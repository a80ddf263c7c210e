"""Clean control: a miniature serving tier that satisfies every runtime
rule family — the zero-findings anchor for tests/test_torch_runtimelint.py.
Never imported by runtime code (the fold fixture evaluates
``lww_apply`` on a closed domain)."""

import threading

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE

FLAG_NORMAL = 0
FLAG_DECISION = 4
FLAG_BATCH = 0xB7  # container flag: split natively, no Python branch


class CleanDriver:
    """Every shared field consistently guarded; buffer writes gated on
    the pump being disarmed."""

    def __init__(self):
        self._mu = threading.Lock()
        self._queue = []
        self._pump = None
        self._boxes = [[]]

    def push(self, item):
        with self._mu:
            self._queue.append(item)

    def pop(self):
        with self._mu:
            return self._queue.pop() if self._queue else None

    def adopt_frame(self, lane, payload):
        if self._pump is None:
            self._boxes[lane].append(payload)

    def on_frame(self, tag, payload):
        if tag.flag == FLAG_NORMAL:
            METRICS.counter("fxclean.frames").inc()
            return payload
        if tag.flag == FLAG_DECISION:
            TRACE.emit("fxclean_decision", step=1)
        return None


def lww_apply(state, rec):
    """Commutative LWW register: total order on (seq, digest) — the
    post-fix fold shape.  state: {key: (seq, dig, value)}."""
    seq, dig, val = rec
    cur = state.get("k")
    if cur is None or (seq, dig) > (cur[0], cur[1]):
        out = dict(state)
        out["k"] = (seq, dig, val)
        return out
    return state
