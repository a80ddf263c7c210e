"""lock-discipline fixture: mixed-guard, order-inversion, pump write.

Never imported by runtime code — linted statically by
tests/test_torch_runtimelint.py.  Every ``# lint:`` comment marks the defect
line the golden test anchors on.
"""

import threading


class BrokenDriver:
    """A driver that violates every lock-discipline rule at once."""

    def __init__(self):
        self._mu = threading.Lock()
        self._aux = threading.Lock()
        self._queue = []
        self._pump = object()   # armed: the native pump holds _boxes
        self._boxes = [[]]

    def locked_push(self, item):
        with self._mu:
            self._queue.append(item)

    def bare_push(self, item):
        # same field as locked_push, no lock taken
        self._queue.append(item)  # lint: lock-discipline/mixed-guard

    def mu_then_aux(self):
        with self._mu:
            with self._aux:
                return len(self._queue)

    def aux_then_mu(self):
        with self._aux:
            with self._mu:  # lint: lock-discipline/order-inversion
                return len(self._queue)

    def adopt_frame(self, lane, payload):
        # the oob-adoption bug shape: the pump may be writing
        # this buffer, and nothing disarmed the lane first
        self._boxes[lane].append(payload)  # lint: lock-discipline/pump-write-no-disarm
