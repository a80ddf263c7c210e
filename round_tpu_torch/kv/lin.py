"""Wing&Gong-style per-key linearizability checker (docs/KV.md).

The client history is a list of completed operations, each a dict:

    {"op": "w" | "r", "key": <hex>, "seq": int, "val": <hex>,
     "grade": "lin" | "lease" | "stale" (reads),
     "t0": invoke monotonic s, "t1": complete monotonic s,
     "ok": bool, "res_seq": int (reads), "cl": client id}

Per key, writes carry UNIQUE seq numbers (the client allocates them),
which makes the register check POLYNOMIAL (the Gibbons&Korach shape):
group each write with the reads that returned its seq (a *cluster*);
a linearization must place every cluster as one contiguous block
(write first), so the history is linearizable iff no read completes
before its write was invoked and the cluster precedence relation
(some member of A really-precedes some member of B) is acyclic — and
for this relation any cycle collapses to a 2-cycle, so detection is
one pairwise interval test instead of a search.  A history with
duplicate write seqs (hand-built, degenerate) falls back to the
Wing&Gong search: linearize one minimal operation at a time, with
memoization on the linearized set and a visited-state cap — the
fallback can refuse (KvLinError), the cluster check never does.

Grade semantics:

  * ``lin`` and ``lease`` reads participate in the linearizability
    check — a VALID lease read is linearizable by the staleness-bound
    license (rv/compile.py LeaseClock), so a lease answer that cannot
    be linearized (the broken-lease fixture's frozen answers) is
    exactly the violation this gate exists to catch;
  * ``stale`` reads are checked against the weaker committed-or-
    concurrent contract: the returned seq must be 0 (initial) or a
    write of that key invoked before the read completed;
  * failed/unacked writes (``ok`` False) may or may not have taken
    effect — the search may linearize them anywhere or drop them.

Violations dump through ``dump_history_violation`` in the same
artifact discipline as rv (rv/dump.py): a JSON artifact carrying the
full per-key history and a ``meta.kv`` block, replayable by
``apps/kv.py check`` (re-running the checker on the banked history
must reproduce the verdict bit-for-bit — the history IS the schedule
at this layer).

Port of round_tpu/kv/lin.py, unchanged (plain Python and numpy): the
verdicts and the artifacts are round_tpu's, so an artifact dumped by
either package replays in the other.
"""

from __future__ import annotations

import json
import os
import re
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime.log import get_logger

log = get_logger("kv")

_C_CHECKS = METRICS.counter("kv.lin_checks")
_C_VIOLATIONS = METRICS.counter("kv.lin_violations")

ARTIFACT_VERSION = 1
_SEARCH_CAP = 200_000  # visited-state cap per key (refuse, don't hang)


class KvLinError(RuntimeError):
    """The checker could not certify a history (search cap blown)."""


def _by_key(history: List[Dict[str, Any]]) -> Dict[str, List[Dict]]:
    keys: Dict[str, List[Dict]] = {}
    for op in history:
        keys.setdefault(op["key"], []).append(op)
    return keys


def _check_key(key: str, ops: List[Dict[str, Any]]) -> Optional[Dict]:
    """One key's sub-history; returns a violation dict or None."""
    # stale reads: the committed-or-concurrent contract, outside W&G
    write_seqs = {op["seq"] for op in ops if op["op"] == "w"}
    aborted = {op["seq"] for op in ops
               if op["op"] == "w" and op.get("aborted")}
    for op in ops:
        if op["op"] != "r" or op.get("grade") != "stale":
            continue
        s = op.get("res_seq", 0)
        if s == 0:
            continue
        writes_before = {w["seq"] for w in ops
                         if w["op"] == "w" and w["t0"] <= op["t1"]}
        if s not in writes_before or s in aborted:
            return {"key": key, "kind": "stale-read-uncommitted",
                    "op": op,
                    "why": f"stale read returned seq {s}, which is not "
                           f"a committed-or-concurrent write of this "
                           f"key"}
    # aborted-txn visibility: no read at any grade may see an aborted seq
    for op in ops:
        if op["op"] == "r" and op.get("res_seq", 0) in aborted:
            return {"key": key, "kind": "aborted-read", "op": op,
                    "why": f"read returned seq {op['res_seq']} from an "
                           f"aborted transaction"}
    # reads must return real writes (or 0): a fabricated seq can never
    # linearize and would otherwise surface as an opaque search failure
    strong = [op for op in ops
              if op["op"] == "w"
              or (op["op"] == "r" and op.get("grade") != "stale")]
    for op in strong:
        if op["op"] == "r" and op.get("res_seq", 0) not in \
                write_seqs | {0}:
            return {"key": key, "kind": "phantom-read", "op": op,
                    "why": f"read returned seq {op['res_seq']} which "
                           f"no write of this key produced"}
    strong.sort(key=lambda o: (o["t0"], o["t1"]))
    if not strong:
        return None
    wlist = [op for op in ops if op["op"] == "w"]
    if len({op["seq"] for op in wlist}) == len(wlist):
        # unique seqs: the polynomial cluster check (never refuses)
        return _check_key_clusters(key, strong, aborted)
    return _check_key_wg(key, strong, aborted)


def _check_key_clusters(key: str, strong: List[Dict[str, Any]],
                        aborted: set) -> Optional[Dict]:
    """The unique-seq register check (module docstring): each value's
    cluster = its write + the lin/lease reads that returned it, plus a
    virtual cluster 0 (the initial value, written at -inf).  Failed or
    aborted writes nobody read are dropped (they may never take
    effect; dropping only removes constraints); a read forces its
    write into effect.  Linearizable iff no read completes before its
    write begins and no two clusters mutually precede each other —
    a length-k precedence cycle always contains a 2-cycle (pick the
    cycle member m with minimal earliest-completion: its predecessor's
    incoming edge bounds m's below that predecessor's latest-
    invocation), so the pairwise test IS the cycle test."""
    writes: Dict[int, Dict] = {}
    readers: Dict[int, List[Dict]] = {}
    for op in strong:
        if op["op"] == "w":
            writes[op["seq"]] = op
        else:
            readers.setdefault(op.get("res_seq", 0), []).append(op)
    for s, rs in readers.items():
        if s == 0:
            continue
        w = writes[s]  # the phantom-read pre-check guarantees presence
        for r in rs:
            if r["t1"] < w["t0"]:
                return {"key": key, "kind": "non-linearizable",
                        "ops": len(strong),
                        "why": f"a read returned seq {s} before its "
                               f"write was invoked"}
    eff = [s for s, w in writes.items()
           if (w.get("ok", True) and s not in aborted) or s in readers]
    clusters = [0] + sorted(eff)
    lo, hi = [], []  # per cluster: earliest completion / latest invoke
    for s in clusters:
        ts1 = [r["t1"] for r in readers.get(s, [])]
        ts0 = [r["t0"] for r in readers.get(s, [])]
        if s == 0:
            ts1.append(float("-inf"))
            ts0.append(float("-inf"))
        else:
            ts1.append(writes[s]["t1"])
            ts0.append(writes[s]["t0"])
        lo.append(min(ts1))
        hi.append(max(ts0))
    prec = np.less.outer(np.asarray(lo), np.asarray(hi))  # A → B edges
    np.fill_diagonal(prec, False)
    mutual = prec & prec.T
    if mutual.any():
        a, b = (int(x) for x in np.argwhere(mutual)[0])
        return {"key": key, "kind": "non-linearizable",
                "ops": len(strong),
                "why": f"no linearization of {len(strong)} operations "
                       f"on key {key} explains the observed reads: the "
                       f"operations on seq {clusters[a]} and seq "
                       f"{clusters[b]} mutually precede each other"}
    return None


def _check_key_wg(key: str, strong: List[Dict[str, Any]],
                  aborted: set) -> Optional[Dict]:
    """Wing&Gong fallback for duplicate-seq histories (capped)."""
    n = len(strong)
    t0 = [o["t0"] for o in strong]
    t1 = [o["t1"] for o in strong]
    seen: set = set()

    def dfs(done: frozenset, cur_seq: int) -> bool:
        if len(done) == n:
            return True
        if (done, cur_seq) in seen:
            return False
        if len(seen) > _SEARCH_CAP:
            raise KvLinError(
                f"key {key}: linearizability search exceeded "
                f"{_SEARCH_CAP} states")
        seen.add((done, cur_seq))
        horizon = min((t1[i] for i in range(n) if i not in done))
        for i in range(n):
            if i in done or t0[i] > horizon:
                continue
            op = strong[i]
            nxt = done | {i}
            if op["op"] == "w":
                if op["seq"] not in aborted and dfs(nxt, op["seq"]):
                    return True
                # a FAILED write may also never take effect; an acked
                # non-aborted write must
                if (not op.get("ok", True) or op["seq"] in aborted) \
                        and dfs(nxt, cur_seq):
                    return True
            else:
                if op.get("res_seq", 0) == cur_seq and dfs(nxt, cur_seq):
                    return True
        return False

    if not dfs(frozenset(), 0):
        return {"key": key, "kind": "non-linearizable",
                "ops": len(strong),
                "why": f"no linearization of {len(strong)} operations "
                       f"on key {key} explains the observed reads"}
    return None


def check_history(history: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Check one banked client history; returns the violation list
    (empty = linearizable).  Only completed operations participate —
    the client banks ops at completion time."""
    _C_CHECKS.inc()
    violations = []
    for key, ops in sorted(_by_key(history).items()):
        v = _check_key(key, ops)
        if v is not None:
            violations.append(v)
            _C_VIOLATIONS.inc()
            log.error("kv: LINEARIZABILITY VIOLATION key=%s kind=%s: %s",
                      key, v["kind"], v["why"])
    return violations


def _slug(s: str) -> str:
    return re.sub(r"[^a-zA-Z0-9]+", "-", s).strip("-")[:48] or "kv"


def dump_history_violation(dump_dir: str, history: List[Dict[str, Any]],
                           violations: List[Dict[str, Any]],
                           meta: Optional[Dict[str, Any]] = None
                           ) -> Optional[str]:
    """Bank one violating history as a replayable artifact (the rv dump
    discipline, rv/dump.py): the artifact carries everything needed to
    re-run the check — ``apps/kv.py check FILE`` reproduces the
    verdict.  Returns the path, or None when the write failed (the
    counters/log record already stand)."""
    try:
        os.makedirs(dump_dir, exist_ok=True)
        art = {
            "version": ARTIFACT_VERSION,
            "kind": "kv-lin",
            "history": history,
            "expected": {"violations": violations},
            "meta": {"kv": {
                "violations": violations,
                "ops": len(history),
                "wall": _time.time(),
                **(meta or {}),
            }},
        }
        name = (f"kv-lin-{_slug(violations[0]['key'])}-"
                f"{_slug(violations[0]['kind'])}.json"
                if violations else "kv-lin.json")
        path = os.path.join(dump_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(art, f, indent=1)
        os.replace(tmp, path)
        return path
    except Exception as e:  # noqa: BLE001 — a failed dump must not turn
        # one violation into two failure modes (the rv/dump.py contract)
        log.warning("kv: violation dump failed: %s", e)
        return None


def load_artifact(path: str) -> Dict[str, Any]:
    with open(path) as f:
        art = json.load(f)
    if art.get("kind") != "kv-lin" or "history" not in art:
        raise ValueError(f"{path} is not a kv-lin artifact")
    return art


def replay_artifact(path: str) -> Dict[str, Any]:
    """Re-run the checker on a banked artifact's history; returns
    {"violations": [...], "matches_expected": bool} — the kv layer's
    replay contract (the history IS the schedule here)."""
    art = load_artifact(path)
    got = check_history(art["history"])
    exp = art.get("expected", {}).get("violations", [])
    return {
        "violations": got,
        "matches_expected":
            [(v["key"], v["kind"]) for v in got]
            == [(v["key"], v["kind"]) for v in exp],
    }
