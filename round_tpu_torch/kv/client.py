"""The KV client: writes, three-grade reads, transactions, history.

``KVClient`` wraps a FleetRouter (runtime/fleet.py): writes are encoded
records proposed to the shard owning the KEY (ring.owner_key), reads
ride the FLAG_READ verb with NACK/retry accounting mirroring the
proposal path, stale reads never touch the wire, and every completed
operation lands in ``history`` — the banked input of the kv/lin.py
checker.  Single-threaded like the router: the caller drives ``pump()``
as its event loop (apps/loadgen.py kv_open_loop does).

Port of round_tpu/kv/client.py.  The client is host Python; the one
place it reaches the engine is the cross-shard commit calculus
(kv/txn.py ``tpc_decide``), which runs on ``device`` (the card unless
the caller passes another).
"""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional, Set, Tuple

from round_tpu_torch.kv import reads as R
from round_tpu_torch.kv import txn as T
from round_tpu_torch.kv.store import (
    OP_COMMIT, OP_ABORT, OP_PREPARE, OP_PUT, OP_TXN, encode_record,
)
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.runtime.log import get_logger

log = get_logger("kv")

_C_PUTS = METRICS.counter("kv.client_puts")
_C_READ_RETRIES = METRICS.counter("kv.read_retries")
_C_READ_GIVE_UPS = METRICS.counter("kv.read_give_ups")


class _PendingRead:
    __slots__ = ("rid", "key", "grade", "mode", "shard", "t0", "replies",
                 "sent_t", "attempts", "next_retry", "fallback",
                 "internal", "result")

    def __init__(self, rid, key, grade, mode, shard, t0):
        self.rid = rid
        self.key = key
        self.grade = grade      # requested grade (history label source)
        self.mode = mode        # current wire mode: lease | lin
        self.shard = shard
        self.t0 = t0
        self.replies: Dict[int, Tuple[int, bytes]] = {}
        self.sent_t = t0
        self.attempts = 0
        self.next_retry = 0.0
        self.fallback = False
        # PROTOCOL reads (the 2PC coordinator's vote reads) complete
        # outside the client history: they read replicated control
        # state, not data the linearizability contract covers
        self.internal = False
        self.result: Optional[Tuple[bool, int, bytes]] = None


class KVClient:
    """One client id's KV session over a FleetRouter."""

    def __init__(self, router, *, payload_bytes: int = 1024,
                 client: str = "c0", start_id: int = 1,
                 lease_replica: int = 0, keyspace: int = 4096,
                 read_retry_ms: float = 500.0,
                 read_backoff_ms: float = 25.0,
                 read_give_up: int = 12,
                 tenant: int = 0,
                 device=None):
        self.router = router
        # where the cross-shard commit calculus runs (kv/txn.py)
        self.device = device
        self.payload_bytes = payload_bytes
        self.client = client
        # tenancy (docs/SERVING.md "per-tenant admission"): a nonzero
        # tenant id namespaces this session's KEY SPACE (every key gets
        # a tenant prefix, so tenants cannot collide or read each other)
        # and rides Tag.call_stack on every write/txn/read, so the shard
        # meters this session against the tenant's weighted-fair share
        if not 0 <= int(tenant) <= 0xFF:
            raise ValueError(f"tenant id {tenant} outside [0, 255]")
        self.tenant = int(tenant)
        self.lease_replica = lease_replica
        self.keyspace = keyspace
        self.read_retry_ms = read_retry_ms
        self.read_backoff_ms = read_backoff_ms
        self.read_give_up = read_give_up
        self.next_id = start_id
        self.history: List[Dict[str, Any]] = []
        self.mirror: Dict[bytes, Tuple[int, bytes]] = {}
        self._seq: Dict[bytes, int] = {}
        self._writes: Dict[int, Dict[str, Any]] = {}
        self._reads: Dict[int, _PendingRead] = {}
        # 16-bit NACK-correlation tag -> the rids sharing it: rids
        # alias mod 65536 on the wire (reads.read_tag), so one tag can
        # cover several in-flight reads on a long run
        self._rid16: Dict[int, Set[int]] = {}
        self._rid = 1
        self._txn = 1
        self.lease_served = 0
        self.lease_fallbacks = 0
        self.read_give_ups = 0
        router.on_read_reply = self._on_read_reply
        router.on_read_nack = self._on_read_nack

    # -- writes ------------------------------------------------------------

    def _alloc_inst(self) -> int:
        inst = self.next_id
        self.next_id += 1
        return inst

    def _ns(self, key: bytes) -> bytes:
        """The tenant's slice of the key space: a ``t<id>/`` prefix on
        every data key (vote keys stay raw — 2PC control state is
        protocol-owned, not tenant data)."""
        if not self.tenant:
            return key
        return b"t%d/" % self.tenant + key

    def next_seq(self, key: bytes) -> int:
        s = self._seq.get(key, 0) + 1
        self._seq[key] = s
        return s

    def put(self, key: bytes, value: bytes) -> int:
        """One asynchronous write; resolves through ``pump`` (the
        router's decision stream is the ack)."""
        key = self._ns(key)
        seq = self.next_seq(key)
        rec = encode_record(OP_PUT, [(seq, key, value)],
                            self.payload_bytes, keyspace=self.keyspace)
        inst = self._alloc_inst()
        shard = self.router.ring.owner_key(key)
        op = {"cl": self.client, "op": "w", "key": key.hex(),
              "seq": seq, "val": value.hex(), "t0": _time.monotonic(),
              "inst": inst}
        self.router.propose(inst, rec, shard=shard, tenant=self.tenant)
        self._writes[inst] = (op, key, seq, value)
        _C_PUTS.inc()
        return inst

    # -- reads -------------------------------------------------------------

    def read(self, key: bytes, grade: int,
             internal: bool = False,
             shard: Optional[str] = None) -> Optional[int]:
        """One read at ``grade``; stale completes INLINE (zero wire
        traffic) and returns None, lease/lin return a read id that
        resolves through ``pump``.  ``internal`` reads (the 2PC vote
        reads) stay out of the banked history.  ``shard`` overrides the
        ring's key->shard routing — the vote reads need it: a txn's
        vote key is replicated state on EACH participant shard, not on
        the shard the key itself would hash to."""
        if not internal:
            # internal (vote) keys are protocol state, never namespaced
            key = self._ns(key)
        t0 = _time.monotonic()
        if grade == R.GRADE_STALE:
            seq, val = R.local_stale_read(self.mirror, key)
            t1 = _time.monotonic()
            self.history.append({
                "cl": self.client, "op": "r", "key": key.hex(),
                "grade": "stale", "t0": t0, "t1": t1, "ok": True,
                "res_seq": seq, "res_val": val.hex()})
            R.H_READ_MS["stale"].observe((t1 - t0) * 1000.0)
            return None
        rid = self._rid
        self._rid += 1
        if shard is None:
            shard = self.router.ring.owner_key(key)
        mode = "lease" if grade == R.GRADE_LEASE else "lin"
        pr = _PendingRead(rid, key, R.GRADE_NAMES[grade], mode, shard, t0)
        pr.internal = internal
        self._reads[rid] = pr
        self._rid16.setdefault(R.read_tag(rid).instance, set()).add(rid)
        self._send_read(pr)
        return rid

    def _send_read(self, pr: _PendingRead) -> None:
        now = _time.monotonic()
        pr.sent_t = now
        pr.attempts += 1
        payload = R.encode_read(
            pr.rid, pr.key,
            R.GRADE_LEASE if pr.mode == "lease" else R.GRADE_LIN)
        if pr.mode == "lease":
            self.router.send_read(pr.shard, self.lease_replica, pr.rid,
                                  payload, tenant=self.tenant)
        else:
            n = self.router.shard_n(pr.shard)
            for j in range(n):
                self.router.send_read(pr.shard, j, pr.rid, payload,
                                      tenant=self.tenant)

    def _complete_read(self, pr: _PendingRead, ok: bool,
                       seq: int = 0, val: bytes = b"") -> None:
        self._reads.pop(pr.rid, None)
        iid = R.read_tag(pr.rid).instance
        tagged = self._rid16.get(iid)
        if tagged is not None:
            # drop only THIS rid from the shared 16-bit slot: an
            # aliased read still in flight keeps its NACK correlation
            tagged.discard(pr.rid)
            if not tagged:
                del self._rid16[iid]
        t1 = _time.monotonic()
        pr.result = (ok, seq, val)
        if pr.internal:
            return
        grade = "lin" if pr.fallback else pr.grade
        self.history.append({
            "cl": self.client, "op": "r", "key": pr.key.hex(),
            "grade": grade, "t0": pr.t0, "t1": t1, "ok": ok,
            "res_seq": seq, "res_val": val.hex(),
            **({"fallback": True} if pr.fallback else {})})
        if ok:
            R.H_READ_MS[grade].observe((t1 - pr.t0) * 1000.0)
            if pr.grade == "lease" and not pr.fallback:
                self.lease_served += 1

    def _on_read_reply(self, shard: str, sender: int, tag, raw) -> None:
        rep = R.decode_reply(raw)
        if rep is None:
            return
        pr = self._reads.get(rep["r"])
        if pr is None:
            return
        if rep["st"] == R.ST_REFUSED:
            if pr.mode == "lease":
                # the lease clock refused (stale): fall back to a
                # linearizable read — refusal is the CONTRACT working
                self.lease_fallbacks += 1
                R.C_LEASE_FALLBACKS.inc()
                pr.mode = "lin"
                pr.fallback = True
                pr.replies.clear()
                self._send_read(pr)
            return
        pr.replies[sender] = (rep["seq"], rep["v"])
        if pr.mode == "lease":
            seq, val = rep["seq"], rep["v"]
            self._complete_read(pr, True, seq, val)
            return
        need = R.majority(self.router.shard_n(pr.shard))
        if len(pr.replies) >= need:
            seq, val = R.combine_lin(pr.replies.values())
            self._complete_read(pr, True, seq, val)

    def _on_read_nack(self, shard: str, iid: int) -> None:
        # the 16-bit tag may cover several aliased in-flight reads;
        # back off every one targeting the shedding shard (they would
        # all be shed the same way)
        for rid in list(self._rid16.get(iid, ())):
            pr = self._reads.get(rid)
            if pr is None or pr.shard != shard:
                continue
            if pr.attempts >= self.read_give_up:
                self.read_give_ups += 1
                _C_READ_GIVE_UPS.inc()
                self._complete_read(pr, False)
                continue
            _C_READ_RETRIES.inc()
            backoff = min(self.read_backoff_ms * (2.0 ** pr.attempts),
                          1000.0)
            pr.next_retry = _time.monotonic() + backoff / 1000.0

    # -- the event loop ----------------------------------------------------

    def pump(self, timeout_ms: int = 20) -> int:
        """One client wave: drain the router (decisions, read replies,
        NACKs), resolve completed writes into history/mirror, fire read
        retry timers."""
        handled = self.router.pump(timeout_ms)
        for inst in [i for i in self._writes if i in self.router.results]:
            op, key, seq, value = self._writes.pop(inst)
            decided = self.router.results[inst] is not None
            op["t1"] = _time.monotonic()
            op["ok"] = decided
            if decided and seq >= self.mirror.get(key, (0, b""))[0]:
                # the client-side decision bank (stale reads serve here)
                self.mirror[key] = (seq, value)
            self.history.append(op)
        now = _time.monotonic()
        for pr in list(self._reads.values()):
            if pr.next_retry > 0 and now >= pr.next_retry:
                pr.next_retry = 0.0
                self._send_read(pr)
            elif pr.next_retry == 0 and (now - pr.sent_t) * 1000.0 \
                    >= self.read_retry_ms:
                if pr.attempts >= self.read_give_up:
                    self.read_give_ups += 1
                    _C_READ_GIVE_UPS.inc()
                    self._complete_read(pr, False)
                else:
                    _C_READ_RETRIES.inc()
                    self._send_read(pr)
        return handled

    def drain(self, deadline_s: float) -> bool:
        """Pump until every in-flight write and read resolves."""
        t_end = _time.monotonic() + deadline_s
        while (self._writes or self._reads) \
                and _time.monotonic() < t_end:
            self.pump(20)
        return not (self._writes or self._reads)

    # -- transactions (kv/txn.py protocol) ---------------------------------

    def _wait_insts(self, insts: List[int], deadline_s: float) -> bool:
        t_end = _time.monotonic() + deadline_s
        while any(i not in self.router.results for i in insts) \
                and _time.monotonic() < t_end:
            self.pump(20)
        return all(self.router.results.get(i) is not None for i in insts)

    def _read_blocking(self, key: bytes, grade: int, deadline_s: float,
                       shard: Optional[str] = None,
                       ) -> Optional[Tuple[int, bytes]]:
        """A blocking INTERNAL read (the 2PC vote reads): never banked
        in the client history."""
        rid = self.read(key, grade, internal=True, shard=shard)
        pr = self._reads[rid]
        t_end = _time.monotonic() + deadline_s
        while pr.result is None and _time.monotonic() < t_end:
            self.pump(20)
        if pr.result is None or not pr.result[0]:
            return None
        return (pr.result[1], pr.result[2])

    def txn(self, pairs: Dict[bytes, bytes],
            deadline_s: float = 30.0) -> Dict[str, Any]:
        """One multi-key transaction (blocking; see kv/txn.py for the
        protocol).  Returns {"committed": bool, "txn": id,
        "shards": k}."""
        t0 = _time.monotonic()
        pairs = {self._ns(k): v for k, v in pairs.items()}
        by_shard = T.plan_txn(self.router.ring, pairs)
        seqs = {k: self.next_seq(k) for k in pairs}
        txn_id = self._txn
        self._txn += 1

        def bank_writes(committed: bool, t1: float) -> None:
            for k, v in pairs.items():
                self.history.append({
                    "cl": self.client, "op": "w", "key": k.hex(),
                    "seq": seqs[k], "val": v.hex(), "t0": t0, "t1": t1,
                    "ok": committed, "txn": txn_id,
                    **({} if committed else {"aborted": True})})
                if committed and seqs[k] >= self.mirror.get(
                        k, (0, b""))[0]:
                    self.mirror[k] = (seqs[k], v)

        if len(by_shard) == 1:
            (shard, sub), = by_shard.items()
            rec = encode_record(
                OP_TXN, [(seqs[k], k, v) for k, v in sub.items()],
                self.payload_bytes, txn=txn_id, keyspace=self.keyspace)
            inst = self._alloc_inst()
            self.router.propose(inst, rec, shard=shard, txn=True,
                                tenant=self.tenant)
            committed = self._wait_insts([inst], deadline_s)
            bank_writes(committed, _time.monotonic())
            return {"committed": committed, "txn": txn_id, "shards": 1}

        # cross-shard 2PC: prepare everywhere, read the deterministic
        # votes, decide via the TPC model, land the outcome everywhere
        prep = []
        for shard, sub in by_shard.items():
            rec = encode_record(
                OP_PREPARE, [(seqs[k], k, v) for k, v in sub.items()],
                self.payload_bytes, txn=txn_id, keyspace=self.keyspace)
            inst = self._alloc_inst()
            self.router.propose(inst, rec, shard=shard, txn=True,
                                tenant=self.tenant)
            prep.append(inst)
        prepared = self._wait_insts(prep, deadline_s)
        votes = []
        if prepared:
            # each PARTICIPANT holds its own replicated vote under the
            # same reserved key: read it from every participant shard
            # (the ring would route the vote key to one fixed shard)
            for shard in by_shard:
                ans = self._read_blocking(T.vote_key(txn_id),
                                          R.GRADE_LIN, deadline_s,
                                          shard=shard)
                votes.append(ans is not None and ans[1] == b"y")
        commit = (prepared and bool(votes)
                  and T.tpc_decide(votes, device=self.device))
        out_op = OP_COMMIT if commit else OP_ABORT
        outs = []
        for shard, sub in by_shard.items():
            k0 = next(iter(sub))
            rec = encode_record(
                out_op, [(seqs[k0], k0, b"")], self.payload_bytes,
                txn=txn_id, keyspace=self.keyspace)
            inst = self._alloc_inst()
            self.router.propose(inst, rec, shard=shard, txn=True,
                                tenant=self.tenant)
            outs.append(inst)
        self._wait_insts(outs, deadline_s)
        bank_writes(commit, _time.monotonic())
        return {"committed": commit, "txn": txn_id,
                "shards": len(by_shard)}

    # -- reporting ---------------------------------------------------------

    def grade_latencies(self) -> Dict[str, List[float]]:
        out: Dict[str, List[float]] = {"lin": [], "lease": [],
                                       "stale": []}
        for op in self.history:
            if op["op"] == "r" and op["ok"]:
                out[op["grade"]].append((op["t1"] - op["t0"]) * 1000.0)
        return out

    def status(self) -> Dict[str, Any]:
        reads = [op for op in self.history if op["op"] == "r"]
        return {
            "ops": len(self.history),
            "writes": sum(1 for op in self.history if op["op"] == "w"),
            "reads": len(reads),
            "reads_by_grade": {
                g: sum(1 for op in reads if op["grade"] == g)
                for g in ("lin", "lease", "stale")},
            "lease_served": self.lease_served,
            "lease_fallbacks": self.lease_fallbacks,
            "read_give_ups": self.read_give_ups,
        }
