"""Chaos layer for the host runtime: deterministic wire-fault injection
and the crash-restart cluster driver.

The simulated engines carry their whole fault model as data
(engine/scenarios.py HO families); the real multi-process path
(runtime/host.py over runtime/transport.py) had none — it was only ever
exercised on a clean localhost wire.  This module closes that gap:

* ``FaultPlan`` — a seed-driven schedule of wire faults per
  (src, dst, round), SHARING the engines' counter-based link hash
  (scenarios.link_bernoulli: murmur3 fmix32 over
  ``idx·GOLD + salt0 ^ (r·RMIX + salt1)``, probabilities quantized to
  1/256).  ``FaultPlan(seed=s, drop=p)`` drops exactly the links
  ``scenarios.omission(n, p, impl="hash")`` drops for ``PRNGKey(s)`` —
  pinned by tests/test_chaos.py — so one fault mix can run against both
  the fused engine and a real process cluster and the decisions diffed.
  The extra families (duplicate / reorder / delay / truncate / garbage)
  draw from the same hash under distinct stream constants: one seed, six
  independent, REPLAYABLE schedules.

* ``FaultyTransport`` — a wrapper implementing the HostTransport surface
  (send/recv/add_peer/stop/close/dropped) that applies a FaultPlan:
  sender-side faults (drop, crash-silence, partition, duplicate,
  truncate, garbage bytes) perturb ``send``; receiver-side faults
  (delay, reorder) hold packets back in ``recv``.  Only FLAG_NORMAL
  data-plane frames are perturbed — the decision-reply control plane IS
  the recovery machinery under test and keeps the wire semantics of the
  underlying transport.

* ``run_chaos_cluster`` — the crash-restart driver: n ``host_replica``
  OS processes with a chaos spec, optionally SIGKILLing one replica
  after it has durably checkpointed ``crash_after`` instances and
  restarting it from the checkpoint (runtime/checkpoint.py).  Shared by
  tests/test_chaos.py and the tools/soak.py ``host-chaos`` rotation
  slot, which diffs the surviving decision logs byte-for-byte against a
  clean run.

Port of round_tpu/runtime/chaos.py.  ``host_key_salts(seed)`` gives
round_tpu's salts of ``PRNGKey(seed)`` without jax, so a plan drops the
links round_tpu's plan drops for the same seed, bit for bit.  The
cluster driver launches the port's ``host_replica`` (on the card unless
``device`` says otherwise).  ``FaultyTransport.from_schedule_file`` reads
fuzz artifacts through the port's ``fuzz/replay.py``.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import json
import os
import signal
import subprocess
import sys
import time
from typing import Dict, Optional

from round_tpu_torch.engine.scenarios import (
    LINK_GOLD,
    host_key_salts,
    host_link_u32,
    mix32_host,
)
from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.oob import FLAG_NORMAL

# Stream constants: each fault family draws an independent Bernoulli from
# the one link hash by folding its stream into the round salt.  DROP is
# stream 0 so the drop schedule is BIT-IDENTICAL to the engines'
# scenarios.omission hash mask for the same seed.
STREAM_DROP = 0x00000000
STREAM_DUP = 0x5D0F00D1
STREAM_REORDER = 0x6C1E55A7
STREAM_DELAY = 0x7D2EAA93
STREAM_TRUNCATE = 0x8E3F0189
STREAM_GARBAGE = 0x9F4F56B5
_PARTITION_SALT = 0x9A87  # matches scenarios.partition's fold-in constant

# The value-adversary streams (equivocation / stale replay) live in
# round_tpu/byz/adversary.py: value faults are SCHEDULED here (explicit
# [T, n, n] plans from v2 fuzz artifacts), never hash-drawn per send.

#: Native-round-pump compatibility, DECLARED per fault surface — the
#: silent-composition gate: ``enable_pump`` refuses unless every ACTIVE
#: surface of this transport is explicitly declared True here.  A new
#: fault family added without a declaration therefore falls back to the
#: Python pump instead of silently bypassing its injection semantics.
#: Sender-side byte-stream families are safe (the native receiver sees
#: exactly the faulted frames); receiver-side hold/release families are
#: not (natively-ingested frames would skip this wrapper's recv());
#: value-fault families start UNPROVEN: the forged frames are
#: well-formed and would template-ingest, but the zero-copy pinned-
#: mailbox interaction has no parity pin yet, so they keep the Python
#: pump (pump.fast_frames stays 0 — tests/test_byz.py).
PUMP_COMPAT = {
    "drop": True, "dup": True, "truncate": True, "garbage": True,
    "crash": True, "partition": True, "schedule": True,
    "delay": False, "reorder": False,
    "value": False,
}


def _p8(p: float) -> int:
    """Probability → 8-bit threshold, exactly link_bernoulli's clamp: any
    p > 0 keeps at least 1/256 (a lossy schedule must stay lossy)."""
    return max(1, round(p * 256.0)) if p > 0 else 0


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Seed-driven per-(src, dst, round) wire-fault schedule.

    Families and parameterisation mirror engine/scenarios.py:
      drop          — scenarios.omission(n, drop): iid per-link loss;
      crash_round   — scenarios.crash_at: from this round on, this
                      replica's sends are swallowed (-1 = never; the
                      process-level analogue is run_chaos_cluster's
                      SIGKILL);
      partition     — scenarios.partition: two seed-drawn halves cannot
                      talk until heal_round;
      dup/reorder/delay/truncate/garbage — wire-level families with no
                      HO-mask counterpart (an HO set cannot express a
                      duplicated or corrupted payload; the reference
                      tolerates these via InstanceHandler.scala:392-399,
                      which is exactly the machinery they exercise).
    """

    seed: int = 0
    drop: float = 0.0
    dup: float = 0.0
    reorder: float = 0.0
    reorder_hold_ms: int = 60
    delay: float = 0.0
    delay_ms: int = 40
    truncate: float = 0.0
    garbage: float = 0.0
    crash_round: int = -1
    heal_round: int = 0  # partition active while r < heal_round

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        """Build a plan from a compact CLI spec:
        ``drop=0.2,reorder=0.15,dup=0.05,seed=7`` (keys are the dataclass
        fields; ints and floats inferred).  Unknown keys are an error —
        a typo'd family must not silently run fault-free."""
        kwargs: Dict[str, object] = {}
        fields = {f.name: f.type for f in dataclasses.fields(cls)}
        for part in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in part:
                raise ValueError(f"chaos spec entry {part!r} is not key=value")
            key, val = part.split("=", 1)
            key = key.strip().replace("-", "_")
            if key not in fields:
                raise ValueError(
                    f"unknown chaos family/field {key!r}; known: "
                    f"{sorted(fields)}")
            kwargs[key] = (int(val) if fields[key] == "int"
                           or fields[key] is int else float(val))
        return cls(**kwargs)

    def spec(self) -> str:
        """The canonical round-trippable spec string (non-default fields)."""
        out = []
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if v != f.default:
                out.append(f"{f.name}={v}")
        return ",".join(out)


class FaultyTransport:
    """A HostTransport/HostBus-surface wrapper applying a FaultPlan.

    Fault decisions are pure functions of (seed, src, dst, round): two
    runs over the same plan see the same schedule (delivery TIMING of
    delayed packets is wall-clock, the schedule of which packets fault is
    not).  `injected` counts every applied fault for assertions and
    stats.  Non-NORMAL (control-plane) frames pass through untouched."""

    def __init__(self, inner, plan: FaultPlan, n: int, schedule=None,
                 value_plan=None, protocol: Optional[str] = None,
                 rounds_per_phase: Optional[int] = None):
        self.inner = inner
        self.plan = plan
        self.n = n
        self._salt0, self._salt1 = host_key_salts(plan.seed)
        self.injected: Dict[str, int] = {}
        self._held: list = []   # (release_t, seq, got) min-heap
        self._seq = itertools.count()
        # explicit-schedule mode (the fuzzer's replay surface): a
        # [T, n, n] bool DELIVER tensor — schedule[r, dst, src] — REPLACES
        # the hash-derived families wholesale (rounds >= T clamp to the
        # last row, matching engine/scenarios.from_schedule).  Purely
        # sender-side, so the native round pump stays safe to engage.
        self.schedule = None
        if schedule is not None:
            import numpy as np

            sched = np.asarray(schedule, dtype=bool)
            if sched.ndim != 3 or sched.shape[1] != sched.shape[2] \
                    or sched.shape[0] < 1:
                raise ValueError(
                    f"schedule must be [T, n, n] bool, got {sched.shape}")
            if sched.shape[1] != n:
                raise ValueError(
                    f"schedule n={sched.shape[1]} != transport n={n}")
            self.schedule = sched
        # scheduled VALUE-fault families (round_tpu/byz): an explicit
        # [T, n, n] int32 substitution plan — plan[r, dst, src] is
        # VP_NONE (truthful), VP_STALE (replay this sender's previous
        # transmission of the round class) or v >= 0 (re-encode the frame
        # claiming value v through the protocol's lie model).  Purely
        # sender-side: the frame on the wire IS the forged frame, so an
        # engine equivocation finding replays byte-equivalently here.
        self.value_plan = None
        self.protocol = protocol
        self._rpp = max(1, int(rounds_per_phase or 1))
        # stale-replay memory: per round class, the LAST truthful payload
        # bytes actually sent at an earlier round (the engine's carried
        # (ever-sent, last-sent) pair, in byte form) + the in-round cache
        self._class_prev: Dict[int, bytes] = {}
        self._class_cur: Dict[int, tuple] = {}
        self._class_inst: Optional[int] = None
        if value_plan is not None:
            import numpy as np

            vp = np.asarray(value_plan, dtype=np.int32)
            if vp.ndim != 3 or vp.shape[1] != vp.shape[2]:
                raise ValueError(
                    f"value plan must be [T, n, n] int32, got {vp.shape}")
            if vp.shape[1] != n:
                raise ValueError(
                    f"value plan n={vp.shape[1]} != transport n={n}")
            if protocol is None:
                raise ValueError(
                    "value_plan needs the protocol name (lie-model and "
                    "round-class resolution)")
            self.value_plan = vp

    @classmethod
    def from_schedule_file(cls, inner, path: str) -> "FaultyTransport":
        """Explicit per-(src, dst, round) schedule from a fuzz artifact
        (round_tpu/fuzz/replay.py schema) instead of hash-derived
        families — the constructor that turns a minimized engine finding
        into a deterministic host-wire regression: the SAME link events
        the engine mask suppressed are dropped on the real wire, and (v2
        artifacts) the SAME value-substitution events are forged into
        the outgoing frames (delivery equivalence pinned by
        tests/test_fuzz.py; value equivalence by tests/test_byz.py)."""
        from round_tpu_torch.fuzz.replay import (
            load_artifact,
            schedule_from_artifact,
            value_plan_from_artifact,
        )

        art = load_artifact(path)
        vplan = value_plan_from_artifact(art)
        rpp = None
        if vplan is not None:
            from round_tpu_torch.apps.selector import select

            rpp = select(art["protocol"]).rounds_per_phase
        return cls(inner, FaultPlan(seed=int(art.get("seed", 0))),
                   n=int(art["n"]),
                   schedule=schedule_from_artifact(art),
                   value_plan=vplan, protocol=art["protocol"],
                   rounds_per_phase=rpp)

    # -- the seeded link hash ----------------------------------------------

    def _u32(self, stream: int, src: int, dst: int, r: int) -> int:
        return host_link_u32(self._salt0, self._salt1, r, src, dst,
                             self.n, stream)

    def _event(self, stream: int, src: int, dst: int, r: int,
               p: float) -> bool:
        p8 = _p8(p)
        return p8 > 0 and (self._u32(stream, src, dst, r) & 0xFF) < p8

    def _side(self, node: int) -> int:
        """Seed-drawn partition side, constant per node (the
        scenarios.partition per-scenario split role)."""
        return mix32_host(node * LINK_GOLD + self._salt0
                          + _PARTITION_SALT) & 1

    def _count(self, family: str, src: int, dst: int, r: int,
               inst: int) -> None:
        """Record one injected fault: the per-transport `injected` dict
        (assertions), the unified chaos.* counter, and — when tracing —
        a typed `fault` event carrying the (src, dst, round, instance)
        coordinates tools/trace_view.py correlates against the timeouts
        and catch-ups the fault caused downstream."""
        self.injected[family] = self.injected.get(family, 0) + 1
        METRICS.counter(f"chaos.{family}").inc()
        if TRACE.enabled:
            TRACE.emit("fault", node=self.inner.id, family=family,
                       src=src, dst=dst, round=r, inst=inst)

    # -- scheduled value faults (round_tpu/byz) ----------------------------

    def _note_sent(self, r: int, inst: int, payload: bytes) -> None:
        """Advance the per-round-class stale memory: ``_class_prev[k]``
        holds the last truthful payload bytes this sender transmitted at
        a round STRICTLY earlier than the current one (the byte twin of
        the engine's carried (ever-sent, last-sent) pair).  An instance
        change — or a round restart, for callers that re-tag — resets
        it: a fresh instance has no stale history (so a new instance
        whose first send lands on the SAME round number as the previous
        instance's last send cannot inherit its payload)."""
        if inst != self._class_inst:
            self._class_prev.clear()
            self._class_cur.clear()
            self._class_inst = inst
        k = r % self._rpp
        cur = self._class_cur.get(k)
        if cur is not None:
            if cur[0] == r:
                return  # same round, same payload: one entry per round
            if cur[0] > r:  # rounds restarted without an instance tag
                self._class_prev.clear()
                self._class_cur.clear()
            else:
                self._class_prev[k] = cur[1]
        self._class_cur[k] = (r, bytes(payload))

    def _value_fault(self, to: int, r: int, inst: int,
                     payload: bytes) -> bytes:
        """Apply the scheduled value op for (r, to): forge the frame
        claiming the planned value through the protocol's lie model
        (byz/lies.py — decode, lie, re-encode: well-formed by
        construction), or substitute the sender's previous transmission
        of this round class (stale replay).  Undecodable/empty frames
        pass through untouched — a lie needs a well-formed truth to
        forge."""
        vp = self.value_plan
        src = self.inner.id
        vn, T = vp.shape[1], vp.shape[0]
        if not (0 <= src < vn and 0 <= to < vn):
            return payload
        op = int(vp[min(r, T - 1), to, src])
        if op == -1:
            return payload
        k = r % self._rpp
        if op == -2:  # VP_STALE
            prev = self._class_prev.get(k)
            if prev is None:
                return payload  # nothing sent earlier: truthful
            self._count("byz_stale", src, to, r, inst)
            return prev
        if not payload:
            return payload
        from round_tpu_torch.byz.lies import forge_payload
        from round_tpu_torch.runtime import codec

        try:
            obj = codec.loads(bytes(payload))
            forged = codec.encode(forge_payload(self.protocol, k, obj, op))
        except Exception:  # noqa: BLE001 — an unforgeable frame (foreign
            # codec, control payload riding FLAG_NORMAL) stays truthful;
            # the adversary only forges what it can parse
            return payload
        self._count("byz_equivocate", src, to, r, inst)
        return forged

    # -- HostTransport surface ---------------------------------------------

    @property
    def id(self):
        return self.inner.id

    @property
    def port(self):
        return self.inner.port

    @property
    def dropped(self):
        return self.inner.dropped

    @property
    def closed(self):
        return self.inner.closed

    def add_peer(self, peer_id, host, port):
        return self.inner.add_peer(peer_id, host, port)

    def remove_peer(self, peer_id):
        return self.inner.remove_peer(peer_id)

    def connected(self, peer_id):
        return self.inner.connected(peer_id)

    def start_reconnect(self, **kw):
        return self.inner.start_reconnect(**kw)

    @property
    def reconnects(self):
        return self.inner.reconnects

    def active_surfaces(self):
        """The fault surfaces this transport actually applies — the
        inputs of the PUMP_COMPAT capability check."""
        out = []
        p = self.plan
        if self.schedule is not None:
            out.append("schedule")
        else:
            if p.drop > 0:
                out.append("drop")
            if p.dup > 0:
                out.append("dup")
            if p.truncate > 0:
                out.append("truncate")
            if p.garbage > 0:
                out.append("garbage")
            if p.crash_round >= 0:
                out.append("crash")
            if p.heal_round > 0:
                out.append("partition")
        # the receiver-side hold/release families apply in recv()
        # REGARDLESS of schedule mode (_maybe_hold consults only the
        # plan), so they stay declared even when an explicit schedule
        # turned the sender-side hash families off — a schedule+delay
        # transport must refuse the pump like any delay plan
        if p.delay > 0:
            out.append("delay")
        if p.reorder > 0:
            out.append("reorder")
        if self.value_plan is not None:
            out.append("value")
        return out

    def enable_pump(self, L, n, k, nbz=0):
        """Native-round-pump pass-through, gated by the EXPLICIT
        capability map (PUMP_COMPAT): the pump engages only when every
        active fault surface is declared pump-compatible.  Sender-side
        byte families (drop, crash, partition, dup, truncate, garbage,
        explicit schedules) are — faults apply in send/send_buffered
        before the wire, so the native receiver sees exactly the faulted
        frame stream.  The receiver-side hold/release families (delay,
        reorder) are not — frames the native pump ingests would bypass
        this wrapper's recv().  VALUE-fault plans are declared
        incompatible until a zero-copy parity pin exists (PUMP_COMPAT),
        so a value-schedule run falls back to the Python pump
        (pump.fast_frames stays 0) rather than silently bypassing
        injection.  The pump SEND path is never offered here (no
        ``pump_send_ok``): sends must keep flowing through send_buffered
        so faults stay per logical frame."""
        if not all(PUMP_COMPAT.get(s, False)
                   for s in self.active_surfaces()):
            return None
        f = getattr(self.inner, "enable_pump", None)
        return None if f is None else f(L, n, k, nbz)

    def rewire(self, peers, my_id=None):
        """View-change pass-through (runtime/view.py): the live peer table
        swap happens on the inner transport; the fault schedules COMPOSE
        with churn by construction — every family is a pure function of
        (seed, src, dst, round), so reconnects and renames change which
        physical channel carries a frame, never whether it faults.  Only
        ``n`` (the sender-range/partition-side domain) tracks the group."""
        out = self.inner.rewire(peers, my_id=my_id)
        self.n = len(peers)
        return out

    def stop(self):
        return self.inner.stop()

    def close(self):
        return self.inner.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _send_faults(self, to, tag, payload):
        """Apply the sender-side fault families to ONE logical frame.
        Returns (deliver, payload, dup): the frame's fate is a pure
        function of (seed, src, dst, round) regardless of HOW it then
        travels — a direct send and a coalesced batch member fault
        IDENTICALLY, which is what keeps per-(seed,src,dst,round)
        schedules framing-invariant (pinned by tests/test_chaos.py)."""
        plan, src = self.plan, self.inner.id
        r, inst = tag.round, tag.instance
        if self.value_plan is not None:
            # stale-replay memory advances on every SEND attempt (the
            # engine's prev carry updates on the dest mask, not on
            # delivery — a round whose frames all drop still refreshes
            # the sender's last-sent payload)
            self._note_sent(r, inst, payload)
        if self.schedule is not None:
            # explicit schedule: one lookup decides the frame's fate; the
            # hash families are OFF in this mode.  Out-of-range peers
            # pass through — bounded by the SCHEDULE's own group size,
            # not self.n, which rewire() retargets on view churn (a
            # schedule pins a fixed-n world; members past it are unfaulted
            # rather than an IndexError killing the sender).
            sn = self.schedule.shape[1]
            if not (0 <= src < sn and 0 <= to < sn):
                return True, payload, False
            T = self.schedule.shape[0]
            if not self.schedule[min(r, T - 1), to, src]:
                self._count("drop", src, to, r, inst)
                return False, payload, False
            if self.value_plan is not None:
                payload = self._value_fault(to, r, inst, payload)
            return True, payload, False
        if 0 <= plan.crash_round <= r:
            self._count("crash_mute", src, to, r, inst)
            return False, payload, False  # swallowed: crashed = silent
        if r < plan.heal_round and self._side(src) != self._side(to):
            self._count("partition", src, to, r, inst)
            return False, payload, False
        if self._event(STREAM_DROP, src, to, r, plan.drop):
            self._count("drop", src, to, r, inst)
            return False, payload, False  # silent loss, UDP-style
        if self.value_plan is not None:
            # a standalone value plan composes with the hash families:
            # lies apply only to frames the omission families deliver
            payload = self._value_fault(to, r, inst, payload)
        if payload and self._event(STREAM_TRUNCATE, src, to, r,
                                   plan.truncate):
            u = self._u32(STREAM_TRUNCATE, src, to, r)
            payload = payload[: (u >> 8) % len(payload)]
            self._count("truncate", src, to, r, inst)
        if self._event(STREAM_GARBAGE, src, to, r, plan.garbage):
            u = self._u32(STREAM_GARBAGE, src, to, r)
            payload = (u.to_bytes(4, "big") * (1 + (u >> 8) % 16))
            self._count("garbage", src, to, r, inst)
        dup = self._event(STREAM_DUP, src, to, r, plan.dup)
        if dup:
            self._count("dup", src, to, r, inst)
        return True, payload, dup

    def send(self, to, tag, payload: bytes = b"") -> bool:
        if tag.flag != FLAG_NORMAL:
            return self.inner.send(to, tag, payload)
        deliver, payload, dup = self._send_faults(to, tag, payload)
        if not deliver:
            return True
        ok = self.inner.send(to, tag, payload)
        if dup:
            self.inner.send(to, tag, payload)
        return ok

    def send_buffered(self, to, tag, payload=b"") -> bool:
        """The coalescing surface (runtime/transport.py): faults apply
        PER LOGICAL FRAME before the frame joins its destination batch,
        so a batch member drops/corrupts/duplicates exactly when its
        direct-send twin would (duplicates ride the same batch)."""
        inner_sb = getattr(self.inner, "send_buffered", None)
        if inner_sb is None:
            return self.send(to, tag, payload)
        if tag.flag != FLAG_NORMAL:
            return inner_sb(to, tag, payload)
        deliver, payload, dup = self._send_faults(to, tag, payload)
        if not deliver:
            return True
        ok = inner_sb(to, tag, payload)
        if dup:
            inner_sb(to, tag, payload)
        return ok

    def flush(self, to=None) -> int:
        f = getattr(self.inner, "flush", None)
        return 0 if f is None else f(to)

    def _maybe_hold(self, got):
        """Receiver-side families: None when the packet was held back."""
        sender, tag, _raw = got
        if tag.flag != FLAG_NORMAL or not (0 <= sender < self.n):
            return got
        plan, dst, r = self.plan, self.inner.id, tag.round
        hold_ms = 0
        if self._event(STREAM_DELAY, sender, dst, r, plan.delay):
            hold_ms += plan.delay_ms
            self._count("delay", sender, dst, r, tag.instance)
        if self._event(STREAM_REORDER, sender, dst, r, plan.reorder):
            hold_ms += plan.reorder_hold_ms
            self._count("reorder", sender, dst, r, tag.instance)
        if hold_ms <= 0:
            return got
        heapq.heappush(
            self._held,
            (time.monotonic() + hold_ms / 1000.0, next(self._seq), got),
        )
        return None

    def recv(self, timeout_ms: int):
        deadline = time.monotonic() + max(timeout_ms, 0) / 1000.0
        while True:
            now = time.monotonic()
            if self._held and self._held[0][0] <= now:
                return heapq.heappop(self._held)[2]
            remaining = deadline - now
            if remaining <= 0:
                # final non-blocking poll keeps recv(0) drain semantics
                got = self.inner.recv(0)
                if got is None:
                    return None
                return self._maybe_hold(got)
            wait = remaining
            if self._held:
                wait = min(wait, self._held[0][0] - now)
            got = self.inner.recv(max(0, int(wait * 1000)))
            if got is None:
                continue  # deadline or a held release came due
            got = self._maybe_hold(got)
            if got is not None:
                return got

    def recv_many(self, timeout_ms: int):
        """Batched-drain surface: repeated recv() so the receiver-side
        hold/release schedules (delay, reorder) apply per logical frame
        exactly as they do frame-by-frame."""
        out = []
        got = self.recv(timeout_ms)
        while got is not None:
            out.append(got)
            got = self.recv(0)
        return out


# ---------------------------------------------------------------------------
# Crash-restart cluster driver (host_replica subprocesses)
# ---------------------------------------------------------------------------


def alloc_ports(n: int):
    """n free localhost ports (bind-then-close; the shared copy — also
    used by apps/host_perftest.py and the cluster tests)."""
    import socket

    socks = [socket.socket() for _ in range(n)]
    for s in socks:
        s.bind(("127.0.0.1", 0))
    ports = [s.getsockname()[1] for s in socks]
    for s in socks:
        s.close()
    return ports


def cluster_env() -> Dict[str, str]:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _checkpoint_step(ckpt_dir: str) -> int:
    """step recorded in a checkpoint manifest, -1 when absent/torn."""
    try:
        with open(os.path.join(ckpt_dir, "manifest.json")) as fh:
            return int(json.load(fh).get("step", -1))
    except (OSError, ValueError):
        return -1


def run_chaos_cluster(
    workdir: str,
    n: int = 3,
    instances: int = 6,
    *,
    algo: str = "otr",
    chaos: Optional[str] = None,
    crash_replica: Optional[int] = None,
    crash_after: int = 2,
    crash_wait_s: float = 60.0,
    timeout_ms: int = 250,
    max_rounds: int = 32,
    value_schedule: str = "uniform",
    seed: int = 0,
    adaptive: bool = False,
    proto: str = "tcp",
    join_timeout: float = 150.0,
    linger_ms: int = 8000,
    trace: bool = False,
    device: Optional[str] = None,
):
    """Run an n-process host cluster to completion, optionally under a
    chaos spec and one forced crash-restart.

    With ``crash_replica`` set, that replica is SIGKILLed once its
    durable checkpoint records >= ``crash_after`` completed instances
    (or after ``crash_wait_s``, whichever first) and immediately
    restarted with the same argv — recovery must come from the
    checkpoint plus the peers' decision-replay protocol.  The OTHER
    replicas get ``--linger-ms`` so they outlive the restart: a replica
    whose peers all exit before its interpreter even comes back up has
    nobody left to serve the decision replies catch-up depends on
    (host.serve_decisions).

    With ``trace``, every replica records a round-level event trace and a
    metrics snapshot (apps/host_replica.py --trace / --metrics-json into
    ``workdir/trace-<i>.jsonl`` / ``workdir/metrics-<i>.json``); the
    returned dict then also carries ``trace_files`` / ``metrics_files``
    for tools/trace_view.py to merge and correlate.

    ``device`` is each replica's ``--device`` (the card when None).

    Returns a dict with per-replica ``decisions`` (from the summary JSON
    line), ``log_bytes`` (the byte-exact instance→value decision-log TSV
    each replica wrote), ``outs`` (full summary JSONs) and ``restarts``.
    """
    os.makedirs(workdir, exist_ok=True)
    ports = alloc_ports(n)
    peer_arg = ",".join(f"127.0.0.1:{p}" for p in ports)
    env = cluster_env()

    def argv(i: int):
        a = [sys.executable, "-m", "round_tpu_torch.apps.host_replica",
             "--id", str(i), "--peers", peer_arg, "--algo", algo,
             "--instances", str(instances),
             "--timeout-ms", str(timeout_ms),
             "--max-rounds", str(max_rounds),
             "--seed", str(seed), "--proto", proto,
             "--value-schedule", value_schedule,
             "--decision-log", os.path.join(workdir, f"decisions-{i}.tsv"),
             "--checkpoint-dir", os.path.join(workdir, f"ckpt-{i}")]
        if chaos:
            a += ["--chaos", chaos]
        if trace:
            a += ["--trace", os.path.join(workdir, f"trace-{i}.jsonl"),
                  "--metrics-json", os.path.join(workdir,
                                                 f"metrics-{i}.json")]
        if adaptive:
            a += ["--adaptive-timeout"]
        if device is not None:
            a += ["--device", device]
        if (crash_replica is not None and i != crash_replica
                and linger_ms > 0):
            a += ["--linger-ms", str(linger_ms)]
        return a

    def launch(i: int):
        return subprocess.Popen(argv(i), stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, env=env)

    procs = {i: launch(i) for i in range(n)}
    restarts = 0
    try:
        if crash_replica is not None:
            ckpt = os.path.join(workdir, f"ckpt-{crash_replica}")
            t_end = time.monotonic() + crash_wait_s
            while (time.monotonic() < t_end
                   and _checkpoint_step(ckpt) < crash_after
                   and procs[crash_replica].poll() is None):
                time.sleep(0.05)
            if procs[crash_replica].poll() is None:
                # SIGKILL, not terminate: the point is an unclean death
                procs[crash_replica].send_signal(signal.SIGKILL)
                procs[crash_replica].wait(timeout=30)
                restarts += 1
                procs[crash_replica] = launch(crash_replica)
        outs = {}
        for i, p in enumerate(procs.values()):
            stdout, stderr = p.communicate(timeout=join_timeout)
            if p.returncode != 0:
                raise RuntimeError(
                    f"replica {i} failed (rc={p.returncode}): "
                    f"{stderr[-2000:]}")
            outs[i] = json.loads(stdout.strip().splitlines()[-1])
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                try:
                    p.communicate(timeout=10)
                except Exception:  # noqa: BLE001 - best-effort reap
                    pass
    log_bytes = {}
    for i in range(n):
        with open(os.path.join(workdir, f"decisions-{i}.tsv"), "rb") as fh:
            log_bytes[i] = fh.read()
    out = {
        "decisions": {i: outs[i].get("decisions") for i in outs},
        "log_bytes": log_bytes,
        "outs": outs,
        "restarts": restarts,
    }
    if trace:
        out["trace_files"] = {
            i: os.path.join(workdir, f"trace-{i}.jsonl") for i in range(n)}
        out["metrics_files"] = {
            i: os.path.join(workdir, f"metrics-{i}.json") for i in range(n)}
    return out
