"""The violation pipeline: typed obs events, rv.* counters, halt-and-dump.

Port of round_tpu/rv/dump.py: the same counters, event, artifact and
policies; the artifact is the port's ``fuzz/replay.py`` schema, which
round_tpu's loads too.

A tripped monitor must leave three things behind (docs/
RUNTIME_VERIFICATION.md "violation pipeline"):

  1. a typed trace event (``rv_violation``) + counters (``rv.checks``,
     ``rv.violations``, ``rv.dumps``, per-policy ``rv.halts`` /
     ``rv.sheds`` / ``rv.logged``) — the observability record;
  2. a halt-and-dump ARTIFACT in the fuzz/replay.py schedule-JSON
     format — protocol, n, seed, per-process proposals, the fault
     schedule in force (the --chaos-schedule artifact's drops, or a
     clean all-deliver wire), and an ``meta.rv`` block naming the
     tripped formula (spec/check.py:formula_label vocabulary), the
     replica, instance, round and observed decision plane.  Because the
     format IS the fuzz artifact format, ``fuzz_cli replay`` reproduces
     it bit-exactly on the batched engine and on the real host wire;
  3. the configured policy's action: ``halt`` raises RvViolation out of
     the driver (the artifact path rides the exception), ``shed``
     retires the instance undecided (accounted like an admission shed),
     ``log`` records and keeps serving.
"""

from __future__ import annotations

import dataclasses
import os
import re
import time as _time
from typing import Any, Dict, List, Optional

import numpy as np

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.log import get_logger

log = get_logger("rv")

POLICIES = ("halt", "shed", "log")

_C_CHECKS = METRICS.counter("rv.checks")
_C_VIOLATIONS = METRICS.counter("rv.violations")
_C_DUMPS = METRICS.counter("rv.dumps")
_C_POLICY = {p: METRICS.counter(f"rv.{p}s" if p != "log" else "rv.logged")
             for p in POLICIES}


class RvViolation(RuntimeError):
    """A monitor tripped under the ``halt`` policy.  Carries the formula
    label and the dump artifact path (None when dumping was off or
    failed)."""

    def __init__(self, label: str, inst: int, round_: int,
                 artifact: Optional[str]):
        self.label, self.inst, self.round = label, inst, round_
        self.artifact = artifact
        at = f" -> {artifact}" if artifact else ""
        super().__init__(
            f"runtime-verification violation: {label} "
            f"(instance {inst}, round {round_}){at}")


@dataclasses.dataclass
class RvConfig:
    """Driver-facing rv switches (host_replica --rv / fleet --rv).

    policy:        halt | shed | log (what a violation does).
    protocol:      the selector name, so dump artifacts are replayable
                   (None = events/counters only, no artifact).
    dump_dir:      artifact directory (None = no artifact).
    schedule_path: the --chaos-schedule artifact in force, copied into
                   the dump's drops so the replay runs the same wire.
    bank_engine:   record expected.engine into the artifact at dump time
                   (one engine replay — acceptable while halting;
                   turn off for latency-sensitive shed/log serving).
    gossip:        broadcast FLAG_DECISION on local decide, widening the
                   agreement monitor's observability to peers that are
                   NOT lagging (a laggard already learns decisions via
                   the TooLate/decision-reply recovery path, which the
                   monitor taps for free).  Off by default: the n²
                   decision fan-out interrupts the native pump's wait
                   per frame and measurably costs dps on fast-round
                   workloads — turn it on for adversarial deployments
                   (and the injected-violation tests) where decided
                   replicas must cross-check each other.
    max_dumps:     artifact cap per driver (a wedged monitor must not
                   fill the disk).
    """

    policy: str = "log"
    protocol: Optional[str] = None
    dump_dir: Optional[str] = None
    schedule_path: Optional[str] = None
    bank_engine: bool = True
    gossip: bool = False
    max_dumps: int = 8

    def __post_init__(self):
        if self.policy not in POLICIES:
            raise ValueError(
                f"rv policy must be one of {POLICIES}, got {self.policy!r}")


def _slug(label: str) -> str:
    return re.sub(r"[^a-zA-Z0-9]+", "-", label).strip("-")[:48] or "rv"


def dump_violation(cfg: RvConfig, *, n: int, seed: int, rounds: int,
                   values: List[int], node: int, inst: int, round_: int,
                   label: str, observed: Dict[str, Any],
                   device=None) -> Optional[str]:
    """Write one violation artifact (fuzz/replay.py schema + meta.rv);
    returns its path, or None when artifacts are not configured or the
    write failed (the obs record still stands either way).  The banked
    engine replay runs on ``device``, the driver's."""
    if cfg.protocol is None or cfg.dump_dir is None:
        return None
    from round_tpu_torch.fuzz import replay

    vplan = None
    if cfg.schedule_path is not None:
        src = replay.load_artifact(cfg.schedule_path)
        sched = replay.schedule_from_artifact(src)
        # a v2 source's VALUE plan rides into the dump too — a
        # lie-caused violation replays only if the lies replay
        # (round_tpu/byz; the same last-row clamp semantics)
        vplan = replay.value_plan_from_artifact(src)
        # the dump pins the VIOLATING run's horizon; the source schedule
        # clamps to its last row past its own horizon on every replay
        # surface, so truncation/extension below is outcome-neutral
        if sched.shape[0] >= rounds:
            sched = sched[:rounds]
            vplan = None if vplan is None else vplan[:rounds]
        else:
            pad = rounds - sched.shape[0]
            sched = np.concatenate(
                [sched, np.repeat(sched[-1:], pad, axis=0)])
            if vplan is not None:
                vplan = np.concatenate(
                    [vplan, np.repeat(vplan[-1:], pad, axis=0)])
    else:
        sched = np.ones((rounds, n, n), dtype=bool)
    try:
        art = replay.make_artifact(
            protocol=cfg.protocol, schedule=sched, value_plan=vplan,
            values=np.asarray(values, dtype=np.int64), seed=seed,
            meta={"rv": {
                "formula": label,
                "node": int(node),
                "instance": int(inst),
                "round": int(round_),
                "observed": observed,
                "wall": _time.time(),
            }})
        if cfg.bank_engine:
            art["expected"]["engine"] = replay.replay_engine(
                art, device=device)
        os.makedirs(cfg.dump_dir, exist_ok=True)
        path = os.path.join(
            cfg.dump_dir,
            f"rv-{cfg.protocol}-i{inst}-{_slug(label)}.json")
        replay.dump_artifact(path, art)
        _C_DUMPS.inc()
        return path
    except Exception as e:  # noqa: BLE001 — a failed dump must never
        # turn one violation into a second failure mode; the trace
        # event + counters already recorded the trip
        log.warning("rv: violation dump failed: %s", e)
        return None


class RvRuntime:
    """Per-driver violation bookkeeping, shared by LaneDriver and the
    HostRunner loop: counters, events, the dump rate limit, and the
    policy verdict the caller acts on (round_tpu/rv/dump.py::RvRuntime;
    ``device`` is where a dump's engine replay runs)."""

    def __init__(self, cfg: RvConfig, *, node: int, n: int, seed: int,
                 max_rounds: int, device=None):
        self.cfg = cfg
        self.device = device
        self.node, self.n = node, n
        self.seed, self.max_rounds = seed, max_rounds
        self.checks = 0
        self.violations: List[Dict[str, Any]] = []
        self.artifacts: List[str] = []
        self._dumped: set = set()

    def note_checks(self, k: int) -> None:
        self.checks += k
        _C_CHECKS.inc(k)

    def violate(self, *, inst: int, round_: int, label: str,
                values: List[int], observed: Dict[str, Any],
                where: str) -> str:
        """Record one tripped monitor.  Under the ``halt`` policy this
        RAISES RvViolation (artifact attached) after the record is
        banked — the ONE place the halt exception is built, so the
        drivers' sites cannot drift; otherwise returns the action the
        caller must take ('shed' | 'log')."""
        _C_VIOLATIONS.inc()
        _C_POLICY[self.cfg.policy].inc()
        rec = {"inst": int(inst), "round": int(round_), "formula": label,
               "where": where, "policy": self.cfg.policy}
        if TRACE.enabled:
            TRACE.emit("rv_violation", node=self.node, inst=int(inst),
                       round=int(round_), formula=label, where=where,
                       policy=self.cfg.policy)
        log.error("node %d: RV VIOLATION inst=%d round=%d %s (%s)",
                  self.node, inst, round_, label, where)
        key = (int(inst), label)
        artifact = None
        if key not in self._dumped and len(self.artifacts) \
                < self.cfg.max_dumps:
            self._dumped.add(key)
            artifact = dump_violation(
                self.cfg, n=self.n, seed=self.seed,
                rounds=self.max_rounds, values=values, node=self.node,
                inst=inst, round_=round_, label=label, observed=observed,
                device=self.device)
            if artifact is not None:
                rec["artifact"] = artifact
                self.artifacts.append(artifact)
        self.violations.append(rec)
        if self.cfg.policy == "halt":
            raise RvViolation(
                label, inst, round_,
                artifact if artifact is not None
                else (self.artifacts[-1] if self.artifacts else None))
        return self.cfg.policy

    def fill_stats(self, stats_out: Optional[Dict[str, Any]]) -> None:
        if stats_out is None:
            return
        stats_out["rv_checks"] = stats_out.get("rv_checks", 0) \
            + self.checks
        stats_out.setdefault("rv_violations", []).extend(self.violations)
        stats_out.setdefault("rv_artifacts", []).extend(self.artifacts)
