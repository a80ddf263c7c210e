"""SnapDriver: the one object the serving drivers hold.

Port of round_tpu/snap/driver.py; ``device`` is where the audit runs
and a violation dump's engine replay runs (the driver's device).

LaneDriver (runtime/lanes.py) and the HostRunner instance loop
(runtime/host.py) each construct ONE SnapDriver per run and touch it at
exactly three seams:

  * ``after_round(inst, r, leaves)`` — a round boundary completed on
    this replica: sample if the deterministic policy says so (all
    replicas agree on the rounds, snap/sample.py), ship or join
    locally;
  * ``on_frame(sender, tag, raw)`` — a FLAG_SNAP frame arrived: the
    collector replica joins it; anyone else drops it (a mis-addressed
    sample is wire noise, not an error);
  * ``flush()`` — the serving loop's housekeeping tick on the collector
    replica: expire part-cut deadlines, run the batched audit dispatch
    over assembled cuts, and hand back the instance ids the POLICY says
    to shed (halt raises SnapViolation out of here; log returns
    nothing).

Everything else — policy, budget, digests, epoch fencing, audit
compilation, artifact dumping — lives behind those three calls, so the
drivers' wiring stays the rv-hook size.
"""

from __future__ import annotations

import time as _time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from round_tpu_torch.runtime.log import get_logger
from round_tpu_torch.snap.audit import (
    CutAuditor, SnapConfig, SnapRuntime, audit_program,
)
from round_tpu_torch.snap.collect import SnapCollector, envelope_f_max
from round_tpu_torch.snap.sample import SampleEmitter, SnapPolicy

log = get_logger("snap")

# flush cadence: deadlines and audit batching are coarse-grained — a
# serving tick is not.  The driver calls flush() every loop iteration;
# this floor keeps the poll/audit machinery off the hot path between
# samples (assembled cuts still audit promptly: the interval is well
# under the cut deadline).
_FLUSH_INTERVAL_S = 0.05


class SnapDriver:
    """One replica's snapshot subsystem (module docstring)."""

    def __init__(self, cfg: SnapConfig, algo, *, node: int, n: int,
                 seed: int, max_rounds: int, transport,
                 value_schedule: str = "mixed", base_value: int = 0,
                 admission=None, view=None, device=None):
        self.cfg = cfg
        self.algo = algo
        self.node, self.n = node, n
        self.view = view
        self._removed = False
        self.is_collector = (node == cfg.collector)
        self.device = device
        self.runtime = SnapRuntime(cfg, node=node, n=n, seed=seed,
                                   max_rounds=max_rounds, device=device)
        policy = SnapPolicy(every_k=cfg.every_k, seed=seed,
                            budget_bytes_per_s=cfg.budget_bytes_per_s)
        self.collector: Optional[SnapCollector] = None
        self.auditor: Optional[CutAuditor] = None
        if self.is_collector:
            self.collector = SnapCollector(
                n, envelope_f=envelope_f_max(algo, n),
                deadline_ms=cfg.cut_deadline_ms,
                epoch=(view.epoch if view is not None else 0),
                bank_dir=cfg.bank_dir, protocol=cfg.protocol)
            self.auditor = CutAuditor(self._compile_program(n),
                                      self.runtime, self.collector)
        if view is not None:
            # epoch fencing + resize recompile ride the SAME observer
            # fan-out as PeerHealth.resize and the fleet rebalance —
            # one view move, every subscriber (view.py add_observer).
            # Registered on EVERY replica: the emitters' proposal-row
            # width tracks n too, not just the collector's join state.
            view.add_observer(self.on_view_change)
        self.emitter = SampleEmitter(
            node, policy, transport, cfg.collector,
            sink=self.collector, admission=admission)
        self._value_rows: Dict[int, List[int]] = {}
        self._value_args = (value_schedule, base_value)
        self._last_flush = 0.0

    # -- emission ----------------------------------------------------------

    def _epoch(self) -> int:
        return self.view.epoch if self.view is not None else 0

    def note_client_value(self, inst: int, scalar: int) -> None:
        """A client-proposed instance (the fleet's uniform-proposal
        contract): the proposal row is the client scalar at every pid —
        deterministic cluster-wide, like the schedule."""
        self._value_rows[inst & 0xFFFF] = [int(scalar)] * self.n
        while len(self._value_rows) > 8192:
            # oldest-first eviction (the _DONE_CAP discipline), never a
            # wholesale clear: a live instance's row must survive the
            # cap — a cleared row falls back to the schedule value,
            # which DIFFERS from the client's proposal and would record
            # values-mismatch divergences on a clean serve shard.  The
            # driver forgets rows on lane retire, so the map is bounded
            # by live lanes in steady state; this cap is the backstop.
            self._value_rows.pop(next(iter(self._value_rows)))

    def forget_value(self, inst: int) -> None:
        """The instance retired: its proposal row is dead bookkeeping
        (emission only happens for live lanes, always before retire)."""
        self._value_rows.pop(inst & 0xFFFF, None)

    def due(self, inst: int, r: int) -> bool:
        """Cheap policy pre-check for callers whose sample EXTRACTION
        itself costs (the lane driver's per-lane state-row copies):
        emit() re-checks, so skipping the call on a not-due round is
        pure savings, never a behavior change."""
        return self.emitter.policy.due(inst, r)

    def _values(self, inst: int) -> List[int]:
        row = self._value_rows.get(inst & 0xFFFF)
        if row is not None:
            return row
        from round_tpu_torch.runtime.host import _schedule_value

        vs, bv = self._value_args
        return [_schedule_value(vs, bv, pid, inst)
                for pid in range(self.n)]

    def after_round(self, inst: int, r: int,
                    leaves: Sequence[np.ndarray]) -> None:
        """One completed round boundary on this replica (post-update
        state rows, zero extra dispatches — engine/executor.py
        lane_sample_rows is the lane driver's extraction contract)."""
        if self._removed:
            return  # left the group: this pid now names someone else
        self.emitter.emit(inst, r, self._epoch(), list(leaves),
                          self._values(inst))

    # -- collection --------------------------------------------------------

    def on_frame(self, sender: int, tag, raw) -> None:
        if self.collector is not None:
            self.collector.on_frame(sender, tag, raw)

    def on_view_change(self, renames, n: int) -> None:
        """One membership move (auto-registered on the ViewManager when
        one exists; callable manually by driver-less tests): track the
        new n on the emitter side, follow this replica's RENAME (a
        remove compacts the surviving pids — a sample stamped the old
        pid while the transport speaks the new one is refused by the
        collector's sender check as a forged row), and on the collector
        replica sync the epoch fence to the MANAGER'S epoch (an
        adopt_wire catch-up can jump it by more than one move — a bare
        increment would refuse every sample forever), re-derive the
        envelope tolerance, and RECOMPILE the audit program at the new
        n — a program compiled at the old n would silently skip every
        post-resize cut through the auditor's geometry guard while
        cuts_audited kept counting."""
        self.n = n
        self.runtime.n = n   # violation artifacts record the CUT's n
        if renames:
            new_node = renames.get(self.node, self.node)
            if new_node is None:
                # this replica left the group: nothing further to emit
                # (the loop unwinds; a late after_round must not stamp
                # a pid that now names someone else)
                self._removed = True
            else:
                self.node = new_node
                self.emitter.node = new_node
                self.runtime.node = new_node
        # the collector ROLE rides the pid, not the process: whoever
        # holds cfg.collector in the CURRENT view assembles cuts
        if self.collector is None and not self._removed \
                and self.node == self.cfg.collector:
            self.is_collector = True
            self.collector = SnapCollector(
                n, envelope_f=envelope_f_max(self.algo, n),
                deadline_ms=self.cfg.cut_deadline_ms,
                epoch=(self.view.epoch if self.view is not None else 0),
                bank_dir=self.cfg.bank_dir, protocol=self.cfg.protocol)
            self.auditor = CutAuditor(self._compile_program(n),
                                      self.runtime, self.collector)
            self.emitter.sink = self.collector
            return
        if self.collector is not None \
                and (self._removed or self.node != self.cfg.collector):
            # lost the role: flush nothing (the epoch fence would drop
            # the part-cuts anyway) and go back to shipping samples to
            # whoever holds the collector pid now
            self.is_collector = False
            self.collector = None
            self.auditor = None
            self.emitter.sink = None
            return
        if self.collector is not None:
            self.collector.on_view_change(
                renames, n,
                epoch=(self.view.epoch if self.view is not None
                       else None),
                envelope_f=envelope_f_max(self.algo, n))
        if self.auditor is not None:
            # swap in place: the auditor's counters and the runtime's
            # violation bank survive the resize
            self.auditor.program = self._compile_program(n)

    def _compile_program(self, n: int):
        program = audit_program(self.algo, n, device=self.device)
        if program is None:
            log.info("snap: %s carries no cut-auditable formulas — "
                     "digest/divergence layer only",
                     type(self.algo).__name__)
        elif program.skipped:
            log.info("snap: auditing %s; not cut-evaluable: %s",
                     program.labels, program.skipped)
        return program

    # -- audit -------------------------------------------------------------

    def flush(self, force: bool = False) -> List[int]:
        """Collector housekeeping: expire deadlines, audit assembled
        cuts, return instance ids to shed.  Cheap no-op off the
        collector replica and between flush intervals.  ALWAYS ships
        buffered samples first (every replica; covers the pump-send
        path, whose native round flush bypasses the Python per-peer
        buffers the emitter coalesces into)."""
        self.emitter.flush()
        if self.collector is None:
            return []
        now = _time.monotonic()
        if not force and now - self._last_flush < _FLUSH_INTERVAL_S \
                and not self.collector._ready:
            return []
        self._last_flush = now
        if force:
            # end-of-run: resolve every pending part-cut NOW (the
            # envelope tolerance decides partial vs dropped)
            self.collector.poll(now + self.cfg.cut_deadline_ms / 1000.0
                                + 1.0)
        else:
            self.collector.poll(now)
        return self.auditor.audit(self.collector.take())

    # -- stats -------------------------------------------------------------

    def fill_stats(self, stats_out: Optional[Dict[str, Any]]) -> None:
        if stats_out is None:
            return
        self.runtime.fill_stats(stats_out)
        stats_out["snap_samples"] = stats_out.get("snap_samples", 0) \
            + self.emitter.samples
        stats_out["snap_sample_bytes"] = \
            stats_out.get("snap_sample_bytes", 0) \
            + self.emitter.sample_bytes
        stats_out["snap_skipped"] = stats_out.get("snap_skipped", 0) \
            + self.emitter.skipped
        if self.collector is not None:
            stats_out["snap_cuts"] = stats_out.get("snap_cuts", 0) \
                + self.collector.cuts
            stats_out["snap_partial_cuts"] = \
                stats_out.get("snap_partial_cuts", 0) \
                + self.collector.partial
            stats_out.setdefault("snap_divergences", []).extend(
                self.collector.divergences)
            if self.auditor is not None:
                stats_out["snap_cuts_audited"] = \
                    stats_out.get("snap_cuts_audited", 0) \
                    + self.auditor.cuts_audited
