"""Model-driven fleet control plane: the capacity-model loop closed LIVE
(docs/SERVING.md "planet-scale control plane", PERF_MODEL.md "control
loop").

A fleet sized at spawn time is capacity-fixed: a load swing past the
fitted knee can only be shed (the admission watermark's NACKs).  But the fitted
``dps(drivers, lanes, payload)`` surface (round_tpu/runtime/capacity.py,
CAPACITY_r03.json) PREDICTS how much fleet a given offered load needs —
so the SCALE-Sim-style discipline of validating the model against
measurement becomes a controller: watch the live knee signals, compare
them to the model, and resize the ring instead of shedding.

``FleetSupervisor`` owns that loop:

  * SIGNALS — windowed deltas read off the FleetRouter it supervises:
    offered rate (proposal deltas), achieved rate (resolution deltas),
    round-wall p99 vs the SLO (the router's decide latencies), NACK rate
    (shard shed pressure), and in-flight backlog.  No new wire traffic:
    the router already sees everything the controller needs.

  * DECISIONS — grow when offered load clears the model's headroom for
    the current fleet OR an SLO/NACK breach dwells (two+ consecutive
    windows: one bad window is noise, a dwell is a trend); shrink only
    under sustained slack against the model for the SMALLER fleet (the
    hysteresis gap keeps grow/shrink from oscillating around the knee),
    after a cooldown.  A breach while offered load is INSIDE the model's
    envelope is knee drift — the model is wrong, not the load — counted,
    banked as a live ``(drivers, lanes, payload, knee_dps)`` sample for
    the next ``capacity.fit`` refit (the r03 refit feeds on exactly
    these), and still answered by growing: measurement outranks model.

  * MOTION — a resize is a view move and is licensed like one: every
    grow/shrink passes ``rv/license.py`` (the machine-checked all-n
    proof envelope) BEFORE any ring change; a denial emits
    ``autoscale_refused``, ticks ``autoscale.refused`` AND the view
    subsystem's ``view.refused`` — never a silent move.  Growth spawns a
    DriverServer via the injected ``spawn`` hook and joins it to ONE
    region's inner ring (two-level ring: motion stays local); shrink
    removes the shard first — FleetRouter.remove_shard re-proposes its
    unresolved instances over the idempotent-PROPOSE primitive, zero
    decision loss (pinned byte-identical in tests/test_control.py) —
    and only then retires the process via the ``retire`` hook.

Every decision is BANKED (``decisions`` list: signals, model verdict,
license verdict, ring before/after) so the autoscale bench and the
fleet-autoscale soak rung can audit the trajectory: SLO held by scaling,
not shedding.

Port of round_tpu/runtime/control.py, unchanged: the supervisor is host
Python over the router's counters, and its default proof gate is
``rv/license.py``'s ``ProofLicenseRegistry`` with its default prover (the
port's verifier_cli, tracing on the card).
"""

from __future__ import annotations

import itertools
import time as _time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE
from round_tpu_torch.runtime.log import get_logger

log = get_logger("control")

# autoscale.* vocabulary (docs/OBSERVABILITY.md)
_C_STEPS = METRICS.counter("autoscale.steps")
_C_GROWS = METRICS.counter("autoscale.grows")
_C_SHRINKS = METRICS.counter("autoscale.shrinks")
_C_REFUSED = METRICS.counter("autoscale.refused")
_C_KNEE_DRIFT = METRICS.counter("autoscale.knee_drift")
_G_SHARDS = METRICS.gauge("autoscale.shards")
# an unlicensed resize is a refused view move: the SAME counter the
# ViewManager ticks (runtime/view.py), so the licensing dashboard sees
# supervisor refusals beside membership refusals
_C_VIEW_REFUSED = METRICS.counter("view.refused")


def _p99(samples: List[float]) -> Optional[float]:
    if not samples:
        return None
    s = sorted(samples)
    return s[min(len(s) - 1, int(0.99 * len(s)))]


class FleetSupervisor:
    """Close the capacity loop over one FleetRouter (module docstring).

    Single-threaded like the router itself: the serving loop (loadgen's
    open-loop pump, apps/fleet.py's bench) calls ``maybe_step()`` once
    per wave, exactly as it calls ``router.pump()`` — the controller is
    one more timer on the same event loop, never a thread racing the
    ring.

    ``spawn(name) -> replicas`` must return a READY replica address
    list (an in-process DriverServer's ``start()``, or a subprocess
    that already binds its ports — apps/fleet.py provides both);
    ``retire(name)`` tears the shard down AFTER its instances migrated.
    """

    def __init__(self, router, *,
                 algo_name: str,
                 n: int,
                 spawn: Callable[[str], List[Tuple[str, int]]],
                 retire: Callable[[str], None],
                 model=None,
                 lanes: int = 16,
                 payload_bytes: int = 0,
                 read_frac: float = 0.0,
                 slo_ms: float = 2000.0,
                 min_shards: int = 1,
                 max_shards: int = 8,
                 license_registry=None,
                 license_solve: Optional[bool] = None,
                 region_fn: Optional[Callable[[int], str]] = None,
                 headroom: float = 0.85,
                 shrink_frac: float = 0.45,
                 window_s: float = 2.0,
                 dwell_steps: int = 2,
                 cooldown_s: float = 5.0,
                 step_interval_s: float = 0.5,
                 nack_rate_tol: float = 1.0,
                 min_p99_samples: int = 5,
                 shard_prefix: str = "a"):
        if min_shards < 1 or max_shards < min_shards:
            raise ValueError(
                f"need 1 <= min_shards <= max_shards, got "
                f"[{min_shards}, {max_shards}]")
        self.router = router
        self.algo_name = algo_name
        self.n = int(n)
        self.spawn = spawn
        self.retire = retire
        self.model = model
        self.lanes = lanes
        self.payload_bytes = payload_bytes
        self.read_frac = read_frac
        self.slo_ms = slo_ms
        self.min_shards = min_shards
        self.max_shards = max_shards
        if license_registry is None:
            from round_tpu_torch.rv.license import ProofLicenseRegistry

            license_registry = ProofLicenseRegistry()
        self.license_registry = license_registry
        self.license_solve = license_solve
        self.region_fn = region_fn or (lambda i: "r0")
        self.headroom = headroom
        self.shrink_frac = shrink_frac
        self.window_s = window_s
        self.dwell_steps = dwell_steps
        self.cooldown_s = cooldown_s
        self.step_interval_s = step_interval_s
        self.nack_rate_tol = nack_rate_tol
        self.min_p99_samples = min_p99_samples
        self.shard_prefix = shard_prefix
        # the shards this supervisor is allowed to resize: seeded from
        # the ring it was handed, grown by every spawn
        self.owned: List[str] = list(router.ring.shards)
        self.spawned: List[str] = []
        self._next_idx = 0
        self.decisions: List[Dict[str, Any]] = []
        self.knee_samples: List[Dict[str, Any]] = []
        self.grows = 0
        self.shrinks = 0
        self.refused = 0
        self.knee_drifts = 0
        # signal windows
        self._samples: deque = deque()   # (t, proposals, resolved, nacks)
        self._lat_cursor = 0
        self._lat_window: deque = deque()  # (t, latency_ms)
        self._grow_dwell = 0
        self._shrink_dwell = 0
        self._last_step = 0.0
        self._cooldown_until = 0.0
        _G_SHARDS.set(len(self.owned))

    # -- signals -----------------------------------------------------------

    def _nack_total(self) -> int:
        return sum(h.get("nacks", 0)
                   for h in self.router.shard_health.values())

    def signals(self, now: float) -> Dict[str, Any]:
        """One window's worth of knee signals off the router: rates from
        the oldest in-window sample to now, p99 over the window's decide
        latencies."""
        lat = self.router.latency_ms
        for ms in itertools.islice(lat.values(), self._lat_cursor, None):
            self._lat_window.append((now, ms))
        self._lat_cursor = len(lat)
        horizon = now - self.window_s
        while self._lat_window and self._lat_window[0][0] < horizon:
            self._lat_window.popleft()
        self._samples.append((now, self.router.proposals,
                              len(self.router.results),
                              self._nack_total()))
        while len(self._samples) > 2 and self._samples[1][0] <= horizon:
            self._samples.popleft()
        t0, p0, r0, k0 = self._samples[0]
        dt = max(1e-6, now - t0)
        lats = [ms for _t, ms in self._lat_window]
        return {
            "offered_dps": (self.router.proposals - p0) / dt,
            "achieved_dps": (len(self.router.results) - r0) / dt,
            "nack_rate": (self._nack_total() - k0) / dt,
            "p99_ms": _p99(lats),
            "lat_samples": len(lats),
            "inflight": len(self.router._inflight),
        }

    def predicted_dps(self, drivers: int) -> Optional[float]:
        if self.model is None or drivers < 1:
            return None
        return float(self.model.predict_dps(
            drivers, self.lanes, payload_bytes=self.payload_bytes,
            read_frac=self.read_frac))

    # -- the control loop --------------------------------------------------

    def maybe_step(self, now: Optional[float] = None
                   ) -> Optional[Dict[str, Any]]:
        """Rate-limited ``step``: the serving loop calls this every
        wave; the controller actually evaluates once per
        ``step_interval_s``."""
        now = _time.monotonic() if now is None else now
        if now - self._last_step < self.step_interval_s:
            return None
        return self.step(now)

    def step(self, now: Optional[float] = None
             ) -> Optional[Dict[str, Any]]:
        """Evaluate the knee signals against the model and resize if the
        dwell/hysteresis discipline says so.  Returns the banked
        decision dict when a resize (or refusal) happened."""
        now = _time.monotonic() if now is None else now
        self._last_step = now
        _C_STEPS.inc()
        sig = self.signals(now)
        drivers = len(self.owned)
        pred = self.predicted_dps(drivers)
        p99 = sig["p99_ms"]
        breach_slo = (p99 is not None and p99 > self.slo_ms
                      and sig["lat_samples"] >= self.min_p99_samples)
        breach_nack = sig["nack_rate"] > self.nack_rate_tol
        breach = breach_slo or breach_nack
        over_model = (pred is not None
                      and sig["offered_dps"] > self.headroom * pred)
        if breach and pred is not None \
                and sig["offered_dps"] <= pred:
            # KNEE DRIFT: the model says this fleet holds the offered
            # load, the measurement disagrees — bank the live knee for
            # the refit; growth still answers the breach (measurement
            # outranks model)
            self.knee_drifts += 1
            _C_KNEE_DRIFT.inc()
            self.knee_samples.append({
                "drivers": drivers, "lanes": self.lanes,
                "payload_bytes": self.payload_bytes,
                "read_frac": self.read_frac,
                "knee_dps": sig["achieved_dps"],
                "why": "slo_breach" if breach_slo else "nack_rate",
                "predicted_dps": pred,
            })
        if breach or over_model:
            self._shrink_dwell = 0
            self._grow_dwell += 1
            if self._grow_dwell >= self.dwell_steps \
                    and now >= self._cooldown_until:
                reason = ("over_model" if over_model and not breach
                          else "slo_breach" if breach_slo
                          else "nack_rate")
                return self.grow(reason, now=now, signals=sig)
            return None
        pred_smaller = self.predicted_dps(drivers - 1)
        if (pred_smaller is not None and drivers > self.min_shards
                and sig["offered_dps"]
                < self.shrink_frac * pred_smaller
                and sig["inflight"] < self.lanes * drivers):
            self._grow_dwell = 0
            self._shrink_dwell += 1
            # shrink dwells twice as long as grow: spare capacity is
            # cheap, a flap back under load is not
            if self._shrink_dwell >= 2 * self.dwell_steps \
                    and now >= self._cooldown_until:
                return self.shrink("under_model", now=now, signals=sig)
            return None
        self._grow_dwell = 0
        self._shrink_dwell = 0
        return None

    # -- resize motion -----------------------------------------------------

    def _license(self):
        return self.license_registry.check(self.algo_name, self.n,
                                           solve=self.license_solve)

    def _bank(self, action: str, reason: str, now: float,
              signals: Optional[Dict[str, Any]], shard: Optional[str],
              region: Optional[str], before: int,
              lic) -> Dict[str, Any]:
        dec = {
            "t": now, "action": action, "reason": reason,
            "shard": shard, "region": region,
            "drivers_before": before, "drivers_after": len(self.owned),
            "predicted_dps": self.predicted_dps(len(self.owned)),
            "signals": dict(signals) if signals else None,
            "license": lic.to_json() if lic is not None else None,
        }
        self.decisions.append(dec)
        return dec

    def _refuse(self, action: str, reason: str, now: float,
                signals, lic) -> Dict[str, Any]:
        self.refused += 1
        _C_REFUSED.inc()
        _C_VIEW_REFUSED.inc()
        log.warning("autoscale %s REFUSED (%s): %s", action,
                    lic.status if lic is not None else "no-license",
                    lic.reason if lic is not None else reason)
        TRACE.emit("autoscale_refused", node=None, op=action,
                   n=self.n, status=lic.status if lic else "unlicensed",
                   reason=lic.reason if lic else reason)
        # refusals cool down too, or a standing breach re-asks the
        # prover every dwell
        self._cooldown_until = now + self.cooldown_s
        self._grow_dwell = 0
        self._shrink_dwell = 0
        return self._bank("refused", f"{action}:{reason}", now, signals,
                          None, None, len(self.owned), lic)

    def grow(self, reason: str = "manual", now: Optional[float] = None,
             signals: Optional[Dict[str, Any]] = None
             ) -> Optional[Dict[str, Any]]:
        """Spawn one DriverServer shard and join it to the ring —
        license first, ring change only on a grant."""
        now = _time.monotonic() if now is None else now
        if len(self.owned) >= self.max_shards:
            self._grow_dwell = 0
            return None  # at the fleet ceiling: shed is the only escape
        lic = self._license()
        if not lic.ok:
            return self._refuse("grow", reason, now, signals, lic)
        before = len(self.owned)
        name = f"{self.shard_prefix}{self._next_idx}"
        region = self.region_fn(self._next_idx)
        self._next_idx += 1
        replicas = self.spawn(name)
        self.router.add_shard(name, replicas, region=region)
        self.owned.append(name)
        self.spawned.append(name)
        self.grows += 1
        _C_GROWS.inc()
        _G_SHARDS.set(len(self.owned))
        self._grow_dwell = 0
        self._cooldown_until = now + self.cooldown_s
        log.info("autoscale grow -> %d shards (+%s in %s): %s",
                 len(self.owned), name, region, reason)
        TRACE.emit("autoscale_grow", node=None, shard=name,
                   region=region, shards=len(self.owned), reason=reason)
        return self._bank("grow", reason, now, signals, name, region,
                          before, lic)

    def shrink(self, reason: str = "manual",
               now: Optional[float] = None,
               signals: Optional[Dict[str, Any]] = None
               ) -> Optional[Dict[str, Any]]:
        """Retire the most recently spawned shard: licensed, then
        migrated (remove_shard re-proposes its unresolved instances —
        zero decision loss), then torn down."""
        now = _time.monotonic() if now is None else now
        if not self.spawned or len(self.owned) <= self.min_shards:
            self._shrink_dwell = 0
            return None  # only supervisor-spawned shards are victims
        lic = self._license()
        if not lic.ok:
            return self._refuse("shrink", reason, now, signals, lic)
        before = len(self.owned)
        name = self.spawned.pop()
        region = self.router.ring.region_of(name)
        migrated = self.router.remove_shard(name)
        self.owned.remove(name)
        self.retire(name)
        self.shrinks += 1
        _C_SHRINKS.inc()
        _G_SHARDS.set(len(self.owned))
        self._shrink_dwell = 0
        self._cooldown_until = now + self.cooldown_s
        log.info("autoscale shrink -> %d shards (-%s, %d migrated): %s",
                 len(self.owned), name, migrated, reason)
        TRACE.emit("autoscale_shrink", node=None, shard=name,
                   region=region, shards=len(self.owned),
                   migrated=migrated, reason=reason)
        dec = self._bank("shrink", reason, now, signals, name, region,
                         before, lic)
        dec["migrated"] = migrated
        return dec

    def summary(self) -> Dict[str, Any]:
        """The bench/soak banking surface."""
        return {
            "shards": len(self.owned),
            "grows": self.grows,
            "shrinks": self.shrinks,
            "refused": self.refused,
            "knee_drifts": self.knee_drifts,
            "decisions": list(self.decisions),
            "knee_samples": list(self.knee_samples),
        }
