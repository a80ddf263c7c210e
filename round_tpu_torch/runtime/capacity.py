"""Calibrated serving-capacity model: dps(drivers, lanes, payload) fitted
from measured open-loop knee curves (PERF_MODEL.md "serving capacity
model").

Port of round_tpu/runtime/capacity.py, unchanged (plain numpy: the same
samples give the same coefficients).  The knee samples the repo keeps
(CAPACITY_r0*.json) are round_tpu's host measurements.

Every A/B before the fleet tier was closed-loop (self-paced drivers),
which hides queueing collapse; the open-loop load generator
(apps/loadgen.py) measures latency-vs-offered-load to the KNEE — the
highest offered rate the fabric still serves without falling behind.
This module does for the serving tier what PERF_MODEL.md's roofline did
for the kernels, in the SCALE-Sim spirit of validating the model
against measurement: fit a small parametric form to the measured knees,
then FEED IT BACK — `--admission auto` (apps/host_replica.py) derives
the admission watermarks and the lane count from the model instead
of fixed defaults.

The declared form is a saturating power law,

    log(knee_dps) = b0 + b1·log(drivers) + b2·log(lanes)
                       + b3·log1p(payload_KiB)
                       + b4·read_frac + b5·lease_frac

fitted by least squares over the banked knee samples.  b1 is the
scale-out exponent (1.0 = perfect driver scaling), b2 the lane
amortization exponent (PERF_MODEL.md measured strong sub-linearity past
L≈64), b3 the payload tax.  b4/b5 are the READ axes (apps/kv.py bench
--sweep): read_frac is the fraction of offered ops that are reads,
lease_frac the fraction served at the lease grade — reads skip the
consensus write path entirely, so a read-heavy mix should lift the op
knee (b4 > 0) and lease-serving lifts it further (b5 > 0) because a
lease read costs one local frame instead of a round wave.  Knee
samples from the pre-KV benches simply omit the fields (0.0 default),
and the zero-variance pinning below keeps them out of the fit until a
sweep actually varies them.  The fit refuses (<3 distinct samples or a
singular design) rather than extrapolating from nothing.

Feedback derivations (documented in PERF_MODEL.md, pinned monotone by
tests/test_fleet.py):

  * ``admission_bytes_per_lane`` — Little's law on the lane queue: the
    budget is the bytes one lane can DRAIN within the latency SLO,
    ``rate_per_lane × slo × round_bytes(n, payload)``, clamped to
    [4 KiB, 1 MiB].  A deeper queue than that cannot clear in time —
    admitting it converts latency SLO violations into memory growth,
    which is what a fixed 256 KiB default guesses at.
  * ``recommended_lanes`` — the smallest lane bucket within 10% of the
    model's saturated throughput: lanes past the amortization knee cost
    memory and admission-budget surface for ~no dps.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, List

import numpy as np

from round_tpu_torch.runtime.instances import LANE_BUCKETS


class CapacityFitError(ValueError):
    """Not enough (or degenerate) knee samples to fit the model."""


@dataclasses.dataclass
class CapacityModel:
    """The fitted dps(drivers, lanes, payload) form + fit metadata."""

    b0: float
    b_drivers: float
    b_lanes: float
    b_payload: float
    r2: float
    n_samples: int
    samples: List[Dict[str, Any]] = dataclasses.field(default_factory=list)
    # read axes (apps/kv.py bench): 0.0 on pre-KV model artifacts
    b_read: float = 0.0
    b_lease: float = 0.0

    def predict_dps(self, drivers: int, lanes: int,
                    payload_bytes: int = 0, read_frac: float = 0.0,
                    lease_frac: float = 0.0) -> float:
        return math.exp(
            self.b0
            + self.b_drivers * math.log(max(1, drivers))
            + self.b_lanes * math.log(max(1, lanes))
            + self.b_payload * math.log1p(payload_bytes / 1024.0)
            + self.b_read * read_frac
            + self.b_lease * lease_frac)

    def recommended_lanes(self, drivers: int = 1,
                          payload_bytes: int = 0) -> int:
        """Smallest lane bucket within 10% of the saturated throughput —
        past the amortization knee, more lanes is memory, not
        decisions/sec.  Candidates are capped at the largest lane count
        the fit actually SAW: a pure power law never saturates, so
        recommending outside the measured range would be extrapolation
        dressed as calibration."""
        fitted_max = max((int(s.get("lanes", 1)) for s in self.samples),
                         default=LANE_BUCKETS[-1])
        buckets = [b for b in LANE_BUCKETS if b <= fitted_max] \
            or [LANE_BUCKETS[0]]
        sat = self.predict_dps(drivers, buckets[-1], payload_bytes)
        for b in buckets:
            if self.predict_dps(drivers, b, payload_bytes) >= 0.9 * sat:
                return b
        return buckets[-1]

    def admission_bytes_per_lane(self, n: int, lanes: int,
                                 payload_bytes: int = 0,
                                 drivers: int = 1,
                                 slo_ms: float = 1000.0) -> int:
        """Little's-law admission watermark (module docstring): the
        bytes one lane drains within the SLO, clamped to [4 KiB, 1 MiB].
        ``n`` is the consensus group size — one round wave queues up to
        n-1 inbound frames per lane."""
        rate_per_lane = self.predict_dps(
            drivers, lanes, payload_bytes) / max(1, drivers * lanes)
        # ~64 B of tag + codec framing per message around the payload
        round_bytes = max(1, n - 1) * (payload_bytes + 64)
        budget = rate_per_lane * (slo_ms / 1000.0) * round_bytes
        return int(min(max(budget, 4 << 10), 1 << 20))

    # -- persistence (the JSON artifact --admission auto consumes) --------

    def to_json(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)

    @classmethod
    def load(cls, path: str) -> "CapacityModel":
        with open(path) as f:
            d = json.load(f)
        return cls(**{k.name: d[k.name]
                      for k in dataclasses.fields(cls) if k.name in d})


def fit_capacity(samples: List[Dict[str, Any]]) -> CapacityModel:
    """Fit the power-law capacity model from measured knee samples.

    Each sample: ``{"drivers": D, "lanes": L, "payload_bytes": B,
    "knee_dps": dps}`` plus optional read axes ``read_frac`` /
    ``lease_frac`` (0.0 when absent — pre-KV samples) (extra keys ride
    along into the artifact).  Raises CapacityFitError on fewer than 3
    usable samples or a design matrix without enough variation to
    identify the exponents (columns with zero variance are PINNED to 0
    instead — a sweep that never varied payload fits b_payload = 0,
    honestly)."""
    rows = [s for s in samples if s.get("knee_dps", 0) > 0]
    if len(rows) < 3:
        raise CapacityFitError(
            f"need >= 3 positive knee samples, got {len(rows)}")
    y = np.log([float(s["knee_dps"]) for s in rows])
    cols = np.array([
        [1.0,
         math.log(max(1, int(s.get("drivers", 1)))),
         math.log(max(1, int(s.get("lanes", 1)))),
         math.log1p(int(s.get("payload_bytes", 0)) / 1024.0),
         float(s.get("read_frac", 0.0)),
         float(s.get("lease_frac", 0.0))]
        for s in rows])
    # pin unidentifiable exponents: a column that never varies carries
    # no information — lstsq would smear the intercept across it
    active = [0] + [j for j in (1, 2, 3, 4, 5)
                    if np.ptp(cols[:, j]) > 1e-12]
    if active == [0]:
        raise CapacityFitError(
            "degenerate design: no axis (drivers/lanes/payload) varies "
            "across the samples — an intercept-only 'model' cannot "
            "derive anything")
    coef = np.zeros(6)
    sol, _res, rank, _sv = np.linalg.lstsq(cols[:, active], y, rcond=None)
    if rank < len(active):
        raise CapacityFitError(
            "degenerate design: the sweep's axes are collinear")
    for j, c in zip(active, sol):
        coef[j] = c
    pred = cols @ coef
    ss_res = float(np.sum((y - pred) ** 2))
    ss_tot = float(np.sum((y - np.mean(y)) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return CapacityModel(
        b0=float(coef[0]), b_drivers=float(coef[1]),
        b_lanes=float(coef[2]), b_payload=float(coef[3]),
        b_read=float(coef[4]), b_lease=float(coef[5]),
        r2=round(r2, 4), n_samples=len(rows),
        samples=[{k: v for k, v in s.items()} for s in rows])


def derive_admission(model_path: str, n: int, lanes: int,
                     payload_bytes: int = 0,
                     slo_ms: float = 1000.0) -> Dict[str, int]:
    """The `--admission auto` entry point (apps/host_replica.py): load a
    fitted model artifact and derive {bytes_per_lane, lanes} — lanes is
    the model's recommendation only when the caller passed 0 (an
    explicit --lanes always wins)."""
    model = CapacityModel.load(model_path)
    out_lanes = lanes if lanes > 0 else model.recommended_lanes(
        payload_bytes=payload_bytes)
    return {
        "bytes_per_lane": model.admission_bytes_per_lane(
            n, out_lanes, payload_bytes=payload_bytes, slo_ms=slo_ms),
        "lanes": out_lanes,
    }
