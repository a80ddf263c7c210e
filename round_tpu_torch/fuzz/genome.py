"""Fault-schedule genomes: the fault model as an evolvable tensor.

Port of round_tpu/fuzz/genome.py.  A genome is one structured fault
schedule, exactly the per-scenario parameters the fused engine batches
(``engine.fast.FaultMix``: crash sets, partition sides, a rotating
suppressed coordinator, an iid-omission threshold, hash salts) plus a
byzantine-silence membership mask and the value-adversary fields.  A
population is one set of numpy arrays with a leading [P] axis; evaluating
all P candidates is one batched program (fuzz/search.py).

Two invariants make a genome portable:

  * engine-runnable: ``row_sampler`` extends ``scenarios.from_fault_params``
    with the byzantine-silence term, and the batched evaluator draws the
    same masks for a whole population through ``engine.fast.mix_ho``;
  * schedule-expressible: ``row_schedule`` materializes the genome into an
    explicit ``[T, n, n]`` HO schedule, bit-identical to what the sampler
    draws, the form fuzz/minimize.py delta-debugs.

Mutation and crossover operate per fault family, on the host, in numpy:
the same ``np.random.Generator`` gives the same arrays as round_tpu's.
``seed_population`` draws through the port's ``standard_mix``
(``torch.Generator``), so its rows differ from round_tpu's.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from round_tpu_torch.byz.adversary import _link_u32
from round_tpu_torch.engine import scenarios
from round_tpu_torch.engine.fast import FaultMix
from round_tpu_torch.utils.device import resolve_device

# Byzantine-silence stream constant: the per-(round, link) "is this
# receiver in the silenced half" Bernoulli(1/2) draws from the same
# counter-based link hash as every other family
STREAM_BYZ = 0xB5F0D1E3

# omission mutation cap: p8 < 232 (~91% loss) keeps the all-drop schedule
# out of the search space
P8_CAP = 232


def value_cap_default(n: int) -> int:
    """The byzantine-value mutation envelope: at most ``(n - 1) // 3``
    liars, the classic n > 3f budget (round_tpu/fuzz/genome.py::
    value_cap_default)."""
    return max(0, (n - 1) // 3)


#: the family blocks crossover inherits wholesale (field name -> leaves)
FAMILIES: Dict[str, tuple] = {
    "omission": ("p8",),
    "crash": ("crashed", "crash_round"),
    "partition": ("side", "heal_round"),
    "rotate": ("rotate_down",),
    "byz": ("byz",),
    "byzval": ("byz_value", "equiv_p8", "stale_p8"),
    "salts": ("salt0", "salt1"),
}

_FIELDS = ("crashed", "crash_round", "side", "heal_round", "rotate_down",
           "p8", "salt0", "salt1", "byz", "byz_value", "equiv_p8",
           "stale_p8")

#: value-adversary fields absent from a row dict get zero defaults
_VALUE_FIELDS = ("byz_value", "equiv_p8", "stale_p8")

_BOOL_FIELDS = ("crashed", "byz", "byz_value")


@dataclasses.dataclass
class Population:
    """[P] fault-schedule genomes as host-side numpy arrays
    (round_tpu/fuzz/genome.py::Population).

    Leaves mirror engine.fast.FaultMix (leading axis [P]) plus ``byz [P, n]
    bool``, byzantine-silence membership (a byzantine process is silent
    toward a hash-drawn half of the receivers each round)."""

    crashed: np.ndarray      # [P, n] bool
    crash_round: np.ndarray  # [P] int32
    side: np.ndarray         # [P, n] int32
    heal_round: np.ndarray   # [P] int32
    rotate_down: np.ndarray  # [P] int32
    p8: np.ndarray           # [P] int32
    salt0: np.ndarray        # [P] int32
    salt1: np.ndarray        # [P] int32
    byz: np.ndarray          # [P, n] bool
    byz_value: np.ndarray    # [P, n] bool: value adversaries (byz/)
    equiv_p8: np.ndarray     # [P] int32: equivocation threshold /256
    stale_p8: np.ndarray     # [P] int32: stale-replay threshold /256

    @property
    def size(self) -> int:
        return self.crashed.shape[0]

    @property
    def n(self) -> int:
        return self.crashed.shape[1]

    def mix(self, device=None) -> FaultMix:
        """The FaultMix view on ``device`` (drops byz-silence; carries the
        value tensors), what engine.fast consumes."""
        t = stage(self.arrays(), device)
        return FaultMix(**{f: t[f] for f in _FIELDS if f != "byz"})

    def arrays(self) -> Dict[str, np.ndarray]:
        """Every leaf as bool or int32 numpy, keyed by field."""
        return {f: np.asarray(getattr(self, f)).astype(
            bool if f in _BOOL_FIELDS else np.int32) for f in _FIELDS}

    def leaves(self) -> tuple:
        """The per-field tuple (axis 0 = the population)."""
        return tuple(getattr(self, f) for f in _FIELDS)

    def row(self, i: int) -> Dict[str, np.ndarray]:
        """Genome i as a field dict (artifact/minimizer currency)."""
        return {f: np.asarray(getattr(self, f)[i]) for f in _FIELDS}

    def take(self, idx) -> "Population":
        idx = np.asarray(idx)
        return Population(**{f: np.asarray(getattr(self, f))[idx]
                             for f in _FIELDS})

    @classmethod
    def from_rows(cls, rows) -> "Population":
        rows = [dict(r) for r in rows]
        for r in rows:
            _fill_value_fields(r)
        return cls(**{f: np.stack([np.asarray(r[f]) for r in rows])
                      for f in _FIELDS})

    @classmethod
    def from_mix(cls, mix: FaultMix, byz: Optional[np.ndarray] = None
                 ) -> "Population":
        # np.array(copy=True): the genetic operators mutate in place
        kw = {f: np.array(getattr(mix, f).cpu())
              for f in _FIELDS
              if f != "byz" and getattr(mix, f, None) is not None}
        P, n = kw["crashed"].shape
        kw["byz"] = (np.zeros((P, n), dtype=bool) if byz is None
                     else np.asarray(byz, dtype=bool))
        kw.setdefault("byz_value", np.zeros((P, n), dtype=bool))
        kw.setdefault("equiv_p8", np.zeros((P,), dtype=np.int32))
        kw.setdefault("stale_p8", np.zeros((P,), dtype=np.int32))
        return cls(**kw)


# ---------------------------------------------------------------------------
# Host <-> device: one copy each way per batched evaluation
# ---------------------------------------------------------------------------

_NARROW = {np.dtype(bool): torch.bool, np.dtype(np.int8): torch.int8,
           np.dtype(np.uint8): torch.uint8, np.dtype(np.int16): torch.int16,
           np.dtype(np.int32): torch.int32}
_TORCH_TO_NP = {v: k for k, v in _NARROW.items()}
_TORCH_TO_NP[torch.float32] = np.dtype(np.float32)


def stage(arrays: Dict[str, np.ndarray], device=None
          ) -> Dict[str, torch.Tensor]:
    """numpy ``[P, ...]`` arrays (bool, integers up to 32 bits, float32) on
    ``device`` through ONE host-to-device copy: each array is a run of
    int32 columns of one buffer, viewed back in its own dtype there."""
    dev = resolve_device(device)
    cols, layout = [], []
    for k, a in arrays.items():
        a = np.asarray(a)
        flat = a.reshape(a.shape[0], -1)
        if a.dtype == np.float32:
            flat = flat.view(np.int32)
        elif a.dtype not in _NARROW:
            raise TypeError(f"stage: {k} is {a.dtype}")
        cols.append(flat.astype(np.int32))
        layout.append((k, a.dtype, a.shape[1:], flat.shape[1]))
    buf = torch.as_tensor(np.concatenate(cols, axis=1)).to(dev)
    out, at = {}, 0
    for k, dtype, shape, w in layout:
        col = buf[:, at:at + w]
        at += w
        if dtype == np.float32:
            col = col.view(torch.float32)
        elif dtype == bool:
            col = col != 0
        elif dtype != np.int32:
            col = col.to(_NARROW[dtype])
        out[k] = col.reshape((col.shape[0],) + tuple(shape))
    return out


def fetch(tensors: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The inverse of ``stage``: ``[P, ...]`` tensors (bool, integers up to
    32 bits, float32) to numpy through ONE device-to-host copy."""
    cols, layout = [], []
    for k, t in tensors.items():
        if t.dtype not in _TORCH_TO_NP:
            raise TypeError(f"fetch: {k} is {t.dtype}")
        flat = t.reshape(t.shape[0], -1)
        flat = (flat.view(torch.int32) if t.dtype == torch.float32
                else flat.to(torch.int32))
        cols.append(flat)
        layout.append((k, _TORCH_TO_NP[t.dtype], tuple(t.shape), flat.shape[1]))
    buf = torch.cat(cols, dim=1).cpu().numpy()
    out, at = {}, 0
    for k, dtype, shape, w in layout:
        col = np.ascontiguousarray(buf[:, at:at + w])
        at += w
        if dtype == np.float32:
            col = col.view(np.float32)
        elif dtype == bool:
            col = col != 0
        else:
            col = col.astype(dtype)
        out[k] = col.reshape(shape)
    return out


def _fill_value_fields(row: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """In place: default the value-adversary fields of a row dict to zeros
    (the truthful adversary)."""
    n = int(np.asarray(row["crashed"]).shape[-1])
    row.setdefault("byz_value", np.zeros((n,), dtype=bool))
    row.setdefault("equiv_p8", np.int32(0))
    row.setdefault("stale_p8", np.int32(0))
    return row


# ---------------------------------------------------------------------------
# Engine bridge: genome -> HO sampler / explicit schedule
# ---------------------------------------------------------------------------


def byz_silence(byz, salt0, salt1, r, n: int) -> torch.Tensor:
    """``[.., n(recv), n(send)]`` bool: True where a byzantine sender is
    silent toward this receiver in round r: byz membership AND the
    per-(round, link) hash half (p = 1/2), diagonal excluded
    (round_tpu/fuzz/genome.py::byz_silence).  ``byz`` is ``[.., n]``, the
    salts ``[..]`` (leading dims broadcast, so a population's masks come
    from one call)."""
    byz = torch.as_tensor(byz) != 0
    dev = byz.device
    half = (_link_u32(salt0, salt1, r, n, STREAM_BYZ, dev) & 0xFF) < 128
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    return byz[..., None, :] & half & ~eye


def row_sampler(n: int, crashed, crash_round, side, heal_round, rotate_down,
                p8, salt0, salt1, byz=None):
    """HO sampler ``(key, r) -> [n, n] bool`` for ONE genome: exactly
    ``scenarios.from_fault_params`` with the byzantine-silence term ANDed
    in (round_tpu/fuzz/genome.py::row_sampler).  Runs on the device of
    ``crashed``."""
    base = scenarios.from_fault_params(
        n, crashed, crash_round, side, heal_round, rotate_down, p8,
        salt0, salt1)
    dev = torch.as_tensor(crashed).device

    def sample(key, r):
        ho = base(key, r)
        if byz is not None:
            ho = ho & ~byz_silence(torch.as_tensor(byz, device=dev),
                                   salt0, salt1, r, n)
        return ho

    return sample


def schedule_fn(n: int, rounds: int):
    """``leaves -> [rounds, n, n] bool`` materializer: the genome as an
    explicit HO schedule, bit-identical to ``row_sampler``'s draws
    (round_tpu/fuzz/genome.py::schedule_fn)."""

    def materialize(crashed, crash_round, side, heal_round, rotate_down,
                    p8, salt0, salt1, byz):
        samp = row_sampler(n, crashed, crash_round, side, heal_round,
                           rotate_down, p8, salt0, salt1, byz)
        return torch.stack([samp(None, r) for r in range(rounds)])

    return materialize


#: the fields schedule_fn consumes: the delivery half of the genome; the
#: value-adversary fields materialize separately (row_value_plan)
_SCHEDULE_FIELDS = ("crashed", "crash_round", "side", "heal_round",
                    "rotate_down", "p8", "salt0", "salt1", "byz")


def row_schedule(row: Dict[str, np.ndarray], rounds: int,
                 device=None) -> np.ndarray:
    """One genome row dict as a numpy ``[rounds, n, n]`` bool deliver
    schedule (round_tpu/fuzz/genome.py::row_schedule), computed on
    ``device``."""
    dev = resolve_device(device)
    n = int(np.asarray(row["crashed"]).shape[-1])
    args = [torch.as_tensor(np.asarray(row[f]), device=dev)
            for f in _SCHEDULE_FIELDS]
    return schedule_fn(n, rounds)(*args).cpu().numpy()


def row_value_plan(row: Dict[str, np.ndarray], rounds: int,
                   num_values: int, device=None) -> np.ndarray:
    """One genome row's value-fault fields as the explicit ``[rounds, n,
    n] int32`` substitution plan (byz/adversary.py opcodes), bit-identical
    to the hash-mode draws of the batched evaluation
    (round_tpu/fuzz/genome.py::row_value_plan)."""
    from round_tpu_torch.byz import adversary as _adv

    row = _fill_value_fields(dict(row))
    return _adv.value_plan(row, rounds, num_values, device=device)


# ---------------------------------------------------------------------------
# Severity: how much fault a genome spends
# ---------------------------------------------------------------------------


def severity(pop: Population, horizon: int) -> np.ndarray:
    """[P] float64: normalized fault intensity, the search's spending meter
    (round_tpu/fuzz/genome.py::severity).  Of two schedules that hurt
    equally, the search prefers the sparser one."""
    h = max(1, horizon)
    crash_frac = pop.crashed.mean(axis=1) * np.clip(
        (h - pop.crash_round) / h, 0.0, 1.0)
    # a partition only costs while it is active and actually splits
    split = (pop.side.max(axis=1) != pop.side.min(axis=1))
    part_frac = split * np.clip(pop.heal_round / h, 0.0, 1.0)
    # value adversaries: rent scales with membership AND lie intensity
    value_frac = pop.byz_value.mean(axis=1) * np.clip(
        (pop.equiv_p8 + pop.stale_p8) / 256.0, 0.0, 1.0)
    return (pop.p8 / 256.0
            + crash_frac
            + 0.5 * part_frac
            + 0.25 * (pop.rotate_down > 0)
            + 0.5 * pop.byz.mean(axis=1)
            + 0.75 * value_frac).astype(np.float64)


# ---------------------------------------------------------------------------
# Seeding, mutation, crossover
# ---------------------------------------------------------------------------


def seed_population(seed: int, P: int, n: int, horizon: int,
                    p_drop: float = 0.25) -> Population:
    """The initial population: ``engine.fast.standard_mix``'s four-family
    split with byz off and every 8th row zeroed to fault-free
    (round_tpu/fuzz/genome.py::seed_population).  Drawn on the host from a
    ``torch.Generator`` seeded with ``seed``, so the rows differ from
    round_tpu's threefry draws; the structure is the same."""
    from round_tpu_torch.engine.fast import standard_mix

    gen = torch.Generator().manual_seed(seed)
    mix = standard_mix(gen, P, n, p_drop=p_drop,
                       heal_round=min(5, max(1, horizon // 2)),
                       device="cpu")
    pop = Population.from_mix(mix)
    clean = np.arange(P) % 8 == 7
    pop.crashed[clean] = False
    pop.side[clean] = 0
    pop.heal_round[clean] = 0
    pop.rotate_down[clean] = 0
    pop.p8[clean] = 0
    return pop


def _flip_one_capped(rng: np.random.Generator, mask_rows: np.ndarray,
                     rows: np.ndarray, cap: int) -> None:
    """Toggle one random bit per selected row of a [P, n] bool matrix,
    refusing toggles that would push the row's popcount past ``cap``
    (round_tpu/fuzz/genome.py::_flip_one_capped)."""
    n = mask_rows.shape[1]
    for i in rows:
        j = int(rng.integers(n))
        if mask_rows[i, j] or mask_rows[i].sum() < cap:
            mask_rows[i, j] = ~mask_rows[i, j]


def mutate(rng: np.random.Generator, pop: Population, horizon: int,
           rate: float = 0.9,
           value_cap: Optional[int] = None) -> Population:
    """Per-family point mutations: each row draws ~1-2 of the seven family
    operators (round_tpu/fuzz/genome.py::mutate).  ``value_cap`` bounds
    the byzantine-value membership per row (default ``(n-1)//3``; 0 keeps
    the value adversary out of the gene pool).  Returns a new population
    (inputs untouched)."""
    P, n = pop.size, pop.n
    out = pop.take(np.arange(P))  # deep copy via fancy-index
    h = max(1, horizon)
    if value_cap is None:
        value_cap = value_cap_default(n)
    ops = rng.random((P, 7)) < (rate / 3.0)

    r = np.flatnonzero(ops[:, 0])      # omission intensity
    out.p8[r] = np.clip(out.p8[r] + rng.integers(-48, 49, r.size),
                        0, P8_CAP).astype(np.int32)

    r = np.flatnonzero(ops[:, 1])      # crash set / onset
    _flip_one_capped(rng, out.crashed, r, cap=max(1, n // 3))
    out.crash_round[r] = np.clip(
        out.crash_round[r] + rng.integers(-2, 3, r.size), 0, h - 1
    ).astype(np.int32)

    r = np.flatnonzero(ops[:, 2])      # partition side / heal horizon
    for i in r:
        out.side[i, int(rng.integers(n))] ^= 1
    out.heal_round[r] = np.clip(
        out.heal_round[r] + rng.integers(-3, 4, r.size), 0, h
    ).astype(np.int32)

    r = np.flatnonzero(ops[:, 3])      # coordinator-down period
    choices = np.array([0, 1, 2, 4], dtype=np.int32)
    out.rotate_down[r] = rng.choice(choices, r.size)

    r = np.flatnonzero(ops[:, 4])      # byzantine-silence membership
    _flip_one_capped(rng, out.byz, r, cap=max(1, n // 3))

    r = np.flatnonzero(ops[:, 5])      # link-pattern reroll
    out.salt0[r] = rng.integers(0, 2**32, r.size, dtype=np.uint32) \
        .astype(np.int64).astype(np.int32)
    out.salt1[r] = rng.integers(0, 2**32, r.size, dtype=np.uint32) \
        .astype(np.int64).astype(np.int32)

    r = np.flatnonzero(ops[:, 6])      # value-adversary family
    if value_cap > 0:
        _flip_one_capped(rng, out.byz_value, r, cap=value_cap)
        out.equiv_p8[r] = np.clip(
            out.equiv_p8[r] + rng.integers(-64, 65, r.size), 0, P8_CAP
        ).astype(np.int32)
        out.stale_p8[r] = np.clip(
            out.stale_p8[r] + rng.integers(-48, 49, r.size), 0, P8_CAP
        ).astype(np.int32)
    else:
        # cap 0 = the benign fault model: the family stays off, and any
        # inherited value genes are scrubbed
        out.byz_value[:] = False
        out.equiv_p8[:] = 0
        out.stale_p8[:] = 0
    # over-cap rows are trimmed back to the envelope, highest-index
    # members first
    over = np.flatnonzero(out.byz_value.sum(axis=1) > max(value_cap, 0))
    for i in over:
        members = np.flatnonzero(out.byz_value[i])
        out.byz_value[i, members[max(value_cap, 0):]] = False
    return out


def crossover(rng: np.random.Generator, pop: Population,
              parents_a: np.ndarray, parents_b: np.ndarray) -> Population:
    """Family-block recombination: each child inherits every leaf of a
    fault family wholesale from parent A or B, a coin per family
    (round_tpu/fuzz/genome.py::crossover)."""
    a, b = pop.take(parents_a), pop.take(parents_b)
    child = a.take(np.arange(a.size))
    for fam, fields in FAMILIES.items():
        from_b = rng.random(a.size) < 0.5
        for f in fields:
            arr = getattr(child, f)
            arr[from_b] = getattr(b, f)[from_b]
    return child
