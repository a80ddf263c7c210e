"""HO-mask families: the fault model as data.

Port of round_tpu/engine/scenarios.py.  Every fault manifests as the
*heard-of* sets HO(j) ⊆ P; the families here are samplers
``(key, r) -> ho[n, n]`` with ho[j, i] = "j hears from i" and the diagonal
always True (a process hears itself, Round.scala:114-117).

The port has no typed PRNG keys: a sampler's ``key`` is a pair of uint32
salts ``(salt0, salt1)`` — exactly what round_tpu's ``_key_salt`` extracts
from a key — and all randomness is the counter-based murmur3 link hash, so
a sampler is a pure function of (salts, round).  Samplers are built for an
explicit ``device``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from round_tpu_torch.utils.device import resolve_device

# the link-hash stream constants (per-link stride, per-round stride)
LINK_GOLD = 0x9E3779B9
LINK_RMIX = 0x7FEB352D
_M32 = 0xFFFFFFFF
# stream constants of the scenario-constant draws (round_tpu folds these
# into the key): the crash set, the byzantine set, the partition sides
_CRASH_STREAM = 0x5EED
_BYZ_STREAM = 0xB12
_SIDE_STREAM = 0x9A87


def _with_self(ho: torch.Tensor) -> torch.Tensor:
    n = ho.shape[-1]
    return ho | torch.eye(n, dtype=torch.bool, device=ho.device)


def _key_salt(key) -> tuple[int, int]:
    """Two uint32 salts from a key: a ``(salt0, salt1)`` pair or a length-2
    tensor/array (round_tpu/engine/scenarios.py::_key_salt takes the last
    two words of a key's data)."""
    flat = np.asarray(torch.as_tensor(key).cpu()).reshape(-1)
    return int(flat[-2]) & _M32, int(flat[-1]) & _M32


def _mix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3 fmix32 on uint32 values held in int64."""
    from round_tpu_torch.ops.fused import _fmix32

    return _fmix32(z)


def mix32_host(z: int) -> int:
    """Scalar mirror of _mix32 for host code (round_tpu/engine/scenarios.py::
    mix32_host)."""
    with np.errstate(over="ignore"):
        z = np.uint32(z & _M32)  # callers pass arbitrary-width ints
        z ^= z >> np.uint32(16)
        z *= np.uint32(0x85EBCA6B)
        z ^= z >> np.uint32(13)
        z *= np.uint32(0xC2B2AE35)
        z ^= z >> np.uint32(16)
    return int(z)


def host_link_u32(salt0: int, salt1: int, r: int, src: int, dst: int,
                  n: int, stream: int = 0) -> int:
    """One link's value of the counter-based link hash, with an optional
    ``stream`` constant for the host chaos layer's independent event
    families (round_tpu/engine/scenarios.py::host_link_u32).  With
    stream=0, ``host_link_u32(...) & 0xFF < p8`` is link_bernoulli's
    ``[dst, src]`` entry for the same salts."""
    idx = ((dst & _M32) * (n & _M32) + (src & _M32)) & _M32
    z = (idx * LINK_GOLD + salt0) & _M32
    z ^= ((r & _M32) * LINK_RMIX + salt1 + stream) & _M32
    return mix32_host(z)


def host_key_salts(seed: int) -> tuple[int, int]:
    """(salt0, salt1) for the host chaos layer from an integer seed: the
    salts round_tpu's ``_key_salt(PRNGKey(seed))`` gives
    (round_tpu/engine/scenarios.py::host_key_salts), computed without
    jax.  Under JAX's default 32-bit mode ``PRNGKey(seed)`` is the pair
    (0, seed mod 2^32); a seed outside int64 overflows there too."""
    if not -(1 << 63) <= seed < (1 << 63):
        raise OverflowError("Python int too large to convert to C long")
    return 0, seed & _M32


def link_bernoulli(key, r, n: int, p: float, device=None) -> torch.Tensor:
    """[n, n] iid Bernoulli(p') mask, p' = round(p*256)/256 (at least 1/256
    for any p > 0), keyed by (key salts, round, link).  True with
    probability p'.  Bit-exact with round_tpu's link_bernoulli for the same
    salts."""
    k0, k1 = _key_salt(key)
    return _link_draw(k0, k1, r, n, p, resolve_device(device))


def _link_draw(k0, k1, r, n: int, p: float, dev) -> torch.Tensor:
    """link_bernoulli on salts given as ints, or as int64 tensors that
    broadcast against the [n, n] link grid (``[W, 1, 1]``: W keys' masks,
    ``[W, n, n]``, in one call)."""
    thresh = (max(1, round(p * 256.0)) if p > 0 else 0)
    i = torch.arange(n, dtype=torch.int64, device=dev)
    idx = i[:, None] * n + i[None, :]
    z = (idx * LINK_GOLD + k0) & _M32
    z = z ^ ((int(r) * LINK_RMIX + k1) & _M32)
    return (_mix32(z) & 0xFF) < thresh


def _key_free(sample: Callable) -> Callable:
    """Give a sampler that ignores its key its window form: the masks of W
    instances for round r are its one mask, expanded
    (runtime/instances.py::window_masks)."""
    sample.window = lambda salt0, salt1, r: sample(None, r).expand(
        salt0.shape[0], -1, -1)
    return sample


def full(n: int, device=None) -> Callable:
    """Synchronous fault-free network: everyone hears everyone."""
    dev = resolve_device(device)

    def sample(key, r):
        return torch.ones((n, n), dtype=torch.bool, device=dev)

    return _key_free(sample)


def _lane_hash(key, n: int, stream: int, dev) -> torch.Tensor:
    """[n] scenario-constant uint32 words (in int64), one a lane, on the
    link hash's scheme with `stream` in the place of the round."""
    k0, k1 = _key_salt(key)
    lane = torch.arange(n, dtype=torch.int64, device=dev)
    z = (lane * LINK_GOLD + k0) & _M32
    z = z ^ ((stream * LINK_RMIX + k1) & _M32)
    return _mix32(z)


def _hash_crash_set(key, n: int, f: int, dev,
                    stream: int = _CRASH_STREAM) -> torch.Tensor:
    """f of n processes chosen by the key: the f lanes with the smallest
    hash ranks (a uniform random f-subset, scenario-constant)."""
    order = torch.argsort(_lane_hash(key, n, stream, dev), stable=True)
    crashed = torch.zeros(n, dtype=torch.bool, device=dev)
    crashed[order[:f]] = True
    return crashed


def crash(n: int, f: int, device=None) -> Callable:
    """f crash-stop processes, chosen per scenario (from the key), silent from
    round 0.  round_tpu draws the set with a threefry permutation; the port
    draws it from the link hash (another uniform f-subset, never
    bit-compared)."""
    dev = resolve_device(device)

    def sample(key, r):
        crashed = _hash_crash_set(key, n, f, dev)
        return _with_self(
            torch.ones((n, n), dtype=torch.bool, device=dev) & ~crashed[None, :])

    return sample


def crash_at(n: int, f: int, crash_round: int, device=None) -> Callable:
    """f processes crash at a given round, alive and talkative before
    (round_tpu/engine/scenarios.py::crash_at).  The crash set is the one
    ``crash`` draws for the same key."""
    dev = resolve_device(device)

    def sample(key, r):
        crashed = _hash_crash_set(key, n, f, dev)
        dead = crashed[None, :] & (int(r) >= crash_round)
        return _with_self(
            torch.ones((n, n), dtype=torch.bool, device=dev) & ~dead)

    return sample


def omission(n: int, p_drop: float, impl: str = "hash",
             device=None) -> Callable:
    """Each (sender, receiver) link drops independently with prob p_drop per
    round, from the counter-based 8-bit hash sampler (link_bernoulli).
    round_tpu's impl="threefry" is not ported."""
    if impl != "hash":
        raise NotImplementedError(f"omission impl={impl!r}: only 'hash'")
    dev = resolve_device(device)

    def sample(key, r):
        return _with_self(~link_bernoulli(key, r, n, p_drop, device=dev))

    def window(salt0, salt1, r):
        """[W, n, n]: the masks of W keys ([W] int64 salt tensors) in one
        call, row w bit-equal to ``sample`` on key w."""
        return _with_self(~_link_draw(salt0[:, None, None],
                                      salt1[:, None, None], r, n, p_drop,
                                      dev))

    sample.window = window
    return sample


def quorum_omission(n: int, p_drop: float, quorum: Callable[[int], int],
                    device=None) -> Callable:
    """Random omissions, but every receiver still hears at least
    ``quorum(n)`` processes (round_tpu/engine/scenarios.py::quorum_omission;
    cf. OTR's goodRound liveness predicate, Otr.scala:96).

    Each link's score is its 32-bit link-hash word for the round; a link
    drops when the score's top byte is below p_drop·256 (1/256 granularity,
    as link_bernoulli), and the q smallest scores of each row are heard
    whatever they drew.  round_tpu ranks threefry uniforms; the ranks here
    come from a stable sort, so a tie would go to the smaller sender id
    (the link hash is a bijection of the link index within a round, so
    scores of one round never tie while n² ≤ 2^32)."""
    dev = resolve_device(device)
    q = quorum(n)
    thresh = (max(1, round(p_drop * 256.0)) if p_drop > 0 else 0)

    def sample(key, r):
        k0, k1 = _key_salt(key)
        i = torch.arange(n, dtype=torch.int64, device=dev)
        idx = i[:, None] * n + i[None, :]
        z = (idx * LINK_GOLD + k0) & _M32
        score = _mix32(z ^ ((int(r) * LINK_RMIX + k1) & _M32))
        ho = (score >> 24) >= thresh
        rank = torch.argsort(torch.argsort(score, dim=1, stable=True), dim=1,
                             stable=True)
        return _with_self(ho | (rank < q))

    return sample


def partition(n: int, round_heal: int, device=None) -> Callable:
    """Network split into two halves until `round_heal`, then fully
    connected (round_tpu/engine/scenarios.py::partition).  Each lane's side
    is one bit of its scenario-constant hash word (round_tpu draws a
    threefry Bernoulli(0.5) per lane)."""
    dev = resolve_device(device)

    def sample(key, r):
        if int(r) >= round_heal:
            return torch.ones((n, n), dtype=torch.bool, device=dev)
        side = (_lane_hash(key, n, _SIDE_STREAM, dev) >> 31) & 1
        return _with_self(side[:, None] == side[None, :])

    return sample


def coordinator_down(n: int, rounds_per_phase: int, p_drop: float = 0.0,
                     device=None) -> Callable:
    """The rotating coordinator of the current phase is crashed (nobody
    hears it), plus optional background omissions drawn by link_bernoulli
    (round_tpu/engine/scenarios.py::coordinator_down; round_tpu draws them
    from threefry uniforms).  coord = r / rounds_per_phase % n
    (LastVoting.scala:95)."""
    dev = resolve_device(device)

    def sample(key, r):
        coord = (int(r) // rounds_per_phase) % n
        ho = torch.ones((n, n), dtype=torch.bool, device=dev)
        if p_drop > 0.0:
            ho = ~link_bernoulli(key, r, n, p_drop, device=dev)
        ho = ho & (torch.arange(n, device=dev) != coord)[None, :]
        return _with_self(ho)

    return sample


def byzantine_silence(n: int, f: int, device=None) -> Callable:
    """f byzantine processes that are silent toward a random half of the
    receivers each round (round_tpu/engine/scenarios.py::
    byzantine_silence): the mask side of the byzantine model.  The
    byzantine set is a hash-ranked f-subset on its own stream, the targets
    link_bernoulli at p = 1/2 (exact at 1/256 granularity)."""
    dev = resolve_device(device)

    def sample(key, r):
        byz = _hash_crash_set(key, n, f, dev, stream=_BYZ_STREAM)
        target = link_bernoulli(key, r, n, 0.5, device=dev)
        return _with_self(~(byz[None, :] & target))

    return sample


def from_fault_params(
    n: int,
    crashed,
    crash_round,
    side,
    heal_round,
    rotate_down,
    p8,
    salt0,
    salt1,
) -> Callable:
    """Replay ONE scenario row of an engine.fast.FaultMix in the general
    engine, bit-exactly matching the fused kernels' hash-mode mask:

        ho[j, i] = (colmask[i] ∧ side_r[j] = side_r[i] ∧ keep(j, i)) ∨ (i = j)

    The key handed to the sampler is unused: the salts carry the randomness.
    Runs on the device of ``crashed``."""
    crashed = torch.as_tensor(crashed) != 0
    dev = crashed.device
    side = torch.as_tensor(side, device=dev).to(torch.int32)
    crash_round = int(crash_round)
    heal_round = int(heal_round)
    rotate_down = int(rotate_down)
    salt1 = int(salt1) & _M32
    lane = torch.arange(n, device=dev)

    def sample(key, r):
        from round_tpu_torch.ops.fused import ho_link_mask  # local: no cycle

        r = int(r)
        alive = ~(crashed & (r >= crash_round))
        period = max(rotate_down, 1)
        victim = (r // period) % n
        rotated = (lane == victim) & (rotate_down > 0)
        colmask = alive & ~rotated
        side_r = side if r < heal_round else torch.zeros_like(side)
        salt1r = (r * LINK_RMIX + salt1) & _M32
        return ho_link_mask(colmask, side_r, salt0, salt1r, p8)

    return _key_free(sample)


def from_mix_row(mix, s: int) -> Callable:
    """from_fault_params over row `s` of an engine.fast.FaultMix — the one
    place that unpacks a mix row."""
    return from_fault_params(
        mix.crashed.shape[1], mix.crashed[s], mix.crash_round[s], mix.side[s],
        mix.heal_round[s], mix.rotate_down[s], mix.p8[s],
        mix.salt0[s], mix.salt1[s],
    )


def from_schedule(schedule: torch.Tensor) -> Callable:
    """Replay an explicit [T, n, n] HO schedule."""

    def sample(key, r):
        return schedule[min(int(r), schedule.shape[0] - 1)]

    return _key_free(sample)


def sync_k_filter(base: Callable, k_sync: int) -> Callable:
    """Impose the `sync(k)` progress constraint (Progress.scala:16-20): every
    receiver hears at least k processes."""

    def sample(key, r):
        ho = base(key, r)
        # greedily re-enable the lowest-id senders per deficient row
        count = ho.sum(dim=1)
        need = torch.clamp(k_sync - count, min=0)
        rank = torch.cumsum((~ho).to(torch.int64), dim=1)
        add = (~ho) & (rank <= need[:, None])
        return ho | add

    return sample
