"""The link streams and the coin, written out plainly for the reference.

Every uint32 quantity is held in an int64 tensor and masked to 32 bits
after each step that can wrap.  Nothing here comes from the program: the
stream is Philox4x32 (Salmon et al., "Parallel random numbers: as easy as
1, 2, 3", SC'11), the hash is murmur3's 32-bit finalizer.

Link (receiver j, sender i) of a group of n has index ``idx = j * n + i``.

* hw stream: Philox4x32-10 keyed (salt0, salt1r).  Call ``t`` of the
  stream has counter (t, 0, 0, 0) and gives four words; each word gives
  four bytes, low byte first.  So link ``idx`` reads byte ``idx & 3`` of
  word ``(idx >> 2) & 3`` of call ``idx >> 4``.  The link is kept when
  ``p8 <= 0`` or that byte is at least ``min(p8, 255)``.
* hash stream: ``fmix32(((idx * GOLD + salt0) mod 2^32) ^ salt1r) & 0xFF``
  at least ``p8``.

``salt1r = (r * RMIX + salt1) mod 2^32`` is the salt of round ``r``.  The
coin of (scenario, lane, round) is bit 0 of ``fmix32(((lane * GOLD +
salt0) mod 2^32) ^ ((r * RMIX + salt1 + COIN) mod 2^32))``.

``rounds`` of Philox is a parameter only so that the control of the
correctness check can draw from a weaker stream (Philox4x32-7).
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
GOLD = 0x9E3779B9
RMIX = 0x7FEB352D
COIN = 0x1B873593
PHILOX_M0, PHILOX_M1 = 0xD2511F53, 0xCD9E8D57
PHILOX_W0, PHILOX_W1 = 0x9E3779B9, 0xBB67AE85


def u32(x) -> torch.Tensor:
    """The uint32 value of an integer tensor (an int32 bit pattern or any
    int64), held in int64."""
    return torch.as_tensor(x).to(torch.int64) & M32


def mul_hi_lo(a: torch.Tensor, m: int):
    """(high, low) 32-bit words of the 64-bit product of uint32 values `a`
    and the constant `m`.  `a` is split into 16-bit halves so that no
    partial product leaves int64."""
    a_lo, a_hi = a & 0xFFFF, a >> 16
    p_lo, p_hi = a_lo * m, a_hi * m  # each below 2^48
    low = (((p_hi & 0xFFFF) << 16) + p_lo) & M32
    high = (p_hi + (p_lo >> 16)) >> 16
    return high, low


def philox4x32(c0, c1, c2, c3, k0, k1, rounds: int = 10):
    """The four output words of Philox4x32-`rounds` for counter (c0, c1, c2,
    c3) and key (k0, k1), each a uint32 tensor (int64) or int; broadcasts."""
    c0, c1, c2, c3, k0, k1 = (u32(w) for w in (c0, c1, c2, c3, k0, k1))
    for rnd in range(rounds):
        if rnd > 0:
            k0 = (k0 + PHILOX_W0) & M32
            k1 = (k1 + PHILOX_W1) & M32
        hi0, lo0 = mul_hi_lo(c0, PHILOX_M0)
        hi1, lo1 = mul_hi_lo(c2, PHILOX_M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def fmix32(z: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer."""
    z = u32(z)
    z = z ^ (z >> 16)
    z = (z * 0x85EBCA6B) & M32
    z = z ^ (z >> 13)
    z = (z * 0xC2B2AE35) & M32
    return z ^ (z >> 16)


def round_salt(salt1, r: int) -> torch.Tensor:
    """salt1r of round r."""
    return (r * RMIX + u32(salt1)) & M32


def hw_bytes(n: int, salt0, salt1r, rounds: int = 10) -> torch.Tensor:
    """[c, n(receiver), n(sender)] bytes of the hw stream for one round of c
    scenarios keyed (salt0, salt1r), each [c]."""
    salt0, salt1r = u32(salt0), u32(salt1r)
    calls = (n * n + 15) // 16
    t = torch.arange(calls, dtype=torch.int64, device=salt0.device)
    words = philox4x32(t[None, :], 0, 0, 0, salt0[:, None], salt1r[:, None],
                       rounds)
    words = torch.stack(words, dim=-1)  # [c, calls, 4]
    shifts = torch.tensor([0, 8, 16, 24], dtype=torch.int64,
                          device=salt0.device)
    b = (words[..., None] >> shifts) & 0xFF  # [c, calls, 4 words, 4 bytes]
    return b.reshape(salt0.shape[0], -1)[:, :n * n].reshape(-1, n, n)


def keep(n: int, mode: str, salt0, salt1r, p8,
         philox_rounds: int = 10) -> torch.Tensor:
    """[c, n(receiver), n(sender)] bool: whether the stream keeps each link
    of one round (the diagonal included; the caller decides about it)."""
    p8 = torch.as_tensor(p8).to(torch.int64)[:, None, None]
    if mode == "hw":
        drawn = hw_bytes(n, salt0, salt1r, philox_rounds)
        return (p8 <= 0) | (drawn >= torch.clamp(p8, max=255))
    if mode == "hash":
        dev = p8.device
        ids = torch.arange(n, dtype=torch.int64, device=dev)
        idx = ids[:, None] * n + ids[None, :]
        z = (idx[None] * GOLD + u32(salt0)[:, None, None]) & M32
        z = z ^ u32(salt1r)[:, None, None]
        return (fmix32(z) & 0xFF) >= p8
    raise ValueError(f"unknown link stream {mode!r}")


def coin(salt0, salt1, r: int, n: int) -> torch.Tensor:
    """[c, n] bool: the hash coin of each lane of c scenarios in round r."""
    salt0, salt1 = u32(salt0)[:, None], u32(salt1)[:, None]
    lane = torch.arange(n, dtype=torch.int64, device=salt0.device)[None, :]
    z = (lane * GOLD + salt0) & M32
    z = z ^ ((r * RMIX + salt1 + COIN) & M32)
    return (fmix32(z) & 1) == 1
