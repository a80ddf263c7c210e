"""The Heard-Of sets of the fault model, as dense masks, for the reference.

A scenario is one row of these inputs (n processes):

  crashed [n] bool, crash_round      processes silent from crash_round on
  side [n] int, heal_round           a process hears only its own side
                                     before heal_round
  rotate_down                        0: off; k > 0: process (r // k) mod n
                                     is silent in round r
  p8, salt0, salt1                   links dropped by the stream (links.py)
                                     with probability p8/256; p8 >= 256
                                     silences every sender

A process that has exited sends nothing and its state no longer changes.
Every process that has not exited hears itself.
"""

from __future__ import annotations

import torch

from hobench.reference import links


def delivered(rows: dict, r: int, active: torch.Tensor, mode: str,
              philox_rounds: int = 10) -> torch.Tensor:
    """[c, n(receiver), n(sender)] bool: who hears whom in round r."""
    crashed, side = rows["crashed"], rows["side"]
    c, n = crashed.shape
    dev = crashed.device
    lane = torch.arange(n, device=dev)
    silent = crashed & (r >= rows["crash_round"])[:, None]
    period = rows["rotate_down"]
    victim = (r // torch.clamp(period, min=1)) % n
    silent |= (lane[None, :] == victim[:, None]) & (period > 0)[:, None]
    silent |= (rows["p8"] >= 256)[:, None]
    sends = active & ~silent
    same_side = ((side[:, :, None] == side[:, None, :])
                 | (r >= rows["heal_round"])[:, None, None])
    kept = links.keep(n, mode, rows["salt0"],
                      links.round_salt(rows["salt1"], r), rows["p8"],
                      philox_rounds)
    hears = kept & same_side & sends[:, None, :]
    eye = torch.eye(n, dtype=torch.bool, device=dev)[None]
    return torch.where(eye, active[:, :, None], hears)


def value_counts(heard: torch.Tensor, vals: torch.Tensor,
                 num_values: int) -> torch.Tensor:
    """[c, n(receiver), num_values] int64: how many messages of each value
    each receiver got, from the mask and the senders' values (in [0,
    num_values)).  An exact float32 product of 0/1 operands (sums < 2^24),
    with TF32 off."""
    onehot = (vals[:, :, None] == torch.arange(
        num_values, device=vals.device)[None, None, :]).to(torch.float32)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        got = torch.bmm(heard.to(torch.float32), onehot)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return got.round().to(torch.int64)


def chunks(c: int, n: int):
    """Slices of the scenario axis that keep one [chunk, n, n] int64 tensor
    near 128 MB."""
    step = max(1, (1 << 24) // (n * n))
    for a in range(0, c, step):
        yield slice(a, min(c, a + step))
