"""Ben-Or's randomized binary consensus, plainly (PSync example/BenOr.scala),
with the deterministic hash coin (links.coin).  A phase is two rounds.

Round 1 (even r): each process broadcasts (x, can_decide).  A process that
may decide decides x and exits at the end of the round.  Any other sets
its vote to true when more than n/2 messages carry x = true or one carries
(true, can_decide), else to false likewise, else to none; and can_decide
to whether any message carried can_decide.

Round 2 (odd r): each process broadcasts its vote.  With t true and f
false votes heard, an undecided process sets x to true if t > n/2, false
if f > n/2, true if t > 1, false if f > 1, else its coin; and can_decide
when t > n/2 or f > n/2 (or it already could).

Outputs, each [c, n] int64: x, can_decide, vote (-1 none, 0 false, 1
true), decided, decision (0 until decided), done, decided_round.
"""

from __future__ import annotations

import torch

from hobench.reference import links
from hobench.reference.heardof import chunks, delivered, value_counts

FIELDS = ("x", "can_decide", "vote", "decided", "decision", "done",
          "decided_round")


def run(rows: dict, init: torch.Tensor, config: dict,
        philox_rounds: int = 10) -> dict:
    """The whole run of every scenario row; `init` [c, n] initial bits."""
    c, n = init.shape
    parts = [_run({k: v[sl] for k, v in rows.items()}, init[sl], config,
                  philox_rounds)
             for sl in chunks(c, n)]
    return {k: torch.cat([p[k] for p in parts]) for k in FIELDS}


def _run(rows, init, config, philox_rounds):
    n = config["n"]
    half = n // 2
    x = (init != 0).long()
    zero = torch.zeros_like(x)
    can, vote, decided, decision = zero, zero - 1, zero, zero
    done = zero.bool()
    decided_round = zero - 1
    for r in range(config["rounds"]):
        active = ~done
        heard = delivered(rows, r, active, config["link_mode"], philox_rounds)
        if r % 2 == 0:
            c = value_counts(heard, x + 2 * can, 4)  # (x, can) as x + 2 can
            t_cnt, f_cnt = c[..., 1] + c[..., 3], c[..., 0] + c[..., 2]
            new_vote = torch.where(
                (t_cnt > half) | (c[..., 3] > 0), 1,
                torch.where((f_cnt > half) | (c[..., 2] > 0), 0, -1))
            any_can = ((c[..., 2] + c[..., 3]) > 0).long()
            deciding = (can != 0) & active
            decision = torch.where(deciding & (decided == 0), x, decision)
            decided = torch.where(deciding, 1, decided)
            undecided_here = active & ~deciding
            vote = torch.where(undecided_here, new_vote, vote)
            can = torch.where(undecided_here, any_can, can)
            done = done | deciding
        else:
            c = value_counts(heard, vote + 1, 3)  # none, false, true
            t, f = c[..., 2], c[..., 1]
            flip = links.coin(rows["salt0"], rows["salt1"], r, n).long()
            new_x = torch.where(
                t > half, 1, torch.where(
                    f > half, 0, torch.where(
                        t > 1, 1, torch.where(f > 1, 0, flip))))
            new_can = ((t > half) | (f > half) | (can != 0)).long()
            moves = active & (decided == 0)
            x = torch.where(moves, new_x, x)
            can = torch.where(moves, new_can, can)
        decided_round = torch.where((decided != 0) & (decided_round < 0), r,
                                    decided_round)
    return {"x": x, "can_decide": can, "vote": vote, "decided": decided,
            "decision": decision, "done": done.long(),
            "decided_round": decided_round}
