"""OneThirdRule, plainly (PSync example/Otr.scala): every round each process
broadcasts its estimate x; a process that hears more than 2n/3 messages
sets x to the smallest of the values it heard most often, and decides that
value when more than 2n/3 of the messages carry it.  A decided process
takes part for `after_decision` more rounds, counting the one in which it
decided, then exits.

Outputs, each [c, n] int64: x, decided (0/1), decision (-1 until decided),
after, done (0/1: exited), decided_round (-1 until decided).
"""

from __future__ import annotations

import torch

from hobench.reference.heardof import chunks, delivered, value_counts

FIELDS = ("x", "decided", "decision", "after", "done", "decided_round")


def run(rows: dict, init: torch.Tensor, config: dict,
        philox_rounds: int = 10) -> dict:
    """The whole run of every scenario row; `init` [c, n] initial values."""
    c, n = init.shape
    parts = [_run(_take(rows, sl), init[sl], config, philox_rounds)
             for sl in chunks(c, n)]
    return {k: torch.cat([p[k] for p in parts]) for k in FIELDS}


def _take(rows: dict, sl: slice) -> dict:
    return {k: v[sl] for k, v in rows.items()}


def _run(rows, init, config, philox_rounds):
    n, V = config["n"], config["num_values"]
    third = (2 * n) // 3
    x = init.to(torch.int64)
    decided = torch.zeros_like(x, dtype=torch.bool)
    decision = torch.full_like(x, -1)
    after = torch.full_like(x, config["after_decision"])
    done = torch.zeros_like(decided)
    decided_round = torch.full_like(x, -1)
    values = torch.arange(V, device=x.device)
    for r in range(config["rounds"]):
        active = ~done
        heard = delivered(rows, r, active, config["link_mode"], philox_rounds)
        counts = value_counts(heard, x, V)  # [c, n, V]
        size = counts.sum(-1)
        best = counts.max(-1).values
        # the smallest value among those heard most often
        v = torch.where(counts == best[..., None], values, V).min(-1).values
        quorum = size > third
        deciding = quorum & (best > third)
        new_decided = decided | deciding
        new_decision = torch.where(deciding & ~decided, v, decision)
        new_after = torch.where(new_decided, after - 1, after)
        exits = new_decided & (new_after <= 0)
        new_x = torch.where(quorum, v, x)
        x = torch.where(active, new_x, x)
        decision = torch.where(active, new_decision, decision)
        after = torch.where(active, new_after, after)
        decided = torch.where(active, new_decided, decided)
        done = done | (active & exits)
        decided_round = torch.where(decided & (decided_round < 0), r,
                                    decided_round)
    return {"x": x, "decided": decided.long(), "decision": decision,
            "after": after, "done": done.long(),
            "decided_round": decided_round}
