"""Ben-Or through the program: the engine entries a cell's traffic names,
called as a user of round_tpu_torch calls them."""

from __future__ import annotations

import torch

from round_tpu_torch.engine import fast
from round_tpu_torch.models.benor import BenOrState

# the outputs compared with the reference: the state returned to the
# caller, then done and decided_round
FIELDS = ("x", "can_decide", "vote", "decided", "decision", "done",
          "decided_round")


def linger(config: dict) -> int:
    """Rounds a process stays active after the one in which it decides."""
    return 0


def message_values(config: dict) -> int:
    """Values a message of the exchange can carry: (x, can_decide) in the
    first round of a phase, the vote in the second, in one domain of 4."""
    return 4


class Program:
    """One engine path of the program for one configuration."""

    def __init__(self, config: dict, engine: str):
        self.config = config
        self.engine = engine
        self.rnd = fast.BenOrHist()
        if engine not in ("loop", "hist"):
            raise ValueError(f"unknown engine {engine!r}")

    def state0(self, init: torch.Tensor) -> BenOrState:
        """The fresh state of a batch, from its [S, n] initial bits."""
        false = torch.zeros(init.shape, dtype=torch.bool, device=init.device)
        return BenOrState(x=init != 0, can_decide=false,
                          vote=torch.full_like(init, -1), decided=false,
                          decision=false)

    def run(self, state0, mix: fast.FaultMix) -> dict:
        c = self.config
        if self.engine == "loop":
            state, done, dround = fast.run_benor_loop(
                self.rnd, state0, mix, c["rounds"], mode=c["link_mode"])
        else:
            state, done, dround = fast.run_hist(
                self.rnd, state0, lambda s: s.decided, mix, c["rounds"],
                mode=c["link_mode"])
        return {"x": state.x, "can_decide": state.can_decide,
                "vote": state.vote, "decided": state.decided,
                "decision": state.decision, "done": done,
                "decided_round": dround}
