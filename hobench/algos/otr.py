"""OneThirdRule through the program: the engine entries a cell's traffic
names, called as a user of round_tpu_torch calls them."""

from __future__ import annotations

import torch

from round_tpu_torch.engine import fast
from round_tpu_torch.models.otr import OtrState

# the outputs compared with the reference: the state returned to the
# caller, then done and decided_round
FIELDS = ("x", "decided", "decision", "after", "done", "decided_round")


def linger(config: dict) -> int:
    """Rounds a process stays active after the one in which it decides."""
    return config["after_decision"] - 1


def message_values(config: dict) -> int:
    """Values a message of the exchange can carry."""
    return config["num_values"]


class Program:
    """One engine path of the program for one configuration."""

    def __init__(self, config: dict, engine: str):
        self.config = config
        self.engine = engine
        self.rnd = fast.OtrHist(n_values=config["num_values"],
                                after_decision=config["after_decision"])
        if engine not in ("loop", "hist"):
            raise ValueError(f"unknown engine {engine!r}")

    def state0(self, init: torch.Tensor) -> OtrState:
        """The fresh state of a batch, from its [S, n] initial values."""
        return OtrState(
            x=init,
            decided=torch.zeros(init.shape, dtype=torch.bool,
                                device=init.device),
            decision=torch.full_like(init, -1),
            after=torch.full_like(init, self.config["after_decision"]),
        )

    def run(self, state0, mix: fast.FaultMix) -> dict:
        c = self.config
        if self.engine == "loop":
            state, done, dround = fast.run_otr_loop(
                self.rnd, state0, mix, c["rounds"], mode=c["link_mode"])
        else:
            state, done, dround = fast.run_hist(
                self.rnd, state0, lambda s: s.decided, mix, c["rounds"],
                mode=c["link_mode"])
        return {"x": state.x, "decided": state.decided,
                "decision": state.decision, "after": state.after,
                "done": done, "decided_round": dround}
