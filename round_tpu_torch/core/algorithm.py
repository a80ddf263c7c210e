"""Algorithm: ties a phase of Rounds to an initial state.

Port of round_tpu/core/algorithm.py.  "vars" are the fields of a state
dataclass (``utils.tree.struct``), "init" is a per-lane pure function and
"rounds" is a static tuple — the phase executes round-robin, exactly like
RtProcess.incrementRound (Process.scala:53-59).  ``spec`` is the model's
round_tpu_torch.spec.Spec (None where a model states none).
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

from round_tpu_torch.core.rounds import Round, RoundCtx


class Algorithm:
    """Base class for round-based algorithms.

    Subclasses define:
      rounds: tuple[Round, ...] — the phase (executed round-robin).
      make_init_state(ctx, io) -> state: per-lane initial state from the
        per-lane io pytree (reference: Process.init(io)).
      decided(state) / decision(state): accessors the engine uses to
        extract decision traces.
      fault_envelope / adversary_model / decision_null: the declarations of
        round_tpu/core/algorithm.py::Algorithm, carried over unchanged.

    ``adopt_decision`` (the host runtime's out-of-band recovery) comes with
    the runtime slice.
    """

    rounds: Tuple[Round, ...] = ()
    spec = None
    fault_envelope: Optional[str] = None
    adversary_model: str = "benign"
    decision_null: Optional[int] = None

    @property
    def rounds_per_phase(self) -> int:
        return len(self.rounds)

    def make_init_state(self, ctx: RoundCtx, io: Any):
        raise NotImplementedError

    def decided(self, state):
        """[n] bool — which lanes have decided. Override."""
        raise NotImplementedError

    def decision(self, state):
        """[n] values — the decided value per lane (garbage where undecided)."""
        raise NotImplementedError
