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

    def adopt_decision(self, state, decision):
        """Adopt an out-of-band decision (the host runtime's FLAG_DECISION
        recovery — a peer that already decided replies with the value when
        it sees our late traffic, PerfTest.scala:40-60).  Default: set the
        conventional `decided`/`decision` state fields, on the state's
        device.  Returns the updated state, or None when this state cannot
        adopt (no such fields, or a malformed value) — the runner then
        ignores the message (round_tpu/core/algorithm.py::adopt_decision).

        THREAT MODEL: this is BENIGN-fault recovery, exactly as in the
        reference — the message is trusted like any group traffic, so a
        byzantine peer (or a socket-level forger) could inject a decision.
        The host path's byzantine tolerance is CRASH-safety (garbage never
        kills a replica); byzantine *agreement* belongs to the PBFT layer
        (models/pbft.py + utils/byzantine.py), not to this recovery
        path."""
        import numpy as np
        import torch

        if not (hasattr(state, "replace") and hasattr(state, "decided")
                and hasattr(state, "decision")):
            return None
        d, v = state.decided, state.decision
        np_dtype = torch.empty((), dtype=v.dtype).numpy().dtype
        try:
            val = np.asarray(decision, dtype=np_dtype).reshape(tuple(v.shape))
        except Exception:  # noqa: BLE001 — byzantine value: ignore, run on
            return None
        return state.replace(
            decided=torch.ones_like(d, dtype=d.dtype),
            decision=torch.from_numpy(val.copy()).to(v.device))
