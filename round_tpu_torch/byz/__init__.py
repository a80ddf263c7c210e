"""round_tpu_torch.byz — the byzantine value-adversary engine.

Port of round_tpu/byz (its ``lies`` and ``adversary`` modules; the
proof/fuzzer cross-check harness, ``crosscheck``, is not ported yet):

  * ``lies``      — per-protocol lie models: how a compromised sender
                    forges a well-formed payload claiming value ``v``
                    (digest-consistent for the PBFT family);
  * ``adversary`` — the value-fault tensors (membership mask +
                    equivocation / stale-replay thresholds), the
                    counter-hash event formula, the explicit ``[T, n, n]``
                    substitution plan, and the engine hook
                    ``ValueAdversary`` that ``executor.run_round`` folds
                    into the update step.
"""

from round_tpu_torch.byz.adversary import (  # noqa: F401
    STREAM_BYZ_STALE,
    STREAM_BYZ_VAL,
    ValueAdversary,
    hash_adversary,
    plan_adversary,
    value_events,
    value_plan,
)
from round_tpu_torch.byz.lies import LIE_MODELS, forge_payload, lie_for  # noqa: F401
