"""Coverage-guided fault-schedule search on the batched engine.

Port of round_tpu/fuzz (its genome, objectives, search and minimize
modules; the artifact replay and the hostile-frame fuzzer are not ported
yet).  The per-(src, dst, round) fault schedule is a GENOME; a generation
evaluates the whole population as one batched program on the general
engine, scores it by spec-derived objectives and evolves toward the
schedules that hurt; a winner is delta-debugged down to a minimal
reproducer:

  genome     — schedule tensors + per-family mutation/crossover operators
  objectives — lane scores computed in the same batched evaluation
  search     — the generational loop with coverage/novelty bookkeeping
  minimize   — batched delta-debugging down to a minimal link set

Entry point: ``make_target(...)`` then ``search(...)`` and
``minimize.minimize(...)``.
"""

from round_tpu_torch.fuzz.genome import Population  # noqa: F401
from round_tpu_torch.fuzz.search import FuzzResult, make_target, search  # noqa: F401
