"""Round-consistent snapshots: full-state audits of live serving.

Port of round_tpu/snap.  Communication-closed rounds make n per-replica
samples stamped the same (instance, round, epoch) a consistent global
state with no marker protocol; the collector replica assembles them
into cuts and audits the offline Spec formulas (the full-state
invariants no lane monitor can see) in one batched dispatch.

Modules:
  sample.py   — the deterministic sampling policy, the FLAG_SNAP wire
                form, state digests and the byte budget.
  collect.py  — cut assembly: round alignment, epoch fencing, the
                missing-contributor tolerance, divergence forensics and
                the ``.snapcut`` bank.
  audit.py    — the batched cut auditor (``torch.func.vmap`` over the
                cut batch) and the violation pipeline (rv/dump.py).
  driver.py   — SnapDriver, the one object the serving drivers hold.
  fixtures.py — the deliberately broken round the auditor must catch.
"""

from round_tpu_torch.snap.audit import (  # noqa: F401
    AuditProgram, CutAuditor, SnapConfig, SnapRuntime, SnapViolation,
    audit_program,
)
from round_tpu_torch.snap.collect import (  # noqa: F401
    Cut, SnapCollector, bank_cut, envelope_f_max, load_cut,
)
from round_tpu_torch.snap.driver import SnapDriver  # noqa: F401
from round_tpu_torch.snap.sample import (  # noqa: F401
    SampleEmitter, SnapPolicy, decode_sample, encode_sample,
    sample_jitter, state_digest,
)
