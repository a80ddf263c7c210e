"""Runtime verification: lane monitors fused into serving.

Port of round_tpu/rv.  The same Spec formulas spec/check.py evaluates
offline become live monitors on the serving tier: every instance a
LaneDriver or HostRunner advances is checked on its decision plane, a
violation halts, sheds or logs by policy and dumps a replayable artifact
(the fuzz/replay.py schedule format), and membership changes are
licensed by the parameterized proofs.

Modules:
  compile.py  — the monitor compiler: Spec → the per-lane monitor term
                fused into the lane driver's update mega-step, and its
                numpy twin for the host runner.
  dump.py     — the violation pipeline: obs events, rv.* counters and
                halt-and-dump artifacts that ``fuzz_cli replay``
                reproduces on the engine and the host wire.
  license.py  — proof-licensed reconfiguration.
  fixtures.py — deliberately broken rounds (selector-registered) that
                trip each monitor.
"""

from round_tpu_torch.rv.compile import (  # noqa: F401
    InstanceMonitor, MonitorProgram, monitor_program,
)
from round_tpu_torch.rv.dump import RvConfig, RvRuntime, RvViolation  # noqa: F401
from round_tpu_torch.rv.license import License, ProofLicenseRegistry  # noqa: F401
