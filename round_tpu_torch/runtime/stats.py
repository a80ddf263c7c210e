"""Named counters and phase timers with a shutdown report (legacy shim).

Port of round_tpu/runtime/stats.py (psync.utils.Stats, utils/Stats.scala:
7-98, + the --stat shutdown-hook report, utils/Options.scala:16-25): a
re-export of the port's ``obs/metrics.py``, so the engines and the runtime
share one counters/timers surface.
"""

from __future__ import annotations

from round_tpu_torch.obs.metrics import METRICS, Stats, stats  # noqa: F401
