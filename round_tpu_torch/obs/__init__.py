"""Observability: round-level structured tracing + unified typed metrics.

Port of round_tpu/obs (importing round_tpu.obs would load jax through
round_tpu/__init__.py, so the port keeps its own copy):

* ``obs.trace`` — a low-overhead structured event tracer (ring buffer,
  JSONL export, zero-cost when disabled);
* ``obs.metrics`` — a typed registry (counter / gauge / histogram with
  fixed buckets) with JSON and Prometheus-text snapshots, and the legacy
  ``Stats`` counters/timers facade over it.
"""

from round_tpu_torch.obs.metrics import (  # noqa: F401
    METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    Stats,
    stats,
)
from round_tpu_torch.obs.trace import TRACE, Tracer, load_jsonl, merge  # noqa: F401
