"""obs-vocab fixture (code side): emits one metric and one trace event
that ``_broken_obs.md`` does not document, while that doc documents a
metric and an event nothing emits.  Never imported by runtime code."""

from round_tpu_torch.obs.metrics import METRICS
from round_tpu_torch.obs.trace import TRACE


def emit():
    METRICS.counter("fx.undocumented").inc()  # lint: obs-vocab/undocumented
    TRACE.emit("fx_ghost_event", step=1)  # lint: obs-vocab/undocumented
