"""counter-accounting fixture: an undeclared dynamic name, a kind
clash, and a balance pair with one side's tick lost.  Never imported by
runtime code — linted statically."""

from round_tpu_torch.obs.metrics import METRICS


def tick_dynamic(kind):
    # computed name, site not in any DYNAMIC_NAMES registry
    METRICS.counter(f"fx.dyn_{kind}").inc()  # lint: counter-accounting/dynamic-name


def tick_clashing():
    METRICS.counter("fx.same").inc()
    METRICS.gauge("fx.same").set(1)  # lint: counter-accounting/type-clash


def shed(n):
    METRICS.counter("fx.shed_frames").inc(n)
    # declared as the other side of the shed balance invariant, but its
    # .inc() site was lost in a refactor — the accounting fails open
    METRICS.counter("fx.nacks_sent")  # lint: counter-accounting/unbalanced-pair
