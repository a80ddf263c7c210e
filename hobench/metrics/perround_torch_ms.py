"""Device ms per batch of the per-round engine's kernels other than K2
(round_params, the update, the freeze, decided_round), launched inside the
harness's `engine` span, over the traced batches.  Nothing to read where
no K2 kernel ran."""

KERNEL = "hist_exchange_kernel"


def read(ctx):
    tr = ctx.record.trace
    if tr is None or not any(KERNEL in op.name for op in tr.ops):
        return None
    ns = sum(op.end - op.start for op in tr.ops
             if op.step == "engine" and KERNEL not in op.name)
    return ns / 1e6 / len(tr.batches)
