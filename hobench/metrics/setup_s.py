"""Seconds from the process's start to the first timed batch: imports,
the card's context, loading (and in a checkout's first run, building) the
kernels, the pool of fault structures and the warm-up batches."""


def read(ctx):
    return ctx.record.setup_s
