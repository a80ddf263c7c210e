"""Share of the traced window in which no kernel, copy or fill ran on the
card, from the profiler's timeline, in %."""


def read(ctx):
    tr = ctx.record.trace
    if tr is None or tr.busy_ns == 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
