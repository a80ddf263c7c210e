"""Scenario-rounds per second: S x R of every batch the window completed,
over the window's seconds.  R is the rounds a batch asks for, whether or
not its scenarios exit early."""


def read(ctx):
    rec = ctx.record
    return len(rec.window) * rec.work_per_batch / rec.window_s
