"""The 95th percentile, over every batch of the window, of the time from
the host's submit to the batch's verdict being on the host, in ms."""

import statistics


def read(ctx):
    lat = [(b["done"] - b["submit"]) * 1e3 for b in ctx.record.window]
    if len(lat) < 2:
        return None
    return statistics.quantiles(lat, n=100)[94]
