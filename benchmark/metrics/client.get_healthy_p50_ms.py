"""Median of the healthy baselines that get_degraded_x sets its degraded
GETs against (each the median of up to 3 size-matched healthy GETs due
within 2 s), on the client's clock: the healthy side of its ratio, which
shows a change that slows healthy reads and so lowers the ratio without a
faster decode."""

from benchmark import layers


def read(ctx):
    return layers.baselined_p50_ms(ctx["records"], 1)
