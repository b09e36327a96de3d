"""Median of the degraded GETs that get_degraded_x sets against a healthy
baseline, due to last byte, on the client's clock: the degraded side of
its ratio."""

from benchmark import layers


def read(ctx):
    return layers.baselined_p50_ms(ctx["records"], 0)
