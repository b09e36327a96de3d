"""Median of the degraded GETs that get_degraded_x pairs, due to last
byte, on the client's clock: the degraded side of its ratio."""

from benchmark import layers


def read(ctx):
    return layers.twin_p50_ms(ctx["records"], 0)
