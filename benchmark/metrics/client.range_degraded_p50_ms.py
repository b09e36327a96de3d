"""Median of the range pairs' degraded halves, due to last byte, on the
client's clock."""

from benchmark import layers


def read(ctx):
    return layers.range_p50_ms(ctx["records"], 0)
