"""Median of the range pairs' healthy halves, due to last byte, on the
client's clock: the guard against a change that slows healthy reads and so
lowers the pairs' ratio without a faster degraded path."""

from benchmark import layers


def read(ctx):
    return layers.range_p50_ms(ctx["records"], 1)
