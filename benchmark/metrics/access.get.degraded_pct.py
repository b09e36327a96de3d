"""Share of GETs that decoded on the fly: how much of the window read a
degraded cluster."""

from benchmark import layers


def read(ctx):
    return layers.span_share(ctx, "access.get", "decode")
