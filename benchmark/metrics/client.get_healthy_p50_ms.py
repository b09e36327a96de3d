"""Median of the healthy twins that get_degraded_x pairs, due to last
byte, on the client's clock: the healthy side of its ratio, which shows a
change that slows healthy reads and so lowers the ratio without a faster
decode."""

from benchmark import layers


def read(ctx):
    return layers.twin_p50_ms(ctx["records"], 1)
