"""What the broken disk costs a read: the median over degraded GETs of
their latency over their healthy twin's, a twin due within 2 s and of a
size within 1.5x, due to last byte (layers.get_degraded_x)."""

from benchmark import layers


def read(ctx):
    return layers.get_degraded_x(ctx["records"])
