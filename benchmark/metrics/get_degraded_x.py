"""What the broken disk costs a read: the geometric mean over degraded GETs
of their latency over a healthy baseline (the median of up to 3 healthy
GETs of their kind due within 2 s and of a size within 1.5x), due to last
byte, a tenth trimmed at each end (layers.get_degraded_x)."""

from benchmark import layers


def read(ctx):
    return layers.get_degraded_x(ctx["records"])
