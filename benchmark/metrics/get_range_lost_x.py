"""R: what a lost disk costs a ranged read, as the geometric mean over
range pairs of the degraded half's latency over its healthy twin's (the
same blob, length and in-shard offset, due at the same instant), due to
last byte, a tenth of the log ratios trimmed at each end
(layers.get_range_lost_x). It falls with a faster degraded path and rises
with a faster path that both halves share, so it judges only the
former."""

from benchmark import layers


def read(ctx):
    return layers.get_range_lost_x(ctx["records"])
