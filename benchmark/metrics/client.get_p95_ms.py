"""95th percentile of the window's GETs, due to last byte, on the client's
clock: the tail beside the rate, in the traced run."""

from benchmark import layers


def read(ctx):
    return layers.get_p95_ms(ctx.get("records", []))
