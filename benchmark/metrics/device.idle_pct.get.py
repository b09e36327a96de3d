"""Share of a GET window in which no kernel or copy ran on the card."""

from benchmark import layers


def read(ctx):
    return layers.device_idle_pct(ctx)
