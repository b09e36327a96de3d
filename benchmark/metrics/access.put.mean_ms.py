"""Mean wall of the preload's `access.put` spans, in ms."""

from benchmark import preload


def read(ctx):
    return preload.put_mean_ms(ctx)
