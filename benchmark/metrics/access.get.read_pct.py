"""Share of GET span wall in its read and gather stages: shard reads."""

from benchmark import layers


def read(ctx):
    return layers.stage_share(ctx, "access.get", ("read", "gather"))
