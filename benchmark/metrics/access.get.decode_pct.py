"""Share of GET span wall in its decode stages: on-the-fly reconstruction."""

from benchmark import layers


def read(ctx):
    return layers.stage_share(ctx, "access.get", ("decode",))
