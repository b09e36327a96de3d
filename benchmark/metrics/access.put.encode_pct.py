"""Share of the preload's PUT span wall in `encode`: each blob's wait for its stripe."""

from benchmark import preload


def read(ctx):
    return preload.put_share(ctx, ("encode",))
