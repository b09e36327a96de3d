"""Share of the preload's PUT span wall in `write`: each blob's shard fan-out to the blobnodes."""

from benchmark import preload


def read(ctx):
    return preload.put_share(ctx, ("write",))
