"""Share of the preload's PUT span wall in the codec batches of its encodes (one at a time)."""

from benchmark import preload


def read(ctx):
    return preload.put_share(ctx, ("codec.host", "codec.launch"))
