"""Share of the preload's PUT span wall in `submit`: the caller staging each blob for the codec."""

from benchmark import preload


def read(ctx):
    return preload.put_share(ctx, ("submit",))
