"""Share of the preload's PUT span wall in `wait.codec`: encode jobs queued for the codec."""

from benchmark import preload


def read(ctx):
    return preload.put_share(ctx, ("wait.codec",))
