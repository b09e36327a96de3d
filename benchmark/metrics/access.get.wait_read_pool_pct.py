"""Share of GET span wall in wait.read_pool: shard reads queued for a
worker of the gateway's read pool."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "access.get", ("wait.read_pool",))
