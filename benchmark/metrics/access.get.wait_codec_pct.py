"""Share of GET span wall in wait.codec: decode jobs queued for the codec's
dispatcher, its coalescing window included."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "access.get", ("wait.codec",))
