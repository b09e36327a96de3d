"""Share of GET span wall in decode stages outside the codec's queue and
batches: the caller's matrix build and padding, and its wake-up after the
result is set."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "access.get", ("decode",), outside=("wait.codec", "codec."),
                       needs=("wait.codec",))
