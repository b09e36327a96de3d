"""Share of GET span wall in gather.replace stages: survivor reads the
gateway's gather launched in place of reads that failed or hung, from each
one's launch to its answer."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "access.get", ("gather.replace",), needs=("gather.replace",))
