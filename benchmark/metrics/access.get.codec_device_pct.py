"""Share of GET span wall in which the card worked for the GET: the
profiler's busy seconds of the window, once for each job of the codec batch
they served (the cell's only device work is its GETs' decodes)."""

from benchmark import spans


def read(ctx):
    return spans.device_share(ctx, "access.get")
