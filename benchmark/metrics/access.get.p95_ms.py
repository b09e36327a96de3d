"""95th percentile of the window's access.get spans: the GET's tail inside
the program, beside the client's client.get_p95_ms (the difference is the
HTTP face, loopback and the client)."""

from benchmark import spans


def read(ctx):
    return spans.p95_ms(ctx, "access.get")
