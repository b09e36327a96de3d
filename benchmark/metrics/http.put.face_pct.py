"""Share of the preload's PUT time at the daemon in the HTTP face: recv, queue and send."""

from benchmark import preload


def read(ctx):
    return preload.put_face_pct(ctx)
