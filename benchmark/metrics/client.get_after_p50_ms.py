"""Median of the whole-object GETs of the window's second half, after the
disks are lost, due to last byte, over the objects that get_loss_x pairs:
the degraded side of its ratio."""

from benchmark import layers


def read(ctx):
    return layers.loss_p50_ms(ctx, 1)
