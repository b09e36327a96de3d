"""Codec dispatcher busy share over a GET window."""

from benchmark import layers


def read(ctx):
    return layers.codec_busy_pct(ctx)
