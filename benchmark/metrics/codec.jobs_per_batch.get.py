"""Codec jobs per device batch over a GET window."""

from benchmark import layers


def read(ctx):
    return layers.jobs_per_batch(ctx)
