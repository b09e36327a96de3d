"""Encode jobs per codec batch over the preload (LRC's composed parity counts as encode)."""

from benchmark import preload


def read(ctx):
    return preload.encode_jobs_per_batch(ctx)
