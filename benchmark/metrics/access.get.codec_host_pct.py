"""Share of GET span wall in the codec dispatcher's batches: codec.host
(staging) and codec.launch (matrix expansion, the copies and the kernel, the
wait for the stream). The card's part of it is codec_device_pct."""

from benchmark import spans


def read(ctx):
    return spans.share(ctx, "access.get", ("codec.host", "codec.launch"),
                       needs=("codec.launch",))
