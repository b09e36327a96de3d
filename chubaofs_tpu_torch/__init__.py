"""chubaofs_tpu_torch — the PyTorch/CUDA port of chubaofs_tpu.

The port lives beside the JAX package and is held against it byte for byte
(GF math is exact). It imports torch and numpy, never jax and never anything
of chubaofs_tpu: each module it needs from there has its own copy here, at the
same relative path, so every module's counterpart is found by path.

Layout (this slice: the codec plane):
    ops/       GF(2^8) tables, the bit-matrix lowering, the RS kernel API and
               the hand-written Hopper GF(2^8) matmul kernel (ops/csrc)
    codec/     code modes, RS / LRC / product-matrix encoders, CodecService
    models/    the codec "model zoo" (FLAGSHIP, ARCHIVE)
    utils/     locks, metrics exporter, config, audit log, events, trace sink
    chaos/     failpoints
    blobstore/ trace spans (the gateway itself is the next slice)

Entry points (CodecService, new_encoder, RSKernel) run on the CUDA device
unless the caller passes device="cpu"; with no GPU and no device named they
raise instead of falling back to the host.
"""

__version__ = "0.1.0"
