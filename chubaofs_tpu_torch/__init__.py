"""chubaofs_tpu_torch — the PyTorch/CUDA port of chubaofs_tpu.

The port lives beside the JAX package and is held against it byte for byte
(GF math is exact). It imports torch and numpy, never jax and never anything
of chubaofs_tpu: each module it needs from there has its own copy here, at the
same relative path, so every module's counterpart is found by path.

Layout (slices 1 and 2: the codec plane and the blobstore access path):
    ops/        GF(2^8) tables, the bit-matrix lowering, the RS kernel API and
                the hand-written Hopper GF(2^8) matmul kernels (ops/csrc):
                B1 (cuda_gf) and the pipelined tensor-core B2 (cuda_gf_pipe)
    codec/      code modes, RS / LRC / product-matrix encoders, CodecService
    models/     the codec "model zoo" (FLAGSHIP, ARCHIVE)
    blobstore/  access gateway, clustermgr, blobnode, proxy, cache, scheduler,
                MiniCluster, trace spans
    blockcache/ the node-local block cache the read cache rides
    utils/      locks, metrics exporter, config, audit log, events, trace
                sink, crc32block, breaker, rate limit, the KV store
    chaos/      failpoints, fault plans and their scheduler

Entry points (MiniCluster, Access, CodecService, new_encoder, RSKernel) run
on the CUDA device unless the caller passes device="cpu"; with no GPU and no
device named they raise instead of falling back to the host.
"""

__version__ = "0.1.0"
