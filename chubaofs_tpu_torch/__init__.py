"""chubaofs_tpu_torch — the PyTorch/CUDA port of chubaofs_tpu.

The port lives beside the JAX package and is held against it byte for byte
(GF math is exact). It imports torch and numpy, never jax and never anything
of chubaofs_tpu: each module it needs from there has its own copy here, at the
same relative path, so every module's counterpart is found by path.

Layout (the codec plane, the blobstore access path, the blobstore daemon and
the device grid):
    ops/        GF(2^8) tables, the bit-matrix lowering, the RS kernel API and
                the hand-written Hopper GF(2^8) matmul kernels (ops/csrc):
                B1 (cuda_gf) and the pipelined tensor-core B2 (cuda_gf_pipe)
    codec/      code modes, RS / LRC / product-matrix encoders, CodecService
    parallel/   the (dp, sp) device grid: sharded placement, the sharded GF
                product and codec step (CodecService(mesh=...) rides it)
    models/     the codec "model zoo" (FLAGSHIP, ARCHIVE)
    blobstore/  access, clustermgr, blobnode, proxy, cache, scheduler,
                MiniCluster, trace spans; the access HTTP gateway and client
                (gateway.py), the module runner and admin API (cmd.py)
    blockcache/ the node-local block cache the read cache rides
    proto/      the binary packet wire and its zero-copy framing
    rpc/        the HTTP framework: router, errors, keep-alive pool, the
                evloop serving core (evloop.py, httpevloop.py), server, client
    utils/      locks, metrics exporter, config, audit log, events, trace
                sink, crc32block, breaker, rate limit, the KV store; the
                health plane (profiler, metric history, SLOs, alerts, flight
                recorder) and graceful shutdown
    autopilot/  alert-driven actuators the RPC server arms at boot
    tools/      cfs-stat (scrape and diff /metrics, or a bundle's frozen
                snapshots) and cfs-doctor (list, inspect, diff bundles)
    cli/        the blobstore admin CLI
    chaos/      failpoints, fault plans and their scheduler
    cmd.py      the daemon entry point, `python -m chubaofs_tpu_torch.cmd -c
                cfg.json`; the blobstore role
    entry.py    entry() (the flagship encode) and dryrun_multichip(n) (the
                sharded codec step over an n-entry grid)

Entry points (MiniCluster, Access, CodecService, new_encoder, RSKernel, the
blobstore daemon, codec_mesh, entry.py) run on the CUDA device unless the
caller passes device="cpu" (the daemon: "device": "cpu" in its config; a
grid: CPU devices); with no GPU and no device named they raise instead of
falling back to the host.
"""

__version__ = "0.1.0"
