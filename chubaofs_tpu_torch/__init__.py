"""chubaofs_tpu_torch — the PyTorch/CUDA port of chubaofs_tpu.

The port lives beside the JAX package and is held against it byte for byte
(GF math is exact). It imports torch and numpy, never jax and never anything
of chubaofs_tpu: each module it needs from there has its own copy here, at the
same relative path, so every module's counterpart is found by path.

Layout (the codec plane, the blobstore access path, the blobstore daemon,
the device grid and the file/metadata cluster):
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
    raft/       multi-raft: core, WAL and snapshots, in-process and TCP nets,
                the pickle-free wire codec and snapshot sections
    storage/    the datanodes' extent store
    meta/       metanode partitions (inodes, dentries, the cold tier's
                obj_extents), the metanode
    data/       datanodes: chain replication, per-partition raft, repair
    authnode/   the ticket service over a raft-replicated keystore
    master/     the cluster resource manager (volumes, partitions, nodes)
    sdk/        the metadata wrapper, the extent client and FsClient
    deploy.py   FsCluster: the whole file cluster in one process; cold
                volumes write through the blobstore, hot ones to datanodes
    proto/      the binary packet wire and its zero-copy framing
    rpc/        the HTTP framework: router, errors, keep-alive pool, the
                evloop serving core (evloop.py, httpevloop.py), server, client
    utils/      locks, metrics exporter, config, audit log, events, trace
                sink, crc32block, breaker, rate limit, the KV store; the
                health plane (profiler, metric history, SLOs, alerts, flight
                recorder), graceful shutdown, the packet connection pool
                and the authnode's crypto helpers
    autopilot/  alert-driven actuators the RPC server arms at boot
    tools/      cfs-stat (scrape and diff /metrics, or a bundle's frozen
                snapshots), cfs-doctor (list, inspect, diff bundles),
                cfs-trace, cfs-events, cfs-top and cfs-chaos-soak
    cli/        the blobstore admin CLI
    chaos/      failpoints (rpc, raft, datanode, extent store, meta submit,
                blobnode, access, rs encode), fault plans, their scheduler
                and the soak harness
    cmd.py      the daemon entry point, `python -m chubaofs_tpu_torch.cmd -c
                cfg.json`; the blobstore role
    entry.py    entry() (the flagship encode) and dryrun_multichip(n) (the
                sharded codec step over an n-entry grid)

Entry points (MiniCluster, FsCluster, Access, CodecService, new_encoder,
RSKernel, the blobstore daemon, codec_mesh, entry.py, the soak runners) run on
the CUDA device unless the caller passes device="cpu" (the daemon: "device":
"cpu" in its config; a grid: CPU devices); with no GPU and no device named
they raise instead of falling back to the host.
"""

__version__ = "0.1.0"
