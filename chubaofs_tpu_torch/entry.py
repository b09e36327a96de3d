"""Entry points: the flagship encode on one device, and the sharded codec
step over a device grid.

Counterparts of `entry` and `dryrun_multichip` in __graft_entry__.py
(the JAX package's entry points), with the same sequence and checks, on
the port's modules. Both run on the CUDA device unless the caller passes device="cpu":

    python -c "from chubaofs_tpu_torch import entry; entry.dryrun_multichip(4)"

On a host with fewer cards than n_devices, the grid repeats the cards (a
2 x 2 grid over one H100 exercises every split, pad and gather; its blocks
run one after another on the card's stream).
"""

from __future__ import annotations

import tempfile

import numpy as np
import torch


def _check(cond, what: str) -> None:
    """A check that holds under python -O too."""
    if not cond:
        raise AssertionError(what)


def entry(device=None):
    """(fn, example_args): the flagship step — EC(12,4) stripe encode.

    fn maps a (B, 12, k) uint8 batch of data stripes to the (B, 16, k)
    encoded stripes (data + parity) on the device, through B1 on a CUDA
    device."""
    from chubaofs_tpu_torch.models import FLAGSHIP
    from chubaofs_tpu_torch.ops import rs

    t = FLAGSHIP.tactic
    kernel = rs.get_kernel(t.N, t.M, device)

    def fn(data):
        return kernel.encode(data)

    rng = np.random.default_rng(0)
    example = rng.integers(0, 256, (2, t.N, 1024), dtype=np.uint8)
    return fn, (example,)


def _grid_devices(n_devices: int, device=None) -> list[torch.device]:
    """n_devices grid entries: each CUDA device in turn (repeated when the
    host has fewer), or n_devices times the named device."""
    if device is not None:
        return [torch.device(device)] * n_devices
    from chubaofs_tpu_torch.ops import rs

    rs.resolve_device(None)  # raises without a CUDA device
    count = torch.cuda.device_count()
    return [torch.device("cuda", i % count) for i in range(n_devices)]


def dryrun_multichip(n_devices: int, device=None, shard_len: int = 1 << 20) -> dict:
    """The full codec step (encode + sharded verify + repair) over an
    n-entry grid, then the LRC archive encode and a MiniCluster on a
    grid-backed CodecService; every result checked. shard_len (1 MiB, as
    the reference) exists so that a CPU run can stay small. Returns what it
    ran: the grid's shape, the batch and the shard length."""
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
    from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix
    from chubaofs_tpu_torch.codec.service import CodecService
    from chubaofs_tpu_torch.models import ARCHIVE, FLAGSHIP
    from chubaofs_tpu_torch.ops import gf256, rs
    from chubaofs_tpu_torch.parallel import (
        codec_mesh, sharded_codec_step, sharded_gf_matmul, ungroup_stripe)

    t = FLAGSHIP.tactic
    mesh = codec_mesh(_grid_devices(n_devices, device))
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]
    run = sharded_codec_step(mesh, t.N, t.M)

    rng = np.random.default_rng(0)
    # real-scale shards and an UNEVEN dp remainder: the run pads the batch
    # up to dp and slices results back
    b, k = dp * 2 + 1, shard_len
    data = rng.integers(0, 256, (b, t.N, k), dtype=np.uint8)
    stripe, ok, repaired = (np.asarray(a) for a in run(data, bad_idx=(0, t.N)))

    gen = rs.get_kernel(t.N, t.M, "cpu").gen
    want = gf256.encode_numpy(gen, data[0])
    _check(stripe.shape[0] == b, "batch remainder not sliced back")
    _check(np.array_equal(stripe[0], want), "sharded encode mismatch")
    _check(bool(np.all(ok)), "sharded verify failed")
    _check(np.array_equal(repaired, stripe), "sharded repair mismatch")

    # the repair pattern is runtime data: a different missing set reuses the
    # same per-shape setup
    stripe2, ok2, repaired2 = (np.asarray(a) for a in run(data, bad_idx=(1, t.N - 1, t.N + 1)))
    _check(np.array_equal(repaired2, stripe2), "runtime-plan repair mismatch")
    _check(bool(np.all(ok2)), "runtime-plan verify failed")
    _check(run.trace_count[0] == 1, f"a new repair pattern redid the setup: {run.trace_count[0]}")

    # the grouped layout on the same grid: g=2 stripes viewed as one wide
    # stripe, results converted at the host boundary and cross-checked
    g = 2
    run_g = sharded_codec_step(mesh, t.N, t.M, group=g)
    data_g = data[:, :, : 1 << 16]
    stripe_g, ok_g, _ = run_g(data_g, bad_idx=(0, t.N))
    full = ungroup_stripe(np.asarray(stripe_g), g, t.N, t.M, b=data_g.shape[0])
    want_g = gf256.encode_numpy(gen, data_g[0])
    _check(np.array_equal(full[0], want_g), "grouped sharded encode mismatch")
    _check(bool(np.all(np.asarray(ok_g)[: data_g.shape[0]])), "grouped verify failed")

    # the EC(20,4)+L2 LRC archive mode over the grid: the composed
    # global+local generator, one product per block
    t5 = ARCHIVE.tactic
    lrc_mat = lrc_parity_matrix(t5)
    lrc_bits = rs.bit_operand(lrc_mat)
    data5 = rng.integers(0, 256, (dp * 2, t5.N, 4096), dtype=np.uint8)
    parity5 = sharded_gf_matmul(mesh)(lrc_bits, data5)
    want5 = np.stack([gf256.gf_matmul(lrc_mat, d) for d in data5])
    _check(np.array_equal(parity5, want5), "sharded LRC archive encode mismatch")

    # the data plane above the kernel on the same grid: a MiniCluster whose
    # CodecService drains every batch through sharded_gf_matmul — PUT, a
    # lost shard, degraded GET (sharded reconstruct), durable heal by the
    # inspector and the repair worker
    with tempfile.TemporaryDirectory() as root:
        svc = CodecService(mesh=mesh)
        try:
            c = MiniCluster(root, n_nodes=9, disks_per_node=2, codec=svc)
            try:
                payload = rng.integers(0, 256, 300_000, dtype=np.uint8).tobytes()
                loc = c.access.put(payload)
                blob = loc.blobs[0]
                unit = c.cm.get_volume(blob.vid).units[1]
                c.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)
                _check(c.access.get(loc) == payload, "grid degraded GET mismatch")
                c.run_background_once()  # inspector + repair worker heal the shard
                _check(c.nodes[unit.node_id].get_shard(unit.vuid, blob.bid),
                       "grid repair plane did not restore the shard")
                _check(c.access.get(loc) == payload, "GET after the heal")
            finally:
                c.close()
        finally:
            svc.close()

    return {"dp": dp, "sp": sp, "devices": [str(d) for d in mesh.devices.flat],
            "batch": b, "shard_len": k, "group": g}
