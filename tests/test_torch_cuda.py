"""The CUDA kernels on the card, against their plain PyTorch version, and
the device grid of parallel/mesh.py laid over the card.

These tests need an NVIDIA GPU with nvcc (they build ops/csrc/gf_matmul.cu,
B1, and ops/csrc/gf_matmul_pipe.cu, B2); elsewhere they skip. On the GPU machine run them with
`python -m pytest --noconftest tests/test_torch_cuda.py -q -m cuda`
(tests/conftest.py imports jax, which the port's machine need not have;
this file needs none of its fixtures).
"""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf, cuda_gf_pipe, gf256, rs

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


SHAPES = [
    (4, 12, (3,), 4096), (3, 6, (), 1000), (22, 16, (2, 2), 12345),
    (30, 30, (3,), 777), (0, 6, (2,), 256), (40, 50, (1,), 300),
    (2, 1600, (1,), 64),
]


@pytest.mark.parametrize("r,n,lead,k", SHAPES)
def test_kernel_equals_plain_on_card(dev, r, n, lead, k):
    rng = np.random.default_rng(r * 1000 + n)
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    x = torch.from_numpy(rng.integers(0, 256, (*lead, n, k), dtype=np.uint8)).to(dev)
    before = cuda_gf.LAUNCHES
    got = cuda_gf.gf_matmul(bits, x)
    want = rs.gf_matmul_bytes(bits, x)
    torch.cuda.synchronize()
    assert got.shape == (*lead, r, k)
    assert torch.equal(got, want)
    assert cuda_gf.LAUNCHES - before == (len(cuda_gf.blocks(r, n)) if r else 0)
    if r:
        host = x.reshape(-1, n, k)[0].cpu().numpy()
        assert np.array_equal(got.reshape(-1, r, k)[0].cpu().numpy(),
                              gf256.gf_matmul(coef, host))


@pytest.mark.parametrize("k", [1, 15, 17, 31, 32, 33, 1000, 1023, 1024, 1025, 12345, 699_051])
@pytest.mark.parametrize("offset", [0, 1, 4, 15])
def test_kernel_tails_and_bases(dev, k, offset):
    """Every row at its own offset mod 16 (odd k) and row bases at odd and
    4-byte offsets (a slice made contiguous at that offset): aligned loads
    and a funnel shift, stores through the left lane's words, ragged ends
    bytewise."""
    rng = np.random.default_rng(k * 10 + offset)
    bits = rs.get_kernel(6, 3, dev).parity_bits
    b, n = 2, 6
    flat = torch.from_numpy(rng.integers(0, 256, b * n * k + offset, dtype=np.uint8)).to(dev)
    x = flat[offset:].view(b, n, k)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset % 16
    got = cuda_gf.gf_matmul(bits, x)
    torch.cuda.synchronize()
    assert torch.equal(got, rs.gf_matmul_bytes(bits, x)), (k, offset)


@pytest.mark.parametrize("r,n,k", [(5, 7, 1000), (4, 12, 65536), (30, 30, 4099), (1, 9, 3001),
                                   (2, 20, 2048)])
def test_kernel_non_expansion_matrix(dev, r, n, k):
    """Any GF(2) matrix, as the TPU kernel takes it."""
    rng = np.random.default_rng(r * 100 + n)
    bits = rng.integers(0, 2, (8 * r, 8 * n), dtype=np.int8)
    x = torch.from_numpy(rng.integers(0, 256, (3, n, k), dtype=np.uint8)).to(dev)
    got = cuda_gf.gf_matmul(bits, x)
    torch.cuda.synchronize()
    assert torch.equal(got, rs.gf_matmul_bytes(bits, x))


@pytest.mark.parametrize("r,n,k", [(70, 30, 5000), (3, 2000, 1000), (60, 40, 777)])
def test_kernel_past_its_budget(dev, r, n, k):
    """Shapes past B1's shared-memory budget: row blocks, column blocks that
    accumulate (at an odd base too), and both."""
    rng = np.random.default_rng(r + n)
    bits = rng.integers(0, 2, (8 * r, 8 * n), dtype=np.int8)
    assert len(cuda_gf.blocks(r, n)) > 1
    flat = torch.from_numpy(rng.integers(0, 256, 2 * n * k + 1, dtype=np.uint8)).to(dev)
    for x in (flat[:-1].view(2, n, k), flat[1:].view(2, n, k)):
        before = cuda_gf.LAUNCHES
        got = cuda_gf.gf_matmul(bits, x)
        torch.cuda.synchronize()
        assert torch.equal(got, rs.gf_matmul_bytes(bits, x))
        assert cuda_gf.LAUNCHES - before == len(cuda_gf.blocks(r, n))


def test_kernel_rejects_non_contiguous(dev):
    bits = rs.get_kernel(4, 2, dev).parity_bits
    x = torch.zeros((4, 64), dtype=torch.uint8, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        cuda_gf.gf_matmul(bits, x)


# -- B2, the pipelined tensor-core kernel -----------------------------------------


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("r,n,lead,k", SHAPES + [(4, 12, (16,), 1 << 20), (1, 12, (5,), 7777)])
def test_pipe_kernel_equals_plain_on_card(dev, r, n, lead, k, static):
    rng = np.random.default_rng(r * 1000 + n)
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    x = torch.from_numpy(rng.integers(0, 256, (*lead, n, k), dtype=np.uint8)).to(dev)
    variant = "static" if static else "dynamic"
    before = cuda_gf_pipe.LAUNCHES[variant]
    got = cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, x, static_slots=static)
    want = rs.gf_matmul_bytes(bits, x)
    torch.cuda.synchronize()
    assert got.shape == (*lead, r, k)
    assert torch.equal(got, want)
    assert cuda_gf_pipe.LAUNCHES[variant] - before == (len(cuda_gf_pipe.blocks(r, n)) if r else 0)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("k", [1, 15, 17, 128, 256, 300, 384, 511, 512, 513, 640, 768, 1023, 1280])
@pytest.mark.parametrize("offset", [0, 1, 4])
def test_pipe_kernel_tiles_tails_and_bases(dev, k, offset, static):
    """tile_k=256 on one SM's worth of grid and on the whole card: 1, 2, 3
    and 5 tiles per stripe, k under one tile, tile boundaries +-1, and row
    bases at odd and 4-byte offsets (a slice made contiguous at that
    offset)."""
    rng = np.random.default_rng(k * 10 + offset)
    bits = rs.get_kernel(6, 3, dev).parity_bits
    b, n = 2, 6
    flat = torch.from_numpy(rng.integers(0, 256, b * n * k + offset, dtype=np.uint8)).to(dev)
    x = flat[offset:].view(b, n, k)
    assert x.is_contiguous() and x.data_ptr() % 16 == offset % 16
    want = rs.gf_matmul_bytes(bits, x)
    for sms in (1, 132):
        got = cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, x, tile_k=256, static_slots=static,
                                                     sms=sms)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (k, offset, sms)


def test_pipe_kernel_group_stacked_matrix(dev):
    rng = np.random.default_rng(5)
    ker = rs.get_kernel(4, 2, dev)
    b, g, n, k = 4, 2, 4, 384
    host = rng.integers(0, 256, (b, n, k), dtype=np.uint8)
    mat_s = np.kron(np.eye(g, dtype=np.int8), rs.to_numpy(ker.parity_bits))
    want = rs.gf_matmul_bytes(ker.parity_bits, torch.from_numpy(host))
    for static in (False, True):
        got = cuda_gf_pipe.gf_matmul_bytes_pipelined(
            mat_s, torch.from_numpy(host.reshape(b // g, g * n, k)).to(dev), tile_k=256,
            static_slots=static, sms=1)
        assert torch.equal(got.cpu().reshape(b, 2, k), want)


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("r,n,k", [(5, 7, 1000), (4, 12, 65536), (30, 30, 4099), (1, 9, 3001),
                                   (2, 20, 2048)])
def test_pipe_kernel_non_expansion_matrix(dev, r, n, k, static):
    """Any GF(2) matrix, as the TPU kernel takes it."""
    rng = np.random.default_rng(r * 100 + n)
    bits = rng.integers(0, 2, (8 * r, 8 * n), dtype=np.int8)
    x = torch.from_numpy(rng.integers(0, 256, (3, n, k), dtype=np.uint8)).to(dev)
    got = cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, x, static_slots=static)
    torch.cuda.synchronize()
    assert torch.equal(got, rs.gf_matmul_bytes(bits, x))


@pytest.mark.parametrize("static", [False, True])
@pytest.mark.parametrize("r,n,k", [(70, 20, 5000), (3, 300, 1000), (66, 130, 700)])
def test_pipe_kernel_past_its_budget(dev, r, n, k, static):
    """Shapes past B2's operand budget: row blocks, column blocks that
    accumulate, and both."""
    rng = np.random.default_rng(r + n)
    coef = rng.integers(0, 256, (r, n), dtype=np.uint8)
    bits = bitmatrix.expand_matrix(coef).astype(np.int8)
    assert len(cuda_gf_pipe.blocks(r, n)) > 1
    x = torch.from_numpy(rng.integers(0, 256, (2, n, k), dtype=np.uint8)).to(dev)
    variant = "static" if static else "dynamic"
    before = cuda_gf_pipe.LAUNCHES[variant]
    got = cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, x, static_slots=static)
    torch.cuda.synchronize()
    assert torch.equal(got, rs.gf_matmul_bytes(bits, x))
    assert cuda_gf_pipe.LAUNCHES[variant] - before == len(cuda_gf_pipe.blocks(r, n))


def test_dispatch_follows_cfs_gf_pipelined_on_card(dev, monkeypatch):
    bits = rs.get_kernel(6, 3, dev).parity_bits
    x = torch.from_numpy(np.random.default_rng(3).integers(0, 256, (2, 6, 4096), dtype=np.uint8)).to(dev)
    want = rs.gf_matmul_bytes(bits, x)
    for env, counter in (("1", "dynamic"), ("static", "static"), ("", None)):
        monkeypatch.setenv("CFS_GF_PIPELINED", env)
        b1, b2 = cuda_gf.LAUNCHES, dict(cuda_gf_pipe.LAUNCHES)
        got = rs.gf_matmul_dispatch(bits, x)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
        if counter:
            assert cuda_gf.LAUNCHES == b1 and cuda_gf_pipe.LAUNCHES[counter] == b2[counter] + 1
        else:
            assert cuda_gf.LAUNCHES == b1 + 1 and cuda_gf_pipe.LAUNCHES == b2


def test_pipe_kernel_rejects_non_contiguous(dev):
    bits = rs.get_kernel(4, 2, dev).parity_bits
    x = torch.zeros((4, 64), dtype=torch.uint8, device=dev)[:, ::2]
    with pytest.raises(ValueError):
        cuda_gf_pipe.gf_matmul_bytes_pipelined(bits, x)


def test_pipe_failure_raises_instead_of_falling_back(dev, monkeypatch):
    """Under CFS_GF_PIPELINED=1 a B2 that cannot build raises: neither B1 nor
    the plain version steps in."""
    def broken_build():
        raise RuntimeError("nvcc failed")

    monkeypatch.setenv("CFS_GF_PIPELINED", "1")
    monkeypatch.setattr(cuda_gf_pipe, "_lib", None)
    monkeypatch.setattr(cuda_gf_pipe, "load", broken_build)
    bits = rs.get_kernel(6, 3, dev).parity_bits
    x = torch.zeros((2, 6, 4096), dtype=torch.uint8, device=dev)
    b1 = cuda_gf.LAUNCHES
    with pytest.raises(RuntimeError, match="nvcc failed"):
        rs.gf_matmul_dispatch(bits, x)
    assert cuda_gf.LAUNCHES == b1


# -- parallel/mesh.py on the card: a grid that repeats the card ---------------


@pytest.mark.parametrize("dp,sp", [(1, 1), (2, 2), (1, 4)])
@pytest.mark.parametrize("group", [1, 2])
def test_mesh_step_on_card_matches_single_device(dev, monkeypatch, dp, sp, group):
    """sharded_codec_step on a grid of the host's cards (each card in turn,
    repeated when there are fewer than dp x sp) against the single-device
    RSKernel on the card: every stripe byte-equal, ok all true, repaired ==
    stripe for two patterns with one setup, and every product on B1 (3
    launches per block per call), even under CFS_GF_PIPELINED=1."""
    from chubaofs_tpu_torch.parallel import codec_mesh, sharded_codec_step, ungroup_stripe

    n, m = 6, 3
    cards = torch.cuda.device_count()
    mesh = codec_mesh([torch.device("cuda", i % cards) for i in range(dp * sp)], dp=dp, sp=sp)
    run = sharded_codec_step(mesh, n, m, group=group)
    data = np.random.default_rng(dp * 10 + sp).integers(
        0, 256, (2 * dp * group + 1, n, 4099), dtype=np.uint8)
    want = rs.get_kernel(n, m, dev).encode(torch.from_numpy(data).to(dev)).cpu().numpy()
    monkeypatch.setenv("CFS_GF_PIPELINED", "1")  # the grid never takes B2
    for bad in [(0, n), (1, 2, n + 1)]:
        b1, b2 = cuda_gf.LAUNCHES, dict(cuda_gf_pipe.LAUNCHES)
        stripe, ok, repaired = (np.asarray(a) for a in run(data, bad_idx=bad))
        assert cuda_gf.LAUNCHES - b1 == 3 * dp * sp and cuda_gf_pipe.LAUNCHES == b2
        if group > 1:
            stripe = ungroup_stripe(stripe, group, n, m, b=data.shape[0])
            repaired = ungroup_stripe(repaired, group, n, m, b=data.shape[0])
        assert np.array_equal(stripe, want) and np.array_equal(repaired, want)
        assert ok.shape == (data.shape[0],) and ok.all()
    assert run.trace_count[0] == 1


def test_mesh_gf_matmul_on_card_matches_hostbatch(dev):
    from chubaofs_tpu_torch.parallel import codec_mesh, sharded_gf_matmul

    mesh = codec_mesh([torch.device("cuda", i % torch.cuda.device_count()) for i in range(4)],
                      dp=2, sp=2)
    bits = rs.get_kernel(12, 4, dev).parity_bits
    for b, k in [(16, 65536), (5, 4099), (3, 17)]:
        data = np.random.default_rng(b + k).integers(0, 256, (b, 12, k), dtype=np.uint8)
        assert np.array_equal(sharded_gf_matmul(mesh)(bits, data),
                              rs.gf_matmul_hostbatch(bits, data, dev)), (b, k)


def test_mesh_dryrun_and_entry_on_card(dev):
    from chubaofs_tpu_torch import entry

    fn, (example,) = entry.entry()
    out = fn(example)
    assert out.device.type == "cuda" and out.shape == (2, 16, 1024)
    got = entry.dryrun_multichip(4, shard_len=65536)
    assert (got["dp"], got["sp"]) == (2, 2)


def test_kill_blobnode_soak_on_card(dev, tmp_path, monkeypatch):
    """The repair plane's acceptance scenario at smoke size with the codec
    on the card: every acked blob rebuilds byte-identical through B1, and
    B2 stays idle with CFS_GF_PIPELINED unset."""
    from chubaofs_tpu_torch.chaos.soak import run_kill_soak

    monkeypatch.delenv("CFS_GF_PIPELINED", raising=False)
    b1, b2 = cuda_gf.LAUNCHES, dict(cuda_gf_pipe.LAUNCHES)
    res = run_kill_soak(str(tmp_path), seed=7, device="cuda", warm_puts=6,
                        live_puts=3, hb_timeout=0.4, read_deadline=0.4,
                        write_deadline=2.5, max_wait_s=90.0,
                        sizes=[120_000, 700_000])
    assert res["ok"], res
    assert res["rebuilt_shards"] > 0 and res["rebuild_shards_per_s"] > 0
    assert res["alerts_fired"] == ["broken_disks"]
    assert cuda_gf.LAUNCHES > b1
    assert cuda_gf_pipe.LAUNCHES == b2


def test_fs_cluster_cold_volume_on_card(dev, tmp_path, monkeypatch):
    """The filesystem client on a cold volume with the codec on the card:
    writes and reads launch B1 and return the bytes; a hot volume launches
    no kernel; FsCluster with no device takes the card."""
    from chubaofs_tpu_torch.deploy import FsCluster

    monkeypatch.delenv("CFS_GF_PIPELINED", raising=False)
    c = FsCluster(str(tmp_path / "fs"))
    try:
        assert c.blobstore.codec.device.type == "cuda"
        c.create_volume("cold")
        c.create_volume("hot", cold=False)
        fs, hot = c.client("cold"), c.client("hot")
        rng = np.random.default_rng(8)
        files = {f"/d/f{i}": rng.bytes(int(rng.integers(4096, 3_000_000))) for i in range(6)}
        b1, b2 = cuda_gf.LAUNCHES, dict(cuda_gf_pipe.LAUNCHES)
        fs.mkdirs("/d")
        for path, data in files.items():
            fs.write_file(path, data)
        fs.append_file("/d/f0", b"tail")
        torch.cuda.synchronize()
        assert cuda_gf.LAUNCHES > b1
        for path, data in files.items():
            want = data + (b"tail" if path == "/d/f0" else b"")
            assert fs.read_file(path) == want
            assert fs.read_file(path, 1000, 2000) == want[1000:3000]
        b1 = cuda_gf.LAUNCHES
        hot.write_file("/h", files["/d/f1"])
        assert hot.read_file("/h") == files["/d/f1"]
        torch.cuda.synchronize()
        assert cuda_gf.LAUNCHES == b1
        assert cuda_gf_pipe.LAUNCHES == b2
    finally:
        c.close()


def test_proc_cluster_cold_volume_on_card(dev, tmp_path, monkeypatch):
    """The cluster as daemons with the codec on the card: a ProcCluster
    with no device runs its blobstore daemon on the CUDA device, and cold
    writes through the SDK over the wire grow that daemon's codec batches;
    reads of healthy stripes return the bytes."""
    import time

    from chubaofs_tpu_torch.testing.harness import ProcCluster
    from chubaofs_tpu_torch.tools.cfsstat import parse_metrics, scrape

    monkeypatch.delenv("CFS_GF_PIPELINED", raising=False)
    c = ProcCluster(str(tmp_path / "procs"), masters=1, metanodes=3,
                    datanodes=0, blobstore=True)
    try:
        def batches():
            return parse_metrics(scrape(c.access_addr)).get(
                "cfs_codec_batches_total", 0)

        c.client_master().create_volume("cold", cold=True)
        fs = c.fs("cold")
        rng = np.random.default_rng(9)
        # at most 1 MiB each: the harness's 12 disks take up to EC(6,3)
        files = {f"/f{i}": rng.bytes(int(rng.integers(4096, 1 << 20)))
                 for i in range(8)}
        before = batches()
        deadline = time.monotonic() + 30
        while True:  # the volume's meta partition elects a leader first
            try:
                fs.mkdirs("/d")
                break
            except Exception:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.3)
        for path, data in files.items():
            fs.write_file(path, data)
        assert batches() > before
        for path, data in files.items():
            assert fs.read_file(path) == data
            assert fs.read_file(path, 100, 1000) == data[100:1100]
    finally:
        c.close()
