"""The cases of tests/test_ranged_reads.py, run against the port on the CPU.

Partial-stripe ranged reads: byte-window shard gather, range-scoped degraded
decode, block-granular cache, the cfs-stat read rollup, and the HTTP Range
surface of the access gateway (range parsing, 206, 416, 400), and the cfs-top
read-amp column."""

import os

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.access import AccessError
from chubaofs_tpu_torch.blobstore.cache import BlobCache
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic
from chubaofs_tpu_torch.codec.service import CodecService
from chubaofs_tpu_torch.ops import gf256
from chubaofs_tpu_torch.ops.rs import RSKernel
from chubaofs_tpu_torch.utils.exporter import registry


CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture
def cluster(tmp_path):
    # EC12P4 places 16 units on 16 distinct disks
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=9, disks_per_node=2)
    yield c
    c.close()


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def read_counter(kind):
    return registry("access").counter("read_bytes", {"kind": kind}).value


def lose(cluster, blob, idx):
    vol = cluster.cm.get_volume(blob.vid)
    unit = vol.units[idx]
    cluster.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)


# -- decode_rows / window_matrix numerics -----------------------------------


def test_window_matrix_matches_encoded_stripe(rng):
    n, m, k = 6, 3, 4096
    kern = RSKernel(n, m, CPU)
    data = rng.integers(0, 256, (n, k), dtype=np.uint8)
    stripe = np.concatenate(
        [data, gf256.gf_matmul(kern.gen[n:, :], data)], axis=0)
    present = [0, 2, 3, 5, 6, 8]
    want = [1, 4]
    mat = kern.window_matrix(present, want)
    out = gf256.gf_matmul(mat, stripe[np.asarray(present), :])
    assert np.array_equal(out, stripe[np.asarray(want), :])


def test_window_matrix_present_rows_are_identity(rng):
    """A wanted shard that is ALSO a survivor comes back verbatim — the
    row-sliced matrix contains a unit row for it, so mixing served and
    reconstructed shards in one decode is safe."""
    n, m, k = 6, 3, 512
    kern = RSKernel(n, m, CPU)
    data = rng.integers(0, 256, (n, k), dtype=np.uint8)
    stripe = np.concatenate(
        [data, gf256.gf_matmul(kern.gen[n:, :], data)], axis=0)
    present = [0, 1, 2, 3, 4, 6]
    out = gf256.gf_matmul(kern.window_matrix(present, [2, 5]),
                          stripe[np.asarray(present), :])
    assert np.array_equal(out[0], stripe[2])
    assert np.array_equal(out[1], stripe[5])


def test_window_matrix_validates():
    kern = RSKernel(6, 3, CPU)
    with pytest.raises(ValueError):
        kern.window_matrix([0, 1, 2], [4])  # too few survivors
    with pytest.raises(ValueError):
        kern.window_matrix([0, 1, 2, 3, 4, 9], [4])  # out of range
    assert kern.window_matrix([0, 1, 2, 3, 4, 5], []).shape == (0, 6)


def test_decode_rows_column_sliced(rng):
    """Column independence: decoding survivors restricted to a byte window
    yields exactly the same window of the wanted shards — the property the
    range-scoped degraded path is built on."""
    n, m, k = 6, 3, 4096
    svc = CodecService(device=CPU)
    try:
        data = rng.integers(0, 256, (n, k), dtype=np.uint8)
        stripe = np.asarray(svc.encode(n, m, data).result())
        present = [0, 2, 3, 5, 6, 8]
        want = [1, 4]
        lo, hi = 100, 900
        full = np.asarray(svc.decode_rows(
            n, m, present, stripe[np.asarray(present), :], want).result())
        assert np.array_equal(full, stripe[np.asarray(want), :])
        window = np.asarray(svc.decode_rows(
            n, m, present, stripe[np.asarray(present), lo:hi], want).result())
        assert window.shape == (len(want), hi - lo)
        assert np.array_equal(window, stripe[np.asarray(want), lo:hi])
    finally:
        svc.close()


# -- ranged-read equivalence: healthy ---------------------------------------


def test_ranged_fuzz_healthy(cluster, rng):
    data = blob_bytes(rng, 2_000_000)  # EC12P4
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    whole = cluster.access.get(loc)
    assert whole == data
    pyrng = np.random.default_rng(7)
    size = len(data)
    windows = [(0, 0), (size, 0), (0, size), (size - 1, 1), (0, 1)]
    for _ in range(20):
        off = int(pyrng.integers(0, size))
        ln = int(pyrng.integers(0, size - off + 1))
        windows.append((off, ln))
    for off, ln in windows:
        assert cluster.access.get(loc, off, ln) == data[off:off + ln], \
            f"window ({off}, {ln})"


def test_ranged_out_of_bounds_rejected(cluster, rng):
    data = blob_bytes(rng, 100_000)
    loc = cluster.access.put(data)
    for off, ln in ((0, len(data) + 1), (len(data) + 1, 0), (-1, 10),
                    (50_000, 60_000)):
        with pytest.raises(AccessError):
            cluster.access.get(loc, off, ln)


def test_healthy_subshard_range_reads_less_than_stripe(cluster, rng):
    """The acceptance floor: a 64 KiB range on a 2 MiB EC12P4 blob must move
    fewer backend bytes than the data stripe — the whole point of the
    byte-window gather."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    t = get_tactic(CodeMode.EC12P4)
    shard_len = t.shard_size(len(data))
    s0 = read_counter("shards_read")
    d0 = read_counter("decoded")
    off, ln = 123_456, 64 * 1024
    assert cluster.access.get(loc, off, ln) == data[off:off + ln]
    shards_read = read_counter("shards_read") - s0
    assert 0 < shards_read < t.N * shard_len
    # healthy + sub-shard: served verbatim from in-window data shards
    assert shards_read <= 2 * ln
    assert read_counter("decoded") == d0  # zero decode on the healthy path


# -- ranged-read equivalence: degraded --------------------------------------


def test_ranged_fuzz_degraded(cluster, rng):
    """Byte-identical ranged reads with a lost data shard AND a lost parity
    shard: every window that touches the hole decodes only window columns."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    t = get_tactic(CodeMode.EC12P4)
    shard_len = t.shard_size(len(data))
    lose(cluster, blob, 1)   # data shard
    lose(cluster, blob, 13)  # parity shard
    size = len(data)
    pyrng = np.random.default_rng(3)
    windows = [
        (0, size),                       # whole object through the hole
        (shard_len - 100, 300),          # crosses shard 0 -> lost shard 1
        (shard_len + 10, 1000),          # entirely inside the lost shard
        (2 * shard_len - 50, 100),       # lost shard 1 -> shard 2
        (size - 7, 7),                   # tail
        (shard_len, 0),                  # zero-length at the hole
    ]
    for _ in range(10):
        off = int(pyrng.integers(0, size))
        ln = int(pyrng.integers(0, min(size - off, 200_000) + 1))
        windows.append((off, ln))
    for off, ln in windows:
        assert cluster.access.get(loc, off, ln) == data[off:off + ln], \
            f"window ({off}, {ln})"


def test_degraded_range_decodes_window_not_stripe(cluster, rng):
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    t = get_tactic(CodeMode.EC12P4)
    shard_len = t.shard_size(len(data))
    lose(cluster, blob, 1)
    d0 = read_counter("decoded")
    off, ln = shard_len + 64, 4096  # strictly inside the lost shard
    assert cluster.access.get(loc, off, ln) == data[off:off + ln]
    decoded = read_counter("decoded") - d0
    # one missing shard over a <= ln+1 byte column window — nowhere near
    # the shard_len a full-stripe reconstruct would decode
    assert 0 < decoded <= 2 * ln
    assert decoded < shard_len


def test_degraded_gather_skips_unselected_parity(cluster, rng):
    """The degraded window gather launches survivor reads it
    SELECTS — with one lost data shard, one replacement suffices, so the
    foreground read set is the in-window data shards plus exactly enough
    survivors, never all parity. Only count=True reads are foreground; the
    async probe plane (count=False) deliberately touches the rest."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    t = get_tactic(CodeMode.EC12P4)
    shard_len = t.shard_size(len(data))
    lose(cluster, blob, 1)
    access = cluster.access
    foreground: list[int] = []
    orig = access._read_shard

    def spy(vol, idx, bid, offset, size, count=True):
        if count:
            foreground.append(idx)
        return orig(vol, idx, bid, offset, size, count)

    access._read_shard = spy
    try:
        off, ln = shard_len + 10, 1000
        assert access.get(loc, off, ln) == data[off:off + ln]
    finally:
        access._read_shard = orig
    # direct attempt on the lost shard + its replacement survivors: the
    # window needs N column-survivors, so at most N+1 foreground reads and
    # at least one parity/other-data shard NOT gathered
    assert len(foreground) <= t.N + 1
    assert len(set(foreground) & set(range(t.N, t.N + t.M))) < t.M


# -- block-granular cache ----------------------------------------------------


def test_cache_block_keys_and_ranged_fill(tmp_path):
    cache = BlobCache(str(tmp_path), mem_mb=8, block_bytes=4096)
    B = cache.block
    blob = bytes(range(256)) * (3 * B // 256 + 16)  # 3 blocks + tail
    ver = cache.fill_version(1, 2)
    assert cache.fill(1, 2, ver, blob)  # whole-blob fill infers total
    assert cache.get(1, 2) == blob
    # sub-block and cross-block lookups assemble from block keys
    assert cache.get(1, 2, 100, 50) == blob[100:150]
    assert cache.get(1, 2, B - 10, 20) == blob[B - 10:B + 10]
    assert cache.get(1, 2, 3 * B, None) == blob[3 * B:]  # short tail block


def test_cache_partial_fill_serves_only_covered_blocks(tmp_path):
    cache = BlobCache(str(tmp_path), mem_mb=8, block_bytes=4096)
    B = cache.block
    total = 5 * B
    blob = os.urandom(total)
    ver = cache.fill_version(7, 9)
    # a block-aligned middle window: blocks 1 and 2 land, nothing else
    assert cache.fill(7, 9, ver, blob[B:3 * B], offset=B, total=total)
    assert cache.get(7, 9, B, 2 * B) == blob[B:3 * B]
    assert cache.get(7, 9, B + 5, 100) == blob[B + 5:B + 105]
    assert cache.get(7, 9, 0, 10) is None        # block 0 never filled
    assert cache.get(7, 9, 3 * B, 10) is None    # block 3 never filled
    assert cache.get(7, 9, 2 * B, B + 1) is None  # straddles into a hole


def test_cache_unaligned_fill_skips_partial_edge_blocks(tmp_path):
    cache = BlobCache(str(tmp_path), mem_mb=8, block_bytes=4096)
    B = cache.block
    total = 4 * B
    blob = os.urandom(total)
    ver = cache.fill_version(3, 3)
    # window covers half of block 0, all of block 1, half of block 2:
    # only block 1 is fully covered, so only block 1 may be served
    assert cache.fill(3, 3, ver, blob[B // 2:2 * B + B // 2],
                      offset=B // 2, total=total)
    assert cache.get(3, 3, B, B) == blob[B:2 * B]
    assert cache.get(3, 3, B // 2, 10) is None
    assert cache.get(3, 3, 2 * B, 10) is None


def test_cache_invalidate_punches_blocks(tmp_path):
    cache = BlobCache(str(tmp_path), mem_mb=8, block_bytes=4096)
    blob = os.urandom(3 * cache.block)
    ver = cache.fill_version(5, 5)
    assert cache.fill(5, 5, ver, blob)
    assert cache.get(5, 5, 10, 100) == blob[10:110]
    cache.invalidate(5, 5)
    assert cache.get(5, 5, 10, 100) is None
    assert cache.get(5, 5) is None


def test_cache_stale_fill_version_rejected(tmp_path):
    cache = BlobCache(str(tmp_path), mem_mb=8, block_bytes=4096)
    blob = os.urandom(2 * cache.block)
    ver = cache.fill_version(6, 6)
    cache.invalidate(6, 6)  # version bumps after the backend read started
    assert not cache.fill(6, 6, ver, blob)
    assert cache.get(6, 6, 0, 100) is None


# -- access + cache -------------------------------------------------------


def test_access_ranged_miss_fills_blocks_and_hits_on_repeat(tmp_path, rng):
    cache = BlobCache(os.path.join(str(tmp_path), "cache"), mem_mb=16)
    c = MiniCluster(os.path.join(str(tmp_path), "cl"), n_nodes=9,
                    disks_per_node=2, cache=cache, device=CPU)
    try:
        data = blob_bytes(rng, 2_000_000)
        loc = c.access.put(data, code_mode=CodeMode.EC12P4)
        off, ln = 300_000, 64 * 1024
        assert c.access.get(loc, off, ln) == data[off:off + ln]
        s0 = read_counter("shards_read")
        # repeat + a sub-window of the block-rounded fill: both cache hits
        assert c.access.get(loc, off, ln) == data[off:off + ln]
        assert c.access.get(loc, off + 1000, 512) == \
            data[off + 1000:off + 1512]
        assert read_counter("shards_read") == s0  # zero backend bytes
    finally:
        c.close()


# -- cfs-stat read rollup and the gateway HTTP Range surface --------------


def test_cfsstat_read_rollup_and_summary():
    from chubaofs_tpu_torch.tools.cfsstat import is_read_metric, read_amp_summary

    assert is_read_metric("cfs_access_read_bytes")
    assert is_read_metric("cfs_cache_hits")
    assert is_read_metric("cfs_bcache_mem_hits")
    assert is_read_metric("cfs_blobnode_shard_get_total")
    assert not is_read_metric("cfs_scheduler_tasks")
    before = {'cfs_access_read_bytes{kind="requested"}': 0.0,
              'cfs_access_read_bytes{kind="shards_read"}': 0.0,
              'cfs_access_read_bytes{kind="decoded"}': 0.0}
    after = {'cfs_access_read_bytes{kind="requested"}': 4096.0,
             'cfs_access_read_bytes{kind="shards_read"}': 8192.0,
             'cfs_access_read_bytes{kind="decoded"}': 1024.0}
    amp = read_amp_summary(before, after)
    assert amp == {"requested_bytes": 4096.0, "shards_read_bytes": 8192.0,
                   "decoded_bytes": 1024.0, "read_amp": 2.0}
    # a quiet window prints nothing rather than 0.0
    assert read_amp_summary(after, after) is None


def test_parse_http_range_forms():
    from chubaofs_tpu_torch.blobstore.gateway import parse_http_range

    assert parse_http_range("bytes=0-99", 1000) == (0, 100)
    assert parse_http_range("bytes=100-", 1000) == (100, 900)
    assert parse_http_range("bytes=-50", 1000) == (950, 50)
    assert parse_http_range("bytes=900-5000", 1000) == (900, 100)  # clipped
    assert parse_http_range("bytes=1000-1001", 1000) is None  # past the end
    assert parse_http_range("bytes=-0", 1000) is None
    assert parse_http_range("bytes=5-2", 1000) is None
    for bad in ("items=0-1", "bytes=-", "bytes=abc-1", "bytes=5"):
        with pytest.raises(ValueError):
            parse_http_range(bad, 1000)


@pytest.fixture
def gateway_pair(cluster):
    from chubaofs_tpu_torch.blobstore.gateway import AccessClient, AccessGateway

    gw = AccessGateway(cluster.access)
    yield cluster, AccessClient([gw.addr])
    gw.stop()


def test_gateway_range_request_206(gateway_pair, rng):
    cluster, client = gateway_pair
    data = blob_bytes(rng, 500_000)
    loc = client.put(data)
    status, headers, body = client.get_range(loc, "bytes=1000-1999")
    assert status == 206
    assert body == data[1000:2000]
    assert headers["Content-Range"] == f"bytes 1000-1999/{len(data)}"
    # suffix + open-ended forms
    status, headers, body = client.get_range(loc, "bytes=-77")
    assert (status, body) == (206, data[-77:])
    status, _, body = client.get_range(loc, f"bytes={len(data) - 10}-")
    assert (status, body) == (206, data[-10:])


def test_gateway_range_416_and_400(gateway_pair, rng):
    cluster, client = gateway_pair
    data = blob_bytes(rng, 10_000)
    loc = client.put(data)
    status, headers, _ = client.get_range(loc, f"bytes={len(data)}-")
    assert status == 416
    assert headers["Content-Range"] == f"bytes */{len(data)}"
    status, _, _ = client.get_range(loc, "pages=0-1")
    assert status == 400
    # plain (un-ranged) GET still answers 200 with the whole object
    assert client.get(loc) == data


def test_cfstop_read_amp_column():
    from chubaofs_tpu_torch.tools.cfstop import COLUMNS, compute_row, render

    prev = {'cfs_access_read_bytes{kind="requested"}': 1000.0,
            'cfs_access_read_bytes{kind="shards_read"}': 1000.0}
    cur = {'cfs_access_read_bytes{kind="requested"}': 2000.0,
           'cfs_access_read_bytes{kind="shards_read"}': 5000.0}
    row = compute_row("t1", prev, cur, 1.0, {"status": "ok"})
    assert row["read_amp"] == pytest.approx(4.0)
    assert "RDAMP" in COLUMNS
    assert "4" in render([row])
    # no reads in the window -> '-' (None), never a fake amp
    row2 = compute_row("t2", {"x": 1.0}, {"x": 2.0}, 1.0, {"status": "ok"})
    assert row2["read_amp"] is None
    # daemon restart: post-restart value IS the delta (never negative)
    cur3 = {'cfs_access_read_bytes{kind="requested"}': 100.0,
            'cfs_access_read_bytes{kind="shards_read"}': 300.0}
    row3 = compute_row("t3", prev, cur3, 1.0, {"status": "ok"})
    assert row3["read_amp"] == pytest.approx(3.0)
