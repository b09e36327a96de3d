"""The cases of tests/test_blobstore_pipeline.py, run against the port on the CPU:
the access gateway's pipelined PUT window and GET readahead."""

import threading
import time

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.access import QuorumError, VolumeFullError
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster


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

BLOB = 64 * 1024  # shrink max_blob_size so multi-blob objects stay small


@pytest.fixture
def cluster(tmp_path):
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=9, disks_per_node=2)
    c.access.max_blob_size = BLOB
    yield c
    c.close()


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_pipelined_put_bid_order_and_roundtrip(cluster, rng):
    data = blob_bytes(rng, 6 * BLOB + 123)  # 7 blobs, ragged tail
    cluster.access.pipeline_window = 3
    loc = cluster.access.put(data)
    bids = [b.bid for b in loc.blobs]
    assert bids == list(range(bids[0], bids[0] + 7)), "bid order broken"
    sizes = [b.size for b in loc.blobs]
    assert sizes == [BLOB] * 6 + [123]
    assert cluster.access.get(loc) == data
    # cross-blob ranged read through the readahead path
    assert cluster.access.get(loc, BLOB - 10, 20) == data[BLOB - 10: BLOB + 10]
    # the pipeline actually ran: occupancy histogram saw multi-stripe flight
    from chubaofs_tpu_torch.utils.exporter import registry

    occ = registry("access").summary("put_pipeline_occupancy").snapshot()
    assert occ["count"] > 0 and occ["max"] >= 2


def test_bid_order_survives_out_of_order_encode(cluster, rng):
    """Blob 0's codec future resolves LAST; loc.blobs must still come back
    in ascending-bid = data order and the bytes must round-trip."""
    real = cluster.access.codec

    class _LaggardFut:
        def __init__(self, fut, delay):
            self._fut, self._delay = fut, delay

        def result(self, timeout=None):
            time.sleep(self._delay)
            return self._fut.result(timeout)

    class _ShuffleCodec:
        """First encode of every put resolves after all later ones."""

        def __init__(self):
            self.calls = 0

        def encode_tactic(self, t, mat):
            self.calls += 1
            delay = 0.3 if self.calls == 1 else 0.0
            return _LaggardFut(real.encode_tactic(t, mat), delay)

        def __getattr__(self, name):  # reconstruct etc. pass through
            return getattr(real, name)

    cluster.access.codec = _ShuffleCodec()
    try:
        data = blob_bytes(rng, 5 * BLOB)
        cluster.access.pipeline_window = 3
        loc = cluster.access.put(data)
    finally:
        cluster.access.codec = real
    bids = [b.bid for b in loc.blobs]
    assert bids == sorted(bids) and len(set(bids)) == 5
    assert cluster.access.get(loc) == data


def test_mid_window_quorum_failure_aborts_cleanly(cluster, rng):
    """Blob 2 of 8 fails its quorum: the put raises, stages beyond the
    window never start (no orphaned shard writes for late bids), and no
    repair messages are queued for blobs the client will never see."""
    access = cluster.access
    access.pipeline_window = 2
    # deterministic failure by CONTENT: blob k's first byte is k
    data = bytearray(rng.integers(0, 256, 8 * BLOB, dtype=np.uint8).tobytes())
    for k in range(8):
        data[k * BLOB] = k
    fail_at = 2

    real_write = access._write_stripe

    def failing_write(t, vol, bid, stripe):
        if int(stripe[0][0]) == fail_at:
            raise QuorumError("injected mid-window quorum failure")
        return real_write(t, vol, bid, stripe)

    access._write_stripe = failing_write
    # record every shard write's bid, cluster-wide
    written_bids: set[int] = set()
    rec_lock = threading.Lock()
    for node in cluster.nodes.values():
        def wrap(real_put):
            def put_shard(vuid, bid, payload):
                with rec_lock:
                    written_bids.add(bid)
                return real_put(vuid, bid, payload)
            return put_shard
        node.put_shard = wrap(node.put_shard)
    first_bid = cluster.cm.alloc_scope("bid", 0)[0]  # peek next bid

    try:
        with pytest.raises(QuorumError):
            access.put(bytes(data))
    finally:
        access._write_stripe = real_write
    # nothing past the in-flight window ever touched a blobnode: with
    # window=2 and blob 2 failing, blobs 0..3 may have written, 4..7 must not
    late = {b for b in written_bids if b - first_bid >= fail_at + 2}
    assert not late, f"orphaned writes for aborted blobs: {sorted(late)}"
    # no repair-queue spam (successful stripes wrote all shards; the failed
    # one aborted before any write): nothing for the repair plane, and
    # certainly no duplicates
    assert cluster.proxy.topics["shard_repair"].lag("scheduler") == 0


def test_caller_side_alloc_failure_aborts_window(cluster, rng):
    """A failure on the SUBMITTING thread (volume alloc raising mid-window)
    must honor the same abort contract as a stage failure: the put raises,
    in-flight stages drain, and nothing is queued for repair."""
    access = cluster.access
    access.pipeline_window = 2
    real_alloc = cluster.proxy.alloc_volume
    calls = {"n": 0}

    def failing_alloc(mode):
        calls["n"] += 1
        if calls["n"] >= 3:
            raise ConnectionError("allocator down")
        return real_alloc(mode)

    cluster.proxy.alloc_volume = failing_alloc
    try:
        with pytest.raises(Exception) as ei:
            access.put(blob_bytes(rng, 6 * BLOB))
    finally:
        cluster.proxy.alloc_volume = real_alloc
    assert "allocator down" in str(ei.value) or "breaker" in str(ei.value)
    assert cluster.proxy.topics["shard_repair"].lag("scheduler") == 0


def test_get_readahead_matches_serial(cluster, rng):
    data = blob_bytes(rng, 5 * BLOB + 7)
    cluster.access.pipeline_window = 3
    loc = cluster.access.put(data)
    from chubaofs_tpu_torch.utils.exporter import registry

    pre = registry("access").counter("get_readahead_prefetch").value
    want = data[BLOB // 2: 4 * BLOB + 99]
    got_ra = cluster.access.get(loc, BLOB // 2, len(want))
    assert got_ra == want
    assert registry("access").counter("get_readahead_prefetch").value > pre
    cluster.access.pipeline_window = 0  # serial control
    assert cluster.access.get(loc, BLOB // 2, len(want)) == want


def test_proxy_rotates_active_volume_grants(cluster, rng):
    """The proxy grants a rotating SET of active volumes (reference
    allocator's multi-volume grant), so a windowed PUT's consecutive blobs
    spread across chunks/disks instead of serializing on one chunk lock."""
    from chubaofs_tpu_torch.codec.codemode import CodeMode

    mode = int(CodeMode.EC6P3)
    vids = {cluster.proxy.alloc_volume(mode).vid for _ in range(6)}
    assert len(vids) == cluster.proxy.active_vols == 2
    # a multi-blob put rides the rotation end to end
    data = blob_bytes(rng, 4 * BLOB)
    cluster.access.pipeline_window = 3
    loc = cluster.access.put(data)
    assert len({b.vid for b in loc.blobs}) == 2
    assert cluster.access.get(loc) == data
    # invalidate drops the whole grant set (volume-full rotation path)
    cluster.proxy.invalidate(mode)
    assert cluster.proxy.alloc_volume(mode).status == "active"


def test_volume_full_rotation_survives_lockstep_grants(cluster, rng):
    """The rotating grant set fills in lockstep: when volume A reports full,
    the re-alloc may hand back its equally-full sibling B. The bounded
    rotation in _write_blob must retire BOTH and land on a fresh volume
    instead of surfacing VolumeFullError to the client."""
    access = cluster.access
    real = access._write_stripe
    full_vids: set[int] = set()

    def write(t, vol, bid, stripe):
        # the first two distinct volumes seen behave full (lockstep case)
        if len(full_vids) < 2 and vol.vid not in full_vids:
            full_vids.add(vol.vid)
        if vol.vid in full_vids:
            raise VolumeFullError(f"vol {vol.vid} full")
        return real(t, vol, bid, stripe)

    access._write_stripe = write
    try:
        data = blob_bytes(rng, 1000)
        loc = access.put(data)
    finally:
        access._write_stripe = real
    assert loc.blobs[0].vid not in full_vids
    assert access.get(loc) == data


def test_lrc_encode_cancel_chains_and_service_survives():
    """Pipeline aborts cancel encode-ahead futures; for LRC modes those are
    wrapper futures — cancel must chain to the queued codec job and must
    never blow up the drain loop's result delivery."""
    from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic
    from chubaofs_tpu_torch.codec.service import CodecService

    svc = CodecService(device=CPU)
    try:
        t = get_tactic(int(CodeMode.EC6P3L3))
        mat = np.zeros((t.N, 64), np.uint8)
        futs = [svc.encode_tactic(t, mat) for _ in range(8)]
        for f in futs[4:]:
            f.cancel()
        for f in futs[:4]:
            assert f.result(timeout=30).shape[0] == t.total
        # the service is alive and correct after the cancellations
        assert svc.encode_tactic(t, mat).result(timeout=30).shape[0] == t.total
    finally:
        svc.close()


def test_window_zero_is_serial_and_equivalent(cluster, rng):
    data = blob_bytes(rng, 3 * BLOB)
    cluster.access.pipeline_window = 0
    loc0 = cluster.access.put(data)
    cluster.access.pipeline_window = 4
    loc1 = cluster.access.put(data)
    assert cluster.access.get(loc0) == cluster.access.get(loc1) == data
    assert len(loc0.blobs) == len(loc1.blobs) == 3
