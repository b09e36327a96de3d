"""The cases of tests/test_cache_plane.py, run against the port on the CPU.

Tiered read-cache plane: BlobCache keying + invalidation, access-layer
integration, Replica3 hot-tier promotion/demotion, the SLO and cfs-top
surfaces, the zipfian bench floor (the port's tools/perfbench.py) and the
cache soak smoke, on MiniCluster(device="cpu")."""

import os
import zlib

import pytest
import torch

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore.cache import BlobCache
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
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
    chaos.reset()


@pytest.fixture()
def cluster(tmp_path):
    cache = BlobCache(str(tmp_path / "cache"), mem_mb=8, disk_mb=32,
                      promote_hits=3)
    c = MiniCluster(str(tmp_path / "mc"), n_nodes=6, cache=cache, device=CPU)
    yield c, cache
    c.close()


# -- BlobCache unit behavior ---------------------------------------------------


def test_blobcache_versioned_keying(tmp_path):
    cache = BlobCache(str(tmp_path), mem_mb=4, promote_hits=0)
    ver = cache.fill_version(1, 7)
    assert cache.fill(1, 7, ver, b"payload")
    assert cache.get(1, 7) == b"payload"
    assert cache.get(1, 7, 2, 3) == b"ylo"
    cache.invalidate(1, 7)
    assert cache.get(1, 7) is None  # punched out AND re-versioned
    # a fill that captured the PRE-invalidation version must be dropped:
    # its backend read may predate the delete it raced
    assert not cache.fill(1, 7, ver, b"stale bytes")
    assert cache.get(1, 7) is None
    ver2 = cache.fill_version(1, 7)
    assert ver2 != ver
    assert cache.fill(1, 7, ver2, b"fresh")
    assert cache.get(1, 7) == b"fresh"


def test_blobcache_promote_signal_rate(tmp_path):
    """One signal per promote_hits accesses: the counter resets on signal,
    so a SUSTAINED-hot blob keeps signalling (what keeps the idle-sweep
    demoter honest) while the message rate stays bounded."""
    cache = BlobCache(str(tmp_path), mem_mb=4, promote_hits=4)
    for _ in range(3):
        cache.get(3, 9)
        assert not cache.promote_signal(3, 9)
    cache.get(3, 9)
    assert cache.promote_signal(3, 9)  # threshold crossed
    cache.get(3, 9)
    assert not cache.promote_signal(3, 9)  # heat restarted from zero
    for _ in range(3):
        cache.get(3, 9)
    assert cache.promote_signal(3, 9)  # still hot: signals again
    # invalidation resets heat
    cache.invalidate(3, 9)
    assert not cache.promote_signal(3, 9)


def test_blobcache_from_env_gating(tmp_path, monkeypatch):
    monkeypatch.delenv("CFS_CACHE_MB", raising=False)
    assert BlobCache.from_env(str(tmp_path / "a")) is None
    monkeypatch.setenv("CFS_CACHE_MB", "0")
    assert BlobCache.from_env(str(tmp_path / "b")) is None
    monkeypatch.setenv("CFS_CACHE_MB", "8")
    cache = BlobCache.from_env(str(tmp_path / "c"))
    assert cache is not None
    assert cache.mgr.mem_capacity == 8 << 20
    assert cache.mgr.capacity == 32 << 20  # disk defaults to 4x memory


# -- access integration --------------------------------------------------------


def test_cache_hit_serves_with_backend_dark(cluster):
    """A warm GET must not touch a blobnode at all: with every shard read
    erroring, the cached copy still serves byte-identical."""
    c, _ = cluster
    data = os.urandom(200_000)
    loc = c.access.put(data)
    assert c.access.get(loc) == data  # miss -> EC read -> fill
    chaos.arm("blobnode.get_shard", "error(dark)")
    try:
        assert c.access.get(loc) == data
    finally:
        chaos.disarm("blobnode.get_shard")


def test_ranged_get_served_from_cached_blob(cluster):
    c, cache = cluster
    data = os.urandom(150_000)
    loc = c.access.put(data)
    assert c.access.get(loc) == data  # whole-blob fill
    h0 = registry("cache").counter("hits").value
    assert c.access.get(loc, 1234, 4321) == data[1234:1234 + 4321]
    assert registry("cache").counter("hits").value == h0 + 1


def test_read_after_delete_never_serves_cache(cluster):
    """DELETE punch-out is write-through (and failpoint-delayed
    here) — once delete() returns, the cached copy is unreachable, and once
    the deleter punches shards the GET errors instead of serving stale."""
    from chubaofs_tpu_torch.blobstore.access import AccessError

    c, _ = cluster
    data = os.urandom(120_000)
    loc = c.access.put(data)
    assert c.access.get(loc) == data  # cached
    chaos.arm("cache.invalidate", "delay(0.05)")
    try:
        c.access.delete(loc)
    finally:
        chaos.disarm("cache.invalidate")
    c.run_background_once()  # deleter punches the EC shards
    with pytest.raises(AccessError):
        c.access.get(loc)


def test_read_after_overwrite_serves_new_bytes(cluster):
    """An overwrite (new location + delete of the old) must serve the NEW
    bytes from the very first read — fresh bids can never alias a cached
    entry, even with invalidation failpoint-delayed."""
    c, _ = cluster
    old = os.urandom(100_000)
    new = os.urandom(100_000)
    old_loc = c.access.put(old)
    assert c.access.get(old_loc) == old  # old bytes cached
    chaos.arm("cache.invalidate", "delay(0.05)")
    try:
        new_loc = c.access.put(new)
        c.access.delete(old_loc)
    finally:
        chaos.disarm("cache.invalidate")
    got = c.access.get(new_loc)
    assert got == new and zlib.crc32(got) == zlib.crc32(new)


# -- tier migration (Replica3 hot engine) --------------------------------------


def test_hot_promotion_and_replica_read(cluster):
    c, cache = cluster
    data = os.urandom(180_000)
    loc = c.access.put(data)
    for _ in range(4):  # cross promote_hits=3
        assert c.access.get(loc) == data
    out = c.run_background_once()
    assert out["tier_msgs"] >= 1
    blob = loc.blobs[0]
    hot = c.cm.hot_location(blob.vid, blob.bid)
    assert hot is not None
    hot_vid, hot_bid = hot
    from chubaofs_tpu_torch.codec.codemode import CodeMode

    hot_vol = c.cm.get_volume(hot_vid)
    assert hot_vol.code_mode == int(CodeMode.Replica3)
    # replica shard 0 IS the blob bytes (systematic RS(1,2), exact size)
    unit = hot_vol.units[0]
    assert c.nodes[unit.node_id].get_shard(unit.vuid, hot_bid) == data
    # force the read THROUGH the hot tier: punch the cache copy, then read
    cache.invalidate(blob.vid, blob.bid)
    t0 = registry("cache").counter("tier_hits").value
    assert c.access.get(loc) == data
    assert registry("cache").counter("tier_hits").value == t0 + 1


def test_hot_read_falls_back_to_ec_when_replica_dark(cluster):
    c, cache = cluster
    data = os.urandom(90_000)
    loc = c.access.put(data)
    for _ in range(4):
        c.access.get(loc)
    c.run_background_once()
    blob = loc.blobs[0]
    hot = c.cm.hot_location(blob.vid, blob.bid)
    assert hot is not None
    # kill the replica copy's shards; the EC cold copy stays authoritative
    hot_vol = c.cm.get_volume(hot[0])
    for unit in hot_vol.units:
        c.nodes[unit.node_id].delete_shard(unit.vuid, hot[1])
    cache.invalidate(blob.vid, blob.bid)
    f0 = registry("cache").counter("tier_fallbacks").value
    assert c.access.get(loc) == data
    assert registry("cache").counter("tier_fallbacks").value == f0 + 1


def test_demotion_after_idle_sweeps(cluster):
    c, cache = cluster
    c.scheduler.demote_sweeps = 2
    data = os.urandom(60_000)
    loc = c.access.put(data)
    for _ in range(4):
        c.access.get(loc)
    c.run_background_once()
    blob = loc.blobs[0]
    assert c.cm.hot_location(blob.vid, blob.bid) is not None
    d0 = registry("cache").counter("demotes").value
    c.run_background_once()  # idle sweep 1
    c.run_background_once()  # idle sweep 2 -> demote task + execution
    assert c.cm.hot_location(blob.vid, blob.bid) is None
    assert registry("cache").counter("demotes").value == d0 + 1
    # the replica shards were freed and reads ride EC again, byte-identical
    cache.invalidate(blob.vid, blob.bid)
    assert c.access.get(loc) == data


def test_sustained_hot_blob_is_not_demoted(cluster):
    """Review regression: a promoted blob that KEEPS being read must keep
    its hot residency — continued traffic re-signals every promote_hits
    accesses, resetting the demoter's idle clock each sweep."""
    c, _ = cluster
    c.scheduler.demote_sweeps = 2
    data = os.urandom(40_000)
    loc = c.access.put(data)
    for _ in range(4):
        c.access.get(loc)
    c.run_background_once()
    blob = loc.blobs[0]
    assert c.cm.hot_location(blob.vid, blob.bid) is not None
    for _ in range(4):  # traffic continues across 4 demote-window sweeps
        for _ in range(4):  # >= promote_hits accesses per sweep
            c.access.get(loc)
        c.run_background_once()
        assert c.cm.hot_location(blob.vid, blob.bid) is not None


def test_tier_map_survives_clustermgr_restart(tmp_path):
    cache = BlobCache(str(tmp_path / "cache"), mem_mb=8, promote_hits=2)
    root = str(tmp_path / "mc")
    c = MiniCluster(root, n_nodes=6, cache=cache, device=CPU)
    data = os.urandom(70_000)
    loc = c.access.put(data)
    for _ in range(3):
        c.access.get(loc)
    c.run_background_once()
    blob = loc.blobs[0]
    hot = c.cm.hot_location(blob.vid, blob.bid)
    assert hot is not None
    c.close()
    c2 = MiniCluster(root, n_nodes=6,
                     cache=BlobCache(str(tmp_path / "cache2"), mem_mb=8), device=CPU)
    try:
        assert c2.cm.hot_location(blob.vid, blob.bid) == hot
        assert c2.access.get(loc) == data
    finally:
        c2.close()


def test_deleter_drops_hot_copy(cluster):
    c, _ = cluster
    data = os.urandom(50_000)
    loc = c.access.put(data)
    for _ in range(4):
        c.access.get(loc)
    c.run_background_once()
    blob = loc.blobs[0]
    assert c.cm.hot_location(blob.vid, blob.bid) is not None
    c.access.delete(loc)
    c.run_background_once()
    assert c.cm.hot_location(blob.vid, blob.bid) is None


# -- observability surfaces ----------------------------------------------------


def test_slo_cache_miss_ratio_kind():
    from chubaofs_tpu_torch.utils.slo import SLO, _eval_window

    slo = SLO("cache_miss_ratio", "counter_ratio", "cfs_cache_misses", 0.5,
              ops_family="cfs_cache_lookups")
    snap = lambda mono, miss, lk: {  # noqa: E731
        "mono": mono,
        "metrics": {"cfs_cache_misses": miss, "cfs_cache_lookups": lk}}
    # one snapshot = lifetime totals, not a burn window
    assert _eval_window(slo, [snap(0, 10, 10)]) is None
    # 30 misses over 100 lookups in the window
    win = [snap(0, 10, 100), snap(10, 40, 200)]
    assert _eval_window(slo, win) == pytest.approx(0.3)
    # quiet window (no lookups) is healthy, not unknown-unhealthy
    assert _eval_window(slo, [snap(0, 10, 100), snap(10, 10, 100)]) is None
    # restart contract: totals went down -> post-restart totals ARE the delta
    assert _eval_window(slo, [snap(0, 50, 100), snap(10, 9, 10)]) \
        == pytest.approx(0.9)


def test_slo_default_set_includes_cache_ratio():
    from chubaofs_tpu_torch.utils.slo import default_slos

    names = [s.name for s in default_slos()]
    assert "cache_miss_ratio" in names


def test_cfstop_cache_column_math():
    from chubaofs_tpu_torch.tools.cfstop import COLUMNS, compute_row, render

    prev = {"cfs_cache_lookups": 100.0, "cfs_cache_hits": 60.0}
    cur = {"cfs_cache_lookups": 200.0, "cfs_cache_hits": 140.0}
    row = compute_row("t1", prev, cur, 1.0, {"status": "ok"})
    assert row["cache_pct"] == pytest.approx(80.0)
    assert "CACHE%" in COLUMNS
    assert "80" in render([row])
    # a target with no cache renders '-' (None), never a fake zero
    row2 = compute_row("t2", {"x": 1.0}, {"x": 2.0}, 1.0, {"status": "ok"})
    assert row2["cache_pct"] is None


def test_cache_metrics_families_render(cluster):
    c, _ = cluster
    data = os.urandom(40_000)
    loc = c.access.put(data)
    c.access.get(loc)
    c.access.get(loc)
    from chubaofs_tpu_torch.utils import exporter

    text = exporter.render_all()
    for fam in ("cfs_cache_lookups", "cfs_cache_hits", "cfs_cache_misses",
                "cfs_bcache_fills"):
        assert fam in text, fam


# -- bench + soak smokes (tier-1 floors) ---------------------------------------


def test_bench_cache_zipf_smoke_floor(tmp_path):
    """Tier-1 cache gate: the zipfian A/B at smoke size must realize a
    NONZERO hit ratio on the warm pass and beat the EC arm's p99 (crc-
    verified internally). The full-size acceptance numbers live in PERF.md —
    CI co-tenant noise keeps hard latency floors out of tier-1."""
    from chubaofs_tpu_torch.tools.perfbench import bench_cache_zipf

    out = bench_cache_zipf(str(tmp_path), objects=10, obj_kb=32, gets=50,
                           wire_ms=1.0, device=CPU)
    assert out["cache_zipf_hit_ratio"] > 0.3, out
    assert out["cache_zipf_p99_ms_cached"] < out["cache_zipf_p99_ms_ec"], out
    assert out["cache_zipf_speedup_p99"] > 1.0, out


def test_cache_soak_smoke(tmp_path):
    """The chaos cache soak (delayed invalidation + overwrites +
    deletes + tier migration) at smoke size."""
    from chubaofs_tpu_torch.chaos.soak import run_cache_soak

    res = run_cache_soak(str(tmp_path), seed=7, rounds=2, objects=6,
                         obj_kb=16, gets_per_round=12,
                         invalidate_delay=0.02, promote_hits=3, device=CPU)
    assert res["ok"]
    assert res["gets"] > 0 and res["overwrites"] > 0 and res["deletes"] > 0
