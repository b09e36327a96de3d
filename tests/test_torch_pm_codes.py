"""The cases of tests/test_pm_codes.py, run against the port on the CPU.

Product-matrix regenerating codes: kernel math, the encoder dispatch, the
all-CodeModes erasure fuzz, the beta-fetch repair plane end to end through
the scheduler on MiniCluster(device="cpu"), and the cfs-stat / cfs-top
repair-traffic surfaces. The service-level beta-path fuzz is
tests/test_torch_codec.py::test_erasure_fuzz_beta_path_and_multi_loss_fallback."""

import itertools
import os

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.codec import pm
from chubaofs_tpu_torch.codec.codemode import CodeMode, all_modes, get_tactic
from chubaofs_tpu_torch.codec.encoder import (
    EncoderConfig, PmEncoder, RsEncoder, new_encoder)
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


def _counter(name, labels=None):
    return registry("scheduler").counter(name, labels).value


# -- kernel math ---------------------------------------------------------------


def test_pm_kernel_systematic_and_beta_repair_every_node(rng):
    kern = pm.get_kernel(12, 6)
    assert kern.alpha == 5 and kern.d == 10
    data = rng.integers(0, 256, (6, 5 * 41), dtype=np.uint8)
    stripe = kern.encode(data)
    assert np.array_equal(stripe[:6], data)  # systematic
    assert kern.verify(stripe)
    for fail in range(12):
        helpers = [i for i in range(12) if i != fail][:10]
        payloads = np.stack([
            np.frombuffer(kern.helper_payload(fail, stripe[h]), np.uint8)
            for h in helpers])
        # each helper ships exactly beta = shard/alpha bytes
        assert payloads.shape == (10, 41)
        assert np.array_equal(kern.repair(fail, helpers, payloads),
                              stripe[fail])


def test_pm_kernel_repair_any_helper_subset(rng):
    kern = pm.get_kernel(12, 6)
    data = rng.integers(0, 256, (6, 5 * 7), dtype=np.uint8)
    stripe = kern.encode(data)
    fail = 4
    survivors = [i for i in range(12) if i != fail]
    for helpers in itertools.islice(
            itertools.combinations(survivors, 10), 0, None, 3):
        helpers = list(helpers)
        payloads = np.stack([
            np.frombuffer(kern.helper_payload(fail, stripe[h]), np.uint8)
            for h in helpers])
        assert np.array_equal(kern.repair(fail, helpers, payloads),
                              stripe[fail])


def test_pm_kernel_any_k_reconstruct(rng):
    kern = pm.get_kernel(8, 4)  # the small RG4P4 geometry
    data = rng.integers(0, 256, (4, 3 * 11), dtype=np.uint8)
    stripe = kern.encode(data)
    for bad in itertools.combinations(range(8), 4):  # max loss = n-k
        garb = stripe.copy()
        garb[list(bad)] = 0
        assert np.array_equal(kern.reconstruct(garb, list(bad)), stripe), bad


def test_pm_kernel_rejects_bad_geometry():
    with pytest.raises(ValueError):
        pm.PMKernel(10, 2)  # k < 3
    with pytest.raises(ValueError):
        pm.PMKernel(6, 6)  # n <= d
    k = pm.get_kernel(12, 6)
    with pytest.raises(ValueError):
        k.repair_matrix(0, list(range(1, 10)))  # too few helpers
    with pytest.raises(ValueError):
        k.decode_matrix([0, 1, 2], [3])  # not k survivors


# -- encoder dispatch ----------------------------------------------------------


def test_new_encoder_dispatches_pm_and_matches_rs_systematic(rng):
    enc = new_encoder(CodeMode.RG6P6, device=CPU)
    assert isinstance(enc, PmEncoder)
    # same blob, same shard size: data shards bit-identical with plain RS
    data = rng.integers(0, 256, 6 * 6150, dtype=np.uint8).tobytes()
    sh = enc.split(data)
    enc.encode(sh)
    assert enc.verify(sh)
    from chubaofs_tpu_torch.codec.codemode import Tactic

    rs_enc = new_encoder(EncoderConfig(
        code_mode=Tactic(6, 4, 0, 1, put_quorum=9)), device=CPU)
    assert isinstance(rs_enc, RsEncoder)
    rs_sh = rs_enc.split(data)
    for i in range(6):
        assert np.array_equal(sh[i], rs_sh[i]), i


def test_regenerating_shard_size_alpha_aligned():
    t = get_tactic(CodeMode.RG6P6)
    for blob in (1, 100, 12300, 99991, 6 * 6150):
        assert t.shard_size(blob) % t.sub_units == 0
        assert t.shard_size(blob) * t.N >= blob
    assert t.beta_size(t.shard_size(99991)) * t.sub_units == \
        t.shard_size(99991)


def test_helper_set_policy_prefers_local_az_and_caps_at_d():
    t = get_tactic(CodeMode.RG6P6)
    alive = [i for i in range(12) if i != 7]
    h = t.helper_set(7, alive)
    assert len(h) == t.helpers and 7 not in h
    assert t.helper_set(7, alive[:9]) == []  # short of d -> fallback signal
    assert get_tactic(CodeMode.EC12P4).helper_set(0, list(range(1, 16))) == []


# -- the all-modes erasure fuzz ------------------------------------------------


@pytest.mark.parametrize("mode", all_modes(), ids=lambda m: m.name)
def test_erasure_fuzz_roundtrip_all_modes(mode, rng):
    """Random data, random <= M erasures, reconstruct, byte-identical join —
    the MDS contract every registered CodeMode must honor."""
    import io

    t = get_tactic(mode)
    enc = new_encoder(mode, device=CPU)
    for trial in range(3):
        size = int(rng.integers(1, 4 * t.N * max(t.min_shard_size, 64)))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        shards = enc.split(data)
        enc.encode(shards)
        assert enc.verify(shards)
        n_bad = int(rng.integers(1, t.M + 1))
        bad = sorted(rng.choice(t.total, size=n_bad, replace=False).tolist())
        for b in bad:
            shards[b][:] = 0
        enc.reconstruct(shards, bad)
        assert enc.verify(shards), (mode, trial, bad)
        out = io.BytesIO()
        enc.join(out, shards, len(data))
        assert out.getvalue() == data, (mode, trial, bad)


# -- the repair plane end to end -----------------------------------------------


@pytest.fixture
def rg_cluster(tmp_path):
    c = MiniCluster(str(tmp_path), n_nodes=13, disks_per_node=2, device=CPU)
    yield c
    c.close()


def test_beta_fetch_single_loss_repair(rg_cluster, rng):
    """Single lost shard under RG6P6: the scheduler repairs it from d
    combined beta payloads — d * shard/alpha bytes downloaded, not a full
    gather — and records repair_helper_bytes{mode} for attribution."""
    c = rg_cluster
    data = rng.integers(0, 256, 60000, dtype=np.uint8).tobytes()
    loc = c.access.put(data, code_mode=CodeMode.RG6P6)
    blob = loc.blobs[0]
    vol = c.cm.get_volume(blob.vid)
    t = vol.tactic()
    shard_len = t.shard_size(len(data))
    unit = vol.units[3]
    c.nodes[unit.node_id].lose_shard(unit.vuid, blob.bid)

    dl0 = _counter("repair_bytes_downloaded")
    beta0 = _counter("repair_beta_shards")
    helper0 = _counter("repair_helper_bytes", {"mode": "RG6P6"})
    c.proxy.send_shard_repair(vol.vid, blob.bid, [3], "test")
    c.scheduler.poll_repair_topic()
    while c.worker.run_once():
        pass
    want = t.helpers * t.beta_size(shard_len)
    assert _counter("repair_beta_shards") - beta0 == 1
    assert _counter("repair_helper_bytes", {"mode": "RG6P6"}) - helper0 == want
    assert _counter("repair_bytes_downloaded") - dl0 == want
    # the repaired shard serves reads again, bytes intact
    assert c.nodes[unit.node_id].get_shard(unit.vuid, blob.bid) is not None
    assert c.access.get(loc) == data


def test_beta_fetch_multi_loss_falls_back_to_full_gather(rg_cluster, rng):
    """Two losses exceed what beta-fetch can decode: the stripe must heal
    through the generic full gather, counted as a fallback."""
    c = rg_cluster
    data = rng.integers(0, 256, 48000, dtype=np.uint8).tobytes()
    loc = c.access.put(data, code_mode=CodeMode.RG6P6)
    blob = loc.blobs[0]
    vol = c.cm.get_volume(blob.vid)
    for i in (2, 9):
        u = vol.units[i]
        c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
    fb0 = _counter("repair_beta_fallback", {"reason": "multi_loss"})
    beta0 = _counter("repair_beta_shards")
    c.proxy.send_shard_repair(vol.vid, blob.bid, [2, 9], "test")
    c.scheduler.poll_repair_topic()
    while c.worker.run_once():
        pass
    assert _counter("repair_beta_fallback",
                    {"reason": "multi_loss"}) - fb0 == 1
    assert _counter("repair_beta_shards") == beta0  # no beta attempt
    assert _counter("repair_global_shards") >= 2
    assert c.access.get(loc) == data


def test_beta_fetch_helper_failure_falls_back(rg_cluster, rng):
    """One reported loss but a SECOND shard is silently dead: a helper read
    fails, the beta pass aborts, and the full gather (needs only N) still
    heals the stripe byte-identically."""
    c = rg_cluster
    data = rng.integers(0, 256, 48000, dtype=np.uint8).tobytes()
    loc = c.access.put(data, code_mode=CodeMode.RG6P6)
    blob = loc.blobs[0]
    vol = c.cm.get_volume(blob.vid)
    # shard 2 sits inside 5's helper set (index-ordered pick), so its
    # silent death surfaces as a failed combined read mid-beta-pass
    for i in (5, 2):
        u = vol.units[i]
        c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
    fb0 = _counter("repair_beta_fallback", {"reason": "read_fail"})
    c.proxy.send_shard_repair(vol.vid, blob.bid, [5], "test")
    c.scheduler.poll_repair_topic()
    while c.worker.run_once():
        pass
    assert _counter("repair_beta_fallback",
                    {"reason": "read_fail"}) - fb0 == 1
    assert c.access.get(loc) == data


def test_degraded_get_regenerating_mode(rg_cluster, rng):
    """GETs under RG6P6 survive shard loss via the any-N full-stripe
    degraded path (the windowed RS decode doesn't apply to sub-unit
    layouts), both full and ranged."""
    c = rg_cluster
    data = rng.integers(0, 256, 60000, dtype=np.uint8).tobytes()
    loc = c.access.put(data, code_mode=CodeMode.RG6P6)
    blob = loc.blobs[0]
    vol = c.cm.get_volume(blob.vid)
    for i in (0, 4):  # two data shards gone — direct reads must fail over
        u = vol.units[i]
        c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
    assert c.access.get(loc) == data
    assert c.access.get(loc, offset=5, size=40000) == data[5:40005]


def test_hedged_gather_bytes_split_from_required(rg_cluster, rng):
    """The full-stripe repair gather reads N+M shards but decode needs N:
    the extra successes must count as repair_bytes_hedged, keeping
    bytes-per-repaired-shard an honest numerator."""
    c = rg_cluster
    data = rng.integers(0, 256, 40000, dtype=np.uint8).tobytes()
    loc = c.access.put(data, code_mode=CodeMode.EC12P4)
    blob = loc.blobs[0]
    vol = c.cm.get_volume(blob.vid)
    t = vol.tactic()
    shard_len = t.shard_size(len(data))
    u = vol.units[0]
    c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
    dl0 = _counter("repair_bytes_downloaded")
    h0 = _counter("repair_bytes_hedged")
    c.proxy.send_shard_repair(vol.vid, blob.bid, [0], "test")
    c.scheduler.poll_repair_topic()
    while c.worker.run_once():
        pass
    dl = _counter("repair_bytes_downloaded") - dl0
    hedged = _counter("repair_bytes_hedged") - h0
    # 15 survivors answer; N=12 required, the other 3 reads are hedges
    assert dl == t.N * shard_len
    assert hedged == (t.M - 1) * shard_len
    assert c.access.get(loc) == data


# -- observability: cfs-stat --repair rollup + cfs-top REPB/SH column --------


def test_cfsstat_repair_summary():
    from chubaofs_tpu_torch.tools.cfsstat import repair_summary

    before = {"cfs_scheduler_repaired_shards": 0.0,
              "cfs_scheduler_repair_bytes_downloaded": 0.0,
              "cfs_scheduler_repair_bytes_hedged": 0.0,
              "cfs_scheduler_repair_beta_shards": 0.0,
              'cfs_scheduler_repair_helper_bytes{mode="RG6P6"}': 0.0}
    after = {"cfs_scheduler_repaired_shards": 4.0,
             "cfs_scheduler_repair_bytes_downloaded": 81920.0,
             "cfs_scheduler_repair_bytes_hedged": 10240.0,
             "cfs_scheduler_repair_beta_shards": 4.0,
             'cfs_scheduler_repair_helper_bytes{mode="RG6P6"}': 81920.0}
    rep = repair_summary(before, after)
    assert rep["bytes_per_repaired_shard"] == 20480.0
    assert rep["hedged_bytes"] == 10240.0
    assert rep["beta_shards"] == 4.0
    assert rep["helper_bytes"] == {"RG6P6": 81920.0}
    # idle window: None, callers render '-' instead of a fake 0.0
    assert repair_summary(after, after) is None
    # restart clamp: counters went backwards -> post-restart value IS the
    # window delta, never a negative ratio
    restarted = {"cfs_scheduler_repaired_shards": 1.0,
                 "cfs_scheduler_repair_bytes_downloaded": 20480.0}
    rep2 = repair_summary(after, restarted)
    assert rep2["bytes_per_repaired_shard"] == 20480.0
    # bundle-prefixed series ("target:cfs_...") roll up the same way
    pre_b = {f"n1:{k}": v for k, v in before.items()}
    post_b = {f"n1:{k}": v for k, v in after.items()}
    assert repair_summary(pre_b, post_b)["bytes_per_repaired_shard"] \
        == 20480.0


def test_cfstop_repair_bytes_column():
    from chubaofs_tpu_torch.tools.cfstop import COLUMNS, compute_row, render

    assert "REPB/SH" in COLUMNS
    prev = {"cfs_scheduler_repaired_shards": 0.0,
            "cfs_scheduler_repair_bytes_downloaded": 0.0}
    cur = {"cfs_scheduler_repaired_shards": 2.0,
           "cfs_scheduler_repair_bytes_downloaded": 40960.0}
    row = compute_row("t1", prev, cur, 1.0, {"status": "ok"})
    assert row["repair_bps"] == 20480.0
    assert "20480" in render([row])
    # nothing repaired this window -> '-' (None), never 0.0
    row2 = compute_row("t2", {"x": 1.0}, {"x": 2.0}, 1.0, {"status": "ok"})
    assert row2["repair_bps"] is None
