"""The cases of tests/test_lrc_cluster.py, run against the port on the CPU:
LRC (EC6P3L3 and friends) on multi-AZ MiniClusters, local repair inside an AZ."""

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.access import (
    QuorumError,
    default_policies,
    select_code_mode,
)
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic


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


class DownNode:
    """A blobnode whose every RPC fails (a fully-dark host)."""

    def __getattr__(self, name):
        def _fail(*a, **k):
            raise RuntimeError("node down")

        return _fail


class RecordingNode:
    """Pass-through blobnode that records which shards were read."""

    def __init__(self, inner):
        self._inner = inner
        self.reads = []

    def get_shard(self, vuid, bid, offset=0, size=None):
        self.reads.append((vuid, bid))
        return self._inner.get_shard(vuid, bid, offset=offset, size=size)

    def __getattr__(self, name):
        return getattr(self._inner, name)


@pytest.fixture
def cluster3az(tmp_path):
    # 3 AZs x 2 nodes x 2 disks: EC6P3L3 places 4 units per AZ on 4 disks
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2, azs=3)
    yield c
    c.close()


def _az_nodes(cluster, az):
    """node_ids whose disks live in the given AZ."""
    return sorted({d.node_id for d in cluster.cm.disks.values() if d.az == az})


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_default_policies_put_lrc_on_live_path():
    """Multi-AZ clusters select LRC modes for archive-sized puts."""
    p3 = default_policies(3)
    assert select_code_mode(2_000_000, p3) == CodeMode.EC6P3L3
    assert get_tactic(select_code_mode(2_000_000, p3)).L > 0
    p2 = default_policies(2)
    assert select_code_mode(2_000_000, p2) == CodeMode.EC16P20L2
    assert select_code_mode(1000, p2) == CodeMode.EC6P10L2
    # single-AZ keeps the plain-RS ladder
    assert select_code_mode(2_000_000, default_policies(1)) == CodeMode.EC12P4


def test_access_selects_lrc_from_cluster_topology(cluster3az, rng):
    """An Access built on a 3-AZ cluster routes large puts through LRC."""
    data = blob_bytes(rng, 2_000_000)
    loc = cluster3az.access.put(data)
    assert loc.code_mode == int(CodeMode.EC6P3L3)
    assert cluster3az.access.get(loc) == data
    # every shard, locals included, landed
    t = get_tactic(loc.code_mode)
    vol = cluster3az.cm.get_volume(loc.blobs[0].vid)
    for unit in vol.units:
        node = cluster3az.nodes[unit.node_id]
        assert node.get_shard(unit.vuid, loc.blobs[0].bid)


def test_dark_az_put_get_heal(cluster3az, rng):
    """PUT with one whole AZ down succeeds; GET reconstructs; repair heals.

    The signature LRC/multi-AZ flow: stream_put.go:405-437 tolerance, then the
    failed shards ride the repair topic back to full redundancy."""
    c = cluster3az
    dark_az = 2
    down = _az_nodes(c, dark_az)
    saved = {n: c.nodes[n] for n in down}
    for n in down:
        c.nodes[n] = DownNode()

    data = blob_bytes(rng, 2_000_000)
    loc = c.access.put(data, code_mode=CodeMode.EC6P3L3)

    # degraded GET with the AZ still dark
    assert c.access.get(loc) == data

    # exactly the dark AZ's shards were queued for repair
    t = get_tactic(CodeMode.EC6P3L3)
    vol = c.cm.get_volume(loc.blobs[0].vid)
    bid = loc.blobs[0].bid
    dark_idx = set(t.shards_in_az(dark_az))
    msgs = c.proxy.topics["shard_repair"].consume("peek", 100)
    assert msgs and set(msgs[0]["bad_idx"]) == dark_idx

    # lights back on: background repair heals every missing shard
    for n, node in saved.items():
        c.nodes[n] = node
    c.run_background_once()
    for idx in sorted(dark_idx):
        unit = vol.units[idx]
        got = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
        assert len(got) == t.shard_size(loc.blobs[0].size)
    # the healed object reads back clean via the fast path
    assert c.access.get(loc) == data


def test_two_dark_azs_fail_put(cluster3az, rng):
    """Two dark AZs break both the quorum and the tolerance rule."""
    c = cluster3az
    saved = dict(c.nodes)
    for az in (1, 2):
        for n in _az_nodes(c, az):
            c.nodes[n] = DownNode()
    try:
        with pytest.raises(QuorumError):
            c.access.put(blob_bytes(rng, 2_000_000), code_mode=CodeMode.EC6P3L3)
    finally:
        c.nodes.update(saved)


def test_local_parity_does_not_satisfy_quorum(tmp_path, rng):
    """Quorum counts global shards only (maxWrittenIndex = N+M): killing all
    but one AZ's globals fails the put even if locals landed."""
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=2, azs=3)
    try:
        t = get_tactic(CodeMode.EC6P3L3)
        # darken two AZs partially: one global shard down in each of az1, az2
        # leaves written globals = 7 < put_quorum 9 and no single-dark-AZ out
        vol = c.cm.alloc_volume(int(CodeMode.EC6P3L3))
        down_nodes = set()
        for az in (1, 2):
            g = [i for i in t.shards_in_az(az) if i < t.global_count][0]
            down_nodes.add(vol.units[g].node_id)
        saved = dict(c.nodes)
        for n in down_nodes:
            c.nodes[n] = DownNode()
        try:
            with pytest.raises(QuorumError):
                c.access.put(blob_bytes(rng, 2_000_000), code_mode=CodeMode.EC6P3L3)
        finally:
            c.nodes.update(saved)
    finally:
        c.close()


def test_local_stripe_repair_reads_same_az_only(cluster3az, rng):
    """Losing one shard inside an AZ repairs from that AZ alone
    (work_shard_recover.go:517)."""
    c = cluster3az
    data = blob_bytes(rng, 2_000_000)
    loc = c.access.put(data, code_mode=CodeMode.EC6P3L3)
    t = get_tactic(CodeMode.EC6P3L3)
    vol = c.cm.get_volume(loc.blobs[0].vid)
    bid = loc.blobs[0].bid

    lost_idx = t.shards_in_az(0)[0]  # a data shard in AZ 0
    unit = vol.units[lost_idx]
    c.nodes[unit.node_id].lose_shard(unit.vuid, bid)
    c.proxy.send_shard_repair(vol.vid, bid, [lost_idx], "test")

    # gate off the volume inspector: it legitimately sweeps every AZ, and this
    # test asserts only on the REPAIR's read set
    from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT

    c.scheduler.switches.set(SWITCH_VOL_INSPECT, False)
    recorders = {n: RecordingNode(node) for n, node in c.nodes.items()}
    c.nodes.clear()
    c.nodes.update(recorders)
    c.run_background_once()

    az0_nodes = set(_az_nodes(c, 0))
    read_nodes = {n for n, r in recorders.items() if r.reads}
    assert read_nodes, "repair must have read something"
    assert read_nodes <= az0_nodes, f"repair read outside AZ 0: {read_nodes}"

    healed = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
    assert np.frombuffer(healed, np.uint8).size == t.shard_size(loc.blobs[0].size)
    assert c.access.get(loc) == data


def test_lost_local_parity_recomputed_in_az(cluster3az, rng):
    """A lost local parity is regenerated from its AZ's global shards."""
    c = cluster3az
    data = blob_bytes(rng, 2_000_000)
    loc = c.access.put(data, code_mode=CodeMode.EC6P3L3)
    t = get_tactic(CodeMode.EC6P3L3)
    vol = c.cm.get_volume(loc.blobs[0].vid)
    bid = loc.blobs[0].bid

    local_idx = t.shards_in_az(1)[-1]  # AZ 1's local parity
    assert local_idx >= t.global_count
    unit = vol.units[local_idx]
    before = c.nodes[unit.node_id].get_shard(unit.vuid, bid)
    c.nodes[unit.node_id].lose_shard(unit.vuid, bid)
    c.proxy.send_shard_repair(vol.vid, bid, [local_idx], "test")

    from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT

    c.scheduler.switches.set(SWITCH_VOL_INSPECT, False)  # see test above
    recorders = {n: RecordingNode(node) for n, node in c.nodes.items()}
    c.nodes.clear()
    c.nodes.update(recorders)
    c.run_background_once()

    az1_nodes = set(_az_nodes(c, 1))
    read_nodes = {n for n, r in recorders.items() if r.reads}
    assert read_nodes <= az1_nodes, f"repair read outside AZ 1: {read_nodes}"
    assert c.nodes[unit.node_id].get_shard(unit.vuid, bid) == before


def test_two_az_lrc_roundtrip(tmp_path, rng):
    """EC6P10L2 (2-AZ LRC) full put/get/degraded-get on a 2-AZ cluster."""
    # EC6P10L2 places 9 units per AZ: 3 nodes x 3 disks each side
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=3, azs=2)
    try:
        data = blob_bytes(rng, 500_000)
        loc = c.access.put(data)
        assert loc.code_mode == int(CodeMode.EC6P10L2)
        assert c.access.get(loc) == data
        # kill two data shards; direct GET degrades but still serves
        vol = c.cm.get_volume(loc.blobs[0].vid)
        for idx in (0, 1):
            u = vol.units[idx]
            c.nodes[u.node_id].lose_shard(u.vuid, loc.blobs[0].bid)
        assert c.access.get(loc) == data
    finally:
        c.close()


# -- one whole AZ dark in EC6P10L2: the survivor gather's replacement reads --


class _GetSpans:
    """The gateway's finished `access.get` spans, through the trace module's
    finish hook (the hook in place before is restored on exit)."""

    def __enter__(self):
        from chubaofs_tpu_torch.blobstore import trace

        self.trace, self.spans = trace, []
        self._prev = trace.finish_hook()
        trace.set_finish_hook(
            lambda s: self.spans.append(s) if s.operation == "access.get" else None)
        return self

    def __exit__(self, *exc):
        self.trace.set_finish_hook(self._prev)
        return False


def _replaced_total() -> float:
    from chubaofs_tpu_torch.utils.exporter import registry

    reg = registry("access")
    return sum(reg.counter("gather_replaced", {"cause": c}).value for c in ("failed", "slow"))


def _traced_get(c, loc, offset=0, size=None):
    """One GET: its bytes, its access.get span, and how far the
    gather_replaced counter grew under it."""
    before = _replaced_total()
    with _GetSpans() as rec:
        data = c.access.get(loc, offset, size)
    assert len(rec.spans) == 1
    return data, rec.spans[0], _replaced_total() - before


def _stages(span, name):
    return [s for s in span.stages if s[0] == name]


def _replacements(t, shard_len, dead: set, offset: int, size: int) -> int:
    """The replacement reads a windowed degraded read of [offset, offset +
    size) of one blob launches, from the layout alone: the direct phase reads
    the range's shards; the live ones that cover the decode's column window
    are reused, the dead ones are decoded; the gather takes the other global
    shards in index order and replaces each dead one it meets until it holds
    N survivors."""
    def window_of(i):
        return (max(offset, i * shard_len) - i * shard_len,
                min(offset + size, (i + 1) * shard_len) - i * shard_len)

    direct = range(offset // shard_len, (offset + size - 1) // shard_len + 1)
    need = [i for i in direct if i in dead]
    col_lo = min(window_of(i)[0] for i in need)
    col_hi = max(window_of(i)[1] for i in need)
    reuse = [i for i in direct if i not in dead
             and window_of(i)[0] <= col_lo and window_of(i)[1] >= col_hi]
    candidates = [i for i in range(t.N + t.M) if i not in need and i not in reuse]
    needed, live, replaced = t.N - len(reuse), 0, 0
    for i in candidates:
        if live == needed:
            break
        if i in dead:
            replaced += 1
        else:
            live += 1
    return replaced


@pytest.fixture
def az0_dark(tmp_path, rng):
    """A 2-AZ cluster in EC6P10L2 holding one single-blob object and one of
    four blobs; `dark()` makes every disk of AZ 0 lose its shards and marks it
    broken, as a whole AZ gone dark with repair pending."""
    from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN

    # 9 units an AZ: 3 nodes x 3 disks each side
    c = MiniCluster(str(tmp_path), device=CPU, n_nodes=6, disks_per_node=3, azs=2)
    t = get_tactic(CodeMode.EC6P10L2)
    c.access.max_blob_size = t.N * 32 << 10  # four blobs at a size the host decodes quickly
    one = blob_bytes(rng, t.N * 24 << 10)
    four = blob_bytes(rng, 3 * c.access.max_blob_size + 40_000)
    objs = {"one": (one, c.access.put(one, code_mode=CodeMode.EC6P10L2)),
            "four": (four, c.access.put(four, code_mode=CodeMode.EC6P10L2))}

    def dark():
        az0 = {d.disk_id for d in c.cm.disks.values() if d.az == 0}
        for vol in c.cm.volumes.values():
            for u in vol.units:
                if u.disk_id in az0:
                    for m in c.nodes[u.node_id].list_shards(u.vuid):
                        c.nodes[u.node_id].lose_shard(u.vuid, m.bid)
        for d in az0:
            c.cm.set_disk_status(d, DISK_BROKEN)
        return az0

    c.dark, c.objs, c.tactic = dark, objs, t
    yield c
    c.close()


def _dead_shards(c, loc, az0) -> set:
    vol = c.cm.get_volume(loc.blobs[0].vid)
    return {u.index for u in vol.units if u.disk_id in az0}


def test_az_dark_whole_get_replaces_per_layout(az0_dark):
    """A whole single-blob GET with AZ 0 dark: data 0-2 decode from the
    other AZ, and the gather meets AZ 0's global parities first, so it
    replaces each of them; one gather.replace stage per count, and the count
    the layout gives (5 for EC6P10L2). The same GET before the loss
    replaces nothing."""
    c, t = az0_dark, az0_dark.tactic
    data, loc = c.objs["one"]
    got, span, grew = _traced_get(c, loc)
    assert got == data and grew == 0 and not _stages(span, "gather.replace")

    dead = _dead_shards(c, loc, c.dark())
    assert dead == set(t.shards_in_az(0))
    shard_len = t.shard_size(loc.blobs[0].size)
    want = _replacements(t, shard_len, dead, 0, loc.blobs[0].size)
    assert want == 5
    got, span, grew = _traced_get(c, loc)
    assert got == data
    assert grew == want == len(_stages(span, "gather.replace"))
    assert _stages(span, "decode")
    for _, off, dur in _stages(span, "gather.replace"):
        assert off >= 0 and dur >= 0


@pytest.mark.parametrize("where", [
    (0.25, 0.5),   # inside data shard 0
    (1.5, 0.25),   # inside data shard 1
    (0.5, 1.0),    # across data shards 0 and 1
    (0.0, 3.0),    # all of data shards 0-2
    (2.75, 0.5),   # across the dark AZ's last data shard and a live one
])
def test_az_dark_ranged_get_replaces_per_layout(az0_dark, where):
    """Ranged GETs over the dark AZ's data shards (in shard lengths from
    the blob's start): byte for byte, and as many gather.replace stages as
    the counter grew, as many as the layout gives."""
    c, t = az0_dark, az0_dark.tactic
    data, loc = c.objs["one"]
    dead = _dead_shards(c, loc, c.dark())
    shard_len = t.shard_size(loc.blobs[0].size)
    offset, size = int(where[0] * shard_len), int(where[1] * shard_len)
    got, span, grew = _traced_get(c, loc, offset, size)
    assert got == data[offset:offset + size]
    want = _replacements(t, shard_len, dead, offset, size)
    assert want > 0
    assert grew == want == len(_stages(span, "gather.replace"))


def test_az_dark_four_blob_get_drops_no_stage(az0_dark):
    """A four-blob object's whole GET with AZ 0 dark, its blobs gathered on
    the readahead pipe: every blob's replacements on the request's span, and
    no stage dropped under the span's cap."""
    from chubaofs_tpu_torch.blobstore import trace

    c, t = az0_dark, az0_dark.tactic
    data, loc = c.objs["four"]
    assert len(loc.blobs) == 4
    az0 = c.dark()
    got, span, grew = _traced_get(c, loc)
    assert got == data
    want = 0
    for blob in loc.blobs:
        dead = {u.index for u in c.cm.get_volume(blob.vid).units if u.disk_id in az0}
        want += _replacements(t, t.shard_size(blob.size), dead, 0, blob.size)
    assert grew == want == len(_stages(span, "gather.replace"))
    assert span.stage_dropped == 0 and len(span.stages) < trace.STAGE_MAX


class _SlowShards:
    """Pass-through blobnode whose reads of some shards (by vuid) answer
    only after a delay: a replica that hangs but is alive."""

    def __init__(self, inner, delays: dict):
        self._inner, self._delays = inner, delays

    def get_shard(self, vuid, bid, offset=0, size=None):
        import time

        time.sleep(self._delays.get(vuid, 0.0))
        return self._inner.get_shard(vuid, bid, offset=offset, size=size)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_hung_reads_are_hedged_and_an_abandoned_hedge_ends_with_the_gather(az0_dark):
    """No AZ dark; a ranged GET inside data shard 1, which hangs, so the
    window decode gathers shards 0, 2-6. Shard 0 hangs past read_deadline:
    its hedge, shard 7, hangs too and is hedged by shard 8, which answers
    and completes the gather while 0 and 7 still hang. Two replacements,
    both `slow`; the abandoned one's stage ends with the gather, long
    before its read would have answered."""
    c, t = az0_dark, az0_dark.tactic
    data, loc = c.objs["one"]
    vol = c.cm.get_volume(loc.blobs[0].vid)
    deadline, hang, hang_long = 0.25, 1.5, 3.0
    delays = {vol.units[0].vuid: hang, vol.units[1].vuid: hang, vol.units[7].vuid: hang_long}
    c.access.read_deadline = deadline
    for n in list(c.nodes):
        c.nodes[n] = _SlowShards(c.nodes[n], delays)
    from chubaofs_tpu_torch.utils.exporter import registry

    reg = registry("access")
    slow0, failed0 = (reg.counter("gather_replaced", {"cause": k}).value for k in ("slow", "failed"))
    shard_len = t.shard_size(loc.blobs[0].size)
    offset, size = shard_len + 100, shard_len // 2
    got, span, grew = _traced_get(c, loc, offset, size)
    assert got == data[offset:offset + size]
    assert grew == 2
    assert reg.counter("gather_replaced", {"cause": "slow"}).value - slow0 == 2
    assert reg.counter("gather_replaced", {"cause": "failed"}).value == failed0
    replaces = sorted(_stages(span, "gather.replace"), key=lambda s: s[1])
    assert len(replaces) == 2
    (gather,) = _stages(span, "gather")
    gather_end = gather[1] + gather[2]
    first_end = replaces[0][1] + replaces[0][2]  # shard 7: abandoned
    assert replaces[0][2] < hang_long - deadline
    assert abs(first_end - gather_end) < 0.05
