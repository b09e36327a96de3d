"""The cases of tests/test_soak.py, run against the port on the CPU:
every name, size and assertion as in the reference, imports from
chubaofs_tpu_torch, every MiniCluster built with device="cpu", and the
shared bit-rot injector from chubaofs_tpu_torch.chaos.inject.

The reference file's docstring:

Randomized fault-injection soak of the blobstore MiniCluster.

The reference proves its failure handling with docker-kill scripts plus
mock-injected error codes (SURVEY §4, §5 "fault injection"); this is the
in-process analog: a seeded random schedule interleaves PUTs/GETs/DELETEs
with disk breaks and on-disk shard corruption while the background planes
(inspector, repair, deleter, balancer, compaction) run between batches.

Invariants checked continuously:
  * every live blob reads back byte-identical (degraded or healed),
  * the clustermgr's per-disk chunk accounting stays conserved,
  * after the final heal, a fresh inspector sweep is quiet and no broken
    disk still backs any volume unit.
"""

import random

import numpy as np
import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN, DISK_NORMAL
from chubaofs_tpu_torch.chaos.inject import corrupt_shard_on_disk

SEED = 1234
ROUNDS = 8
PUTS_PER_ROUND = 3


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def _live_disks(cm):
    return [d for d in cm.disks.values() if d.status == DISK_NORMAL]


@pytest.mark.parametrize("seed", [SEED, SEED + 1])
def test_fault_injection_soak(tmp_path, seed):
    rnd = random.Random(seed)
    rng = np.random.default_rng(seed)
    c = MiniCluster(str(tmp_path / str(seed)), n_nodes=9, disks_per_node=3,
                    device="cpu")
    try:
        live: dict[int, tuple] = {}  # idx -> (loc, bytes)
        next_id = 0
        broken = 0
        injected = {"corrupt": 0, "disk": 0}
        totals = {"repair_msgs": 0, "disk_tasks": 0, "tasks_ran": 0}

        for rnd_no in range(ROUNDS):
            # a few writes of mixed sizes (tiers across codemodes)
            for _ in range(PUTS_PER_ROUND):
                size = rnd.choice([8_000, 120_000, 700_000, 2_000_000])
                data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                loc = c.access.put(data)
                live[next_id] = (loc, data)
                next_id += 1

            # one random fault per round
            fault = rnd.choice(["corrupt", "disk", "delete", "none"])
            if fault == "corrupt" and live:
                loc, _ = live[rnd.choice(list(live))]
                blob = loc.blobs[0]
                vol = c.cm.get_volume(blob.vid)
                unit = rnd.choice(vol.units)
                try:
                    corrupt_shard_on_disk(c.nodes[unit.node_id], unit.vuid,
                                          blob.bid)
                    injected["corrupt"] += 1
                except Exception:
                    pass  # shard may live elsewhere (fine: fault is a no-op)
            elif fault == "disk" and broken < 2:
                # cap concurrent breakage below parity so data stays whole
                victims = _live_disks(c.cm)
                if len(victims) > 20:
                    c.cm.set_disk_status(rnd.choice(victims).disk_id,
                                         DISK_BROKEN)
                    broken += 1
                    injected["disk"] += 1
            elif fault == "delete" and live:
                idx = rnd.choice(list(live))
                loc, _ = live.pop(idx)
                c.access.delete(loc)

            # pump the background planes until they go quiet
            for _ in range(6):
                stats = c.run_background_once()
                for k in totals:
                    totals[k] += stats[k]
                if (stats["repair_msgs"] == 0 and stats["disk_tasks"] == 0
                        and stats["tasks_ran"] == 0):
                    break

            # invariant: every live blob reads back byte-identical
            for idx, (loc, data) in live.items():
                assert c.access.get(loc) == data, (
                    f"round {rnd_no}: blob {idx} corrupted after fault {fault}")

            # invariant: chunk accounting is conserved (registered units ==
            # per-disk chunk_count sums; unit moves must not leak or double)
            per_disk: dict[int, int] = {}
            for vol in c.cm.volumes.values():
                for u in vol.units:
                    per_disk[u.disk_id] = per_disk.get(u.disk_id, 0) + 1
            for disk_id, disk in c.cm.disks.items():
                want = per_disk.get(disk_id, 0)
                assert disk.chunk_count == want, (
                    f"round {rnd_no}: disk {disk_id} counts "
                    f"{disk.chunk_count} != {want}")

        # final heal: drain all planes, then a fresh sweep must be quiet
        for _ in range(10):
            stats = c.run_background_once()
            if (stats["repair_msgs"] == 0 and stats["disk_tasks"] == 0
                    and stats["tasks_ran"] == 0):
                break
        assert c.scheduler.inspect_volumes(max_volumes=1000) == 0
        # no broken disk still backs any unit
        for vol in c.cm.volumes.values():
            for u in vol.units:
                assert c.cm.disks[u.disk_id].status == DISK_NORMAL, (
                    f"unit {u.vuid} still on broken disk {u.disk_id}")
        for idx, (loc, data) in live.items():
            assert c.access.get(loc) == data
        # the soak must have exercised real faults AND real repairs — a
        # silent no-op schedule would rot this test into vacuous green
        assert injected["corrupt"] + injected["disk"] >= 1, injected
        if injected["corrupt"]:
            assert totals["repair_msgs"] >= 1, totals
        if injected["disk"]:
            assert totals["disk_tasks"] >= 1, totals
        assert totals["tasks_ran"] >= 1, totals
    finally:
        c.close()


class _DownNode:
    """A blobnode whose every RPC fails (a fully-dark host)."""

    def __getattr__(self, name):
        def _fail(*a, **k):
            raise RuntimeError("node down")

        return _fail


@pytest.mark.parametrize("seed", [77, 78])
def test_fault_injection_soak_3az_lrc(tmp_path, seed):
    """The multi-AZ/LRC variant: a seeded schedule drops a WHOLE AZ dark for
    a round (PUTs must ride the one-dark-AZ quorum, GETs must reconstruct),
    plus shard corruption and deletes, with the repair planes pumping
    throughout. Every live blob must read byte-identical in every phase —
    degraded included — and the cluster must fully heal once the AZ returns.
    Sizes span all three 3-AZ policy tiers (EC6P6 / EC12P9 / EC6P3L3-LRC)."""
    rnd = random.Random(seed)
    rng = np.random.default_rng(seed)
    # 24 disks over 3 AZs: fits EC12P9's 21-unit spread (7 per AZ)
    c = MiniCluster(str(tmp_path / str(seed)), n_nodes=12, disks_per_node=2,
                    azs=3, device="cpu")
    real_nodes = dict(c.nodes)
    try:
        az_of_node = {}
        for d in c.cm.disks.values():
            az_of_node[d.node_id] = d.az
        live: dict[int, tuple] = {}
        next_id = 0
        dark_az = None

        for rnd_no in range(8):
            for _ in range(3):
                size = rnd.choice([60_000, 500_000, 2_500_000])
                data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
                loc = c.access.put(data)
                live[next_id] = (loc, data)
                next_id += 1

            fault = rnd.choice(["az_down", "corrupt", "delete", "none"])
            if fault == "az_down" and dark_az is None:
                dark_az = rnd.choice([0, 1, 2])
                for nid, az in az_of_node.items():
                    if az == dark_az:
                        c.nodes[nid] = _DownNode()
            elif fault == "corrupt" and live:
                loc, _ = live[rnd.choice(list(live))]
                blob = loc.blobs[0]
                vol = c.cm.get_volume(blob.vid)
                unit = rnd.choice(vol.units)
                if not isinstance(c.nodes[unit.node_id], _DownNode):
                    try:
                        corrupt_shard_on_disk(real_nodes[unit.node_id],
                                              unit.vuid, blob.bid)
                    except Exception:
                        pass
            elif fault == "delete" and live:
                idx = rnd.choice(list(live))
                loc, _ = live.pop(idx)
                c.access.delete(loc)

            # pump bounded (repairs can't finish while an AZ is dark)
            for _ in range(4):
                c.run_background_once()

            # THE invariant: every live blob reads back, degraded or not
            for idx, (loc, data) in live.items():
                assert c.access.get(loc) == data, (
                    f"round {rnd_no}: blob {idx} unreadable "
                    f"(fault={fault}, dark_az={dark_az})")

            # restore the dark AZ after one full round in the dark, then
            # DRAIN the repair planes before any further faults: surviving a
            # second dark AZ is only promised once the first outage healed
            if dark_az is not None and fault != "az_down":
                for nid, az in az_of_node.items():
                    if az == dark_az:
                        c.nodes[nid] = real_nodes[nid]
                dark_az = None
                # recovery confirmed: lift the punish windows so new writes
                # trust the healed AZ again (else a second AZ failure inside
                # punish_secs sees blobs missing two AZs' worth of shards)
                c.access.clear_punishments()
                # healed = a FULL inspector pass over every volume is clean
                # (per-sweep stats can be zero while the inspect cursor is
                # still short of the damaged volumes)
                for _ in range(12):
                    c.run_background_once()
                    if c.scheduler.inspect_volumes(max_volumes=1000) == 0:
                        break

        # final heal: restore everything, drain, and require quiescence
        for nid in az_of_node:
            c.nodes[nid] = real_nodes[nid]
        for _ in range(12):
            c.run_background_once()
            if c.scheduler.inspect_volumes(max_volumes=1000) == 0:
                break
        assert c.scheduler.inspect_volumes(max_volumes=1000) == 0
        for idx, (loc, data) in live.items():
            assert c.access.get(loc) == data
    finally:
        c.nodes.update(real_nodes)  # close() must not hit _DownNode stubs
        c.close()
