"""Seeded chaos scheduler — fault plans on a virtual timeline.

Drives injections against a live MiniCluster deterministically: given the
same (seed, plan) the scheduler makes identical target choices and emits an
identical event log, run over run — the log never contains wall-clock
times, realized volume/bid ids, process pids or anything else the thread
scheduler could perturb; only virtual time plus the RNG-chosen coordinates.

Fault kinds (all lift automatically after `duration` virtual steps):

  node_wedge     shard IO to the node hangs silently (no error, no RST) —
                 the degraded-GET / punish-window paths must carry the load
  slow_disk      every shard IO on the node pays a delay
  link_drop      shard IO to the node fails fast with probability `arg`
                 (flapping link); also arms raft.send drops for daemons
  shard_bitrot   one byte of one live shard flips on disk (instantaneous;
                 nothing to lift — the scrub/repair plane must heal it)
  crash_restart  the node's in-process engine is closed and rebuilt from
                 its disks at lift time (process crash + restart)
  node_kill      the node's engine is closed and REMOVED from the routing
                 dict, permanently (a dead host). Nothing lifts: its
                 heartbeats stop, the clustermgr expiry must mark its disks
                 broken, and the repair plane must rebuild every affected
                 stripe onto the survivors

node_wedge/slow_disk/link_drop arm the ACCESS-layer call sites
(`access.read_shard` / `access.write_shard`), not the blobnode ones: the
MiniCluster's repair planes call blobnode engines in-process on the soak
thread, and a blobnode-level hang would wedge the very loop that has to
lift the fault. Daemon-cluster chaos wedges the blobnode sites directly
via CFS_FAILPOINTS instead.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from chubaofs_tpu_torch.chaos import failpoints as fp


@dataclass
class Fault:
    kind: str
    at: int                  # virtual step of injection
    duration: int = 1        # steps until lifted (ignored by shard_bitrot)
    target: int | None = None  # node id; None = scheduler picks (seeded)
    arg: float | None = None   # kind-specific knob (delay s / drop prob)


@dataclass
class FaultPlan:
    name: str
    faults: list[Fault] = field(default_factory=list)
    steps: int = 6


def builtin_plan(name: str, steps: int = 6) -> FaultPlan:
    """The named plans the soak acceptance runs: one mid-run fault window
    per plan, lifted with steps to spare so convergence is observable."""
    mid, dur = 1, max(2, steps // 2)
    plans = {
        "node_wedge": [Fault("node_wedge", at=mid, duration=dur)],
        "slow_disk": [Fault("slow_disk", at=mid, duration=dur, arg=0.15)],
        "link_drop": [Fault("link_drop", at=mid, duration=dur, arg=0.7)],
        "shard_bitrot": [Fault("shard_bitrot", at=mid),
                         Fault("shard_bitrot", at=mid + 1),
                         Fault("shard_bitrot", at=mid + 2)],
        "crash_restart": [Fault("crash_restart", at=mid, duration=dur)],
        "node_kill": [Fault("node_kill", at=mid)],
    }
    if name not in plans:
        raise ValueError(f"unknown plan {name!r}; have {sorted(plans)}")
    return FaultPlan(name=name, faults=plans[name], steps=steps)


class ChaosScheduler:
    """Applies one FaultPlan to a MiniCluster as virtual time advances.

    The soak harness calls `step()` once per round; faults whose `at`
    equals the current step inject, faults whose window expired lift.
    `events` is the reproducible log. `blobs` maps blob index ->
    (Location, payload) and feeds shard_bitrot target choice — the
    CHOICE is logged as (blob index, unit index), never the realized
    vid/vuid, which thread timing could perturb."""

    def __init__(self, cluster, plan: FaultPlan, seed: int):
        self.cluster = cluster
        self.plan = plan
        self.rng = random.Random(seed)
        self.vtime = 0
        self.events: list[dict] = []
        self.blobs: dict[int, tuple] = {}  # soak harness registers live blobs
        self._active: list[tuple[Fault, int, int]] = []  # (fault, node, lift_at)
        self._crashed: dict[int, list[str]] = {}  # node -> disk roots

    # -- timeline -------------------------------------------------------------

    def step(self) -> list[dict]:
        """Advance one virtual step: lift expired faults, inject due ones.
        Returns the events this step appended."""
        before = len(self.events)
        for fault, node, lift_at in list(self._active):
            if self.vtime >= lift_at:
                self._lift(fault, node)
                self._active.remove((fault, node, lift_at))
        for fault in self.plan.faults:
            if fault.at == self.vtime:
                self._inject(fault)
        self.vtime += 1
        return self.events[before:]

    def close(self) -> None:
        """Lift everything still active (test teardown / end of soak)."""
        for fault, node, _ in self._active:
            self._lift(fault, node)
        self._active.clear()

    def quiesced(self) -> bool:
        return not self._active

    def _log(self, event: str, fault: Fault, **details) -> None:
        self.events.append({"t": self.vtime, "event": event,
                            "fault": fault.kind, **details})
        # mirror the plan step onto the cluster event timeline so the
        # injected fault sorts against its detections/reactions in
        # `cfs-events` output. The SEEDED log above stays the determinism
        # contract; the journal record adds wall/mono stamps for the merge.
        # A 'skip' step injected NOTHING — it stays in the seeded log only,
        # never as a chaos_inject record a timeline consumer could anchor on.
        if event not in ("inject", "lift"):
            return
        from chubaofs_tpu_torch.utils import events as ev

        ev.emit("chaos_lift" if event == "lift" else "chaos_inject",
                ev.SEV_INFO if event == "lift" else ev.SEV_WARNING,
                entity=fault.kind,
                detail={"step": event, "t": self.vtime,
                        "plan": self.plan.name, **details})

    def _pick_node(self, fault: Fault) -> int:
        if fault.target is not None:
            return fault.target
        return self.rng.choice(sorted(self.cluster.nodes))

    # -- inject / lift --------------------------------------------------------

    def _inject(self, fault: Fault) -> None:
        kind = fault.kind
        if kind == "shard_bitrot":
            self._inject_bitrot(fault)
            return
        node = self._pick_node(fault)
        if kind == "node_wedge":
            # bounded hang as a backstop; the lift path releases much sooner
            fp.arm("access.read_shard", "hang(45)", node=node)
            fp.arm("access.write_shard", "hang(45)", node=node)
        elif kind == "slow_disk":
            d = fault.arg if fault.arg is not None else 0.15
            fp.arm("access.read_shard", f"delay({d})", node=node)
            fp.arm("access.write_shard", f"delay({d})", node=node)
        elif kind == "link_drop":
            p = fault.arg if fault.arg is not None else 0.7
            fp.arm("access.read_shard", "error(link down)", node=node, prob=p)
            fp.arm("access.write_shard", "error(link down)", node=node, prob=p)
            fp.arm("raft.send", "drop", node=node, prob=p)
        elif kind == "crash_restart":
            self._crash(node)
        elif kind == "node_kill":
            self._kill(node)
            self._log("inject", fault, node=node)
            return  # permanent: nothing to lift, never enters _active
        else:
            raise ValueError(f"unknown fault kind {kind!r}")
        self._log("inject", fault, node=node)
        self._active.append((fault, node, self.vtime + max(1, fault.duration)))

    def _lift(self, fault: Fault, node: int) -> None:
        if fault.kind in ("node_wedge", "slow_disk", "link_drop"):
            fp.disarm("access.read_shard", node=node)
            fp.disarm("access.write_shard", node=node)
            if fault.kind == "link_drop":
                fp.disarm("raft.send", node=node)
        elif fault.kind == "crash_restart":
            self._restart(node)
        # a lifted fault is a CONFIRMED recovery: drop the punish windows so
        # writes trust the healed node again (clear_punishments contract)
        try:
            self.cluster.access.clear_punishments()
        except Exception:
            pass
        self._log("lift", fault, node=node)

    def _inject_bitrot(self, fault: Fault) -> None:
        from chubaofs_tpu_torch.chaos.inject import corrupt_shard_on_disk

        if not self.blobs:
            self._log("skip", fault, reason="no live blobs")
            return
        blob_idx = self.rng.choice(sorted(self.blobs))
        loc, _ = self.blobs[blob_idx]
        blob = loc.blobs[0]
        vol = self.cluster.cm.get_volume(blob.vid)
        unit_idx = self.rng.randrange(len(vol.units))
        unit = vol.units[unit_idx]
        try:
            corrupt_shard_on_disk(self.cluster.nodes[unit.node_id],
                                  unit.vuid, blob.bid)
            outcome = "flipped"
        except Exception:
            # the shard may not be materialized on that unit (failed write,
            # mid-migration): the plan's CHOICE is still logged identically
            outcome = "absent"
        self._log("inject", fault, blob=blob_idx, unit=unit_idx,
                  outcome=outcome)

    def _crash(self, node: int) -> None:
        eng = self.cluster.nodes[node]
        roots = [d.root for d in eng.disks.values()]
        self._crashed[node] = roots
        try:
            eng.close()
        except Exception:
            pass
        # a crashed process answers nothing: error (not hang) like a RST
        fp.arm("access.read_shard", "error(crashed)", node=node)
        fp.arm("access.write_shard", "error(crashed)", node=node)

    def _kill(self, node: int) -> None:
        """Permanent kill: close the engine and REMOVE it from the routing
        dict. No failpoints needed — reads see an unknown node, writes fail
        and punish, and the stopped heartbeats are exactly the detection
        signal the repair plane has to catch."""
        eng = self.cluster.nodes.pop(node, None)
        if eng is not None:
            try:
                eng.close()
            except Exception:
                pass

    def _restart(self, node: int) -> None:
        from chubaofs_tpu_torch.blobstore.blobnode import BlobNode

        roots = self._crashed.pop(node, None)
        fp.disarm("access.read_shard", node=node)
        fp.disarm("access.write_shard", node=node)
        if roots is None:
            return
        # rebuilt from its superblock + metadb, exactly a process restart;
        # the shared nodes dict makes access/scheduler see the new engine
        self.cluster.nodes[node] = BlobNode(node_id=node, disk_roots=roots)
