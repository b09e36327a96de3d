"""MiniCluster — an in-process blobstore cluster for tests and local use.

Reference analog: master/mocktest + docker-compose bring-up (SURVEY §4) — the
reference validates multi-node behavior with in-process fakes speaking the real
interfaces. Here every component is the REAL implementation wired directly:
N blobnodes with D disks each, one clustermgr, one proxy, one access gateway,
one scheduler + repair worker, all sharing one CodecService (on the CUDA
device unless the caller names another).
"""

from __future__ import annotations

import os

from chubaofs_tpu_torch.blobstore.access import Access
from chubaofs_tpu_torch.blobstore.blobnode import BlobNode
from chubaofs_tpu_torch.blobstore.clustermgr import ClusterMgr
from chubaofs_tpu_torch.blobstore.proxy import Proxy
from chubaofs_tpu_torch.blobstore.scheduler import RepairWorker, Scheduler
from chubaofs_tpu_torch.codec.service import CodecService


class MiniCluster:
    def __init__(
        self,
        root: str,
        n_nodes: int = 6,
        disks_per_node: int = 2,
        azs: int = 1,
        persist_cm: bool = True,
        codec: CodecService | None = None,
        cache: "BlobCache | None" = None,
        device=None,
    ):
        """codec: inject a shared CodecService; by default the cluster
        builds its own on `device`.
        device: where that service runs — None means the CUDA device (and
        raises without one), "cpu" runs the codec math on the host.
        cache: inject a blobstore.cache.BlobCache for the tiered read plane;
        default comes from the environment (CFS_CACHE_MB > 0), so daemon
        deployments and the capacity harness opt in with one knob."""
        from chubaofs_tpu_torch.blobstore.cache import BlobCache

        self.root = root
        self._owns_codec = codec is None  # injected services outlive us
        self.codec = codec or CodecService(device=device)
        if cache is None:
            cache = BlobCache.from_env(os.path.join(root, "cache"))
        self.cache = cache
        self.cm = ClusterMgr(os.path.join(root, "cm") if persist_cm else None)
        self.nodes: dict[int, BlobNode] = {}
        for n in range(1, n_nodes + 1):
            roots = [os.path.join(root, f"node{n}", f"disk{d}") for d in range(disks_per_node)]
            node = BlobNode(node_id=n, disk_roots=roots)
            self.nodes[n] = node
            az = (n - 1) % azs
            self.cm.register_disks([
                {"disk_id": disk_id, "node_id": n, "az": az}
                for disk_id in node.disks])
        self.proxy = Proxy(self.cm, data_dir=os.path.join(root, "proxy"))
        self.access = Access(self.cm, self.proxy, self.nodes, codec=self.codec,
                             cache=self.cache)
        self.scheduler = Scheduler(self.cm, self.proxy, self.nodes,
                                   codec=self.codec, cache=self.cache)
        self.worker = RepairWorker(self.scheduler, self.nodes, codec=self.codec)

    def run_background_once(self) -> dict:
        """One tick of every background loop (the 16-ticker scheduleTask analog):
        detection first (heartbeats, heartbeat expiry, lease reaping, the
        budgeted scrub), then the task planes, then host-local hygiene."""
        # heartbeats are per-node daemon work: a dead/closed engine simply
        # stops beating, which IS the signal the expiry below consumes
        for n in list(self.nodes.values()):
            try:
                n.heartbeat(self.cm)
            except Exception:
                pass
        dead_disks = self.scheduler.check_node_health()
        reaped = self.scheduler.reap_expired()
        scrubbed = self.scheduler.run_scrub()
        inspected = self.scheduler.inspect_volumes()
        polled = self.scheduler.poll_repair_topic()
        tier_msgs = self.scheduler.run_tier()
        disk_tasks = self.scheduler.check_disks()
        balance_task = self.scheduler.check_balance()
        ran = 0
        while self.worker.run_once():
            ran += 1
        deleted = self.scheduler.run_deleter()
        # compaction is host-local work: a dark/dead node skips its own sweep
        # without stalling the cluster's (the daemon analog runs it per host)
        compacted = 0
        for n in self.nodes.values():
            try:
                compacted += n.compact_once()
            except Exception:
                pass
        return {
            "inspect_msgs": inspected,
            "repair_msgs": polled,
            "tier_msgs": tier_msgs,
            "disk_tasks": len(disk_tasks),
            "balance_tasks": 1 if balance_task else 0,
            "tasks_ran": ran,
            "deletes": deleted,
            "compacted_bytes": compacted,
            "hb_expired_disks": len(dead_disks),
            "leases_reaped": reaped,
            "scrub_findings": scrubbed,
        }

    def close(self):
        if self._owns_codec:  # never kill a shared/injected service
            self.codec.close()
        self.access.close()
        self.worker.close()
        for node in self.nodes.values():
            node.close()
        self.cm.close()
