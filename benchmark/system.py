"""What the benchmark takes from the program: the blobstore daemon as a user
starts it, its operator surface, its counters and spans, and the shards it
stored (read back only to judge them).

Everything here runs in the run's own process, which holds the card; the
traffic comes from benchmark/client.py in another process.
"""

from __future__ import annotations

import json
import urllib.request


def start_daemon(cfg: dict, root: str, device: str):
    """The blobstore role, through the port's cmd.start_role."""
    from chubaofs_tpu_torch.cmd import start_role

    return start_role({"role": "blobstore", "root": root, "nodes": cfg["nodes"],
                       "disksPerNode": cfg["disks_per_node"], "azs": cfg["azs"],
                       "listen": "127.0.0.1:0", "device": device})


def cluster_of(daemon):
    return daemon.runner.handles["cluster"]


def switch_off(addr: str, names: list[str]) -> None:
    """Turn background task switches off through the admin API, as an
    operator does (`/admin/switch`), and read them back."""
    for name in names:
        req = urllib.request.Request(f"http://{addr}/admin/switch?name={name}&enabled=0",
                                     data=b"", method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            if r.status != 200:
                raise RuntimeError(f"/admin/switch {name}: {r.status}")
    with urllib.request.urlopen(f"http://{addr}/admin/switches", timeout=30) as r:
        state = json.load(r)
    if any(state.get(n) for n in names):
        raise RuntimeError(f"switches still on: {state}")


def set_policies(cluster, policies: list[dict]) -> None:
    """The configuration's code-mode policy table, handed to the gateway
    (the port's `Access.policies`, `CodeModePolicy` by mode name), before
    any object is stored."""
    from chubaofs_tpu_torch.blobstore.access import CodeModePolicy
    from chubaofs_tpu_torch.codec.codemode import CodeMode

    cluster.access.policies = [CodeModePolicy(CodeMode[p["mode"]], p.get("min_size", 0),
                                              p.get("max_size", 1 << 62))
                               for p in policies]


def az_disks(cluster, az: int) -> list[int]:
    """Every disk of one AZ, by id."""
    return sorted(d.disk_id for d in cluster.cm.disks.values() if d.az == az)


def victims(cluster, count: int, exclude: list[int] = ()) -> list[int]:
    """`count` disks to lose, picked by what they hold: each in turn, in the
    next AZ and on a node not picked yet, the disk holding the most
    data-shard bytes of blobs that no disk picked so far touches (ties to
    the lowest disk id). So the lost disks reach as many stored blobs as
    they can, whatever volumes the preload filled. Disks in `exclude` (an
    AZ lost whole) are never picked, and their AZ takes no turn."""
    from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard

    held: dict[int, dict[tuple[int, int], int]] = {}  # disk -> (vid, bid) -> bytes
    for vol in list(cluster.cm.volumes.values()):
        n = vol.tactic().N
        for u in vol.units:
            try:
                metas = cluster.nodes[u.node_id].list_shards(u.vuid)
            except NoSuchShard:
                continue
            disk = held.setdefault(u.disk_id, {})
            for m in metas:
                if u.index < n:
                    disk[(vol.vid, m.bid)] = m.size
    disks = sorted((d for d in cluster.cm.disks.values() if d.disk_id not in exclude),
                   key=lambda d: d.disk_id)
    azs = sorted({d.az for d in disks})
    out, nodes, reached = [], set(), set()
    for i in range(count):
        az = azs[i % len(azs)]
        cands = [d for d in disks if d.az == az and d.node_id not in nodes]
        best = max(cands, key=lambda d: (sum(b for k, b in held.get(d.disk_id, {}).items()
                                             if k not in reached), -d.disk_id))
        out.append(best.disk_id)
        nodes.add(best.node_id)
        reached.update(held.get(best.disk_id, {}))
    return out


def lose_disks(cluster, disk_ids: list[int]) -> int:
    """Every shard on the disks is lost (media loss, no tombstone) and the
    disks are marked broken. Returns the shards lost."""
    from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard
    from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN

    lost = 0
    for vol in list(cluster.cm.volumes.values()):
        for u in vol.units:
            if u.disk_id not in disk_ids:
                continue
            node = cluster.nodes[u.node_id]
            try:
                metas = node.list_shards(u.vuid)
            except NoSuchShard:
                continue  # the unit never got a chunk: nothing stored there
            for m in metas:
                node.lose_shard(u.vuid, m.bid)
                lost += 1
    for d in disk_ids:
        cluster.cm.set_disk_status(d, DISK_BROKEN)
    return lost


def lost_units(cluster, disk_ids: list[int]) -> dict[int, set[int]]:
    """vid -> the unit indices of that volume on the disks: the shards of
    its blobs that losing the disks takes."""
    out: dict[int, set[int]] = {}
    for vol in list(cluster.cm.volumes.values()):
        for i, u in enumerate(vol.units):
            if u.disk_id in disk_ids:
                out.setdefault(vol.vid, set()).add(i)
    return out


def codec_counters() -> dict:
    """The codec service's counters (process-wide registry)."""
    from chubaofs_tpu_torch.utils.exporter import registry

    reg = registry("codec")
    return {"batches": reg.counter("batches_total").value,
            "jobs": reg.counter("jobs_total").value,
            "dispatch_s": reg.summary("dispatch_seconds").snapshot()["sum"]}


def decoded_bytes() -> float:
    from chubaofs_tpu_torch.utils.exporter import registry

    return registry("access").counter("read_bytes", {"kind": "decoded"}).value


class SpanRecorder:
    """Collects the gateway's finished `access.put` / `access.get` spans
    through the trace module's finish hook, chained to any hook already
    installed."""

    OPS = ("access.put", "access.get")

    def __init__(self):
        from chubaofs_tpu_torch.blobstore import trace

        self.trace = trace
        self.spans: list[dict] = []
        self._prev = None

    def _hook(self, span) -> None:
        if span.operation in self.OPS and span.finished_us is not None:
            self.spans.append({"op": span.operation, "start": span.start,
                               "dur": span.finished_us / 1e6,
                               "stages": [(n, span.start + off, d) for n, off, d in span.stages]})
        if self._prev is not None:
            self._prev(span)

    def __enter__(self):
        self._prev = self.trace.finish_hook()
        self.trace.set_finish_hook(self._hook)
        return self

    def __exit__(self, *exc):
        self.trace.set_finish_hook(self._prev)
        return False


def read_stripe(cluster, vid: int, bid: int) -> list[bytes | None]:
    """Every shard the blobnodes hold for one blob, in stripe order (None
    where a shard is missing)."""
    vol = cluster.cm.get_volume(vid)
    out = []
    for u in vol.units:
        try:
            out.append(cluster.nodes[u.node_id].get_shard(u.vuid, bid))
        except Exception:  # the engine reports a missing shard many ways
            out.append(None)
    return out
