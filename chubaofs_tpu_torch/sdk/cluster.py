"""RemoteCluster — the SDK's network view of a running cluster.

Reference counterpart: the composition every CubeFS client performs —
sdk/master/client.go (master HTTP), sdk/meta (partition routing over TCP),
sdk/data/stream (extent TCP), sdk/data/blobstore (access API for cold
volumes). This object resolves everything from the master's registry: which
metanodes serve a volume's partitions, which datanodes host its extents, and
where the blobstore access gateway lives. Its surface matches the in-process
`FsCluster` (client/create_volume/delete_volume/volume_names/data_backend),
so ObjectNode and the FUSE-layer client run unchanged over the wire.
"""

from __future__ import annotations

import threading

from chubaofs_tpu_torch.master.api_service import MasterClient
from chubaofs_tpu_torch.master.master import (
    INF,
    DataPartitionView,
    MasterError,
    MetaPartitionView,
    VolumeView,
)
from chubaofs_tpu_torch.meta.service import RemoteMetaNode
from chubaofs_tpu_torch.sdk.fs import FsClient
from chubaofs_tpu_torch.sdk.meta_wrapper import MetaWrapper
from chubaofs_tpu_torch.sdk.stream import ExtentClient, HotBackend


class _MasterAdapter:
    """Duck-types the `master` object MetaWrapper routes over, fed by HTTP."""

    def __init__(self, mc: MasterClient):
        self.mc = mc

    def get_volume(self, name: str) -> VolumeView:
        d = self.mc.get_volume(name)
        vol = VolumeView(name=d["name"], vol_id=d["vol_id"], owner=d["owner"],
                         capacity=d["capacity"], cold=d["cold"],
                         follower_read=d.get("follower_read", False),
                         qos_read_mbps=d.get("qos_read_mbps", 0),
                         qos_write_mbps=d.get("qos_write_mbps", 0))
        for mp in d["meta_partitions"]:
            end = INF if mp["end"] < 0 else mp["end"]
            vol.meta_partitions.append(MetaPartitionView(
                mp["partition_id"], mp["start"], end,
                peers=list(mp["peers"]), leader=mp.get("leader")))
        for dp in d["data_partitions"]:
            vol.data_partitions.append(DataPartitionView(
                dp["partition_id"], peers=list(dp["peers"]),
                hosts=list(dp["hosts"]), status=dp.get("status", "rw")))
        return vol


class RemoteDataBackend:
    """Cold-tier backend over the access gateway (FsClient data_backend)."""

    def __init__(self, access_client):
        self.ac = access_client

    def write(self, data: bytes) -> str:
        return self.ac.put(data).to_json()

    def read(self, loc: str, offset: int, size: int) -> bytes:
        return self.ac.get(loc, offset, size)

    def delete(self, loc: str) -> None:
        self.ac.delete(loc)


class RemoteCluster:
    def __init__(self, master_addrs: list[str], access_addrs: list[str] | None = None,
                 admin_ticket=None):
        self.mc = MasterClient(master_addrs, admin_ticket=admin_ticket)
        self.adapter = _MasterAdapter(self.mc)
        self.access_addrs = access_addrs or []
        self._metanodes: dict[int, RemoteMetaNode] = {}
        self._lock = threading.Lock()
        self._backend = None

    # -- registry refresh ------------------------------------------------------

    def metanode_handles(self) -> dict[int, RemoteMetaNode]:
        """RemoteMetaNode per registered metanode; re-dials on addr change."""
        cluster = self.mc.get_cluster()
        with self._lock:
            for n in cluster["nodes"]:
                if n["kind"] != "meta" or not n["addr"]:
                    continue
                cur = self._metanodes.get(n["node_id"])
                if cur is None or cur.addr != n["addr"]:
                    if cur is not None:
                        cur.close()
                    self._metanodes[n["node_id"]] = RemoteMetaNode(n["addr"])
            return dict(self._metanodes)

    @property
    def data_backend(self):
        if self._backend is None:
            if not self.access_addrs:
                raise MasterError("no blobstore access gateway configured")
            from chubaofs_tpu_torch.blobstore.gateway import AccessClient

            self._backend = RemoteDataBackend(AccessClient(self.access_addrs))
        return self._backend

    # -- FsCluster surface -----------------------------------------------------

    def create_volume(self, name: str, cold: bool = True) -> None:
        """Creates the volume and returns once every master that answers
        serves it. Each master serves getVol from its own replica of the
        raft log, so a volume the leader just committed may not be on a
        follower yet, and the next call (the objectnode's bucket lookup
        right after its create) may land there. A master that cannot be
        reached catches up from the log when it comes back."""
        import time

        from chubaofs_tpu_torch.rpc.errors import HTTPError

        self.mc.create_volume(name, cold=cold)
        for host in self.mc.rpc.hosts:
            one = MasterClient([host], retries=1,
                               auth_secret=self.mc.auth_secret,
                               admin_ticket=self.mc.admin_ticket)
            deadline = time.monotonic() + 10.0
            while True:
                try:
                    one.get_volume(name)
                    break
                except MasterError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.02)
                except (HTTPError, OSError):
                    break

    def delete_volume(self, name: str) -> None:
        self.mc.delete_volume(name)

    def volume_names(self) -> list[str]:
        return sorted(self.mc.get_cluster()["volumes"])

    def client(self, volume: str) -> FsClient:
        from chubaofs_tpu_torch.sdk.fs import VolQos

        meta = MetaWrapper(self.adapter, self.metanode_handles(), volume)
        vol = self.adapter.get_volume(volume)
        backend = self.data_backend if self.access_addrs else None

        def fetch_limits():
            v = self.adapter.get_volume(volume)
            return v.qos_read_mbps, v.qos_write_mbps

        qos = VolQos.from_view(vol, fetch=fetch_limits)
        if vol.cold:
            return FsClient(meta, backend, cold=True, qos=qos)
        ec = ExtentClient(lambda: self.mc.data_partitions(volume),
                          follower_read=vol.follower_read)
        return FsClient(meta, backend, hot_backend=HotBackend(ec, meta),
                        cold=False, qos=qos)
