"""Metanode wire service — metadata ops over the packet TCP protocol.

Reference counterpart: metanode/manager.go:103 (`HandleMetadataOperation`
dispatching OpMeta* packets from TCP conns) + sdk/meta/operation.go (the
client side of the same wire). Kept: request/response ride the shared binary
`Packet` (proto/packet.go), the partition id addresses the shard, a
not-leader reply carries the leader hint so clients re-aim
(sdk/meta retry/leader-switch), and op payloads are JSON. Changed: one
OP_META_OP opcode with the op name in the arg blob instead of ~40 distinct
opcodes — the partition state machine dispatches by name already.

`RemoteMetaNode` duck-types the in-process `MetaNode` surface the
`MetaWrapper` routes over (submit_sync / lookup / get_inode / read_dir /
multipart_*), so the SDK works unchanged against local objects or TCP.
"""

from __future__ import annotations

import json
import socket
import threading

import time

from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.meta.metanode import MetaNode, OpError
from chubaofs_tpu_torch.meta.partition import MetaPartitionSM
from chubaofs_tpu_torch.meta.wire import dec, enc
from chubaofs_tpu_torch.proto.packet import (
    OP_META_OP,
    TRACE_ARG_KEY,
    Packet,
    RES_ERR,
    RES_NOT_LEADER,
    RES_OK,
    recv_packet,
    send_packet,
    trace_extract,
    trace_inject,
    trace_merge,
    trace_reply,
)
from chubaofs_tpu_torch.raft.server import NotLeaderError
from chubaofs_tpu_torch.rpc.evloop import EvloopServer, evloop_enabled
from chubaofs_tpu_torch.utils.auditlog import record_slow_op
from chubaofs_tpu_torch.utils.exporter import registry

# ops served from leader state without a raft round (metanode read path)
READ_OPS = {"lookup", "get_inode", "read_dir", "multipart_get",
            "multipart_list", "quota_usage", "tx_status", "dump_namespace",
            "split_point", "export_range"}

_ADMIN_OPS = {"admin_create_partition", "admin_remove_partition",
              "admin_raft_config", "admin_partitions",
              "admin_partition_leaders"}


def _op_label(op: str) -> str:
    """Metric label for an op name: the KNOWN op set verbatim, anything else
    collapsed to "other" — the op string arrives off the wire, and a label
    minted per arbitrary client string would grow the registry unboundedly
    (the invariant obslint enforces for literal keys)."""
    if op in READ_OPS or op in _ADMIN_OPS \
            or hasattr(MetaPartitionSM, "_op_" + op):
        return op
    return "other"


class MetaService:
    """TCP front of one MetaNode (manager.go dispatch analog)."""

    def __init__(self, metanode: MetaNode, host: str = "127.0.0.1", port: int = 0):
        self.metanode = metanode
        self._reg = registry("metanode")  # bound once: _handle is per-packet
        self.listener = socket.create_server((host, port))
        self.addr = f"{host}:{self.listener.getsockname()[1]}"
        self._stop = threading.Event()
        self._evloop: EvloopServer | None = None
        if evloop_enabled():
            # serving on the shared event-loop core: loop shards own the
            # sockets, _handle runs on the bounded worker pool (it blocks on
            # raft commits), per-connection order preserved
            self._evloop = EvloopServer(self.listener, self._handle,
                                        name="meta")
            self._evloop.start()
        else:
            self._thread = threading.Thread(target=self._accept, daemon=True)
            self._thread.start()

    def _accept(self):
        """CFS_EVLOOP=0 shim: the pre-evloop thread-per-connection path."""
        while not self._stop.is_set():
            try:
                conn, _ = self.listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(  # racelint: CFS_EVLOOP=0 rollback shim — evloop is the default serving path
                target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket):
        try:
            while not self._stop.is_set():
                pkt = recv_packet(conn)
                send_packet(conn, self._handle(pkt))
        except (ConnectionError, OSError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def _handle(self, pkt: Packet) -> Packet:
        """Dispatch wrapper: continues the packet's trace (span pushed so the
        partition/raft layers under the handler see it), counts per-op TP
        metrics into the metanode role registry (exporter.NewTPCnt at
        metanode/manager.go:109), sends the span's track log back in the
        reply arg, and audits over-threshold ops."""
        op = pkt.arg.get("op", "") if isinstance(pkt.arg, dict) else ""
        # reply carries the track log ONLY for requests that brought a trace
        # id (same guard as datanode dispatch): untraced callers on the
        # hottest metadata path pay zero extra reply bytes
        traced = isinstance(pkt.arg, dict) and TRACE_ARG_KEY in pkt.arg
        span = trace_extract(pkt, f"metanode.{op or 'packet'}")
        trace.push_span(span)
        t0 = time.perf_counter()
        try:
            with self._reg.tp("meta_op", {"op": _op_label(op)}):
                resp = self._handle_inner(pkt, op)
            span.append_track_log("metanode", start=t0)
            return trace_reply(resp, span) if traced else resp
        finally:
            span.finish()
            trace.pop_span()
            record_slow_op("metanode", _op_label(op) if op else "packet",
                           time.perf_counter() - t0, span=span)

    def _handle_inner(self, pkt: Packet, op: str) -> Packet:
        if pkt.opcode != OP_META_OP:
            return pkt.reply(RES_ERR, arg={"error": f"bad opcode {pkt.opcode:#x}"})
        args = dec(json.loads(pkt.data.decode())) if pkt.data else {}
        pid = pkt.partition_id
        try:
            if op == "admin_create_partition":
                # node-level admin task from the master (cluster_task.go
                # analog); raft_addrs lets this node's TcpNet dial peers
                raft_addrs = args.pop("raft_addrs", None) or {}
                if hasattr(self.metanode.raft.net, "set_peer"):
                    for nid, addr in raft_addrs.items():
                        self.metanode.raft.net.set_peer(int(nid), addr)
                if pid not in self.metanode.partitions:
                    self.metanode.create_partition(pid, **args)
                return pkt.reply(RES_OK, data=b"null")
            if op == "admin_remove_partition":
                self.metanode.remove_partition(pid)
                return pkt.reply(RES_OK, data=b"null")
            if op == "admin_raft_config":
                # the leader must be able to dial a freshly added member
                raft_addrs = args.get("raft_addrs") or {}
                if hasattr(self.metanode.raft.net, "set_peer"):
                    for nid, addr in raft_addrs.items():
                        self.metanode.raft.net.set_peer(int(nid), addr)
                out = self.metanode.propose_raft_config(
                    pid, args["action"], args["node_id"])
                return pkt.reply(RES_OK, data=json.dumps(enc(out)).encode())
            if op == "admin_partitions":
                out = sorted(self.metanode.partitions)
                return pkt.reply(RES_OK, data=json.dumps(out).encode())
            if op == "admin_partition_leaders":
                # pid -> whether THIS node currently leads its raft group
                # (the meta-scale bench's leader-spread evidence)
                out = {pid: self.metanode.is_leader(pid)
                       for pid in sorted(self.metanode.partitions)}
                return pkt.reply(RES_OK, data=json.dumps(out).encode())
            if op in READ_OPS:
                out = getattr(self.metanode, op)(pid, **args)
            else:
                out = self.metanode.submit_sync(pid, op, **args)
            return pkt.reply(RES_OK, data=json.dumps(enc(out)).encode())
        except NotLeaderError as e:
            return pkt.reply(RES_NOT_LEADER, arg={"leader": e.leader})
        except OpError as e:
            return pkt.reply(RES_ERR, arg={"code": e.code, "error": str(e)})
        except Exception as e:  # never kill the conn on a handler bug
            return pkt.reply(RES_ERR, arg={"code": "EIO",
                                           "error": f"{type(e).__name__}: {e}"})

    def close(self):
        self._stop.set()
        if self._evloop is not None:
            self._evloop.stop()
        try:
            self.listener.close()
        except OSError:
            pass


class RemoteMetaNode:
    """Client handle speaking MetaService's wire; MetaNode duck-type.

    One pooled connection per handle; MetaWrapper's leader-retry logic drives
    which node gets asked (sdk/meta/operation.go's sendToMetaPartition).
    """

    def __init__(self, addr: str, conn_pool=None, timeout: float = 10.0):
        self.addr = addr
        self.timeout = timeout
        self.pool = conn_pool
        self._local = threading.local()

    def _conn(self) -> socket.socket:
        sock = getattr(self._local, "sock", None)
        if sock is None:
            host, port = self.addr.rsplit(":", 1)
            sock = socket.create_connection((host, int(port)), timeout=self.timeout)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            self._local.sock = sock
        return sock

    def _drop_conn(self):
        sock = getattr(self._local, "sock", None)
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
            self._local.sock = None

    def _call(self, pid: int, op: str, **args):
        pkt = trace_inject(Packet(opcode=OP_META_OP, partition_id=pid,
                                  arg={"op": op},
                                  data=json.dumps(enc(args)).encode()))
        # connect failures are ECONN (nothing was sent — always safe to retry
        # elsewhere); failures after send are EIO (the op may have applied, so
        # only idempotent ops retry — sdk/meta's same distinction)
        try:
            sock = self._conn()
        except (ConnectionError, OSError) as e:
            self._drop_conn()
            raise OpError("ECONN", f"metanode {self.addr}: {e}") from None
        try:
            send_packet(sock, pkt)
            resp = recv_packet(sock)
        except (ConnectionError, OSError) as e:
            self._drop_conn()
            raise OpError("EIO", f"metanode {self.addr}: {e}") from None
        trace_merge(resp)  # fold the metanode's track log into our span
        if resp.result == RES_NOT_LEADER:
            raise NotLeaderError(resp.arg.get("leader"))
        if resp.result != RES_OK:
            raise OpError(resp.arg.get("code", "EIO"), resp.arg.get("error", "error"))
        return dec(json.loads(resp.data.decode())) if resp.data else None

    # -- MetaNode surface ------------------------------------------------------

    def submit_sync(self, partition_id: int, op: str, timeout: float = 5.0, **args):
        return self._call(partition_id, op, **args)

    def lookup(self, partition_id: int, parent: int, name: str):
        return self._call(partition_id, "lookup", parent=parent, name=name)

    def get_inode(self, partition_id: int, ino: int):
        return self._call(partition_id, "get_inode", ino=ino)

    def read_dir(self, partition_id: int, parent: int):
        return self._call(partition_id, "read_dir", parent=parent)

    def multipart_get(self, partition_id: int, upload_id: str):
        return self._call(partition_id, "multipart_get", upload_id=upload_id)

    def multipart_list(self, partition_id: int):
        return self._call(partition_id, "multipart_list")

    def quota_usage(self, partition_id: int):
        out = self._call(partition_id, "quota_usage")
        return {int(k): v for k, v in out.items()}  # JSON stringifies int keys

    def tx_status(self, partition_id: int, tx_id: str) -> str:
        return self._call(partition_id, "tx_status", tx_id=tx_id)

    def dump_namespace(self, partition_id: int):
        return self._call(partition_id, "dump_namespace")

    def split_point(self, partition_id: int) -> int:
        return self._call(partition_id, "split_point")

    def export_range(self, partition_id: int, after: int = 0,
                     limit: int = 0) -> dict:
        return self._call(partition_id, "export_range", after=after,
                          limit=limit)

    def partition_leaders(self) -> dict[int, bool]:
        """pid -> is_leader on this node (admin; pid 0 addresses the node)."""
        out = self._call(0, "admin_partition_leaders")
        return {int(k): bool(v) for k, v in out.items()}

    def close(self):
        self._drop_conn()
