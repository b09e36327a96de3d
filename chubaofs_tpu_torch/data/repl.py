"""Chain-replication packet pipeline (repl/repl_protocol.go:35-66 analog).

The reference's ReplProtocol: the leader reads a packet from the client
connection, Prepares it, forwards to every follower through pooled
FollowerTransports, Operates locally, and acks the client only after all
follower acks arrive (repl_protocol.go:190-219, follower check :155-160).

Kept here: the same leader pipeline with the forward overlapped against the
local operate (send to all followers first, operate, then collect acks — the
goroutine-pair overlap collapsed to one worker task per client connection),
pooled follower connections, and the RemainingFollowers byte cleared on
forwarded packets. The operator itself is injected by the datanode.

Serving rides the rpc/evloop.py event-loop core by default: loop
shards own the sockets, the blocking dispatch runs on the bounded worker
pool, per-connection order is preserved. `CFS_EVLOOP=0` restores the
thread-per-connection accept loop below for A/B and rollback."""

from __future__ import annotations

import socket
import threading

from chubaofs_tpu_torch.proto.packet import (
    Packet, RES_OK, recv_packet, send_packet,
)
from chubaofs_tpu_torch.rpc.evloop import EvloopServer, evloop_enabled
from chubaofs_tpu_torch.utils.conn_pool import ConnPool


class ReplError(Exception):
    pass


class FollowerAckError(ReplError):
    def __init__(self, addr: str, detail: str):
        super().__init__(f"follower {addr}: {detail}")
        self.addr = addr


class ReplServer:
    """TCP packet server + follower forwarding for one datanode."""

    def __init__(self, addr: str, dispatch, pool: ConnPool | None = None):
        """dispatch(pkt: Packet) -> Packet runs the node-local operate step
        (datanode/wrap_operator.go:80 analog) and decides replication itself
        via self.replicate()."""
        self.addr = addr
        self.dispatch = dispatch
        self.pool = pool or ConnPool()
        host, port = addr.rsplit(":", 1)
        self._listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._listener.bind((host, int(port)))
        if int(port) == 0:
            self.addr = f"{host}:{self._listener.getsockname()[1]}"
        self._stop = threading.Event()
        self._accept_thread: threading.Thread | None = None
        self._evloop: EvloopServer | None = None

    # -- server side -----------------------------------------------------------

    def start(self) -> None:
        self._listener.listen(128)
        if evloop_enabled():
            self._evloop = EvloopServer(self._listener, self.dispatch,
                                        name="repl")
            self._evloop.start()
            return
        self._accept_thread = threading.Thread(
            target=self._accept_loop, daemon=True, name=f"repl-{self.addr}")
        self._accept_thread.start()

    def _accept_loop(self) -> None:
        """CFS_EVLOOP=0 shim: the pre-evloop thread-per-connection path."""
        while not self._stop.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(  # racelint: CFS_EVLOOP=0 rollback shim — evloop is the default serving path
                target=self._serve_conn, args=(conn,), daemon=True).start()

    def _serve_conn(self, conn: socket.socket) -> None:
        """ServerConn analog (repl_protocol.go:219): packets in order per conn."""
        try:
            while not self._stop.is_set():
                pkt = recv_packet(conn)
                reply = self.dispatch(pkt)
                send_packet(conn, reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self) -> None:
        self._stop.set()
        if self._evloop is not None:
            self._evloop.stop()
        try:
            self._listener.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self._listener.close()
        self.pool.close()

    # -- leader-side forwarding ------------------------------------------------

    def replicate(self, pkt: Packet, operate) -> Packet:
        """Forward to pkt.arg['followers'], operate locally, collect acks.

        Overlap discipline of OperatorAndForwardPktGoRoutine
        (repl_protocol.go:205): all follower sends go out before the local
        operate runs; acks are collected after. Any follower failure fails the
        whole op — the client retries on a fresh extent, and repair reconciles
        (the reference's behavior on follower error)."""
        followers: list[str] = list(pkt.arg.get("followers", []))
        if not followers:
            return operate(pkt)

        fwd = Packet(
            opcode=pkt.opcode, partition_id=pkt.partition_id,
            extent_id=pkt.extent_id, extent_offset=pkt.extent_offset,
            kernel_offset=pkt.kernel_offset, data=pkt.data,
            arg={k: v for k, v in pkt.arg.items() if k != "followers"},
            req_id=pkt.req_id, crc=pkt.crc,
        )
        sent: list[tuple[str, socket.socket]] = []
        try:
            for addr in followers:
                sock = self.pool.get(addr)
                try:
                    send_packet(sock, fwd)
                except OSError as e:
                    self.pool.put(addr, sock, ok=False)
                    raise FollowerAckError(addr, f"send: {e}") from None
                sent.append((addr, sock))

            reply = operate(pkt)  # local op overlaps follower network+disk

            for addr, sock in sent:
                try:
                    ack = recv_packet(sock)
                except (OSError, ConnectionError) as e:
                    self.pool.put(addr, sock, ok=False)
                    sent.remove((addr, sock))
                    raise FollowerAckError(addr, f"recv: {e}") from None
                if ack.result != RES_OK:
                    raise FollowerAckError(addr, ack.error())
            for addr, sock in sent:
                self.pool.put(addr, sock)
            return reply
        except FollowerAckError:
            for addr, sock in sent:
                self.pool.put(addr, sock, ok=False)
            raise

    # -- client-side one-shot --------------------------------------------------

    def request(self, addr: str, pkt: Packet) -> Packet:
        """Send one packet to a peer and await its reply (repair/admin path)."""
        sock = self.pool.get(addr)
        try:
            send_packet(sock, pkt)
            reply = recv_packet(sock)
        except (OSError, ConnectionError):
            self.pool.put(addr, sock, ok=False)
            raise
        self.pool.put(addr, sock)
        return reply
