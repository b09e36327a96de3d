"""Event-loop packet server core — the thread-per-connection replacement.

Reference counterpart: Go's netpoller gives repl/repl_protocol.go a goroutine
pair per connection for free; at hundreds of concurrent clients a Python port
paying a full OS thread (8 MiB stack, GIL churn, scheduler pressure) per
connection hits the thread wall long before the network saturates (ROADMAP
item 5). This module is the event loop we have to build ourselves:

  * ONE acceptor thread owns the listener and deals new connections to loop
    shards round-robin;
  * N **loop shards** (`CFS_EVLOOP_SHARDS`), each a single thread owning a
    `selectors` instance and every connection registered on it. Sockets are
    non-blocking; each connection runs an incremental framing state machine
    (proto/packet.PacketFramer or the raft frame reader) that preallocates
    exactly the bytes the next stage needs and fills them with `recv_into` —
    the zero-copy receive discipline of the blocking path, resumable across
    partial reads;
  * a **write queue per connection** with backpressure: a reply takes an
    opportunistic direct non-blocking `sendmsg` from the worker when the
    queue is empty (ordering is the sender's, and the common case skips
    the wake-pipe round trip); any remainder is queued as iovecs and
    flushed by the owning shard under EVENT_WRITE. When either per-conn
    buffer — replies for a slow reader, or parsed requests ahead of a slow
    handler — crosses the high-water mark the shard STOPS READING from
    that connection (and only that one) until both drain below half — one
    wedged client costs itself throughput, never its shard neighbors;
  * a **bounded worker pool** (`CFS_EVLOOP_WORKERS` daemon threads) that
    dispatch hops to, so the existing blocking `dispatch(pkt) -> Packet`
    handlers (datanode operate + chain replicate, metanode raft submit)
    never stall a loop shard. Per-connection dispatch stays SERIAL and
    in-order — the pipelined write burst sdk/stream.py sends on one socket
    is acked in send order, exactly like the thread-per-conn path — while
    distinct connections share the pool.

Trace spans survive the loop→worker hop by construction: the trace carrier
rides the packet's arg blob, and the span is minted inside the handler on
the worker thread (datanode._dispatch / MetaService._handle are unchanged).
The hop itself is metered: `cfs_evloop_dispatch` observes parse-to-reply
latency including queue wait.

Instrumentation: `cfs_evloop_conns{srv,shard}` live connections per shard,
`cfs_evloop_dispatch{srv}` handler latency, `cfs_evloop_backpressure{srv,
shard}` pause events. Chaos: the `evloop.dispatch` failpoint fires before
every handler call — `delay` injects service latency, `error` (a
ConnectionError) drops that connection, exactly like a link cut mid-op.

`CFS_EVLOOP=0` restores the threaded accept loops in data/repl.py,
meta/service.py, and raft/transport.py for A/B and rollback.
"""

from __future__ import annotations

import os
import queue
import selectors
import socket
import threading
import time
from collections import deque
from itertools import count, islice

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.proto.packet import PacketFramer, advance_iov, packet_iov
from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.locks import SanitizedLock


def evloop_enabled() -> bool:
    """The CFS_EVLOOP escape hatch: default ON, =0 restores the threaded
    path (checked at server start, so one process can A/B both)."""
    return os.environ.get("CFS_EVLOOP", "1").lower() not in ("0", "false", "off")


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


# process-wide id so several same-name servers (one process, many nodes in
# tests) never share a settable metric series
_INSTANCE_IDS = count()

# per-connection buffer high-water mark: one full extent packet plus
# headroom. Crossing it on EITHER side — replies queued for a slow reader
# (wq_bytes) or parsed requests awaiting a slow handler (inbox_bytes) —
# pauses READS from that connection until both drain below half; classic
# high/low-water backpressure, so neither direction can balloon memory.
_WRITE_HWM = 8 << 20

# loop-lag heartbeat: each shard expects to pass through select() at least
# every _LAG_TICK seconds; how LATE the tick actually fires is the shard's
# scheduling lag — the saturation signal (a shard stuck flushing one conn's
# burst, or starved by the GIL, shows up as lag long before conns error).
# The tick equals the idle select timeout, so an IDLE shard's wakeup
# cadence is exactly what it was before the tick existed — the lag meter
# adds observations, not wakeups.
_LAG_TICK = 0.5
# lag histogram buckets in MILLISECONDS: sub-tick jitter up to multi-second
# stalls (the same decade ladder the lock-hold histogram uses)
LAG_BUCKETS = (0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0,
               250.0, 1000.0)


class _Conn:
    """One registered connection: framing state + write queue + dispatch
    queue. Owned by exactly one loop shard; workers touch only the queues,
    under the shard lock."""

    __slots__ = ("sock", "fd", "framer", "buf", "view", "got", "wq",
                 "wq_bytes", "inbox", "inbox_bytes", "msg_bytes",
                 "dispatching", "paused", "closed", "events", "greedy",
                 "close_after")

    def __init__(self, sock: socket.socket, framer):
        self.sock = sock
        self.fd = sock.fileno()
        self.framer = framer
        self.buf: bytearray | None = None   # current stage buffer
        self.view: memoryview | None = None
        self.got = 0
        self.wq: deque = deque()            # pending outbound memoryviews
        self.wq_bytes = 0
        self.inbox: deque = deque()         # (msg, wire bytes) awaiting dispatch
        self.inbox_bytes = 0                # wire bytes parked in inbox
        self.msg_bytes = 0                  # stages consumed by the current msg
        self.dispatching = False            # a worker is draining inbox
        self.paused = False                 # reads stopped by backpressure
        self.closed = False
        self.events = 0                     # currently registered event mask
        # greedy framers (variable-length protocols: HTTP) consume whatever
        # arrived via feed_chunk() instead of the exact-size feed() stages
        self.greedy = bool(getattr(framer, "greedy", False))
        # a reply asked for connection teardown once it is fully flushed
        # (HTTP Connection: close); reads stop immediately
        self.close_after = False

    def arm_stage(self) -> None:
        n = self.framer.need()
        self.buf = bytearray(n)
        self.view = memoryview(self.buf)
        self.got = 0


class _Workers:
    """Bounded pool of daemon worker threads over one shared task queue,
    spawned LAZILY up to the bound: a process running several servers
    (MiniCluster's 3 datanodes + 3 metanodes) would otherwise idle at
    n-per-server fixed threads — the very cost the evloop removes. Tasks
    are per-connection drain loops, so the queue never holds more than one
    entry per live connection; daemon threads match the threaded path's
    shutdown semantics (a blocked handler cannot hang process exit)."""

    _SENTINEL = None

    def __init__(self, n: int, name: str):
        self.n = n
        self._name = name
        self._q: queue.SimpleQueue = queue.SimpleQueue()
        self._threads: list[threading.Thread] = []
        self._idle = 0
        self._lock = SanitizedLock(name=f"evloop.workers.{name}")

    def submit(self, fn) -> None:
        self._q.put(fn)
        with self._lock:
            if self._idle or len(self._threads) >= self.n:
                return
            t = threading.Thread(
                target=self._run, daemon=True,
                name=f"evw-{self._name}-{len(self._threads)}")
            self._threads.append(t)
        t.start()

    def _run(self) -> None:
        while True:
            with self._lock:
                self._idle += 1
            try:
                fn = self._q.get()
            finally:
                with self._lock:
                    self._idle -= 1
            if fn is self._SENTINEL:
                return
            try:
                fn()
            except Exception:
                pass  # a task's errors are handled at its conn; never kill a worker

    def stop(self) -> None:
        with self._lock:
            n_live = len(self._threads)
        for _ in range(n_live):
            self._q.put(self._SENTINEL)


class _LoopShard(threading.Thread):
    """One selector + the connections it owns. Everything that touches the
    selector runs HERE; cross-thread requests (new conns, queued writes,
    closes) arrive as closures through the inbox + wake pipe. Socket READS
    are loop-thread-only; writes are loop-thread OR a worker's direct send
    under the shard lock with an empty write queue (see send())."""

    def __init__(self, server: "EvloopServer", idx: int):
        super().__init__(daemon=True, name=f"evloop-{server.name}-{idx}")
        self.server = server
        self.idx = idx
        self.sel = selectors.DefaultSelector()
        self.conns: dict[int, _Conn] = {}
        self._rx, self._tx = os.pipe()
        os.set_blocking(self._tx, False)
        self.sel.register(self._rx, selectors.EVENT_READ, None)
        self._inbox: deque = deque()
        self._lock = SanitizedLock(name=f"evloop.shard.{server.name}")
        self._woken = False
        self._pipe_closed = False
        # the gauge is SET (not added), so several same-name servers in one
        # process (MiniCluster's 3 datanodes) would clobber a shared series
        # and the first stop() would unregister it for the survivors — the
        # labels carry a process-unique instance id
        self.gauge_labels = {"srv": server.name, "shard": str(idx),
                             "inst": str(server.instance)}
        self._gauge = server.reg.gauge("conns", self.gauge_labels)
        self._bp = server.reg.counter(
            "backpressure", {"srv": server.name, "shard": str(idx)})
        # cfs_evloop_loop_lag_ms: select-wakeup delay vs the expected tick —
        # the per-shard saturation histogram cfs-top reads
        self._lag = server.reg.summary(
            "loop_lag_ms", {"srv": server.name, "shard": str(idx)},
            buckets=LAG_BUCKETS)

    # -- cross-thread entry points --------------------------------------------

    def post(self, fn) -> bool:
        """Run `fn` on the loop thread (workers and the acceptor call this).
        The pipe write happens under the lock that also serializes teardown's
        close — a late post can never hit a recycled fd number. Returns False
        once teardown has run: the loop will never drain the inbox again, so
        enqueueing would silently drop the closure."""
        with self._lock:
            if self._pipe_closed or self.server.stopping.is_set():
                return False  # loop exited (or is exiting): nothing drains
            self._inbox.append(fn)
            if not self._woken:
                self._woken = True
                try:
                    os.write(self._tx, b"\0")
                except (BlockingIOError, OSError):
                    pass  # pipe full: a wakeup is already pending
        return True

    def wake(self) -> None:
        """Nudge the loop out of select() without enqueueing work — stop()'s
        see-the-flag-now signal (post() refuses once stopping is set)."""
        with self._lock:
            if self._pipe_closed or self._woken:
                return
            self._woken = True
            try:
                os.write(self._tx, b"\0")
            except (BlockingIOError, OSError):
                pass

    def adopt(self, sock: socket.socket) -> None:
        if not self.post(lambda: self._register(sock)):
            # accepted during the stop window onto a torn-down shard: the
            # _register closure will never run — close instead of leaking
            # the fd and hanging the client
            try:
                sock.close()
            except OSError:
                pass

    # -- loop ------------------------------------------------------------------

    def run(self) -> None:
        # loop-lag tick: how late each pass through select() fires vs the
        # _LAG_TICK deadline. An idle shard observes ~0; a shard pinned in
        # one pass (flushing a burst, a huge parse) records the stall.
        next_tick = time.monotonic() + _LAG_TICK
        while not self.server.stopping.is_set():
            now = time.monotonic()
            if now >= next_tick:
                self._lag.observe((now - next_tick) * 1e3)
                next_tick = now + _LAG_TICK
            for key, events in self.sel.select(
                    timeout=min(_LAG_TICK, max(0.0, next_tick - now))):
                if key.data is None:  # wake pipe
                    try:
                        os.read(self._rx, 4096)
                    except OSError:
                        pass
                    with self._lock:
                        self._woken = False
                        todo = list(self._inbox)
                        self._inbox.clear()
                    for fn in todo:
                        try:
                            fn()
                        except Exception:
                            pass  # a closure's errors end at its conn; the
                            # shard must outlive any one connection
                    continue
                conn: _Conn = key.data
                try:
                    if events & selectors.EVENT_WRITE:
                        self._flush(conn)
                    if events & selectors.EVENT_READ and not conn.closed:
                        self._readable(conn)
                except Exception:
                    # any unexpected per-connection error (e.g. a failed
                    # stage-buffer allocation) is conn-fatal, never
                    # shard-fatal: a dead shard thread would orphan every
                    # conn it owns AND everything the acceptor keeps dealing
                    self._close(conn)
        self._teardown()

    def _teardown(self) -> None:
        for conn in list(self.conns.values()):
            self._close(conn)
        try:
            self.sel.unregister(self._rx)
        except (KeyError, ValueError):
            pass
        with self._lock:
            self._pipe_closed = True
            os.close(self._rx)
            os.close(self._tx)
        self.sel.close()

    def _register(self, sock: socket.socket) -> None:
        try:
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            framer = self.server.framer_factory()
            if hasattr(framer, "on_connect"):
                # variable-length protocols want per-conn identity (the HTTP
                # framer stamps each request with the peer address)
                framer.on_connect(sock)
            conn = _Conn(sock, framer)
            conn.arm_stage()
            conn.events = selectors.EVENT_READ
            self.sel.register(sock, conn.events, conn)
        except (OSError, ValueError):
            try:
                sock.close()
            except OSError:
                pass
            return
        self.conns[conn.fd] = conn
        self._gauge.set(len(self.conns))

    def _set_events(self, conn: _Conn, events: int) -> None:
        if conn.closed or events == conn.events:
            return
        prev, conn.events = conn.events, events
        try:
            if not events:
                # fully paused with nothing to write: deregister rather than
                # poll EVENT_WRITE on an always-writable socket
                self.sel.unregister(conn.sock)
            elif not prev:
                self.sel.register(conn.sock, events, conn)
            else:
                self.sel.modify(conn.sock, events, conn)
        except (KeyError, ValueError, OSError):
            self._close(conn)

    def _close(self, conn: _Conn) -> None:
        # conn state is shared with workers (send/_drain check closed and
        # mutate the queues under the shard lock); mutate it under the same
        # lock so a racing worker can't pop from a cleared inbox or park
        # reply bytes on a dead conn
        with self._lock:
            if conn.closed:
                return
            conn.closed = True
            conn.wq.clear()
            conn.wq_bytes = 0
            conn.inbox.clear()
            conn.inbox_bytes = 0
        self.conns.pop(conn.fd, None)
        try:
            self.sel.unregister(conn.sock)
        except (KeyError, ValueError, OSError):
            pass
        try:
            conn.sock.close()
        except OSError:
            pass
        self._gauge.set(len(self.conns))

    # -- read side -------------------------------------------------------------

    # per-wakeup read budget: a firehose sender on one connection yields the
    # shard back to its neighbors every budget's worth; the level-triggered
    # selector re-reports the remainder immediately
    _READ_BUDGET = 1 << 20

    def _readable(self, conn: _Conn) -> None:
        if conn.greedy:
            return self._readable_greedy(conn)
        consumed = 0
        while consumed < self._READ_BUDGET and not conn.paused \
                and not conn.closed:
            if conn.got < len(conn.buf):
                try:
                    n = conn.sock.recv_into(conn.view[conn.got:])
                except (BlockingIOError, InterruptedError):
                    return
                except OSError:
                    self._close(conn)
                    return
                if n == 0:  # peer closed
                    self._close(conn)
                    return
                conn.got += n
                consumed += n
                if conn.got < len(conn.buf):
                    return  # partial stage: resume on the next EVENT_READ
            try:
                msg = conn.framer.feed(conn.buf)
            except Exception:
                self._close(conn)  # bad magic/frame: hostile or corrupt
                return
            conn.msg_bytes += len(conn.buf)
            conn.arm_stage()
            if msg is None:
                continue
            nbytes, conn.msg_bytes = conn.msg_bytes, 0
            self._enqueue(conn, msg, nbytes)

    def _readable_greedy(self, conn: _Conn) -> None:
        """Read side for greedy (variable-length) framers: recv into the
        fixed scratch buffer and hand the framer whatever arrived; it
        buffers internally (bounded — an oversized header block is ITS
        error) and returns every message the chunk completed, so one recv
        can surface a whole pipelined burst."""
        consumed = 0
        while consumed < self._READ_BUDGET and not conn.paused \
                and not conn.closed and not conn.close_after:
            try:
                n = conn.sock.recv_into(conn.view)
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                self._close(conn)
                return
            if n == 0:  # peer closed
                self._close(conn)
                return
            consumed += n
            try:
                msgs = conn.framer.feed_chunk(conn.view[:n])
            except Exception:
                self._close(conn)  # hostile or corrupt framing
                return
            for msg, nbytes in msgs:
                self._enqueue(conn, msg, nbytes)
            if n < len(conn.buf):
                return  # socket drained for now

    def _enqueue(self, conn: _Conn, msg, nbytes: int) -> None:
        """Park a parsed message for dispatch (shared by both read paths)."""
        newly_paused = False
        with self._lock:
            conn.inbox.append((msg, nbytes))
            conn.inbox_bytes += nbytes
            if conn.inbox_bytes > self.server.write_hwm \
                    and not conn.paused:
                # fast sender, slow handler: parsed requests are piling
                # up — stop READING so the flood stays in the kernel
                # socket buffer (TCP backpressure to the peer), like the
                # threaded path's one-recv-per-dispatch loop bounded it.
                # paused flips INSIDE the append's critical section: a
                # worker popping this very message must observe it, or
                # its low-water resume check can race the pause and
                # leave the conn read-paused forever
                conn.paused = True
                newly_paused = True
            start = not conn.dispatching
            if start:
                conn.dispatching = True
        if start:
            self.server.workers.submit(lambda c=conn: self._drain(c))
        if newly_paused:
            self._bp.add()
            self._emit_bp("backpressure_on", "inbox")
            self._set_events(conn, conn.events & ~selectors.EVENT_READ)

    # -- dispatch (worker threads) --------------------------------------------

    def _drain(self, conn: _Conn) -> None:
        """Serial per-connection dispatch: pop → handle → queue reply, until
        the inbox is empty. Runs on a worker thread; in-order replies fall
        out of the single-drainer-per-conn invariant."""
        while True:
            with self._lock:
                if not conn.inbox or conn.closed:
                    conn.dispatching = False
                    return
                msg, nbytes = conn.inbox.popleft()
                conn.inbox_bytes -= nbytes
                resume = conn.paused and \
                    conn.inbox_bytes <= self.server.write_hwm // 2
            if resume:
                # paused reads may be waiting on THIS drain (inbox pressure);
                # the loop thread re-checks both watermarks before resuming
                self.post(lambda c=conn: self._maybe_resume(c))
            t0 = time.perf_counter()
            try:
                chaos.failpoint("evloop.dispatch")
                reply = self.server.on_message(msg)
                self.server.dispatch_tp.observe(time.perf_counter() - t0)
                if reply is not None:
                    whole = self.send(conn, self.server.encode(reply),
                                      close_after=self.server.close_reply(reply))
                    if whole and self.server.on_sent is not None:
                        self.server.sent(reply)
            except Exception:
                # a handler- OR encode-escaping error is conn-fatal (the
                # threaded path's serve thread died the same way); an error
                # swallowed with dispatching still True would wedge the conn
                self.post(lambda c=conn: self._close(c))
                with self._lock:
                    conn.dispatching = False
                return

    # -- write side ------------------------------------------------------------

    def send(self, conn: _Conn, iov: list, close_after: bool = False) -> bool:
        """Send an iovec on `conn` (worker-thread safe). Fast path: when the
        write queue is empty — no flush in flight, ordering is ours — try a
        direct non-blocking `sendmsg` right here under the shard lock. Most
        replies fit the kernel buffer whole, so the common case skips the
        wake-pipe → select → flush round trip entirely AND spreads the send
        syscalls over the worker pool instead of serializing them through
        the loop thread. Any remainder (EAGAIN/partial) is queued and the
        loop finishes it under EVENT_WRITE, same as the slow path.

        `close_after` tears the connection down once THIS iov is fully on
        the wire (HTTP `Connection: close`): reads stop immediately, the
        close itself waits for the flush. Returns True when the direct send
        put the whole iov on the wire, False when any of it was queued."""
        total = sum(len(b) for b in iov)
        views = [memoryview(b) for b in iov]
        action = None
        done = False
        with self._lock:
            if conn.closed:
                return False
            if close_after:
                conn.close_after = True
            if not conn.wq and hasattr(conn.sock, "sendmsg"):
                try:
                    sent = conn.sock.sendmsg(views)
                except (BlockingIOError, InterruptedError):
                    sent = 0
                except OSError:
                    action = "close"
                    sent = total  # nothing left worth queuing
                if sent < total:
                    rest = advance_iov(views, sent)
                    conn.wq.extend(rest)
                    conn.wq_bytes += sum(len(v) for v in rest)
                    action = action or "flush"
                else:
                    done = action is None
                    if conn.close_after and action is None:
                        action = "close"  # reply fully on the wire: tear down now
            else:
                conn.wq.extend(views)
                conn.wq_bytes += total
                action = "flush"
        # post() takes the shard lock itself, so both follow-ups run after it
        if action == "flush":
            self.post(lambda c=conn: self._after_send(c))
        elif action == "close":
            self.post(lambda c=conn: self._close(c))
        return done

    def _after_send(self, conn: _Conn) -> None:
        if conn.closed:
            return
        self._flush(conn)
        if conn.wq_bytes > self.server.write_hwm and not conn.paused:
            # slow reader: its replies pile up — stop READING from it so the
            # pipeline quits growing, keep draining what's queued. Neighbors
            # on this shard never notice.
            conn.paused = True
            self._bp.add()
            self._emit_bp("backpressure_on", "write_queue")
            self._set_events(conn, selectors.EVENT_WRITE)

    def _flush(self, conn: _Conn) -> None:
        try:
            while conn.wq:
                with self._lock:
                    batch = list(islice(conn.wq, 64))
                try:
                    sent = conn.sock.sendmsg(batch) if hasattr(conn.sock, "sendmsg") \
                        else conn.sock.send(batch[0])
                except (BlockingIOError, InterruptedError):
                    break
                with self._lock:
                    if conn.closed:
                        return
                    conn.wq_bytes -= sent
                    # the loop thread is the only popper and direct sends
                    # only run on an EMPTY queue, so `batch` is still the
                    # exact head of wq: replace it with its unsent remainder
                    rest = advance_iov(batch, sent)
                    for _ in range(len(batch)):
                        conn.wq.popleft()
                    conn.wq.extendleft(reversed(rest))
        except OSError:
            self._close(conn)
            return
        if conn.wq:
            self._set_events(conn, conn.events | selectors.EVENT_WRITE)
        else:
            if conn.close_after:
                # the Connection: close reply is fully flushed — teardown
                self._close(conn)
                return
            self._set_events(conn, conn.events & ~selectors.EVENT_WRITE)
        self._maybe_resume(conn)

    def _maybe_resume(self, conn: _Conn) -> None:
        """Loop-thread re-arm of reads once BOTH watermarks (reply queue and
        parsed-request inbox) are below half — the low-water side of the
        high/low hysteresis."""
        if conn.closed or not conn.paused or conn.close_after:
            return
        with self._lock:
            low = conn.wq_bytes <= self.server.write_hwm // 2 \
                and conn.inbox_bytes <= self.server.write_hwm // 2
        if low:
            conn.paused = False
            self._emit_bp("backpressure_off", "low_water")
            self._set_events(conn, conn.events | selectors.EVENT_READ)

    def _emit_bp(self, etype: str, reason: str) -> None:
        """Backpressure engage/release -> timeline. A TRANSITION record (the
        hysteresis means one flip pair per pressure episode per conn, not
        per op); emit() never raises, so the loop/worker paths stay safe."""
        from chubaofs_tpu_torch.utils import events

        events.emit(etype,
                    events.SEV_WARNING if etype == "backpressure_on"
                    else events.SEV_INFO,
                    entity=f"{self.server.name}/shard{self.idx}",
                    detail={"srv": self.server.name, "shard": self.idx,
                            "reason": reason})


class EvloopServer:
    """The server core: acceptor + shards + workers around an accepted-socket
    handler. `on_message(msg)` runs on a worker thread (blocking is fine) and
    returns a reply to encode, or None for fire-and-forget protocols.

    Defaults serve the shared binary Packet protocol (framer_factory =
    PacketFramer, encode = packet_iov); the raft transport passes its own
    frame reader and encode=None."""

    def __init__(self, listener: socket.socket, on_message, *,
                 name: str = "pkt", framer_factory=PacketFramer,
                 encode=packet_iov, shards: int | None = None,
                 workers: int | None = None, write_hwm: int | None = None,
                 close_reply=None, on_sent=None):
        self.listener = listener
        self.on_message = on_message
        self.name = name
        self.framer_factory = framer_factory
        self.encode = encode or (lambda reply: [reply])
        # does THIS reply end its connection? (HTTP Connection: close); the
        # packet protocols never do — every conn outlives every reply
        self.close_reply = close_reply or (lambda reply: False)
        # on_sent(reply), given, runs on the worker whose direct send put the
        # whole reply on the wire; a reply that had to queue for a flush is
        # not reported
        self.on_sent = on_sent
        self.reg = registry("evloop")
        self.dispatch_tp = self.reg.summary("dispatch", {"srv": name})
        self.write_hwm = write_hwm if write_hwm is not None \
            else _env_int("CFS_EVLOOP_WRITEBUF", _WRITE_HWM)
        self.stopping = threading.Event()
        self.instance = next(_INSTANCE_IDS)  # disambiguates same-name
        # servers sharing this process's metric registry
        n_shards = shards or _env_int("CFS_EVLOOP_SHARDS", 2)
        n_workers = workers or _env_int("CFS_EVLOOP_WORKERS", 16)
        self.workers = _Workers(n_workers, name)
        self.shards = [_LoopShard(self, i) for i in range(n_shards)]
        self._next = 0
        self._accept_thread = threading.Thread(
            target=self._accept, daemon=True, name=f"evloop-{name}-accept")

    def sent(self, reply) -> None:
        try:
            self.on_sent(reply)
        except Exception:
            pass  # the hook's failure must never fail the connection

    def start(self) -> None:
        for s in self.shards:
            s.start()
        self._accept_thread.start()

    def _accept(self) -> None:
        while not self.stopping.is_set():
            try:
                sock, _ = self.listener.accept()
            except OSError:
                return
            self.shards[self._next % len(self.shards)].adopt(sock)
            self._next += 1

    def stop(self) -> None:
        """Stop accepting, close every connection, release the workers. The
        caller owns (and closes) the listener, same as the threaded path."""
        self.stopping.set()
        for s in self.shards:
            s.wake()  # not post(): post refuses once stopping is set, and a
            # sleeping shard must still see the flag now, not a select
            # timeout later
        self.workers.stop()
        for s in self.shards:
            s.join(timeout=2.0)
            # a closed server's series must not render as a live idle shard
            self.reg.unregister("conns", s.gauge_labels)
