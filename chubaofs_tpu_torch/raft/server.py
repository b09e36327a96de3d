"""MultiRaft server — hosts many raft groups per node over one transport.

Reference counterpart: raftstore/raftstore.go:34-41 (RaftStore facade),
depends/tiglabs/raft/server.go:65 (NewRaftServer, many groups, merged
heartbeats). One MultiRaft instance per node hosts every partition's group:
master GroupID=1, one group per meta partition, one per random-write data
partition — same multiplexing the reference uses.

The transport is pluggable; InProcNet wires nodes in one process (the test
strategy of SURVEY §4) and batches per-destination messages the way tiglabs
merges heartbeats across groups. WAL persistence: term/vote + entries per
group as JSONL; snapshots delegate to the StateMachine and compact the log.

Group commit (raft.go:283-311 parity): `propose`/`propose_batch` ENQUEUE onto
the group's pending queue and WAKE the node's drain pump — the reference's
proposal-channel + run-goroutine shape. The pump drains the queue under the
node lock: one log-append pass, one WAL write+flush, and one AppendEntries
fan-out for the whole drained batch, so N concurrent clients coalesce into
~1 replication round instead of N. A proposer-inline drain would NOT batch
under the GIL (the first proposer runs its whole commit round before the
others get scheduled — measured 0.6x at 64 proposers, not 5x), so the pump
adds a sub-millisecond gather window, armed only while drains actually
batch, and keeps single-proposer latency at plain thread-handoff cost. The
tick pump drains too, as the safety net that fails stranded futures after
leadership loss.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from concurrent.futures import Future

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.utils.locks import SanitizedLock, SanitizedRLock
from chubaofs_tpu_torch.raft import codec
from chubaofs_tpu_torch.raft.core import Entry, Msg, NotLeaderError, RaftCore, ROLE_LEADER


class StateMachine:
    """What a replicated component implements (statemachine.go:23-30 analog)."""

    def apply(self, data, index: int):  # -> result delivered to the proposer
        raise NotImplementedError

    def snapshot(self) -> bytes:
        raise NotImplementedError

    def restore(self, data: bytes) -> None:
        raise NotImplementedError

    def on_leader_change(self, leader: int | None) -> None:
        pass


class InProcNet:
    """In-process transport connecting MultiRaft nodes; per-dst batching."""

    def __init__(self):
        self.nodes: dict[int, "MultiRaft"] = {}
        self.partitions: set[frozenset] = set()  # simulated network partitions
        self._lock = SanitizedLock(name="raft.net")

    def register(self, node: "MultiRaft"):
        with self._lock:
            self.nodes[node.node_id] = node

    def isolate(self, *node_ids: int):
        """Cut node_ids off from everyone else (fault injection)."""
        with self._lock:
            self.partitions.add(frozenset(node_ids))

    def heal(self):
        with self._lock:
            self.partitions.clear()

    def _blocked(self, a: int, b: int) -> bool:
        for part in self.partitions:
            if (a in part) != (b in part):
                return True
        return False

    def send(self, msgs: list[Msg]):
        by_dst: dict[int, list[Msg]] = {}
        for m in msgs:
            if self._blocked(m.src, m.dst):
                continue
            by_dst.setdefault(m.dst, []).append(m)
        for dst, batch in by_dst.items():
            try:
                # same site TcpNet exposes: injected link loss drops the whole
                # per-destination frame; raft re-sends via the next tick
                chaos.failpoint("raft.send", node=batch[0].src)
            except chaos.FailpointError:
                continue
            node = self.nodes.get(dst)
            if node is not None:
                node.deliver(batch)


# cache an entry's WAL encoding only when small: in-proc replicas share the
# Entry, so one encode serves all three logs — but pinning a hex copy of a
# 64 KiB datanode payload for the entry's whole uncompacted life is a worse
# trade than re-encoding it per replica
_WAL_HEX_CACHE_MAX = 1 << 13


def _ent_blob(ent: Entry) -> str:
    blob = ent.wal_hex
    if blob is None:
        blob = codec.dumps(ent.data).hex() if ent.data is not None else ""
        if len(blob) <= _WAL_HEX_CACHE_MAX:
            ent.wal_hex = blob
    return blob


class _Group:
    def __init__(self, core: RaftCore, sm: StateMachine, wal_path: str | None):
        self.core = core
        self.sm = sm
        self.wal_path = wal_path
        self.wal = None
        self.waiters: dict[int, tuple[int, Future]] = {}  # index -> (term, future)
        # group commit: futures FIFO-parallel to core.pending — both only
        # mutated under pending_lock, so queue order IS future order
        self.pending_lock = SanitizedLock(name="raft.pending")
        self.pending_futs: deque[Future] = deque()
        self.last_leader: int | None = None
        if wal_path:
            self._recover()
            self.wal = open(wal_path, "a")

    def _recover(self):
        snap_path = self.wal_path + ".snap"
        if os.path.exists(snap_path):
            with open(snap_path, "rb") as f:
                meta_len = int.from_bytes(f.read(4), "little")
                meta = json.loads(f.read(meta_len))
                payload = f.read()
            self.sm.restore(payload)
            self.core.offset = meta["index"]
            self.core.offset_term = meta["term"]
            self.core.commit = self.core.applied = meta["index"]
            if "peers" in meta:
                self.core.peers = [p for p in meta["peers"] if p != self.core.id]
        if os.path.exists(self.wal_path):
            with open(self.wal_path) as f:
                for line in f:
                    if not line.strip():
                        continue
                    rec = json.loads(line)
                    if rec[0] == "hs":  # hard state
                        self.core.term, self.core.voted_for = rec[1], rec[2]
                    elif rec[0] in ("ent", "entb"):
                        # "ent": one [idx, term, blob]; "entb": a whole drained
                        # batch [[idx, term, blob], ...] in ONE record (group
                        # commit writes + flushes once per batch)
                        ents = [rec[1:]] if rec[0] == "ent" else rec[1]
                        for idx, term, blob in ents:
                            if idx <= self.core.offset:
                                continue
                            # truncate conflicts in place, then append (a
                            # per-record whole-list copy makes replay O(n^2))
                            if idx <= self.core.last_index:
                                del self.core.entries[idx - self.core.offset - 1:]
                            try:
                                data = codec.loads(bytes.fromhex(blob)) if blob else None
                            except codec.CodecError:
                                raise RuntimeError(
                                    f"{self.wal_path}: WAL entry is not in the "
                                    "current (codec) format — this walDir was "
                                    "written by an incompatible build; move it "
                                    "aside to start fresh") from None
                            self.core.entries.append(Entry(term, data))
                    elif rec[0] == "commit":
                        idx = min(rec[1], self.core.last_index)
                        self.core.commit = max(self.core.commit, idx)
            # replay committed entries into the SM (config changes re-apply to
            # the core so the recovered membership matches pre-crash)
            for idx in range(self.core.offset + 1, self.core.commit + 1):
                ent = self.core.entry_at(idx)
                if ent.data is None:
                    continue
                if (isinstance(ent.data, tuple) and len(ent.data) == 3
                        and ent.data[0] == "__config_change__"):
                    self.core.apply_config(ent.data[1], ent.data[2])
                    continue
                self.sm.apply(ent.data, idx)
            self.core.applied = self.core.commit

    def persist(self, hard_state_changed: bool, new_entries: list[tuple[int, Entry]], commit: int):
        """Batched WAL append: the whole drained batch lands as ONE "entb"
        record in ONE write + ONE flush (group commit's durability half —
        the per-entry write/flush was most of the unbatched commit cost)."""
        if not self.wal:
            return
        recs = []
        if hard_state_changed:
            recs.append(json.dumps(["hs", self.core.term, self.core.voted_for]))
        if new_entries:
            recs.append(json.dumps(["entb", [
                [idx, ent.term, _ent_blob(ent)] for idx, ent in new_entries]]))
        recs.append(json.dumps(["commit", commit]))
        self.wal.write("\n".join(recs) + "\n")
        self.wal.flush()

    def take_snapshot(self):
        """Snapshot the SM at applied index and compact the log."""
        if not self.wal_path:
            self.core.compact(self.core.applied, self.core.term_at(self.core.applied))
            return
        idx = self.core.applied
        term = self.core.term_at(idx)
        payload = self.sm.snapshot()
        # membership travels with the snapshot: config entries before the
        # compaction point are gone from the log
        meta = json.dumps({"index": idx, "term": term,
                           "peers": list(self.core.peers)}).encode()
        tmp = self.wal_path + ".snap.tmp"
        with open(tmp, "wb") as f:
            f.write(len(meta).to_bytes(4, "little") + meta + payload)
        os.replace(tmp, self.wal_path + ".snap")
        self.core.compact(idx, term)
        self.wal.close()
        self.wal = open(self.wal_path, "w")
        self.wal.write(json.dumps(["hs", self.core.term, self.core.voted_for]) + "\n")
        for i in range(self.core.offset + 1, self.core.last_index + 1):
            ent = self.core.entry_at(i)
            self.wal.write(json.dumps(["ent", i, ent.term, _ent_blob(ent)]) + "\n")
        self.wal.write(json.dumps(["commit", self.core.commit]) + "\n")
        self.wal.flush()


class MultiRaft:
    """All raft groups of one node + the tick/apply pump."""

    # gather window armed once drains start batching: proposals arriving
    # inside it ride the same commit round (group commit); zero while the
    # node sees only sequential proposers, so their latency stays handoff-only
    GROUP_WINDOW = float(os.environ.get("CFS_RAFT_GROUP_WINDOW_MS", "0.5")) / 1e3

    def __init__(self, node_id: int, net: InProcNet, wal_dir: str | None = None,
                 snapshot_every: int = 0):
        self.node_id = node_id
        self.net = net
        self.wal_dir = wal_dir
        self.snapshot_every = snapshot_every
        self.groups: dict[int, _Group] = {}
        # per-node name: tick/deliver must NEVER hold two node locks at once
        # (delivery acquires the destination's), and distinct names let the
        # sanitizer prove it — a nodeA->nodeB + nodeB->nodeA edge pair is the
        # deadlock this file's send-outside-the-lock discipline prevents
        self._lock = SanitizedRLock(name=f"raft.node{node_id}")
        # proposal pump: proposers enqueue + wake; the pump drains (the
        # reference's propose-channel/run-goroutine split). Lazy: nodes that
        # never see a proposal never spawn the thread.
        self._prop_wake = threading.Event()
        self._dirty: deque[_Group] = deque()
        self._pump_started = False
        self._pump_lock = SanitizedLock(name="raft.pumpstart")
        self.pump_dead = False  # a drain crash poisons the node: fail fast
        # group-commit observability. The role registry (cfs_raft_*) is the
        # primary surface — counters + a batch-occupancy histogram rendered
        # by every daemon's /metrics; drain_stats stays as the legacy dict
        # view (perfbench resets/reads it), updated only under _stats_lock
        # so readers can take a consistent snapshot.
        self.drain_stats = {"rounds": 0, "entries": 0, "max_batch": 0}
        self._stats_lock = SanitizedLock(name="raft.stats")
        net.register(self)

    # -- group lifecycle -----------------------------------------------------

    def create_group(self, group_id: int, peers: list[int], sm: StateMachine) -> None:
        with self._lock:
            core = RaftCore(group_id, self.node_id, peers)
            wal_path = None
            if self.wal_dir:
                os.makedirs(self.wal_dir, exist_ok=True)
                wal_path = os.path.join(self.wal_dir, f"g{group_id}.wal")
            g = _Group(core, sm, wal_path)

            def snap_fn():
                payload = sm.snapshot()
                return core.applied, core.term_at(core.applied), payload

            core.snapshot_fn = snap_fn
            self.groups[group_id] = g

    def remove_group(self, group_id: int) -> None:
        with self._lock:
            self.groups.pop(group_id, None)

    def is_leader(self, group_id: int) -> bool:
        g = self.groups.get(group_id)
        return g is not None and g.core.role == ROLE_LEADER

    def leader_of(self, group_id: int) -> int | None:
        g = self.groups.get(group_id)
        return g.core.leader if g else None

    # -- the pump ------------------------------------------------------------

    def tick(self):
        """One logical clock tick for every group; flush I/O.

        Quiescent leaders' liveness beats are MERGED: one group_hb message per
        peer carries every group's (term, commit) slice, so heartbeat traffic
        scales with peers, not partitions (tiglabs raft README:18).

        Outbound messages are sent AFTER the node lock is released: delivery
        acquires the destination node's lock, and holding two node locks at
        once would deadlock concurrent datanode/metanode handler threads."""
        out: list[Msg] = []
        merged: dict[int, list] = {}  # dst -> [[gid, term, commit], ...]
        with self._lock:
            for gid, g in self.groups.items():
                if not self.pump_dead and (g.core.pending or g.pending_futs):
                    # drain stragglers (and fail stranded futures after a
                    # leadership loss) — proposers normally drain on wakeup;
                    # a dead pump means a poisoned mid-round state, so the
                    # safety net must not keep committing on top of it
                    out += self._drain_pending(g)
                term0, vote0 = g.core.term, g.core.voted_for
                last0, commit0 = g.core.last_index, g.core.commit
                g.core.tick()
                for p in g.core.pending_hb:
                    merged.setdefault(p, []).append([gid, g.core.term, g.core.commit])
                g.core.pending_hb.clear()
                out += self._flush(g, term0, vote0, last0, commit0)
        for dst, slices in merged.items():
            out.append(Msg(type="group_hb", group=0, src=self.node_id, dst=dst,
                           term=0, hb=slices))
        if out:
            self.net.send(out)

    def deliver(self, msgs: list[Msg]):
        out: list[Msg] = []
        with self._lock:
            for m in msgs:
                if m.type == "group_hb":
                    out += self._on_group_hb(m)
                    continue
                if m.type == "group_hb_resp":
                    out += self._on_group_hb_resp(m)
                    continue
                g = self.groups.get(m.group)
                if g is None:
                    continue
                term0, vote0 = g.core.term, g.core.voted_for
                last0, commit0 = g.core.last_index, g.core.commit
                g.core.step(m)
                out += self._flush(g, term0, vote0, last0, commit0)
        if out:
            self.net.send(out)

    def _on_group_hb(self, m: Msg) -> list[Msg]:
        """Fan a merged heartbeat into each group; stale sender terms ride
        back in ONE merged response."""
        out: list[Msg] = []
        stale: list = []
        for gid, term, commit in m.hb:
            g = self.groups.get(gid)
            if g is None:
                continue
            term0, vote0 = g.core.term, g.core.voted_for
            last0, commit0 = g.core.last_index, g.core.commit
            ok = g.core.step_group_hb(m.src, term, commit)
            out += self._flush(g, term0, vote0, last0, commit0)
            if not ok:
                stale.append([gid, g.core.term])
        if stale:
            out.append(Msg(type="group_hb_resp", group=0, src=self.node_id,
                           dst=m.src, term=0, hb=stale))
        return out

    def _on_group_hb_resp(self, m: Msg) -> list[Msg]:
        """A peer saw a higher term for these groups: step down there."""
        out: list[Msg] = []
        for gid, term in m.hb:
            g = self.groups.get(gid)
            if g is None or term <= g.core.term:
                continue
            term0, vote0 = g.core.term, g.core.voted_for
            last0, commit0 = g.core.last_index, g.core.commit
            g.core._become_follower(term, None)
            out += self._flush(g, term0, vote0, last0, commit0)
        return out

    def _flush(self, g: _Group, term0: int, vote0, last0: int, commit0: int) -> list[Msg]:
        core = g.core
        msgs, committed = core.ready()
        # a conflicting append may have OVERWRITTEN entries below last0: the
        # rewritten span must reach the WAL too (its record truncates the
        # stale-term suffix at replay), or recovery replays the old entries
        start = max(last0, core.offset) + 1
        if core.log_rewind is not None:
            start = min(start, max(core.log_rewind, core.offset + 1))
            core.log_rewind = None
        new_entries = [
            (i, core.entry_at(i))
            for i in range(start, core.last_index + 1)
        ]
        hs_changed = core.term != term0 or core.voted_for != vote0
        if hs_changed or new_entries or core.commit != commit0:
            g.persist(hs_changed, new_entries, core.commit)
            if new_entries:
                # the crash window between the batched WAL append and the
                # apply pass below — chaos tests prove a restart here replays
                # every drained entry exactly once (no loss, no double apply)
                chaos.failpoint("raft.drain", node=self.node_id)
        for idx, ent in committed:
            if isinstance(ent.data, tuple) and len(ent.data) == 2 and ent.data[0] == "__install_snapshot__":
                g.sm.restore(ent.data[1])
                continue
            if (isinstance(ent.data, tuple) and len(ent.data) == 3
                    and ent.data[0] == "__config_change__"):
                g.core.apply_config(ent.data[1], ent.data[2])
                waiter = g.waiters.pop(idx, None)
                if waiter and ent.term == waiter[0]:
                    waiter[1].set_result(sorted(g.core.peers + [g.core.id]))
                continue
            result = g.sm.apply(ent.data, idx) if ent.data is not None else None
            waiter = g.waiters.pop(idx, None)
            if waiter:
                wterm, fut = waiter
                if ent.term == wterm:
                    fut.set_result(result)
                else:
                    fut.set_exception(NotLeaderError(core.leader))
        if g.last_leader != core.leader:
            g.last_leader = core.leader
            g.sm.on_leader_change(core.leader)
        if (
            self.snapshot_every
            and core.applied - core.offset >= self.snapshot_every
        ):
            g.take_snapshot()
        return msgs

    # -- client API ------------------------------------------------------------

    def propose_config(self, group_id: int, action: str, node_id: int) -> Future:
        """Single-server membership change ('add'/'remove' one node); the
        future resolves with the new peer set once the change commits."""
        assert action in ("add", "remove"), action
        return self.propose(group_id, ("__config_change__", action, node_id))

    def propose(self, group_id: int, data) -> Future:
        """Replicate one command; future resolves with sm.apply's result.
        Rides the group-commit path: concurrent proposers coalesce into one
        WAL flush + one replication round per drained batch."""
        return self.propose_batch(group_id, [data])[0]

    def propose_batch(self, group_id: int, datas: list) -> list[Future]:
        """Replicate a FIFO batch of commands; one future per command, each
        resolving with its own sm.apply result (an entry rejected by a
        leadership change fails only its own future). Raises NotLeaderError
        synchronously when this node is not the group's leader."""
        g = self.groups.get(group_id)
        if g is None:
            raise KeyError(f"no group {group_id} on node {self.node_id}")
        if self.pump_dead:
            raise RuntimeError(
                f"raft drain pump died on node {self.node_id} "
                "(see stderr traceback); restart the node to recover")
        futs: list[Future] = []
        with g.pending_lock:
            if g.core.role != ROLE_LEADER:
                raise NotLeaderError(g.core.leader)
            for data in datas:
                g.core.pending.append(data)
                fut: Future = Future()
                g.pending_futs.append(fut)
                futs.append(fut)
        # NOTE on tracing: the "raft:<ms>" track entry is appended by the
        # WAITER thread after future.result() (metanode submit_sync, the
        # datanode random-write handler) — a done-callback here would race
        # the waiter's span.finish()/reply construction and drop the entry
        # nondeterministically (Future runs callbacks after waking waiters).
        self._dirty.append(g)
        self._ensure_pump()
        self._prop_wake.set()
        return futs

    def _ensure_pump(self):
        if self._pump_started:
            return
        with self._pump_lock:
            if self._pump_started:
                return
            t = threading.Thread(target=self._pump, daemon=True,
                                 name=f"raft-drain-{self.node_id}")
            t.start()
            self._pump_started = True

    def _pump(self):
        """Drain pump: wake -> (gather window while batching) -> drain every
        dirty group -> send. One WAL flush + one fan-out per drained batch.

        A drain failure mid-round (WAL I/O error, SM apply bug) leaves
        applied-tracking ahead of the state machine — continuing would
        silently diverge replicas. Die LOUDLY instead: later proposals fail
        fast with RuntimeError and a restart recovers from the WAL."""
        try:
            self._pump_loop()
        except BaseException:
            self.pump_dead = True
            raise

    def _pump_loop(self):
        window = 0.0
        while True:
            self._prop_wake.wait()
            self._prop_wake.clear()
            if window:
                time.sleep(window)  # let concurrent proposers pile in
            out: list[Msg] = []
            biggest = 0
            seen: set[int] = set()
            with self._lock:
                while True:
                    try:
                        g = self._dirty.popleft()
                    except IndexError:
                        break
                    if id(g) in seen:
                        continue
                    seen.add(id(g))
                    biggest = max(biggest, len(g.core.pending))
                    out += self._drain_pending(g)
            if out:
                self.net.send(out)
            window = self.GROUP_WINDOW if biggest > 1 else 0.0

    def _record_drain(self, batch: int) -> None:
        """One drained batch: bump the legacy dict (under its lock) and the
        raft role registry (drain counters + batch-size histogram)."""
        with self._stats_lock:
            st = self.drain_stats
            st["rounds"] += 1
            st["entries"] += batch
            st["max_batch"] = max(st["max_batch"], batch)
        try:
            from chubaofs_tpu_torch.utils.exporter import BATCH_BUCKETS, registry

            reg = registry("raft")
            reg.counter("drain_rounds_total").add()
            reg.counter("drain_entries_total").add(batch)
            reg.summary("drain_batch", buckets=BATCH_BUCKETS).observe(batch)
        except Exception:
            pass  # metrics must never poison the drain pump (pump_dead)

    def drain_stats_snapshot(self) -> dict:
        """Consistent copy of the legacy counters (no torn multi-field
        reads — rounds/entries/max_batch all from one instant)."""
        with self._stats_lock:
            return dict(self.drain_stats)

    def drain_stats_reset(self) -> None:
        """Zero the legacy counters under the lock (bench epochs); the
        registry counters stay cumulative, as counters must."""
        with self._stats_lock:
            self.drain_stats.update(rounds=0, entries=0, max_batch=0)

    def _drain_pending(self, g: _Group) -> list[Msg]:
        """Drain the group's pending proposals (held lock: self._lock). Each
        round is ONE core log-append of up to max_batch entries, ONE WAL
        write+flush, and ONE AppendEntries fan-out; the whole queue empties
        here, so a proposer blocked on the node lock usually finds its own
        entry already drained by whoever held it."""
        core = g.core
        out: list[Msg] = []
        while True:
            term0, vote0 = core.term, core.voted_for
            last0, commit0 = core.last_index, core.commit
            with g.pending_lock:
                if not core.pending and not g.pending_futs:
                    break
                try:
                    idxs = core.drain_proposals()
                except NotLeaderError as e:
                    core.pending.clear()
                    stranded = list(g.pending_futs)
                    g.pending_futs.clear()
                    for fut in stranded:
                        fut.set_exception(NotLeaderError(e.leader))
                    break
                if not idxs:
                    break  # queue raced empty: nothing left to drain
                self._record_drain(len(idxs))
                futs = [g.pending_futs.popleft() for _ in idxs]
                for idx, fut in zip(idxs, futs):
                    g.waiters[idx] = (core.term, fut)
            out += self._flush(g, term0, vote0, last0, commit0)
        return out


def run_until(net: InProcNet, cond, max_ticks: int = 300, sleep: float = 0.0) -> bool:
    """Drive every node's clock until cond() or tick budget exhausted (tests)."""
    for _ in range(max_ticks):
        for node in list(net.nodes.values()):
            node.tick()
        if cond():
            return True
        if sleep:
            time.sleep(sleep)
    return cond()


class TickLoop:
    """Background wall-clock pump for live deployments (100ms/tick default)."""

    def __init__(self, nodes: list[MultiRaft], interval: float = 0.1):
        self.nodes = nodes
        self.interval = interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True, name="raft-tick")

    def start(self):
        self._thread.start()

    def _run(self):
        while not self._stop.is_set():
            for n in self.nodes:
                n.tick()
            self._stop.wait(self.interval)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2)
