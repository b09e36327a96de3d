"""RaftCore — a deterministic, message-passing raft consensus core.

Reference counterpart: depends/tiglabs/raft (statemachine.go:23-30, server.go:65)
— the multi-raft engine under master, metanode, and datanode random-writes.
Design follows the etcd/tiglabs shape: a PURE state machine advanced by tick()
and step(msg), emitting messages and committed entries through ready(). No
threads, no clocks, no sockets in here — the server layer owns those — so every
consensus scenario (elections, splits, log repair, snapshot install) is unit
-testable deterministically, the way the reference tests multi-node logic with
in-process fakes (SURVEY §4).

Log model: 1-based indexes; entries list holds (term, payload) pairs starting at
`offset + 1` (offset = index of the last snapshot-compacted entry).

Group commit (the reference drain loop, raft.go:283-311): client proposals
accumulate in `pending` and `drain_proposals()` moves up to `max_batch` of
them into the log in ONE append pass followed by ONE AppendEntries fan-out —
so N concurrent proposers cost one replication round, not N. Replication is
pipelined per follower: `_send_append` advances next_index optimistically
(batch i+1 ships without waiting for ack i) under a bounded in-flight window;
NACKs and heartbeat probes rewind next_index, so message loss self-heals.
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

ROLE_FOLLOWER = "follower"
ROLE_CANDIDATE = "candidate"
ROLE_LEADER = "leader"

ELECTION_TICKS = 10  # randomized per-node in [E, 2E)
HEARTBEAT_TICKS = 2
# group-commit drain width (reference parity: raft.go:283-311 drains up to 64
# pending proposals into one log-append/replication round) and the per-follower
# pipelined-replication window (entries in flight past the last verified match)
MAX_BATCH = 64
MAX_INFLIGHT = 4 * MAX_BATCH


class NotLeaderError(Exception):
    def __init__(self, leader: int | None):
        super().__init__(f"not leader; leader hint: {leader}")
        self.leader = leader


@dataclass
class Entry:
    term: int
    data: object  # opaque command; None for leader no-op barriers
    # cached codec-encoded payload for the WAL (filled by the first persist;
    # in-proc replicas share the Entry, so one encode serves all three logs)
    wal_hex: str | None = None


@dataclass
class Msg:
    type: str  # vote_req | vote_resp | append | append_resp | snap
    group: int
    src: int
    dst: int
    term: int
    # vote
    last_log_index: int = 0
    last_log_term: int = 0
    granted: bool = False
    # append
    prev_index: int = 0
    prev_term: int = 0
    entries: list[Entry] = field(default_factory=list)
    commit: int = 0
    success: bool = False
    match_index: int = 0
    # snapshot
    snap_index: int = 0
    snap_term: int = 0
    snap_data: bytes = b""
    # merged cross-group heartbeat (group_hb/group_hb_resp): [gid, term,
    # commit] triples / [gid, term] stale pairs — ONE message per peer pair
    # per tick regardless of group count (tiglabs raft README:18)
    hb: list = field(default_factory=list)


class RaftCore:
    def __init__(self, group: int, node_id: int, peers: list[int],
                 rng: random.Random | None = None, max_batch: int = MAX_BATCH):
        self.group = group
        self.id = node_id
        self.peers = [p for p in peers if p != node_id]
        self.rng = rng or random.Random(node_id * 7919 + group)
        self.max_batch = max_batch
        # group commit: queued client proposals awaiting a drain round; the
        # server owns the matching futures (FIFO, same enqueue order)
        self.pending: list = []

        # persistent state
        self.term = 0
        self.voted_for: int | None = None
        self.offset = 0  # last compacted index
        self.offset_term = 0
        self.entries: list[Entry] = []

        # volatile
        # lowest index whose entry was overwritten since the last WAL flush:
        # the server must re-persist from here, or recovery replays the
        # stale-term suffix a conflicting append truncated in memory
        self.log_rewind: int | None = None
        self.role = ROLE_FOLLOWER
        self.leader: int | None = None
        self.commit = 0
        self.applied = 0
        self.votes: set[int] = set()
        self.next_index: dict[int, int] = {}
        self.match_index: dict[int, int] = {}
        self.elapsed = 0
        self.election_timeout = self._rand_timeout()

        self._outbox: list[Msg] = []
        self._committed: list[tuple[int, Entry]] = []
        # set by the server when the sm can produce a snapshot for laggards
        self.snapshot_fn = None  # () -> (index, term, bytes)
        # peers due a liveness heartbeat this tick; the SERVER merges these
        # across groups into one group_hb per peer (tiglabs README:18)
        self.pending_hb: list[int] = []

    # -- helpers ------------------------------------------------------------

    def _rand_timeout(self) -> int:
        return ELECTION_TICKS + self.rng.randrange(ELECTION_TICKS)

    @property
    def last_index(self) -> int:
        return self.offset + len(self.entries)

    def term_at(self, index: int) -> int:
        if index == self.offset:
            return self.offset_term
        if index < self.offset or index > self.last_index:
            return -1
        return self.entries[index - self.offset - 1].term

    def entry_at(self, index: int) -> Entry:
        return self.entries[index - self.offset - 1]

    def _send(self, **kw):
        self._outbox.append(Msg(group=self.group, src=self.id, **kw))

    def quorum(self) -> int:
        return (len(self.peers) + 1) // 2 + 1

    # -- public: server drives these ----------------------------------------

    def tick(self):
        self.elapsed += 1
        if self.role == ROLE_LEADER:
            if self.elapsed >= HEARTBEAT_TICKS:
                self.elapsed = 0
                for p in self.peers:
                    # merged path only for peers whose match is VERIFIED (an
                    # append_resp proved the prefix); next_index alone can be
                    # optimistic (fresh members, post-election defaults)
                    if self.match_index.get(p, 0) < self.last_index:
                        # laggard/unverified: real replication traffic
                        self._send_append(p)
                    else:
                        # quiescent: liveness only — merged across groups by
                        # the server so 1,000 partitions != 1,000 messages
                        self.pending_hb.append(p)
        elif self.elapsed >= self.election_timeout:
            self._campaign()

    def step_group_hb(self, src: int, term: int, commit: int) -> bool:
        """One group's slice of a merged heartbeat. Returns False when the
        sender's term is stale (the server reports it back so the old leader
        steps down). Safe without a log-prefix check: a leader only puts a
        peer on the merged path once match_index == last_index, which an
        append_resp verified; any divergence since implies a higher term,
        caught here."""
        if term < self.term:
            return False
        if term > self.term:
            self._become_follower(term, src)
        self.role = ROLE_FOLLOWER
        self.leader = src
        self.elapsed = 0
        if commit > self.commit:
            self.commit = min(commit, self.last_index)
            self._emit_committed()
        return True

    def propose(self, data) -> int:
        return self.propose_batch([data])[-1]

    def propose_batch(self, datas: list) -> list[int]:
        """Queue + drain in one call: the whole batch lands in the log as one
        append pass and one AppendEntries fan-out (multiple drain rounds only
        past max_batch). Returns the assigned indexes, FIFO."""
        if self.role != ROLE_LEADER:
            raise NotLeaderError(self.leader)
        self.pending.extend(datas)
        out: list[int] = []
        while self.pending:
            out += self.drain_proposals()
        return out[-len(datas):]

    def queue_proposal(self, data) -> None:
        """Enqueue one proposal for the next drain round (group commit)."""
        if self.role != ROLE_LEADER:
            raise NotLeaderError(self.leader)
        self.pending.append(data)

    def drain_proposals(self) -> list[int]:
        """Move up to max_batch pending proposals into the log: ONE append
        pass, ONE replication fan-out (the raft.go:283-311 drain loop analog).
        Raises NotLeaderError — pending intact for the caller to fail — when
        leadership was lost between enqueue and drain."""
        if self.role != ROLE_LEADER:
            raise NotLeaderError(self.leader)
        batch = self.pending[: self.max_batch]
        if not batch:
            return []
        del self.pending[: len(batch)]
        first = self.last_index + 1
        for data in batch:
            self.entries.append(Entry(self.term, data))
        self.match_index[self.id] = self.last_index
        if not self.peers:  # single-node group commits immediately
            self._advance_commit()
        else:
            self._broadcast_append()
        return list(range(first, self.last_index + 1))

    # -- membership (single-server change: one add/remove per entry keeps any
    # two quorums overlapping, the standard safe reconfiguration) -------------

    def apply_config(self, action: str, node_id: int) -> None:
        """Run when a __config_change__ entry COMMITS, on every replica."""
        if action == "add" and node_id != self.id and node_id not in self.peers:
            self.peers.append(node_id)
            if self.role == ROLE_LEADER:
                self.next_index[node_id] = self.last_index + 1
                self.match_index[node_id] = 0
        elif action == "remove":
            if node_id == self.id:
                # removed from the group: stop campaigning/serving
                self.peers = []
                self.role = ROLE_FOLLOWER
                self.leader = None
                return
            if node_id in self.peers:  # racelint: RaftCore state is only touched under the owning MultiRaft node lock
                self.peers.remove(node_id)
                self.next_index.pop(node_id, None)
                self.match_index.pop(node_id, None)
                if self.role == ROLE_LEADER:
                    self._advance_commit()  # quorum may shrink past pending

    def step(self, m: Msg):
        if m.term > self.term:
            self._become_follower(m.term, m.src if m.type == "append" else None)
        handler = getattr(self, "_on_" + m.type)
        handler(m)

    def ready(self) -> tuple[list[Msg], list[tuple[int, Entry]]]:
        """Drain outgoing messages and newly committed entries."""
        out, self._outbox = self._outbox, []
        committed, self._committed = self._committed, []
        return out, committed

    def compact(self, index: int, term: int):
        """Drop log entries <= index (after the server snapshots the SM)."""
        if index <= self.offset:
            return
        keep = self.entries[index - self.offset :]
        self.offset, self.offset_term, self.entries = index, term, keep

    # -- roles ---------------------------------------------------------------

    def _become_follower(self, term: int, leader: int | None):
        self.term = term
        self.role = ROLE_FOLLOWER
        self.voted_for = None
        self.leader = leader
        self.votes.clear()
        self.elapsed = 0
        self.election_timeout = self._rand_timeout()

    def _campaign(self):
        self.role = ROLE_CANDIDATE
        self.term += 1
        self.voted_for = self.id
        self.votes = {self.id}
        self.leader = None
        self.elapsed = 0
        self.election_timeout = self._rand_timeout()
        if not self.peers:
            self._become_leader()
            return
        for p in self.peers:
            self._send(
                type="vote_req",
                dst=p,
                term=self.term,
                last_log_index=self.last_index,
                last_log_term=self.term_at(self.last_index),
            )

    def _become_leader(self):
        self.role = ROLE_LEADER
        self.leader = self.id
        # one timeline record per election, emitted by the WINNER (followers
        # learning the leader would triple-report every election). emit()
        # never raises, so the tick path stays safe.
        from chubaofs_tpu_torch.utils import events

        events.emit("raft_leader", entity=f"g{self.group}",
                    detail={"group": self.group, "node": self.id,
                            "term": self.term})
        self.elapsed = 0
        self.next_index = {p: self.last_index + 1 for p in self.peers}
        self.match_index = {p: 0 for p in self.peers}
        self.match_index[self.id] = self.last_index
        # no-op barrier commits entries from prior terms (raft §5.4.2)
        self.entries.append(Entry(self.term, None))
        self.match_index[self.id] = self.last_index
        if not self.peers:
            self._advance_commit()
        else:
            self._broadcast_append()

    # -- vote flow -----------------------------------------------------------

    def _on_vote_req(self, m: Msg):
        if m.term < self.term:
            self._send(type="vote_resp", dst=m.src, term=self.term, granted=False)
            return
        up_to_date = (m.last_log_term, m.last_log_index) >= (
            self.term_at(self.last_index),
            self.last_index,
        )
        grant = up_to_date and self.voted_for in (None, m.src)
        if grant:
            self.voted_for = m.src
            self.elapsed = 0
        self._send(type="vote_resp", dst=m.src, term=self.term, granted=grant)

    def _on_vote_resp(self, m: Msg):
        if self.role != ROLE_CANDIDATE or m.term != self.term:
            return
        if m.granted:
            self.votes.add(m.src)
            if len(self.votes) >= self.quorum():
                self._become_leader()

    # -- replication ----------------------------------------------------------

    def _broadcast_append(self):
        for p in self.peers:
            self._send_append(p)

    def _send_append(self, peer: int):
        next_i = self.next_index.get(peer, self.last_index + 1)
        if next_i <= self.offset:
            self._send_snapshot(peer)
            return
        prev = next_i - 1
        # pipelined replication: ship at most max_batch entries per message
        # and advance next_index OPTIMISTICALLY, so batch i+1 goes out without
        # waiting for ack i. The window bounds entries in flight past the last
        # verified match; when it is full (or next_i is already past the tail)
        # this degrades to an empty probe carrying prev/commit — the probe's
        # ACK advances match, its NACK rewinds next_index, so both lost
        # appends and lost acks self-heal on the heartbeat cadence.
        ents: list[Entry] = []
        if prev - self.match_index.get(peer, 0) < MAX_INFLIGHT:
            end = min(self.last_index, next_i + self.max_batch - 1)
            ents = [self.entry_at(i) for i in range(next_i, end + 1)]
        self._send(
            type="append",
            dst=peer,
            term=self.term,
            prev_index=prev,
            prev_term=self.term_at(prev),
            entries=ents,
            commit=self.commit,
        )
        if ents:
            self.next_index[peer] = next_i + len(ents)

    def _send_snapshot(self, peer: int):
        if self.snapshot_fn is None:
            return
        idx, term, data = self.snapshot_fn()
        self._send(
            type="snap", dst=peer, term=self.term, snap_index=idx, snap_term=term, snap_data=data
        )

    def _on_append(self, m: Msg):
        if m.term < self.term:
            self._send(type="append_resp", dst=m.src, term=self.term, success=False)
            return
        self.role = ROLE_FOLLOWER
        self.leader = m.src
        self.elapsed = 0
        if m.prev_index > self.last_index or self.term_at(m.prev_index) != m.prev_term:
            self._send(
                type="append_resp",
                dst=m.src,
                term=self.term,
                success=False,
                match_index=min(self.last_index, max(self.offset, m.prev_index - 1)),
            )
            return
        # append, truncating conflicts IN PLACE — the common fresh-tail case
        # must not copy the whole log per entry (O(batch x log) per append)
        for i, ent in enumerate(m.entries):
            idx = m.prev_index + 1 + i
            if idx <= self.offset:
                continue  # already compacted into a snapshot
            if idx <= self.last_index:
                if self.term_at(idx) == ent.term:
                    continue
                del self.entries[idx - self.offset - 1:]
                if self.log_rewind is None or idx < self.log_rewind:
                    self.log_rewind = idx
            self.entries.append(ent)
        # commit no further than this message's last entry: a tail beyond it
        # may be a deposed leader's uncommitted proposals that the leader
        # has not overwritten yet, and applying one would answer its waiter
        # with a success the cluster never committed
        if m.commit > self.commit:
            self.commit = max(self.commit,
                              min(m.commit, m.prev_index + len(m.entries)))
            self._emit_committed()
        self._send(
            type="append_resp",
            dst=m.src,
            term=self.term,
            success=True,
            match_index=m.prev_index + len(m.entries),
        )

    def _on_append_resp(self, m: Msg):
        if self.role != ROLE_LEADER or m.term != self.term:
            return
        if m.success:
            self.match_index[m.src] = max(self.match_index.get(m.src, 0), m.match_index)
            # never rewind a pipelined next_index on an (older) ack
            self.next_index[m.src] = max(
                self.next_index.get(m.src, 0), self.match_index[m.src] + 1)
            self._advance_commit()
            if self.next_index[m.src] <= self.last_index:
                # window freed / next chunk of a laggard catch-up
                self._send_append(m.src)
        else:
            # prefix mismatch: the follower's match_index hint is always
            # genuine here (a stale-term NACK carries a higher term, which
            # dethroned us in step() before reaching this branch), so jump
            # next_index straight to it — a next_index-relative backoff would
            # fight the pipelined optimistic advance and never converge
            self.next_index[m.src] = max(1, min(m.match_index + 1, self.last_index + 1))
            self._send_append(m.src)

    def _advance_commit(self):
        for idx in range(self.last_index, self.commit, -1):
            if self.term_at(idx) != self.term:
                break  # only commit entries of the current term by counting (§5.4.2)
            votes = sum(
                1 for p in [self.id, *self.peers] if self.match_index.get(p, 0) >= idx
            )
            if votes >= self.quorum():
                self.commit = idx
                self._emit_committed()
                break

    def _emit_committed(self):
        while self.applied < self.commit:
            self.applied += 1
            if self.applied <= self.offset:
                continue  # folded into a snapshot already
            self._committed.append((self.applied, self.entry_at(self.applied)))

    # -- snapshot install ------------------------------------------------------

    def _on_snap(self, m: Msg):
        if m.term < self.term:
            return
        self.role = ROLE_FOLLOWER
        self.leader = m.src
        self.elapsed = 0
        if m.snap_index <= self.commit:
            return  # stale snapshot
        self.offset, self.offset_term = m.snap_index, m.snap_term
        self.entries = []
        self.commit = self.applied = m.snap_index
        self._committed.append((m.snap_index, Entry(m.snap_term, ("__install_snapshot__", m.snap_data))))
        self._send(
            type="append_resp", dst=m.src, term=self.term, success=True, match_index=m.snap_index
        )
