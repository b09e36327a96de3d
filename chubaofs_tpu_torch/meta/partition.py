"""MetaPartitionSM — one inode-range shard of a volume's namespace.

Reference counterpart: metanode/partition.go:69-244 (metaPartition with
start/end inode range), inode.go:57-75 (Inode with Extents + ObjExtents),
dentry.go:42-47, the fsm ops in partition_fsmop_inode.go and the snapshot logic
of partition_store.go. Differences by design: the store is plain dicts behind a
raft StateMachine (ops arrive ordered and single-threaded, so btree clones and
copy-on-write are unnecessary); snapshots are sectioned CRC-framed binary
streams (raft.snapcodec — the partition_store.go per-type-files-with-CRCs
analog) applied batch-by-batch on restore; the orphan freelist is a queue
drained by the metanode's delete loop (partition_free_list.go analog).

Every mutating verb is a pure (op, args) command applied through raft; reads go
through the leader's local state.
"""

from __future__ import annotations

import stat as stat_mod
import time
from dataclasses import dataclass, field

from chubaofs_tpu_torch.raft import snapcodec
from chubaofs_tpu_torch.raft.server import StateMachine

ROOT_INO = 1


class MetaError(Exception):
    code = "EIO"


class NoEntry(MetaError):
    code = "ENOENT"


class Exists(MetaError):
    code = "EEXIST"


class NotEmpty(MetaError):
    code = "ENOTEMPTY"


class NotDir(MetaError):
    code = "ENOTDIR"


class IsDir(MetaError):
    code = "EISDIR"


class CrossPartition(MetaError):
    """Combined op aborted: the child inode lives in another partition.
    A pure pre-check failure (nothing mutated) — the client falls back to
    the per-op flow."""

    code = "EXDEVPART"


class WrongPartition(MetaError):
    """The routed inode is outside this partition's live range — the
    client's volume view is stale (a mid-range split moved the sub-range)
    or the sub-range is frozen mid-split. Pure pre-check (nothing mutated):
    the client refreshes its view and re-routes instead of failing the op."""

    code = "EWRONGPART"


class TxConflict(MetaError):
    code = "ETXCONFLICT"


class QuotaExceeded(MetaError):
    code = "EDQUOT"


class OutOfRange(MetaError):
    code = "ERANGE"


class SplitRefused(MetaError):
    """A split-orchestration op refused by the SM's own state (freeze
    conflict, frozen range, shrink violation, unfrozen export): the
    ORCHESTRATOR must handle it — retrying the same op can never succeed,
    so the meta-op hooks must not classify it as a transport failure."""

    code = "ESPLIT"


@dataclass
class ExtentKey:
    """Where one contiguous span of file data lives (proto/extent_key.go:40-47).

    Hot volumes: (partition_id, extent_id, offset in extent). Cold volumes use
    ObjExtentKey-style blobstore locations instead (kept as opaque dicts)."""

    file_offset: int
    size: int
    partition_id: int = 0
    extent_id: int = 0
    extent_offset: int = 0


@dataclass
class Inode:
    ino: int
    mode: int  # stat-style type+perm bits
    uid: int = 0
    gid: int = 0
    size: int = 0
    nlink: int = 1
    ctime: float = field(default_factory=time.time)
    mtime: float = field(default_factory=time.time)
    extents: list[ExtentKey] = field(default_factory=list)
    obj_extents: list[dict] = field(default_factory=list)  # cold-tier locations
    xattrs: dict[str, bytes] = field(default_factory=dict)

    @property
    def is_dir(self) -> bool:
        return stat_mod.S_ISDIR(self.mode)


@dataclass
class Dentry:
    parent: int
    name: str
    ino: int
    mode: int


class MetaPartitionSM(StateMachine):
    """The replicated state of one meta partition (inode range [start, end))."""

    def __init__(self, partition_id: int, start: int, end: int):
        self.partition_id = partition_id
        self.start = start
        self.end = end
        self.cursor = start  # last allocated ino
        self.inodes: dict[int, Inode] = {}
        # dentries keyed (parent_ino, name); children index for readdir
        self.dentries: dict[tuple[int, str], Dentry] = {}
        self.children: dict[int, dict[str, Dentry]] = {}
        self.freelist: list[int] = []  # orphaned inos awaiting data cleanup
        # evicted inode payloads keyed by ino: the drain needs the extent maps
        # to purge data (partition_free_list.go keeps the inode until its
        # extents are deleted)
        self.orphans: dict[int, Inode] = {}
        # extents dropped by truncate, awaiting datanode/blobstore deletion
        # (the metanode EXTENT_DEL-file analog); entries are (seq, payload) and
        # are removed only by an explicit ack after the purge succeeds
        self.del_extents: list[tuple[int, dict]] = []
        self.del_seq = 0
        self.multipart: dict[str, dict] = {}  # S3 multipart sessions
        # client-op idempotence (metanode/uniq_checker.go): per client a
        # bounded window of uniq-id -> recorded result, replicated via raft so
        # every replica answers a retried op identically
        self.uniq_seen: dict[str, dict] = {}
        # two-phase transactions (metanode/transaction.go): prepared txns hold
        # intent locks until commit/rollback/expiry
        self.txns: dict[str, dict] = {}  # tx_id -> {ops, deadline}
        self.tx_locks: dict[tuple, str] = {}  # lock key -> tx_id
        # tx_id -> (decision, retain-until); decisions outlive the txn by
        # TX_DONE_RETAIN so late-resolving participants always find them
        self.tx_done: dict[str, tuple[str, float]] = {}
        # directory quotas (metanode quota + master_quota_manager):
        # qid -> {max_files, max_bytes, files, bytes, exceeded}
        self.quotas: dict[int, dict] = {}
        # mid-range load split: while a split is in flight the
        # sub-range [frozen_from, end) is FROZEN — reads and writes there
        # raise WrongPartition until the master swaps the volume view and
        # complete_split drops the moved entries. split_info carries the
        # replicated resume record {split_at, new_pid, new_peers} so a
        # crashed orchestrator (or a restarted replica) can finish the
        # split from the partition's own state.
        self.frozen_from: int | None = None
        self.split_info: dict | None = None
        self._apply_now = 0.0  # proposer-stamped wall clock of the last op
        if start == ROOT_INO:
            root = Inode(ino=ROOT_INO, mode=stat_mod.S_IFDIR | 0o755, nlink=2)
            self.inodes[ROOT_INO] = root
            self.cursor = ROOT_INO

    # -- raft StateMachine ---------------------------------------------------

    UNIQ_WINDOW = 128

    def apply(self, data, index: int):
        """One fsm op. Under raft group commit, entries arrive in drained
        BATCHES (one WAL flush + replication round for up to max_batch
        submits), but each entry still applies alone in log order: errors are
        values through consensus, so a failing op (EEXIST, EDQUOT, ...) never
        poisons the rest of its drained batch, and the proposer-stamped _now/
        _uniq semantics are untouched by who shared its commit round."""
        op, args = data
        uniq = args.get("_uniq")  # never mutate args: the tuple is shared
        if "_now" in args:
            # wall time rides the PROPOSAL: replicas and WAL replay must stamp
            # identical ctimes/mtimes, so apply never reads the local clock
            self._apply_now = args["_now"]
            args = {k: v for k, v in args.items() if k != "_now"}
        if uniq is not None:
            cid, uid = uniq
            hist = self.uniq_seen.get(cid)
            if hist is not None and uid in hist:
                return hist[uid]  # duplicate delivery: replay the answer
            args = {k: v for k, v in args.items() if k != "_uniq"}
        try:
            result = ("ok", getattr(self, "_op_" + op)(**args))
        except MetaError as e:
            # errors are VALUES through consensus: every replica must take the
            # same path, and the proposer gets the errno back
            result = ("err", e.code, str(e))
        if uniq is not None:
            hist = self.uniq_seen.setdefault(cid, {})
            hist[uid] = result
            if len(hist) > self.UNIQ_WINDOW:
                for k in sorted(hist)[: len(hist) - self.UNIQ_WINDOW]:
                    del hist[k]
            # recency order: re-inserting on every use makes eviction drop the
            # LEAST RECENTLY ACTIVE client, and dict order is identical on
            # every replica (same apply sequence), so it stays deterministic
            self.uniq_seen[cid] = self.uniq_seen.pop(cid)
            if len(self.uniq_seen) > 512:
                for k in list(self.uniq_seen)[:128]:
                    del self.uniq_seen[k]
        return result

    # Snapshots: sectioned CRC-framed stream (partition_store.go per-type
    # files analog). Inodes/dentries/orphans are REPEATED bounded-size
    # sections so a lagging follower applies a large namespace incrementally
    # instead of decoding one giant object.

    @staticmethod
    def _inode_wire(i: Inode) -> list:
        return [i.ino, i.mode, i.uid, i.gid, i.size, i.nlink, i.ctime, i.mtime,
                [[e.file_offset, e.size, e.partition_id, e.extent_id,
                  e.extent_offset] for e in i.extents],
                i.obj_extents, i.xattrs]

    @staticmethod
    def _inode_unwire(w: list) -> Inode:
        return Inode(ino=w[0], mode=w[1], uid=w[2], gid=w[3], size=w[4],
                     nlink=w[5], ctime=w[6], mtime=w[7],
                     extents=[ExtentKey(*e) for e in w[8]],
                     obj_extents=list(w[9]), xattrs=dict(w[10]))

    def snapshot(self) -> bytes:
        # wire enc/dec tags the dataclasses living inside op results
        # (uniq_seen replays) — import here: meta.wire imports this module
        from chubaofs_tpu_torch.meta import wire

        w = snapcodec.SnapshotWriter()
        w.add("meta", {
            "partition_id": self.partition_id, "start": self.start,
            "end": self.end, "cursor": self.cursor, "del_seq": self.del_seq,
            "frozen_from": self.frozen_from, "split_info": self.split_info,
        })
        w.add_batched("inodes", (self._inode_wire(i) for i in self.inodes.values()))
        w.add_batched("dentries", ([d.parent, d.name, d.ino, d.mode]
                                   for d in self.dentries.values()))
        w.add_batched("orphans", (self._inode_wire(i) for i in self.orphans.values()))
        w.add("freelist", self.freelist)
        w.add("del_extents", self.del_extents)
        w.add("multipart", self.multipart)
        w.add("uniq_seen", wire.enc(self.uniq_seen))
        w.add("txns", self.txns)
        w.add("tx_locks", self.tx_locks)
        w.add("tx_done", self.tx_done)
        w.add("quotas", self.quotas)
        return w.getvalue()

    def restore(self, payload: bytes) -> None:
        from chubaofs_tpu_torch.meta import wire

        self.inodes, self.dentries, self.children, self.orphans = {}, {}, {}, {}

        def load_meta(m):
            self.partition_id = m["partition_id"]
            self.start, self.end = m["start"], m["end"]
            self.cursor, self.del_seq = m["cursor"], m["del_seq"]
            # .get: snapshots from before mid-range splits existed
            self.frozen_from = m.get("frozen_from")
            self.split_info = m.get("split_info")

        def load_inodes(batch):
            for rec in batch:
                i = self._inode_unwire(rec)
                self.inodes[i.ino] = i

        def load_dentries(batch):
            for parent, name, ino, mode in batch:
                d = Dentry(parent, name, ino, mode)
                self.dentries[(parent, name)] = d
                self.children.setdefault(parent, {})[name] = d

        def load_orphans(batch):
            for rec in batch:
                i = self._inode_unwire(rec)
                self.orphans[i.ino] = i

        snapcodec.restore_sections(payload, {
            "meta": load_meta,
            "inodes": load_inodes,
            "dentries": load_dentries,
            "orphans": load_orphans,
            "freelist": lambda v: setattr(self, "freelist", list(v)),
            "del_extents": lambda v: setattr(
                self, "del_extents", [tuple(e) for e in v]),
            "multipart": lambda v: setattr(self, "multipart", dict(v)),
            "uniq_seen": lambda v: setattr(self, "uniq_seen", wire.dec(v)),
            "txns": lambda v: setattr(self, "txns", dict(v)),
            "tx_locks": lambda v: setattr(self, "tx_locks", dict(v)),
            "tx_done": lambda v: setattr(self, "tx_done", dict(v)),
            "quotas": lambda v: setattr(self, "quotas", dict(v)),
        })

    # -- routing ownership (mid-range split fencing) ---------------------------

    def owns_ino_live(self, ino: int) -> bool:
        """owns_ino minus the frozen sub-range: while a split is in flight
        the entries >= frozen_from are leaving this partition, and serving
        them here (reads included — the sibling starts serving writes the
        instant the view swaps, BEFORE complete_split shrinks `end`) would
        hand out stale state."""
        if self.frozen_from is not None and ino >= self.frozen_from:
            return False
        return self.start <= ino < self.end

    def _route_guard(self, ino: int) -> None:
        if not self.owns_ino_live(ino):
            live_end = self.frozen_from if self.frozen_from is not None \
                else self.end
            raise WrongPartition(
                f"ino {ino} not served by partition {self.partition_id} "
                f"[{self.start}, {live_end})")

    # -- fsm ops: inodes -------------------------------------------------------

    def _next_ino(self) -> int:
        bound = self.frozen_from if self.frozen_from is not None else self.end
        if self.cursor + 1 >= bound:
            if self.frozen_from is not None:
                # the free tail of the range is moving to the sibling (it
                # inherits the cursor): re-route, don't report exhaustion
                raise WrongPartition(
                    f"partition {self.partition_id} allocations moved by "
                    f"split at {self.frozen_from}")
            raise OutOfRange(f"partition {self.partition_id} inode range exhausted")
        self.cursor += 1
        return self.cursor

    QUOTA_XATTR = "__quota_ids__"

    def _op_create_inode(self, mode: int, uid: int = 0, gid: int = 0,
                         quota_ids: list[int] | None = None):
        ino = self._next_ino()
        inode = Inode(ino=ino, mode=mode, uid=uid, gid=gid,
                      ctime=self._apply_now, mtime=self._apply_now)
        if inode.is_dir:
            inode.nlink = 2
        if quota_ids:  # subtree quota ids stick to the inode for byte charges
            import json as _json

            inode.xattrs[self.QUOTA_XATTR] = _json.dumps(quota_ids).encode()
        self.inodes[ino] = inode
        return inode

    def _op_delete_dentry_unlink(self, parent: int, name: str,
                                 quota_ids: list[int] | None = None,
                                 want_dir: bool | None = None):
        """Combined remove: lookup + delete_dentry + unlink_inode in ONE
        raft commit when this partition owns BOTH the parent and the
        child's inode (the single-tail-MP common case) — the client also
        saves its pre-lookup round-trip. `want_dir` enforces the caller's
        rmdir/unlink type expectation inside the commit (no TOCTOU against
        a concurrent rename-over). Raises CrossPartition when the child
        inode lives elsewhere; the client falls back to the per-op flow."""
        self._route_guard(parent)
        d = self.dentries.get((parent, name))
        if d is None:
            raise NoEntry(f"{name!r} in {parent}")
        if want_dir is not None and stat_mod.S_ISDIR(d.mode) != want_dir:
            raise (NotDir if want_dir else IsDir)(f"{name!r}")
        if not self.owns_ino_live(d.ino):
            # owns_ino_live: a child in the FROZEN sub-range must not be
            # mutated here either — the client falls back to the per-op
            # flow, whose unlink re-routes once the view swaps
            raise CrossPartition(f"ino {d.ino} outside [{self.start},{self.end})")
        self._op_delete_dentry(parent, name, quota_ids=quota_ids)
        inode = self._op_unlink_inode(d.ino)
        return d.ino, inode.nlink

    def _op_create_inode_dentry(self, parent: int, name: str, mode: int,
                                uid: int = 0, gid: int = 0,
                                quota_ids: list[int] | None = None):
        """Combined create: inode + dentry in ONE raft commit when the
        parent lives in this partition (the common single-tail-MP case).
        Halves the per-create consensus round-trips vs the two-op flow
        (create_inode then create_dentry) while keeping its invariants:
        every check — name conflict, parent type, locks, file-count quota —
        runs BEFORE the inode allocates, so a failed create leaves nothing
        behind to undo and burns no inode-range slot."""
        key = (parent, name)
        self._route_guard(parent)
        self._check_lock(("d", parent, name), None)
        self._check_lock(("c", parent), None)
        if key in self.dentries:
            raise Exists(f"{name!r} exists in {parent}")
        pdir = self._get_inode(parent)
        if not pdir.is_dir:
            raise NotDir(f"parent {parent}")
        # quota charge is ALSO a pre-check (it raises EDQUOT before any
        # mutation): an EDQUOT-looping client never burns inode-range
        # slots on a full quota
        self._quota_charge_files(quota_ids, +1)
        try:
            inode = self._op_create_inode(mode, uid, gid, quota_ids)
        except MetaError:  # OutOfRange: refund the charge, nothing mutated
            self._quota_charge_files(quota_ids, -1)
            raise
        # _committing=True: locks checked and quota charged above
        self._op_create_dentry(parent, name, inode.ino, inode.mode,
                               quota_ids=quota_ids, _committing=True)
        return inode

    def _inode_quota_ids(self, inode: Inode) -> list[int]:
        raw = inode.xattrs.get(self.QUOTA_XATTR)
        if not raw:
            return []
        import json as _json

        return _json.loads(raw)

    def _op_unlink_inode(self, ino: int):
        self._route_guard(ino)
        inode = self._get_inode(ino)
        inode.nlink -= 1
        if inode.is_dir:
            inode.nlink = max(inode.nlink, 0)
        if inode.nlink <= 0 or (inode.is_dir and inode.nlink <= 1):
            pass  # survives until evict
        return inode

    def _op_evict_inode(self, ino: int):
        self._route_guard(ino)
        inode = self.inodes.get(ino)
        if inode is None:
            return None
        if inode.nlink <= 0 or (inode.is_dir and inode.nlink <= 1):
            del self.inodes[ino]
            if not inode.is_dir:
                if inode.size:  # the file's bytes leave the quota with it
                    self._quota_charge_bytes(
                        self._inode_quota_ids(inode), -inode.size)
                self.freelist.append(ino)
                self.orphans[ino] = inode
        return None

    def _op_update_inode(self, ino: int, size: int | None = None, mode: int | None = None,
                         uid: int | None = None, gid: int | None = None,
                         mtime: float | None = None):
        self._route_guard(ino)
        inode = self._get_inode(ino)
        if size is not None:
            inode.size = size
        if mode is not None:
            inode.mode = mode
        if uid is not None:
            inode.uid = uid
        if gid is not None:
            inode.gid = gid
        inode.mtime = mtime if mtime is not None else self._apply_now
        return inode

    def _op_append_extents(self, ino: int, extents: list[dict], size: int):
        """AppendExtentKey analog (sdk/meta/api.go:1137): extend the file map."""
        self._route_guard(ino)
        inode = self._get_inode(ino)
        grow = max(0, size - inode.size)
        if grow:
            self._quota_charge_bytes(self._inode_quota_ids(inode), grow)
        for e in extents:
            inode.extents.append(ExtentKey(**e))
        inode.size = max(inode.size, size)
        inode.mtime = self._apply_now
        return inode

    def _op_append_obj_extents(self, ino: int, locations: list[dict], size: int):
        """Cold tier: record blobstore locations (ObjExtents, inode.go:73-74)."""
        self._route_guard(ino)
        inode = self._get_inode(ino)
        grow = max(0, size - inode.size)
        if grow:
            self._quota_charge_bytes(self._inode_quota_ids(inode), grow)
        inode.obj_extents.extend(locations)
        inode.size = max(inode.size, size)
        inode.mtime = self._apply_now
        return inode

    def _op_truncate(self, ino: int, size: int):
        self._route_guard(ino)
        inode = self._get_inode(ino)
        shrink = max(0, inode.size - size)
        if shrink:  # credit the quota back for the cut-off span
            self._quota_charge_bytes(self._inode_quota_ids(inode), -shrink)
        dropped = [e for e in inode.extents if e.file_offset >= size]
        inode.extents = [e for e in inode.extents if e.file_offset < size]
        for e in inode.extents:
            if e.file_offset + e.size > size:
                e.size = size - e.file_offset
        # cold-tier map: obj extents are consecutive; keep those before the cut,
        # clip the one straddling it
        kept, dropped_obj, pos = [], [], 0
        for ext in inode.obj_extents:
            if pos >= size:
                dropped_obj.append(ext)
                pos += ext["size"]
                continue
            if pos + ext["size"] > size:
                ext = {**ext, "size": size - pos}
            kept.append(ext)
            pos += ext["size"]
        inode.obj_extents = kept
        if dropped or dropped_obj:
            self.del_seq += 1
            self.del_extents.append((self.del_seq, {
                "extents": [vars(e) for e in dropped],
                "obj_extents": dropped_obj,
            }))
        inode.size = size
        inode.mtime = self._apply_now
        return inode

    def _op_set_xattr(self, ino: int, key: str, value: bytes):
        self._route_guard(ino)
        self._get_inode(ino).xattrs[key] = value

    def _op_remove_xattr(self, ino: int, key: str):
        self._route_guard(ino)
        self._get_inode(ino).xattrs.pop(key, None)

    # -- fsm ops: dentries ------------------------------------------------------

    def _check_lock(self, key: tuple, tx_id: str | None = None):
        """A prepared transaction's intent lock blocks outside mutations."""
        holder = self.tx_locks.get(key)
        if holder is not None and holder != tx_id:
            raise TxConflict(f"{key} locked by txn {holder}")

    def _op_create_dentry(self, parent: int, name: str, ino: int, mode: int,
                          quota_ids: list[int] | None = None,
                          _tx: str | None = None, _committing: bool = False):
        """_committing=True is the 2PC commit replay: every check already ran
        (and quota was RESERVED) at prepare, so nothing here may fail — a
        failure after the TM decision would leave the txn half-applied."""
        key = (parent, name)
        if not _committing:
            # 2PC commit replays skip the guard: prepare already ran it, and
            # freeze_range refuses while prepared txns exist — a commit can
            # never land in a frozen sub-range, and commits cannot fail
            self._route_guard(parent)
            self._check_lock(("d", parent, name), _tx)
            self._check_lock(("c", parent), _tx)  # dir-delete freezes the child set
        if key in self.dentries:
            raise Exists(f"{name!r} exists in {parent}")
        pdir = self._get_inode(parent)
        if not pdir.is_dir:
            raise NotDir(f"parent {parent}")
        if not _committing:  # committed txns charged at prepare
            self._quota_charge_files(quota_ids, +1)
        d = Dentry(parent, name, ino, mode)
        self.dentries[key] = d
        self.children.setdefault(parent, {})[name] = d
        if stat_mod.S_ISDIR(mode):
            pdir.nlink += 1
        pdir.mtime = self._apply_now
        return d

    def _op_delete_dentry(self, parent: int, name: str,
                          quota_ids: list[int] | None = None,
                          _tx: str | None = None, _committing: bool = False):
        key = (parent, name)
        if not _committing:
            self._route_guard(parent)
            self._check_lock(("d", parent, name), _tx)
        d = self.dentries.get(key)
        if d is None:
            raise NoEntry(f"{name!r} in {parent}")
        if stat_mod.S_ISDIR(d.mode):
            if self.children.get(d.ino):
                raise NotEmpty(f"{name!r}")
            if not _committing:
                # a PREPARED create inside this directory holds ("d", d.ino, *):
                # deleting the dir now would make that txn's commit fail after
                # the TM decision — the commit-cannot-fail invariant's reverse
                # direction, so the plain rmdir path must conflict too
                for lk, holder in self.tx_locks.items():
                    if lk[0] == "d" and lk[1] == d.ino and holder != _tx:
                        raise TxConflict(f"dir {d.ino} has pending txn {holder}")
        self._quota_charge_files(quota_ids, -1)
        del self.dentries[key]
        self.children.get(parent, {}).pop(name, None)
        pdir = self.inodes.get(parent)
        if pdir:
            if stat_mod.S_ISDIR(d.mode):
                pdir.nlink -= 1
            pdir.mtime = self._apply_now
        return d

    def _op_rename_local(self, src_parent: int, src_name: str, dst_parent: int,
                         dst_name: str, src_quota_ids: list[int] | None = None,
                         dst_quota_ids: list[int] | None = None):
        """Atomic rename when both dentries live in this partition. The move
        leaves the source quota and enters the destination's.

        POSIX rename(2) REPLACE semantics: an existing destination is
        atomically displaced in the same commit — its dentry drops, and when
        this partition also owns its inode, the link drops too. Returns
        (new_dentry, displaced_ino, displaced_nlink, displaced_is_dir) where
        displaced_ino == 0 means nothing was displaced and displaced_nlink
        == -1 means the displaced inode lives in another partition (the
        client must unlink it via the per-op flow)."""
        self._route_guard(src_parent)
        self._route_guard(dst_parent)
        self._check_lock(("d", src_parent, src_name))
        self._check_lock(("d", dst_parent, dst_name))
        d = self.dentries.get((src_parent, src_name))
        if d is None:
            raise NoEntry(f"{src_name!r} in {src_parent}")
        displaced_ino, displaced_nlink = 0, -1
        displaced_is_dir = False
        displaced = self.dentries.get((dst_parent, dst_name))
        if displaced is not None:
            if displaced.ino == d.ino:
                # both names are links to ONE inode: rename(2) succeeds and
                # does nothing (POSIX "oldpath and newpath are hard links")
                return (d, 0, -1, False)
            src_is_dir = stat_mod.S_ISDIR(d.mode)
            displaced_is_dir = stat_mod.S_ISDIR(displaced.mode)
            if src_is_dir and not displaced_is_dir:
                raise NotDir(f"{dst_name!r} in {dst_parent}")
            if not src_is_dir and displaced_is_dir:
                raise IsDir(f"{dst_name!r} in {dst_parent}")
            if displaced_is_dir and self.children.get(displaced.ino):
                raise NotEmpty(f"{dst_name!r}")
            # drop the displaced dentry + its link inside THIS commit: no
            # window where dst is missing, no window with two dsts
            self._op_delete_dentry(dst_parent, dst_name,
                                   quota_ids=dst_quota_ids)
            displaced_ino = displaced.ino
            # owns_ino_live: a displaced inode in the FROZEN sub-range is
            # the sibling's to unlink (client per-op flow re-routes there)
            if self.owns_ino_live(displaced.ino) and displaced.ino in self.inodes:
                displaced_nlink = self._op_unlink_inode(displaced.ino).nlink
        self._op_create_dentry(dst_parent, dst_name, d.ino, d.mode,
                               quota_ids=dst_quota_ids)
        self._op_delete_dentry(src_parent, src_name, quota_ids=src_quota_ids)
        return (self.dentries[(dst_parent, dst_name)], displaced_ino,
                displaced_nlink, displaced_is_dir)

    def _op_link(self, parent: int, name: str, ino: int):
        self._route_guard(parent)
        if self.owns_ino(ino):
            # the nlink bump mutates the inode: fence it during a split
            # (a cross-partition link's nlink is the caller's contract)
            self._route_guard(ino)
        inode = self._get_inode(ino)
        if inode.is_dir:
            raise MetaError("hardlink to directory")
        d = self._op_create_dentry(parent, name, ino, inode.mode)
        inode.nlink += 1
        return d

    # -- fsm ops: freelist / multipart -----------------------------------------

    def _op_drain_freelist(self, max_items: int = 64):
        """Peek orphaned inodes for purging. The orphan stays until the purge
        acks (_op_purge_ack) — a failed purge is retried next drain."""
        return [self.orphans[i] for i in self.freelist[:max_items]
                if i in self.orphans]

    def _op_purge_ack(self, inos: list[int]):
        done = set(inos)
        self.freelist = [i for i in self.freelist if i not in done]
        for i in done:
            self.orphans.pop(i, None)
        return len(done)

    def _op_drain_del_extents(self, max_items: int = 64):
        return self.del_extents[:max_items]

    def _op_del_extents_ack(self, seqs: list[int]):
        done = set(seqs)
        self.del_extents = [(s, e) for s, e in self.del_extents if s not in done]
        return len(done)

    # -- fsm ops: transactions (metanode/transaction.go 2PC) --------------------
    #
    # prepare validates every sub-op and takes intent locks; commit replays the
    # sub-ops with the locks held (so they cannot fail); rollback/expiry drops
    # the intents. Deadlines ride the PROPOSAL (deterministic across replicas).
    #
    # Coordinator recovery (the reference's TM/RM split): every txn names a
    # TRANSACTION-MANAGER partition (tm_pid). The coordinator commits the TM
    # first — the TM's tx_done entry IS the durable decision. A participant
    # whose prepared txn expires does not abort unilaterally: the sweep hands
    # it to the metanode, which asks the TM partition and rolls the txn
    # forward (commit) or back to match. Only the TM's own expiry decides
    # "rolledback" (the coordinator died before any commit).

    TX_OPS = {"create_dentry", "delete_dentry"}

    @staticmethod
    def _tx_lock_keys(op: str, args: dict) -> list[tuple]:
        keys = [("d", args["parent"], args["name"])]
        if op == "delete_dentry" and args.get("_lock_children"):
            # deleting a DIRECTORY: freeze its child set too, or a create
            # inside it between prepare and commit breaks the "commit cannot
            # fail" invariant (the validation checked it was empty)
            keys.append(("c", args["_lock_children"]))
        return keys

    # a decision outlives its txn's deadline by this much, so a participant
    # resolving within TX_TTL + sweep slack ALWAYS finds it (count-based
    # pruning could forget a commit inside that window and roll a committed
    # rename half back)
    TX_DONE_RETAIN = 120.0
    TX_DONE_HARD_CAP = 1 << 16  # memory backstop, far above any live window

    def _op_tx_prepare(self, tx_id: str, ops: list, deadline: float,
                       tm_pid: int = 0):
        if tx_id in self.tx_done:
            raise TxConflict(f"txn {tx_id} already {self.tx_done[tx_id][0]}")
        if tx_id in self.txns:
            return None  # idempotent re-prepare
        prepared_ops = []
        for op, args in ops:
            if op not in self.TX_OPS:
                raise MetaError(f"op {op!r} not transactable")
            args = dict(args)
            # a prepare landing in the frozen sub-range must conflict NOW:
            # freeze_range refuses while txns exist, so without this guard a
            # post-freeze prepare could commit into entries mid-copy
            self._route_guard(args["parent"])
            # dry-run validation so commit CANNOT fail later: every check the
            # commit replay would make must run (and conflict) here
            if op == "create_dentry":
                if (args["parent"], args["name"]) in self.dentries:
                    raise Exists(f"{args['name']!r} exists in {args['parent']}")
                pdir = self._get_inode(args["parent"])
                if not pdir.is_dir:
                    raise NotDir(f"parent {args['parent']}")
                # a prepared dir-delete of the parent must conflict NOW, not
                # at commit time
                self._check_lock(("c", args["parent"]))
            elif op == "delete_dentry":
                d = self.dentries.get((args["parent"], args["name"]))
                if d is None:
                    raise NoEntry(f"{args['name']!r} in {args['parent']}")
                if stat_mod.S_ISDIR(d.mode):
                    if self.children.get(d.ino):
                        raise NotEmpty(args["name"])
                    # a prepared create INSIDE this directory would repopulate
                    # it between our emptiness check and commit
                    for key, holder in self.tx_locks.items():
                        if key[0] == "d" and key[1] == d.ino and holder != tx_id:
                            raise TxConflict(
                                f"dir {d.ino} has pending txn {holder}")
                    args["_lock_children"] = d.ino
            for key in self._tx_lock_keys(op, args):
                self._check_lock(key)
            prepared_ops.append((op, args))
        # RESERVE quota at prepare (released on rollback): the commit replay
        # must never hit EDQUOT because the quota filled in between. A
        # mid-loop failure must undo the charges already made — prepare
        # failed, so no txn exists to roll them back later.
        charged = []
        try:
            for op, args in prepared_ops:
                if op == "create_dentry":
                    self._quota_charge_files(args.get("quota_ids"), +1)
                    charged.append(args.get("quota_ids"))
        except QuotaExceeded:
            for qids in charged:
                self._quota_charge_files(qids, -1)
            raise
        for op, args in prepared_ops:
            for key in self._tx_lock_keys(op, args):
                self.tx_locks[key] = tx_id
        self.txns[tx_id] = {"ops": prepared_ops, "deadline": deadline,
                            "tm_pid": tm_pid or self.partition_id}
        return None

    def _release_tx(self, tx_id: str, undo_reservations: bool):
        txn = self.txns.pop(tx_id, None)
        if txn is not None and undo_reservations:
            for op, args in txn["ops"]:
                if op == "create_dentry":
                    self._quota_charge_files(args.get("quota_ids"), -1)
        self.tx_locks = {k: t for k, t in self.tx_locks.items() if t != tx_id}
        if len(self.tx_done) > self.TX_DONE_HARD_CAP:
            for k in list(self.tx_done)[: self.TX_DONE_HARD_CAP // 2]:
                del self.tx_done[k]

    def _done_stamp(self, txn: dict) -> float:
        """Decision retention deadline, derived from the txn's own deadline so
        every replica computes the identical value (no wall clock in apply)."""
        return txn["deadline"] + self.TX_DONE_RETAIN

    def _op_tx_commit(self, tx_id: str):
        if tx_id in self.tx_done and self.tx_done[tx_id][0] == "committed":
            return None  # idempotent re-commit
        txn = self.txns.get(tx_id)
        if txn is None:
            raise TxConflict(
                f"txn {tx_id} not prepared "
                f"({self.tx_done.get(tx_id, ('unknown',))[0]})")
        for op, args in txn["ops"]:
            run_args = {k: v for k, v in args.items() if k != "_lock_children"}
            getattr(self, "_op_" + op)(**run_args, _tx=tx_id, _committing=True)
        self.tx_done[tx_id] = ("committed", self._done_stamp(txn))
        self._release_tx(tx_id, undo_reservations=False)
        return None

    def _op_tx_rollback(self, tx_id: str):
        txn = self.txns.get(tx_id)
        if txn is not None:
            self.tx_done[tx_id] = ("rolledback", self._done_stamp(txn))
            self._release_tx(tx_id, undo_reservations=True)
        return None

    def _op_tx_sweep(self, now: float):
        """Resolve expired prepared txns. TM-anchored txns roll back here (no
        commit decision was ever recorded); participant txns are RETURNED for
        the metanode to resolve against their TM partition. Also prunes
        decisions whose retention window has lapsed — never earlier."""
        unresolved = []
        for t, txn in list(self.txns.items()):
            if txn["deadline"] >= now:
                continue
            if txn["tm_pid"] == self.partition_id:
                self.tx_done[t] = ("rolledback", self._done_stamp(txn))
                self._release_tx(t, undo_reservations=True)
            else:
                unresolved.append((t, txn["tm_pid"]))
        for t, (_, expire) in list(self.tx_done.items()):
            if now > expire:
                del self.tx_done[t]
        return unresolved

    def tx_status(self, tx_id: str) -> str:
        """TM-side decision lookup: committed | rolledback | prepared | unknown."""
        if tx_id in self.tx_done:
            return self.tx_done[tx_id][0]
        if tx_id in self.txns:
            return "prepared"
        return "unknown"

    # -- fsm ops: mid-range load split ------------------------------------------
    #
    # Master-orchestrated: freeze_range fences the sub-range (every op routed
    # there raises WrongPartition), export_range pages a CONSISTENT snapshot
    # of the frozen entries (frozen = immutable by construction),
    # import_entries loads them into the sibling raft group, the master then
    # swaps the volume view in ONE master-raft commit (the atomicity point:
    # before it the sub-range is owned — frozen — by this partition, after it
    # by the sibling; never by zero or two), and complete_split drops the
    # moved entries + shrinks `end`. Every step is idempotent, and split_info
    # is REPLICATED state reported via heartbeats — a crashed orchestrator or
    # restarted replica resumes the split from the partition's own record.

    EXPORT_BATCH = 256

    def split_point(self) -> int:
        """Median live inode — the split_at candidate (leader read). 0 when
        the partition cannot split: fewer than two live inodes, or a median
        that would leave one side empty."""
        inos = sorted(self.inodes)
        if len(inos) < 2:
            return 0
        m = inos[len(inos) // 2]
        if m <= inos[0] or m <= self.start or m >= self.end:
            return 0
        return m

    def _op_freeze_range(self, split_at: int, new_pid: int,
                         new_peers: list[int] | None = None):
        if self.frozen_from is not None:
            if self.frozen_from == split_at and self.split_info \
                    and self.split_info.get("new_pid") == int(new_pid):
                return dict(self.split_info)  # idempotent re-freeze (resume)
            raise SplitRefused(
                f"partition {self.partition_id} already splitting at "
                f"{self.frozen_from}")
        if not (self.start < split_at < self.end):
            raise SplitRefused(
                f"split_at {split_at} outside ({self.start}, {self.end})")
        if self.txns:
            # a prepared 2PC txn may commit into the moving sub-range, and
            # commits can NEVER fail — refuse; the sweep retries after the
            # txns resolve (seconds, bounded by TX_TTL)
            raise TxConflict(
                f"{len(self.txns)} prepared txn(s) in flight; retry split")
        self.frozen_from = split_at
        self.split_info = {"split_at": int(split_at), "new_pid": int(new_pid),
                           "new_peers": [int(p) for p in (new_peers or [])]}
        return dict(self.split_info)

    def _op_unfreeze_range(self):
        """Abort path: lift the fence without moving anything."""
        self.frozen_from, self.split_info = None, None
        return None

    def _op_set_range_end(self, end: int):
        """Shrink this partition's range end (the SM half of a CURSOR split:
        the master's view commit caps the old tail at split_at, and without
        this the SM would keep end=INF and allocate inodes BEYOND its view
        range — unroutable files). Never below the allocation cursor (live
        inos <= cursor by construction), refused mid-split. A request at or
        above the current end returns the EXISTING cap unchanged: a sweep
        retrying a cursor split whose view commit failed recomputes
        split_at from a cursor that has since advanced, so the recomputed
        cap overshoots the committed one — the caller must complete the
        view swap at the cap this op RETURNS, or the tail could never
        split again once the cursor fills the headroom."""
        if self.frozen_from is not None:
            raise SplitRefused(
                f"partition {self.partition_id} mid-split; range is frozen")
        if end >= self.end:
            return self.end
        if end <= self.start or end <= self.cursor:
            raise SplitRefused(
                f"range end {end} would cut live inos "
                f"(start {self.start}, cursor {self.cursor})")
        self.end = end
        return end

    def export_range(self, after: int = 0, limit: int = 0) -> dict:
        """One page of the frozen sub-range (leader read): inode wires plus
        each inode's child dentries, ino-ordered. The first page (after=0)
        also carries the allocation cursor and quota definitions the sibling
        inherits. Every dentry's parent inode lives in this partition
        (create_dentry routes by parent), so paging by parent ino covers
        the dentry set exactly."""
        if self.frozen_from is None:
            raise SplitRefused(f"partition {self.partition_id} not frozen")
        limit = limit or self.EXPORT_BATCH
        inos = sorted(i for i in self.inodes
                      if i >= self.frozen_from and i > after)
        page = inos[:limit]
        dentries = []
        for ino in page:
            dentries += [[d.parent, d.name, d.ino, d.mode]
                         for d in self.children.get(ino, {}).values()]
        out = {"inodes": [self._inode_wire(self.inodes[i]) for i in page],
               "dentries": dentries,
               "next": page[-1] if page else after,
               "done": len(inos) <= limit}
        if not after:
            out["cursor"] = self.cursor
            out["quotas"] = {qid: {"max_files": q.get("max_files", 0),
                                   "max_bytes": q.get("max_bytes", 0)}
                             for qid, q in self.quotas.items()}
        return out

    def _op_import_entries(self, inodes: list, dentries: list,
                           cursor: int | None = None,
                           quotas: dict | None = None,
                           final: bool = True):
        """Load one exported page into the sibling (keyed upserts, so a
        resumed orchestrator may replay pages). Quota usage is RECOUNTED
        from the imported entries on the FINAL page only (the sibling does
        not serve its range until the view swap, so intermediate counts are
        unobservable, and a per-page recount would make the copy
        O(n^2/batch) on the apply thread); the recount is idempotent, so
        replays can't double-charge, and the source sheds the moved usage
        the same way in complete_split, so volume aggregates conserve."""
        for rec in inodes:
            i = self._inode_unwire(rec)
            if not self.owns_ino(i.ino):
                raise SplitRefused(
                    f"import ino {i.ino} outside [{self.start}, {self.end})")
            self.inodes[i.ino] = i
        for parent, name, ino, mode in dentries:
            d = Dentry(parent, name, ino, mode)
            self.dentries[(parent, name)] = d
            self.children.setdefault(parent, {})[name] = d
        if cursor is not None:
            # inherit the source's allocation cursor: live inos <= cursor,
            # and the free tail (cursor, end) now allocates HERE
            self.cursor = max(self.cursor, int(cursor))
        for qid, q in (quotas or {}).items():
            dst = self.quotas.setdefault(
                int(qid), {"files": 0, "bytes": 0, "exceeded": False})
            dst["max_files"] = q.get("max_files", 0)
            dst["max_bytes"] = q.get("max_bytes", 0)
        if final:
            self._recount_quotas()
        return len(inodes)

    def _op_complete_split(self):
        """Cleanup tail step, AFTER the master's view swap: drop the moved
        entries and shrink `end` to the split point. Idempotent — completing
        an unfrozen partition is a no-op (resume may retry). Orphans and
        del_extents keep draining here: their inodes already left the
        namespace and the purge is location-addressed."""
        if self.frozen_from is None:
            return 0
        cut = self.frozen_from
        dropped = [i for i in self.inodes if i >= cut]
        for i in dropped:
            del self.inodes[i]
            self.children.pop(i, None)
        for k in [k for k, d in self.dentries.items() if d.parent >= cut]:
            del self.dentries[k]
        self.end = cut
        self.frozen_from, self.split_info = None, None
        # shed the moved entries' quota usage: without this their later
        # deletion debits the SIBLING (which the import recounted), the
        # max(0,..) clamp eats the debit there, and this side's stale
        # charge never releases — headroom leaks every split+delete cycle
        self._recount_quotas()
        return len(dropped)

    def _recount_quotas(self) -> None:
        """Rebuild quota usage counters from live entries (split paths only:
        import pages and complete). Deterministic over replicated SM state
        and idempotent, so page replays by a resumed orchestrator are safe.
        The derivation matches how charges/debits are attributed at op time:
        files per dentry under the PARENT dir inode's __quota_ids__ xattr
        (dentries live on the parent's partition, and the client resolves
        quota_ids from that same xattr), bytes per non-dir inode's own
        xattr times its size (released at evict, so un-evicted orphans
        stay counted — matching the charge they still hold)."""
        if not self.quotas:
            return
        for q in self.quotas.values():
            q["files"] = 0
            q["bytes"] = 0
        for d in self.dentries.values():
            parent = self.inodes.get(d.parent)
            if parent is None:
                continue
            for qid in self._inode_quota_ids(parent):
                q = self.quotas.get(qid)
                if q is not None:
                    q["files"] += 1
        for inode in self.inodes.values():
            if inode.is_dir or not inode.size:
                continue
            for qid in self._inode_quota_ids(inode):
                q = self.quotas.get(qid)
                if q is not None:
                    q["bytes"] += inode.size

    # -- fsm ops: quotas (metanode quota + master_quota_manager) ----------------
    #
    # A quota id names a directory subtree. Definitions are fanned out to every
    # partition of the volume; usage is counted where the charged op applies
    # (files at the dentry's partition — exact, because one directory's
    # dentries live on one partition; bytes at the inode's partition). The
    # aggregator (MetaWrapper.quota_usage) sums partitions and pushes the
    # `exceeded` flag back down, the reference's master-report loop shape.

    def _op_set_quota_def(self, quota_id: int, max_files: int = 0,
                          max_bytes: int = 0):
        q = self.quotas.setdefault(
            quota_id, {"files": 0, "bytes": 0, "exceeded": False})
        q["max_files"] = max_files
        q["max_bytes"] = max_bytes
        return None

    def _op_delete_quota_def(self, quota_id: int):
        self.quotas.pop(quota_id, None)
        return None

    def _op_set_quota_flag(self, quota_id: int, exceeded: bool):
        q = self.quotas.get(quota_id)
        if q is not None:
            q["exceeded"] = exceeded
        return None

    def _quota_check_files(self, quota_ids):
        for qid in quota_ids or ():
            q = self.quotas.get(qid)
            if q is None:
                continue
            if q["exceeded"] or (q.get("max_files") and
                                 q["files"] >= q["max_files"]):
                raise QuotaExceeded(f"quota {qid}: file limit")

    def _quota_charge_files(self, quota_ids, delta: int):
        if delta > 0:
            self._quota_check_files(quota_ids)
        for qid in quota_ids or ():
            q = self.quotas.get(qid)
            if q is not None:
                q["files"] = max(0, q["files"] + delta)

    def _quota_charge_bytes(self, quota_ids, delta: int):
        for qid in quota_ids or ():  # validate every quota BEFORE charging any
            q = self.quotas.get(qid)
            if q is None:
                continue
            if delta > 0 and (q["exceeded"] or (
                    q.get("max_bytes")
                    and q["bytes"] + delta > q["max_bytes"])):
                raise QuotaExceeded(f"quota {qid}: byte limit")
        for qid in quota_ids or ():
            q = self.quotas.get(qid)
            if q is not None:
                q["bytes"] = max(0, q["bytes"] + delta)

    def quota_usage(self) -> dict[int, dict]:
        return {qid: dict(q) for qid, q in self.quotas.items()}

    def _op_multipart_create(self, key: str, upload_id: str):
        self.multipart[upload_id] = {"key": key, "parts": {}}
        return upload_id

    def _op_multipart_put_part(self, upload_id: str, part_num: int, location: dict):
        """Returns the replaced part's location (None for a fresh part) so the
        caller can reclaim the superseded data (S3 UploadPart retry semantics)."""
        mp = self.multipart.get(upload_id)
        if mp is None:
            raise NoEntry(f"upload {upload_id}")
        old = mp["parts"].get(part_num)
        mp["parts"][part_num] = location
        return old

    def _op_multipart_complete(self, upload_id: str):
        mp = self.multipart.pop(upload_id, None)
        if mp is None:
            raise NoEntry(f"upload {upload_id}")
        return mp

    def _op_multipart_abort(self, upload_id: str):
        """Same pop as complete; the caller deletes the part data instead of
        linking it (objectnode AbortMultipartUpload path)."""
        mp = self.multipart.pop(upload_id, None)
        if mp is None:
            raise NoEntry(f"upload {upload_id}")
        return mp

    # -- reads (leader-local, not through the log) ------------------------------

    def _get_inode(self, ino: int) -> Inode:
        inode = self.inodes.get(ino)
        if inode is None:
            raise NoEntry(f"inode {ino}")
        return inode

    def get_inode(self, ino: int) -> Inode:
        self._route_guard(ino)
        return self._get_inode(ino)

    def lookup(self, parent: int, name: str) -> Dentry:
        self._route_guard(parent)
        d = self.dentries.get((parent, name))
        if d is None:
            raise NoEntry(f"{name!r} in {parent}")
        return d

    def read_dir(self, parent: int) -> list[Dentry]:
        self._route_guard(parent)
        self._get_inode(parent)
        return sorted(self.children.get(parent, {}).values(), key=lambda d: d.name)

    def owns_ino(self, ino: int) -> bool:
        return self.start <= ino < self.end

    def multipart_get(self, upload_id: str) -> dict:
        mp = self.multipart.get(upload_id)
        if mp is None:
            raise NoEntry(f"upload {upload_id}")
        return mp

    def multipart_list(self) -> dict[str, dict]:
        return dict(self.multipart)
