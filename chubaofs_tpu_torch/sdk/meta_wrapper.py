"""MetaWrapper — volume-view routing + leader-retry metadata client.

Reference counterpart: sdk/meta (meta.py:113-121 MetaWrapper with an
inode-range btree, api.go Create_ll/Lookup_ll/InodeGet_ll, operation.go's
retry/leader-switch). Routing: an inode belongs to the partition whose
[start, end) contains it; new inodes are created on the partition owning the
parent when it can still allocate (the combined-commit fast path), else on
the TAIL partition (the open range). Every op retries across the partition's
peers until it finds the leader.

Refresh-safe under splits: the view is CACHED (VIEW_TTL, with a
bisect index over partition starts so routing stays O(log n) at hundreds of
partitions) and a `EWRONGPART` reply — the metanode's "your view is stale /
this sub-range is frozen mid-split" signal — triggers a view refresh +
re-route instead of failing the op; mid-split the re-route loop rides the
same retry window the leader-switch path uses.
"""

from __future__ import annotations

import time

from chubaofs_tpu_torch.master.master import MasterError, MetaPartitionView, VolumeView
from chubaofs_tpu_torch.meta.metanode import MetaNode, OpError
from chubaofs_tpu_torch.raft.server import NotLeaderError


class MetaWrapper:
    # cached-view lifetime: error-driven refresh (EWRONGPART) catches splits
    # the instant they matter, so the TTL only bounds how long COLD routing
    # data (new partitions a client never erred on) stays unseen
    VIEW_TTL = 5.0

    def __init__(self, master, metanodes: dict[int, MetaNode], volume: str):
        import itertools
        import uuid

        self.master = master
        self.metanodes = metanodes
        self.volume = volume
        # uniq-op identity (metanode/uniq_checker.go): every mutation carries
        # (client_id, seq) so a retried delivery replays the recorded answer
        # instead of double-applying — which is what makes EIO retries safe
        self.client_id = uuid.uuid4().hex[:16]
        self._uniq = itertools.count(1)
        self._cached_view: VolumeView | None = None
        self._view_expire = 0.0
        # bisect index rebuilt with the cache: (starts[], mps[]) published as
        # ONE tuple — a MetaWrapper is shared across threads (objectnode
        # serves one cached FsClient from many evloop workers), and a reader
        # must never pair a new starts list with an old mps list
        self._route: tuple[list[int], list[MetaPartitionView]] = ([], [])
        # partitions that answered ERANGE (inode range exhausted): skip
        # their combined-create fast path until a refresh shows otherwise
        self._full_pids: set[int] = set()

    # -- routing ---------------------------------------------------------------

    def _view(self) -> VolumeView:
        now = time.monotonic()
        if self._cached_view is None or now >= self._view_expire:
            return self.refresh_view()
        return self._cached_view

    def refresh_view(self) -> VolumeView:
        """Re-fetch the volume view and rebuild the routing index. In-process
        the view object is the master's LIVE state (mutated in place by raft
        apply), so the rebuild re-snapshots the partition list; remotely it
        is a fresh HTTP fetch."""
        view = self.master.get_volume(self.volume)
        mps = sorted(view.meta_partitions, key=lambda m: m.start)
        self._route = ([m.start for m in mps], mps)  # atomic publish
        self._cached_view = view
        self._view_expire = time.monotonic() + self.VIEW_TTL
        self._full_pids.clear()
        return view

    def partition_of(self, ino: int) -> MetaPartitionView:
        """The partition owning `ino`: one bisect over the cached start
        index (O(log n) at hundreds of partitions), with a containment
        re-check — a stale index (split since the last rebuild) misses, and
        ONE refresh re-routes before giving up."""
        import bisect

        self._view()  # ensure the cache is built / TTL-fresh
        for _ in range(2):
            starts, mps = self._route  # one read: starts stays aligned
            i = bisect.bisect_right(starts, ino) - 1
            if i >= 0:
                mp = mps[i]
                # containment re-check: in-process the cached mp objects are
                # LIVE (a split shrank mp.end in place), so a stale index
                # still answers correctly or falls through to the refresh
                if mp.start <= ino < mp.end:
                    return mp
            self.refresh_view()
        raise MasterError(f"no partition owns inode {ino}")

    def tail_partition(self) -> MetaPartitionView:
        self._view()
        return self._route[1][-1]

    # -- leader-retry op execution ---------------------------------------------

    # a fresh partition's raft group needs an election round before it serves;
    # the reference client retries for much longer (sdk/meta/operation.go's
    # SendToMetaPartitionWithTimeOut loop)
    RETRY_WINDOW = 10.0
    RETRY_SLEEP = 0.1

    def _on_partition(self, mp: MetaPartitionView, fn, idempotent: bool = True):
        """Run fn(metanode) on the partition's leader, retrying peers and
        waiting out elections (sdk/meta retry/leader-switch).

        ECONN (connect failed: nothing sent) and ENOPARTITION (replica not
        hosting the shard) always re-aim at another peer. EIO (connection
        died AFTER the request went out) retries only when `idempotent` —
        a mutation may have applied before the reply was lost, and blindly
        re-submitting turns success into EEXIST/ENOENT."""
        RETRYABLE = ("ECONN", "ENOPARTITION") + (("EIO",) if idempotent else ())

        deadline = time.monotonic() + self.RETRY_WINDOW
        last: Exception | None = None
        while True:
            order = [mp.leader] if mp.leader in mp.peers else []
            order += [p for p in mp.peers if p not in order]
            for peer in order:
                node = self.metanodes.get(peer)
                if node is None:
                    continue
                try:
                    return fn(node)
                except NotLeaderError as e:
                    last = e
                    hinted = self.metanodes.get(e.leader) if e.leader in mp.peers else None
                    if hinted is not None and e.leader != peer:
                        try:
                            return fn(hinted)
                        except NotLeaderError as e2:
                            last = e2
                        except OpError as e2:
                            if e2.code not in RETRYABLE:
                                raise
                            last = e2
                except OpError as e:
                    if e.code not in RETRYABLE:
                        raise
                    last = e
            if time.monotonic() >= deadline:
                break
            time.sleep(self.RETRY_SLEEP)
        raise last or MasterError(f"partition {mp.partition_id}: no leader reachable")

    def submit(self, mp: MetaPartitionView, op: str, **args):
        from chubaofs_tpu_torch import chaos
        from chubaofs_tpu_torch.blobstore import trace

        chaos.failpoint("meta.submit")
        # the uniq id makes the mutation idempotent end-to-end, so even an
        # after-send connection loss (EIO) may retry safely
        args["_uniq"] = (self.client_id, next(self._uniq))
        # wall time stamps ride the proposal so every replica applies the
        # identical ctime/mtime (no clock reads inside the state machine)
        args.setdefault("_now", time.time())
        # one child span per mutation: downstream hops (metanode service,
        # raft drain) hang their track entries off the same trace id
        with trace.child_of(trace.current_span(), f"meta.{op}") as span:
            err: Exception | None = None
            try:
                return self._on_partition(
                    mp,
                    lambda node: node.submit_sync(mp.partition_id, op, **args),
                    idempotent=True,
                )
            except Exception as e:
                err = e
                raise
            finally:
                span.append_track_log("meta", err=err)

    # -- split-safe routed execution -------------------------------------------
    #
    # EWRONGPART is the metanode's "this partition no longer (or not yet)
    # serves that inode" reply: the view is stale (a split swapped ownership)
    # or the sub-range is frozen mid-split. Nothing was mutated (the route
    # guard is a pre-check), so the op refreshes the view, re-routes, and
    # retries — once immediately for the common post-swap case, then inside
    # the same bounded window the leader-retry path uses for the brief
    # freeze-to-swap gap.

    def _retry_stale_view(self, attempt, codes: tuple = ("EWRONGPART",)):
        """Run attempt() to completion through stale-route errors: on a code
        in `codes`, refresh the view and retry — once immediately (the
        common post-swap case), then polling each RETRY_SLEEP inside the
        bounded RETRY_WINDOW for the brief freeze-to-swap gap. `attempt`
        re-resolves its own routing per call, so every retry runs against
        the refreshed view. The ONE retry policy for every routed op."""
        deadline = time.monotonic() + self.RETRY_WINDOW
        first = True
        while True:
            try:
                return attempt()
            except OpError as e:
                if e.code not in codes:
                    raise
                if not first:
                    if time.monotonic() >= deadline:
                        raise
                    time.sleep(self.RETRY_SLEEP)
                first = False
                self.refresh_view()

    def _routed_submit(self, route_ino: int, op: str, **args):
        return self._retry_stale_view(
            lambda: self.submit(self.partition_of(route_ino), op, **args))

    def _routed_read(self, route_ino: int, fn):
        """fn(metanode, mp) on the owning partition's leader, re-routing on
        EWRONGPART like _routed_submit."""
        def attempt():
            mp = self.partition_of(route_ino)
            return self._on_partition(mp, lambda n, _mp=mp: fn(n, _mp))

        return self._retry_stale_view(attempt)

    # -- the ll API (api.go analogs) -------------------------------------------

    def create_inode(self, mode: int, uid: int = 0, gid: int = 0,
                     quota_ids: list[int] | None = None):
        """Allocate on the tail partition (the open range), refreshing
        through splits: ERANGE = the cached tail filled and split (cursor
        growth), EWRONGPART = the tail is mid-load-split and its free range
        is moving to the sibling — both re-route to the CURRENT tail."""
        return self._retry_stale_view(
            lambda: self.submit(self.tail_partition(), "create_inode",
                                mode=mode, uid=uid, gid=gid,
                                quota_ids=quota_ids or []),
            codes=("ERANGE", "EWRONGPART"))

    def create_file(self, parent: int, name: str, mode: int,
                    quota_ids: list[int] | None = None):
        """Inode + dentry in ONE commit when the partition owning the parent
        can still allocate inodes — always true on the tail (the open
        range), and true on cursor-split/load-split siblings until their
        bounded range fills. Falls back to the two-op flow (undo-on-conflict
        handled by the CALLER, as FsClient does) by returning None: on
        ERANGE the partition is remembered as full (skipped until the next
        view refresh), on EWRONGPART the view refreshes and the fast path
        RE-CHECKS against the new routing — a split between the route and
        the submit must not silently demote every create to two ops."""
        def attempt():
            mp = self.partition_of(parent)
            if mp.partition_id in self._full_pids:
                return None  # known-exhausted: caller takes the two-op path
            try:
                return self.submit(mp, "create_inode_dentry", parent=parent,
                                   name=name, mode=mode,
                                   quota_ids=quota_ids or [])
            except OpError as e:
                if e.code == "ERANGE":
                    self._full_pids.add(mp.partition_id)
                    return None
                raise

        return self._retry_stale_view(attempt)

    def create_dentry(self, parent: int, name: str, ino: int, mode: int,
                      quota_ids: list[int] | None = None):
        return self._routed_submit(parent, "create_dentry", parent=parent,
                                   name=name, ino=ino, mode=mode,
                                   quota_ids=quota_ids or [])

    def lookup(self, parent: int, name: str):
        return self._routed_read(
            parent, lambda n, mp: n.lookup(mp.partition_id, parent, name))

    def get_inode(self, ino: int):
        return self._routed_read(
            ino, lambda n, mp: n.get_inode(mp.partition_id, ino))

    def read_dir(self, parent: int):
        return self._routed_read(
            parent, lambda n, mp: n.read_dir(mp.partition_id, parent))

    def remove_entry(self, parent: int, name: str, want_dir: bool,
                     quota_ids: list[int] | None = None):
        """Combined lookup + delete_dentry + unlink_inode in one commit
        when the parent's partition also owns the child inode; returns
        (ino, nlink_after) or None when the child lives in another
        partition (caller falls back to the per-op flow)."""
        try:
            res = self._routed_submit(parent, "delete_dentry_unlink",
                                      parent=parent, name=name,
                                      want_dir=want_dir,
                                      quota_ids=quota_ids or [])
        except OpError as e:
            if e.code == "EXDEVPART":
                return None
            raise
        return res[0], res[1]

    def delete_dentry(self, parent: int, name: str,
                      quota_ids: list[int] | None = None):
        return self._routed_submit(parent, "delete_dentry", parent=parent,
                                   name=name, quota_ids=quota_ids or [])

    def unlink_inode(self, ino: int):
        return self._routed_submit(ino, "unlink_inode", ino=ino)

    def evict_inode(self, ino: int):
        return self._routed_submit(ino, "evict_inode", ino=ino)

    def update_inode(self, ino: int, **kw):
        return self._routed_submit(ino, "update_inode", ino=ino, **kw)

    def truncate(self, ino: int, size: int):
        return self._routed_submit(ino, "truncate", ino=ino, size=size)

    def append_extents(self, ino: int, extents: list[dict], size: int):
        return self._routed_submit(ino, "append_extents", ino=ino,
                                   extents=extents, size=size)

    def append_obj_extents(self, ino: int, locations: list[dict], size: int):
        return self._routed_submit(ino, "append_obj_extents", ino=ino,
                                   locations=locations, size=size)

    TX_TTL = 30.0  # prepared-txn lifetime before peers self-resolve

    def rename(self, src_parent: int, src_name: str, dst_parent: int,
               dst_name: str, src_quota_ids: list[int] | None = None,
               dst_quota_ids: list[int] | None = None):
        """POSIX replace semantics: an existing destination is displaced.
        Returns (displaced_ino, displaced_nlink, displaced_is_dir) when a
        destination was displaced (the caller owns its orphan/evict
        contract), else None. A stale-view EWRONGPART (split mid-rename)
        restarts the whole flow on the refreshed view: the local-vs-2PC
        decision itself depends on the routing, so per-op re-route is not
        enough."""
        return self._retry_stale_view(
            lambda: self._rename_once(src_parent, src_name, dst_parent,
                                      dst_name, src_quota_ids,
                                      dst_quota_ids))

    def _rename_once(self, src_parent: int, src_name: str, dst_parent: int,
                     dst_name: str, src_quota_ids: list[int] | None = None,
                     dst_quota_ids: list[int] | None = None):
        import stat as stat_mod

        src_mp = self.partition_of(src_parent)
        dst_mp = self.partition_of(dst_parent)
        if src_mp.partition_id == dst_mp.partition_id:
            # rename-over of a directory whose INODE lives in another
            # partition: the commit's own children check cannot see its
            # dentries, so emptiness is pre-checked at the owning partition
            # (best-effort; the owned case stays atomic in _op_rename_local)
            try:
                dd = self._on_partition(dst_mp, lambda n: n.lookup(
                    dst_mp.partition_id, dst_parent, dst_name))
            except OpError as e:
                if e.code != "ENOENT":
                    raise
                dd = None
            if dd is not None and stat_mod.S_ISDIR(dd.mode) and \
                    self.partition_of(dd.ino).partition_id != \
                    src_mp.partition_id and self._dir_has_children(dd.ino):
                raise OpError("ENOTEMPTY", f"{dst_name!r} in {dst_parent}")
            res = self.submit(
                src_mp, "rename_local", src_parent=src_parent, src_name=src_name,
                dst_parent=dst_parent, dst_name=dst_name,
                src_quota_ids=src_quota_ids or [], dst_quota_ids=dst_quota_ids or [],
            )
            _, ino, nlink, is_dir = res
            if not ino:
                return None
            if nlink == -1:
                # displaced inode lives in another partition: the combined
                # commit dropped its dentry; drop its link here
                nlink = self.unlink_inode(ino).nlink
            return (ino, nlink, is_dir)
        # cross-partition: two-phase transaction (metanode/transaction.go).
        # Prepare takes intent locks + validates on both shards. The DST
        # partition is the transaction manager: its commit is THE decision —
        # committed there means every expired participant rolls forward, not
        # back (metanode sweep asks the TM via tx_status).
        import uuid

        d = self._on_partition(src_mp, lambda n: n.lookup(src_mp.partition_id, src_parent, src_name))
        # replace semantics across partitions: the 2PC create would conflict
        # on Exists at prepare, so an existing destination is removed FIRST
        # in its own commit. Not atomic with the move (a reader can see dst
        # briefly missing), but never two destinations — the single-shard
        # common case stays fully atomic via rename_local above. If the move
        # then fails, the removed destination is restored best-effort below.
        displaced = None
        dd = None
        try:
            dd = self._on_partition(dst_mp, lambda n: n.lookup(
                dst_mp.partition_id, dst_parent, dst_name))
        except OpError as e:
            if e.code != "ENOENT":
                raise
        if dd is not None:
            if dd.ino == d.ino:
                return None  # hard links to one inode: POSIX no-op
            src_is_dir = stat_mod.S_ISDIR(d.mode)
            dst_is_dir = stat_mod.S_ISDIR(dd.mode)
            if src_is_dir and not dst_is_dir:
                raise OpError("ENOTDIR", f"{dst_name!r} in {dst_parent}")
            if not src_is_dir and dst_is_dir:
                raise OpError("EISDIR", f"{dst_name!r} in {dst_parent}")
            if dst_is_dir and self.partition_of(dd.ino).partition_id != \
                    dst_mp.partition_id and self._dir_has_children(dd.ino):
                raise OpError("ENOTEMPTY", f"{dst_name!r} in {dst_parent}")
            res = self.remove_entry(dst_parent, dst_name, want_dir=dst_is_dir,
                                    quota_ids=dst_quota_ids)
            if res is None:  # child inode on a third partition: per-op flow
                self.delete_dentry(dst_parent, dst_name,
                                   quota_ids=dst_quota_ids)
                res = (dd.ino, self.unlink_inode(dd.ino).nlink)
            displaced = (res[0], res[1], dst_is_dir)
        tx_id = f"tx-{self.client_id}-{uuid.uuid4().hex[:12]}"
        # the tx deadline rides the proposal and is compared by every
        # replica's sweep (now=time.time()) — cross-process wall time
        deadline = time.time() + self.TX_TTL  # wallclock: protocol stamp
        tm_pid = dst_mp.partition_id
        plans = [
            (dst_mp, [("create_dentry",
                       {"parent": dst_parent, "name": dst_name,
                        "ino": d.ino, "mode": d.mode,
                        "quota_ids": dst_quota_ids or []})]),
            (src_mp, [("delete_dentry",
                       {"parent": src_parent, "name": src_name,
                        "quota_ids": src_quota_ids or []})]),
        ]
        prepared = []
        try:
            for mp, ops in plans:
                self.submit(mp, "tx_prepare", tx_id=tx_id, ops=ops,
                            deadline=deadline, tm_pid=tm_pid)
                prepared.append(mp)
            # TM commit — the point of no return. After it lands, participant
            # commits are best-effort: the sweep rolls any straggler forward.
            self.submit(dst_mp, "tx_commit", tx_id=tx_id)
        except OpError:
            for mp in prepared:
                try:
                    self.submit(mp, "tx_rollback", tx_id=tx_id)
                except OpError:
                    pass  # expiry sweep covers it
            # a failed rename must leave the destination intact: restore the
            # dentry we removed above (link() also restores the file's
            # nlink; a dir gets its dentry back — best effort by design)
            if displaced is not None and dd is not None:
                try:
                    if stat_mod.S_ISDIR(dd.mode):
                        self.create_dentry(dst_parent, dst_name, dd.ino,
                                           dd.mode, quota_ids=dst_quota_ids)
                    else:
                        self.link(dst_parent, dst_name, dd.ino)
                except OpError:
                    pass  # dst stays missing; its inode is already orphaned
            raise
        try:
            self.submit(src_mp, "tx_commit", tx_id=tx_id)
        except OpError:
            pass  # resolved by the participant sweep against the TM
        return displaced

    def _dir_has_children(self, ino: int) -> bool:
        """Emptiness as seen by the partition that OWNS the directory's
        inode — a dir's child dentries route by the dir's ino, so a check on
        the dst dentry's partition is blind to children living elsewhere."""
        try:
            return bool(self._routed_read(
                ino, lambda n, mp: n.read_dir(mp.partition_id, ino)))
        except OpError as e:
            if e.code == "ENOENT":
                return False  # inode already gone: nothing to orphan
            # a transient failure must NOT read as "empty" — rename-over
            # would displace a non-empty dir and orphan its subtree
            raise

    # -- directory quotas (master_quota_manager + metanode quota analog) --------

    def set_quota(self, dir_ino: int, quota_id: int, max_files: int = 0,
                  max_bytes: int = 0) -> None:
        """Define a subtree quota: fan the definition to every partition (usage
        is charged wherever the op lands) and tag the directory inode."""
        for mp in self._view().meta_partitions:
            self.submit(mp, "set_quota_def", quota_id=quota_id,
                        max_files=max_files, max_bytes=max_bytes)
        ids = self.quota_ids_of(dir_ino)
        if quota_id not in ids:
            ids.append(quota_id)
        import json as _json

        self.set_xattr(dir_ino, "__quota_ids__", _json.dumps(ids).encode())

    def delete_quota(self, quota_id: int) -> None:
        for mp in self._view().meta_partitions:
            self.submit(mp, "delete_quota_def", quota_id=quota_id)

    def quota_ids_of(self, dir_ino: int) -> list[int]:
        """The quota ids a child of dir_ino inherits (client-side resolution,
        the reference's quota-id cache shape)."""
        import json as _json

        inode = self.get_inode(dir_ino)
        raw = inode.xattrs.get("__quota_ids__")
        return _json.loads(raw) if raw else []

    def quota_usage(self, quota_id: int) -> dict:
        """Aggregate usage across partitions (the master report loop's sum)."""
        total = {"files": 0, "bytes": 0}
        for mp in self._view().meta_partitions:
            for node_usage in [self._on_partition(
                    mp, lambda n, _mp=mp: n.quota_usage(_mp.partition_id))]:
                q = node_usage.get(quota_id)
                if q:
                    total["files"] += q["files"]
                    total["bytes"] += q["bytes"]
        return total

    def push_quota_flags(self) -> None:
        """Re-evaluate aggregated usage and distribute `exceeded` flags — one
        round of the reference's master quota report loop. Also re-fans quota
        DEFINITIONS to partitions that miss them (a tail split creates new
        partitions after set_quota ran; until this heals, the new partition
        silently skips those quota ids)."""
        defs: dict[int, dict] = {}
        usage: dict[int, dict] = {}
        per_mp: dict[int, set[int]] = {}
        mps = self._view().meta_partitions
        for mp in mps:
            node_usage = self._on_partition(
                mp, lambda n, _mp=mp: n.quota_usage(_mp.partition_id))
            per_mp[mp.partition_id] = set(node_usage)
            for qid, q in node_usage.items():
                defs[qid] = q
                agg = usage.setdefault(qid, {"files": 0, "bytes": 0})
                agg["files"] += q["files"]
                agg["bytes"] += q["bytes"]
        for qid, agg in usage.items():
            d = defs[qid]
            exceeded = bool(
                (d.get("max_files") and agg["files"] >= d["max_files"])
                or (d.get("max_bytes") and agg["bytes"] >= d["max_bytes"]))
            for mp in mps:
                if qid not in per_mp.get(mp.partition_id, ()):
                    self.submit(mp, "set_quota_def", quota_id=qid,
                                max_files=d.get("max_files", 0),
                                max_bytes=d.get("max_bytes", 0))
                self.submit(mp, "set_quota_flag", quota_id=qid,
                            exceeded=exceeded)

    def link(self, parent: int, name: str, ino: int):
        return self._routed_submit(parent, "link", parent=parent, name=name,
                                   ino=ino)

    def set_xattr(self, ino: int, key: str, value: bytes):
        return self._routed_submit(ino, "set_xattr", ino=ino, key=key,
                                   value=value)

    def remove_xattr(self, ino: int, key: str):
        return self._routed_submit(ino, "remove_xattr", ino=ino, key=key)

    # -- S3 multipart sessions (metanode multipart state, objectnode's backing) --
    # upload_id embeds the owning partition so later ops route without a
    # cluster-wide lookup: "<partition_id>.<random>".

    def multipart_create(self, key: str) -> str:
        import uuid

        mp = self.tail_partition()
        upload_id = f"{mp.partition_id}.{uuid.uuid4().hex[:16]}"
        return self.submit(mp, "multipart_create", key=key, upload_id=upload_id)

    def _multipart_partition(self, upload_id: str):
        try:
            pid = int(upload_id.split(".", 1)[0])
        except ValueError:
            raise OpError("ENOENT", f"malformed upload id {upload_id!r}") from None
        for fresh in (False, True):
            view = self.refresh_view() if fresh else self._view()
            for mp in view.meta_partitions:
                if mp.partition_id == pid:
                    return mp
            # cached view may predate the partition (a just-split sibling):
            # one refresh before declaring the upload gone
        raise OpError("ENOENT", f"partition {pid} for upload {upload_id}")

    def multipart_put_part(self, upload_id: str, part_num: int, location: dict):
        mp = self._multipart_partition(upload_id)
        return self.submit(mp, "multipart_put_part", upload_id=upload_id,
                           part_num=part_num, location=location)

    def multipart_complete(self, upload_id: str) -> dict:
        mp = self._multipart_partition(upload_id)
        return self.submit(mp, "multipart_complete", upload_id=upload_id)

    def multipart_abort(self, upload_id: str) -> dict:
        mp = self._multipart_partition(upload_id)
        return self.submit(mp, "multipart_abort", upload_id=upload_id)

    def multipart_get(self, upload_id: str) -> dict:
        mp = self._multipart_partition(upload_id)
        return self._on_partition(
            mp, lambda n: n.multipart_get(mp.partition_id, upload_id))

    def multipart_list(self) -> dict[str, dict]:
        out: dict[str, dict] = {}
        for mp in self._view().meta_partitions:
            sessions = self._on_partition(
                mp, lambda n, _mp=mp: n.multipart_list(_mp.partition_id))
            out.update(sessions)
        return out
