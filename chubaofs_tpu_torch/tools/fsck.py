"""fsck — offline inode/dentry consistency checker.

Reference counterpart: fsck/ (1,431 LoC: the `cfs-fsck check` / `clean`
commands that cross-walk inode and dentry dumps looking for orphans and
dangling entries). Kept: the same defect taxonomy —

  * dangling dentry: names an inode that no partition holds;
  * orphan inode: held by a partition but reachable by no dentry (and not
    already queued on the freelist);
  * nlink drift: a file inode's link count differs from its dentry count;
  * dir cycle / unreachable subtree: a directory whose walk never reaches
    the root.

`check` reports; `clean` repairs what's safe: dangling dentries are removed,
orphan inodes are unlinked+evicted so the freelist purges their data.
Runs over a MetaWrapper (live cluster or in-proc), so the same tool works
against daemons via RemoteCluster.
"""

from __future__ import annotations

import stat as stat_mod
from dataclasses import dataclass, field

from chubaofs_tpu_torch.meta.metanode import OpError
from chubaofs_tpu_torch.meta.partition import ROOT_INO


@dataclass
class FsckReport:
    inode_count: int = 0
    dentry_count: int = 0
    dangling_dentries: list[tuple[int, str, int]] = field(default_factory=list)
    orphan_inodes: list[int] = field(default_factory=list)
    nlink_drift: list[tuple[int, int, int]] = field(default_factory=list)  # ino, expect, got
    unreachable_dirs: list[int] = field(default_factory=list)
    cleaned: int = 0

    @property
    def clean(self) -> bool:
        return not (self.dangling_dentries or self.orphan_inodes
                    or self.nlink_drift or self.unreachable_dirs)

    def summary(self) -> str:
        lines = [
            f"inodes           : {self.inode_count}",
            f"dentries         : {self.dentry_count}",
            f"dangling dentries: {len(self.dangling_dentries)}",
            f"orphan inodes    : {len(self.orphan_inodes)}",
            f"nlink drift      : {len(self.nlink_drift)}",
            f"unreachable dirs : {len(self.unreachable_dirs)}",
        ]
        if self.cleaned:
            lines.append(f"cleaned          : {self.cleaned}")
        lines.append("status           : " + ("CLEAN" if self.clean else "DIRTY"))
        return "\n".join(lines)


class Fsck:
    ORPHAN_GRACE = 60.0  # seconds an unreferenced inode may be mid-creation

    def __init__(self, meta, orphan_grace: float | None = None):
        """meta: a MetaWrapper for the volume under check."""
        self.meta = meta
        if orphan_grace is not None:
            self.ORPHAN_GRACE = orphan_grace

    # -- collection ------------------------------------------------------------

    def _collect(self):
        """Full namespace dump via per-partition leader reads."""
        inodes: dict[int, object] = {}
        dentries: list = []
        for mp in self.meta._view().meta_partitions:
            # walk the partition's inode range via readdir of known dirs is
            # not enough (orphans have no dentry); ask the SM directly
            sm_inodes = self.meta._on_partition(
                mp, lambda n, _mp=mp: self._dump_partition(n, _mp.partition_id))
            inodes.update(sm_inodes["inodes"])
            dentries += sm_inodes["dentries"]
        return inodes, dentries

    @staticmethod
    def _dump_partition(node, pid: int):
        """Dump one partition — MetaNode and RemoteMetaNode share the
        dump_namespace surface."""
        dump = node.dump_namespace(pid)
        return {"inodes": {i.ino: i for i in dump["inodes"]},
                "dentries": dump["dentries"]}

    # -- check -----------------------------------------------------------------

    def check(self) -> FsckReport:
        inodes, dentries = self._collect()
        rep = FsckReport(inode_count=len(inodes), dentry_count=len(dentries))

        by_ino: dict[int, int] = {}
        children: dict[int, list] = {}
        for d in dentries:
            by_ino[d.ino] = by_ino.get(d.ino, 0) + 1
            children.setdefault(d.parent, []).append(d)
            if d.ino not in inodes:
                rep.dangling_dentries.append((d.parent, d.name, d.ino))

        import time

        now = time.time()
        for ino, inode in inodes.items():
            if ino == ROOT_INO:
                continue
            refs = by_ino.get(ino, 0)
            if refs == 0:
                # a live client creates the inode BEFORE its dentry, and the
                # per-partition dumps aren't atomic — young inodes are likely
                # mid-creation, not orphans (the reference fsck runs offline;
                # online we need the grace window)
                if now - inode.ctime >= self.ORPHAN_GRACE:
                    rep.orphan_inodes.append(ino)
            elif not inode.is_dir and inode.nlink != refs:
                rep.nlink_drift.append((ino, refs, inode.nlink))

        # reachability: BFS from root over dentries
        reachable = {ROOT_INO}
        frontier = [ROOT_INO]
        while frontier:
            nxt = []
            for parent in frontier:
                for d in children.get(parent, []):
                    if d.ino not in reachable:
                        reachable.add(d.ino)
                        if stat_mod.S_ISDIR(d.mode):
                            nxt.append(d.ino)
            frontier = nxt
        for ino, inode in inodes.items():
            if inode.is_dir and ino not in reachable and ino != ROOT_INO:
                rep.unreachable_dirs.append(ino)
        return rep

    # -- clean -----------------------------------------------------------------

    def clean(self) -> FsckReport:
        rep = self.check()
        for parent, name, _ino in rep.dangling_dentries:
            try:
                self.meta.delete_dentry(parent, name)
                rep.cleaned += 1
            except OpError:
                pass
        for ino in rep.orphan_inodes:
            try:
                self.meta.unlink_inode(ino)
                self.meta.evict_inode(ino)
                rep.cleaned += 1
            except OpError:
                pass
        return rep


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="cfs-fsck",
                                description="namespace consistency checker")
    p.add_argument("--addr", action="append", required=True,
                   help="master address (repeatable)")
    p.add_argument("--volume", required=True)
    p.add_argument("mode", choices=["check", "clean"])
    args = p.parse_args(argv)

    from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

    fs = RemoteCluster(args.addr).client(args.volume)
    fsck = Fsck(fs.meta)
    rep = fsck.clean() if args.mode == "clean" else fsck.check()
    print(rep.summary())
    return 0 if rep.clean or args.mode == "clean" else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
