"""preload — warm the node-local block cache with cold-tier data.

Reference counterpart: preload/ (865 LoC: walks a cold volume's subtree and
pulls data through the cache tier ahead of a training job's reads). Kept:
subtree walk with concurrency, read-through the bcache so warmed extents
serve later reads locally, a byte/file budget, and a summary report.
"""

from __future__ import annotations

import concurrent.futures as futures
from dataclasses import dataclass

from chubaofs_tpu_torch.sdk.fs import FsClient, FsError


@dataclass
class PreloadStats:
    files: int = 0
    bytes: int = 0
    errors: int = 0

    def summary(self) -> str:
        return (f"preloaded {self.files} files / {self.bytes} bytes"
                f" ({self.errors} errors)")


class Preloader:
    def __init__(self, fs: FsClient, workers: int = 8,
                 max_bytes: int | None = None, chunk: int = 4 << 20):
        """fs should carry a bcache for the warmth to persist locally; without
        one this still validates readability end-to-end."""
        self.fs = fs
        self.workers = workers
        self.max_bytes = max_bytes
        self.chunk = chunk

    def _walk(self, path: str):
        st = self.fs.stat(path)
        if not st["is_dir"]:
            yield path, st["size"]
            return
        stack = [path.rstrip("/") or "/"]
        while stack:
            d = stack.pop()
            for name in self.fs.readdir(d):
                child = f"{d.rstrip('/')}/{name}"
                try:
                    cst = self.fs.stat(child)
                except FsError:
                    continue
                if cst["is_dir"]:
                    stack.append(child)
                else:
                    yield child, cst["size"]

    def _pull(self, path: str, size: int) -> int:
        pulled = 0
        for off in range(0, size, self.chunk):
            n = min(self.chunk, size - off)
            data = self.fs.read_file(path, off, n)
            pulled += len(data)
        return pulled

    def run(self, path: str = "/") -> PreloadStats:
        stats = PreloadStats()
        budget = self.max_bytes
        with futures.ThreadPoolExecutor(max_workers=self.workers) as pool:
            pending = {}
            for fpath, size in self._walk(path):
                if budget is not None:
                    if budget <= 0:
                        break
                    budget -= size
                pending[pool.submit(self._pull, fpath, size)] = fpath
            for fut in futures.as_completed(pending):
                try:
                    stats.bytes += fut.result()
                    stats.files += 1
                except (FsError, OSError):
                    stats.errors += 1
        return stats


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="cfs-preload",
                                description="warm the local block cache")
    p.add_argument("--addr", action="append", required=True)
    p.add_argument("--volume", required=True)
    p.add_argument("--access", action="append", default=None,
                   help="blobstore access gateway (cold volumes)")
    p.add_argument("--path", default="/")
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--max-bytes", type=int, default=None)
    args = p.parse_args(argv)

    from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

    fs = RemoteCluster(args.addr, access_addrs=args.access).client(args.volume)
    stats = Preloader(fs, workers=args.workers,
                      max_bytes=args.max_bytes).run(args.path)
    print(stats.summary())
    return 0 if stats.errors == 0 else 1


if __name__ == "__main__":
    import sys

    sys.exit(main())
