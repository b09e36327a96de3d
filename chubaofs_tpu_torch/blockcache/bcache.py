"""Node-local block cache: frequency-admitted two-tier LRU + unix-socket service.

Reference counterpart: blockcache/bcache — service.go:132 (unix domain socket
listener shared by every client process on the node), manage.go:130
(bcacheManager: blocks cached as local files keyed `volume_inode_offset`,
size-capped LRU with free-ratio eviction), client.go (Get/Put/Evict RPCs).
Wire format here: one JSON header line + raw data bytes, length-prefixed.
The cold-read path docks via FsClient (sdk/data/blobstore/reader.go:30,66
bcache hooks): read-through GET, async-ish PUT after a blobstore read.

The cache plane: zipfian GET traffic is mostly one-hit
wonders at the tail and a small sustained-hot head, so a plain LRU lets one
cold scan flush the whole hot set. The manager now runs TinyLFU-style
admission (arxiv's W-TinyLFU shape, simplified): a counting sketch estimates
every key's access frequency, a ghost list remembers recently-evicted keys,
and a candidate is admitted past a FULL cache only when it is provably
hotter than the LRU victim it would displace (or it just got evicted —
re-reference is the strongest hotness proof there is). Two tiers with
separate budgets: a byte-bounded in-memory overlay (hit = no file IO at
all) over the disk LRU; disk stays authoritative so a daemon restart
rebuilds the index (now in true recency order — file mtimes).
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import struct
import threading
import zlib
from collections import OrderedDict

from chubaofs_tpu_torch.utils.exporter import registry
from chubaofs_tpu_torch.utils.locks import SanitizedLock


class FrequencySketch:
    """Count-min sketch with saturating 4-bit-style counters and periodic
    aging (the TinyLFU "reset" operation): after `sample` recorded accesses
    every counter halves, so the estimate tracks RECENT frequency and a
    formerly-hot key decays instead of squatting on its peak forever."""

    DEPTH = 4
    CAP = 15  # saturation: 4-bit counters, the TinyLFU sweet spot

    def __init__(self, width: int = 4096):
        width = max(64, width)
        self._width = 1 << (width - 1).bit_length()  # power of two
        self._mask = self._width - 1
        self._rows = [bytearray(self._width) for _ in range(self.DEPTH)]
        self._adds = 0
        self._sample = self._width * 8
        self.ages = 0

    def _indexes(self, key: str):
        raw = key.encode()
        h1 = zlib.crc32(raw)
        h2 = zlib.crc32(raw, 0x9E3779B9) | 1  # odd: full-period double hash
        return [(h1 + d * h2) & self._mask for d in range(self.DEPTH)]

    def add(self, key: str) -> None:
        for row, i in zip(self._rows, self._indexes(key)):
            if row[i] < self.CAP:
                row[i] += 1
        self._adds += 1
        if self._adds >= self._sample:
            self._age()

    def _age(self) -> None:
        for row in self._rows:
            for i in range(self._width):
                row[i] >>= 1
        self._adds //= 2
        self.ages += 1

    def estimate(self, key: str) -> int:
        return min(row[i] for row, i in zip(self._rows, self._indexes(key)))


class GhostList:
    """Bounded FIFO of recently-EVICTED keys. A key that comes back while
    its ghost is warm was evicted too early — admission lets it straight
    back in (the ARC/2Q ghost trick grafted onto TinyLFU admission)."""

    def __init__(self, capacity: int = 2048):
        self.capacity = max(16, capacity)
        self._keys: OrderedDict[str, None] = OrderedDict()

    def remember(self, key: str) -> None:
        self._keys.pop(key, None)
        self._keys[key] = None
        while len(self._keys) > self.capacity:
            self._keys.popitem(last=False)

    _MISS = object()

    def recall(self, key: str) -> bool:
        """True (and forgets the ghost) when key was recently evicted."""
        return self._keys.pop(key, self._MISS) is not self._MISS

    def __len__(self) -> int:
        return len(self._keys)


class BcacheManager:
    """Frequency-admitted two-tier cache (manage.go:130 analog, grown).

    Disk tier: blocks as local files, size-capped LRU with free-ratio
    eviction (authoritative — survives restarts). Memory tier: a separately
    byte-bounded LRU overlay holding the bytes of the hottest resident
    blocks, so a mem hit costs zero file IO. Admission: TinyLFU sketch +
    ghost list in front of the disk LRU; `admit="always"` disables the
    policy (plain recency, kept for A/B and for write-heavy
    callers that want pure recency)."""

    def __init__(self, cache_dir: str, capacity_bytes: int = 256 << 20,
                 free_ratio: float = 0.15,
                 mem_capacity_bytes: int = 32 << 20,
                 admit: str = "tinylfu"):
        self.dir = cache_dir
        self.capacity = capacity_bytes
        self.free_ratio = free_ratio
        self.mem_capacity = max(0, mem_capacity_bytes)
        self.admit = admit
        self._lock = SanitizedLock(name="bcache.lru")
        self._lru: OrderedDict[str, int] = OrderedDict()  # key -> size, LRU order
        self._mem: OrderedDict[str, bytes] = OrderedDict()  # hot-byte overlay
        self.used = 0
        self.mem_used = 0
        self.sketch = FrequencySketch(width=max(1024, capacity_bytes >> 16))
        self.ghost = GhostList(capacity=max(256, capacity_bytes >> 18))
        # instance tallies back stats() (several managers per process must
        # not share one series); the registry mirror feeds /metrics
        self.hits = 0
        self.misses = 0
        self.admit_rejects = 0
        self.evictions = 0
        self._mem_hits = 0  # amortized mtime-refresh clock (see get())
        self._reg = registry("bcache")
        os.makedirs(cache_dir, exist_ok=True)
        self._load()

    def _path(self, key: str) -> str:
        h = hashlib.sha256(key.encode()).hexdigest()
        return os.path.join(self.dir, h[:2], h)

    def _load(self):
        """Rebuild the index from cache files surviving a daemon restart,
        ordered by file mtime — directory/hash order would randomize the
        LRU, and the first post-restart eviction would evict an arbitrary
        survivor instead of the actual least-recently-used tail."""
        found: list[tuple[float, str, int]] = []
        for sub in sorted(os.listdir(self.dir)):
            subdir = os.path.join(self.dir, sub)
            if not os.path.isdir(subdir):
                continue
            for name in sorted(os.listdir(subdir)):
                p = os.path.join(subdir, name)
                keyfile = p + ".key"
                if not os.path.exists(keyfile):
                    continue
                with open(keyfile, encoding="utf-8") as f:
                    key = f.read()
                found.append((os.path.getmtime(p), key, os.path.getsize(p)))
        for _, key, size in sorted(found):
            self._lru[key] = size
            self.used += size

    # -- read path -------------------------------------------------------------

    def get(self, key: str, offset: int = 0, size: int | None = None) -> bytes | None:
        with self._lock:
            self.sketch.add(key)  # every lookup is a frequency sample
            entry_size = self._lru.get(key)
            if entry_size is None:
                self.misses += 1
                self._reg.counter("misses").add()
                return None
            self._lru.move_to_end(key)  # touch: MRU
            blk = self._mem.get(key)
            if blk is not None:
                self._mem.move_to_end(key)
                self.hits += 1
                self._mem_hits += 1
                # every Nth mem hit refreshes the backing file's mtime: the
                # restart rebuild orders by mtime, and a block served from
                # the overlay for hours must not restart at the LRU tail.
                # Amortized so the overlay keeps its (near-)zero-IO hits.
                touch = (self._mem_hits & 31) == 0
                self._reg.counter("hits", {"tier": "mem"}).add()
                out = blk[offset:offset + size] if size is not None \
                    else blk[offset:]
            else:
                touch = out = None
        if out is not None:
            if touch:
                try:
                    os.utime(self._path(key))
                except OSError:
                    pass  # recency refresh is best-effort
            return out
        try:
            p = self._path(key)
            with open(p, "rb") as f:
                f.seek(offset)
                data = f.read(size if size is not None else -1)
            # refresh recency where _load can see it: the restart rebuild
            # orders by mtime, so a disk hit must count as a touch (mem-
            # overlay hits skip the syscall — their blocks are by
            # construction the recently-written/hit set already)
            try:
                os.utime(p)
            except OSError:
                pass  # read succeeded; a failed touch must not fake a miss
        except OSError:
            # stale index entry (file vanished out-of-band): this lookup
            # returned nothing, so it IS a miss — hits+misses must account
            # for every lookup or scraped hit ratios over-report
            with self._lock:
                size_gone = self._lru.pop(key, 0)
                self.used -= size_gone
                self._drop_mem_locked(key)
                self.misses += 1
                self._reg.counter("misses").add()
            return None
        with self._lock:
            self.hits += 1
            self._reg.counter("hits", {"tier": "disk"}).add()
            # whole-block disk hits promote into the memory overlay: the
            # next hit on this (evidently warm) block skips the file read.
            # An explicit size covering the whole entry counts — BlobCache
            # always passes the blob's exact size, and `size is None` alone
            # would leave its hottest blocks paying file IO forever.
            # Re-checks under the lock: an evict that raced the unlocked
            # file read must not get its bytes resurrected into the overlay
            # (unreachable, but they would squat on the mem budget), and
            # the bytes must match the entry's CURRENT size — a re-put that
            # truncated/rewrote the file mid-read would otherwise pin a
            # torn prefix into the overlay, served IO-free forever
            if self._lru.get(key) == len(data) and offset == 0 \
                    and (size is None or size >= entry_size):
                self._fill_mem_locked(key, data)
        return data

    # -- write path ------------------------------------------------------------

    def _admit_locked(self, key: str, size: int) -> bool:
        """TinyLFU admission against a FULL cache: the candidate must beat
        the recent frequency of EVERY victim its size would displace (one
        tail comparison would let a single large barely-warmer-than-the-
        coldest-block candidate evict a run of hot blocks — the W-TinyLFU
        victim walk), or hold a warm ghost (it was just evicted and came
        back — admission error, let it in). Rejected candidates still left
        their frequency sample in the sketch, so a key that keeps knocking
        eventually builds the estimate to enter."""
        if self.admit == "always":
            return True
        if self.ghost.recall(key):
            return True
        cand = self.sketch.estimate(key)
        freed = 0
        for victim, vsize in self._lru.items():
            if self.used - freed + size <= self.capacity:
                return True  # enough displaceable-cold space found
            if self.sketch.estimate(victim) > cand:
                return False  # would displace a hotter block
            freed += vsize
        return True

    def put(self, key: str, data: bytes) -> bool:
        """Admission-gated insert; returns False when the policy rejected
        the block (a one-hit wonder must not flush the hot set)."""
        with self._lock:
            self.sketch.add(key)
            would_overflow = key not in self._lru and \
                self.used + len(data) > self.capacity
            if would_overflow and not self._admit_locked(key, len(data)):
                self.admit_rejects += 1
                self._reg.counter("admit_rejects").add()
                return False
        p = self._path(key)
        os.makedirs(os.path.dirname(p), exist_ok=True)
        with open(p, "wb") as f:
            f.write(data)
        with open(p + ".key", "w", encoding="utf-8") as f:
            f.write(key)
        with self._lock:
            old = self._lru.pop(key, 0)
            self._lru[key] = len(data)
            self.used += len(data) - old
            self._fill_mem_locked(key, data)
            evict = self._plan_eviction_locked()
            self._reg.counter("fills").add()
        for k in evict:
            self._delete_files(k)
        return True

    def _fill_mem_locked(self, key: str, data: bytes) -> None:
        if len(data) > self.mem_capacity:
            return
        old = self._mem.pop(key, None)
        if old is not None:
            self.mem_used -= len(old)
        self._mem[key] = data
        self.mem_used += len(data)
        while self.mem_used > self.mem_capacity and self._mem:
            # mem eviction only drops the overlay copy — the block stays
            # resident (and servable) from its disk file
            _, dropped = self._mem.popitem(last=False)
            self.mem_used -= len(dropped)

    def _drop_mem_locked(self, key: str) -> None:
        blk = self._mem.pop(key, None)
        if blk is not None:
            self.mem_used -= len(blk)

    def _plan_eviction_locked(self) -> list[str]:
        """When over capacity, free down to (1 - free_ratio) * capacity."""
        if self.used <= self.capacity:
            return []
        target = int(self.capacity * (1 - self.free_ratio))
        out = []
        for k in list(self._lru):
            if self.used <= target:
                break
            self.used -= self._lru.pop(k)
            self._drop_mem_locked(k)
            self.ghost.remember(k)
            self.evictions += 1
            self._reg.counter("evictions").add()
            out.append(k)
        return out

    def evict(self, key: str):
        with self._lock:
            size = self._lru.pop(key, None)
            if size is None:
                return
            self.used -= size
            self._drop_mem_locked(key)
        self._delete_files(key)

    def _delete_files(self, key: str):
        p = self._path(key)
        for path in (p, p + ".key"):
            try:
                os.unlink(path)
            except OSError:
                pass

    def stats(self) -> dict:
        with self._lock:
            return {"used": self.used, "capacity": self.capacity,
                    "mem_used": self.mem_used,
                    "mem_capacity": self.mem_capacity,
                    "blocks": len(self._lru), "mem_blocks": len(self._mem),
                    "hits": self.hits, "misses": self.misses,
                    "admit_rejects": self.admit_rejects,
                    "evictions": self.evictions}


# -- wire: 4-byte header length + JSON header + raw data -----------------------

def _send_msg(sock: socket.socket, header: dict, data: bytes = b""):
    h = json.dumps(header).encode()
    sock.sendall(struct.pack("<II", len(h), len(data)) + h + data)


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("peer closed")
        buf += chunk
    return buf


def _recv_msg(sock: socket.socket) -> tuple[dict, bytes]:
    hlen, dlen = struct.unpack("<II", _recv_exact(sock, 8))
    header = json.loads(_recv_exact(sock, hlen).decode()) if hlen else {}
    data = _recv_exact(sock, dlen) if dlen else b""
    return header, data


class BcacheService:
    """Unix-socket daemon fronting one BcacheManager (service.go:132)."""

    def __init__(self, sock_path: str, manager: BcacheManager):
        self.sock_path = sock_path
        self.manager = manager
        if os.path.exists(sock_path):
            os.unlink(sock_path)
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(sock_path)
        self._listener.listen(64)
        self._stopping = threading.Event()
        self._thread: threading.Thread | None = None

    def _serve_conn(self, conn: socket.socket) -> None:
        with conn:
            while not self._stopping.is_set():
                try:
                    header, data = _recv_msg(conn)
                except (ConnectionError, OSError):
                    return
                mgr = self.manager
                try:
                    op = header.get("op")
                    if op == "get":
                        blk = mgr.get(header["key"], header.get("offset", 0),
                                      header.get("size"))
                        if blk is None:
                            _send_msg(conn, {"ok": False})
                        else:
                            _send_msg(conn, {"ok": True}, blk)
                    elif op == "put":
                        ok = mgr.put(header["key"], data)
                        _send_msg(conn, {"ok": bool(ok)})
                    elif op == "evict":
                        mgr.evict(header["key"])
                        _send_msg(conn, {"ok": True})
                    elif op == "stats":
                        _send_msg(conn, {"ok": True, **mgr.stats()})
                    else:
                        _send_msg(conn, {"ok": False, "err": "bad op"})
                except (ConnectionError, OSError):
                    return

    def _accept_loop(self) -> None:
        while not self._stopping.is_set():
            try:
                conn, _ = self._listener.accept()
            except OSError:
                return  # listener closed by stop()
            t = threading.Thread(target=self._serve_conn, args=(conn,),  # racelint: host-local unix socket, fan-in bounded by same-node client processes (not user traffic) — the evloop's thousands-of-conns economics don't apply; daemon threads die with the conn
                                 name="bcache-conn", daemon=True)
            t.start()

    def start(self):
        self._thread = threading.Thread(target=self._accept_loop,
                                        name="bcache", daemon=True)
        self._thread.start()
        return self

    def stop(self):
        self._stopping.set()
        try:
            self._listener.close()
        except OSError:
            pass
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        if os.path.exists(self.sock_path):
            os.unlink(self.sock_path)


class BcacheClient:
    """Per-process client with one pooled connection (client.go analog).

    cache_key(volume, ino, offset) mirrors the reference's
    `volume_inode_offset` naming."""

    def __init__(self, sock_path: str):
        self.sock_path = sock_path
        self._lock = SanitizedLock(name="bcache.client")
        self._sock: socket.socket | None = None

    @staticmethod
    def cache_key(volume: str, ino: int, offset: int) -> str:
        return f"{volume}_{ino}_{offset}"

    def _conn_locked(self) -> socket.socket:
        if self._sock is None:
            self._sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
            self._sock.settimeout(5.0)
            self._sock.connect(self.sock_path)
        return self._sock

    def _call(self, header: dict, data: bytes = b"") -> tuple[dict, bytes]:
        with self._lock:
            try:
                sock = self._conn_locked()
                _send_msg(sock, header, data)
                return _recv_msg(sock)
            except (ConnectionError, OSError):
                if self._sock is not None:
                    self._sock.close()
                    self._sock = None
                raise

    def get(self, key: str, offset: int = 0, size: int | None = None) -> bytes | None:
        try:
            header, data = self._call({"op": "get", "key": key,
                                       "offset": offset, "size": size})
        except (ConnectionError, OSError):
            return None  # cache daemon down == cache miss
        return data if header.get("ok") else None

    def put(self, key: str, data: bytes) -> bool:
        try:
            header, _ = self._call({"op": "put", "key": key}, data)
            return bool(header.get("ok"))
        except (ConnectionError, OSError):
            return False

    def evict(self, key: str) -> None:
        try:
            self._call({"op": "evict", "key": key})
        except (ConnectionError, OSError):
            pass

    def stats(self) -> dict | None:
        try:
            header, _ = self._call({"op": "stats"})
        except (ConnectionError, OSError):
            return None
        return header if header.get("ok") else None

    def close(self):
        with self._lock:
            if self._sock is not None:
                self._sock.close()
                self._sock = None
