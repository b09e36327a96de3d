"""Direct on-disk fault injectors (bypassing every API layer).

These model media faults — the bytes under the service change, the service
is not told. The CRC framing / scrub planes are what must notice.
"""

from __future__ import annotations

import os


def corrupt_shard_on_disk(node, vuid: int, bid: int, flip_at: int = 10) -> None:
    """Flip one payload byte inside a blobnode chunk's crc32block framing,
    bypassing the API (the shared bit-rot injector for the hygiene, soak and
    chaos suites — byte-offset-sensitive, keep the one copy)."""
    from chubaofs_tpu_torch.blobstore.blobnode import HEADER_LEN

    chunk = node._chunk(vuid)
    meta = chunk.shards[bid]
    with open(chunk._data_path, "r+b") as f:
        f.seek(meta.offset + HEADER_LEN + 4 + flip_at)  # into block 0 payload
        b = f.read(1)
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([b[0] ^ 0xFF]))
