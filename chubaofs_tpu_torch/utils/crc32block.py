"""Block-framed CRC32 codec for chunk datafiles.

Equivalent of reference blobstore/common/crc32block: payloads are framed as
fixed-size blocks, each followed by a 4-byte CRC32 of that block, so torn writes
and bit rot are detected at read time block-by-block (a full-payload CRC can't
say *where* corruption happened and forces whole-shard reads).

Frame layout for payload P split into blocks of BLOCK_SIZE:
    [block0][crc32(block0)][block1][crc32(block1)]...[blockN (short)][crc32]
"""

from __future__ import annotations

import struct
import zlib

BLOCK_SIZE = 64 * 1024
_CRC = struct.Struct("<I")


class CrcError(ValueError):
    """A framed block failed its CRC check."""


def encoded_len(payload_len: int, block_size: int = BLOCK_SIZE) -> int:
    if payload_len == 0:
        return 0
    nblocks = -(-payload_len // block_size)
    return payload_len + 4 * nblocks


def decoded_len(framed_len: int, block_size: int = BLOCK_SIZE) -> int:
    if framed_len == 0:
        return 0
    full = framed_len // (block_size + 4)
    rem = framed_len - full * (block_size + 4)
    if rem == 0:
        return full * block_size
    if rem <= 4:
        raise CrcError(f"framed length {framed_len} leaves a truncated block")
    return full * block_size + (rem - 4)


def encode(payload: bytes | bytearray | memoryview, block_size: int = BLOCK_SIZE) -> bytes:
    view = memoryview(payload)
    out = bytearray(encoded_len(len(view), block_size))
    pos = 0
    for off in range(0, len(view), block_size):
        block = view[off : off + block_size]
        out[pos : pos + len(block)] = block
        pos += len(block)
        _CRC.pack_into(out, pos, zlib.crc32(block))
        pos += 4
    return bytes(out)


def decode(framed: bytes | bytearray | memoryview, block_size: int = BLOCK_SIZE) -> bytes:
    view = memoryview(framed)
    out = bytearray(decoded_len(len(view), block_size))
    pos = 0
    stride = block_size + 4
    for off in range(0, len(view), stride):
        frame = view[off : off + stride]
        block, crc_raw = frame[:-4], frame[-4:]
        if len(crc_raw) != 4:
            raise CrcError("truncated frame")
        (want,) = _CRC.unpack(crc_raw)
        if zlib.crc32(block) != want:
            raise CrcError(f"crc mismatch in block at framed offset {off}")
        out[pos : pos + len(block)] = block
        pos += len(block)
    return bytes(out)


def block_range(offset: int, size: int, block_size: int = BLOCK_SIZE) -> tuple[int, int]:
    """Map a payload byte range to the framed byte range covering it.

    Returns (framed_start, framed_end) such that decoding that slice yields the
    blocks containing [offset, offset+size)."""
    first = offset // block_size
    last = -(-(offset + size) // block_size) if size else first
    stride = block_size + 4
    return first * stride, last * stride
