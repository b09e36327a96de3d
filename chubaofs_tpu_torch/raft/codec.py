"""Safe binary codec for raft wire frames and WAL entries — pickle's replacement.

The reference encodes raft commands and transport frames with explicit binary
encodings (depends/tiglabs/raft proto marshaling; metanode snapshot sections
carry their own CRCs, partition_store.go:57-1033) precisely so that a network
peer can never make the decoder execute anything. Pickle behind an HMAC gate
is RCE-adjacent (a leaked or defaulted secret turns the raft port into an
eval server). This codec closes
that class entirely: decoding constructs only None/bool/int/float/str/bytes/
list/tuple/dict values, never objects.

Wire grammar (tag byte + payload):
    N                 -> None
    T / F             -> True / False
    i <zigzag varint> -> int (arbitrary precision via varint continuation)
    f <8B LE double>  -> float
    s <varint n> <n bytes utf8>  -> str
    b <varint n> <n bytes>       -> bytes
    l <varint n> <n values>      -> list
    t <varint n> <n values>      -> tuple
    d <varint n> <n (key value)> -> dict

Msg batches are encoded schema-less as plain values: a frame is the list of
per-Msg field lists (raft.transport owns the field order). Decode failures
raise CodecError — callers treat the frame as hostile and drop the connection.
"""

from __future__ import annotations

import struct

_F64 = struct.Struct("<d")

MAX_DEPTH = 64


class CodecError(ValueError):
    pass


def _write_varint(out: bytearray, n: int) -> None:
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return


def _zigzag(n: int) -> int:
    return (n << 1) ^ (n >> (n.bit_length() + 1)) if n < 0 else n << 1


def _unzigzag(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def _encode(out: bytearray, v, depth: int) -> None:
    if depth > MAX_DEPTH:
        raise CodecError("value too deeply nested")
    if v is None:
        out.append(ord("N"))
    elif v is True:
        out.append(ord("T"))
    elif v is False:
        out.append(ord("F"))
    elif isinstance(v, int):
        out.append(ord("i"))
        _write_varint(out, _zigzag(v))
    elif isinstance(v, float):
        out.append(ord("f"))
        out += _F64.pack(v)
    elif isinstance(v, str):
        raw = v.encode("utf-8")
        out.append(ord("s"))
        _write_varint(out, len(raw))
        out += raw
    elif isinstance(v, (bytes, bytearray, memoryview)):
        raw = bytes(v)
        out.append(ord("b"))
        _write_varint(out, len(raw))
        out += raw
    elif isinstance(v, tuple):
        out.append(ord("t"))
        _write_varint(out, len(v))
        for x in v:
            _encode(out, x, depth + 1)
    elif isinstance(v, list):
        out.append(ord("l"))
        _write_varint(out, len(v))
        for x in v:
            _encode(out, x, depth + 1)
    elif isinstance(v, dict):
        out.append(ord("d"))
        _write_varint(out, len(v))
        for k, x in v.items():
            _encode(out, k, depth + 1)
            _encode(out, x, depth + 1)
    else:
        raise CodecError(f"unencodable type {type(v).__name__}")


def dumps(v) -> bytes:
    out = bytearray()
    _encode(out, v, 0)
    return bytes(out)


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        if n < 0 or self.pos + n > len(self.buf):
            raise CodecError("truncated value")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def varint(self) -> int:
        shift = 0
        n = 0
        while True:
            if self.pos >= len(self.buf):
                raise CodecError("truncated varint")
            if shift > 630:  # bounds attacker-supplied bignum growth
                raise CodecError("varint too long")
            b = self.buf[self.pos]
            self.pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return n
            shift += 7


def _decode(r: _Reader, depth: int):
    if depth > MAX_DEPTH:
        raise CodecError("value too deeply nested")
    tag = r.take(1)
    if tag == b"N":
        return None
    if tag == b"T":
        return True
    if tag == b"F":
        return False
    if tag == b"i":
        return _unzigzag(r.varint())
    if tag == b"f":
        return _F64.unpack(r.take(8))[0]
    if tag == b"s":
        try:
            return r.take(r.varint()).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CodecError(f"bad utf8: {e}") from None
    if tag == b"b":
        return r.take(r.varint())
    if tag in (b"l", b"t"):
        n = r.varint()
        if n > len(r.buf):  # cheap bound: each element takes >= 1 byte
            raise CodecError("sequence length exceeds frame")
        seq = [_decode(r, depth + 1) for _ in range(n)]
        return tuple(seq) if tag == b"t" else seq
    if tag == b"d":
        n = r.varint()
        if n > len(r.buf):
            raise CodecError("dict length exceeds frame")
        out = {}
        for _ in range(n):
            k = _decode(r, depth + 1)
            try:
                out[k] = _decode(r, depth + 1)
            except TypeError:
                raise CodecError("unhashable dict key") from None
        return out
    raise CodecError(f"unknown tag {tag!r}")


def loads(buf: bytes):
    r = _Reader(bytes(buf))
    v = _decode(r, 0)
    if r.pos != len(r.buf):
        raise CodecError("trailing bytes after value")
    return v
