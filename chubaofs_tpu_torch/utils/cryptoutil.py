"""Crypto primitives for the auth plane (util/cryptoutil analog).

Reference counterpart: util/cryptoutil — AES-256-GCM authenticated encryption
+ HMAC message auth + base64 key/ticket serialization, used by authnode and
its clients. This environment has no AES primitive in-tree, so the AEAD here
is the standard encrypt-then-MAC composition over stdlib hashes: an HMAC-
SHA256 counter-mode keystream for confidentiality and an HMAC-SHA256 tag over
nonce+ciphertext for integrity — same interface, same security role
(symmetric AEAD under a shared service key), swappable for AES-GCM where one
exists.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct


class AuthTagError(Exception):
    pass


def gen_key() -> bytes:
    return os.urandom(32)


def _keystream(key: bytes, nonce: bytes, length: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < length:
        out += hmac.new(key, nonce + struct.pack("<Q", counter),
                        hashlib.sha256).digest()
        counter += 1
    return bytes(out[:length])


def _subkeys(key: bytes) -> tuple[bytes, bytes]:
    enc = hmac.new(key, b"enc", hashlib.sha256).digest()
    mac = hmac.new(key, b"mac", hashlib.sha256).digest()
    return enc, mac


def seal(key: bytes, plaintext: bytes, aad: bytes = b"") -> bytes:
    """AEAD encrypt: nonce(16) || ciphertext || tag(32)."""
    enc_key, mac_key = _subkeys(key)
    nonce = os.urandom(16)
    ct = bytes(a ^ b for a, b in zip(plaintext,
                                     _keystream(enc_key, nonce, len(plaintext))))
    tag = hmac.new(mac_key, nonce + ct + aad, hashlib.sha256).digest()
    return nonce + ct + tag


def open_sealed(key: bytes, blob: bytes, aad: bytes = b"") -> bytes:
    """AEAD decrypt; raises AuthTagError on any tamper."""
    if len(blob) < 48:
        raise AuthTagError("sealed blob too short")
    nonce, ct, tag = blob[:16], blob[16:-32], blob[-32:]
    enc_key, mac_key = _subkeys(key)
    want = hmac.new(mac_key, nonce + ct + aad, hashlib.sha256).digest()
    if not hmac.compare_digest(want, tag):
        raise AuthTagError("auth tag mismatch")
    return bytes(a ^ b for a, b in zip(ct, _keystream(enc_key, nonce, len(ct))))


def hmac_sha256(key: bytes, msg: bytes) -> bytes:
    return hmac.new(key, msg, hashlib.sha256).digest()


def verify_hmac(key: bytes, msg: bytes, tag: bytes) -> bool:
    return hmac.compare_digest(hmac_sha256(key, msg), tag)
