"""Encoder — the ec.Encoder-equivalent API over the GPU GF(2^8) kernel.

Mirrors the capability surface of reference blobstore/common/ec/encoder.go:41-62
(Encode / Verify / Reconstruct / ReconstructData / Split / Join / GetDataShards /
GetParityShards / GetLocalShards / GetShardsInIdc) and the LRC variant
(lrcencoder.go): global RS(N, M) plus per-AZ local RS over each AZ's global shards.

Differences from the reference, by design:
  * the math runs as batched GF(2^8) matrix products on the encoder's device
    (ops/rs.py: the hand-written CUDA kernel on a GPU, the plain PyTorch
    lowering on the CPU), not per-shard SIMD loops;
  * shards are numpy uint8 views stacked into one (total, k) array per call —
    the stacked form is what the device wants;
  * reconstruct accepts any repairable missing pattern; for LRC it prefers
    AZ-local stripes (the reference's recoverByLocalStripe,
    blobnode/work_shard_recover.go:517) and falls back to the global stripe.

The list-of-buffers API is kept for drop-in familiarity: a user of the reference's
`ec.Encoder` finds the same verbs here. Every encoder runs on the device it
was built for: new_encoder(..., device=None) means the CUDA device, and raises
when there is none; pass device="cpu" to run on the host.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import IO, Sequence

import numpy as np

from chubaofs_tpu_torch.codec.codemode import CodeMode, Tactic, get_tactic
from chubaofs_tpu_torch.ops import gf256, rs

Shards = list[np.ndarray]


class ECError(Exception):
    pass


class ShortDataError(ECError):
    pass


class VerifyError(ECError):
    pass


class InvalidShardsError(ECError):
    pass


@dataclass(frozen=True)
class EncoderConfig:
    """Equivalent of ec.Config (encoder.go:66-71)."""

    code_mode: CodeMode | Tactic
    enable_verify: bool = False

    @property
    def tactic(self) -> Tactic:
        t = self.code_mode
        return t if isinstance(t, Tactic) else get_tactic(t)


def _as_matrix(shards: Sequence[np.ndarray | bytes | bytearray], total: int) -> np.ndarray:
    if len(shards) != total:
        raise InvalidShardsError(f"want {total} shards, got {len(shards)}")
    rows = [np.frombuffer(memoryview(s), dtype=np.uint8) if not isinstance(s, np.ndarray) else s for s in shards]
    k = len(rows[0])
    if k == 0 or any(len(r) != k for r in rows):
        raise InvalidShardsError("shards must be equal-sized and non-empty")
    return np.stack(rows)


def _check_writable(shards: Sequence, idx: Sequence[int]) -> None:
    """Reject read-only output buffers BEFORE any device work is spent."""
    for i in idx:
        dst = shards[i]
        ro = dst.flags.writeable is False if isinstance(dst, np.ndarray) else memoryview(dst).readonly
        if ro:
            raise InvalidShardsError(
                f"shard {i} is read-only; pass bytearray/ndarray for output shards"
            )


def _writeback(shards: Sequence, mat: np.ndarray, idx: Sequence[int]) -> None:
    """Copy repaired/encoded rows back into caller-owned buffers."""
    for i in idx:
        dst = shards[i]
        if isinstance(dst, np.ndarray):
            dst[:] = mat[i]
        else:
            memoryview(dst)[:] = mat[i].tobytes()


class RsEncoder:
    """Plain RS encoder for L == 0 code modes."""

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.tactic = cfg.tactic
        if not self.tactic.is_valid():
            raise ValueError(f"invalid code-mode tactic {self.tactic}")
        if self.tactic.L:
            raise ValueError("use LrcEncoder for L != 0 modes")
        self.device = rs.resolve_device(device)
        self.kernel = rs.get_kernel(self.tactic.N, self.tactic.M, self.device)

    # -- core verbs --------------------------------------------------------

    def encode(self, shards: Sequence) -> None:
        t = self.tactic
        _check_writable(shards, range(t.N, t.total))
        mat = _as_matrix(shards, t.total)
        full = rs.to_numpy(self.kernel.encode(mat[: t.N]))
        if self.cfg.enable_verify and not bool(self.kernel.verify(full)):
            raise VerifyError("post-encode verify failed")
        _writeback(shards, full, range(t.N, t.total))

    def verify(self, shards: Sequence) -> bool:
        mat = _as_matrix(shards, self.tactic.total)
        return bool(self.kernel.verify(mat))

    def reconstruct(self, shards: Sequence, bad_idx: Sequence[int]) -> None:
        self._reconstruct(shards, bad_idx, data_only=False)

    def reconstruct_data(self, shards: Sequence, bad_idx: Sequence[int]) -> None:
        self._reconstruct(shards, bad_idx, data_only=True)

    def _reconstruct(self, shards, bad_idx, data_only: bool) -> None:
        if not bad_idx:
            return
        t = self.tactic
        target = [i for i in bad_idx if i < t.N] if data_only else list(bad_idx)
        _check_writable(shards, target)
        mat = _as_matrix(shards, t.total)
        fixed = rs.to_numpy(self.kernel.reconstruct(mat, list(bad_idx), data_only=data_only))
        _writeback(shards, fixed, target)

    # -- shard bookkeeping (encoder.go:52-62) -------------------------------

    def split(self, data: bytes | bytearray | np.ndarray) -> Shards:
        """Split source data into a full zero-padded shard list (data + parity)."""
        t = self.tactic
        buf = np.frombuffer(memoryview(data), dtype=np.uint8)
        if buf.size == 0:
            raise ShortDataError("empty data")
        size = t.shard_size(buf.size)
        out = np.zeros((t.total, size), dtype=np.uint8)
        flat = out[: t.N].reshape(-1)
        flat[: buf.size] = buf
        return list(out)

    def join(self, dst: IO[bytes], shards: Sequence, out_size: int) -> None:
        """Write the first out_size bytes of the data region; accepts the full
        shard list or just the N data shards."""
        t = self.tactic
        if len(shards) < t.N:
            raise InvalidShardsError(f"join needs >= {t.N} shards")
        mat = _as_matrix(list(shards)[: t.N], t.N)
        data = mat.reshape(-1)
        if out_size > data.size:
            raise ShortDataError(f"join: want {out_size} bytes, have {data.size}")
        dst.write(data[:out_size].tobytes())

    def get_data_shards(self, shards: Sequence) -> list:
        return list(shards[: self.tactic.N])

    def get_parity_shards(self, shards: Sequence) -> list:
        return list(shards[self.tactic.N : self.tactic.N + self.tactic.M])

    def get_local_shards(self, shards: Sequence) -> list:
        return []

    def get_shards_in_idc(self, shards: Sequence, az: int) -> list:
        return [shards[i] for i in self.tactic.shards_in_az(az)]


class LrcEncoder(RsEncoder):
    """LRC: global RS(N, M) plus one local RS per AZ over that AZ's global shards.

    Layout (codemode.go:119-126): shards = N data | M global parity | L local
    parity; each AZ's local stripe is its (N+M)/AZCount global shards plus its
    L/AZCount local parities.
    """

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.tactic = cfg.tactic
        t = self.tactic
        if not t.is_valid():
            raise ValueError(f"invalid code-mode tactic {t}")
        if not t.L:
            raise ValueError("LrcEncoder requires L != 0")
        self.device = rs.resolve_device(device)
        self.kernel = rs.get_kernel(t.N, t.M, self.device)
        self.local_n = (t.N + t.M) // t.az_count
        self.local_m = t.L // t.az_count
        self.local_kernel = rs.get_kernel(self.local_n, self.local_m, self.device)

    def encode(self, shards: Sequence) -> None:
        t = self.tactic
        mat = _as_matrix(shards, t.total)
        full = rs.to_numpy(self.kernel.encode(mat[: t.N]))  # (N+M, k)
        mat[: t.global_count] = full
        self._encode_locals(mat)
        if self.cfg.enable_verify and not self._verify_matrix(mat):
            raise VerifyError("post-encode verify failed")
        _writeback(shards, mat, range(t.N, t.total))

    def _encode_locals(self, mat: np.ndarray, azs: Sequence[int] | None = None) -> None:
        """Fill local-parity rows of mat from its global rows, batched per-AZ.

        azs restricts the recompute to the given AZ indexes (default: all).
        """
        t = self.tactic
        stripes = t.local_stripes()
        if azs is not None:
            stripes = [stripes[a] for a in sorted(set(azs))]
        if not stripes:
            return
        # selected AZ stripes share (local_n, local_m): batch into one kernel call
        src = np.stack([mat[idx[: self.local_n]] for idx, _, _ in stripes])
        parity = rs.to_numpy(self.local_kernel.encode_parity(src))  # (az, local_m, k)
        for a, (idx, _, _) in enumerate(stripes):
            mat[idx[self.local_n :]] = parity[a]

    def _verify_matrix(self, mat: np.ndarray) -> bool:
        t = self.tactic
        if not bool(self.kernel.verify(mat[: t.global_count])):
            return False
        stripes = t.local_stripes()
        full = np.stack([mat[idx] for idx, _, _ in stripes])
        return bool(self.local_kernel.verify(full).all())

    def verify(self, shards: Sequence) -> bool:
        return self._verify_matrix(_as_matrix(shards, self.tactic.total))

    def _reconstruct(self, shards, bad_idx, data_only: bool) -> None:
        if not bad_idx:
            return
        t = self.tactic
        target = [i for i in bad_idx if i < t.N] if data_only else list(bad_idx)
        _check_writable(shards, target)
        mat = _as_matrix(shards, t.total)
        bad = set(int(i) for i in bad_idx)

        # 1. local repair: any AZ whose missing count fits its local stripe
        #    (reference recoverByLocalStripe, work_shard_recover.go:517)
        for idx, local_n, local_m in t.local_stripes():
            az_bad = [i for i in idx if i in bad]
            if not az_bad or len(az_bad) > local_m:
                continue
            sub = mat[idx]  # (local_n+local_m, k)
            pos = {g: p for p, g in enumerate(idx)}
            fixed = rs.to_numpy(
                self.local_kernel.reconstruct(sub, [pos[i] for i in az_bad])
            )
            mat[idx] = fixed
            bad -= set(az_bad)

        # 2. global repair for whatever remains in the global stripe
        global_bad = [i for i in bad if i < t.global_count]
        if global_bad:
            if len(global_bad) > t.M:
                raise InvalidShardsError(
                    f"{len(global_bad)} global shards missing > M={t.M}"
                )
            fixed = rs.to_numpy(
                self.kernel.reconstruct(mat[: t.global_count], global_bad)
            )
            mat[: t.global_count] = fixed
            bad -= set(global_bad)

        # 3. any still-missing local parities: recompute from repaired globals,
        #    only in the AZs that actually lost one
        if bad and not data_only:
            locals_bad = [i for i in bad if i >= t.global_count]
            if locals_bad:
                self._encode_locals(mat, azs=[t.az_of_shard(i) for i in locals_bad])
            bad = {i for i in bad if i < t.global_count}
        if bad and any(i < t.N for i in bad):
            raise InvalidShardsError(f"unrecoverable shards: {sorted(bad)}")

        _writeback(shards, mat, target)

    def get_local_shards(self, shards: Sequence) -> list:
        t = self.tactic
        return list(shards[t.global_count : t.total])


class PmEncoder(RsEncoder):
    """Product-matrix MSR encoder for regenerating code modes (codec/pm.py).

    Same verb surface as RsEncoder — systematic, so split/join and the data
    shards are bit-identical to RsEncoder's at equal shard size. What
    changes is the repair math: reconstruct decodes from any N intact
    nodes via the PM generator. The host builds the PM matrices (numpy,
    codec/pm.py); the byte work of encode, verify and reconstruct runs as
    GF matmuls on the encoder's device, shard rows viewed as sub-unit rows.
    """

    def __init__(self, cfg: EncoderConfig, device=None):
        self.cfg = cfg
        self.tactic = cfg.tactic
        t = self.tactic
        if not t.is_valid():
            raise ValueError(f"invalid code-mode tactic {t}")
        if not t.is_regenerating:
            raise ValueError("PmEncoder requires a regenerating tactic")
        from chubaofs_tpu_torch.codec import pm

        self.device = rs.resolve_device(device)
        self.kernel = pm.get_kernel(t.total, t.N)
        self._parity_bits = rs.bit_operand(self.kernel.parity_mat)

    def _sub_units(self, rows: np.ndarray) -> np.ndarray:
        """(count, S) shard rows -> (count * alpha, S / alpha) sub-unit rows."""
        t = self.tactic
        if rows.shape[1] % t.sub_units:
            raise InvalidShardsError(
                f"shard size {rows.shape[1]} not a multiple of "
                f"sub_units={t.sub_units}")
        return rows.reshape(rows.shape[0] * t.sub_units, -1)

    def _parity(self, data: np.ndarray) -> np.ndarray:
        """(N, S) data shards -> (M, S) PM parity shards, on the device."""
        t = self.tactic
        parity = rs.gf_matmul_hostbatch(self._parity_bits,
                                        self._sub_units(data), self.device)
        return parity.reshape(t.M, data.shape[1])

    def encode(self, shards: Sequence) -> None:
        t = self.tactic
        _check_writable(shards, range(t.N, t.total))
        mat = _as_matrix(shards, t.total)
        full = np.concatenate([mat[: t.N], self._parity(mat[: t.N])])
        if self.cfg.enable_verify and not self._verify_matrix(full):
            raise VerifyError("post-encode verify failed")
        _writeback(shards, full, range(t.N, t.total))

    def _verify_matrix(self, mat: np.ndarray) -> bool:
        return np.array_equal(self._parity(mat[: self.tactic.N]),
                              mat[self.tactic.N:])

    def verify(self, shards: Sequence) -> bool:
        return self._verify_matrix(_as_matrix(shards, self.tactic.total))

    def _reconstruct(self, shards, bad_idx, data_only: bool) -> None:
        if not bad_idx:
            return
        t = self.tactic
        target = [i for i in bad_idx if i < t.N] if data_only else list(bad_idx)
        _check_writable(shards, target)
        mat = _as_matrix(shards, t.total)
        bad = sorted(set(int(i) for i in bad_idx))
        alive = [i for i in range(t.total) if i not in bad]
        if len(alive) < t.N:
            raise ValueError(f"{len(bad)} losses > n-k={t.total - t.N}")
        want = [i for i in bad if i < t.N] if data_only else bad
        if want:
            srv = alive[: t.N]
            dec = rs.bit_operand(self.kernel.decode_matrix(srv, want))
            fixed = rs.gf_matmul_hostbatch(
                dec, self._sub_units(mat[np.asarray(srv)]), self.device)
            mat[np.asarray(want)] = fixed.reshape(len(want), mat.shape[1])
        _writeback(shards, mat, target)


@functools.lru_cache(maxsize=32)
def lrc_parity_matrix(t: Tactic) -> np.ndarray:
    """Composed (M+L, N) GF(2^8) generator: global parity rows plus every AZ's
    local parities expressed directly over the N data shards.

    Every LRC parity is linear over GF(2^8), so the reference's two-stage
    encode (global RS, then per-AZ local RS over data+parity rows —
    lrcencoder.go) composes into ONE matrix: an AZ's local input rows are
    A = [basis rows of its data shards; its global parity rows P_az], and its
    local parity rows are L @ A. One fused matmul then yields ALL parity of an
    LRC stripe — no intermediate stripe materialization, no second HBM pass.
    The result is bit-identical to the two-stage path (same generators).
    """
    if not t.L:
        raise ValueError("lrc_parity_matrix requires L != 0")
    g = gf256.systematic_generator(t.N, t.M)  # (N+M, N)
    P = g[t.N :]
    local_n = (t.N + t.M) // t.az_count
    local_m = t.L // t.az_count
    L = gf256.systematic_generator(local_n, local_m)[local_n:]  # (local_m, local_n)
    ident = np.eye(t.N, dtype=np.uint8)
    rows = [P]
    for idx, _, _ in t.local_stripes():
        A = np.stack(
            [ident[i] if i < t.N else P[i - t.N] for i in idx[:local_n]]
        )  # (local_n, N)
        rows.append(gf256.gf_matmul(L, A))
    return np.concatenate(rows, axis=0)


# the reference interface name, for drop-in reading of call sites
Encoder = RsEncoder | LrcEncoder | PmEncoder


def new_encoder(cfg: EncoderConfig | CodeMode | int | str, device=None,
                **kw) -> Encoder:
    """NewEncoder equivalent (encoder.go:78-112): picks RS vs LRC by
    tactic.L, and the product-matrix encoder for regenerating tactics.
    device=None runs on the CUDA device (and raises without one)."""
    if not isinstance(cfg, EncoderConfig):
        cfg = EncoderConfig(code_mode=get_tactic(cfg), **kw)
    if cfg.tactic.is_regenerating:
        return PmEncoder(cfg, device)
    return LrcEncoder(cfg, device) if cfg.tactic.L else RsEncoder(cfg, device)
