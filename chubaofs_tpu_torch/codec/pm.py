"""Product-matrix MSR regenerating code over GF(2^8) (repair-traffic codes).

The product-matrix MSR construction (Rashmi-Shah-Kumar, arXiv:1412.3022's
regenerating-code family) at the minimum-storage point: n nodes, k data
nodes, d = 2k-2 repair helpers, alpha = k-1 sub-units per node, beta = 1
sub-unit shipped per helper. A lost shard is rebuilt from d helpers who each
send shard_size/(d-k+1) = shard_size/alpha bytes — d*beta total instead of
the k full shards an RS repair downloads. For the shipped RG6P6 mode
(n=12, k=6, d=10, alpha=5) that is 10/5 = 2 shard-equivalents of download
per repaired shard vs RS(12,4)'s 12 — a 6x cut in repair traffic at the
cost of rate 1/2 storage (vs RS(12,4)'s 3/4).

Construction (all math in GF(2^8), POLY 0x11D):

  * message: the blob's k*alpha sub-units arranged as two symmetric
    alpha x alpha matrices S1, S2 (k*alpha = alpha*(alpha+1) distinct
    symbols = twice an upper triangle);
  * encoding matrix Psi (n x d): row i is the plain Vandermonde row
    (1, x_i, ..., x_i^(d-1)) with x_i = g^i, which factors as
    [phi_i | lambda_i * phi_i] for phi_i = (1, x_i, ..., x_i^(alpha-1))
    and lambda_i = x_i^alpha. Node i stores psi_i^T [S1; S2] — alpha
    symbols per byte column;
  * repair of node f: helper i ships the single symbol phi_f^T w_i
    (its alpha stored symbols combined by the FAILED node's phi row —
    the beta-combine). Stacking d helper symbols gives
    Psi_H [S1 phi_f; S2 phi_f]; Psi_H is d Vandermonde rows, hence
    invertible, and w_f = S1 phi_f + lambda_f S2 phi_f by symmetry. The
    whole decode is ONE (alpha, d) @ (d, L) matmul — window-sized, and
    shaped exactly like the matmul jobs CodecService already drains;
  * any k nodes decode the message (the MSR/MDS property), so the code is
    made SYSTEMATIC by the standard precode: with G_raw the raw
    (n*alpha, k*alpha) generator over the symbol vector,
    G = G_raw @ inv(G_raw[:k*alpha]) stores the blob bytes verbatim on the
    first k nodes — bit-exact with RsEncoder's data layout — while repair
    math is untouched (stored shards are still a product-matrix codeword,
    just of the precoded message).

Distinctness requirements: x_i pairwise distinct (any n <= 255) and
lambda_i = g^(i*alpha) pairwise distinct (n <= 255/gcd(alpha, 255);
51 for alpha=5). Both checked at construction.

Why helpers COMBINE instead of shipping a raw byte range: uncoded-access
(help-by-transfer) MSR at this tiny sub-packetization is impossible —
optimal-access constructions need alpha ~ r^(n/r) sub-units. The product-
matrix code trades a cheap GF combine on the helper (reads its whole local
shard, ships beta bytes) for the bandwidth win; disk reads are unchanged,
NETWORK bytes drop, which is the cost the repair plane actually pays for
cross-node rebuilds.

This module is pure host-side numpy: it builds the tiny generator/repair
matrices (<= 60x30) and provides oracle encode/repair/decode used by tests
and the blobnode beta-combine. The data-plane path submits these matrices
as CodecService matmul jobs so the byte work runs on the device batched
with everything else.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from chubaofs_tpu_torch.ops import gf256


class PMKernel:
    """One (n, k) product-matrix MSR code instance; matrices built once."""

    def __init__(self, n: int, k: int):
        if k < 3:
            raise ValueError(f"PM-MSR needs k >= 3, got k={k}")
        self.n = n
        self.k = k
        self.alpha = k - 1  # sub-units per shard
        self.d = 2 * k - 2  # helpers per repair
        if n <= self.d:
            raise ValueError(
                f"PM-MSR(n={n}, k={k}) needs n > d={self.d} so a single "
                f"loss leaves d helpers")
        if n > gf256.ORDER // math.gcd(self.alpha, gf256.ORDER):
            raise ValueError(
                f"n={n} too large: lambda_i = g^(i*alpha) collide beyond "
                f"{gf256.ORDER // math.gcd(self.alpha, gf256.ORDER)} nodes")
        a = self.alpha
        # x_i = g^i; phi_i = (1, x_i, .., x_i^(a-1)); lambda_i = x_i^a;
        # psi_i = (1, x_i, .., x_i^(d-1)) = [phi_i | lambda_i*phi_i]
        self.x = np.array([gf256.gf_pow(2, i) for i in range(n)], np.uint8)
        self.phi = np.array(
            [[gf256.gf_pow(int(x), j) for j in range(a)] for x in self.x],
            np.uint8)
        self.lam = np.array(
            [gf256.gf_pow(int(x), a) for x in self.x], np.uint8)
        self.psi = np.array(
            [[gf256.gf_pow(int(x), j) for j in range(self.d)] for x in self.x],
            np.uint8)
        assert len(set(self.lam.tolist())) == n, "lambda_i must be distinct"

        # raw generator over the alpha*(alpha+1) = k*alpha distinct symbols
        # of [S1; S2]: stored symbol (i, c) = sum_r psi_i[r] * M[r][c]
        nsym = k * a
        g_raw = np.zeros((n * a, nsym), np.uint8)
        for i in range(n):
            for c in range(a):
                row = i * a + c
                for r in range(self.d):
                    g_raw[row, self._sym(r, c)] ^= self.psi[i, r]
        # systematic precode: first k nodes store the message verbatim
        t = g_raw[: k * a]
        self.G = gf256.gf_matmul(g_raw, gf256.gf_inv_matrix(t))
        assert np.array_equal(self.G[: k * a], np.eye(k * a, dtype=np.uint8))
        self.parity_mat = np.ascontiguousarray(self.G[k * a:])

    def _sym(self, r: int, c: int) -> int:
        """Column index of symbol M[r][c]: S1 upper triangle then S2's."""
        a = self.alpha
        half = a * (a + 1) // 2
        off = 0
        if r >= a:  # S2 block
            r -= a
            off = half
        lo, hi = (r, c) if r <= c else (c, r)
        return off + lo * a - lo * (lo - 1) // 2 + (hi - lo)

    # -- repair-plane matrices (host-built, device-applied) -----------------

    def helper_coeffs(self, fail: int) -> np.ndarray:
        """phi_f (alpha,) — the combine coefficients a helper applies to its
        alpha sub-units to produce the beta payload for failed node f."""
        return np.array(self.phi[fail], np.uint8)

    def repair_matrix(self, fail: int, helpers: list[int]) -> np.ndarray:
        """(alpha, d) decode matrix R: failed shard (alpha, L) = R @ P with
        P the (d, L) stacked helper payloads in `helpers` order."""
        if len(helpers) != self.d or fail in helpers:
            raise ValueError(f"need {self.d} helpers != failed {fail}")
        inv = gf256.gf_inv_matrix(self.psi[np.asarray(helpers)])
        a = self.alpha
        # R = [I_a | lambda_f * I_a] @ inv(Psi_H)
        return inv[:a] ^ gf256.gf_mul(self.lam[fail], inv[a: 2 * a])

    def decode_matrix(self, survivors: list[int],
                      want: list[int]) -> np.ndarray:
        """Generic any-k decode (the multi-loss fallback): given k survivor
        NODES' full shards stacked as (k*alpha, L) sub-unit rows, the
        (len(want)*alpha, k*alpha) matrix rebuilding the wanted nodes."""
        if len(survivors) != self.k:
            raise ValueError(f"need exactly k={self.k} survivors")
        a = self.alpha
        rows = np.concatenate([self.G[i * a: (i + 1) * a] for i in survivors])
        inv = gf256.gf_inv_matrix(rows)  # MSR any-k property: invertible
        wrows = np.concatenate([self.G[i * a: (i + 1) * a] for i in want])
        return gf256.gf_matmul(wrows, inv)

    # -- numpy oracle verbs (tests, blobnode combine, host fallback) --------

    def split_shard(self, shard: bytes | np.ndarray) -> np.ndarray:
        """One shard's bytes as its (alpha, L) sub-unit matrix."""
        buf = np.frombuffer(memoryview(shard), np.uint8) \
            if not isinstance(shard, np.ndarray) else shard
        if buf.size % self.alpha:
            raise ValueError(
                f"shard size {buf.size} not a multiple of alpha={self.alpha}")
        return buf.reshape(self.alpha, -1)

    def helper_payload(self, fail: int, shard: bytes | np.ndarray) -> bytes:
        """The beta = shard/alpha bytes helper ships for failed node f:
        phi_f combined over the helper's own sub-units."""
        sub = self.split_shard(shard)
        return gf256.gf_matmul(self.phi[fail][None, :], sub).tobytes()

    def repair(self, fail: int, helpers: list[int],
               payloads: np.ndarray) -> np.ndarray:
        """payloads (d, L) in `helpers` order -> the failed shard's bytes
        (alpha*L,)."""
        mat = self.repair_matrix(fail, helpers)
        return gf256.gf_matmul(mat, np.asarray(payloads, np.uint8)).reshape(-1)

    def encode(self, data: np.ndarray) -> np.ndarray:
        """data (k, S) node-major shards -> full (n, S) stripe (oracle)."""
        k, size = data.shape
        if k != self.k:
            raise ValueError(f"want {self.k} data shards, got {k}")
        msg = np.asarray(data, np.uint8).reshape(self.k * self.alpha, -1)
        parity = gf256.gf_matmul(self.parity_mat, msg)
        return np.concatenate(
            [np.asarray(data, np.uint8),
             parity.reshape(self.n - self.k, size)])

    def reconstruct(self, shards: np.ndarray, bad_idx: list[int],
                    data_only: bool = False) -> np.ndarray:
        """Full-stripe oracle rebuild from any k intact nodes (the fallback
        path's math): shards (n, S) with garbage rows at bad_idx."""
        bad = sorted(set(int(i) for i in bad_idx))
        if not bad:
            return np.array(shards, copy=True)
        alive = [i for i in range(self.n) if i not in bad]
        if len(alive) < self.k:
            raise ValueError(f"{len(bad)} losses > n-k={self.n - self.k}")
        want = [i for i in bad if i < self.k] if data_only else bad
        out = np.array(shards, np.uint8, copy=True)
        if not want:
            return out
        srv = alive[: self.k]
        mat = self.decode_matrix(srv, want)
        stacked = np.concatenate([self.split_shard(out[i]) for i in srv])
        fixed = gf256.gf_matmul(mat, stacked)
        size = out.shape[1]
        out[np.asarray(want)] = fixed.reshape(len(want), size)
        return out

    def verify(self, shards: np.ndarray) -> bool:
        """Parity check: recompute parity rows from the data rows."""
        mat = np.asarray(shards, np.uint8)
        return np.array_equal(self.encode(mat[: self.k]), mat)


@functools.lru_cache(maxsize=16)
def get_kernel(n: int, k: int) -> PMKernel:
    return PMKernel(n, k)
