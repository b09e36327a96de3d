"""Reed-Solomon encode/reconstruct as GF(2^8) matrix products (the GPU hot loop).

Reference counterpart: klauspost/reedsolomon's Encode/Reconstruct SIMD loops behind
CubeFS's ec.Encoder (reference blobstore/common/ec/encoder.go:41-151). Both
operations are ONE primitive, a GF(2^8) matrix product

    out = M (x) shards

with M the generator's parity block (encode) or rows of
gen[missing] @ inv(gen[survivors]) (reconstruct), computed on the host in numpy
(tiny, O(n^3) on n<=36 matrices) and handed to the device as runtime data — so
ONE compiled kernel serves every encode, decode and repair pattern.

Matrices travel in the byte-major (8r, 8n) GF(2) bit-matrix form
(ops/bitmatrix.py) and stay on the host: the plain version and B2 multiply
by the bits, B1 by split tables built from each 8x8 block of them. Data
tensors live on the caller's device:

  * a CUDA tensor goes to a hand-written kernel, which launches or raises —
    there is no fallback: B1 (ops/cuda_gf.py) by default, B2, the pipelined
    tensor-core kernel (ops/cuda_gf_pipe.py), when CFS_GF_PIPELINED is "1"
    (dynamic slots) or "static" (static slots), read on every call as the
    JAX package's dispatcher reads it;
  * a CPU tensor goes to gf_matmul_tables, a plain PyTorch version that looks
    each byte up in a 256-entry table per 8x8 block (the same bytes as
    gf_matmul_bytes, quicker on the host than its bit lowering), whatever
    CFS_GF_PIPELINED says (the JAX package too takes the kernels off the TPU).

Batching: all kernels take (..., n, k) with arbitrary leading batch dims; the
bulk-repair path stacks many stripes into one call.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from chubaofs_tpu_torch import chaos
from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf, cuda_gf_pipe, gf256

BITS = 8


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: what the caller named, else the
    CUDA device. With no device named and no GPU present this raises — an
    entry point never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run on the host")
    return torch.device("cuda", torch.cuda.current_device())


def to_numpy(x) -> np.ndarray:
    """Host numpy view/copy of a tensor (or the array itself)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(x, device: torch.device) -> torch.Tensor:
    """numpy or tensor -> contiguous uint8 tensor on `device`."""
    if isinstance(x, torch.Tensor):
        if x.dtype != torch.uint8:
            raise ValueError(f"want uint8 shards, got {x.dtype}")
        return x.to(device).contiguous()
    arr = np.ascontiguousarray(x, np.uint8)
    if not arr.flags.writeable:  # torch.from_numpy wants writable memory
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def mat_tensor(mat_bits) -> torch.Tensor:
    """A bit matrix as the host int8 tensor the port keeps matrices in."""
    if isinstance(mat_bits, torch.Tensor):
        return mat_bits.detach().to("cpu", torch.int8)
    return torch.from_numpy(np.ascontiguousarray(mat_bits, np.int8))


def unpack_bits(x: torch.Tensor) -> torch.Tensor:
    """(..., n, k) uint8 -> (..., 8n, k) int8 of {0,1}, LSB-first rows."""
    bitpos = torch.arange(BITS, dtype=torch.uint8, device=x.device)
    b = (x.unsqueeze(-2) >> bitpos[:, None]) & 1
    return b.reshape(*x.shape[:-2], x.shape[-2] * BITS, x.shape[-1]).to(torch.int8)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8m, k) {0,1} -> (..., m, k) uint8."""
    m = bits.shape[-2] // BITS
    b = bits.reshape(*bits.shape[:-2], m, BITS, bits.shape[-1]).to(torch.int32)
    weights = 1 << torch.arange(BITS, dtype=torch.int32, device=bits.device)
    return (b * weights[:, None]).sum(dim=-2).to(torch.uint8)


def gf_matmul_bytes(mat_bits, shards: torch.Tensor) -> torch.Tensor:
    """The plain version: GF(2^8) matrix product via the bit-matrix lowering.

    mat_bits: (8r, 8n) GF(2) matrix (from bitmatrix.expand_matrix).
    shards:   (..., n, k) uint8 tensor, on any device.
    returns:  (..., r, k) uint8 = GFmat @ shards, per batch element.

    unpack -> bit product -> & 1 -> pack, as the JAX package's XLA lowering.
    The product runs in float32 on {0,1} values on every device (CUDA has no
    integer matmul, and on the CPU float32 BLAS is ~3x an int32 matmul):
    exact, since every sum is <= 8n < 2^24 and 0/1 survive even TF32's input
    rounding (chip_smoke.py sets allow_tf32 = False all the same)."""
    mat = mat_tensor(mat_bits).to(shards.device)
    bits = unpack_bits(shards)
    acc = torch.matmul(mat.to(torch.float32), bits.to(torch.float32))
    return pack_bits(acc.to(torch.int32) & 1)


def byte_tables(mat_bits) -> torch.Tensor:
    """(r, n, 256) uint8: entry [i, j, v] is the 8x8 GF(2) block (i, j) of an
    (8r, 8n) bit matrix applied to byte v. Any GF(2) matrix has them."""
    mat = mat_tensor(mat_bits).to(torch.int32)
    r, n = mat.shape[0] // BITS, mat.shape[1] // BITS
    pos = torch.arange(BITS, dtype=torch.int32)
    vbits = (torch.arange(256, dtype=torch.int32)[None, :] >> pos[:, None]) & 1
    blocks = mat.reshape(r, BITS, n, BITS).permute(0, 2, 1, 3)
    out_bits = torch.matmul(blocks, vbits) & 1  # (r, n, 8, 256)
    return (out_bits << pos[:, None]).sum(dim=-2).to(torch.uint8)


def gf_matmul_tables(mat_bits, shards: torch.Tensor) -> torch.Tensor:
    """The plain version by table lookup, the host's path: out row i is the
    XOR over input rows j of byte_tables[i, j] gathered at row j's bytes.
    Equal to gf_matmul_bytes byte for byte; on any device."""
    tabs = byte_tables(mat_bits).to(shards.device)
    r, n = tabs.shape[:2]
    lead, k = shards.shape[:-2], shards.shape[-1]
    if shards.shape[-2] != n:
        raise ValueError(f"matrix {tuple(mat_bits.shape)} does not match "
                         f"shards {tuple(shards.shape)}")
    x = shards.reshape(-1, n, k)
    b = x.shape[0]
    out = torch.zeros((b, r, k), dtype=torch.uint8, device=shards.device)
    if r and b and k:
        idx = x.to(torch.int64)
        for j in range(n):
            out ^= torch.gather(tabs[:, j, :].expand(b, r, 256), 2,
                                idx[:, j:j + 1, :].expand(b, r, k))
    return out.reshape(*lead, r, k)


def gf_matmul_dispatch(mat_bits, shards: torch.Tensor) -> torch.Tensor:
    """A kernel for a CUDA tensor (B2 when CFS_GF_PIPELINED is "1" or
    "static", else B1), the plain version by table lookup for a CPU
    tensor."""
    if shards.device.type == "cuda":
        pipe = os.environ.get("CFS_GF_PIPELINED", "")
        if pipe in ("1", "static"):
            return cuda_gf_pipe.gf_matmul_bytes_pipelined(
                mat_bits, shards, static_slots=pipe == "static")
        return cuda_gf.gf_matmul(mat_bits, shards)
    if shards.device.type == "cpu":
        return gf_matmul_tables(mat_bits, shards)
    raise ValueError(f"no GF(2^8) matmul for device {shards.device}")


def group_stack(mat_bits, batch: int) -> tuple[np.ndarray, int]:
    """(matrix, g) for a batch of stripes; always (mat, 1) here.

    The JAX package stacks g stripes' generators block-diagonally to fill the
    TPU's 128-row matrix unit. The CUDA kernel has no such unit to fill, so
    the matrix passes through unchanged; the function stays for API parity."""
    return np.asarray(to_numpy(mat_bits), np.int8), 1


def host_buffer(shape, device: torch.device) -> torch.Tensor:
    """Host staging tensor for a batch: page-locked when it feeds a CUDA
    device (so the copies are asynchronous DMA), plain memory otherwise."""
    return torch.empty(shape, dtype=torch.uint8, pin_memory=device.type == "cuda")


def gf_matmul_hostbatch(mat_bits, shards, device=None) -> np.ndarray:
    """Host-boundary batched GF matmul: host (..., n, k) uint8 in (numpy, or a
    host tensor such as a host_buffer) -> host numpy (..., r, k).

    On a CUDA device: copy to the card, launch the kernel, copy the result
    into a page-locked host buffer and wait for the stream. This is the batch
    entry the codec service uses."""
    device = resolve_device(device)
    host = shards if isinstance(shards, torch.Tensor) else as_tensor(
        shards, torch.device("cpu"))
    lead, n, k = tuple(host.shape[:-2]), host.shape[-2], host.shape[-1]
    r = mat_bits.shape[0] // BITS
    b = 1
    for d in lead:
        b *= d
    if b == 0 or r == 0 or k == 0:
        return np.zeros((*lead, r, k), np.uint8)
    flat = host.reshape(b, n, k)
    if device.type == "cuda":
        out = gf_matmul_dispatch(mat_bits, flat.to(device, non_blocking=True))
        res = host_buffer(tuple(out.shape), device)
        res.copy_(out, non_blocking=True)
        torch.cuda.current_stream(device).synchronize()
    else:
        res = gf_matmul_dispatch(mat_bits, flat.contiguous())
    return res.numpy().reshape(*lead, r, k)


def xor_reduce(shards: torch.Tensor) -> torch.Tensor:
    """XOR over the shard axis: (..., n, k) -> (..., k). Used by CRC/verify paths."""
    return functools.reduce(torch.bitwise_xor, shards.unbind(-2))


def plan_from_numpy(mat_bits, present=None, missing=None, device=None):
    """The port's form of a matrix or repair plan made by numpy (the JAX
    package's, or this package's own host code): the bit matrix as a host
    int8 tensor, present/missing as int64 index tensors on `device`.

    mat_bits alone -> the matrix tensor; with present and missing -> the
    (mat_bits, present, missing) triple that RSKernel.apply_repair takes."""
    mat = mat_tensor(mat_bits)
    if present is None and missing is None:
        return mat
    device = resolve_device(device)

    def idx(v):
        return torch.as_tensor(np.asarray(v, np.int64).reshape(-1), device=device)

    return mat, idx(present), idx(missing)


class RSKernel:
    """GF(2^8) codec for one (n, m) systematic layout on one device.

    Host-side numpy builds the generator and per-repair decode matrices; the
    device only ever sees one shape-polymorphic GF matmul. All methods accept
    numpy arrays, uint8 tensors, or anything numpy can read (a sharded
    result of parallel/mesh.py, gathered) with shape (n_in, k) or
    (B, n_in, k) and return tensors on the kernel's device.
    """

    def __init__(self, n: int, m: int, device=None):
        if n <= 0 or m < 0 or n + m > 256:
            raise ValueError(f"invalid RS layout n={n} m={m}")
        self.n = n
        self.m = m
        self.total = n + m
        self.device = resolve_device(device)
        self.gen = gf256.systematic_generator(n, m)  # (n+m, n) uint8
        # host-resident like every matrix of the port: the kernel wrapper
        # reads its coefficients on the host and caches tables per device
        self.parity_bits = plan_from_numpy(
            bitmatrix.expand_matrix(self.gen[n:, :]))

    # -- encode ------------------------------------------------------------

    #
    # portable=True runs the plain PyTorch lowering (gf_matmul_bytes) on the
    # kernel's device instead of the dispatch (B1/B2 on a CUDA tensor), as
    # the JAX package's portable=True runs its einsum lowering. The caller
    # names it; the default stays the kernel.

    def encode_parity(self, data, *, portable: bool = False) -> torch.Tensor:
        """(..., n, k) data -> (..., m, k) parity."""
        # hot-path failpoint: a near-free no-op while unarmed
        chaos.failpoint("rs.encode")
        fn = gf_matmul_bytes if portable else gf_matmul_dispatch
        return fn(self.parity_bits, as_tensor(data, self.device))

    def encode(self, data, *, portable: bool = False) -> torch.Tensor:
        """(..., n, k) data -> (..., n+m, k) full stripe."""
        data = as_tensor(data, self.device)
        return torch.cat([data, self.encode_parity(data, portable=portable)], dim=-2)

    # -- reconstruct -------------------------------------------------------

    def repair_matrix(self, bad_idx: list[int], data_only: bool = False) -> tuple[np.ndarray, list[int], list[int]]:
        """Host-side: (matrix mapping survivors->missing, survivor rows, missing rows).

        survivor rows are the first n present indices; matrix is GF(2^8) of shape
        (len(missing), n), already verified invertible via decode_matrix.
        """
        bad = sorted(set(int(i) for i in bad_idx))
        for i in bad:
            if not 0 <= i < self.total:
                raise ValueError(f"bad shard index {i}")
        if len(bad) > self.m:
            raise ValueError(f"{len(bad)} missing shards > m={self.m}, unrecoverable")
        present = [i for i in range(self.total) if i not in set(bad)][: self.n]
        dec = gf256.decode_matrix(self.gen, present)  # (n, n)
        missing = [i for i in bad if i < self.n] if data_only else bad
        mat = gf256.gf_matmul(self.gen[np.asarray(missing), :], dec) if missing else np.zeros((0, self.n), np.uint8)
        return mat, present, missing

    def window_matrix(self, present: list[int], want: list[int]) -> np.ndarray:
        """Row-sliced decode matrix for ranged reads: the GF(2^8) map from
        exactly n survivor rows (in `present` order) to exactly the `want`
        shard rows — gen[want] @ inv(gen[present]).

        Takes the caller's survivor CHOICE as-is and computes only the rows
        the byte window needs, so degraded decode cost scales with the
        window, not the stripe. RS is column-independent, so the same matrix
        applied to column-sliced survivors yields the identical column slice
        of the wanted shards.
        """
        present = [int(i) for i in present]
        want = [int(i) for i in want]
        if len(present) != self.n:
            raise ValueError(
                f"window decode needs exactly n={self.n} survivors, "
                f"got {len(present)}")
        for i in present + want:
            if not 0 <= i < self.total:
                raise ValueError(f"bad shard index {i}")
        if not want:
            return np.zeros((0, self.n), np.uint8)
        dec = gf256.decode_matrix(self.gen, present)  # (n, n)
        return gf256.gf_matmul(self.gen[np.asarray(want), :], dec)

    def repair_plan(self, bad_idx: list[int], data_only: bool = False):
        """Device-ready repair plan: (repair_bits host int8 tensor, present,
        missing index tensors on the kernel's device)."""
        mat, present, missing = self.repair_matrix(bad_idx, data_only)
        return self._device_plan(mat, present, missing)

    def _device_plan(self, mat, present, missing):
        return plan_from_numpy(bitmatrix.expand_matrix(mat), present, missing,
                               self.device)

    def repair_plan_padded(self, bad_idx: list[int], data_only: bool = False):
        """Fixed-shape repair plan: always m repair rows. Padded slots carry
        the GF identity row of survivor 0 and target survivor 0's own
        position: a value-level no-op write. Returns (repair_bits (8m, 8n),
        present (n,), missing (m,)).
        """
        mat, present, missing = self.repair_matrix(bad_idx, data_only)
        pad = self.m - len(missing)
        if pad:
            id_rows = np.zeros((pad, self.n), np.uint8)
            id_rows[:, 0] = 1  # GF row e_0: recomputes survivor 0 exactly
            mat = np.concatenate([mat, id_rows], axis=0) if len(missing) else id_rows
            missing = list(missing) + [present[0]] * pad
        return self._device_plan(mat, present, missing)

    def apply_repair(self, plan, shards, *, portable: bool = False) -> torch.Tensor:
        """Apply a repair_plan to (..., n+m, k) shards; returns a new tensor."""
        mat_bits, present, missing = plan
        shards = as_tensor(shards, self.device)
        if missing.shape[0] == 0:
            return shards
        survivors = shards.index_select(-2, present.to(shards.device))
        fn = gf_matmul_bytes if portable else gf_matmul_dispatch
        rows = fn(mat_bits, survivors)
        out = shards.clone()
        out[..., missing.to(shards.device), :] = rows
        return out

    def reconstruct(self, shards, bad_idx: list[int], data_only: bool = False) -> torch.Tensor:
        """shards (..., n+m, k) with garbage at bad_idx -> repaired (..., n+m, k)."""
        shards = as_tensor(shards, self.device)
        _, _, missing = self.repair_matrix(bad_idx, data_only)
        if not missing:
            return shards
        return self.apply_repair(self.repair_plan(bad_idx, data_only), shards)

    # -- verify ------------------------------------------------------------

    def verify(self, shards, *, portable: bool = False) -> torch.Tensor:
        """(..., n+m, k) -> scalar/batch bool: parity rows match re-encoded parity."""
        shards = as_tensor(shards, self.device)
        expect = self.encode_parity(shards[..., : self.n, :].contiguous(),
                                    portable=portable)
        got = shards[..., self.n :, :]
        return (expect == got).flatten(-2).all(dim=-1)


@functools.lru_cache(maxsize=64)
def _kernel(n: int, m: int, device: str) -> RSKernel:
    return RSKernel(n, m, device)


def get_kernel(n: int, m: int, device=None) -> RSKernel:
    """Process-wide kernel cache per (n, m, device) (generator construction
    is setup-time work)."""
    return _kernel(n, m, str(resolve_device(device)))
