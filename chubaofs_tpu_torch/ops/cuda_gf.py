"""The hand-written Hopper GF(2^8) matmul kernel: build, bind and launch.

Counterpart of chubaofs_tpu/ops/pallas_gf.py. The kernel source is
ops/csrc/gf_matmul.cu (CUDA C++ for sm_90a); its note gives the bound on the
card and the design. This module:

  * builds the source with nvcc into build/kernels/ at first use (a plain C
    interface loaded with ctypes) and raises if the build fails;
  * builds, from the byte-major (8r, 8n) bit matrix the public API takes,
    the split tables the kernel stages in shared memory (split_tables: the
    byte map of each 8x8 block at the values of a byte's bit fields [0, 3),
    [3, 6) and [6, 8)), cached per matrix on each device. Any GF(2) matrix
    works, as on the TPU: the tables need only that each block is linear;
  * picks the kernel's output rows per pass (row_tile) and whether its
    rows are 16-byte aligned;
  * splits a matrix whose tables exceed the kernel's shared-memory budget into
    row blocks (GF products are row-separable) and, past that, column blocks
    whose products the kernel XOR-accumulates into the output;
  * counts launches in LAUNCHES, so a run can show that it went through the
    kernel.

Nothing here imports or builds anything at import time: the CPU tests import
this module on a machine without nvcc. The plain PyTorch version of the same
function is ops/rs.py::gf_matmul_bytes; rs.gf_matmul_dispatch sends CPU
tensors there and CUDA tensors here, and this wrapper raises on anything that
is not a contiguous uint8 CUDA tensor.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from chubaofs_tpu_torch.ops import bitmatrix

BITS = 8
TAB_BYTES = 32  # per block: T0 (8 B), T1 (8 B), T2 (4 B), 12 B of zeros
# tables per launch, in shared memory: must match kMaxSmem in gf_matmul.cu
SMEM_BUDGET = 48 * 1024
MAX_COEFFS = SMEM_BUDGET // TAB_BYTES

SOURCE = Path(__file__).resolve().parent / "csrc" / "gf_matmul.cu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# kernel launches since import (or since a caller zeroed it); a plain int,
# bumped under _count_lock by the wrapper right where it launches
LAUNCHES = 0
_count_lock = threading.Lock()

# what the last build did: {"seconds", "path", "ptxas"} (ptxas = nvcc's
# register/shared-memory report); empty until the library is loaded
BUILD_INFO: dict = {}

_lib = None
_lib_lock = threading.Lock()

_PLAN_CACHE_MAX = 256
_plans: collections.OrderedDict = collections.OrderedDict()
_plans_lock = threading.Lock()


# -- build + bind ----------------------------------------------------------------


def _nvcc() -> str:
    cands = [shutil.which("nvcc"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the port's CUDA "
        "kernels are built from ops/csrc/*.cu at first use")


def build_library(source: Path, info: dict) -> Path:
    """Compile one kernel source into BUILD_DIR (keyed by the source, the
    headers beside it and the flags), once, and record what the build did in
    `info`."""
    headers = b"".join(h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
    tag = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"{source.stem}_{tag}.so"
    if lib_path.exists():
        info.update(seconds=0.0, path=str(lib_path), ptxas="(cached)")
        return lib_path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{source.stem}_{tag}.{os.getpid()}.so"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(source)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (rc={proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib_path)  # atomic: a concurrent build never loads half a file
    info.update(seconds=time.perf_counter() - t0, path=str(lib_path),
                ptxas=(proc.stdout + proc.stderr).strip())
    return lib_path


def build() -> Path:
    """Compile this module's kernel (gf_matmul.cu), once."""
    return build_library(SOURCE, BUILD_INFO)


def load():
    """The bound library, building it on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_matmul_launch.argtypes = [p, p, p, ll, i, i, ll, ll, ll, i, i, i, p]
            lib.gf_matmul_launch.restype = i
            lib.gf_error_string.argtypes = [i]
            lib.gf_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- host-side matrix preparation -------------------------------------------------


def coefficients(mat_bits) -> np.ndarray:
    """(8r, 8n) byte-major GF(2) bit matrix -> its (r, n) GF(2^8) matrix.

    Column 0 of block (i, j) is bits(c_ij * 1); the rest of the block must be
    what bitmatrix.expand_matrix makes of c_ij, or this raises. A utility for
    building test matrices: the kernel takes any bit matrix (split_tables)."""
    bits = np.asarray(mat_bits)
    if bits.ndim != 2 or bits.shape[0] % BITS or bits.shape[1] % BITS:
        raise ValueError(f"want an (8r, 8n) bit matrix, got {bits.shape}")
    r, n = bits.shape[0] // BITS, bits.shape[1] // BITS
    col0 = bits.reshape(r, BITS, n, BITS)[:, :, :, 0].astype(np.int64)  # (r, 8, n)
    weights = (1 << np.arange(BITS, dtype=np.int64))[None, :, None]
    coef = (col0 * weights).sum(axis=1).astype(np.uint8)
    if not np.array_equal(bitmatrix.expand_matrix(coef), bits.astype(np.uint8)):
        raise ValueError("bit matrix is not the expansion of a GF(2^8) matrix")
    return coef


# the values at which each block's byte map is tabulated: T0[v] = L(v) and
# T1[v] = L(v << 3) for v < 8, T2[v] = L(v << 6) for v < 4
TABLE_VALUES = np.concatenate([np.arange(8), np.arange(8) << 3, np.arange(4) << 6])


def split_tables(mat_bits) -> np.ndarray:
    """(8r, 8n) byte-major GF(2) bit matrix -> (r, n, 32) uint8 split tables.

    Block (i, j) maps a byte x to L(x), output bit p = XOR_q M[8i+p, 8j+q]
    * bit q of x. Its row holds L at TABLE_VALUES (T0, T1, T2: 20 bytes),
    then 12 zero bytes; L(x) = T0[x & 7] ^ T1[(x >> 3) & 7] ^ T2[x >> 6]."""
    bits = np.asarray(mat_bits)
    if bits.ndim != 2 or bits.shape[0] % BITS or bits.shape[1] % BITS:
        raise ValueError(f"want an (8r, 8n) bit matrix, got {bits.shape}")
    r, n = bits.shape[0] // BITS, bits.shape[1] // BITS
    blk = (bits.reshape(r, BITS, n, BITS) & 1).astype(np.int64)  # [i, p, j, q]
    vbits = (TABLE_VALUES[:, None] >> np.arange(BITS)) & 1  # [v, q]
    prod = np.einsum("ipjq,vq->ijvp", blk, vbits) & 1
    tab = np.zeros((r, n, TAB_BYTES), np.uint8)
    tab[:, :, :len(TABLE_VALUES)] = (prod << np.arange(BITS)).sum(axis=-1)
    return tab


def aligned(k: int, base_in: int, base_out: int) -> bool:
    """Whether the launches take the aligned kernel: every row of the input
    and the output starts on 16 bytes."""
    return k % 16 == 0 and base_in % 16 == 0 and base_out % 16 == 0


def row_tile(rows: int) -> int:
    """Output rows the kernel keeps in registers per pass: 4 for the RS
    encodes and repairs (r <= 4), else 8 (fewer re-walks of the inputs)."""
    return 4 if rows <= 4 else 8


def blocks(r: int, n: int) -> list[tuple[int, int, int, int]]:
    """(r0, r1, j0, j1) launch blocks whose tables fit SMEM_BUDGET: row blocks
    of the full width when it fits, else column blocks of MAX_COEFFS inputs
    one row at a time (accumulated into the output)."""
    nb = min(n, MAX_COEFFS)
    rb = max(1, MAX_COEFFS // nb)
    return [(r0, min(r, r0 + rb), j0, min(n, j0 + nb))
            for j0 in range(0, n, nb) for r0 in range(0, r, rb)]


def _plan(mat_bits, device: torch.device):
    """[(r0, r1, j0, j1, tables on device)] for one matrix, LRU-cached."""
    bits = np.ascontiguousarray(
        mat_bits.detach().cpu().numpy() if isinstance(mat_bits, torch.Tensor)
        else mat_bits, dtype=np.int8)
    key = (bits.shape, bits.tobytes(), str(device))
    with _plans_lock:
        hit = _plans.get(key)
        if hit is not None:
            _plans.move_to_end(key)
            return hit
    tables = split_tables(bits)
    plan = []
    for r0, r1, j0, j1 in blocks(*tables.shape[:2]):
        tab = torch.from_numpy(np.ascontiguousarray(tables[r0:r1, j0:j1])).to(device)
        plan.append((r0, r1, j0, j1, tab))
    with _plans_lock:
        _plans[key] = plan
        while len(_plans) > _PLAN_CACHE_MAX:
            _plans.popitem(last=False)
    return plan


# -- the wrapper -------------------------------------------------------------------


def gf_matmul(mat_bits, shards: torch.Tensor) -> torch.Tensor:
    """out = M (x) shards on the card, through the kernel.

    mat_bits: (8r, 8n) byte-major GF(2) bit matrix, any such matrix (numpy or
    a tensor; read on the host). shards: contiguous uint8 CUDA tensor
    (..., n, k). Returns a new (..., r, k) uint8 tensor on the same device,
    on the current stream."""
    global LAUNCHES
    if not isinstance(shards, torch.Tensor) or shards.device.type != "cuda":
        raise ValueError("cuda_gf.gf_matmul takes a CUDA tensor; CPU tensors "
                         "go to rs.gf_matmul_bytes")
    if shards.dtype != torch.uint8 or not shards.is_contiguous() or shards.dim() < 2:
        raise ValueError(f"want contiguous uint8 (..., n, k) shards, got "
                         f"{shards.dtype} {tuple(shards.shape)} "
                         f"contiguous={shards.is_contiguous()}")
    r8, n8 = tuple(mat_bits.shape)
    r, n = r8 // BITS, n8 // BITS
    lead, k = tuple(shards.shape[:-2]), shards.shape[-1]
    if shards.shape[-2] != n:
        raise ValueError(f"matrix {(r8, n8)} does not match shards {tuple(shards.shape)}")
    b = 1
    for d in lead:
        b *= d
    out = torch.empty((*lead, r, k), dtype=torch.uint8, device=shards.device)
    if r == 0 or b == 0 or k == 0:
        return out
    plan = _plan(mat_bits, shards.device)
    lib = load()
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream(shards.device).cuda_stream
        base_in, base_out = shards.data_ptr(), out.data_ptr()
        align = int(aligned(k, base_in, base_out))
        for r0, r1, j0, j1, tab in plan:
            rc = lib.gf_matmul_launch(
                base_in + j0 * k, base_out + r0 * k, tab.data_ptr(),
                b, j1 - j0, r1 - r0, k, n * k, r * k,
                int(j0 > 0), align, row_tile(r1 - r0), stream)
            if rc != 0:
                raise RuntimeError(
                    f"gf_matmul_launch failed: {lib.gf_error_string(rc).decode()} "
                    f"(rc={rc}, b={b} n={n} r={r} k={k})")
            with _count_lock:
                LAUNCHES += 1
    return out
