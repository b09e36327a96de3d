"""The double-buffered Hopper GF(2^8) matmul kernel (B2): build, plan, launch.

Counterpart of chubaofs_tpu/ops/pallas_gf_pipe.py (both of its kernel bodies).
The source is ops/csrc/gf_matmul_pipe.cu; its note gives the bound on the
card and the design: a CTA owns one (stripe, column span) and streams it
through a two-stage cp.async ring in shared memory, computing tile t while
tile t+1 is in flight.

It computes exactly what ops/cuda_gf.py (B1) computes, with the same
contract, and takes from there the coefficient recovery, the split-nibble
tables and the row/column block plan. What this module adds is the host
side of the pipeline, kept in plain functions so the CPU tests can walk
it without a card:

  * pick_tile: the tile kt (a multiple of 16) whose stage ring fits
    STAGE_SMEM_TARGET;
  * span_tiles: how many tiles a CTA walks, so that the grid covers the SMs
    at least twice where the work allows;
  * align_of: 16-byte cp.async, 4-byte cp.async or byte loads, from k and
    the row base pointers.

Nothing is built at import. A CPU tensor is a ValueError: rs.gf_matmul_dispatch
sends CPU tensors to the plain version (rs.gf_matmul_bytes) and CUDA tensors
here when CFS_GF_PIPELINED is "1" (dynamic slots) or "static" (static slots).
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import torch

from chubaofs_tpu_torch.ops import cuda_gf

SOURCE = Path(__file__).resolve().parent / "csrc" / "gf_matmul_pipe.cu"

STAGES = 2  # must match kPipeStages in gf_matmul_pipe.cu
# Stage ring bytes per CTA (STAGES * n * kt). With at most 48 KiB of tables a
# CTA needs <= 144 KiB of the H100's 227 KiB opt-in shared memory; with the
# small tables of the RS/LRC encode matrices (<= 2.5 KiB) two CTAs fit one SM.
STAGE_SMEM_TARGET = 96 * 1024
MAX_TILE = 16 * 1024  # past this a larger tile only lengthens the prologue

# launches since import (or since a caller zeroed them), per slot variant;
# bumped under _count_lock by the wrapper right where it launches
LAUNCHES = {"dynamic": 0, "static": 0}
_count_lock = threading.Lock()

# what the last build did: {"seconds", "path", "ptxas"}; empty until loaded
BUILD_INFO: dict = {}

_lib = None
_lib_lock = threading.Lock()
_sms: dict[int, int] = {}


def load():
    """The bound library, building it on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_gf.build_library(SOURCE, BUILD_INFO)))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_pipe_launch.argtypes = [p, p, p, ll, i, i, ll, ll, ll, i, i, ll,
                                           i, i, p]
            lib.gf_pipe_launch.restype = i
            lib.gf_pipe_error_string.argtypes = [i]
            lib.gf_pipe_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- the host side of the pipeline ---------------------------------------------------


def pick_tile(n: int, k: int, tile_k: int | None = None) -> int:
    """Tile bytes kt for n input rows: the largest multiple of 16 whose
    STAGES-deep ring of n rows fits STAGE_SMEM_TARGET, capped at MAX_TILE and
    at k rounded up to 16 (a short row is one tile). tile_k overrides it."""
    if tile_k is not None:
        if tile_k <= 0 or tile_k % 16:
            raise ValueError(f"tile_k must be a positive multiple of 16, got {tile_k}")
        return tile_k
    kt = STAGE_SMEM_TARGET // (STAGES * n) // 16 * 16
    return max(16, min(kt, MAX_TILE, -(-k // 16) * 16))


def span_tiles(b: int, k: int, kt: int, sms: int) -> int:
    """Tiles per CTA: as many as keep b * ceil(tiles / span) CTAs >= 2 * sms,
    at least one. Fewer CTAs than that would leave SMs idle; more would only
    shorten each CTA's pipeline."""
    tiles = -(-k // kt)
    return max(1, min(tiles, b * tiles // (2 * sms)))


def align_of(k: int, *ptrs: int) -> int:
    """16 when k and every row base allow 16-byte cp.async, else 4 when they
    allow 4-byte copies, else 1 (byte loads)."""
    for a in (16, 4):
        if k % a == 0 and all(p % a == 0 for p in ptrs):
            return a
    return 1


def smem_bytes(r: int, n: int, kt: int) -> int:
    """Dynamic shared memory of one launch: tables, then the stage ring."""
    return r * n * cuda_gf.TAB_BYTES + STAGES * n * kt


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sms:
        _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sms[idx]


# -- the wrapper --------------------------------------------------------------------


def gf_matmul_bytes_pipelined(mat_bits, shards: torch.Tensor, tile_k: int | None = None,
                              static_slots: bool = False, sms: int | None = None) -> torch.Tensor:
    """out = GF(2^8) matrix (x) shards on the card, through the pipelined kernel.

    mat_bits: (8r, 8n) byte-major bit matrix (numpy or a tensor; read on the
    host). shards: contiguous uint8 CUDA tensor (..., n, k). Returns a new
    (..., r, k) uint8 tensor on the same device, on the current stream.
    tile_k overrides pick_tile; static_slots picks the static-slot variant;
    sms is the SM count the grid is sized for (default: the device's)."""
    if not isinstance(shards, torch.Tensor) or shards.device.type != "cuda":
        raise ValueError("cuda_gf_pipe.gf_matmul_bytes_pipelined takes a CUDA tensor; "
                         "CPU tensors go to rs.gf_matmul_bytes")
    if shards.dtype != torch.uint8 or not shards.is_contiguous() or shards.dim() < 2:
        raise ValueError(f"want contiguous uint8 (..., n, k) shards, got "
                         f"{shards.dtype} {tuple(shards.shape)} "
                         f"contiguous={shards.is_contiguous()}")
    r8, n8 = tuple(mat_bits.shape)
    r, n = r8 // cuda_gf.BITS, n8 // cuda_gf.BITS
    lead, k = tuple(shards.shape[:-2]), shards.shape[-1]
    if shards.shape[-2] != n:
        raise ValueError(f"matrix {(r8, n8)} does not match shards {tuple(shards.shape)}")
    b = 1
    for d in lead:
        b *= d
    out = torch.empty((*lead, r, k), dtype=torch.uint8, device=shards.device)
    if r == 0 or b == 0 or k == 0:
        return out
    plan = cuda_gf._plan(mat_bits, shards.device)
    lib = load()
    variant = "static" if static_slots else "dynamic"
    sms = sms or _sm_count(shards.device)
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream(shards.device).cuda_stream
        base_in, base_out = shards.data_ptr(), out.data_ptr()
        for r0, r1, j0, j1, tab in plan:
            kt = pick_tile(j1 - j0, k, tile_k)
            span = span_tiles(b, k, kt, sms) * kt
            src, dst = base_in + j0 * k, base_out + r0 * k
            align = align_of(k, src, dst)
            rc = lib.gf_pipe_launch(
                src, dst, tab.data_ptr(), b, j1 - j0, r1 - r0, k, n * k, r * k,
                int(j0 > 0), kt, span, align, int(static_slots), stream)
            if rc != 0:
                raise RuntimeError(
                    f"gf_pipe_launch failed: {lib.gf_pipe_error_string(rc).decode()} "
                    f"(rc={rc}, {variant}, b={b} n={n} r={r} k={k} kt={kt} "
                    f"span={span} align={align} smem={smem_bytes(r1 - r0, j1 - j0, kt)})")
            with _count_lock:
                LAUNCHES[variant] += 1
    return out
