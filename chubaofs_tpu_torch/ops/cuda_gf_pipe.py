"""The pipelined Hopper GF(2^8) matmul kernel (B2): build, plan, launch.

Counterpart of chubaofs_tpu/ops/pallas_gf_pipe.py (both of its kernel bodies).
The source is ops/csrc/gf_matmul_pipe.cu, on the tensor-core core of
ops/csrc/gf_bitmma.cuh; their notes give the bound on the card and the
design: the (8r, 8n) GF(2) bit matrix multiplies the data's bit planes on the
tensor cores (int8 mma.sync, then & 1), fed by a TMA bulk-copy ring under
mbarriers from a producer warp, with bulk async stores of the output.

Like the TPU kernel it takes any (8r, 8n) GF(2) matrix, not only the
expansion of a GF(2^8) matrix. What this module adds is the host side, kept
in plain functions so the CPU tests can walk it without a card:

  * rows_per_pass, operand: the output rows of one pass of MMAs, and the
    bit matrix in the fragment order of the kernel's B operand, 64 bytes per
    coefficient, cached per matrix and device;
  * blocks: B2's own row/column block plan under its shared-memory budget;
  * pick_tile: the tile kt (a multiple of 256) whose ring, output slots and
    operand fit SMEM_TARGET;
  * cta_items: the (stripe, tile) items each persistent CTA walks;
  * align_of: bulk copies in and out when k and every row base are 16-byte
    aligned, else bulk copies of each row's aligned interior with its ragged
    ends copied bytewise, and stores from registers.

Nothing is built at import. A CPU tensor is a ValueError: rs.gf_matmul_dispatch
sends CPU tensors to the plain version (rs.gf_matmul_bytes) and CUDA tensors
here when CFS_GF_PIPELINED is "1" (dynamic slots) or "static" (static slots).
"""

from __future__ import annotations

import collections
import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from chubaofs_tpu_torch.ops import cuda_gf

SOURCE = Path(__file__).resolve().parent / "csrc" / "gf_matmul_pipe.cu"

BITS = 8
STAGES = 3  # must match kPipeStages in gf_matmul_pipe.cu
CONSUMER_WARPS = 8
TILE_QUANTUM = CONSUMER_WARPS * 32  # each consumer warp works 32 columns at a time
ROW_PAD = 16  # a stage row holds kt + 16 bytes: room for the row's offset mod 16
OUT_ROW_PAD = 32  # an output slot row holds kt + 32 bytes
MAX_ROWS_PER_PASS = 4  # output rows of the 4 MMAs of a full pass
BAR_BYTES = 128
FRAG_BYTES = 256  # B fragments of one MMA: 32 lanes x 8 bytes, 64 per coefficient
# Launch blocks: at most MAX_INPUTS inputs (the ring holds them all) and
# MAX_ROWS outputs (two output slots hold them all), and OPERAND_BUDGET bytes
# of B fragments. Past that, row blocks, then column blocks that the kernel
# XOR-accumulates into the output. Within these limits the smallest tile
# (256 columns) fits the H100's 227 KiB at any shape.
MAX_INPUTS = 128
MAX_ROWS = 64
OPERAND_BUDGET = 64 * 1024
# shared memory one CTA aims for: two CTAs (18 warps) per SM
SMEM_TARGET = 96 * 1024
MAX_TILE = 4096  # past this a larger tile only lengthens the prologue

# launches since import (or since a caller zeroed them), per slot variant;
# bumped under _count_lock by the wrapper right where it launches
LAUNCHES = {"dynamic": 0, "static": 0}
_count_lock = threading.Lock()

# what the last build did: {"seconds", "path", "ptxas"}; empty until loaded
BUILD_INFO: dict = {}

_lib = None
_lib_lock = threading.Lock()
_sms: dict[int, int] = {}
_sms_lock = threading.Lock()

_PLAN_CACHE_MAX = 256
_plans: collections.OrderedDict = collections.OrderedDict()
_plans_lock = threading.Lock()


def load():
    """The bound library, building it on first use."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(cuda_gf.build_library(SOURCE, BUILD_INFO)))
            p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.gf_pipe_launch.argtypes = [p, p, p, ll, i, i, ll, ll, ll, i, i, i,
                                           i, i, p]
            lib.gf_pipe_launch.restype = i
            lib.gf_pipe_smem_bytes.argtypes = [i, i, i]
            lib.gf_pipe_smem_bytes.restype = ll
            lib.gf_pipe_error_string.argtypes = [i]
            lib.gf_pipe_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


# -- the B operand ----------------------------------------------------------------


def rows_per_pass(r: int) -> int:
    """R, the output rows of one pass of R MMAs: r itself below 4, so a pass
    computes no idle rows there, else 4. Must match the kernel's."""
    return r if r < 3 else MAX_ROWS_PER_PASS


def operand(mat_bits) -> np.ndarray:
    """(8r, 8n) GF(2) bit matrix -> its B fragments, (P, G, R, 32, 2, 4) uint8
    with R = rows_per_pass(r), P = ceil(r/R) passes and G = ceil(n/4) input
    groups.

    op[P, jg, p, lane, h, q] = M_bits[8(RP + g // (8/R)) + b, 8(4jg + q) + t + 4h] << b
    with g = lane >> 2, t = lane & 3 and b = p * 8/R + g % (8/R): the b0
    (h = 0) and b1 (h = 1) registers of lane `lane` for MMA p of the pass,
    with K = 4 * plane + row_in_group and N = 8/R bits of each of the pass's
    R output rows, each scaled by 2^bit (gf_bitmma.cuh); zero past r and n."""
    bits = np.asarray(mat_bits)
    if bits.ndim != 2 or bits.shape[0] % BITS or bits.shape[1] % BITS:
        raise ValueError(f"want an (8r, 8n) bit matrix, got {bits.shape}")
    r, n = bits.shape[0] // BITS, bits.shape[1] // BITS
    rows = max(1, rows_per_pass(r))
    passes, groups, per = -(-r // rows), -(-n // 4), BITS // rows
    m = np.zeros((rows * passes, BITS, 4 * groups, BITS), np.uint8)  # [out row, out bit, in row, plane]
    m[:r, :, :n] = bits.reshape(r, BITS, n, BITS) & 1
    m <<= np.arange(BITS, dtype=np.uint8)[None, :, None, None]  # scale output bit b by 2^b
    # [P, row_in_pass, p, bit_in_mma, jg, q, h, t]: out bit = p * 8/R + bit_in_mma, plane = 4h + t
    m = m.reshape(passes, rows, rows, per, groups, 4, 2, 4)
    # -> [P, jg, p, g = (8/R) * row_in_pass + bit_in_mma, t, h, q]
    op = m.transpose(0, 4, 2, 1, 3, 7, 6, 5)
    return np.ascontiguousarray(op.reshape(passes, groups, rows, 32, 2, 4))


def blocks(r: int, n: int) -> list[tuple[int, int, int, int]]:
    """(r0, r1, j0, j1) launch blocks: column blocks of MAX_INPUTS inputs,
    each split into row blocks (a multiple of 4 rows, at most MAX_ROWS) whose
    B fragments fit OPERAND_BUDGET. The first column block writes, the others
    accumulate."""
    nb = min(n, MAX_INPUTS)
    groups = -(-nb // 4)
    rb = max(4, min(MAX_ROWS, OPERAND_BUDGET // (groups * FRAG_BYTES)) // 4 * 4)
    return [(r0, min(r, r0 + rb), j0, min(n, j0 + nb))
            for j0 in range(0, n, nb) for r0 in range(0, r, rb)]


def _plan(mat_bits, device: torch.device):
    """[(r0, r1, j0, j1, B fragments on device)] for one matrix, LRU-cached."""
    bits = np.ascontiguousarray(
        mat_bits.detach().cpu().numpy() if isinstance(mat_bits, torch.Tensor)
        else mat_bits, dtype=np.int8)
    key = (bits.shape, bits.tobytes(), str(device))
    with _plans_lock:
        hit = _plans.get(key)
        if hit is not None:
            _plans.move_to_end(key)
            return hit
    r, n = bits.shape[0] // BITS, bits.shape[1] // BITS
    plan = []
    for r0, r1, j0, j1 in blocks(r, n):
        op = operand(bits[BITS * r0:BITS * r1, BITS * j0:BITS * j1])
        plan.append((r0, r1, j0, j1, torch.from_numpy(op).to(device)))
    with _plans_lock:
        _plans[key] = plan
        while len(_plans) > _PLAN_CACHE_MAX:
            _plans.popitem(last=False)
    return plan


# -- the host side of the pipeline ---------------------------------------------------


def smem_bytes(r: int, n: int, kt: int) -> int:
    """Dynamic shared memory of one launch: barriers, B fragments, the input
    ring (4G rows of kt + 16 bytes per stage) and two output slots of r rows
    of kt + 32 bytes."""
    rows = max(1, rows_per_pass(r))
    groups, passes = -(-n // 4), -(-r // rows)
    return (BAR_BYTES + passes * rows * groups * FRAG_BYTES + STAGES * 4 * groups * (kt + ROW_PAD)
            + 2 * r * (kt + OUT_ROW_PAD))


def pick_tile(r: int, n: int, k: int, tile_k: int | None = None) -> int:
    """Tile columns kt for a block of r outputs and n inputs: the largest
    multiple of TILE_QUANTUM whose launch fits SMEM_TARGET, capped at MAX_TILE
    and at k rounded up to the quantum, at least one quantum. tile_k
    overrides it."""
    if tile_k is not None:
        if tile_k <= 0 or tile_k % TILE_QUANTUM:
            raise ValueError(f"tile_k must be a positive multiple of {TILE_QUANTUM}, got {tile_k}")
        return tile_k
    kt = min(MAX_TILE, -(-k // TILE_QUANTUM) * TILE_QUANTUM)
    while kt > TILE_QUANTUM and smem_bytes(r, n, kt) > SMEM_TARGET:
        kt -= TILE_QUANTUM
    return kt


def items(b: int, k: int, kt: int) -> int:
    """(stripe, tile) work items of a launch over b stripes of k columns."""
    return b * -(-k // kt)


def cta_items(b: int, k: int, kt: int, ctas: int, x: int) -> list[tuple[int, int, int]]:
    """(stripe, first column, columns) of each item CTA x of `ctas` walks, in
    order: items x, x + ctas, ... The launcher sizes the grid to the CTAs
    that fit on the SMs at once (an occupancy query), never more than there
    are items, so every CTA gets within one tile of the same work."""
    tiles = -(-k // kt)
    return [(g // tiles, g % tiles * kt, min(kt, k - g % tiles * kt))
            for g in range(x, items(b, k, kt), ctas)]


def align_of(k: int, *ptrs: int) -> int:
    """16 when k and every row base allow bulk copies of whole rows in and
    bulk stores out, else 1 (each row's aligned interior by bulk copy, its
    ragged ends bytewise, stores from registers)."""
    return 16 if k % 16 == 0 and all(p % 16 == 0 for p in ptrs) else 1


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    # the first launches on a device may come from two threads at once
    with _sms_lock:
        if idx not in _sms:
            _sms[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
        return _sms[idx]


# -- the wrapper --------------------------------------------------------------------


def gf_matmul_bytes_pipelined(mat_bits, shards: torch.Tensor, tile_k: int | None = None,
                              static_slots: bool = False, sms: int | None = None) -> torch.Tensor:
    """out = GF(2) bit matrix . shards on the card, through the pipelined kernel.

    mat_bits: any (8r, 8n) byte-major GF(2) matrix (numpy or a tensor; read
    on the host). shards: contiguous uint8 CUDA tensor (..., n, k). Returns a
    new (..., r, k) uint8 tensor on the same device, on the current stream.
    tile_k overrides pick_tile; static_slots picks the static-slot variant;
    sms is the SM count the persistent grid is sized for (default: the
    device's)."""
    if not isinstance(shards, torch.Tensor) or shards.device.type != "cuda":
        raise ValueError("cuda_gf_pipe.gf_matmul_bytes_pipelined takes a CUDA tensor; "
                         "CPU tensors go to rs.gf_matmul_bytes")
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
    variant = "static" if static_slots else "dynamic"
    sms = sms or _sm_count(shards.device)
    with torch.cuda.device(shards.device):
        stream = torch.cuda.current_stream(shards.device).cuda_stream
        base_in, base_out = shards.data_ptr(), out.data_ptr()
        for r0, r1, j0, j1, op in plan:
            kt = pick_tile(r1 - r0, j1 - j0, k, tile_k)
            src, dst = base_in + j0 * k, base_out + r0 * k
            align = align_of(k, src, dst)
            rc = lib.gf_pipe_launch(
                src, dst, op.data_ptr(), b, j1 - j0, r1 - r0, k, n * k, r * k,
                int(j0 > 0), kt, sms, align, int(static_slots), stream)
            if rc != 0:
                raise RuntimeError(
                    f"gf_pipe_launch failed: {lib.gf_pipe_error_string(rc).decode()} "
                    f"(rc={rc}, {variant}, b={b} n={n} r={r} k={k} kt={kt} sms={sms} "
                    f"align={align} smem={lib.gf_pipe_smem_bytes(j1 - j0, r1 - r0, kt)})")
            with _count_lock:
                LAUNCHES[variant] += 1
    return out
