"""A/B harness: B1 (table-lookup kernel) vs B2 (pipelined tensor-core kernel,
dynamic and static slots) on the card.

Runs the benchmark method (slope timing over CUDA events, median of passes,
HBM floor) over the BASELINE configs for every kernel and prints one JSON
line per config plus a final verdict line. Used to decide whether
CFS_GF_PIPELINED should become the default: the answer is measured on the
card, so the tool exists instead of a guess.

    python -m chubaofs_tpu_torch.tools.kernel_ab [--tile-sweep] [--device cuda:N]

The kernels run on the current CUDA device, or the CUDA device --device
names; with no GPU, or a host device named, the command fails before any
work, since there is no host version of a kernel to time. A kernel that fails to build or launch ends the run with a
nonzero exit: there are no error rows. Staging is plain (batch, n, k) uint8
tensors on the card.
"""

from __future__ import annotations

import json
import sys

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SMEM_LIMIT = 227 * 1024  # dynamic shared memory one H100 block may opt into
MiB = 1 << 20

CONFIGS = [
    ("ec4p2_1mib", 4, 2, 1 * MiB, 64),
    ("ec6p3_4mib", 6, 3, 4 * MiB, 24),
    ("ec12p4_8mib", 12, 4, 8 * MiB, 16),
]


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def hbm_floor(total_bytes_moved: int) -> float:
    """Physical seconds floor: moving the op's bytes at the card's HBM peak."""
    return total_bytes_moved / HBM_BYTES_PER_S


def slope(timed, n1=10, n2=40, runs=3, passes=3, floor: float = 0.0) -> float:
    """Seconds per call from `timed(iters)`, the seconds `iters` back-to-back
    calls take: the median across `passes` passes, each the median of `runs`
    slopes (timed(n2) - timed(n1)) / (n2 - n1), so constant costs cancel.

    `floor` is the physical lower bound on seconds per call (HBM peak): a
    pass below it is a corrupted measurement and is discarded; if nothing
    plausible remains this raises with the raw slopes rather than report an
    impossible number."""
    timed(2)  # build + warm
    plausible: list[float] = []
    raw: list[float] = []
    for _ in range(passes):
        # median of the deltas: one stall in either leg must not deflate the
        # subtraction (a min would lock in a corrupted run)
        deltas = sorted(timed(n2) - timed(n1) for _ in range(runs))
        per_iter = deltas[len(deltas) // 2] / (n2 - n1)
        raw.append(per_iter)
        if per_iter >= max(floor, 0.0) and per_iter > 0:
            plausible.append(per_iter)
    if not plausible:
        raise RuntimeError(f"unstable timing: no plausible pass; slopes={raw}")
    plausible.sort()
    return plausible[len(plausible) // 2]


def throughput(fn, args, floor: float = 0.0, **kw) -> float:
    """Seconds per call of fn(*args) on the current CUDA stream: `slope`
    over CUDA event times."""
    import torch

    def timed(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return slope(timed, floor=floor, **kw)


def sweep_tiles(r: int, n: int) -> list[int]:
    """B2 tile sizes the sweep times for r outputs of n inputs: the power-of-
    two multiples of TILE_QUANTUM and the largest multiple whose launch
    fits SMEM_LIMIT by cuda_gf_pipe.smem_bytes."""
    from chubaofs_tpu_torch.ops import cuda_gf_pipe as pipe

    q = pipe.TILE_QUANTUM
    largest = 0
    kt = q
    while pipe.smem_bytes(r, n, kt) <= SMEM_LIMIT:
        largest = kt
        kt += q
    tiles = {largest} if largest else set()
    kt = q
    while kt <= largest:
        tiles.add(kt)
        kt *= 2
    return sorted(tiles)


def best(r: dict) -> str:
    """The fastest variant of one config's row."""
    cands = [("fused", r["fused_gbps"]),
             ("pipelined", r.get("pipelined_gbps", 0)),
             ("pipelined_static", r.get("pipelined_static_gbps", 0))]
    return max(cands, key=lambda c: c[1])[0]


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(prog="cfs-kernel-ab")
    p.add_argument("--tile-sweep", action="store_true",
                   help="also sweep pipelined tile sizes on EC(12,4)")
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--device", default=None,
                   help="the CUDA device the kernels run on (default: the "
                        "current one)")
    args = p.parse_args(argv)

    import torch

    from chubaofs_tpu_torch.ops import cuda_gf, cuda_gf_pipe, rs

    if not torch.cuda.is_available():
        print("cfs-kernel-ab: no CUDA device available; the kernels it times "
              "run only on the card", file=sys.stderr)
        return 2
    dev = rs.resolve_device(args.device)
    if dev.type != "cuda":
        print(f"cfs-kernel-ab: device {args.device!r} is not a CUDA device; "
              "the kernels it times run only on the card", file=sys.stderr)
        return 2
    torch.cuda.set_device(dev)
    log(f"device={torch.cuda.get_device_name(dev)}")
    rng = np.random.default_rng(0)

    kernels = {
        "fused": cuda_gf.gf_matmul,
        "pipelined": lambda m, s: cuda_gf_pipe.gf_matmul_bytes_pipelined(m, s),
        "pipelined_static": lambda m, s: cuda_gf_pipe.gf_matmul_bytes_pipelined(
            m, s, static_slots=True),
    }
    configs = CONFIGS[:-1] + [CONFIGS[-1][:4] + (args.batch,)]
    results: dict[str, dict[str, float]] = {}
    for name, n, m, stripe, batch in configs:
        k = -(-stripe // n // 128) * 128
        mat = rs.get_kernel(n, m, dev).parity_bits
        data = torch.from_numpy(
            rng.integers(0, 256, (batch, n, k), dtype=np.uint8)).to(dev)
        floor = hbm_floor(batch * (n + m) * k)
        res: dict[str, float] = {}
        for label, fn in kernels.items():
            per = throughput(fn, (mat, data), floor=floor)
            res[f"{label}_gbps"] = round(batch * n * k / per / 1e9, 2)
            log(f"{name}: {label} {res[f'{label}_gbps']} GB/s")
        results[name] = res
        print(json.dumps({"config": name, **res}), flush=True)

    if args.tile_sweep:
        # the loop ended on EC(12,4): its matrix, data and floor are staged
        for kt in sweep_tiles(m, n):
            per = throughput(
                lambda x, kt=kt: cuda_gf_pipe.gf_matmul_bytes_pipelined(
                    mat, x, tile_k=kt), (data,), floor=floor)
            print(json.dumps({"config": "ec12p4_tile_sweep", "tile_k": kt,
                              "gbps": round(batch * n * k / per / 1e9, 2)}),
                  flush=True)

    # the verdict names the exact variant: production selects B2 with
    # CFS_GF_PIPELINED=1 (dynamic) or CFS_GF_PIPELINED=static
    winner = {name: best(r) for name, r in results.items()}
    print(json.dumps({"verdict": winner}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
