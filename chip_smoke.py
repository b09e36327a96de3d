#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (chubaofs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
(sm_90a) and nvcc:

    python3 chip_smoke.py

Phases — any failure raises, so the script exits non-zero and prints no
result line:

  1. build  every kernel of the port from the sources in this checkout
            (ops/csrc/gf_matmul.cu, nvcc, into build/kernels/);
  2. kernel vs plain: the kernel's wrapper on the card against its plain
            PyTorch version on the same inputs, byte-equal (tolerance 0:
            GF(2^8) math is exact), for every matrix kind of the main path,
            unaligned k, batch dims and r = 0, each with its time, the plain
            version's time and the bound;
  3. main path: CodecService(device="cuda") serves the blobstore's device
            work from concurrent submitter threads at the blobstore's sizes
            (PUT encodes, degraded reconstruct, bulk repair, LRC archive
            encode, product-matrix encode + rebuild, ranged-read window
            decode); every result is checked;
  4. encoder: new_encoder(EC12P4) split -> encode -> kill 4 -> reconstruct
            -> join on the card.

The launch counter is zeroed right before phase 3 and read right after
phase 4. Output ends with a `kernels` JSON line, the card's name and power
limit as nvidia-smi reports them, and the one-line result JSON.
"""

from __future__ import annotations

import io
import json
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # float32 rate outside the tensor cores, same sheet
MiB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over `iters` back-to-back calls (CUDA events,
    after one warm-up call)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(b: int, n: int, r: int, k: int) -> tuple[float, str]:
    """Least time for out (b, r, k) = M (b, n, k) on this card: each input
    byte read once and each output byte written once over HBM, against one
    multiply and one XOR per (output row, input row, byte) over the CUDA
    cores' rate; the larger of the two."""
    t_bytes = b * (n + r) * k / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * r * n * k / CUDA_CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


# -- phase 2 --------------------------------------------------------------------


def kernel_cases(rs, pm, cuda_gf, lrc_parity_matrix, get_tactic):
    """(name, GF(2^8) matrix, leading dims, k): every matrix kind the main
    path multiplies by, at the shapes it feeds them."""
    k12 = rs.get_kernel(12, 4, "cpu")
    k63 = rs.get_kernel(6, 3, "cpu")
    pmk = pm.get_kernel(12, 6)
    rg = get_tactic("RG6P6")
    pm_k = rg.shard_size(8 * MiB) // rg.sub_units  # sub-unit row length
    pad = cuda_gf.coefficients(k12.repair_plan_padded([3])[0])
    present = [0, 1, 2, 3, 4, 6, 7, 8, 9, 10, 11, 13]
    return [
        # the main path's shape: 16 EC(12,4) 8 MiB stripes padded to the 1 MiB bucket
        ("ec12p4_parity_bucket", k12.gen[12:], (16,), 1 * MiB),
        ("ec12p4_parity", k12.gen[12:], (16,), 699_136),
        ("ec4p2_parity", rs.get_kernel(4, 2, "cpu").gen[4:], (16,), 262_144),
        ("ec6p3_parity", k63.gen[6:], (8,), 699_051),
        ("ec6p3_parity_k1000", k63.gen[6:], (2, 3), 1000),
        ("ec12p4_repair1", k12.repair_matrix([5])[0], (16,), 699_136),
        ("ec12p4_repair3", k12.repair_matrix([0, 5, 12])[0], (16,), 1 * MiB),
        ("ec12p4_repair_padded", pad, (2, 3), 1000),
        ("ec12p4_window", k12.window_matrix(present, [5, 12]), (1,), 200_000),
        ("ec16p20l2_lrc", lrc_parity_matrix(get_tactic("EC16P20L2")), (2,), 1 * MiB),
        ("ec20p4l2_lrc", lrc_parity_matrix(get_tactic("EC20P4L2")), (1,), 1 * MiB),
        ("rg6p6_parity", pmk.parity_mat, (4,), pm_k),
        ("rg6p6_decode", pmk.decode_matrix([1, 2, 4, 6, 8, 11], [0, 3, 5]), (2,), pm_k),
        ("empty_r0", np.zeros((0, 6), np.uint8), (2,), 256),
    ]


def phase_kernels(cuda_gf, rs, bitmatrix, cases) -> tuple[list[dict], int]:
    """Kernel vs plain on the card. Returns per-case records and the max
    absolute byte difference over all cases (0 when they agree)."""
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    records, max_err = [], 0
    for name, mat, lead, k in cases:
        r, n = mat.shape
        bits = bitmatrix.expand_matrix(mat).astype(np.int8)
        x = torch.from_numpy(rng.integers(0, 256, (*lead, n, k), dtype=np.uint8)).to(dev)
        before = cuda_gf.LAUNCHES
        got = cuda_gf.gf_matmul(bits, x)
        torch.cuda.synchronize()
        launches = cuda_gf.LAUNCHES - before
        want = rs.gf_matmul_bytes(bits, x)
        torch.cuda.synchronize()
        check(got.shape == want.shape == (*lead, r, k), f"{name}: shape {tuple(got.shape)}")
        err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0
        max_err = max(max_err, err)
        check(err == 0 and torch.equal(got, want), f"{name}: kernel != plain (max err {err})")
        check(launches == (len(cuda_gf.blocks(r, n)) if r else 0), f"{name}: {launches} launches")
        del want
        b = int(np.prod(lead))
        payload = b * (n + r) * k
        iters = max(3, min(50, int(4e9 // max(payload, 1))))
        k_ms = time_ms(lambda: cuda_gf.gf_matmul(bits, x), iters) if r else 0.0
        p_ms = time_ms(lambda: rs.gf_matmul_bytes(bits, x), 2) if r else 0.0
        torch.cuda.empty_cache()
        bms, by = bound_ms(b, n, r, k)
        rec = {"case": name, "b": b, "n": n, "r": r, "k": k, "equal": True,
               "launches_per_call": launches, "kernel_ms": k_ms, "plain_ms": p_ms,
               "bound_us": bms * 1e3, "bound_by": by,
               "kernel_GBps": payload / (k_ms * 1e-3) / 1e9 if k_ms else None}
        records.append(rec)
        log("kernel_vs_plain " + json.dumps(rec))
    return records, max_err


# -- phase 3: the main path -------------------------------------------------------


def phase_main_path(svc, gf256, pm, get_tactic, lrc_parity_matrix, models):
    rng = np.random.default_rng(7)
    t_phase = {}

    # (a) access PUT: 8 submitter threads x 4 EC(6,3) 4 MiB encode_tactic calls
    t0 = time.perf_counter()
    t63 = get_tactic("EC6P3")
    k63 = t63.shard_size(4 * MiB)
    puts: dict[int, list] = {}
    errors: list[str] = []

    def putter(tid: int):
        r = np.random.default_rng(100 + tid)
        try:
            datas = [r.integers(0, 256, (t63.N, k63), dtype=np.uint8) for _ in range(4)]
            futs = [svc.encode_tactic(t63, d) for d in datas]
            puts[tid] = [(d, f.result(timeout=300)) for d, f in zip(datas, futs)]
        except Exception as e:  # reported below, fails the phase
            errors.append(f"putter {tid}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=putter, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "PUT threads hung")
    check(not errors, f"PUT errors: {errors}")
    gen63 = gf256.systematic_generator(t63.N, t63.M)
    for tid, stripes in puts.items():
        for i, (d, st) in enumerate(stripes):
            check(st.shape == (t63.total, k63) and np.array_equal(st[: t63.N], d),
                  f"PUT {tid}/{i} shape/data rows")
        d, st = stripes[tid % 4]
        check(np.array_equal(st, gf256.encode_numpy(gen63, d)), f"PUT {tid}: parity != oracle")
        broken = st.copy()
        bad = [tid % t63.N, t63.N, t63.total - 1]
        broken[bad] = 0
        fixed = svc.reconstruct(t63.N, t63.M, broken, bad).result(timeout=300)
        check(np.array_equal(fixed, st), f"PUT {tid}: round trip")
    t_phase["put_ec6p3_4mib_x32"] = time.perf_counter() - t0

    # (b) 16 EC(12,4) 8 MiB stripe encodes (shard 699,136 B -> 1 MiB bucket)
    t0 = time.perf_counter()
    t124 = models.FLAGSHIP.tactic
    k124 = models.FLAGSHIP.shard_len
    datas = [rng.integers(0, 256, (t124.N, k124), dtype=np.uint8) for _ in range(16)]
    futs = [svc.encode(t124.N, t124.M, d) for d in datas]
    stripes = [f.result(timeout=300) for f in futs]
    gen124 = gf256.systematic_generator(t124.N, t124.M)
    for i in (0, 15):
        check(np.array_equal(stripes[i], gf256.encode_numpy(gen124, datas[i])),
              f"EC12P4 stripe {i}: parity != oracle")
    for i, (d, st) in enumerate(zip(datas, stripes)):
        check(st.shape == (16, k124) and np.array_equal(st[:12], d), f"EC12P4 {i} data rows")
    t_phase["encode_ec12p4_8mib_x16"] = time.perf_counter() - t0

    # (c) degraded GET: a 1-missing reconstruct
    t0 = time.perf_counter()
    broken = stripes[3].copy()
    broken[5] = 0
    check(np.array_equal(svc.reconstruct(12, 4, broken, [5]).result(timeout=300), stripes[3]),
          "1-missing reconstruct")
    t_phase["reconstruct_1missing"] = time.perf_counter() - t0

    # (d) bulk repair: 64 stripes, 3 missing ([0, 5, 12]), one repair matrix
    t0 = time.perf_counter()
    bad = [0, 5, 12]
    jobs = []
    for i in range(64):
        st = stripes[i % 16]
        b = st.copy()
        b[bad] = 0
        jobs.append((i % 16, svc.reconstruct(12, 4, b, bad)))
    for src, f in jobs:
        check(np.array_equal(f.result(timeout=300), stripes[src]), f"bulk repair of stripe {src}")
    t_phase["bulk_repair_3missing_x64"] = time.perf_counter() - t0
    del jobs

    # (e) archive: EC(20,4)+L2 16 MiB encode_tactic (composed LRC matrix)
    t0 = time.perf_counter()
    ta = models.ARCHIVE.tactic
    ka = models.ARCHIVE.shard_len
    da = rng.integers(0, 256, (ta.N, ka), dtype=np.uint8)
    sa = svc.encode_tactic(ta, da).result(timeout=300)
    check(sa.shape == (ta.total, ka) and np.array_equal(sa[: ta.N], da), "LRC stripe shape")
    check(np.array_equal(sa[ta.N:], gf256.gf_matmul(lrc_parity_matrix(ta), da)),
          "LRC parity != oracle")
    broken = sa.copy()
    bad = [0, 7, 20, 23]
    broken[bad] = 0
    check(np.array_equal(svc.reconstruct_tactic(ta, broken, bad).result(timeout=300), sa),
          "LRC global round trip")
    t_phase["encode_ec20p4l2_16mib"] = time.perf_counter() - t0

    # (f) regenerating: RG6P6 encode_tactic, then a 3-loss reconstruct_tactic
    t0 = time.perf_counter()
    tr = get_tactic("RG6P6")
    kr = tr.shard_size(8 * MiB)
    dr = rng.integers(0, 256, (tr.N, kr), dtype=np.uint8)
    sr = svc.encode_tactic(tr, dr).result(timeout=300)
    check(np.array_equal(sr, pm.get_kernel(tr.total, tr.N).encode(dr)), "RG6P6 stripe != oracle")
    broken = sr.copy()
    bad = [0, 4, 9]
    broken[bad] = 0
    check(np.array_equal(svc.reconstruct_tactic(tr, broken, bad).result(timeout=300), sr),
          "RG6P6 round trip")
    t_phase["rg6p6_encode_and_rebuild_8mib"] = time.perf_counter() - t0

    # (g) ranged GET: a decode_rows window over an EC(6,3) PUT stripe
    t0 = time.perf_counter()
    st = puts[0][0][1]
    present, want, lo, hi = [0, 2, 3, 5, 6, 8], [1, 4], 100_000, 300_000
    win = svc.decode_rows(6, 3, present, st[np.asarray(present), lo:hi], want).result(timeout=300)
    check(np.array_equal(win, st[np.asarray(want), lo:hi]), "decode_rows window")
    t_phase["decode_rows_window"] = time.perf_counter() - t0
    return t_phase


def phase_encoder(new_encoder, CodeMode) -> float:
    """verify surface 3: split -> encode -> kill 4 -> reconstruct -> join."""
    t0 = time.perf_counter()
    enc = new_encoder(CodeMode.EC12P4, device="cuda")
    data = np.random.default_rng(9).integers(0, 256, 8 * MiB - 77, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)
    check(enc.verify(shards), "encoder verify after encode")
    golden = [s.copy() for s in shards]
    kill = [0, 5, 12, 15]
    for i in kill:
        shards[i][:] = 0
    enc.reconstruct(shards, kill)
    check(all(np.array_equal(a, b) for a, b in zip(shards, golden)), "encoder reconstruct")
    out = io.BytesIO()
    enc.join(out, shards, len(data))
    check(out.getvalue() == data, "encoder join")
    return time.perf_counter() - t0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this runs on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "chubaofs_tpu_torch").is_dir():
        print(f"chip_smoke: no chubaofs_tpu_torch package beside {Path(__file__).name}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from chubaofs_tpu_torch import models
    from chubaofs_tpu_torch.codec import CodeMode, new_encoder, pm
    from chubaofs_tpu_torch.codec.codemode import get_tactic
    from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix
    from chubaofs_tpu_torch.codec.service import CodecService
    from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf, gf256, rs

    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    # phase 1: build
    t0 = time.perf_counter()
    cuda_gf.load()
    log(f"build: gf_matmul {time.perf_counter() - t0:.2f} s -> {cuda_gf.BUILD_INFO['path']}")
    log(cuda_gf.BUILD_INFO["ptxas"])

    # phase 2: each kernel against its plain version on the card
    cases = kernel_cases(rs, pm, cuda_gf, lrc_parity_matrix, get_tactic)
    records, max_err = phase_kernels(cuda_gf, rs, bitmatrix, cases)
    main_rec = records[0]  # ec12p4_parity_bucket: what the service launches for FLAGSHIP

    # phases 3 + 4: the main path, launch counts zeroed just before
    svc = CodecService(device="cuda")
    try:
        cuda_gf.LAUNCHES = 0
        stats0 = svc.stats_snapshot()
        t0 = time.perf_counter()
        phases = phase_main_path(svc, gf256, pm, get_tactic, lrc_parity_matrix, models)
        phases["encoder_ec12p4_roundtrip"] = phase_encoder(new_encoder, CodeMode)
        torch.cuda.synchronize()
        launches = cuda_gf.LAUNCHES
        stats = svc.stats_snapshot()
    finally:
        svc.close()
    batches = stats["batches"] - stats0["batches"]
    log("main_path " + json.dumps({"seconds": time.perf_counter() - t0, "phases_s": phases,
                                   "service_stats": stats, "device_batches": batches,
                                   "gf_matmul_launches": launches}))
    check(launches > 0, "the main path launched no gf_matmul kernel")
    check(launches >= batches, f"{launches} launches < {batches} device batches")

    kernels = [{
        "name": "gf_matmul",
        "route": "cuda",
        "source": "chubaofs_tpu_torch/ops/csrc/gf_matmul.cu",
        "replaces": "chubaofs_tpu/ops/pallas_gf.py:85",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": main_rec["kernel_ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_us"] / 1e3,
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    }]
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
