#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (chubaofs_tpu_torch) on one GPU.

Run from the root of a checkout, on a machine with an NVIDIA Hopper GPU
(sm_90a) and nvcc:

    python3 chip_smoke.py

Phases — any failure raises, so the script exits non-zero and prints no
result line:

  1. build  every kernel of the port from the sources in this checkout, one
            nvcc per source, all started together (ops/csrc/gf_matmul.cu, B1;
            ops/csrc/gf_matmul_pipe.cu, B2; into build/kernels/), and print
            each ptxas report and, per instantiation, its registers, spills,
            stack and shared memory;
  2. kernel vs plain: each kernel's wrapper on the card (B1, B2 with dynamic
            slots, B2 with static slots) against the plain PyTorch version on
            the same inputs, byte-equal (tolerance 0: GF(2^8) math is exact),
            for every matrix kind of the main path, unaligned k, batch dims
            and r = 0, each with its time, the plain version's time, the
            bound and B2's time over B1's. Every kernel runs every case, a
            GF(2) matrix that is not the expansion of a GF(2^8) one included
            (both take any GF(2) matrix, as the TPU kernel does). Where the
            toolkit has cuobjdump, B1's SASS is counted per opcode in the
            inner loop of each instantiation;
  3. codec path: CodecService(device="cuda") serves the blobstore's device
            work from concurrent submitter threads at the blobstore's sizes
            (PUT encodes, degraded reconstruct, bulk repair, LRC archive
            encode, product-matrix encode + rebuild, ranged-read window
            decode); every result is checked;
  4. encoder: new_encoder(EC12P4) split -> encode -> kill 4 -> reconstruct
            -> join on the card;
  5. gateway path: MiniCluster(device="cuda"), 9 nodes x 2 disks. 4 client
            threads PUT a 64 MiB object each (16 EC(12,4) blobs through the
            pipelined PUT), then 8 x 1 MiB (EC(6,3)) and 8 x 100 KiB
            (EC(3,3)); GET everything back and 32 seeded ranges; check stored
            stripes against the numpy oracle; break 2 disks and GET again
            (degraded window and full-stripe decodes); run the background
            loops until the repair worker has rebuilt every lost shard, and
            check them; then an EC6P3L3 cluster over 3 AZs loses a shard per
            blob and serves GETs through the local repair. B1 only;
  6. phase 5's single-AZ part again under CFS_GF_PIPELINED=1 and then
            CFS_GF_PIPELINED=static: B2 only, B1 launches must be 0;
  7. daemon path, B1 only (B2 launches must be 0): (a) the blobstore daemon
            started as a user starts it, cmd.start_role with "device": "cuda",
            serves phase 5's mix over HTTP: 4 client threads PUT a 64 MiB
            object each through their own AccessClient, then the small
            objects; POST /get of everything, 32 `Range:` GETs (206 +
            Content-Range), a suffix range and an unsatisfiable one (416);
            stored stripes against the numpy oracle; 2 disks broken through
            the daemon's cluster handle and everything GET again (decoded
            bytes must grow); the daemon's own background tick must rebuild
            every lost shard, byte-equal, within REPAIR_DEADLINE_S; the admin
            CLI (stat, task ls); POST /admin/reload, then GETs and a PUT on
            the same address (no kernel rebuilt, the old codec-svc thread
            gone); /metrics must count codec batches. (b) `python -m
            chubaofs_tpu_torch.cmd -c cfg.json` as a second process: boot
            line, PUT / GET / Range GET of 4 MiB, /metrics, /health, and
            SIGTERM must end it with exit code 0 within 30 s; it must load
            the kernels built in build/kernels/ and build none;
  8. grid path, B1 only (parallel/mesh.py): on codec_mesh() (every CUDA
            device) and on a 2 x 2 grid of cuda:0, sharded_codec_step at
            EC(12,4) with 1 MiB shards, b = 16 and b = 2 dp + 1, two repair
            patterns with one setup, against the single-device encode on the
            card and the numpy oracle, and a corrupted byte caught by
            RSKernel.verify; sharded_gf_matmul against gf_matmul_hostbatch in
            turns (seconds and B1 launches per call); the grouped step (g = 2);
            the ARCHIVE EC(20,4)+L2 encode over the 2 x 2 grid; a MiniCluster
            on CodecService(mesh=2 x 2 grid): PUT 64 MiB + 300 KB, a shard
            lost per blob, degraded and ranged GETs, the background loops
            heal; entry.entry() and entry.dryrun_multichip(4).

Every path (3+4, 5, each pass of 6, 7a, 8) is driven with every launch count
set to 0 just before it and read just after. Output ends with a `daemon` JSON
line (phase 7's steps), a `mesh` JSON line (phase 8's steps, B1 launches, the
card's name and power limit), a `kernels` JSON line, the card's name and power limit as
nvidia-smi reports them, and the one-line result JSON.
"""

from __future__ import annotations

import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
CUDA_CORE_OPS_PER_S = 67e12  # float32 rate outside the tensor cores, same sheet
MiB = 1 << 20
REPAIR_DEADLINE_S = 180  # phase 7: the daemon's own tick rebuilds every lost shard


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


def ptxas_summary(report: str) -> list[str]:
    """One line per compiled kernel of an nvcc -Xptxas=-v report: its
    template arguments, registers, spills, stack and shared memory."""
    kernels: dict[str, list[str]] = {}
    name = None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1]
            m = re.search(r"(?<=\d)(gf_[a-z_]*kernel)I((?:L[ib]\d+E)+)E", mangled)
            args = re.findall(r"L[ib](\d+)E", m.group(2)) if m else []
            name = f"{m.group(1)}<{','.join(args)}>" if m else mangled
            kernels[name] = []
        elif name and ("spill" in ln or "Used" in ln):
            kernels[name].append(ln.split(":", 1)[-1].strip() if "Used" in ln else ln.strip())
    return [f"{k}: {'; '.join(v)}" for k, v in kernels.items()]


def sass_loops(lib_path: str) -> list[str]:
    """Per B1 instantiation, the opcodes of its innermost loop that looks
    bytes up (the smallest span from a backward branch's target to the
    branch that holds a PRMT), counted in the library's SASS (cuobjdump
    -sass)."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.isfile(tool):
        return ["cuobjdump not found: no SASS counts"]
    proc = subprocess.run([tool, "-sass", lib_path], capture_output=True, text=True, timeout=120)
    out = []
    for fn in proc.stdout.split("Function : ")[1:]:
        m = re.search(r"(gf_[a-z_]*kernel)I((?:L[ib]\d+E)+)E", fn.split("\n", 1)[0])
        if not m:
            continue
        name = f"{m.group(1)}<{','.join(re.findall(r'L[ib](\d+)E', m.group(2)))}>"
        ops, at, loops = [], {}, []
        for ln in fn.splitlines():
            ins = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)(.*)", ln)
            if not ins:
                continue
            at[int(ins.group(1), 16)] = len(ops)
            ops.append(ins.group(2).split(".")[0])
            tgt = re.search(r"0x([0-9a-f]+)\s*;", ins.group(3))
            if ops[-1] == "BRA" and tgt and int(tgt.group(1), 16) in at:  # a branch back
                loops.append((at[int(tgt.group(1), 16)], len(ops)))
        inner = [(b, e) for b, e in loops if "PRMT" in ops[b:e]]
        if not inner:
            out.append(f"{name}: no loop with PRMT found")
            continue
        b, e = min(inner, key=lambda be: be[1] - be[0])
        hist: dict[str, int] = {}
        for op in ops[b:e]:
            hist[op] = hist.get(op, 0) + 1
        out.append(f"{name}: {e - b} instructions per iteration "
                   + json.dumps(dict(sorted(hist.items(), key=lambda kv: -kv[1]))))
    return out


def kernel_cases(rs, pm, cuda_gf, lrc_parity_matrix, get_tactic):
    """(name, matrix, leading dims, k): every matrix kind the main path
    multiplies by, at the shapes it feeds them. The matrix is a GF(2^8) one,
    except for the last case, a GF(2) bit matrix that is no expansion (every
    kernel takes it)."""
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
        # aligned twins of an unaligned case and of the main path's shape at odd k
        ("rg6p6_parity_k16", pmk.parity_mat, (4,), pm_k // 16 * 16),
        ("ec12p4_parity_bucket_odd", k12.gen[12:], (16,), 1 * MiB - 3),
        ("rg6p6_decode", pmk.decode_matrix([1, 2, 4, 6, 8, 11], [0, 3, 5]), (2,), pm_k),
        ("empty_r0", np.zeros((0, 6), np.uint8), (2,), 256),
        ("gf2_nonexpansion", np.random.default_rng(2).integers(0, 2, (8 * 4, 8 * 12), dtype=np.int8),
         (16,), 1 * MiB),
    ]


def phase_kernels(kernels: dict, rs, bitmatrix, cases, smem_of) -> tuple[list[dict], dict]:
    """Each kernel against the plain version on the card. kernels maps a name
    to (wrapper, launch counter, block plan); a call
    launches once per block of the kernel's own plan. smem_of(r, n, k) gives
    B2's (tile, dynamic shared memory) per launch. Returns per-case records
    and, per kernel, the max absolute byte difference over all cases (0 when
    they agree)."""
    rng = np.random.default_rng(1)
    dev = torch.device("cuda")
    records, max_err = [], {name: 0 for name in kernels}
    for name, mat, lead, k in cases:
        expansion = not name.startswith("gf2_")  # a gf2_ case's matrix is its bit matrix
        bits = bitmatrix.expand_matrix(mat).astype(np.int8) if expansion else mat
        r, n = bits.shape[0] // 8, bits.shape[1] // 8
        x = torch.from_numpy(rng.integers(0, 256, (*lead, n, k), dtype=np.uint8)).to(dev)
        want = rs.gf_matmul_bytes(bits, x)
        torch.cuda.synchronize()
        b = int(np.prod(lead))
        payload = b * (n + r) * k
        bms, by = bound_ms(b, n, r, k)
        rec = {"case": name, "b": b, "n": n, "r": r, "k": k, "bound_us": bms * 1e3,
               "bound_by": by, "b2_tile_smem": smem_of(r, n, k) if r else [], "kernels": {}}
        for kname, (fn, count, blocks) in kernels.items():
            before = count()
            got = fn(bits, x)
            torch.cuda.synchronize()
            launches = count() - before
            check(got.shape == want.shape == (*lead, r, k), f"{name}/{kname}: shape {tuple(got.shape)}")
            err = int((got.to(torch.int16) - want.to(torch.int16)).abs().max()) if got.numel() else 0
            max_err[kname] = max(max_err[kname], err)
            check(err == 0 and torch.equal(got, want), f"{name}/{kname}: kernel != plain (max err {err})")
            check(launches == (len(blocks(r, n)) if r else 0), f"{name}/{kname}: {launches} launches")
            del got
            iters = max(3, min(50, int(4e9 // max(payload, 1))))
            k_ms = time_ms(lambda: fn(bits, x), iters) if r else 0.0
            rec["kernels"][kname] = {"equal": True, "launches_per_call": launches, "ms": k_ms,
                                     "GBps": payload / (k_ms * 1e-3) / 1e9 if k_ms else None}
        del want
        b1_ms = rec["kernels"].get("gf_matmul", {}).get("ms")
        rec["over_b1"] = {kn: kr["ms"] / b1_ms for kn, kr in rec["kernels"].items()
                          if b1_ms and kn != "gf_matmul"}
        rec["plain_ms"] = time_ms(lambda: rs.gf_matmul_bytes(bits, x), 2) if r else 0.0
        torch.cuda.empty_cache()
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


# -- phases 5 and 6: the gateway path ---------------------------------------------


def put_concurrently(access_of, payloads: dict[str, bytes], clients: int) -> dict:
    """PUT every payload, `clients` threads at a time, thread i through
    access_of(i); returns name -> Location."""
    locs, errors = {}, []
    names = list(payloads)

    def client(i: int):
        try:
            access = access_of(i)
            for name in names[i::clients]:
                locs[name] = access.put(payloads[name])
        except Exception as e:  # reported below, fails the phase
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), "PUT clients hung")
    check(not errors, f"PUT errors: {errors}")
    return locs


def blob_payloads(loc, data: bytes):
    off = 0
    for b in loc.blobs:
        yield b, data[off:off + b.size]
        off += b.size


def stored_stripe(cluster, blob) -> np.ndarray:
    vol = cluster.cm.get_volume(blob.vid)
    return np.stack([np.frombuffer(cluster.nodes[u.node_id].get_shard(u.vuid, blob.bid), np.uint8)
                     for u in vol.units])


def oracle_stripe(gf256, t, payload: bytes) -> np.ndarray:
    """The numpy encode of one RS blob in the gateway's shard layout."""
    shard_len = t.shard_size(len(payload))
    rows = np.zeros((t.N, shard_len), np.uint8)
    rows.reshape(-1)[: len(payload)] = np.frombuffer(payload, np.uint8)
    return gf256.encode_numpy(gf256.systematic_generator(t.N, t.M), rows)


def get_all(access, payloads, locs, ranges) -> None:
    for name, data in payloads.items():
        check(access.get(locs[name]) == data, f"GET {name}")
    for name, off, ln in ranges:
        check(access.get(locs[name], off, ln) == payloads[name][off:off + ln],
              f"ranged GET {name} [{off}, +{ln})")


def gateway_mix(big_mib: int, clients: int):
    """The gateway path's objects, seeded: `clients` objects of big_mib MiB
    (EC(12,4)), 8 of 1 MiB (EC(6,3)) and 8 of 100 KiB (EC(3,3)), and 32
    ranges over them. Returns (rng, payloads, modes, names, ranges)."""
    from chubaofs_tpu_torch.codec.codemode import CodeMode

    rng = np.random.default_rng(11)
    payloads = {f"big{i}": rng.bytes(big_mib * MiB) for i in range(clients)}
    modes = {name: CodeMode.EC12P4 for name in payloads}
    for i in range(8):
        payloads[f"mid{i}"], modes[f"mid{i}"] = rng.bytes(MiB), CodeMode.EC6P3
        payloads[f"small{i}"], modes[f"small{i}"] = rng.bytes(100 * 1024), CodeMode.EC3P3
    names = sorted(payloads)
    ranges = []
    for _ in range(32):
        name = names[int(rng.integers(len(names)))]
        off = int(rng.integers(len(payloads[name])))
        ranges.append((name, off, int(rng.integers(1, min(MiB, len(payloads[name]) - off) + 1))))
    return rng, payloads, modes, names, ranges


def check_stripes(cluster, payloads, locs, what: str) -> None:
    """Each object's first blob, as the blobnodes hold it, against the numpy
    encode."""
    from chubaofs_tpu_torch.codec.codemode import get_tactic
    from chubaofs_tpu_torch.ops import gf256

    for name in sorted(payloads):
        blob, payload = next(blob_payloads(locs[name], payloads[name]))
        want = oracle_stripe(gf256, get_tactic(locs[name].code_mode), payload)
        check(np.array_equal(stored_stripe(cluster, blob), want), f"{name}: {what} stripe != oracle")


def break_two_disks(cluster, locs, payloads) -> dict:
    """The disks under the first big blob's data shard 0 and parity 13 lose
    every shard and are marked broken. Returns (vid, bid, unit index) -> the
    lost shard's bytes."""
    from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN

    c = cluster
    vol0 = c.cm.get_volume(locs["big0"].blobs[0].vid)
    victims = {vol0.units[0].disk_id, vol0.units[13].disk_id}
    lost = {}
    for name in sorted(payloads):
        for blob, _ in blob_payloads(locs[name], payloads[name]):
            vol = c.cm.get_volume(blob.vid)
            for idx, u in enumerate(vol.units):
                if u.disk_id in victims:
                    lost[(blob.vid, blob.bid, idx)] = c.nodes[u.node_id].get_shard(u.vuid, blob.bid)
                    c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
    for d in victims:
        c.cm.set_disk_status(d, DISK_BROKEN)
    return lost


def phase_gateway(root: str, device, big_mib: int = 64, clients: int = 4,
                  lrc: bool = True) -> dict:
    """Phase 5 (and, with lrc=False, phase 6): the blobstore's own main path
    on `device`. Returns wall seconds per step."""
    from chubaofs_tpu_torch.blobstore.access import MAX_BLOB_SIZE
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
    from chubaofs_tpu_torch.codec.codemode import CodeMode
    from chubaofs_tpu_torch.utils.exporter import registry

    steps = {}
    rng, payloads, modes, names, ranges = gateway_mix(big_mib, clients)

    c = MiniCluster(os.path.join(root, "az1"), n_nodes=9, disks_per_node=2, device=device)
    try:
        t0 = time.perf_counter()
        locs = put_concurrently(lambda i: c.access, {n: payloads[n] for n in payloads
                                                     if n.startswith("big")}, clients)
        steps["put_big"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        locs.update(put_concurrently(lambda i: c.access, {n: payloads[n] for n in payloads
                                                          if not n.startswith("big")}, clients))
        steps["put_small"] = time.perf_counter() - t0
        for name, loc in locs.items():
            check(loc.code_mode == int(modes[name]), f"{name}: code mode {loc.code_mode}")
            check(loc.size == len(payloads[name]), f"{name}: size {loc.size}")
        check(len(locs["big0"].blobs) == big_mib * MiB // MAX_BLOB_SIZE, "64 MiB -> 4 MiB blobs")

        t0 = time.perf_counter()
        get_all(c.access, payloads, locs, ranges)
        steps["get_and_ranged"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        check_stripes(c, payloads, locs, "stored")
        steps["stripe_check"] = time.perf_counter() - t0

        # degraded: two disks under the first big blob's data shard 0 and parity 13 lose everything
        t0 = time.perf_counter()
        lost = break_two_disks(c, locs, payloads)
        decoded0 = registry("access").counter("read_bytes", {"kind": "decoded"}).value
        get_all(c.access, payloads, locs, ranges)
        decoded = registry("access").counter("read_bytes", {"kind": "decoded"}).value - decoded0
        check(decoded > 0, "degraded GETs decoded nothing")
        steps["degraded_get_and_ranged"] = time.perf_counter() - t0

        # repair: the background loops until every lost shard is back, byte-equal
        t0 = time.perf_counter()
        ticks, pending = 0, dict(lost)
        while pending and ticks < 30:
            c.run_background_once()
            ticks += 1
            for key in list(pending):
                vid, bid, idx = key
                u = c.cm.get_volume(vid).units[idx]
                try:
                    got = c.nodes[u.node_id].get_shard(u.vuid, bid)
                except Exception:
                    continue
                check(got == pending.pop(key), f"rebuilt shard {key} != the one lost")
        check(not pending, f"{len(pending)} of {len(lost)} lost shards not rebuilt in {ticks} ticks")
        check_stripes(c, payloads, locs, "repaired")  # the rebuilt stripes hold too
        get_all(c.access, payloads, locs, ranges[:8])
        steps["repair"] = time.perf_counter() - t0
        steps["repaired_shards"] = len(lost)
        steps["repair_ticks"] = ticks
    finally:
        c.close()

    if lrc:
        t0 = time.perf_counter()
        c = MiniCluster(os.path.join(root, "az3"), azs=3, n_nodes=6, disks_per_node=2,
                          device=device)
        try:
            lp = {f"lrc{i}": rng.bytes(8 * MiB) for i in range(4)}
            llocs = {n: c.access.put(d, code_mode=CodeMode.EC6P3L3) for n, d in lp.items()}
            for name, loc in llocs.items():
                for blob, payload in blob_payloads(loc, lp[name]):
                    u = c.cm.get_volume(blob.vid).units[1]
                    c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
            for name, loc in llocs.items():
                check(c.access.get(loc) == lp[name], f"LRC GET {name}")
                check(c.access.get(loc, 5 * MiB + 7, 300_000) == lp[name][5 * MiB + 7:5 * MiB + 300_007],
                      f"LRC ranged GET {name}")
        finally:
            c.close()
        steps["lrc_put_lose_get"] = time.perf_counter() - t0
    return steps


# -- phase 7: the daemon path over HTTP --------------------------------------------


def http_get_all(client, payloads, locs, ranges) -> None:
    """Every object through POST /get, then each range as an HTTP `Range:`
    GET, which must answer 206 with its Content-Range."""
    for name, data in payloads.items():
        check(client.get(locs[name]) == data, f"HTTP GET {name}")
    for name, off, ln in ranges:
        status, headers, body = client.get_range(locs[name], f"bytes={off}-{off + ln - 1}")
        check(status == 206 and body == payloads[name][off:off + ln],
              f"Range GET {name} [{off}, +{ln}): status {status}")
        check(headers.get("Content-Range") == f"bytes {off}-{off + ln - 1}/{len(payloads[name])}",
              f"Range GET {name}: Content-Range {headers.get('Content-Range')}")


def scrape(addr: str) -> dict:
    """One /metrics scrape of a daemon, parsed."""
    from chubaofs_tpu_torch.rpc.client import RPCClient
    from chubaofs_tpu_torch.tools.cfsstat import parse_metrics

    status, _, text = RPCClient([addr]).do("GET", "/metrics")
    check(status == 200, f"/metrics: status {status}")
    return parse_metrics(text.decode())


def pinned_host_bytes() -> dict:
    """The page-locked host allocator's current counters, where this torch
    reports them (torch.cuda.host_memory_stats), else {}."""
    stats = getattr(torch.cuda, "host_memory_stats", lambda: {})()
    return {k: v for k, v in stats.items() if k.endswith(".current")}


def kernel_libraries() -> dict:
    from chubaofs_tpu_torch.ops import cuda_gf

    return {p.name: p.stat().st_mtime_ns for p in cuda_gf.BUILD_DIR.glob("*.so")}


def phase_daemon(root: str, device: str = "cuda", big_mib: int = 64, clients: int = 4) -> dict:
    """Phase 7(a): the blobstore daemon, started through cmd.start_role as a
    user starts it, served over HTTP with its codec on the card. Returns wall
    seconds per step."""
    from chubaofs_tpu_torch.blobstore.gateway import AccessClient
    from chubaofs_tpu_torch.cli import blobstore as bs_cli
    from chubaofs_tpu_torch.cmd import start_role
    from chubaofs_tpu_torch.ops import cuda_gf
    from chubaofs_tpu_torch.utils.exporter import registry

    steps = {}
    _, payloads, modes, names, ranges = gateway_mix(big_mib, clients)
    lib = cuda_gf.load() if device == "cuda" else None
    libs = kernel_libraries()
    t0 = time.perf_counter()
    daemon = start_role({"role": "blobstore", "root": os.path.join(root, "blob"), "nodes": 9,
                         "disksPerNode": 2, "listen": "127.0.0.1:0", "device": device})
    try:
        addr = daemon.addr
        steps["boot"] = time.perf_counter() - t0
        # the codec registry is process-wide: phase 7's batches are its growth
        batches0 = scrape(addr).get("cfs_codec_batches_total", 0.0)

        # PUT over HTTP, each client thread with its own AccessClient
        t0 = time.perf_counter()
        locs = put_concurrently(lambda i: AccessClient([addr]), {n: payloads[n] for n in names
                                                                 if n.startswith("big")}, clients)
        steps["put_big"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        locs.update(put_concurrently(lambda i: AccessClient([addr]), {
            n: payloads[n] for n in names if not n.startswith("big")}, clients))
        steps["put_small"] = time.perf_counter() - t0
        for name, loc in locs.items():
            check(loc.code_mode == int(modes[name]) and loc.size == len(payloads[name]),
                  f"{name}: code mode {loc.code_mode}, size {loc.size}")

        # GET over HTTP: every object, 32 ranges, a suffix range, an unsatisfiable one
        client = AccessClient([addr])
        t0 = time.perf_counter()
        http_get_all(client, payloads, locs, ranges)
        status, headers, body = client.get_range(locs["mid0"], "bytes=-4097")
        check(status == 206 and body == payloads["mid0"][-4097:], f"suffix Range GET: {status}")
        size = len(payloads["small0"])
        status, headers, _ = client.get_range(locs["small0"], f"bytes={size}-")
        check(status == 416 and headers.get("Content-Range") == f"bytes */{size}",
              f"unsatisfiable Range GET: {status} {headers.get('Content-Range')}")
        steps["get_and_ranged"] = time.perf_counter() - t0

        c = daemon.runner.handles["cluster"]
        t0 = time.perf_counter()
        check_stripes(c, payloads, locs, "stored")
        steps["stripe_check"] = time.perf_counter() - t0

        # degraded GET over HTTP through the daemon's own cluster handle
        t0 = time.perf_counter()
        lost = break_two_disks(c, locs, payloads)
        decoded0 = registry("access").counter("read_bytes", {"kind": "decoded"}).value
        http_get_all(client, payloads, locs, ranges)
        decoded = registry("access").counter("read_bytes", {"kind": "decoded"}).value - decoded0
        check(decoded > 0, "degraded HTTP GETs decoded nothing")
        steps["degraded_get_and_ranged"] = time.perf_counter() - t0

        # repair by the daemon's own background tick (every 1 s); the check
        # takes the runner lock, so it never reads a shard the tick is writing
        t0 = time.perf_counter()
        pending = dict(lost)

        def rebuilt(cluster):
            for key in list(pending):
                vid, bid, idx = key
                u = cluster.cm.get_volume(vid).units[idx]
                try:
                    got = cluster.nodes[u.node_id].get_shard(u.vuid, bid)
                except Exception:
                    continue
                check(got == pending.pop(key), f"rebuilt shard {key} != the one lost")

        deadline = time.monotonic() + REPAIR_DEADLINE_S
        while pending and time.monotonic() < deadline:
            daemon.runner.call_with("cluster", rebuilt)
            if pending:
                time.sleep(0.2)
        check(not pending, f"{len(pending)} of {len(lost)} lost shards not rebuilt by the "
                           f"daemon's tick in {REPAIR_DEADLINE_S} s")
        daemon.runner.call_with("cluster", lambda cl: check_stripes(cl, payloads, locs, "repaired"))
        steps["repair"] = time.perf_counter() - t0
        steps["repaired_shards"] = len(lost)

        # the admin surface through the CLI
        t0 = time.perf_counter()
        out = io.StringIO()
        check(bs_cli.main(["--addr", addr, "stat"], stdout=out) == 0, "cli stat")
        stat = json.loads(out.getvalue())
        check(stat["disks"] == 18 and stat["volumes"] >= 1 and stat["reloads"] == 0,
              f"cli stat: {stat}")
        out = io.StringIO()
        check(bs_cli.main(["--addr", addr, "task", "ls"], stdout=out) == 0, "cli task ls")
        check("disk_repair" in out.getvalue(), f"cli task ls shows no disk repair: "
                                               f"{out.getvalue()[:500]}")
        steps["admin_cli"] = time.perf_counter() - t0

        # graceful reload: a new cluster and CodecService on the card, same address
        t0 = time.perf_counter()
        old_codec = c.codec
        steps["pinned_before_reload"] = pinned_host_bytes() if device == "cuda" else {}
        out = io.StringIO()
        check(bs_cli.main(["--addr", addr, "reload"], stdout=out) == 0, "cli reload")
        deadline = time.monotonic() + 60
        while daemon.runner.reloads < 1 and time.monotonic() < deadline:
            time.sleep(0.05)
        check(daemon.runner.reloads == 1, f"reload: {daemon.runner.last_error}")
        check(daemon.runner.handles["gateway"].addr == addr, "reload moved the address")
        c = daemon.runner.handles["cluster"]
        check(c.codec is not old_codec and c.codec.device.type == device, "reload: codec")
        check(old_codec._closed and not old_codec._thread.is_alive(), "reload: old codec-svc alive")
        client = AccessClient([addr])
        for name in names:
            check(client.get(locs[name]) == payloads[name], f"GET {name} after reload")
        extra = np.random.default_rng(12).bytes(MiB)
        check(client.get(client.put(extra)) == extra, "PUT + GET after reload")
        codec_threads = [th.name for th in threading.enumerate() if th.name == "codec-svc"]
        check(len(codec_threads) == 1, f"codec-svc threads after reload: {len(codec_threads)}")
        check(kernel_libraries() == libs and (lib is None or cuda_gf.load() is lib),
              "reload rebuilt or reloaded B1")
        steps["reload_and_get"] = time.perf_counter() - t0
        steps["pinned_after_reload"] = pinned_host_bytes() if device == "cuda" else {}

        batches = scrape(addr).get("cfs_codec_batches_total", 0.0) - batches0
        check(batches > 0, f"/metrics: cfs_codec_batches_total grew by {batches}")
        steps["codec_batches"] = batches
    finally:
        t0 = time.perf_counter()
        daemon.stop()
        steps["stop"] = time.perf_counter() - t0
    return steps


def phase_daemon_process(root: str, device: str = "cuda") -> dict:
    """Phase 7(b): `python -m chubaofs_tpu_torch.cmd -c cfg.json` as a second
    process on the card: boot line, PUT / GET / Range GET, /metrics and
    /health, then SIGTERM must end it with exit code 0 within 30 s. It loads
    the kernels this process built and builds none."""
    import signal

    from chubaofs_tpu_torch.blobstore.gateway import AccessClient
    from chubaofs_tpu_torch.rpc.client import RPCClient

    steps = {}
    os.makedirs(root, exist_ok=True)
    cfg = os.path.join(root, "daemon.json")
    with open(cfg, "w") as f:
        json.dump({"role": "blobstore", "root": os.path.join(root, "blob"), "nodes": 9,
                   "disksPerNode": 2, "listen": "127.0.0.1:0", "device": device}, f)
    libs = kernel_libraries()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    err = open(os.path.join(root, "daemon.stderr"), "w+")
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "chubaofs_tpu_torch.cmd", "-c", cfg],
                            cwd=str(ROOT), env=env, stdout=subprocess.PIPE, stderr=err, text=True)

    def stderr_tail() -> str:
        err.flush()
        err.seek(0)
        return err.read()[-4000:]

    try:
        boot: dict = {}
        reader = threading.Thread(target=lambda: boot.update(line=proc.stdout.readline()),
                                  daemon=True)
        reader.start()
        reader.join(timeout=180)
        check(bool(boot.get("line")), f"daemon printed no boot line; stderr:\n{stderr_tail()}")
        info = json.loads(boot["line"])
        check(info.get("role") == "blobstore" and info.get("addr"), f"boot line {info}")
        addr = info["addr"]
        steps["boot"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        client = AccessClient([addr])
        data = np.random.default_rng(13).bytes(4 * MiB)
        loc = client.put(data)
        check(client.get(loc) == data, "subprocess daemon: GET")
        status, headers, body = client.get_range(loc, "bytes=1000000-1999999")
        check(status == 206 and body == data[1_000_000:2_000_000]
              and headers.get("Content-Range") == f"bytes 1000000-1999999/{len(data)}",
              f"subprocess daemon: Range GET {status}")
        steps["put_get_range"] = time.perf_counter() - t0

        batches = scrape(addr).get("cfs_codec_batches_total", 0.0)
        check(batches > 0, f"subprocess daemon /metrics: cfs_codec_batches_total = {batches}")
        status, _, body = RPCClient([addr]).do("GET", "/health")
        health = json.loads(body)
        check(status == 200 and "status" in health, f"subprocess daemon /health: {status}")
        steps["codec_batches_total"] = batches
        steps["health"] = health["status"]

        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        try:
            rc = proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            rc = None
        if rc != 0:
            log(f"daemon stderr:\n{stderr_tail()}")
        check(rc == 0, f"daemon exit code after SIGTERM: {rc} (within 30 s)")
        steps["sigterm_exit"] = time.perf_counter() - t0
        check(kernel_libraries() == libs, "the second process rebuilt a kernel")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        err.close()
    return steps


# -- phase 8: the codec path over device grids --------------------------------------


def phase_mesh(root: str, count, device: str = "cuda", shard_len: int = MiB,
               big_mib: int = 64) -> tuple[dict, dict, dict]:
    """Phase 8: parallel/mesh.py on a grid of every CUDA device (codec_mesh())
    and on a 2 x 2 grid of cuda:0, at FLAGSHIP EC(12,4) with 1 MiB shards
    (device="cpu" and smaller sizes rehearse it on the host). count() reads
    B1's launch counter. Returns (wall seconds per step, B1 launches per
    step, sharded_gf_matmul vs gf_matmul_hostbatch: seconds of each call and
    B1 launches per call)."""
    from chubaofs_tpu_torch import entry
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
    from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix
    from chubaofs_tpu_torch.codec.service import CodecService
    from chubaofs_tpu_torch.models import ARCHIVE, FLAGSHIP
    from chubaofs_tpu_torch.ops import bitmatrix, gf256, rs
    from chubaofs_tpu_torch.parallel import (
        codec_mesh, shard_stripes, sharded_codec_step, sharded_gf_matmul, ungroup_stripe)
    from chubaofs_tpu_torch.utils.exporter import registry

    steps, launches = {}, {}

    def timed(name: str, fn):
        """fn() ends on the host (a gathered array or a synchronized call)."""
        before = count()
        t0 = time.perf_counter()
        out = fn()
        steps[name] = time.perf_counter() - t0
        launches[name] = count() - before
        return out

    t = FLAGSHIP.tactic
    n, m = t.N, t.M
    kernel = rs.get_kernel(n, m, device)
    one = torch.device(device, 0) if device == "cuda" else torch.device(device)
    grids = {"all": codec_mesh() if device == "cuda" else codec_mesh([one]),
             "2x2": codec_mesh([one] * 4, dp=2, sp=2)}
    log(f"grids: {grids}")
    rng = np.random.default_rng(21)
    data16 = rng.integers(0, 256, (16, n, shard_len), dtype=np.uint8)
    want16 = timed("single_device_encode_b16", lambda: kernel.encode(data16).cpu().numpy())
    for i in (0, 15):
        check(np.array_equal(want16[i], gf256.encode_numpy(kernel.gen, data16[i])),
              f"single-device stripe {i} != numpy oracle")

    # (b) the codec step: b = 16 (the main path's shape) and b = 2 dp + 1
    for gname, mesh in grids.items():
        dp = mesh.shape["dp"]
        for b in (16, 2 * dp + 1):
            run = sharded_codec_step(mesh, n, m)
            data, want = data16[:b], want16[:b]
            for bad in ((0, n), (1, n - 1, n + 1)):
                stripe, ok, repaired = timed(
                    f"{gname}_step_b{b}_bad{'_'.join(map(str, bad))}",
                    lambda: [np.asarray(a) for a in run(data, bad_idx=bad)])
                what = f"{gname} step b={b} bad={bad}"
                check(np.array_equal(stripe, want), f"{what}: stripe != single-device B1")
                check(ok.shape == (b,) and bool(ok.all()), f"{what}: ok {ok}")
                check(np.array_equal(repaired, stripe), f"{what}: repaired != stripe")
            check(run.trace_count[0] == 1, f"{gname} b={b}: {run.trace_count[0]} setups")
            if b % dp == 0:  # a corrupted byte flips exactly its own stripe's ok
                bad = stripe.copy()
                bad[b // 2, n + 1, shard_len // 3] ^= 0xFF
                ok = timed(f"{gname}_verify_corrupt_b{b}",
                           lambda: kernel.verify(shard_stripes(mesh, bad)).cpu().numpy())
                check(not ok[b // 2] and ok[np.arange(b) != b // 2].all(),
                      f"{gname} b={b}: verify after corruption {ok}")

    # (c) sharded_gf_matmul against rs.gf_matmul_hostbatch, 16 x EC(12,4) 1 MiB,
    # in turns (the first round warms the page-locked buffers)
    bits = kernel.parity_bits
    check(np.array_equal(rs.gf_matmul_hostbatch(bits, data16, device), want16[:, n:]),
          "gf_matmul_hostbatch != single-device encode")
    calls = {"hostbatch": lambda: rs.gf_matmul_hostbatch(bits, data16, device)}
    for gname, mesh in grids.items():
        calls[f"grid_{gname}"] = functools.partial(sharded_gf_matmul(mesh), bits, data16)
    matmul = {name: {"seconds": [], "launches_per_call": 0} for name in calls}
    for it in range(5):
        for name in (list(calls) if it % 2 == 0 else list(reversed(calls))):
            before = count()
            t0 = time.perf_counter()
            got = calls[name]()
            matmul[name]["seconds"].append(time.perf_counter() - t0)
            matmul[name]["launches_per_call"] = count() - before
            check(np.array_equal(got, want16[:, n:]), f"{name}: parity != hostbatch")
    for rec in matmul.values():
        rec["median_after_first"] = float(np.median(rec["seconds"][1:]))

    # (d) the grouped step, g = 2, on the 2 x 2 grid at an uneven b
    mesh = grids["2x2"]
    run_g = sharded_codec_step(mesh, n, m, group=2)
    stripe_g, ok_g, repaired_g = timed(
        "2x2_grouped_g2_b5", lambda: [np.asarray(a) for a in run_g(data16[:5], bad_idx=(0, n))])
    check(np.array_equal(ungroup_stripe(stripe_g, 2, n, m, b=5), want16[:5]), "grouped stripe")
    check(np.array_equal(ungroup_stripe(repaired_g, 2, n, m, b=5), want16[:5]), "grouped repair")
    check(ok_g.shape == (5,) and bool(ok_g.all()), f"grouped ok {ok_g}")

    # (e) ARCHIVE EC(20,4)+L2, 16 MiB objects, over the 2 x 2 grid
    ta = ARCHIVE.tactic
    lrc_mat = lrc_parity_matrix(ta)
    lrc_bits = bitmatrix.expand_matrix(lrc_mat).astype(np.int8)
    data_a = rng.integers(0, 256, (4, ta.N, ARCHIVE.shard_len * shard_len // MiB), dtype=np.uint8)
    got = timed("2x2_archive_lrc_16mib_x4", lambda: sharded_gf_matmul(mesh)(lrc_bits, data_a))
    check(np.array_equal(got, rs.gf_matmul_hostbatch(lrc_bits, data_a, device)),
          "grid LRC parity != hostbatch")
    check(np.array_equal(got[0], gf256.gf_matmul(lrc_mat, data_a[0])), "grid LRC != numpy oracle")

    # (f) the blobstore on a grid-backed CodecService
    t0 = time.perf_counter()
    before = count()
    svc = CodecService(mesh=mesh)
    try:
        c = MiniCluster(os.path.join(root, "grid"), n_nodes=9, disks_per_node=2, codec=svc)
        try:
            payloads = {"big": rng.bytes(big_mib * MiB), "small": rng.bytes(300_000)}
            locs = {name: c.access.put(p) for name, p in payloads.items()}
            lost = {}
            for name, payload in payloads.items():
                for blob, _ in blob_payloads(locs[name], payload):
                    u = c.cm.get_volume(blob.vid).units[1]
                    lost[(blob.vid, blob.bid)] = (u, c.nodes[u.node_id].get_shard(u.vuid, blob.bid))
                    c.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
            decoded0 = registry("access").counter("read_bytes", {"kind": "decoded"}).value
            for name, payload in payloads.items():
                check(c.access.get(locs[name]) == payload, f"grid degraded GET {name}")
            off, ln = big_mib * MiB // 13 + 7, big_mib * MiB // 21
            check(c.access.get(locs["big"], off, ln) == payloads["big"][off:off + ln],
                  "grid degraded ranged GET")
            check(registry("access").counter("read_bytes", {"kind": "decoded"}).value > decoded0,
                  "grid degraded GETs decoded nothing")
            ticks = 0
            while ticks < 30 and any(_missing(c, u, bid) for (_, bid), (u, _) in lost.items()):
                c.run_background_once()
                ticks += 1
            for (vid, bid), (u, shard) in lost.items():
                check(c.nodes[u.node_id].get_shard(u.vuid, bid) == shard,
                      f"grid repair of ({vid}, {bid}) unit 1")
            for name, payload in payloads.items():
                check(c.access.get(locs[name]) == payload, f"grid GET {name} after the heal")
            steps["2x2_minicluster_heal_ticks"] = ticks
            steps["2x2_minicluster_lost_shards"] = len(lost)
            check(svc.stats_snapshot()["batches"] > 0, "the grid service ran no batch")
        finally:
            c.close()
    finally:
        svc.close()
    steps["2x2_minicluster_put_lose_get_heal"] = time.perf_counter() - t0
    launches["2x2_minicluster_put_lose_get_heal"] = count() - before

    # (g) the entry points on the card
    fn, (example,) = timed("entry", lambda: entry.entry(None if device == "cuda" else device))
    out = fn(example)
    check(out.device.type == device and tuple(out.shape) == (2, n + m, 1024), "entry() output")
    check(np.array_equal(out[1].cpu().numpy(), gf256.encode_numpy(kernel.gen, example[1])),
          "entry() != numpy oracle")
    got = timed("dryrun_multichip_4", lambda: entry.dryrun_multichip(
        4, None if device == "cuda" else device, shard_len))
    check((got["dp"], got["sp"], got["shard_len"]) == (2, 2, shard_len),
          f"dryrun_multichip(4): {got}")
    return steps, launches, matmul


def _missing(cluster, unit, bid) -> bool:
    from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard

    try:
        cluster.nodes[unit.node_id].get_shard(unit.vuid, bid)
    except NoSuchShard:
        return True
    return False


def build_all(libs) -> float:
    """One nvcc per kernel source, all started together."""
    t0 = time.perf_counter()
    errors = []

    def build(lib):
        try:
            lib.load()
        except Exception as e:  # reported below, fails the phase
            errors.append(f"{lib.__name__}: {e}")

    threads = [threading.Thread(target=build, args=(lib,)) for lib in libs]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    check(not errors, f"kernel build failed: {errors}")
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
    os.environ.pop("CFS_GF_PIPELINED", None)  # phases 3-5 run B1; phase 6 sets it

    from chubaofs_tpu_torch import models
    from chubaofs_tpu_torch.codec import CodeMode, new_encoder, pm
    from chubaofs_tpu_torch.codec.codemode import get_tactic
    from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix
    from chubaofs_tpu_torch.codec.service import CodecService
    from chubaofs_tpu_torch.ops import bitmatrix, cuda_gf, cuda_gf_pipe, gf256, rs

    t_start = time.perf_counter()
    wall = {}
    smi = nvidia_smi_line()
    log(f"device: {torch.cuda.get_device_name(0)} | nvidia-smi: {smi} | torch "
        f"{torch.__version__} cuda {torch.version.cuda}")

    def zero_counts():
        cuda_gf.LAUNCHES = 0
        for v in cuda_gf_pipe.LAUNCHES:
            cuda_gf_pipe.LAUNCHES[v] = 0

    def read_counts() -> dict:
        torch.cuda.synchronize()
        return {"gf_matmul": cuda_gf.LAUNCHES,
                "gf_matmul_pipe": cuda_gf_pipe.LAUNCHES["dynamic"],
                "gf_matmul_pipe_static": cuda_gf_pipe.LAUNCHES["static"]}

    # phase 1: build
    wall["1_build"] = build_all([cuda_gf, cuda_gf_pipe])
    for lib in (cuda_gf, cuda_gf_pipe):
        log(f"build: {lib.__name__} {lib.BUILD_INFO['seconds']:.2f} s -> {lib.BUILD_INFO['path']}")
        log(lib.BUILD_INFO["ptxas"])
        for line in ptxas_summary(lib.BUILD_INFO["ptxas"]):
            log(f"ptxas {lib.__name__}: {line}")
    for line in sass_loops(cuda_gf.BUILD_INFO["path"]):
        log(f"sass {cuda_gf.__name__}: {line}")

    # phase 2: each kernel against its plain version
    t0 = time.perf_counter()
    kernels = {
        "gf_matmul": (cuda_gf.gf_matmul, lambda: cuda_gf.LAUNCHES, cuda_gf.blocks),
        "gf_matmul_pipe": (lambda b, x: cuda_gf_pipe.gf_matmul_bytes_pipelined(b, x),
                           lambda: cuda_gf_pipe.LAUNCHES["dynamic"], cuda_gf_pipe.blocks),
        "gf_matmul_pipe_static": (
            lambda b, x: cuda_gf_pipe.gf_matmul_bytes_pipelined(b, x, static_slots=True),
            lambda: cuda_gf_pipe.LAUNCHES["static"], cuda_gf_pipe.blocks),
    }
    def b2_smem(r, n, k):
        """B2's shared memory is dynamic: (kt, bytes) of each launch of its plan."""
        out = []
        for r0, r1, j0, j1 in cuda_gf_pipe.blocks(r, n):
            kt = cuda_gf_pipe.pick_tile(r1 - r0, j1 - j0, k)
            out.append((kt, cuda_gf_pipe.smem_bytes(r1 - r0, j1 - j0, kt)))
        return out

    cases = kernel_cases(rs, pm, cuda_gf, lrc_parity_matrix, get_tactic)
    records, max_err = phase_kernels(kernels, rs, bitmatrix, cases, b2_smem)
    main_rec = records[0]  # ec12p4_parity_bucket: what the service launches for FLAGSHIP
    wall["2_kernel_vs_plain"] = time.perf_counter() - t0

    # phases 3 + 4: the codec path, B1
    svc = CodecService(device="cuda")
    try:
        zero_counts()
        stats0 = svc.stats_snapshot()
        t0 = time.perf_counter()
        phases = phase_main_path(svc, gf256, pm, get_tactic, lrc_parity_matrix, models)
        phases["encoder_ec12p4_roundtrip"] = phase_encoder(new_encoder, CodeMode)
        counts = read_counts()
        stats = svc.stats_snapshot()
    finally:
        svc.close()
    wall["3_4_codec_path"] = time.perf_counter() - t0
    batches = stats["batches"] - stats0["batches"]
    log("main_path " + json.dumps({"seconds": wall["3_4_codec_path"], "phases_s": phases,
                                   "service_stats": stats, "device_batches": batches,
                                   "launches": counts}))
    check(counts["gf_matmul"] > 0, "the codec path launched no gf_matmul kernel")
    check(counts["gf_matmul"] >= batches, f"{counts['gf_matmul']} launches < {batches} device batches")

    launches = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        # phase 5: the gateway path, B1
        zero_counts()
        t0 = time.perf_counter()
        steps = phase_gateway(os.path.join(tmp, "p5"), "cuda")
        counts = read_counts()
        wall["5_gateway"] = time.perf_counter() - t0
        log("gateway " + json.dumps({"seconds": wall["5_gateway"], "steps_s": steps,
                                     "launches": counts}))
        check(counts["gf_matmul"] > 0, "the gateway path launched no gf_matmul kernel")
        check(counts["gf_matmul_pipe"] == counts["gf_matmul_pipe_static"] == 0,
              f"B2 launched without CFS_GF_PIPELINED: {counts}")
        launches["gf_matmul"] = counts["gf_matmul"]

        # phase 6: the single-AZ gateway path again, on each B2 variant
        for env, name in (("1", "gf_matmul_pipe"), ("static", "gf_matmul_pipe_static")):
            os.environ["CFS_GF_PIPELINED"] = env
            try:
                zero_counts()
                t0 = time.perf_counter()
                steps = phase_gateway(os.path.join(tmp, f"p6_{name}"), "cuda", lrc=False)
                counts = read_counts()
            finally:
                os.environ.pop("CFS_GF_PIPELINED", None)
            wall[f"6_gateway_{name}"] = time.perf_counter() - t0
            log(f"gateway CFS_GF_PIPELINED={env} " + json.dumps(
                {"seconds": wall[f"6_gateway_{name}"], "steps_s": steps, "launches": counts}))
            check(counts[name] > 0, f"CFS_GF_PIPELINED={env}: {name} never launched")
            check(all(v == 0 for k, v in counts.items() if k != name),
                  f"CFS_GF_PIPELINED={env}: other kernels launched: {counts}")
            launches[name] = counts[name]

        # phase 7: the daemon path over HTTP, B1
        zero_counts()
        t0 = time.perf_counter()
        steps = phase_daemon(os.path.join(tmp, "p7"))
        counts = read_counts()
        wall["7a_daemon"] = time.perf_counter() - t0
        check(counts["gf_matmul"] > 0, "the daemon path launched no gf_matmul kernel")
        check(counts["gf_matmul_pipe"] == counts["gf_matmul_pipe_static"] == 0,
              f"B2 launched on the daemon path without CFS_GF_PIPELINED: {counts}")
        t0 = time.perf_counter()
        proc_steps = phase_daemon_process(os.path.join(tmp, "p7b"))
        wall["7b_daemon_process"] = time.perf_counter() - t0
        log("daemon " + json.dumps({"seconds": wall["7a_daemon"], "steps_s": steps,
                                    "launches": counts,
                                    "process_seconds": wall["7b_daemon_process"],
                                    "process_steps_s": proc_steps}))

        # phase 8: the codec path over device grids, B1
        zero_counts()
        t0 = time.perf_counter()
        steps, step_launches, matmul = phase_mesh(os.path.join(tmp, "p8"), lambda: cuda_gf.LAUNCHES)
        counts = read_counts()
        wall["8_mesh"] = time.perf_counter() - t0
        check(counts["gf_matmul"] > 0, "the grid path launched no gf_matmul kernel")
        check(counts["gf_matmul_pipe"] == counts["gf_matmul_pipe_static"] == 0,
              f"B2 launched on the grid path: {counts}")
        log("mesh " + json.dumps({"seconds": wall["8_mesh"], "steps_s": steps,
                                  "launches_per_step": step_launches, "launches": counts,
                                  "gf_matmul_vs_hostbatch": matmul,
                                  "device": torch.cuda.get_device_name(0),
                                  "nvidia_smi": nvidia_smi_line()}))

    replaces = {"gf_matmul": ("chubaofs_tpu_torch/ops/csrc/gf_matmul.cu", "chubaofs_tpu/ops/pallas_gf.py:85"),
                "gf_matmul_pipe": ("chubaofs_tpu_torch/ops/csrc/gf_matmul_pipe.cu",
                                   "chubaofs_tpu/ops/pallas_gf_pipe.py:125"),
                "gf_matmul_pipe_static": ("chubaofs_tpu_torch/ops/csrc/gf_matmul_pipe.cu",
                                          "chubaofs_tpu/ops/pallas_gf_pipe.py:148")}
    line = [{
        "name": name,
        "route": "cuda",
        "source": src,
        "replaces": rep,
        "launches": launches[name],
        "max_abs_err": max_err[name],
        "ms": main_rec["kernels"][name]["ms"],
        "plain_ms": main_rec["plain_ms"],
        "bound_ms": main_rec["bound_us"] / 1e3,
        "bound_by": main_rec["bound_by"],
        "library_ms": None,
    } for name, (src, rep) in replaces.items()]
    log("wall_s " + json.dumps(wall))
    log(f"total: {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": line}))
    log(nvidia_smi_line())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
