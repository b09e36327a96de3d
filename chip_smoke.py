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
  9. soak harness, B1 only (B2 launches must be 0), chaos/soak.py on
            device="cuda", 9 nodes x 2 disks, objects of 120 KB, 1 MiB, 4 MiB
            and 16 MiB: (a) run_kill_soak, seed 7, 16 warm + 8 live PUTs
            (about 130 MiB acked): a blobnode killed under live PUTs, its
            disks found broken by heartbeat expiry, rebuilt by the repair
            plane; every acked blob must read back byte-identical, rebuild
            throughput be nonzero, no task stranded; (b) the same with every
            PUT on RG6P6, rebuilt through beta-fetch (some shards must be);
            (c) run_soak under each acceptance fault plan (node_wedge,
            link_drop, shard_bitrot), then run_cache_soak; (d) `python -m
            chubaofs_tpu_torch.tools.chaos_soak --kill-blobnode --mode RG6P6
            --json` as a second process with no --device: it must exit 0
            without building a kernel, and exit non-zero naming the missing
            device when CUDA_VISIBLE_DEVICES is empty.

  10. filesystem path, B1 only (B2 launches must be 0 in every step):
            FsCluster(root, device="cuda") at the reference's default layout
            (3 raft nodes carrying the master, metanode and authnode groups,
            4 datanodes x 2 disks, 9 blobnodes x 2 disks), a cold and a hot
            volume, driven through FsClient with 4 client threads. (a) cold
            write: 16 directories x 64 files of 4 KiB-256 KiB, 8 files of
            eight 4 MiB appends, then 10,000 empty creates in one directory;
            (b) cold read: every file whole and 256 seeded ranges, then every
            blob's stored stripe against the numpy encode; (c) two blobnode
            disks lose every shard: every file read again (degraded), then
            tick_background until every lost shard is back, byte-equal, and
            those stripes checked again; (d) hot volume: 64 files of 1 MiB,
            16 appends, one in-place overwrite, all read back; B1 launches
            must be 0; (e) unlink half the cold files, tick until the
            freelists drain, and every purged blob must be gone from the
            blobnodes; (f) close, open FsCluster on the same root and read
            64 seeded cold files and 8 hot ones back. B1 must launch in (a)
            and (c); healthy reads of a systematic code and purges code
            nothing, so (b), (e) and (f) report what they launched.

  11. the cluster as daemons, B1 only: the port's ProcCluster with no
            device, 3 masters, 3 metanodes, 3 datanodes, the blobstore daemon
            (9 blobnodes x 2 disks: a blob over 1 MiB is EC(12,4)) and the
            objectnode, each an OS process (`python -m chubaofs_tpu_torch.cmd`).
            The blobstore daemon codes on cuda:0; every other role is host
            work. (a) boot until a master leader answers, 6 nodes have
            registered and the gateway and objectnode listen; only the
            blobstore daemon may hold a CUDA context (nvidia-smi
            --query-compute-apps, read here and after (d)); (b) cold write: 4
            threads, each with its own RemoteCluster client, 512 files of
            4 KiB-256 KiB and 4 files of four 4 MiB appends; (c) every file
            read back whole and 256 seeded ranges; (d) S3: a user made by
            `python -m chubaofs_tpu_torch.cli`, a bucket (and a second one, timed
            beside the first), 64 objects of
            1 KiB-1 MiB and a multipart upload of 4 x 8 MiB parts through the
            objectnode with SigV4, everything GET and Range GET back; (e) a hot
            volume, 32 files of 64 KiB-1 MiB through the datanodes' chain
            replication; (f) SIGKILL the master leader and a metanode, respawn
            the metanode from its config: a new leader within 30 s, 100
            creates, the big files and 64 small ones read back; (g) unlink
            half the files of (b): within 60 s the metanodes' freelist drains
            delete every blob they held (a GET of it is refused); (h) close:
            every daemon exits 0 after SIGTERM within 30 s, none is left, and
            no daemon built a kernel. The launch counters live in the
            blobstore daemon, so device work is read from its /metrics
            (cfs_codec_batches_total) before and after each step: it must
            grow in (b) and (d) and stay put in (c) and (e).

  12. a cold volume through the port's client, B1 in the blobstore daemon:
            phase 11's 9-node ProcCluster with no device (3 masters, 3
            metanodes, 3 datanodes, the blobstore daemon) and a console over
            every daemon's /metrics. (a) boot, a cold and a hot volume; (b)
            where this process may mount FUSE, the `client` role as a daemon
            kernel-mounts the cold volume: 256 files of 4 KiB-1 MiB and 4 of
            64 MiB (sizes and bytes from --seed) written with plain os calls
            by 4 threads and fsync'd, the client daemon stopped and started
            again (its caches and the kernel's dropped), every byte read back,
            stat'ed and listed; where it may not, the line says why and the
            files go in through the SDK; (c) client.mount.Mount in process:
            open, write, pread, append, truncate, unlink while open; the
            port's libcfs built into build/libsdk_torch/, cfs_smoke on the
            cold volume, cfs_posix_soak 4 3 on the hot one (a cold volume
            refuses writes inside a file), and 64 MiB through the C ABI; (d)
            the blobstore daemon restarted with one blobnode's reads failing,
            and a 64 MiB file read back through the client, decoded on the
            card; (e) the console's rollup reaches every daemon, cfs-top
            --once over it, fsck finds the volume clean, preload walks the
            small files; (f) unmount and stop: every daemon exits 0, no mount
            is left. Codec batches (the blobstore daemon's /metrics) must
            grow in (b), (c) and (d).
  13. the port's measuring and checking tools: (a) tools/kernel_ab.py's CLI
            with its tile sweep (B1 and both B2 variants by slope timing over
            CUDA events at the BASELINE configs, the sweep up to the largest
            tile that fits 227 KiB): every GB/s reading positive and at most
            the HBM bound, every kernel launched, beside phase 2's GB/s at
            the same EC(12,4) shape; (b) the device-bound benches of
            tools/perfbench.py (put pipeline, repair, repair codes, ranged
            reads, cache zipf) on device="cuda" at their tier-1 tests' sizes,
            each with that test's floors and a nonzero B1 launch count; (c)
            cfs-capacity's clean arm (--seed 7 --duration 8 --rate 8
            --metanodes 3 --datanodes 0) through its CLI with no --device: exit
            0, at least 3 report frames, and of its daemons only the
            blobstore daemon holds a CUDA context.
  14. the BASELINE bench: `python -m chubaofs_tpu_torch.bench` as a child
            process, as a user runs it: exit 0 and one JSON line holding
            every BASELINE config key (EC(4,2), EC(6,3) and EC(12,4) encode,
            EC(12,4) encode on each B2 variant, the 1-missing reconstruct,
            the 3-missing bulk repair in GB/s and stripes/s, the EC(20,4)+L2
            encode), each positive and at most its HBM ceiling (3.35 TB/s x
            data bytes / bytes moved), the three EC(12,4) encode figures
            within 10% of phase 13a's kernel_ab readings of the same kernels
            at the same shape, and every kernel launched in the child.

Every path (3+4, 5, each pass of 6, 7a, 8, 9a, 9b, each soak of 9c, each step
of 10, 13a, each bench of 13b) is driven with every launch count set to 0
just before it and read just after; each step of 11 and 12 reads the blobstore daemon's codec
batches just before and just after; phase 14's child counts its own
launches from 0 and reports them in its line. Output ends with a `daemon` JSON line (phase 7's steps), a `mesh`
JSON line (phase 8's steps, B1 launches, the card's name and power limit), a
`soak` JSON line (phase 9's steps: wall seconds, rebuild seconds, shards and
shards/s, bytes per repaired shard, download/decode overlap, the top three
stages of the cfs-trace critical path, the rebuild's split over download,
decode and write-back, B1 launches), an `fs` JSON line (phase 10's steps:
wall seconds, cold write and read MiB/s, creates/s, B1 launches per step, B2
launches, shards rebuilt, the card's name and power limit), a `procs` JSON
line (phase 11's steps: wall seconds, cold write and read MiB/s, S3 PUT and
GET ops/s and MiB/s, creates/s after the failover and its seconds, codec
batches per step, the pids that held CUDA contexts and their memory, the
card's name and power limit), a `client` JSON line (phase 12's steps: wall
seconds, the FUSE state, write and read MiB/s through the mount and through
libcfs, codec batches per step, the degraded read's seconds, the card's name
and power limit), a `tools` JSON line (phase 13: kernel_ab's GB/s per kernel
and config, its tile sweep and verdict, phase 2's GB/s at the same shape,
each bench's numbers and launches, the capacity arm's exit code, frames and
CUDA holders, wall seconds per step, the card's name and power limit), a
`bench` JSON line (phase 14: the bench's line, its wall seconds, each key's
HBM ceiling, the EC(12,4) figures over kernel_ab's, the card's name and
power limit), a `kernels` JSON line, the card's name and power limit as nvidia-smi reports them, and the
one-line result JSON.
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


def run_clients(work, items: list, clients: int, what: str) -> None:
    """work(i, item) for every item, `clients` threads at a time, thread i
    taking items[i::clients]."""
    errors = []

    def client(i: int):
        try:
            for item in items[i::clients]:
                work(i, item)
        except Exception as e:  # reported below, fails the phase
            errors.append(f"client {i}: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=client, args=(i,)) for i in range(clients)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    check(not any(th.is_alive() for th in threads), f"{what} clients hung")
    check(not errors, f"{what} errors: {errors}")


def put_concurrently(access_of, payloads: dict[str, bytes], clients: int) -> dict:
    """PUT every payload, `clients` threads at a time, thread i through
    access_of(i); returns name -> Location."""
    locs, access = {}, {}

    def put(i, name):
        if i not in access:
            access[i] = access_of(i)
        locs[name] = access[i].put(payloads[name])

    run_clients(put, list(payloads), clients, "PUT")
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
    batches0 = registry("codec").counter("batches_total").value
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
            check(registry("codec").counter("batches_total").value > batches0,
                  "the grid service ran no batch")
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


# -- phase 9: the soak harness: kill-a-blobnode rebuilds and fault plans ------------


SOAK_SIZES = [120_000, MiB, 4 * MiB, 16 * MiB]  # EC(3,3), EC(6,3), EC(12,4) blobs


def repair_split(records: list[dict]) -> dict:
    """What the rebuild's time is made of, over every scheduler.repair span
    (one per disk-repair task) the soak finished: each span's critical path
    (cfs-trace) splits its wall time into download (the survivors' shard
    reads), wait.codec (the decode's queue wait), the decode batch's
    codec.host and codec.launch (host staging; the copies, the kernel and
    the wait for the stream), and what no stage covers (the write-back of
    the rebuilt shards and the scheduler's glue). Stages overlap by design,
    so the parts may sum past the wall."""
    from chubaofs_tpu_torch.tools.cfstrace import critical_path

    out = {"traces": len(records), "wall_ms": 0.0, "unattributed_ms": 0.0}
    for rec in records:
        cp = critical_path([rec])
        out["wall_ms"] += cp["wall_ms"]
        out["unattributed_ms"] += cp["unattributed_ms"]
        for st in cp["stages"]:
            key = f"{st['stage']}_ms"
            out[key] = out.get(key, 0.0) + st["ms"]
    return out


def kill_soak_step(root: str, seed: int, mode, zero_counts, read_counts,
                   warm_puts: int = 16, live_puts: int = 8) -> dict:
    """Phase 9a / 9b: run_kill_soak on the card at SOAK_SIZES. The soak
    itself fails (SoakFailure) unless every acked blob reads back byte-
    identical after the rebuild, the rebuild throughput is nonzero, and no
    task is stranded in WORKING; this adds B1 > 0 and B2 = 0 launches."""
    from chubaofs_tpu_torch.blobstore import trace
    from chubaofs_tpu_torch.chaos.soak import run_kill_soak

    records: list[dict] = []

    def collect(span):
        if span.operation == "scheduler.repair":
            records.append(span.to_record())

    prev = trace.finish_hook()
    trace.set_finish_hook(collect)  # run_kill_soak chains to it
    try:
        zero_counts()
        t0 = time.perf_counter()
        res = run_kill_soak(root, seed=seed, device="cuda", warm_puts=warm_puts,
                            live_puts=live_puts, sizes=SOAK_SIZES, mode=mode)
        wall = time.perf_counter() - t0
        counts = read_counts()
    finally:
        trace.set_finish_hook(prev)
    what = f"kill soak seed {seed} mode {mode}"
    check(res["ok"] and res["rebuilt_shards"] > 0 and res["rebuild_shards_per_s"] > 0,
          f"{what}: {res}")
    check(counts["gf_matmul"] > 0, f"{what}: B1 never launched")
    check(counts["gf_matmul_pipe"] == counts["gf_matmul_pipe_static"] == 0,
          f"{what}: B2 launched without CFS_GF_PIPELINED: {counts}")
    if mode is not None:
        check(res["code_mode"] == mode and res["beta_shards"] > 0,
              f"{what}: no shard rebuilt through beta-fetch: {res['beta_shards']}")
    cp = res["critical_path"] or {}
    return {
        "seconds": wall, "mode": res["code_mode"], "puts": res["puts"],
        "puts_rejected": res["puts_rejected"],
        "live_puts": res["live_puts"], "killed_node": res["killed_node"],
        "detect_s": res["detect_s"], "rebuild_s": res["rebuild_s"],
        "rebuilt_shards": res["rebuilt_shards"],
        "rebuild_shards_per_s": res["rebuild_shards_per_s"],
        "bytes_per_repaired_shard": res["bytes_per_repaired_shard"],
        "repair_overlap_ratio": res["repair_overlap_ratio"],
        "beta_shards": res["beta_shards"],
        "critical_path_top3": cp.get("stages", [])[:3],
        "critical_path_wall_ms": cp.get("wall_ms"),
        "rebuild_split": repair_split(records),
        "launches": counts,
    }


def soak_cli(root: str, env_extra: dict) -> tuple[int, str, str, float]:
    """`python -m chubaofs_tpu_torch.tools.chaos_soak --kill-blobnode --mode
    RG6P6 --seed 3 --json` with no --device, as a second process."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p), **env_extra)
    env.pop("CFS_GF_PIPELINED", None)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "chubaofs_tpu_torch.tools.chaos_soak", "--kill-blobnode",
         "--mode", "RG6P6", "--seed", "3", "--json", "--root", root],
        cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=600)
    return proc.returncode, proc.stdout, proc.stderr, time.perf_counter() - t0


def phase_soak(root: str, zero_counts, read_counts) -> dict:
    """Phase 9, B1 only, CFS_GF_PIPELINED unset: (a) run_kill_soak at the
    default modes, (b) the same under RG6P6 (beta-fetch repair, full gather
    when the killed node held two units of a stripe), (c) run_soak with each
    acceptance fault plan and then run_cache_soak, (d) the cfs-chaos-soak CLI
    as a second process on its default device, and again with no visible
    GPU, where it must fail naming the missing device. Any soak failure
    raises SoakFailure (with its incident bundle) out of this phase."""
    from chubaofs_tpu_torch.chaos.soak import run_cache_soak, run_soak
    from chubaofs_tpu_torch.tools.chaos_soak import ACCEPTANCE_PLANS

    steps = {}
    steps["9a_kill_default"] = kill_soak_step(os.path.join(root, "9a"), 7, None,
                                              zero_counts, read_counts)
    log("soak 9a " + json.dumps(steps["9a_kill_default"]))
    steps["9b_kill_rg6p6"] = kill_soak_step(os.path.join(root, "9b"), 8, "RG6P6",
                                            zero_counts, read_counts)
    log("soak 9b " + json.dumps(steps["9b_kill_rg6p6"]))

    for plan in ACCEPTANCE_PLANS:
        zero_counts()
        t0 = time.perf_counter()
        res = run_soak(os.path.join(root, f"9c_{plan}"), plan, seed=7, device="cuda",
                       sizes=SOAK_SIZES)
        wall = time.perf_counter() - t0
        counts = read_counts()
        check(res["ok"] and res["puts"] > 0 and res["gets"] > 0, f"soak {plan}: {res}")
        check(counts["gf_matmul"] > 0, f"soak {plan}: B1 never launched")
        check(counts["gf_matmul_pipe"] == counts["gf_matmul_pipe_static"] == 0,
              f"soak {plan}: B2 launched: {counts}")
        steps[f"9c_{plan}"] = {"seconds": wall, "puts": res["puts"],
                               "puts_rejected": res["puts_rejected"], "gets": res["gets"],
                               "max_get_s": res["max_get_s"], "fired": res["fired"],
                               "injections": sum(e["event"] == "inject" for e in res["events"]),
                               "launches": counts}
    zero_counts()
    t0 = time.perf_counter()
    res = run_cache_soak(os.path.join(root, "9c_cache"), seed=7, device="cuda")
    wall = time.perf_counter() - t0
    counts = read_counts()
    check(res["ok"] and res["gets"] > 0 and res["deletes"] > 0, f"cache soak: {res}")
    check(counts["gf_matmul"] > 0, "cache soak: B1 never launched")
    check(counts["gf_matmul_pipe"] == counts["gf_matmul_pipe_static"] == 0,
          f"cache soak: B2 launched: {counts}")
    steps["9c_cache"] = {"seconds": wall, "gets": res["gets"], "overwrites": res["overwrites"],
                         "deletes": res["deletes"], "promoted_peak": res["promoted_peak"],
                         "launches": counts}

    libs = kernel_libraries()
    rc, out, err, wall = soak_cli(os.path.join(root, "9d"), {})
    if rc != 0:
        log(f"cfs-chaos-soak stderr:\n{err[-4000:]}")
    check(rc == 0, f"cfs-chaos-soak on its default device: exit code {rc}")
    check(kernel_libraries() == libs, "the cfs-chaos-soak process rebuilt a kernel")
    doc = json.loads(out)
    (kill,) = doc["results"]
    check(doc["ok"] and kill["ok"] and kill["code_mode"] == "RG6P6"
          and kill["rebuilt_shards"] > 0, f"cfs-chaos-soak result: {kill}")
    steps["9d_cli"] = {"seconds": wall, "launches": None,  # another process's counts
                       **{k: kill[k] for k in ("rebuild_s", "rebuilt_shards",
                                               "rebuild_shards_per_s",
                                               "bytes_per_repaired_shard",
                                               "repair_overlap_ratio", "beta_shards")},
                       "critical_path_top3": (kill.get("critical_path") or {}).get(
                           "stages", [])[:3]}
    rc, out, err, wall = soak_cli(os.path.join(root, "9d_nogpu"), {"CUDA_VISIBLE_DEVICES": ""})
    check(rc != 0 and "no CUDA device" in err and not out.strip(),
          f"cfs-chaos-soak with no visible GPU: exit code {rc}, stderr {err[-2000:]!r}")
    check(not os.path.exists(os.path.join(root, "9d_nogpu")),
          "cfs-chaos-soak with no visible GPU built a cluster")
    steps["9d_cli_no_gpu"] = {"seconds": wall, "exit_code": rc,
                              "error": err.strip().splitlines()[-1]}
    return steps


# -- phase 10: the filesystem path ------------------------------------------------

FS_REPAIR_DEADLINE_S = 180  # phase 10c: tick_background rebuilds every lost shard
FS_PURGE_DEADLINE_S = 60  # phase 10e: tick_background drains every freelist


def fs_tree(dirs: int, files: int, bigs: int):
    """Phase 10's seeded cold tree: `dirs` directories of `files` files of
    4 KiB-256 KiB each, and `bigs` files of eight 4 MiB appends. Returns
    (rng, path -> list of appends)."""
    rng = np.random.default_rng(10)
    tree = {}
    for d in range(dirs):
        for f in range(files):
            tree[f"/d{d:02d}/f{f:02d}"] = [rng.bytes(int(rng.integers(4 * 1024, 256 * 1024 + 1)))]
    for b in range(bigs):
        tree[f"/big/b{b}"] = [rng.bytes(4 * MiB) for _ in range(8)]
    return rng, tree


def fs_blobs(fs, tree: dict, paths) -> list:
    """(Location, blob, payload) of every blob under `paths`, from the
    inodes' obj_extents."""
    from chubaofs_tpu_torch.blobstore.access import Location

    out = []
    for path in paths:
        data = b"".join(tree[path])
        pos = 0
        for ext in fs.meta.get_inode(fs.resolve(path)).obj_extents:
            loc = Location.from_json(ext["loc"])
            out += [(loc, blob, payload) for blob, payload in
                    blob_payloads(loc, data[pos:pos + ext["size"]])]
            pos += ext["size"]
        check(pos == len(data), f"{path}: obj_extents cover {pos} of {len(data)} bytes")
    return out


def check_fs_stripes(cluster, blobs, what: str, clients: int) -> None:
    """Every blob's stored stripe against the numpy encode (numpy's table
    lookups release the GIL, so `clients` threads share the work)."""
    from chubaofs_tpu_torch.codec.codemode import get_tactic
    from chubaofs_tpu_torch.ops import gf256

    def one(i, item):
        loc, blob, payload = item
        want = oracle_stripe(gf256, get_tactic(loc.code_mode), payload)
        check(np.array_equal(stored_stripe(cluster.blobstore, blob), want),
              f"blob {blob.vid}/{blob.bid}: {what} stripe != oracle")

    run_clients(one, blobs, clients, "stripe check")


def read_tree(fs_of, tree: dict, paths, clients: int) -> None:
    def read(i, path):
        check(fs_of(i).read_file(path) == b"".join(tree[path]), f"read {path}")

    run_clients(read, sorted(paths), clients, "read")


def phase_fs(root: str, device, zero_counts, read_counts, dirs: int = 16, files: int = 64,
             bigs: int = 8, creates: int = 10_000, ranges: int = 256, hot_files: int = 64,
             clients: int = 4) -> dict:
    """Phase 10: FsCluster(root, device) at the reference's default layout
    (3 raft nodes with the master, metanode and authnode groups, 4 datanodes
    x 2 disks, 9 blobnodes x 2 disks), a cold and a hot volume, through
    FsClient. Every step runs with the launch counts set to 0 just before it
    and read just after. Returns the `fs` line's fields."""
    from chubaofs_tpu_torch.blobstore.blobnode import NoSuchShard
    from chubaofs_tpu_torch.blobstore.clustermgr import DISK_BROKEN
    from chubaofs_tpu_torch.deploy import FsCluster
    from chubaofs_tpu_torch.raft.server import run_until
    from chubaofs_tpu_torch.utils.exporter import registry

    steps, launches, out = {}, {}, {}
    rng, tree = fs_tree(dirs, files, bigs)
    paths = sorted(tree)
    cold_bytes = sum(len(c) for chunks in tree.values() for c in chunks)

    def step(name, fn):
        zero_counts()
        t0 = time.perf_counter()
        res = fn()
        launches[name] = read_counts()
        steps[name] = time.perf_counter() - t0
        check(launches[name]["gf_matmul_pipe"] == launches[name]["gf_matmul_pipe_static"] == 0,
              f"10 {name}: B2 launched without CFS_GF_PIPELINED: {launches[name]}")
        return res

    t0 = time.perf_counter()
    c = FsCluster(root, device=device)
    c.create_volume("cold")
    c.create_volume("hot", cold=False)
    cold = [c.client("cold") for _ in range(clients)]
    steps["boot"] = time.perf_counter() - t0
    try:
        # 10a: cold write, `clients` threads, then the namespace-scale creates
        def write(i, path):
            fs = cold[i]
            fs.create(path)
            for chunk in tree[path]:
                fs.append_file(path, chunk)

        def cold_write():
            for d in sorted({p.rsplit("/", 1)[0] for p in paths}):
                cold[0].mkdirs(d)
            run_clients(write, paths, clients, "write")
            t1 = time.perf_counter()
            cold[0].mkdirs("/many")
            run_clients(lambda i, n: cold[i].create(f"/many/e{n:05d}"), list(range(creates)),
                        clients, "create")
            out["creates_s"] = time.perf_counter() - t1

        step("10a_cold_write", cold_write)
        fs = cold[0]
        check(len(fs.readdir("/many")) == creates, "creates: readdir count")
        for path in paths:
            st = fs.stat(path)
            check(st["size"] == sum(len(c) for c in tree[path]) and st["nlink"] == 1,
                  f"{path}: stat {st}")
        blobs = fs_blobs(fs, tree, paths)
        out["blobs"] = len(blobs)

        # 10b: cold read, whole and ranged, and every stored stripe
        picks = []
        for _ in range(ranges):
            path = paths[int(rng.integers(len(paths)))]
            size = sum(len(c) for c in tree[path])
            off = int(rng.integers(size))
            picks.append((path, off, int(rng.integers(1, min(MiB, size - off) + 1))))

        def cold_read():
            read_tree(lambda i: cold[i], tree, paths, clients)
            out["read_whole_s"] = time.perf_counter() - t_read
            for path, off, ln in picks:
                check(fs.read_file(path, off, ln) == b"".join(tree[path])[off:off + ln],
                      f"ranged read {path} [{off}, +{ln})")

        t_read = time.perf_counter()
        step("10b_cold_read", cold_read)
        t1 = time.perf_counter()
        check_fs_stripes(c, blobs, "stored", clients)
        out["stripe_check_s"] = time.perf_counter() - t1

        # 10c: two blobnode disks lose everything; degraded reads, then the
        # background ticks rebuild every lost shard
        bs = c.blobstore
        big = fs_blobs(fs, tree, ["/big/b0"])[0][1]  # an EC(12,4) blob: 16 units
        units = bs.cm.get_volume(big.vid).units
        victims = {units[0].disk_id, units[13].disk_id}
        lost = {}
        for _, blob, _ in blobs:
            for idx, u in enumerate(bs.cm.get_volume(blob.vid).units):
                if u.disk_id in victims:
                    lost[(blob.vid, blob.bid, idx)] = bs.nodes[u.node_id].get_shard(u.vuid, blob.bid)
                    bs.nodes[u.node_id].lose_shard(u.vuid, blob.bid)
        for d in victims:
            bs.cm.set_disk_status(d, DISK_BROKEN)
        check(lost, "the broken disks held no shard")

        def degraded_and_rebuild():
            decoded0 = registry("access").counter("read_bytes", {"kind": "decoded"}).value
            t1 = time.perf_counter()
            read_tree(lambda i: cold[i], tree, paths, clients)
            out["degraded_read_s"] = time.perf_counter() - t1
            out["degraded_decoded_bytes"] = \
                registry("access").counter("read_bytes", {"kind": "decoded"}).value - decoded0
            check(out["degraded_decoded_bytes"] > 0, "degraded reads decoded nothing")
            t1 = time.perf_counter()
            pending, ticks = dict(lost), 0
            while pending and time.perf_counter() - t1 < FS_REPAIR_DEADLINE_S:
                c.tick_background()
                ticks += 1
                for key in list(pending):
                    vid, bid, idx = key
                    u = bs.cm.get_volume(vid).units[idx]
                    if u.disk_id in victims:
                        continue
                    try:
                        got = bs.nodes[u.node_id].get_shard(u.vuid, bid)
                    except NoSuchShard:
                        continue
                    check(got == pending.pop(key), f"rebuilt shard {key} != the one lost")
            check(not pending, f"{len(pending)} of {len(lost)} lost shards not rebuilt in "
                               f"{ticks} ticks")
            out["rebuild_s"] = time.perf_counter() - t1
            out["rebuild_ticks"] = ticks

        step("10c_degraded_and_rebuild", degraded_and_rebuild)
        out["rebuilt_shards"] = len(lost)
        hit = {(vid, bid) for vid, bid, _ in lost}
        check_fs_stripes(c, [b for b in blobs if (b[1].vid, b[1].bid) in hit], "rebuilt", clients)

        # 10d: the hot volume: replicated datanodes, no kernel
        hot = c.client("hot")
        hot_data = {f"/h{i:02d}": rng.bytes(MiB) for i in range(hot_files)}
        tails = {p: rng.bytes(256 * 1024) for p in sorted(hot_data)[:16]}
        patch = rng.bytes(64 * 1024)

        def hot_volume():
            for path, data in hot_data.items():
                hot.write_file(path, data)
            for path, tail in tails.items():
                hot.append_file(path, tail)
                hot_data[path] += tail
            # an in-place overwrite rides the partition's raft: pump its clock
            ino, done = hot.resolve("/h00"), {}

            def overwrite():
                try:
                    hot.write_at(ino, 100_000, patch)
                    done["ok"] = True
                except Exception as e:  # reported below, fails the phase
                    done["err"] = f"{type(e).__name__}: {e}"

            th = threading.Thread(target=overwrite)
            th.start()
            run_until(c.net, lambda: not th.is_alive(), max_ticks=5000)
            th.join(timeout=30)
            check(done.get("ok"), f"hot overwrite: {done.get('err')}")
            d = hot_data["/h00"]
            hot_data["/h00"] = d[:100_000] + patch + d[100_000 + len(patch):]
            for path, data in hot_data.items():
                check(hot.read_file(path) == data, f"hot read {path}")

        step("10d_hot_volume", hot_volume)
        check(launches["10d_hot_volume"]["gf_matmul"] == 0,
              f"the hot volume launched B1: {launches['10d_hot_volume']}")

        # 10e: unlink half the cold files; the freelists drain through the
        # blobstore's deletes
        gone = paths[::2]
        gone_blobs = fs_blobs(fs, tree, gone)

        def purge():
            for path in gone:
                fs.unlink(path)
            t1, ticks = time.perf_counter(), 0
            out["unlink_s"] = t1 - t_purge
            while time.perf_counter() - t1 < FS_PURGE_DEADLINE_S:
                c.tick_background()
                ticks += 1
                if not any(sm.freelist for mn in c.metanodes.values()
                           for sm in mn.partitions.values()):
                    break
            check(not any(sm.freelist for mn in c.metanodes.values()
                          for sm in mn.partitions.values()), f"freelists not drained in {ticks} ticks")
            out["purge_ticks"] = ticks

        t_purge = time.perf_counter()
        step("10e_purge", purge)
        for _, blob, _ in gone_blobs:
            for u in bs.cm.get_volume(blob.vid).units:
                try:
                    bs.nodes[u.node_id].get_shard(u.vuid, blob.bid)
                except NoSuchShard:
                    continue
                check(False, f"purged blob {blob.vid}/{blob.bid} still on node {u.node_id}")
        out["purged_files"], out["purged_blobs"] = len(gone), len(gone_blobs)
    finally:
        c.close()

    # 10f: a new cluster on the same root reads the kept files back
    kept = paths[1::2]
    sample = [kept[int(i)] for i in rng.choice(len(kept), min(64, len(kept)), replace=False)]

    def restart():
        c2 = FsCluster(root, device=device)
        try:
            fs2 = c2.client("cold")
            for path in sample:
                check(fs2.read_file(path) == b"".join(tree[path]), f"read after restart {path}")
            check(len(fs2.readdir("/many")) == creates, "creates after restart")
            hot2 = c2.client("hot")
            for path in sorted(hot_data)[:8]:
                check(hot2.read_file(path) == hot_data[path], f"hot read after restart {path}")
        finally:
            c2.close()

    step("10f_restart", restart)
    out["cold_mib"] = cold_bytes / MiB
    out["cold_write_mib_s"] = cold_bytes / MiB / (steps["10a_cold_write"] - out["creates_s"])
    out["cold_read_mib_s"] = cold_bytes / MiB / out["read_whole_s"]
    out["creates_per_s"] = creates / out["creates_s"]
    return {"steps_s": steps, "launches": launches, **out}


# -- phase 11: the cluster as daemons -------------------------------------------

PROCS_FAILOVER_DEADLINE_S = 30  # 11f: a new master leader answers
PROCS_PURGE_DEADLINE_S = 60  # 11g: the metanodes' freelist drains reach the blobstore
PROCS_STOP_DEADLINE_S = 30  # 11h: every daemon exits 0 after SIGTERM


def compute_apps() -> list[str]:
    """`pid, used_memory` of every process that holds a CUDA context, as
    `nvidia-smi --query-compute-apps` reports them. In a container the pids
    are the host's (or 1), not this namespace's: device_files() attributes
    contexts to processes."""
    proc = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return [row.strip() for row in proc.stdout.strip().splitlines()]


def device_files(pid: int) -> list[str]:
    """The NVIDIA device nodes that process `pid` holds open. A CUDA context
    holds its card's node, /dev/nvidia<N>; a process that never opened the
    card holds none."""
    out = []
    try:
        fds = list(Path(f"/proc/{pid}/fd").iterdir())
    except OSError:  # exited
        return []
    for fd in fds:
        try:
            target = os.readlink(fd)
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            out.append(target)
    return sorted(set(out))


def check_contexts(readings: list[dict]) -> None:
    """Only the blobstore daemon holds a CUDA context: it holds a card's
    device node in some reading, and no other daemon holds any NVIDIA
    device node in any."""
    card = re.compile(r"^/dev/nvidia\d+$")
    check(any(card.match(f) for r in readings for f in r.get("blobstore", [])),
          f"the blobstore daemon holds no card: {readings}")
    others = {n: f for r in readings for n, f in r.items() if n != "blobstore" and f}
    check(not others, f"host roles hold NVIDIA devices: {others}")


def s3_request(addr: str, ak: str, sk: str, method: str, path: str, body: bytes = b"",
               headers: dict | None = None, raw_query: str = ""):
    """One SigV4-signed S3 request (the port's objectnode/auth.py signs);
    returns (status, headers, body)."""
    import http.client

    from chubaofs_tpu_torch.objectnode.auth import sign_v4

    hdrs = sign_v4(method, path, raw_query, {"host": addr, **(headers or {})}, ak, sk,
                   payload=body)
    conn = http.client.HTTPConnection(addr, timeout=120)
    try:
        conn.request(method, path + (f"?{raw_query}" if raw_query else ""),
                     body=body or None, headers=hdrs)
        resp = conn.getresponse()
        return resp.status, dict(resp.getheaders()), resp.read()
    finally:
        conn.close()


def cluster_pids(root: str) -> list[int]:
    """Every live process whose command line names a config under `root`."""
    pids = []
    for d in Path("/proc").iterdir():
        if not d.name.isdigit():
            continue
        try:
            cmd = (d / "cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        if any(a.startswith(root.encode()) for a in cmd):
            pids.append(int(d.name))
    return pids


def on_every_master(c, fn, what: str, timeout: float = 30.0) -> None:
    """fn(MasterClient of one master) on each master until it returns. The
    masters serve /admin/getVol and /user/akInfo from their own replica, so a
    volume or user just created may not be on a follower yet; a client that
    meets such a follower fails (the objectnode would cache the miss)."""
    from chubaofs_tpu_torch.master.api_service import MasterClient

    for i, addr in enumerate(c.master_addrs, start=1):
        if f"master{i}" in c.procs:  # a killed master answers nothing
            retry(lambda: fn(MasterClient([addr], retries=1)), f"{what} on {addr}", timeout)


def retry(fn, what: str, timeout: float = 30.0):
    """fn() until it returns, for ops that race a raft election."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return fn()
        except Exception as e:
            if time.monotonic() > deadline:
                raise AssertionError(f"{what}: {type(e).__name__}: {e}") from e
            time.sleep(0.3)


def nine_node_cluster():
    """The harness's ProcCluster with 9 blobnodes x 2 disks in its blobstore
    daemon: a blob over 1 MiB is EC(12,4), 16 units on 16 disks, which the
    harness's 6 x 2 cannot place (phases 11 and 12)."""
    from chubaofs_tpu_torch.testing.harness import ProcCluster

    class Cluster(ProcCluster):
        def blobstore_cfg(self):
            return {**super().blobstore_cfg(), "nodes": 9}

    return Cluster


def phase_procs(root: str, device=None, files: int = 512, bigs: int = 4, ranges: int = 256,
                objects: int = 64, parts: int = 4, hot_files: int = 32,
                clients: int = 4) -> dict:
    """Phase 11: the port's ProcCluster, 3 masters, 3 metanodes, 3 datanodes,
    the blobstore daemon and the objectnode as OS processes, with no device
    (None: the blobstore daemon codes on the CUDA device; every other role
    is host work). Device work is read from the blobstore daemon's /metrics
    (cfs_codec_batches_total) before and after each step, since the launch
    counters live in that process. Returns the `procs` line's fields."""
    import signal

    from chubaofs_tpu_torch.blobstore.gateway import AccessClient
    from chubaofs_tpu_torch.master.api_service import MasterClient
    from chubaofs_tpu_torch.sdk.cluster import RemoteCluster

    Cluster = nine_node_cluster()
    steps, batches, out = {}, {}, {}
    rng = np.random.default_rng(11)
    tree = {f"/d{i % 16:02d}/f{i:03d}": [rng.bytes(int(rng.integers(4 * 1024, 256 * 1024 + 1)))]
            for i in range(files)}
    for b in range(bigs):
        tree[f"/big/b{b}"] = [rng.bytes(4 * MiB) for _ in range(4)]
    paths = sorted(tree)
    cold_bytes = sum(len(c) for chunks in tree.values() for c in chunks)
    libs = kernel_libraries()

    t0 = time.perf_counter()
    c = Cluster(root, masters=3, metanodes=3, datanodes=3, blobstore=True, objectnode=True,
                device=device)
    steps["11a_boot"] = time.perf_counter() - t0
    pids = {n: p.pid for n, p in c.procs.items()}
    out["pids"] = pids
    contexts = [{n: device_files(p) for n, p in pids.items()}]
    smi_apps = [compute_apps()]

    def codec_batches() -> float:
        return scrape(c.access_addr).get("cfs_codec_batches_total", 0.0)

    def step(name, fn):
        b0 = codec_batches()
        t1 = time.perf_counter()
        res = fn()
        steps[name] = time.perf_counter() - t1
        batches[name] = codec_batches() - b0
        return res

    try:
        mc = MasterClient(c.master_addrs)
        remote = [RemoteCluster(c.master_addrs, access_addrs=[c.access_addr])
                  for _ in range(clients)]
        mc.create_volume("cold", cold=True)
        on_every_master(c, lambda m: m.get_volume("cold"), "volume cold")
        cold = [r.client("cold") for r in remote]
        fs = cold[0]
        retry(lambda: fs.mkdirs("/big"), "mkdirs on the new cold volume")

        # 11b: cold write, one client per thread
        def write(i, path):
            cold[i].create(path)
            for chunk in tree[path]:
                cold[i].append_file(path, chunk)

        def cold_write():
            for d in sorted({p.rsplit("/", 1)[0] for p in paths}):
                fs.mkdirs(d)
            run_clients(write, paths, clients, "write")

        step("11b_cold_write", cold_write)
        check(batches["11b_cold_write"] > 0, "11b: cold writes coded no batch on the card")

        # 11c: cold read, whole and ranged
        picks = []
        for _ in range(ranges):
            path = paths[int(rng.integers(len(paths)))]
            size = sum(len(c) for c in tree[path])
            off = int(rng.integers(size))
            picks.append((path, off, int(rng.integers(1, min(MiB, size - off) + 1))))

        def cold_read():
            read_tree(lambda i: cold[i], tree, paths, clients)
            out["read_whole_s"] = time.perf_counter() - t_read
            for path, off, ln in picks:
                check(fs.read_file(path, off, ln) == b"".join(tree[path])[off:off + ln],
                      f"ranged read {path} [{off}, +{ln})")

        t_read = time.perf_counter()
        step("11c_cold_read", cold_read)
        check(batches["11c_cold_read"] == 0,
              f"11c: healthy reads coded {batches['11c_cold_read']} batches")

        # 11d: S3 through the objectnode daemon, a user made by the CLI
        t_s3 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
        cli = subprocess.run(
            [sys.executable, "-m", "chubaofs_tpu_torch.cli",
             *[a for addr in c.master_addrs for a in ("--addr", addr)],
             "--json", "user", "create", "s3user"],
            cwd=str(ROOT), env=env, capture_output=True, text=True, timeout=120)
        check(cli.returncode == 0, f"cli user create: {cli.returncode} {cli.stderr[-2000:]}")
        user = json.loads(cli.stdout)
        ak, sk = user["access_key"], user["secret_key"]
        on_every_master(c, lambda m: m.user_by_ak(ak), "user s3user")
        out["s3_user_s"] = time.perf_counter() - t_s3
        s3 = c.s3_addr
        objs = {f"obj/{i:03d}": rng.bytes(int(rng.integers(1024, MiB + 1)))
                for i in range(objects)}
        part_data = [rng.bytes(8 * MiB) for _ in range(parts)]
        obj_ranges = {}
        for key, data in objs.items():
            a = int(rng.integers(len(data)))
            obj_ranges[key] = (a, int(rng.integers(a, len(data))))

        def s3_put():
            t1 = time.perf_counter()
            status, _, body = s3_request(s3, ak, sk, "PUT", "/bkt")
            check(status == 200, f"S3 create bucket: {status} {body[:300]}")
            on_every_master(c, lambda m: m.get_volume("bkt"), "bucket bkt")
            out["s3_bucket_s"] = time.perf_counter() - t1
            # the second create pays no import: the objectnode built its
            # gateway client at boot
            t1 = time.perf_counter()
            status, _, body = s3_request(s3, ak, sk, "PUT", "/bkt2")
            check(status == 200, f"S3 create second bucket: {status} {body[:300]}")
            on_every_master(c, lambda m: m.get_volume("bkt2"), "bucket bkt2")
            out["s3_bucket2_s"] = time.perf_counter() - t1

            def put(i, key):
                status, _, body = s3_request(s3, ak, sk, "PUT", f"/bkt/{key}", objs[key])
                check(status == 200, f"S3 PUT {key}: {status} {body[:200]}")

            t1 = time.perf_counter()
            run_clients(put, sorted(objs), clients, "S3 PUT")
            out["s3_put_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            status, _, body = s3_request(s3, ak, sk, "POST", "/bkt/multi", raw_query="uploads=")
            check(status == 200, f"S3 initiate multipart: {status}")
            upload = re.search(rb"<UploadId>([^<]+)</UploadId>", body).group(1).decode()
            etags = []
            for n, part in enumerate(part_data, start=1):
                status, hdrs, _ = s3_request(s3, ak, sk, "PUT", "/bkt/multi", part,
                                             raw_query=f"partNumber={n}&uploadId={upload}")
                check(status == 200, f"S3 upload part {n}: {status}")
                etags.append(hdrs["ETag"].strip('"'))
            xml = ("<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag></Part>"
                for n, e in enumerate(etags, start=1)) + "</CompleteMultipartUpload>")
            status, _, body = s3_request(s3, ak, sk, "POST", "/bkt/multi", xml.encode(),
                                         raw_query=f"uploadId={upload}")
            check(status == 200 and f"-{parts}".encode() in body,
                  f"S3 complete multipart: {status} {body[:200]}")
            out["s3_multipart_s"] = time.perf_counter() - t1

            def get(i, key):
                status, _, body = s3_request(s3, ak, sk, "GET", f"/bkt/{key}")
                check(status == 200 and body == objs[key], f"S3 GET {key}: {status}")
                a, b = obj_ranges[key]
                status, hdrs, body = s3_request(s3, ak, sk, "GET", f"/bkt/{key}",
                                                headers={"range": f"bytes={a}-{b}"})
                check(status == 206 and body == objs[key][a:b + 1]
                      and hdrs.get("Content-Range") == f"bytes {a}-{b}/{len(objs[key])}",
                      f"S3 Range GET {key}: {status}")

            t1 = time.perf_counter()
            run_clients(get, sorted(objs), clients, "S3 GET")
            out["s3_get_s"] = time.perf_counter() - t1
            whole = b"".join(part_data)
            status, _, body = s3_request(s3, ak, sk, "GET", "/bkt/multi")
            check(status == 200 and body == whole, f"S3 GET multipart: {status}")
            a = int(rng.integers(len(whole) - MiB))
            status, _, body = s3_request(s3, ak, sk, "GET", "/bkt/multi",
                                         headers={"range": f"bytes={a}-{a + MiB - 1}"})
            check(status == 206 and body == whole[a:a + MiB], f"S3 Range GET multipart: {status}")

        step("11d_s3", s3_put)
        check(batches["11d_s3"] > 0, "11d: S3 PUTs coded no batch on the card")
        contexts.append({n: device_files(p) for n, p in pids.items()})
        smi_apps.append(compute_apps())

        # 11e: a hot volume through the datanodes' chain replication
        mc.create_volume("hot", cold=False)
        on_every_master(c, lambda m: m.get_volume("hot"), "volume hot")
        hot = remote[0].client("hot")
        hot_data = {f"/h{i:02d}": rng.bytes(int(rng.integers(64 * 1024, MiB + 1)))
                    for i in range(hot_files)}

        def hot_volume():
            first = next(iter(hot_data))
            retry(lambda: hot.write_file(first, hot_data[first]), "first hot write")
            for path, data in hot_data.items():
                hot.write_file(path, data)
            for path, data in hot_data.items():
                check(hot.read_file(path) == data, f"hot read {path}")

        step("11e_hot_volume", hot_volume)
        check(batches["11e_hot_volume"] == 0,
              f"11e: the hot volume coded {batches['11e_hot_volume']} batches")

        # 11f: SIGKILL the master leader and a metanode; respawn the metanode
        # from its own config (same walDir)
        leader = mc.get_cluster()["leader_id"]
        victim = "metanode5"
        with open(os.path.join(c.root, f"{victim}.json")) as f:
            victim_cfg = json.load(f)

        def failover():
            t1 = time.perf_counter()
            c.kill(f"master{leader}")
            c.kill(victim)
            pids[f"{victim}_respawned"] = c.spawn(victim, victim_cfg).pid
            fresh = MasterClient(c.master_addrs)

            def new_leader():
                lid = fresh.get_cluster()["leader_id"]
                check(lid is not None and lid != leader, f"leader {lid}")
                return lid

            out["new_leader"] = retry(new_leader, "new master leader",
                                      timeout=PROCS_FAILOVER_DEADLINE_S)
            out["failover_s"] = time.perf_counter() - t1
            after = RemoteCluster(c.master_addrs, access_addrs=[c.access_addr]).client("cold")
            retry(lambda: after.mkdirs("/after"), "mkdirs after the failover")
            t1 = time.perf_counter()
            for n in range(100):
                after.create(f"/after/e{n:03d}")
            out["creates_after_failover_s"] = time.perf_counter() - t1
            check(len(after.readdir("/after")) == 100, "creates after the failover: readdir")
            sample = [p for p in paths if p.startswith("/big/")] + [
                paths[int(i)] for i in rng.choice(files, min(64, files), replace=False)]
            for path in sample:
                check(after.read_file(path) == b"".join(tree[path]),
                      f"read after the failover {path}")

        step("11f_failover", failover)

        # 11g: unlink half the cold files; the metanodes' freelist drains
        # delete their blobs on the blobstore daemon
        gone = paths[::2]
        locs = [ext["loc"] for path in gone
                for ext in fs.meta.get_inode(fs.resolve(path)).obj_extents]
        access = AccessClient([c.access_addr])

        def refused(loc) -> bool:
            try:
                access.get(loc)
            except Exception:
                return True
            return False

        def purge():
            for path in gone:
                fs.unlink(path)
            t1 = time.perf_counter()
            pending = list(locs)
            while pending and time.perf_counter() - t1 < PROCS_PURGE_DEADLINE_S:
                pending = [loc for loc in pending if not refused(loc)]
                if pending:
                    time.sleep(1.0)
            check(not pending, f"{len(pending)} of {len(locs)} purged blobs still served "
                               f"after {PROCS_PURGE_DEADLINE_S} s")
            out["purge_wait_s"] = time.perf_counter() - t1

        step("11g_purge", purge)
        out["purged_files"], out["purged_blobs"] = len(gone), len(locs)
        contexts.append({n: device_files(p.pid) for n, p in c.procs.items()})
        smi_apps.append(compute_apps())
        for path in paths[1::2][:16]:
            check(fs.read_file(path) == b"".join(tree[path]), f"kept file {path}")
    finally:
        # 11h: every daemon exits 0 after SIGTERM, and none is left
        t0 = time.perf_counter()
        live = dict(c.procs)
        c.close()
        steps["11h_stop"] = time.perf_counter() - t0
    codes = {n: p.poll() for n, p in live.items()}
    check(all(rc == 0 for rc in codes.values()), f"daemon exit codes after SIGTERM: {codes}")
    check(steps["11h_stop"] < PROCS_STOP_DEADLINE_S, f"stop took {steps['11h_stop']:.1f} s")
    left = cluster_pids(root)
    check(not left, f"cluster processes left after close: {left}")
    check(kernel_libraries() == libs, "a daemon rebuilt a kernel")
    check_contexts(contexts)

    s3_bytes = sum(len(d) for d in objs.values())
    range_bytes = sum(b - a + 1 for a, b in obj_ranges.values())
    out["device_files"] = contexts
    out["compute_apps"] = smi_apps
    out["cold_mib"] = cold_bytes / MiB
    out["cold_write_mib_s"] = cold_bytes / MiB / steps["11b_cold_write"]
    out["cold_read_mib_s"] = cold_bytes / MiB / out["read_whole_s"]
    out["s3_put_ops_s"] = objects / out["s3_put_s"]
    out["s3_put_mib_s"] = s3_bytes / MiB / out["s3_put_s"]
    out["s3_get_ops_s"] = 2 * objects / out["s3_get_s"]  # a whole GET + a Range GET each
    out["s3_get_mib_s"] = (s3_bytes + range_bytes) / MiB / out["s3_get_s"]
    out["s3_multipart_mib_s"] = parts * 8 / out["s3_multipart_s"]
    out["creates_per_s_after_failover"] = 100 / out["creates_after_failover_s"]
    return {"steps_s": steps, "codec_batches": batches, **out}


# -- phase 12: a cold volume through the port's client ---------------------------

CLIENT_STOP_DEADLINE_S = 30  # 12b, 12f: the client daemon unmounts and exits 0 on SIGTERM
LIBCFS_CHUNK = 4 * MiB  # 12c: one cfs_write per chunk, one EC(12,4) blob each

# 12c: the port's libcfs through its C ABI from a separate process. It loads
# libcfs.so with ctypes, appends `chunks` seeded chunks to one file of the
# cold volume, reads them back and prints the seconds of each half.
LIBCFS_RATE = r"""
import ctypes, json, sys, time
import numpy as np
lib = ctypes.CDLL(sys.argv[1])
cfg, chunks, chunk, seed = sys.argv[2], int(sys.argv[3]), int(sys.argv[4]), int(sys.argv[5])
i64 = ctypes.c_int64
lib.cfs_new_client.restype = i64
lib.cfs_new_client.argtypes = [ctypes.c_char_p]
lib.cfs_last_error.restype = ctypes.c_char_p
lib.cfs_close_client.argtypes = [i64]
lib.cfs_mkdirs.argtypes = [i64, ctypes.c_char_p, ctypes.c_int]
lib.cfs_open.argtypes = [i64, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
lib.cfs_close.argtypes = [i64, ctypes.c_int]
lib.cfs_write.restype = lib.cfs_read.restype = i64
lib.cfs_write.argtypes = [i64, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, i64]
lib.cfs_read.argtypes = [i64, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t, i64]
def need(ok, what):
    if not ok:
        sys.exit(f"{what}: {lib.cfs_last_error().decode()}")
rng = np.random.default_rng(seed)
data = [rng.bytes(chunk) for _ in range(chunks)]
cid = lib.cfs_new_client(cfg.encode())
need(cid > 0, "new_client")
need(lib.cfs_mkdirs(cid, b"/libcfs", 0o755) == 0, "mkdirs")
fd = lib.cfs_open(cid, b"/libcfs/rate.bin", 0o102, 0o644)
need(fd > 0, "open")
t0 = time.perf_counter()
for i, d in enumerate(data):
    need(lib.cfs_write(cid, fd, d, chunk, i * chunk) == chunk, f"write {i}")
write_s = time.perf_counter() - t0
buf = ctypes.create_string_buffer(chunk)
t0 = time.perf_counter()
for i, d in enumerate(data):
    need(lib.cfs_read(cid, fd, buf, chunk, i * chunk) == chunk and buf.raw == d, f"read {i}")
read_s = time.perf_counter() - t0
need(lib.cfs_close(cid, fd) == 0, "close")
lib.cfs_close_client(cid)
print(json.dumps({"bytes": chunks * chunk, "write_s": write_s, "read_s": read_s}))
"""


def mounted(path: str) -> bool:
    with open("/proc/self/mounts") as f:
        return any(line.split()[1] == path for line in f)


def fuse_state() -> str:
    """"kernel" where this process may mount FUSE, else why not."""
    from chubaofs_tpu_torch.client.fuse_ll import fuse_available

    if fuse_available():
        return "kernel"
    if not os.path.exists("/dev/fuse"):
        return "unavailable: no /dev/fuse"
    if os.geteuid() != 0:
        return "unavailable: mount(2) needs root"
    return "unavailable: /dev/fuse is not readable and writable"


def libcfs_env() -> dict:
    """The environment of a process that embeds the interpreter through
    libcfs: libpython may belong to another prefix than this interpreter's
    virtual environment, so it is handed every directory this interpreter
    imports from, with this checkout first."""
    paths = [str(ROOT)] + [p for p in sys.path if p and os.path.isdir(p)]
    return dict(os.environ, CFS_PYTHONPATH=str(ROOT), PYTHONPATH=os.pathsep.join(paths))


def client_tree(rng, files: int, bigs: int, big_mib: int) -> dict:
    """`files` files of 4 KiB-1 MiB over 16 directories under /small and
    `bigs` files of `big_mib` MiB under /big, sizes and bytes from `rng`."""
    tree = {f"/small/d{i % 16:02d}/f{i:03d}": rng.bytes(int(rng.integers(4 * 1024, MiB + 1)))
            for i in range(files)}
    for b in range(bigs):
        tree[f"/big/b{b}"] = rng.bytes(big_mib * MiB)
    return tree


def mount_steps(fs, rng) -> dict:
    """12c in process: client.mount.Mount over the cold volume: open, write,
    pread, append, truncate, and unlink while open. Returns its seconds and
    bytes."""
    from chubaofs_tpu_torch.client.mount import O_APPEND, O_CREAT, O_RDONLY, O_RDWR, O_WRONLY, Mount
    from chubaofs_tpu_torch.sdk.fs import FsError

    a, b = rng.bytes(8 * MiB), rng.bytes(3 * MiB + 17)
    m = Mount(fs, volume="cold")
    t0 = time.perf_counter()
    try:
        m.mkdir("/inproc")
        fd = m.open("/inproc/a", O_CREAT | O_RDWR)
        check(m.write(fd, a) == len(a), "Mount write")
        check(m.read(fd, MiB, offset=5 * MiB) == a[5 * MiB:6 * MiB], "Mount pread")
        m.close(fd)
        fd = m.open("/inproc/a", O_WRONLY | O_APPEND)
        check(m.write(fd, b) == len(b), "Mount append")
        m.close(fd)
        check(m.stat("/inproc/a")["size"] == len(a) + len(b), "Mount stat after append")
        fd = m.open("/inproc/a", O_RDONLY)
        check(m.read(fd, len(a) + len(b)) == a + b, "Mount read after append")
        m.close(fd)
        m.truncate("/inproc/a", 6 * MiB + 5)
        check(m.stat("/inproc/a")["size"] == 6 * MiB + 5, "Mount stat after truncate")
        fd = m.open("/inproc/a", O_RDONLY)
        m.unlink("/inproc/a")
        try:
            m.stat("/inproc/a")
            check(False, "Mount stat of an unlinked file")
        except FsError as e:
            check(e.code == "ENOENT", f"Mount stat after unlink: {e.code}")
        check(m.statfs()["orphans"] == 1, "Mount orphan while open")
        check(m.read(fd, 8 * MiB, offset=0) == a[:6 * MiB + 5], "Mount read after unlink")
        m.close(fd)
        check(m.statfs()["orphans"] == 0, "Mount orphan after the last close")
        check(m.readdir("/inproc") == [], "Mount readdir after unlink")
    finally:
        m.umount()
    return {"seconds": time.perf_counter() - t0, "bytes": len(a) + len(b)}


def phase_client(root: str, seed: int, device=None, files: int = 256, bigs: int = 4,
                 big_mib: int = 64, libcfs_chunks: int = 16, clients: int = 4) -> dict:
    """Phase 12: a cold volume of the daemon cluster through the port's
    client. Phase 11's 9-node ProcCluster (3 masters, 3 metanodes, 3
    datanodes, the blobstore daemon on `device`: None is the CUDA device)
    plus a console; the `client` role kernel-mounts the cold volume where
    FUSE is available, the in-process Mount and the port's libcfs reach the
    same volume. Device work is read from the blobstore daemon's /metrics
    (cfs_codec_batches_total) before and after each step. Returns the
    `client` line's fields."""
    import signal

    from chubaofs_tpu_torch import libsdk_boot
    from chubaofs_tpu_torch.sdk.cluster import RemoteCluster
    from chubaofs_tpu_torch.tools import cfstop
    from chubaofs_tpu_torch.tools.fsck import Fsck
    from chubaofs_tpu_torch.tools.preload import Preloader

    steps, batches, out = {}, {}, {"fuse": fuse_state()}
    rng = np.random.default_rng(seed)
    tree = client_tree(rng, files, bigs, big_mib)
    paths = sorted(tree)
    tree_bytes = sum(len(d) for d in tree.values())
    mp = os.path.join(root, "mnt")
    libs = kernel_libraries()

    t0 = time.perf_counter()
    c = nine_node_cluster()(root, masters=3, metanodes=3, datanodes=3, blobstore=True,
                            device=device)
    live = {}
    client_cfg = {"role": "client", "mountPoint": mp, "volName": "cold",
                  "masterAddrs": c.master_addrs, "accessAddrs": [c.access_addr]}

    def codec_batches() -> float:
        return scrape(c.access_addr).get("cfs_codec_batches_total", 0.0)

    def step(name, fn):
        b0 = codec_batches()
        t1 = time.perf_counter()
        res = fn()
        steps[name] = time.perf_counter() - t1
        batches[name] = codec_batches() - b0
        return res

    def mount():
        proc = c.spawn("client", client_cfg)
        live["client"] = proc
        boot = c.boot_info("client", timeout=120)
        check(boot["addr"] == mp and mounted(mp), f"client daemon did not mount {mp}: {boot}")
        return boot

    def unmount():
        proc = live.pop("client")
        c.procs.pop("client", None)
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=CLIENT_STOP_DEADLINE_S)
        check(rc == 0 and not mounted(mp), f"client daemon exit {rc}, mounted {mounted(mp)}")

    try:
        # 12a: the cluster, a console over every daemon, a cold volume
        console = c.spawn_console(metrics_addrs=[c.access_addr] + c.stats_addrs())
        remote = RemoteCluster(c.master_addrs, access_addrs=[c.access_addr])
        remote.create_volume("cold", cold=True)
        remote.create_volume("hot", cold=False)
        fs = remote.client("cold")
        retry(lambda: fs.mkdirs("/big"), "mkdirs on the new cold volume")
        steps["12a_boot"] = time.perf_counter() - t0

        # 12b: the client role kernel-mounts the volume; plain os calls
        if out["fuse"] == "kernel":
            os.makedirs(mp)
            out["client_boot"] = mount()

            def write(i, path):
                full = mp + path
                try:
                    with open(full, "wb") as f:
                        f.write(tree[path])
                        f.flush()
                        os.fsync(f.fileno())
                except OSError as e:
                    raise AssertionError(
                        f"write {path} ({len(tree[path])} B) through the mount: {e}; "
                        f"{os.stat(full).st_size} B stored; client log:\n"
                        f"{c.log_tail('client', 40)}") from e

            def mount_write():
                for d in sorted({p.rsplit("/", 1)[0] for p in paths}):
                    os.makedirs(mp + d, exist_ok=True)
                run_clients(write, paths, clients, "mount write")

            step("12b_mount_write", mount_write)
            check(batches["12b_mount_write"] > 0, "12b: writes through the mount coded no batch")
            t1 = time.perf_counter()
            unmount()  # drops the kernel's and the client's caches
            mount()
            out["remount_s"] = time.perf_counter() - t1

            def read(i, path):
                full = mp + path
                with open(full, "rb") as f:
                    check(f.read() == tree[path], f"read through the mount {path}")
                check(os.stat(full).st_size == len(tree[path]), f"stat {path}")

            def mount_read():
                run_clients(read, paths, clients, "mount read")
                for d in sorted({p.rsplit("/", 1)[0] for p in paths}):
                    want = sorted(p.rsplit("/", 1)[1] for p in paths if p.rsplit("/", 1)[0] == d)
                    check(sorted(os.listdir(mp + d)) == want, f"readdir {d}")

            step("12b_mount_read", mount_read)
            out["mount_write_mib_s"] = tree_bytes / MiB / steps["12b_mount_write"]
            out["mount_read_mib_s"] = tree_bytes / MiB / steps["12b_mount_read"]
        else:
            # no kernel mount here: the same files go in through the SDK, so
            # 12d and 12e have the same tree to read
            for d in sorted({p.rsplit("/", 1)[0] for p in paths}):
                fs.mkdirs(d)
            for path in paths:
                fs.write_file(path, tree[path])
        out["tree_mib"] = tree_bytes / MiB
        out["tree_files"] = len(paths)

        # 12c: the in-process Mount, then the port's libcfs
        res = step("12c_mount_inproc", lambda: mount_steps(fs, rng))
        out["inproc_mount_mib_s"] = res["bytes"] / MiB / res["seconds"]
        check(batches["12c_mount_inproc"] > 0, "12c: the in-process Mount coded no batch")
        t1 = time.perf_counter()
        lib_dir = libsdk_boot.build_libcfs()
        out["libcfs_build_s"] = time.perf_counter() - t1
        out["libcfs_dir"] = os.path.relpath(lib_dir, ROOT)
        env = libcfs_env()
        cold_cfg = json.dumps({"masterAddr": c.master_addrs, "volName": "cold",
                               "accessAddr": [c.access_addr]})
        hot_cfg = json.dumps({"masterAddr": c.master_addrs, "volName": "hot"})

        def run_c(args, want):
            proc = subprocess.run(args, env=env, capture_output=True, text=True, timeout=300)
            check(proc.returncode == 0 and want in proc.stdout,
                  f"{os.path.basename(args[0])}: {proc.returncode} {proc.stdout[-500:]} "
                  f"{proc.stderr[-2000:]}")
            return proc.stdout

        def libcfs():
            run_c([os.path.join(lib_dir, "cfs_smoke"), cold_cfg], "libcfs smoke ok")
            # pwrite inside a file is refused on a cold volume (append-only, as
            # in the reference), so the POSIX soak runs on the hot volume
            run_c([os.path.join(lib_dir, "cfs_posix_soak"), hot_cfg, "4", "3"],
                  "posix soak ok: 4 threads x 3 iters")
            rate = run_c([sys.executable, "-c", LIBCFS_RATE,
                          os.path.join(lib_dir, "libcfs.so"), cold_cfg,
                          str(libcfs_chunks), str(LIBCFS_CHUNK), str(seed)], "write_s")
            return json.loads(rate.strip().splitlines()[-1])

        rate = step("12c_libcfs", libcfs)
        out["libcfs_write_mib_s"] = rate["bytes"] / MiB / rate["write_s"]
        out["libcfs_read_mib_s"] = rate["bytes"] / MiB / rate["read_s"]
        check(batches["12c_libcfs"] > 0, "12c: libcfs writes coded no batch")

        # 12d: one blobnode stops answering reads; a big file reads back
        # through the client, its stripes decoded on the card. The blobstore
        # daemon restarts from its own config with that node's reads failing.
        node = 1
        blob_proc = c.procs["blobstore"]
        c.kill("blobstore", sig=signal.SIGTERM)
        check(blob_proc.returncode == 0, f"blobstore daemon exit {blob_proc.returncode}")
        env0 = c.env
        c.env = dict(env0, CFS_FAILPOINTS=f"blobnode.get_shard=error#{node}")
        try:
            c.spawn("blobstore", c.blobstore_cfg())
        finally:
            c.env = env0
        c._await_listen(c.access_addr, name="blobstore")
        victim = next(p for p in paths if p.startswith("/big/")) if bigs else paths[-1]

        def degraded_read():
            if out["fuse"] == "kernel":
                with open(mp + victim, "rb") as f:
                    got = f.read()
            else:
                got = fs.read_file(victim)
            check(got == tree[victim], f"degraded read {victim}")

        step("12d_degraded_read", degraded_read)
        out["degraded_read_file"] = victim
        out["degraded_read_mib"] = len(tree[victim]) / MiB
        check(batches["12d_degraded_read"] > 0, "12d: the degraded read decoded no batch")

        # 12e: the console, cfs-top, fsck and preload
        def tools():
            health = json.loads(urllib_get(console, "/api/health"))
            targets = {t["target"] for t in health["targets"]}
            check(not health["unreachable"] and targets == {*c.master_addrs, c.access_addr,
                                                            *c.stats_addrs()},
                  f"console rollup: {health['unreachable']} unreachable, {targets}")
            overview = json.loads(urllib_get(console, "/api/overview"))
            check("cold" in {v["name"] for v in overview["volumeList"]}, "console volumes")
            buf = io.StringIO()
            check(cfstop.main(["--console", console, "--once", "--interval", "0.5"],
                              out=buf) == 0, "cfs-top --once")
            text = buf.getvalue()
            check(all(a in text for a in c.master_addrs + [c.access_addr]), "cfs-top rows")
            out["cfstop_lines"] = len(text.splitlines())
            rep = Fsck(fs.meta).check()
            check(rep.clean, f"fsck: {rep.summary()}")
            out["fsck"] = {"inodes": rep.inode_count, "dentries": rep.dentry_count}
            small = [p for p in paths if p.startswith("/small/")]
            stats = Preloader(fs, workers=clients).run("/small")
            check(stats.errors == 0 and stats.files == len(small)
                  and stats.bytes == sum(len(tree[p]) for p in small), f"preload: {stats}")
            out["preload"] = {"files": stats.files, "bytes": stats.bytes}

        step("12e_console_and_tools", tools)
    finally:
        # 12f: unmount and stop every daemon; no mount is left behind
        t1 = time.perf_counter()
        try:
            if "client" in live:
                unmount()
        finally:
            procs = dict(c.procs)
            c.close()
            steps["12f_stop"] = time.perf_counter() - t1
            check(not mounted(mp), f"{mp} is still mounted")
    codes = {n: p.poll() for n, p in procs.items()}
    check(all(rc == 0 for rc in codes.values()), f"daemon exit codes after SIGTERM: {codes}")
    check(not cluster_pids(root), f"cluster processes left: {cluster_pids(root)}")
    check(kernel_libraries() == libs, "a daemon rebuilt a kernel")
    return {"steps_s": steps, "codec_batches": batches, **out}


# -- phase 13: the port's measuring and checking tools on the card --------------

# 13b: each device-bound bench of tools/perfbench.py at its tier-1 test's size
# and with that test's floors (tests/test_torch_perfbench.py,
# tests/test_torch_cache_plane.py), its codec on the card
BENCHES = [
    ("bench_put_pipeline", dict(blob_kb=16, n_puts=2, blob_counts=(1, 4), wire_ms=0),
     lambda o: (o["put_overlap_ratio_avg"] > 0 and o["rpc_pool_hit_rate"] > 0.5
                and all(o[k] > 0 for k in ("put_4b_pipe_pooled_mbps", "put_4b_serial_nopool_mbps",
                                           "get_4b_pipe_pooled_mbps", "put_pipeline_speedup")))),
    ("bench_repair", dict(n_nodes=6, disks_per_node=2, stripes=6, blob_kb=256, wire_ms=2.0,
                          window=4),
     lambda o: (o["repair_rows_serial"] > 0
                and o["repair_rows_pipelined"] == o["repair_rows_serial"]
                and all(o[k] > 0 for k in ("repair_stripes_s_serial", "repair_stripes_s_pipelined",
                                           "repair_speedup", "repair_overlap_ratio",
                                           "repair_bytes_per_shard")))),
    ("bench_repair_codes", dict(stripes=4, blob_kb=60, wire_ms=2.0, window=4),
     lambda o: (o["repair_codes_rows_rg"] > 0
                and o["repair_codes_rows_rs"] == o["repair_codes_rows_rg"]
                and o["repair_codes_beta_rows"] == o["repair_codes_rows_rg"]
                and o["repair_codes_reduction"] >= 0.25
                and o["repair_codes_amp_rg"] < o["repair_codes_amp_rs"]
                and all(o[k] > 0 for k in ("repair_codes_stripes_s_rg", "repair_codes_stripes_s_rs",
                                           "repair_codes_overlap_rg")))),
    ("bench_ranged", dict(blob_mb=2, range_kbs=(64,), gets_per=2),
     lambda o: (o["ranged_stripe_frac_64k"] < 0.25 and 0 < o["ranged_amp_64k"] < 2.0
                and o["ranged_amp_degraded"] > 0 and o["ranged_decoded_frac_degraded"] < 0.25
                and o["ranged_cached_hits"] > 0 and o["ranged_cached_backend_bytes"] == 0)),
    ("bench_cache_zipf", dict(objects=10, obj_kb=32, gets=50, wire_ms=1.0),
     lambda o: (o["cache_zipf_hit_ratio"] > 0.3
                and o["cache_zipf_p99_ms_cached"] < o["cache_zipf_p99_ms_ec"]
                and o["cache_zipf_speedup_p99"] > 1.0)),
]


def daemon_files(root: str) -> dict:
    """{daemon name: the NVIDIA device nodes it holds} for every live daemon
    of a ProcCluster under `root` (named by its config, <root>/<name>.json)."""
    out = {}
    for pid in cluster_pids(root):
        try:
            cmd = Path(f"/proc/{pid}/cmdline").read_bytes().split(b"\0")
        except OSError:
            continue
        cfg = next((a.decode() for a in cmd if a.startswith(root.encode())
                    and a.endswith(b".json")), None)
        if cfg:
            out[Path(cfg).stem] = device_files(pid)
    return out


def phase_tools(root: str, zero_counts, read_counts, phase2: dict) -> dict:
    """Phase 13: the port's measuring and checking tools on the card. (a)
    tools/kernel_ab.py's CLI with its tile sweep: every reading positive and
    at most the HBM bound, B1 and both B2 variants launched; (b) the
    device-bound perfbench benches on device="cuda" with their tests' floors,
    B1 launched by each; (c) cfs-capacity's clean arm through its CLI with
    no --device, the blobstore daemon on the card and no other daemon
    holding a CUDA context. Returns the `tools` line's fields."""
    import contextlib

    from chubaofs_tpu_torch.tools import capacity, kernel_ab, perfbench

    out, wall = {}, {}

    # 13a: kernel_ab
    zero_counts()
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = kernel_ab.main(["--tile-sweep"])
    counts = read_counts()
    wall["13a_kernel_ab"] = time.perf_counter() - t0
    check(rc == 0, f"kernel_ab exited {rc}")
    lines = [json.loads(x) for x in buf.getvalue().splitlines() if x.strip()]
    rows = {x["config"]: x for x in lines if "config" in x and "tile_k" not in x}
    check(set(rows) == {c[0] for c in kernel_ab.CONFIGS}, f"kernel_ab rows: {sorted(rows)}")
    for name, n, m, _, _ in kernel_ab.CONFIGS:
        for key in ("fused_gbps", "pipelined_gbps", "pipelined_static_gbps"):
            gbps = rows[name].get(key, 0)
            # each reading counts the n data rows; the card moves n + m per stripe
            check(0 < gbps * (n + m) / n <= HBM_BYTES_PER_S / 1e9,
                  f"kernel_ab {name} {key} = {gbps} GB/s outside (0, HBM bound]")
    sweep = [x for x in lines if x.get("config") == "ec12p4_tile_sweep"]
    check([x["tile_k"] for x in sweep] == kernel_ab.sweep_tiles(4, 12),
          f"kernel_ab sweep tiles: {[x['tile_k'] for x in sweep]}")
    check(all(0 < x["gbps"] * 16 / 12 <= HBM_BYTES_PER_S / 1e9 for x in sweep),
          f"kernel_ab sweep outside (0, HBM bound]: {sweep}")
    check(all(v > 0 for v in counts.values()), f"kernel_ab left a kernel unlaunched: {counts}")
    verdict = lines[-1].get("verdict", {})
    check(set(verdict) == set(rows), f"kernel_ab verdict: {lines[-1]}")
    out["kernel_ab"] = {"rows": rows, "tile_sweep": {x["tile_k"]: x["gbps"] for x in sweep},
                        "verdict": verdict, "launches": counts,
                        "phase2_ec12p4_gbps": phase2}
    log(f"kernel_ab verdict {verdict}; ec12p4 GB/s {rows['ec12p4_8mib']} "
        f"(phase 2 at the same shape: {phase2})")

    # 13b: perfbench's device-bound benches on the card
    out["perfbench"] = {}
    for name, kw, floors in BENCHES:
        zero_counts()
        t0 = time.perf_counter()
        res = getattr(perfbench, name)(os.path.join(root, name), device="cuda", **kw)
        counts = read_counts()
        wall[f"13b_{name}"] = time.perf_counter() - t0
        check(floors(res), f"{name}: a floor of its test failed: {res}")
        check(counts["gf_matmul"] > 0, f"{name} launched no gf_matmul kernel: {counts}")
        out["perfbench"][name] = {**res, "launches": counts}
        log(f"perfbench {name} " + json.dumps(out["perfbench"][name]))

    # 13c: the cfs-capacity clean arm, the blobstore daemon on the card
    cap_root = os.path.join(root, "capacity")
    report = os.path.join(root, "capacity.jsonl")
    readings, result = [], {}
    done = threading.Event()

    def sample():
        while not done.wait(1.0):
            seen = daemon_files(cap_root)
            if seen:
                readings.append(seen)

    sampler = threading.Thread(target=sample, daemon=True)
    t0 = time.perf_counter()
    sampler.start()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            result["rc"] = capacity.main(["--seed", "7", "--duration", "8", "--rate", "8",
                                          "--metanodes", "3", "--datanodes", "0",
                                          "--root", cap_root, "--out", report, "--json"])
    finally:
        done.set()
        sampler.join()
    wall["13c_capacity"] = time.perf_counter() - t0
    frames = [json.loads(x) for x in open(report)] if os.path.exists(report) else []
    summary = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(result["rc"] == 0, f"cfs-capacity clean arm exited {result['rc']}: "
          f"{json.dumps(summary)[-2000:]}")
    check(len(frames) >= 3, f"cfs-capacity archived {len(frames)} frames")
    check(readings, "no reading of the capacity cluster's daemons")
    check_contexts(readings)
    check(not cluster_pids(cap_root), f"capacity processes left: {cluster_pids(cap_root)}")
    out["capacity"] = {"rc": result["rc"], "frames": len(frames),
                       "verdict": summary.get("verdict"), "ops_ok": summary.get("ops_ok"),
                       "ops_planned": summary.get("ops_planned"),
                       "cuda_holders": sorted({n for r in readings for n, f in r.items() if f}),
                       "readings": len(readings)}
    out["wall_s"] = wall
    return out


# -- phase 14: the BASELINE bench, as a user runs it ----------------------------------

# each GB/s key of the bench's line: (data rows, rows moved) per stripe, so
# its HBM ceiling in GB/s of data is 3.35 TB/s x data / moved
BENCH_GBPS = {
    "ec4p2_encode_1mib_gbps": (4, 6),
    "ec6p3_encode_4mib_gbps": (6, 9),
    "ec12p4_encode_8mib_gbps": (12, 16),
    "ec12p4_encode_8mib_pipe_dyn_gbps": (12, 16),
    "ec12p4_encode_8mib_pipe_static_gbps": (12, 16),
    "ec12p4_reconstruct_1miss_gbps": (12, 13),
    "ec12p4_bulk_repair_3miss_gbps": (12, 15),
    "ec20p4l2_encode_16mib_gbps": (20, 26),
}
BENCH_STRIPES = "ec12p4_bulk_repair_3miss_stripes_per_sec"  # 15 shards moved a stripe
# the kernel_ab reading (phase 13a, EC(12,4) x16, k = 699,136) each bench
# EC(12,4) encode key times again, by the same method at the same shape
BENCH_VS_AB = {"ec12p4_encode_8mib_gbps": "fused_gbps",
               "ec12p4_encode_8mib_pipe_dyn_gbps": "pipelined_gbps",
               "ec12p4_encode_8mib_pipe_static_gbps": "pipelined_static_gbps"}


def phase_bench(root: str, ab_ec12: dict) -> dict:
    """Phase 14: `python -m chubaofs_tpu_torch.bench` in a child process.
    Returns the `bench` line's fields."""
    os.makedirs(root, exist_ok=True)
    env = {k: v for k, v in os.environ.items() if k != "CFS_GF_PIPELINED"}
    env["CFS_METRICS_DUMP"] = os.path.join(root, "BENCH_metrics.prom")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "chubaofs_tpu_torch.bench"], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=900)
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        log(f"bench: {line}")
    lines = [x for x in proc.stdout.splitlines() if x.strip()]
    check(proc.returncode == 0, f"the bench exited {proc.returncode}: {proc.stdout[-2000:]}")
    check(len(lines) == 1, f"the bench printed {len(lines)} lines: {proc.stdout[-2000:]}")
    res = json.loads(lines[0])
    cfg = res.get("configs", {})
    keys = list(BENCH_GBPS) + [BENCH_STRIPES]
    check(all(cfg.get(key, 0) > 0 for key in keys), f"bench keys missing or not positive: {cfg}")
    ceilings = {key: HBM_BYTES_PER_S / 1e9 * d / m for key, (d, m) in BENCH_GBPS.items()}
    k12 = -(-8 * MiB // 12 // 128) * 128
    ceilings[BENCH_STRIPES] = HBM_BYTES_PER_S / (15 * k12)
    over = {key: (cfg[key], c) for key, c in ceilings.items() if cfg[key] > c}
    check(not over, f"bench figures over their HBM ceilings: {over}")
    vs_ab = {key: cfg[key] / ab_ec12[ab] for key, ab in BENCH_VS_AB.items()}
    check(all(abs(r - 1.0) <= 0.10 for r in vs_ab.values()),
          f"bench EC(12,4) encode off kernel_ab's by more than 10%: {vs_ab}")
    check(res.get("value") == cfg["ec12p4_encode_8mib_gbps"], f"bench headline: {res}")
    check(res.get("device") == torch.cuda.get_device_name(0), f"bench device: {res.get('device')}")
    launches = res.get("launches", {})
    check(set(launches) == {"gf_matmul", "gf_matmul_pipe", "gf_matmul_pipe_static"}
          and all(v > 0 for v in launches.values()),
          f"the bench left a kernel unlaunched: {launches}")
    return {"line": res, "wall_s": wall, "ceilings": ceilings, "vs_kernel_ab": vs_ab}


def urllib_get(addr: str, path: str) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://{addr}{path}", timeout=60) as resp:
        return resp.read().decode()


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


def main(argv: list[str] | None = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="chip smoke test of chubaofs_tpu_torch")
    ap.add_argument("--seed", type=int, default=12,
                    help="seed of phase 12's file sizes and bytes")
    args = ap.parse_args(argv)
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

    def codec_counts() -> dict:
        from chubaofs_tpu_torch.utils.exporter import registry

        reg = registry("codec")
        return {"batches": reg.counter("batches_total").value,
                "jobs": reg.counter("jobs_total").value}

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
        stats0 = codec_counts()
        t0 = time.perf_counter()
        phases = phase_main_path(svc, gf256, pm, get_tactic, lrc_parity_matrix, models)
        phases["encoder_ec12p4_roundtrip"] = phase_encoder(new_encoder, CodeMode)
        counts = read_counts()
        stats = codec_counts()
    finally:
        svc.close()
    wall["3_4_codec_path"] = time.perf_counter() - t0
    batches = stats["batches"] - stats0["batches"]
    log("main_path " + json.dumps({"seconds": wall["3_4_codec_path"], "phases_s": phases,
                                   "device_batches": batches,
                                   "device_jobs": stats["jobs"] - stats0["jobs"],
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

        # phase 9: the soak harness on the card, B1
        t0 = time.perf_counter()
        soak_steps = phase_soak(os.path.join(tmp, "p9"), zero_counts, read_counts)
        wall["9_soak"] = time.perf_counter() - t0

        # phase 10: the filesystem path, B1 on the cold volume, no kernel on the hot one
        t0 = time.perf_counter()
        fs_res = phase_fs(os.path.join(tmp, "p10"), "cuda", zero_counts, read_counts)
        wall["10_fs"] = time.perf_counter() - t0
        for name in ("10a_cold_write", "10c_degraded_and_rebuild"):
            check(fs_res["launches"][name]["gf_matmul"] > 0, f"{name} launched no gf_matmul kernel")

        # phase 11: the cluster as daemons, B1 in the blobstore daemon's process
        t0 = time.perf_counter()
        procs_res = phase_procs(os.path.join(tmp, "p11"))
        wall["11_procs"] = time.perf_counter() - t0

        # phase 12: a cold volume through the port's client, B1 in the
        # blobstore daemon's process
        t0 = time.perf_counter()
        client_res = phase_client(os.path.join(tmp, "p12"), args.seed)
        wall["12_client"] = time.perf_counter() - t0

        # phase 13: the port's measuring and checking tools, B1 and B2
        t0 = time.perf_counter()
        ec12 = next(r for r in records if r["case"] == "ec12p4_parity")
        phase2 = {name: ec12["b"] * ec12["n"] * ec12["k"] / (kr["ms"] * 1e-3) / 1e9
                  for name, kr in ec12["kernels"].items()}
        tools_res = phase_tools(os.path.join(tmp, "p13"), zero_counts, read_counts, phase2)
        wall["13_tools"] = time.perf_counter() - t0

        # phase 14: the BASELINE bench as a child process, B1 and B2
        bench_res = phase_bench(os.path.join(tmp, "p14"),
                                tools_res["kernel_ab"]["rows"]["ec12p4_8mib"])
        wall["14_bench"] = bench_res["wall_s"]

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
    log("soak " + json.dumps({"seconds": wall["9_soak"], "steps": soak_steps,
                              "device": torch.cuda.get_device_name(0),
                              "nvidia_smi": nvidia_smi_line()}))
    log("fs " + json.dumps({"seconds": wall["10_fs"], **fs_res,
                            "b1_launches": {k: v["gf_matmul"] for k, v in fs_res["launches"].items()},
                            "b2_launches": sum(v["gf_matmul_pipe"] + v["gf_matmul_pipe_static"]
                                               for v in fs_res["launches"].values()),
                            "device": torch.cuda.get_device_name(0),
                            "nvidia_smi": nvidia_smi_line()}))
    log("procs " + json.dumps({"seconds": wall["11_procs"], **procs_res,
                               "device": torch.cuda.get_device_name(0),
                               "nvidia_smi": nvidia_smi_line()}))
    log("client " + json.dumps({"seconds": wall["12_client"], **client_res,
                                "device": torch.cuda.get_device_name(0),
                                "nvidia_smi": nvidia_smi_line()}))
    log("tools " + json.dumps({"seconds": wall["13_tools"], **tools_res,
                               "device": torch.cuda.get_device_name(0),
                               "nvidia_smi": nvidia_smi_line()}))
    log("bench " + json.dumps({**bench_res, "device": torch.cuda.get_device_name(0),
                               "nvidia_smi": nvidia_smi_line()}))
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
