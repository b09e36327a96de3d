"""Benchmark: all five BASELINE.json EC configs on one CUDA card.

Headline metric: EC(12,4) 8 MiB-stripe encode, against BASELINE.json's
target of 40 GB/s (vs_baseline = value / 40). The other four configs ride
along in the same JSON line:

  * EC(4,2)  1 MiB stripe  — unit-bench config
  * EC(6,3)  4 MiB stripe  — access PUT-path streaming encode
  * EC(12,4) 8 MiB stripe  — encode + single-missing reconstruct
  * EC(12,4) 8 MiB stripe, 3 missing, bulk repair — stripes/sec (the
    scheduler's 10k-stripe migrate workload, measured as the sustained
    device rate on resident batches)
  * EC(20,4)+L2 16 MiB stripe — LRC archive config: global + per-AZ local
    parity in one composed-generator product

plus the EC(12,4) encode again on the pipelined kernel (CFS_GF_PIPELINED=1
and =static) beside the default one.

    python -m chubaofs_tpu_torch.bench [--device cuda:N]

Prints exactly ONE JSON line on stdout; diagnostics go to stderr. With no
usable card, or a host device named, that line is a staged failure line
(`error` and `probe`) and the exit code is 2: there is no host kernel to
time.

Methodology: inputs resident in device memory; SLOPE timing — time N1 and
then N2 back-to-back calls between two CUDA events and divide the time
DELTA by the call delta, so constant costs (launch queueing, the event
pair) cancel and what is left is per-call device time. Every timed call
goes through ops/rs.py::gf_matmul_dispatch: the table-lookup kernel (B1),
or the pipelined tensor-core kernel (B2) under CFS_GF_PIPELINED.
Reconstruct is measured the way blobnode repair runs it: survivors in,
repaired rows out.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Callable, NamedTuple

import numpy as np
import torch

from chubaofs_tpu_torch.ops import cuda_gf, cuda_gf_pipe, rs

TARGET_GBPS = 40.0
HEADLINE_METRIC = "ec12p4_encode_8mib_stripe"
MiB = 1 << 20

H100 = "NVIDIA H100 80GB HBM3"  # the H100 SXM, as torch.cuda.get_device_name names it
# HBM peak bytes/s per card name, from NVIDIA's data sheets
HBM_PEAK = {H100: 3.35e12}


def log(*a):
    print(*a, file=sys.stderr, flush=True)  # obslint: a CLI's diagnostics


def slope(timed, n1=10, n2=40, runs=3, passes=3, floor: float = 0.0) -> float:
    """Seconds per call from `timed(iters)`, the seconds `iters` back-to-back
    calls take: the median across `passes` passes, each the median of `runs`
    slopes (timed(n2) - timed(n1)) / (n2 - n1), so constant costs cancel.

    The median of passes is robust to load drift without the low-tail bias a
    minimum would bring (an extreme statistic would crown exactly the
    corrupted, deflated slopes the medians exist to reject). `floor` is the
    physical lower bound on seconds per call (HBM peak): a pass below it is a
    corrupted measurement (both legs raced the same stall) and is discarded;
    if nothing plausible remains this raises with the raw slopes rather than
    report an impossible number."""
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


def throughput(fn, args, n1=10, n2=40, runs=3, passes=3,
               floor: float = 0.0) -> float:
    """Seconds per call of fn(*args) on the current CUDA stream: `slope`
    over CUDA event times."""

    def timed(iters: int) -> float:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return slope(timed, n1=n1, n2=n2, runs=runs, passes=passes, floor=floor)


def hbm_peak(dev) -> float:
    """HBM peak bytes/s of `dev`: a card's name, or a device (a torch.device
    or its string), looked up by the name torch.cuda.get_device_name gives
    it. A host device or a card not in HBM_PEAK gets no plausibility gate
    (inf) rather than spurious rejections."""
    if dev in HBM_PEAK:
        return HBM_PEAK[dev]
    try:
        dev = torch.device(dev)
    except (RuntimeError, TypeError):  # a card's name not in the table
        return float("inf")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else ""
    return HBM_PEAK.get(name, float("inf"))


def hbm_floor(total_bytes_moved: int, dev=H100) -> float:
    """Physical seconds floor: moving the op's bytes at the card's HBM peak
    (by default the card the port is built for)."""
    peak = hbm_peak(dev)
    return 0.0 if peak == float("inf") else total_bytes_moved / peak


def stage_grouped(dev, host, mat_bits):
    """A device-resident batch in the codec's layout: (matrix, data on `dev`).

    host: (B, n, k) uint8, numpy or a tensor. The JAX package stacks g
    stripes per matrix row block for the TPU's matrix unit; the port's
    rs.group_stack always gives g = 1, so the matrix comes back unchanged as
    host int8 and the data as a plain contiguous (B, n, k) tensor."""
    mat_s, g = rs.group_stack(mat_bits, host.shape[0])
    b, n, k = host.shape
    return mat_s, rs.as_tensor(host, torch.device(dev)).reshape(b // g, g * n, k)


class Stage(NamedTuple):
    """One timed config, staged on the device: fn(*args) is the call the
    bench times, `mat` the bit matrix it applies, `floor` its seconds floor
    and `payload` the data bytes its GB/s counts."""

    fn: Callable
    mat: np.ndarray
    args: tuple
    floor: float
    payload: int


def shard_len(stripe_bytes: int, n: int) -> int:
    """128-aligned shard length of one stripe."""
    return -(-stripe_bytes // n // 128) * 128


def _stage(dev, mat_bits, data, bytes_moved: int, payload: int) -> Stage:
    mat_s, data = stage_grouped(dev, data, mat_bits)
    return Stage(lambda s: rs.gf_matmul_dispatch(mat_s, s), mat_s, (data,),
                 hbm_floor(bytes_moved, dev), payload)


def stage_encode(rng, dev, n, m, stripe_bytes, batch) -> Stage:
    """Parity of `batch` random (n, k) stripes."""
    k = shard_len(stripe_bytes, n)
    kernel = rs.get_kernel(n, m, dev)
    host = rng.integers(0, 256, (batch, n, k), dtype=np.uint8)
    return _stage(dev, kernel.parity_bits, host, batch * (n + m) * k, batch * n * k)


def stage_reconstruct(rng, dev, n, m, stripe_bytes, batch, missing) -> Stage:
    """The `missing` rows of `batch` stripes encoded on the device, from
    their survivors, staged contiguous. Only the survivors stay resident."""
    k = shard_len(stripe_bytes, n)
    kernel = rs.get_kernel(n, m, dev)
    mat_bits, present, _ = kernel.repair_plan(list(missing))
    data = rng.integers(0, 256, (batch, n, k), dtype=np.uint8)
    stripe = kernel.encode(data)
    del data
    survivors = stripe.index_select(-2, present.to(stripe.device))
    del stripe
    return _stage(dev, mat_bits, survivors, batch * (n + len(missing)) * k,
                  batch * n * k)


def stage_lrc_encode(rng, dev, batch, k: int | None = None) -> Stage:
    """EC(20,4)+L2 archive config: ALL parity (4 global + 2 per-AZ local) in
    one composed-generator product (encoder.lrc_parity_matrix). Geometry
    comes from the model zoo's ARCHIVE entry; `k` overrides its shard
    length."""
    from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix
    from chubaofs_tpu_torch.models import ARCHIVE

    t = ARCHIVE.tactic
    k = ARCHIVE.shard_len if k is None else k
    mat_bits = rs.bit_operand(lrc_parity_matrix(t))
    host = rng.integers(0, 256, (batch, t.N, k), dtype=np.uint8)
    return _stage(dev, mat_bits, host, batch * (t.N + t.M + t.L) * k, batch * t.N * k)


def run(st: Stage) -> float:
    """Seconds per call of a staged config."""
    return throughput(st.fn, st.args, floor=st.floor)


def bench_encode(rng, dev, n, m, stripe_bytes, batch) -> float:
    """Encode GB/s (payload basis) for one (n, m, stripe) config."""
    st = stage_encode(rng, dev, n, m, stripe_bytes, batch)
    return st.payload / run(st) / 1e9


def bench_reconstruct(rng, dev, n, m, stripe_bytes, batch, missing) -> tuple[float, float]:
    """(GB/s payload basis, stripes/sec) repairing `missing` shards per stripe,
    the blobnode-repair way: survivors in, missing rows out."""
    st = stage_reconstruct(rng, dev, n, m, stripe_bytes, batch, missing)
    per = run(st)
    return st.payload / per / 1e9, batch / per


def bench_lrc_encode(rng, dev, batch) -> float:
    """EC(20,4)+L2 16 MiB encode GB/s (payload basis)."""
    st = stage_lrc_encode(rng, dev, batch)
    return st.payload / run(st) / 1e9


# the probe child prints a marker after each phase it SURVIVES, so a failure
# names the phase it died in (import hang vs driver-init hang vs no devices)
# instead of a bare rc=2
_PROBE_SRC = (
    "import sys\n"
    "print('stage:python_up', flush=True)\n"
    "import torch\n"
    "print('stage:torch_imported', flush=True)\n"
    "n = torch.cuda.device_count() if torch.cuda.is_available() else 0\n"
    "if n < 1:\n"
    "    sys.exit('no CUDA device available')\n"
    "print('stage:cuda_ok %d %s' % (n, torch.cuda.get_device_name(0)), flush=True)\n"
)
# last marker seen -> the phase the probe died IN
_PROBE_NEXT_PHASE = {
    None: "python_spawn",
    "stage:python_up": "import_torch",
    "stage:torch_imported": "cuda_init_list_devices",
    # every stage passed yet the child still died: teardown, not an init phase
    "stage:cuda_ok": "child_teardown",
}


def _fail(error: str, probe: dict) -> None:
    """The staged failure line, then exit 2."""
    print(json.dumps({  # obslint: the result line
        "metric": HEADLINE_METRIC, "value": 0.0, "unit": "GB/s",
        "vs_baseline": 0.0, "error": error, "probe": probe}))
    sys.exit(2)


def _resolve_device(timeout_s: float = 120.0, device=None) -> torch.device:
    """The CUDA device to time on, behind a watchdog: a wedged driver can
    hang CUDA init forever, which would hang the whole bench run. The probe
    runs in a SUBPROCESS (a hung init can hold the GIL, so an in-process
    watchdog thread may never get to time out); only after it succeeds is
    CUDA initialized here. On failure the single JSON line carries a staged
    diagnosis — which probe phase died, the exact command, its timing, rc and
    stderr tail. A host `device` is refused the same way, before any work."""
    import subprocess

    if device is not None and torch.device(device).type != "cuda":
        _fail(f"device {device!r} is not a CUDA device; the bench times "
              "kernels that run only on the card",
              {"failed_in": "device_check", "device": str(device),
               "stages_reached": []})
    cmd = [sys.executable, "-c", _PROBE_SRC]
    t0 = time.monotonic()
    try:
        subprocess.run(cmd, capture_output=True, timeout=timeout_s, check=True)
    except Exception as e:  # timeout or nonzero exit: no usable card
        elapsed = time.monotonic() - t0
        stdout = (getattr(e, "stdout", b"") or b"").decode("utf-8", "replace")
        stderr = (getattr(e, "stderr", b"") or b"").decode("utf-8", "replace")
        markers = [ln.strip() for ln in stdout.splitlines()
                   if ln.startswith("stage:")]
        last = markers[-1].split(" ", 1)[0] if markers else None
        failed_in = _PROBE_NEXT_PHASE.get(last, "unknown")
        timed_out = isinstance(e, subprocess.TimeoutExpired)
        if stderr:  # the child's traceback tells a hang from a broken install
            log(stderr[-2000:])
        _fail(f"CUDA probe failed in {failed_in}: {type(e).__name__}"
              + (" (timed out)" if timed_out else ""),
              {"failed_in": failed_in, "stages_reached": markers, "cmd": cmd,
               "elapsed_s": round(elapsed, 3), "timeout_s": timeout_s,
               "timed_out": timed_out, "rc": getattr(e, "returncode", None),
               "stderr_tail": stderr[-1500:]})
    dev = rs.resolve_device(device)
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())


def nvidia_smi_line() -> str:
    """The card's name and power limit as nvidia-smi reports them."""
    import subprocess

    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return proc.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as e:
        return f"nvidia-smi failed: {type(e).__name__}: {e}"


def launches() -> dict:
    """Each kernel's launches in this process so far."""
    return {"gf_matmul": cuda_gf.LAUNCHES,
            "gf_matmul_pipe": cuda_gf_pipe.LAUNCHES["dynamic"],
            "gf_matmul_pipe_static": cuda_gf_pipe.LAUNCHES["static"]}


def main(argv=None) -> None:
    import argparse

    p = argparse.ArgumentParser(prog="cfs-bench")
    p.add_argument("--device", default=None,
                   help="the CUDA device to time on (default: the current one)")
    args = p.parse_args(argv)
    dev = _resolve_device(device=args.device)
    torch.cuda.set_device(dev)
    name = torch.cuda.get_device_name(dev)
    log(f"device={dev} {name}")
    log(f"nvidia-smi: {nvidia_smi_line()}")
    rng = np.random.default_rng(0)

    cfg: dict[str, float] = {}

    cfg["ec4p2_encode_1mib_gbps"] = round(
        bench_encode(rng, dev, 4, 2, 1 * MiB, batch=64), 3
    )
    log(f"EC(4,2) 1MiB encode: {cfg['ec4p2_encode_1mib_gbps']} GB/s")

    cfg["ec6p3_encode_4mib_gbps"] = round(
        bench_encode(rng, dev, 6, 3, 4 * MiB, batch=24), 3
    )
    log(f"EC(6,3) 4MiB encode: {cfg['ec6p3_encode_4mib_gbps']} GB/s")

    headline = bench_encode(rng, dev, 12, 4, 8 * MiB, batch=16)
    cfg["ec12p4_encode_8mib_gbps"] = round(headline, 3)
    log(f"EC(12,4) 8MiB encode: {headline:.2f} GB/s")

    # the same encode on the pipelined kernel, both slot variants, in the
    # same run. A variant that fails to build or launch ends the run: no
    # fallback and no error key may hide a kernel. The caller's setting is
    # restored whatever happens.
    prev = os.environ.get("CFS_GF_PIPELINED")
    for variant, key in (("1", "ec12p4_encode_8mib_pipe_dyn_gbps"),
                         ("static", "ec12p4_encode_8mib_pipe_static_gbps")):
        os.environ["CFS_GF_PIPELINED"] = variant
        try:
            cfg[key] = round(bench_encode(rng, dev, 12, 4, 8 * MiB, batch=16), 3)
        finally:
            if prev is None:
                os.environ.pop("CFS_GF_PIPELINED", None)
            else:
                os.environ["CFS_GF_PIPELINED"] = prev
        log(f"EC(12,4) 8MiB encode pipelined[{variant}]: {cfg[key]} GB/s "
            f"(default kernel {headline:.2f})")

    rec_gbps, _ = bench_reconstruct(rng, dev, 12, 4, 8 * MiB, batch=16, missing=[0])
    cfg["ec12p4_reconstruct_1miss_gbps"] = round(rec_gbps, 3)
    log(f"EC(12,4) reconstruct(1 missing): {rec_gbps:.2f} GB/s")

    bulk_gbps, stripes_sec = bench_reconstruct(
        rng, dev, 12, 4, 8 * MiB, batch=64, missing=[0, 5, 12]
    )
    cfg["ec12p4_bulk_repair_3miss_stripes_per_sec"] = round(stripes_sec, 1)
    cfg["ec12p4_bulk_repair_3miss_gbps"] = round(bulk_gbps, 3)
    log(
        f"EC(12,4) bulk repair (3 missing, 64-stripe device batches): "
        f"{stripes_sec:.0f} stripes/s ({bulk_gbps:.2f} GB/s)"
    )

    cfg["ec20p4l2_encode_16mib_gbps"] = round(
        bench_lrc_encode(rng, dev, batch=8), 3
    )
    log(f"EC(20,4)+L2 16MiB encode: {cfg['ec20p4l2_encode_16mib_gbps']} GB/s")

    # /metrics snapshot next to the JSON line: the bench figures as gauges
    # plus whatever role registries this process exercised
    try:
        from chubaofs_tpu_torch.utils import exporter

        breg = exporter.registry("bench")
        for k, v in cfg.items():
            breg.gauge(k).set(v)
        dump_path = os.environ.get("CFS_METRICS_DUMP", "BENCH_metrics.prom")
        exporter.dump(dump_path)
        log(f"metrics snapshot -> {dump_path}")
    except Exception as e:  # a dump failure must never kill the bench line
        log(f"metrics snapshot failed: {type(e).__name__}: {e}")

    print(  # obslint: the result line
        json.dumps(
            {
                "metric": HEADLINE_METRIC,
                "value": cfg["ec12p4_encode_8mib_gbps"],
                "unit": "GB/s",
                "vs_baseline": round(headline / TARGET_GBPS, 4),
                "configs": cfg,
                "device": name,
                "launches": launches(),
            }
        )
    )


if __name__ == "__main__":
    main()
