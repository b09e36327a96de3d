"""One run of one benchmark cell, on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The run starts the port's blobstore daemon in this process, as a user starts
it (`cmd.start_role`, role blobstore, on the CUDA device), with its cluster
under the TMPDIR it is given. The cell's traffic comes from
benchmark/client.py in a separate process over loopback HTTP: a preload
where the mix has one, the disks the mix loses (an AZ whole, disks picked
by what they hold, or both), the plan of any range pairs (from the stored
layout and what was lost), warm-up requests for every shape the window
uses, then the window. After the window the run checks
what the timed path produced against the plain reference
(benchmark/check.py) and prints one JSON line: the end-to-end metrics with
--trace 0, the per-layer ones (spans, counters, torch.profiler) with
--trace 1.

It refuses, printing no result, without a CUDA device (it never falls back
to the host), when the mix would store more than its cap, and when JAX or
the JAX package is loaded once the window has closed.
"""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import asdict  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

from benchmark import check, layers, system, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "chubaofs_tpu")
GET_OPS = ("get", "range_pairs")  # the window streams whose requests are GETs
BUCKETS = [16 << 10 << i for i in range(6)]  # the codec's shard buckets, 16 KiB .. 512 KiB


class RunError(RuntimeError):
    """The run cannot produce a result (refused, or the harness failed)."""


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def fixed_caches() -> None:
    """Every build and kernel cache at a fixed path inside the checkout (the
    port's own nvcc cache is build/kernels there already)."""
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))


def split_cpus(client_cores: int = 2) -> set[int] | None:
    """Keep `client_cores` cores for the client process and run this process
    (the daemon and every thread it starts) on the others, so the load
    generator and the system under test do not take each other's cores.
    Returns the client's cores; None (no split) on a machine with fewer than
    twice as many. Call it before the daemon starts."""
    cpus = sorted(os.sched_getaffinity(0))
    if len(cpus) < 2 * client_cores:
        return None
    os.sched_setaffinity(0, cpus[:-client_cores])
    return set(cpus[-client_cores:])


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_spec(name: str) -> tuple[dict, dict]:
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise RunError(f"no workload {name!r}; known: {sorted(cells)}")
    return bench, cells[name]


def warm_put_sizes(cfg: dict, mix_max: int) -> list[int]:
    """One object per policy band and shard bucket: the smallest and the
    largest of each band, every bucket a band's shards can fall in (a last
    blob's too), and the mix's largest object (several blobs, the pipelined
    path)."""
    from benchmark.reference import codes

    out = set()
    for p in cfg["policies"]:
        lo, hi = p.get("min_size", 1), min(p.get("max_size", mix_max), mix_max)
        if lo > mix_max:
            continue
        out.update((lo, hi))
        n = codes.MODES[p["mode"]].N
        out.update(n * b for b in BUCKETS if lo <= n * b <= min(hi, codes.MAX_BLOB_SIZE))
        if hi > codes.MAX_BLOB_SIZE:  # a last blob of any size after full ones
            out.update(codes.MAX_BLOB_SIZE + n * b for b in BUCKETS
                       if n * b < codes.MAX_BLOB_SIZE)
    out.add(mix_max)
    return sorted(out)


def planned_bytes(cfg: dict, mix: dict, seed: int, seconds: float, warm: list[int]) -> int:
    sizes = list(warm)
    if mix["preload"]:
        sizes += traffic.sizes(mix["preload"]["sizes"], mix["preload"]["objects"], seed,
                               traffic.PRELOAD)
    for s in mix["window"]:
        if s["op"] == "put":
            sizes += [p.size for p in traffic.put_schedule(s, seed, seconds)]
    return traffic.stored_bytes(cfg["policies"], sizes)


def client(job: dict, workdir: str, phase: str, cpus: set[int] | None,
           **kw) -> tuple[str, subprocess.Popen]:
    path = os.path.join(workdir, f"{phase}.json")
    out = os.path.join(workdir, f"{phase}.out.json")
    with open(path, "w") as f:
        json.dump({**job, "phase": phase, "out": out, **kw}, f)
    proc = subprocess.Popen([sys.executable, os.path.join(HERE, "client.py"), path],
                            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
    if cpus:
        os.sched_setaffinity(proc.pid, cpus)
    return out, proc


def read_line(proc: subprocess.Popen, want: str, timeout: float) -> str:
    """The client's next status line (READY / DONE), or RunError."""
    import selectors

    sel = selectors.DefaultSelector()
    sel.register(proc.stdout, selectors.EVENT_READ)
    if not sel.select(timeout):
        raise RunError(f"client: no {want} in {timeout:.0f} s")
    line = proc.stdout.readline().strip()
    if not line.startswith(want):
        raise RunError(f"client: {line!r}, not {want}")
    return line


def stop(proc: subprocess.Popen) -> None:
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)


def end_to_end(records: list[dict], t0: float, seconds: float, setup_s: float) -> dict:
    out = {"setup_s": {"value": setup_s, "unit": "s"}}
    if any(r["op"] == "get" for r in records):
        out["get_MiBps"] = {"value": layers.get_mibps(records, t0, seconds), "unit": "MiB/s"}
    return out


def host_info() -> str:
    """The host the run shares: CPU model, cores online and usable, load."""
    model = "?"
    try:
        with open("/proc/cpuinfo") as f:
            model = next((ln.split(":", 1)[1].strip() for ln in f
                          if ln.startswith("model name")), "?")
    except OSError:
        pass
    load = os.getloadavg() if hasattr(os, "getloadavg") else ()
    return (f"{model}, {os.cpu_count()} cores online, {len(os.sched_getaffinity(0))} usable, "
            f"load {' '.join(f'{x:.2f}' for x in load)}")


def host_clock() -> tuple[list[int], float]:
    """The host's CPU time counters (/proc/stat `cpu` line, in ticks) and
    this process's CPU seconds, to tell a slow run's host from its work."""
    try:
        with open("/proc/stat") as f:
            ticks = [int(x) for x in f.readline().split()[1:]]
    except OSError:
        ticks = []
    t = os.times()
    return ticks, t.user + t.system


def host_share(a: tuple, b: tuple, seconds: float) -> str:
    d = [y - x for x, y in zip(a[0], b[0])]
    total = sum(d) or 1
    part = lambda i: 100.0 * d[i] / total if len(d) > i else float("nan")  # noqa: E731
    return (f"host CPU over the window: busy {100.0 - part(3) - part(4):.1f}%, iowait "
            f"{part(4):.1f}%, steal {part(7):.1f}%; this process "
            f"{(b[1] - a[1]) / seconds:.2f} cores")


def lose(cluster, victims: list[int]) -> dict[int, set[int]]:
    """Lose the disks; returns the units lost (system.lost_units)."""
    if not victims:
        return {}
    lost = system.lose_disks(cluster, victims)
    if not lost:
        raise RunError("the lost disks held no shards")
    log(f"lost disks {victims}: {lost} shards")
    return system.lost_units(cluster, victims)


def lose_mix(cluster, mix: dict) -> dict[int, set[int]]:
    """What the mix loses: every disk of AZ `lose_az`, where it names one,
    then `lose_disks` disks of the other AZs (system.victims). Returns the
    units lost."""
    whole = []
    if mix.get("lose_az") is not None:
        whole = system.az_disks(cluster, mix["lose_az"])
        if not whole:
            raise RunError(f"the cluster has no AZ {mix['lose_az']}")
        log(f"lost AZ {mix['lose_az']}: {len(whole)} disks")
    return lose(cluster, whole + system.victims(cluster, mix["lose_disks"], exclude=whole))


def pair_plan(mix: dict, dataset: dict, lost: dict[int, set[int]], seed: int,
              seconds: float) -> dict:
    """The mix with each range_pairs stream's `plan` (traffic.range_pairs)
    beside its parameters, for the window's client."""
    window = []
    for s in mix["window"]:
        if s["op"] == "range_pairs":
            try:
                sched, warm = traffic.range_pairs(s, dataset, lost, seed, seconds)
            except ValueError as e:
                raise RunError(f"range pairs: {e}") from None
            s = {**s, "plan": {"window": [(d, asdict(h)) for d, h in sched],
                               "warm": [asdict(h) for h in warm]}}
        window.append(s)
    return {**mix, "window": window}


def classify(records: list[dict], dataset: dict, lost: dict[int, set[int]]) -> None:
    """Mark each GET with the bytes it asks for (`want`) and whether it
    reads a shard of a lost disk (`degraded`), from the stored layout, and
    log the shares and the baselines. A range pair's half whose `role` the
    layout does not bear out is a RunError."""
    gets = [r for r in records if r["op"] == "get"]
    for r in gets:
        r["want"] = dataset["sizes"][r["key"]] if r["length"] is None else r["length"]
        r["degraded"] = layers.reads_lost_shard(json.loads(dataset["locations"][r["key"]]),
                                                r["offset"], r["length"], lost)
    halves = [r for r in gets if r.get("role") is not None]
    wrong = [r for r in halves if (r["role"] == "degraded") != r["degraded"]]
    if wrong:
        raise RunError(f"{len(wrong)} range pair halves read what their role does not say: "
                       f"{wrong[:3]}")
    for kind, part in (("whole", [r for r in gets if r["length"] is None]),
                       ("ranged", [r for r in gets if r["length"] is not None])):
        log(f"{kind} GETs reading a lost shard: {sum(r['degraded'] for r in part)} of "
            f"{len(part)}")
    if halves:
        pairs = layers.pair_latencies(records)
        logs = [math.log(d / h) for d, h in pairs if max(d, h) < math.inf]
        log(f"range pairs: {len(pairs)} ({sum(max(p) == math.inf for p in pairs)} with a "
            f"failed half), degraded halves {sum(r['length'] for r in halves if r['degraded'])} "
            f"B; get_range_lost_x {layers.get_range_lost_x(records)}, p50 degraded "
            f"{layers.range_p50_ms(records, 0)} ms, healthy {layers.range_p50_ms(records, 1)} "
            f"ms, log ratio SD {statistics.stdev(logs) if len(logs) > 1 else None}")
        return
    pairs = layers.baselined(records)
    log(f"degraded GETs with a healthy baseline: {len(pairs)} "
        f"({sum(p[0] == float('inf') for p in pairs)} failed); "
        f"get_degraded_x {layers.get_degraded_x(records)}")


def load_reader(name: str):
    path = os.path.join(HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             fault=None, mix: dict | None = None, config: dict | None = None,
             client_cpus: set[int] | None = None) -> dict:
    """One run of cell `name`; returns the result line as a dict.

    `fault`, given, is called with the live daemon after the preload and
    before the window's warm-up: the controls (benchmark/control.py,
    benchmark/tests) break the timed path with it. `mix` replaces the
    cell's mix: the CPU tests run a cell's path at a size a test can hold.
    `config` replaces the cell's configuration, so that a test can run one
    that no cell names. `client_cpus` pins the client process
    (split_cpus())."""
    bench, cell = cell_spec(name)
    cfg = config or traffic.load_config(cell["config"])
    mix = mix or traffic.load_mix(cell["traffic"])
    put_streams = [s for s in mix["window"] if s["op"] == "put"]
    mix_max = max([s["sizes"]["max"] for s in put_streams] + [1])
    warm = warm_put_sizes(cfg, mix_max) if put_streams else []
    planned = planned_bytes(cfg, mix, seed, seconds, warm)
    if planned > mix["max_stored_bytes"]:
        raise RunError(f"the run would store {planned} B of shards, over the mix's cap "
                       f"{mix['max_stored_bytes']} B")
    metrics = [m for m in bench["per_layer"] if name in m.get("workloads", [name])] if trace \
        else [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]

    import torch

    from benchmark import devtrace

    log(f"host: {host_info()}")
    workdir = tempfile.mkdtemp(prefix="cfs-bench-")
    for var in ("CFS_SLOWOP_DIR", "CFS_TRACE_DIR", "CFS_FLIGHT_DIR"):
        os.environ[var] = os.path.join(workdir, var.lower())
    daemon, procs = None, []
    try:
        daemon = system.start_daemon(cfg, os.path.join(workdir, "cluster"), device)
        cluster = system.cluster_of(daemon)
        system.set_policies(cluster, cfg["policies"])
        job = {"addr": daemon.addr, "seed": seed, "mix": mix, "seconds": seconds}
        dataset = None
        if mix["preload"]:
            out, proc = client(job, workdir, "preload", client_cpus)
            procs.append(proc)
            proc.communicate(timeout=600)
            with open(out) as f:
                dataset = json.load(f)
            if proc.returncode != 0:
                raise RunError(f"preload failed: {dataset['errors'][:5]}")
        # the planes off before any loss, so that no repair task races it
        switches = cfg.get("switches_off", []) + mix["switches_off"]
        if switches:
            system.switch_off(daemon.addr, switches)
        lost = lose_mix(cluster, mix)
        if fault is not None:
            fault(daemon)
        out, proc = client(job, workdir, "window", client_cpus, dataset=dataset,
                           warm_put_sizes=warm,
                           mix=pair_plan(mix, dataset, lost, seed, seconds))
        procs.append(proc)
        read_line(proc, "READY", 600)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        dev = devtrace.DeviceTrace(os.path.join(workdir, "trace.json")) if trace else None
        spans = system.SpanRecorder() if trace else None
        if trace:
            dev.start()
            spans.__enter__()
            dev.go()
        codec0, decoded0, clock0 = system.codec_counters(), system.decoded_bytes(), host_clock()
        t_go = time.monotonic()
        proc.stdin.write("GO\n")
        proc.stdin.flush()
        read_line(proc, "DONE", seconds + 600)
        t_done = time.monotonic()
        codec1, decoded1, clock1 = system.codec_counters(), system.decoded_bytes(), host_clock()
        device_summary = None
        if trace:
            spans.__exit__(None, None, None)
            device_summary = dev.stop()
        proc.wait(timeout=60)
        with open(out) as f:
            result = json.load(f)
        memory_peak = 0
        if device == "cuda":
            torch.cuda.synchronize()
            memory_peak = torch.cuda.max_memory_allocated()
        records = result["records"]
        log(host_share(clock0, clock1, t_done - t_go))
        log(f"window: {len(records)} requests, pacer late by at most "
            f"{result['pacer_late_s'] * 1e3:.1f} ms, last answer {t_done - t_go:.2f} s after GO")
        if lost:
            classify(records, dataset, lost)

        puts = check.check_puts(cluster, cfg["policies"], seed, records) if put_streams else None
        gets = check.check_gets(records) if any(s["op"] in GET_OPS for s in mix["window"]) \
            else None
        decoded = (decoded1 - decoded0) / 2**20 if lost else None
        checks = check.verdict(puts, gets, decoded, check.warm_bad(result["warm"]),
                               int(decoded1 - decoded0), check.degraded_halves_bytes(records))
        if decoded is not None:
            served = sum(r["bytes"] for r in records if r["op"] == "get") / 2**20
            log(f"decoded {decoded:.1f} MiB ({decoded1 - decoded0:.0f} B) of {served:.1f} MiB "
                f"served")
        if puts:
            log(f"PUT: {puts['acked']} acknowledged, {puts['blobs']} blobs read back, "
                f"{puts['shards_missing']} shards missing")

        if trace:
            ctx = {"spans": spans.spans, "codec": {k: codec1[k] - codec0[k] for k in codec0},
                   "traced_s": t_done - t_go, "device": device_summary, "records": records}
            values = {}
            for m in metrics:
                v = load_reader(m["name"])(ctx)
                if v is not None:
                    values[m["name"]] = {"value": v, "unit": m["unit"]}
        else:
            values = end_to_end(records, result["t0"], seconds, result["t0"] - T_START)
            values = {m["name"]: values[m["name"]] for m in metrics if m["name"] in values}
        line = {"correct": check.passed(checks), "attempted": len(records),
                "failed": sum(1 for r in records if r["status"] not in (200, 206)),
                "metrics": values,
                "device": {"platform": "gpu" if device == "cuda" else device,
                           "kind": torch.cuda.get_device_name() if device == "cuda" else device,
                           "count": 1, "memory_peak_bytes": memory_peak}}
        if trace:
            line["device"]["busy_s"] = device_summary["busy_s"]
            line["device"]["window_s"] = device_summary["window_s"]
            line["breakdown"] = devtrace.breakdown(device_summary, spans.spans)
        line["checks"] = checks
        return line
    finally:
        for proc in procs:
            stop(proc)
        if daemon is not None:
            daemon.stop()
        shutil.rmtree(workdir, ignore_errors=True)


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    fixed_caches()
    client_cpus = split_cpus()
    try:
        _, cell = cell_spec(args.workload)
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise RunError(f"needs {cell['chips']} CUDA device(s), found "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}: "
                           "the benchmark runs on the card and never on the host")
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                        client_cpus=client_cpus)
    except RunError as e:
        log(f"run refused: {e}")
        return 2
    bad = forbidden_modules()
    if bad:
        log(f"run refused: the process loaded {bad} (JAX or the JAX package)")
        return 3
    for name, c in line["checks"].items():
        limit = " ".join(f"{op} {c[k]}" for k, op in (("min", ">="), ("max", "<=")) if k in c)
        log(f"check {name} {c['value']} {limit}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
