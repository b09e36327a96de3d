"""cfs-chaos-soak — seeded chaos soak against an in-process MiniCluster.

The acceptance harness for the chaos subsystem: for each fault plan it runs
PUT -> fault -> degraded GET -> heal -> converge and fails loudly on data
loss, unbounded tail latency, or a cluster that will not converge. With
--verify-repro each plan runs TWICE and the injection event logs must be
byte-identical — the determinism contract that makes a chaos failure
debuggable by replaying its seed.

    cfs-chaos-soak --seed 7                  # the 3 acceptance plans
    cfs-chaos-soak --plan link_drop --rounds 8 --verify-repro
    cfs-chaos-soak --kill-blobnode --seed 7  # kill-a-blobnode rebuild soak
    cfs-chaos-soak --kill-blobnode --device cpu  # codec on the host

    python -m chubaofs_tpu_torch.tools.chaos_soak --kill-blobnode --json

The clusters' codec runs on the CUDA device unless --device names another;
with no GPU and no --device the command fails before any soak starts.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ACCEPTANCE_PLANS = ["node_wedge", "link_drop", "shard_bitrot"]
ALL_PLANS = ACCEPTANCE_PLANS + ["slow_disk", "crash_restart"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="cfs-chaos-soak", description=__doc__)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--plan", action="append", choices=ALL_PLANS, default=[],
                   help="fault plan (repeatable; default: the 3 acceptance "
                        "plans)")
    p.add_argument("--rounds", type=int, default=6)
    p.add_argument("--puts-per-round", type=int, default=2)
    p.add_argument("--nodes", type=int, default=9)
    p.add_argument("--disks-per-node", type=int, default=2)
    p.add_argument("--root", default=None,
                   help="state dir (default: a fresh temp dir per plan)")
    p.add_argument("--verify-repro", action="store_true",
                   help="run each plan twice; event logs must be identical")
    p.add_argument("--kill-blobnode", action="store_true",
                   help="run the kill-a-blobnode rebuild scenario (instead "
                        "of the fault plans unless --plan is also given): "
                        "kills one node under live PUT load and FAILS if "
                        "rebuild throughput is zero, any repaired stripe "
                        "miscompares, or a WORKING task is stranded")
    p.add_argument("--meta-split", action="store_true",
                   help="run the metadata scale-out chaos soak: "
                        "crash-restart a metanode daemon mid-split and "
                        "mid-migration under live create load; fails on any "
                        "acked-file loss, a double-owned inode, an unhealed "
                        "membership, or a missing split/migrate event "
                        "timeline")
    p.add_argument("--cache", action="store_true",
                   help="run the cache-plane correctness soak: "
                        "zipfian GETs + overwrites + deletes through the "
                        "tiered read cache with failpoint-DELAYED "
                        "invalidation; fails on any stale or corrupt byte "
                        "(crc ledger) or a deleted blob still readable")
    p.add_argument("--mode", default=None,
                   help="pin every PUT of the kill scenario to one CodeMode "
                        "by name (e.g. RG6P6 to soak the beta-fetch repair "
                        "plane, EC12P4 for the RS baseline); default: the "
                        "cluster's default mode")
    p.add_argument("--hb-timeout", type=float, default=0.75,
                   help="heartbeat-silence window for the kill scenario's "
                        "dead-disk detection (seconds)")
    p.add_argument("--sanitize", action="store_true",
                   help="arm the lock-order sanitizer (CFS_LOCK_SANITIZER=1) "
                        "for the whole soak; any lock inversion observed "
                        "under fault load fails the run")
    p.add_argument("--device", default=None,
                   help="the codec device of every soak's MiniCluster "
                        "(default: the CUDA device; 'cpu' runs the codec "
                        "math on the host)")
    p.add_argument("--json", action="store_true", help="machine-readable out")
    args = p.parse_args(argv)

    import torch

    from chubaofs_tpu_torch.ops.rs import resolve_device

    # refuse before any cluster is built: a soak told (or defaulted) to use
    # the card never runs its codec on the host instead
    if (resolve_device(args.device).type == "cuda"
            and not torch.cuda.is_available()):
        raise RuntimeError(f"device {args.device!r}: no CUDA device "
                           "available; pass --device cpu to run the codec "
                           "on the host")

    if args.sanitize:
        # before run_soak builds any cluster: locks check the env when
        # CONSTRUCTED, so this must precede every component import-and-build
        os.environ["CFS_LOCK_SANITIZER"] = "1"

    from chubaofs_tpu_torch.chaos.soak import (
        SoakFailure, run_cache_soak, run_kill_soak, run_meta_split_soak,
        run_soak)

    plans = args.plan or (
        [] if (args.kill_blobnode or args.cache or args.meta_split)
        else ACCEPTANCE_PLANS)
    results = []
    ok = True
    if args.meta_split:
        root = (os.path.join(args.root, "meta-split") if args.root
                else tempfile.mkdtemp(prefix="chaos-meta-"))
        try:
            res = run_meta_split_soak(root, seed=args.seed)
        except SoakFailure as e:
            ok = False
            res = {"plan": "meta_split", "seed": args.seed, "ok": False,
                   "error": str(e),
                   "bundle": getattr(e, "bundle", None)}
        results.append(res)
    if args.cache:
        root = (os.path.join(args.root, "cache-soak") if args.root
                else tempfile.mkdtemp(prefix="chaos-cache-"))
        try:
            res = run_cache_soak(root, seed=args.seed, rounds=args.rounds,
                                 device=args.device)
        except SoakFailure as e:
            ok = False
            res = {"plan": "cache", "seed": args.seed, "ok": False,
                   "error": str(e),
                   "bundle": getattr(e, "bundle", None)}
        results.append(res)
    if args.kill_blobnode:
        root = (os.path.join(args.root, "kill-blobnode") if args.root
                else tempfile.mkdtemp(prefix="chaos-kill-"))
        try:
            res = run_kill_soak(root, seed=args.seed, n_nodes=args.nodes,
                                disks_per_node=args.disks_per_node,
                                hb_timeout=args.hb_timeout, mode=args.mode,
                                device=args.device)
        except SoakFailure as e:
            ok = False
            res = {"plan": "kill_blobnode", "seed": args.seed, "ok": False,
                   "error": str(e),
                   "bundle": getattr(e, "bundle", None)}
        results.append(res)
    for plan in plans:
        runs = 2 if args.verify_repro else 1
        logs = []
        for i in range(runs):
            if args.root:
                root = os.path.join(args.root, f"{plan}-{i}")
            else:
                root = tempfile.mkdtemp(prefix=f"chaos-{plan}-")
            try:
                res = run_soak(root, plan, seed=args.seed,
                               rounds=args.rounds,
                               puts_per_round=args.puts_per_round,
                               n_nodes=args.nodes,
                               disks_per_node=args.disks_per_node,
                               device=args.device)
            except SoakFailure as e:
                ok = False
                res = {"plan": plan, "seed": args.seed, "ok": False,
                       "error": str(e),
                       "bundle": getattr(e, "bundle", None)}
            logs.append(res.get("events"))
            results.append(res)
            if not res.get("ok"):
                break
        if args.verify_repro and len(logs) == 2 and logs[0] != logs[1]:
            ok = False
            results.append({"plan": plan, "ok": False,
                            "error": "event logs diverged across identical "
                                     "seeded runs"})
    sanitizer = None
    if args.sanitize:
        from chubaofs_tpu_torch.utils import locks

        sanitizer = locks.report()
        if sanitizer["inversions"]:
            ok = False
    if args.json:
        out = {"ok": ok, "results": results}
        if sanitizer is not None:
            out["sanitizer"] = sanitizer
        print(json.dumps(out, indent=2))
    else:
        for r in results:
            status = "OK " if r.get("ok") else "FAIL"
            if not r.get("ok"):
                extra = r.get("error", "")
            elif r.get("plan") == "meta_split":
                extra = (f"parts={r.get('partitions')} "
                         f"acked={r.get('creates_acked')} "
                         f"failed={r.get('creates_failed')} "
                         f"inodes={r.get('inodes_census')} "
                         f"moved={r.get('migrate_moved')} "
                         f"kills={[k['phase'] for k in r.get('kills', [])]}")
            elif r.get("plan") == "kill_blobnode":
                extra = ((f"mode={r['code_mode']} " if r.get("code_mode")
                          else "")
                         + f"killed={r['killed_node']} "
                         f"detect={r['detect_s']}s "
                         f"rebuilt={r['rebuilt_shards']} shards "
                         f"({r['rebuild_shards_per_s']}/s) "
                         + (f"beta={r['beta_shards']} "
                            if r.get("beta_shards") else "")
                         + f"overlap={r['repair_overlap_ratio']} "
                         f"bytes/shard={r['bytes_per_repaired_shard']}")
            else:
                extra = (f"puts={r.get('puts')} "
                         f"rejected={r.get('puts_rejected')}"
                         f" gets={r.get('gets')}"
                         f" max_get={r.get('max_get_s', 0):.2f}s")
            print(f"[{status}] plan={r['plan']} seed={r.get('seed')} {extra}")
            if r.get("bundle"):
                print(f"         incident bundle: {r['bundle']} "
                      f"(cfs-doctor inspect)")
            for ev in r.get("events") or []:
                print(f"         t={ev['t']} {ev['event']} {ev['fault']}"
                      + "".join(f" {k}={v}" for k, v in ev.items()
                                if k not in ("t", "event", "fault")))
            # the event-plane acceptance evidence: the causal timeline the
            # soak asserted on, plus the alert lifecycle it observed
            for te in r.get("timeline") or []:
                print(f"         timeline +{te['t']}s {te['type']} "
                      f"{te['entity']}"
                      + (f" trace={te['trace_id'][:12]}"
                         if te.get("trace_id") else ""))
            if "alerts_fired" in r:
                print(f"         alerts fired={r['alerts_fired']} "
                      f"still-firing={r.get('alerts_firing', [])}")
        if sanitizer is not None:
            n = len(sanitizer["inversions"])
            print(f"[{'OK ' if n == 0 else 'FAIL'}] lock-sanitizer "
                  f"inversions={n} hold_outliers="
                  f"{len(sanitizer['hold_outliers'])} "
                  f"locks={sanitizer['locks_tracked']} "
                  f"edges={sanitizer['edges']}")
            for rec in sanitizer["inversions"]:
                print(f"         {rec['first']} -> {rec['then']} at "
                      f"{rec['acquire_site']} (reverse at "
                      f"{rec['reverse_site']})")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
