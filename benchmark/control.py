"""The controls of `correct`, and of a metric's sensitivity, on the card at
a cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds 7,8,9 --seconds 10 \\
        --faults parity_unwritten,answer_altered,half_batch,state_unchanged [--trace 1]

Runs the cell once per seed and fault, with the fault planted under the
timed path (benchmark/faults.py), and prints each run's compared numbers
beside their limits, and its metrics (end to end, or per layer with
--trace 1), as one JSON line; its `setup_s` counts from this process's
start, so past the first run it is not a run's set-up. Every fault's line
must read correct false. `decode_delayed`'s (3 ms before every codec
batch) and `decode_delayed_1ms`'s must read correct true, and a read-path
ratio higher than the same seed's line under `clean`, which plants
nothing: `get_degraded_x` in blob_3az.get_one_disk, `get_range_lost_x` in
blob_3az.get_range_pairs (both per layer: in the line with --trace 1, and
in each run's log on standard error either way). The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import faults, run  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--faults", required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    run.fixed_caches()
    cpus = run.split_cpus()
    for name in args.faults.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            try:
                line = run.run_cell(args.workload, seed, args.seconds, bool(args.trace),
                                    fault=None if name == "clean" else faults.FAULTS[name],
                                    client_cpus=cpus)
                out = {"correct": line["correct"], "checks": line["checks"],
                       "metrics": line["metrics"]}
            except run.RunError as e:  # a control that gives no number has failed
                out = {"correct": False, "error": str(e)}
            finally:
                faults.restore()
            print(json.dumps({"workload": args.workload, "fault": name, "seed": seed, **out}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
