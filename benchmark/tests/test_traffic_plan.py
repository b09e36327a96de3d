"""The traffic plans, the cells' files and the refusal without a card, on
the host."""

import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from benchmark import run, traffic

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in SPEC["workloads"]]
PUT = {"rate_per_s": 24, "senders": 1,
       "sizes": {"dist": "log_uniform", "min": 65536, "max": 16777216}}
GET = {"rate_per_s": 20, "warm_requests": 64,
       "range_len": {"dist": "log_uniform", "min": 4096, "max": 4194304}}


def test_same_seed_same_schedule_sizes_keys_and_ranges():
    big = 2**31 + 99
    assert traffic.put_schedule(PUT, big, 20) == traffic.put_schedule(PUT, big, 20)
    data = traffic.sizes(PUT["sizes"], 64, big, traffic.PRELOAD)
    assert data == traffic.sizes(PUT["sizes"], 64, big, traffic.PRELOAD)
    assert traffic.get_schedule(GET, data, big, 20) == traffic.get_schedule(GET, data, big, 20)
    assert traffic.warm_gets(GET, data, big) == traffic.warm_gets(GET, data, big)
    assert np.array_equal(traffic.payload(big, 1, 5, 1000), traffic.payload(big, 1, 5, 1000))
    assert traffic.put_schedule(PUT, big, 20) != traffic.put_schedule(PUT, big + 1, 20)


def test_seeds_share_the_set_of_work():
    """Another seed: another order and other bytes, the same sizes, gaps and
    (object size, offset, length) triples."""
    a, b = traffic.put_schedule(PUT, 1, 20), traffic.put_schedule(PUT, 2, 20)
    assert sorted(p.size for p in a) == sorted(p.size for p in b)
    gaps = lambda due, end: sorted(np.round(np.diff(list(due) + [end]), 9))  # noqa: E731
    assert gaps([p.due_s for p in a], 20.0) == gaps([p.due_s for p in b], 20.0)
    assert a[-1].due_s < 20.0 and a[0].due_s == 0.0
    da, db = (traffic.sizes(PUT["sizes"], 64, s, traffic.PRELOAD) for s in (1, 2))
    assert sorted(da) == sorted(db) and da != db

    def triples(seed, data, seconds):
        return sorted((data[g.key], g.offset, g.length)
                      for _, g in traffic.get_schedule(GET, data, seed, seconds))

    for seconds in (20, 51):  # blocks of 128 GETs and a part of one
        assert triples(1, da, seconds) == triples(2, db, seconds)
    ga, gb = traffic.get_schedule(GET, da, 1, 51), traffic.get_schedule(GET, db, 2, 51)
    assert len(ga) == 20 * 51 and [g for _, g in ga] != [g for _, g in gb]
    assert gaps([d for d, _ in ga], 51.0) == gaps([d for d, _ in gb], 51.0)
    assert [d for d, _ in ga] != [d for d, _ in gb] and ga[0][0] == 0.0 and ga[-1][0] < 51.0
    assert not np.array_equal(traffic.payload(1, 1, 0, 64), traffic.payload(2, 1, 0, 64))


def test_ranges_lie_inside_their_objects():
    data = traffic.sizes(PUT["sizes"], 256, 5, traffic.PRELOAD)
    block = traffic.get_block(GET, data)
    assert len(block) == 2 * len(data)
    assert sum(g.length is None for g in block) == len(data)
    for g in block:
        if g.length is not None:
            assert 0 <= g.offset and 1 <= g.length and g.offset + g.length <= data[g.key]


# What one disk of a configuration may hold in a run: every disk's shards
# sit in the host's page cache under the run's TMPDIR (`disk_media`), and
# the cells' datasets take about 60 MiB a disk. A mix's cap scales with the
# disks of the configuration it runs on (a code mode with more parity
# stores more of the same dataset on more disks), not with a flat ceiling.
DISK_BYTES = 128 << 20


@pytest.mark.parametrize("cell", CELLS)
def test_planned_shards_stay_under_the_cap(cell):
    _, spec = run.cell_spec(cell)
    cfg, mix = traffic.load_config(spec["config"]), traffic.load_mix(spec["traffic"])
    puts = [s for s in mix["window"] if s["op"] == "put"]
    warm = run.warm_put_sizes(cfg, max(s["sizes"]["max"] for s in puts)) if puts else []
    disks = cfg["nodes"] * cfg["disks_per_node"]
    for seed in (1, 2**31 + 5):
        planned = run.planned_bytes(cfg, mix, seed, SPEC["run_seconds"], warm)
        assert planned <= mix["max_stored_bytes"] <= disks * DISK_BYTES


def test_each_config_mix_and_metric_is_found_by_name():
    for c in SPEC["configs"]:
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
        cfg = traffic.load_config(c["name"])
        assert cfg["source"] == c["source"] and set(c["reduced"]) <= set(cfg["reduced"])
    for w in SPEC["workloads"]:
        mix = traffic.load_mix(w["traffic"])
        assert mix["window"] and w["config"] in {c["name"] for c in SPEC["configs"]}
    for m in SPEC["per_layer"]:
        assert callable(run.load_reader(m["name"]))


def test_refuses_without_a_card():
    """No CUDA device: exit nonzero, name the missing card, print no result
    (never a run on the host)."""
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert "CUDA" in out.stderr and out.stdout.strip() == ""


def _plan_digest(mix_name: str, seed: int) -> str:
    mix = traffic.load_mix(mix_name)
    data = traffic.sizes(mix["preload"]["sizes"], mix["preload"]["objects"], seed,
                         traffic.PRELOAD)
    stream = mix["window"][0]
    plan = (data, traffic.get_schedule(stream, data, seed, 51),
            traffic.warm_gets(stream, data, seed))
    return hashlib.sha256(repr(plan).encode()).hexdigest()


@pytest.mark.parametrize("mix", ["get_degraded", "get_one_disk"])
@pytest.mark.parametrize("seed,want", [
    (1, "5e513d567327156966e47c210ebc8187a4f19c0f1fef8fb06790cbaab88dc368"),
    (2**31 + 5, "6fcbfb05bb0bd02f9824fb5847b8eeeb09e6dd93a03633c3d8f2868266feece6"),
    (2147618304, "5db6ea7df9247cfd393d986f099760933df6684743d959dff5e66582dd078ff5"),
])
def test_get_plan_is_get_degradeds(mix, seed, want):
    """get_degraded's dataset, schedule and warm-up, digested, are what the
    generator has made since the benchmark began; get_one_disk sends the
    same, so its GETs differ from get_degraded's only in the disks lost."""
    assert _plan_digest(mix, seed) == want


def test_one_disk_sends_the_same_work_for_every_seed():
    """Another seed: other keys, order and gaps, the same 1,020
    (object size, offset, length) GETs over the same dataset sizes."""
    mix = traffic.load_mix("get_one_disk")
    stream = mix["window"][0]
    plans = []
    for seed in (3, 2**31 + 77):
        data = traffic.sizes(mix["preload"]["sizes"], mix["preload"]["objects"], seed,
                             traffic.PRELOAD)
        sched = traffic.get_schedule(stream, data, seed, SPEC["run_seconds"])
        plans.append((sorted(data), sorted((data[g.key], g.offset, g.length) for _, g in sched),
                      [d for d, _ in sched]))
    assert plans[0][:2] == plans[1][:2] and len(plans[0][1]) == 20 * 51
    assert plans[0][2] != plans[1][2]
