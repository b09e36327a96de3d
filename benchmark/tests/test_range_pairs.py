"""The range-pair cell (blob_3az.get_range_pairs): its plan on a synthetic
layout, R and the halves' medians on hand-made records, the role check,
the decoded-bytes check, and the cell's path on the host at a small size,
sound and with the faults its degraded halves can have."""

import hashlib
import json
import math
import re

import pytest

from benchmark import check, faults, layers, run, traffic
from benchmark.reference import codes
from benchmark.tests.small import rehearse, small_mix

CELL = "blob_3az.get_range_pairs"
MIX = traffic.load_mix("get_range_pairs")
STREAM = MIX["window"][0]
EC6P6 = codes.MODES["EC6P6"]


def layout(seed: int) -> dict:
    """The mix's preload sizes, stored in EC6P6 as the gateway cuts them
    (4 MiB blobs), blobs dealt to volumes 1 and 2 in turn, in key order."""
    sizes = traffic.sizes(MIX["preload"]["sizes"], MIX["preload"]["objects"], seed,
                          traffic.PRELOAD)
    locs, bid = [], 0
    for size in sizes:
        blobs = []
        for b in codes.blob_sizes(size):
            blobs.append({"vid": 1 + bid % 2, "bid": bid, "size": b})
            bid += 1
        locs.append(json.dumps({"code_mode": EC6P6.code, "size": size, "blobs": blobs}))
    return {"sizes": sizes, "locations": locs}


# volume 1 lost its data shard 2, volume 2 a parity shard (no pair there)
LOST = {1: {2}, 2: {8}}
SEEDS = (3, 2**31 + 77)


def shard_of(dataset: dict, h: traffic.Half) -> tuple[int, int, int, int]:
    """(bid, shard index, offset in the shard, real bytes of the shard) of a
    half's range, which lies inside one shard."""
    loc = json.loads(dataset["locations"][h.key])
    pos = 0
    for blob in loc["blobs"]:
        if pos <= h.offset < pos + blob["size"]:
            k = EC6P6.shard_size(blob["size"])
            idx, within = divmod(h.offset - pos, k)
            assert within + h.length <= min(k, blob["size"] - idx * k)
            return blob["bid"], idx, within, blob["vid"]
        pos += blob["size"]
    raise AssertionError(h)


def test_pair_halves_share_blob_length_and_offset_and_split_by_the_loss():
    dataset = layout(SEEDS[0])
    sched, warm = traffic.range_pairs(STREAM, dataset, LOST, SEEDS[0], 51)
    assert len(sched) == 2 * 10 * 51 and len(warm) == STREAM["warm_requests"]
    firsts = []
    for (due_a, a), (due_b, b) in zip(sched[::2], sched[1::2]):
        assert due_a == due_b and a.pair == b.pair and {a.role, b.role} == {"degraded", "healthy"}
        assert a.key == b.key and a.length == b.length
        (bid_a, i_a, u_a, vid), (bid_b, i_b, u_b, _) = shard_of(dataset, a), shard_of(dataset, b)
        assert bid_a == bid_b and u_a == u_b and vid == 1
        deg = a if a.role == "degraded" else b
        assert shard_of(dataset, deg)[1] == 2 and {i_a, i_b} == {2, 3}
        loc = json.loads(dataset["locations"][a.key])
        for h in (a, b):
            assert layers.reads_lost_shard(loc, h.offset, h.length, LOST) is (h.role == "degraded")
        firsts.append(a.role)
    assert firsts[::2] == ["degraded"] * 255 and firsts[1::2] == ["healthy"] * 255
    window = {(h.pair, h.role): h for _, h in sched}
    assert all(window[(h.pair, h.role)] == h for h in warm)


def test_lengths_and_fractions_are_the_mixs_and_the_seed_orders_them():
    """Another seed: the same length for each pair, the same gaps, in another
    order; lengths the other cells' ranged ones, clipped to one data shard;
    the warm-up spreads over the lengths, every codec bucket."""
    plans = [traffic.range_pairs(STREAM, layout(s), LOST, s, 51) for s in SEEDS]
    lengths = [{h.pair: h.length for _, h in sched} for sched, _ in plans]
    assert lengths[0] == lengths[1] and len(lengths[0]) == 510
    assert STREAM["range_len"] == traffic.load_mix("get_one_disk")["window"][0]["range_len"]
    shard = EC6P6.shard_size(4 << 20)
    assert min(lengths[0].values()) >= 4096 and max(lengths[0].values()) == shard
    assert 0.2 < sum(v == shard for v in lengths[0].values()) / 510 < 0.3
    dues = [[d for d, _ in sched[::2]] for sched, _ in plans]
    gaps = [sorted(round(b - a, 9) for a, b in zip(d, d[1:] + [51.0])) for d in dues]
    assert gaps[0] == gaps[1] and dues[0] != dues[1]
    assert [h.pair for _, h in plans[0][0]] != [h.pair for _, h in plans[1][0]]
    warm_lengths = sorted(h.length for h in plans[0][1])
    assert warm_lengths[0] < 16 << 10 and warm_lengths[-1] > 256 << 10


@pytest.mark.parametrize("lost,want", [
    ({1: {2}}, [(2, 3)]),
    ({1: {5}}, [(5, 0)]),  # the next healthy data shard wraps
    ({1: {2, 3}}, [(2, 4), (3, 4)]),  # past another lost shard
    ({1: {6}}, []),  # a parity shard: no pair
])
def test_pair_blobs_take_the_next_healthy_data_shard(lost, want):
    k = EC6P6.shard_size(4 << 20)
    loc = json.dumps({"code_mode": EC6P6.code, "size": 4 << 20,
                      "blobs": [{"vid": 1, "bid": 0, "size": 4 << 20}]})
    got = traffic.pair_blobs({"sizes": [4 << 20], "locations": [loc]}, lost)
    real = [k] * 5 + [(4 << 20) - 5 * k]  # the last data shard holds 2 B less
    assert [(0, i * k, j * k, min(real[i], real[j])) for i, j in want] == got


def test_lengths_clip_to_the_largest_shard_a_pair_reads():
    """Only a 60,000 B blob lost a data shard: every length is clipped to
    its shards' 10,000 B, and the lengths under it stay as drawn."""
    loc = json.dumps({"code_mode": EC6P6.code, "size": 60000,
                      "blobs": [{"vid": 1, "bid": 0, "size": 60000}]})
    sched, _ = traffic.range_pairs(STREAM, {"sizes": [60000], "locations": [loc]}, LOST, 1, 51)
    got = sorted(h.length for _, h in sched[::2])
    drawn = sorted(round(x) for x in traffic.quantiles(STREAM["range_len"], 510))
    assert got == [min(x, 10000) for x in drawn] and got[-1] == 10000
    assert all(h.offset % 10000 + h.length <= 10000 for _, h in sched)


def test_a_loss_of_no_data_shard_has_no_pairs():
    with pytest.raises(ValueError, match="no blob lost a data shard"):
        traffic.range_pairs(STREAM, layout(1), {2: {8}}, 1, 51)


@pytest.mark.parametrize("seed,want", [
    (1, "26a0bb641482111e3d4b05d78f08c3087f19bc4c40a16cc0c2b655488efe8d5c"),
    (2**31 + 5, "32008af875deb53ddb84a6d9b0a0a118670f01940e546c4717fb5ca65e93af3e"),
])
def test_pair_plan_digest(seed, want):
    """The plan for a fixed seed and loss, digested: what the generator
    makes for this cell since it began."""
    plan = traffic.range_pairs(STREAM, layout(seed), LOST, seed, 51)
    assert hashlib.sha256(repr(plan).encode()).hexdigest() == want


@pytest.mark.parametrize("mix", ["get_degraded", "get_one_disk", "get_az_out"])
def test_other_mixes_reach_the_client_unchanged(mix):
    """pair_plan adds a plan to range_pairs streams alone: the other cells'
    window clients get their mix as it is."""
    m = traffic.load_mix(mix)
    assert run.pair_plan(m, None, {}, 1, 51) == m


def half(pair, role, lat_ms, status=206):
    return {"op": "get", "key": 0, "offset": 0, "length": 4096, "pair": pair, "role": role,
            "due": 10.0 + pair, "done": 10.0 + pair + lat_ms / 1e3, "status": status,
            "bytes": 4096 if status == 206 else 0}


def pairs(n=layers.MIN_PAIRS, k=2.5, slow=0, failed_degraded=0, failed_healthy=0):
    """n pairs, healthy halves 4 ms, degraded k times that; the first `slow`
    pairs in a 3x slower episode (both halves); the last failed_* pairs with
    that half failed."""
    out = []
    for p in range(n):
        f = 3 if p < slow else 1
        out += [half(p, "degraded", k * 4 * f, -1 if p >= n - failed_degraded else 206),
                half(p, "healthy", 4 * f, -1 if p >= n - failed_healthy else 206)]
    return out


TENTH = layers.MIN_PAIRS // 10  # the pairs trimmed at each end
CASES = {
    # each degraded half k times its twin
    "k_times_slower": (pairs(k=2.5), 2.5),
    "k_times_slower_3": (pairs(k=3.0), 3.0),
    # half the pairs in a 3x slower episode, both halves: R cancels it
    "a_slow_episode": (pairs(slow=layers.MIN_PAIRS // 2), 2.5),
    # failed halves within the trimmed tenth: they fall into the tails
    "failed_degraded_within_the_trim": (pairs(failed_degraded=TENTH), 2.5),
    "failed_healthy_within_the_trim": (pairs(failed_healthy=TENTH), 2.5),
    # past it: a failed degraded half reads inf, a failed healthy half 0
    "failed_degraded_past_the_trim": (pairs(failed_degraded=TENTH + 1), math.inf),
    "failed_healthy_past_the_trim": (pairs(failed_healthy=TENTH + 1), 0.0),
    # under MIN_PAIRS it reads nothing
    "under_min_pairs": (pairs(n=layers.MIN_PAIRS - 1), None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_pair_statistics(case):
    recs, want = CASES[case]
    got = layers.get_range_lost_x(recs)
    assert got == (want if want is None or math.isinf(want) or want == 0
                   else pytest.approx(want))


def test_halves_are_paired_by_id_not_by_order():
    recs = pairs(k=2.0)
    assert layers.pair_latencies(recs[::-1]) == layers.pair_latencies(recs)
    assert layers.pair_latencies(recs[1:])[0] == pytest.approx((0.008, 0.004))


def test_r_is_per_layer():
    """R rises when a change speeds up what both halves share, so it is no
    end-to-end metric: the harness's own line holds get_MiBps alone."""
    assert "get_range_lost_x" not in run.end_to_end(pairs(), 0.0, 51.0, 20.0)


@pytest.mark.parametrize("name,want", [
    ("get_range_lost_x", 2.5),
    ("client.range_degraded_p50_ms", 10.0),
    ("client.range_healthy_p50_ms", 4.0),
])
def test_pair_readers(name, want):
    assert run.load_reader(name)({"records": pairs()}) == pytest.approx(want)
    assert run.load_reader(name)({"records": pairs(n=layers.MIN_PAIRS - 1)}) is None


@pytest.mark.parametrize("decoded,ok", [
    (10 * 4096, True),
    (10 * 4096 + 1, False),  # a byte decoded that no degraded half asked for
    (10 * 4096 - 4096, False),  # a half served without its decode
    (0, False),
])
def test_decoded_bytes_are_the_degraded_halves(decoded, ok):
    recs = pairs(n=10)
    want = check.degraded_halves_bytes(recs)
    checks = check.verdict(None, None, 2.0, 0, decoded, want)
    assert want == 10 * 4096 and checks["decoded_B"] == {"value": decoded, "min": want,
                                                         "max": want}
    assert check.passed(checks) is ok


def test_a_mix_without_pairs_has_no_decoded_bytes_check():
    recs = [{**r, "pair": None, "role": None} for r in pairs(n=10)]
    assert check.degraded_halves_bytes(recs) is None
    assert "decoded_B" not in check.verdict(None, None, 2.0, 0, 7, None)


def test_a_half_whose_role_the_layout_denies_is_refused():
    """A half marked degraded that reads a healthy shard: a RunError."""
    loc = json.dumps({"code_mode": EC6P6.code, "size": 6000,
                      "blobs": [{"vid": 1, "bid": 7, "size": 6000}]})
    dataset = {"sizes": [6000], "locations": [loc]}
    ok = [{**half(0, "degraded", 8), "offset": 4096, "length": 1000},
          {**half(0, "healthy", 4), "offset": 0, "length": 1000}]
    run.classify(ok, dataset, {1: {2}})
    with pytest.raises(run.RunError, match="role"):
        run.classify([{**r, "role": "degraded"} for r in ok], dataset, {1: {2}})


def pair_mix() -> dict:
    """The cell's small mix, at four times its rate and with ranges up to
    128 KiB, so that a 1.5 s window decodes more than the 1 MiB `correct`
    asks of a degraded mix."""
    mix = small_mix(CELL)
    mix["window"][0].update(rate_per_s=40)
    mix["window"][0]["range_len"]["max"] = 128 << 10
    return mix


@pytest.mark.parametrize("fault", [None, "decode_delayed", "decode_delayed_1ms"])
def test_sound_run_is_correct_and_decodes_the_degraded_halves(fault, capsys):
    """Correct, every half classed by its role (else a RunError), and the
    gateway's decoded bytes over the window those of the degraded halves, a
    check of `correct`; the decode delays leave it correct."""
    line = rehearse(CELL, fault=fault and faults.FAULTS[fault], mix=pair_mix())
    err = capsys.readouterr().err
    assert line["correct"], line["checks"]
    assert line["attempted"] == 2 * 60 and line["failed"] == 0
    halves = re.search(r"range pairs: 60 \(0 with a failed half\), degraded halves (\d+) B", err)
    decoded = line["checks"]["decoded_B"]
    assert halves and decoded["value"] == decoded["min"] == decoded["max"] == int(halves.group(1))


@pytest.mark.parametrize("fault", ["decode_skipped", "answer_altered", "full_stripe_decode"])
def test_planted_fault_is_not_correct(fault):
    line = rehearse(CELL, fault=faults.FAULTS[fault], mix=pair_mix())
    assert not line["correct"], line["checks"]
    if fault == "full_stripe_decode":
        # every answer right, but the halves' windows were not what decoded
        assert line["checks"]["get_wrong"]["value"] == 0
        assert line["checks"]["decoded_B"]["value"] > line["checks"]["decoded_B"]["max"]
