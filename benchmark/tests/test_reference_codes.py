"""The benchmark's plain reference against the port, on the host at tiny
sizes: the mode table, the shard rule, the layout, the policy tables and
every stripe byte the port's codec makes (device="cpu"), local parities
included; and the reference's codes against their definition, and the PUT
check's quorum."""

import json
import os
from types import SimpleNamespace as NS

import numpy as np
import pytest

from benchmark import check, system, traffic
from benchmark.reference import codes, gf256

MODES = sorted(codes.MODES)
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(os.path.dirname(traffic.__file__),
                                                           "configs")) if f.endswith(".json"))


@pytest.mark.parametrize("name", MODES)
def test_mode_table_matches_the_port(name):
    from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic

    m, t = codes.MODES[name], get_tactic(CodeMode[name])
    assert (m.code, m.N, m.M, m.L, m.azs, m.put_quorum) == \
        (int(CodeMode[name]), t.N, t.M, t.L, t.az_count, t.put_quorum)
    assert (m.global_count, m.total) == (t.global_count, t.total)
    for az in range(m.azs):
        assert m.shards_in_az(az) == t.shards_in_az(az)
        assert all(t.az_of_shard(i) == az for i in m.shards_in_az(az))
    for size in (1, 100, 2047 * m.N, 2048 * m.N + 1, 1 << 20, codes.MAX_BLOB_SIZE):
        assert m.shard_size(size) == t.shard_size(size)


@pytest.mark.parametrize("config", CONFIGS)
def test_policy_tables_match_the_port(config):
    """The configuration's policy table, as the harness hands it to the
    gateway, picks the mode the reference picks at every size."""
    from chubaofs_tpu_torch.blobstore.access import MAX_BLOB_SIZE, select_code_mode

    cfg = traffic.load_config(config)
    assert cfg["max_blob_size"] == MAX_BLOB_SIZE == codes.MAX_BLOB_SIZE

    class Cluster:
        access = type("Access", (), {})()

    system.set_policies(Cluster, cfg["policies"])
    for size in (1, 64 << 10, 128 << 10, (128 << 10) + 1, 1 << 20, (1 << 20) + 1, 16 << 20):
        assert codes.pick_mode(cfg["policies"], size).code == \
            int(select_code_mode(size, Cluster.access.policies))


@pytest.mark.parametrize("name", MODES)
@pytest.mark.parametrize("size", [1, 5000, 100_003])
def test_stripe_matches_the_port(name, size):
    from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic
    from chubaofs_tpu_torch.codec.service import CodecService

    m, t = codes.MODES[name], get_tactic(CodeMode[name])
    blob = np.random.default_rng(size).bytes(size)
    data = np.zeros((t.N, t.shard_size(size)), np.uint8)
    data.reshape(-1)[:size] = np.frombuffer(blob, np.uint8)
    svc = CodecService(device="cpu")
    try:
        got = svc.encode_tactic(t, data).result(timeout=60)
    finally:
        svc.close()
    assert np.array_equal(got, codes.stripe(m, blob))


def test_field():
    mul = gf256.mul_table()
    assert mul[2, 128] == 0x1D  # x * x^7 = x^8 = x^4 + x^3 + x^2 + 1
    for a in range(1, 256):
        assert mul[a, gf256.inv(a)] == 1
    a, b, c = np.random.default_rng(0).integers(0, 256, (3, 64))
    assert np.array_equal(mul[a, mul[b, c]], mul[mul[a, b], c])
    assert np.array_equal(mul[a, b ^ c], mul[a, b] ^ mul[a, c])


def solve(gen: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """X with gen @ X = rows, gen square, by Gauss-Jordan over the field."""
    n = gen.shape[0]
    a = np.concatenate([gen, rows], axis=1).astype(np.uint8)
    mul = gf256.mul_table()
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r, col])
        a[[col, piv]] = a[[piv, col]]
        a[col] = mul[gf256.inv(int(a[col, col]))][a[col]]
        for r in range(n):
            if r != col and a[r, col]:
                a[r] ^= mul[int(a[r, col])][a[col]]
    return a[:, n:]


def test_any_n_rows_of_a_stripe_recover_the_data():
    """The reference's RS is MDS: its Cauchy generator is what it claims."""
    m = codes.MODES["EC6P6"]
    blob = np.random.default_rng(1).bytes(6 * 3000)
    s = codes.stripe(m, blob)
    gen = np.concatenate([np.eye(6, dtype=np.uint8), gf256.cauchy(6, 6)])
    for rows in ([6, 7, 8, 9, 10, 11], [0, 2, 4, 7, 9, 11], [3, 4, 5, 6, 8, 10]):
        assert np.array_equal(solve(gen[rows], s[rows]), s[:6])


@pytest.mark.parametrize("name", [n for n in MODES if codes.MODES[n].L])
def test_each_local_stripe_recovers_any_one_lost_shard(name):
    """In each AZ's local stripe (its global shards, then its local
    parities), any one shard lost comes back from the others, by the
    reference alone: the local parity is what it claims."""
    m = codes.MODES[name]
    s = codes.stripe(m, np.random.default_rng(2).bytes(m.N * 2500))
    local_n, local_m = m.global_count // m.azs, m.L // m.azs
    assert local_m == 1
    gen = np.concatenate([np.eye(local_n, dtype=np.uint8), gf256.cauchy(local_n, local_m)])
    for az in range(m.azs):
        stripe = s[m.shards_in_az(az)]
        for lost in range(local_n + local_m):
            rows = [r for r in range(local_n + local_m) if r != lost]
            globals_ = solve(gen[rows], stripe[rows])
            assert np.array_equal(gf256.matmul(gen[[lost]], globals_)[0], stripe[lost])


@pytest.mark.parametrize("name", MODES)
def test_put_quorum_counts_global_shards_alone(name):
    """check._check_put, on a blob stored whole, then without its local
    parities (not under quorum), then without one global shard more than
    its quorum allows (under quorum); every stored shard still right."""
    m, seed, size = codes.MODES[name], 5, 40_000
    data = traffic.payload(seed, traffic.WINDOW, 0, size).tobytes()
    want = codes.stripe(m, data)
    rec = {"idx": 0, "size": size, "loc": json.dumps(
        {"code_mode": m.code, "size": size, "blobs": [{"vid": 1, "bid": 1, "size": size}]})}

    def checked(gone: set[int]) -> dict:
        """The check over a volume whose units are the stripe's rows, with
        the rows in `gone` missing."""
        def get_shard(vuid, bid):
            if vuid in gone:
                raise KeyError(vuid)
            return want[vuid].tobytes()

        vol = NS(units=[NS(node_id=0, vuid=i) for i in range(m.total)])
        cluster = NS(nodes={0: NS(get_shard=get_shard)}, cm=NS(get_volume=lambda vid: vol))
        return check._check_put(cluster, [{"mode": name}], seed, rec)

    out = checked(set())
    assert (out["blobs"], out["shards_missing"], out["shards_wrong"], out["mode_wrong"],
            out["blobs_under_quorum"]) == (1, 0, 0, 0, 0)
    locals_ = set(range(m.global_count, m.total))
    out = checked(locals_)
    assert (out["shards_missing"], out["shards_wrong"], out["blobs_under_quorum"]) == \
        (m.L, 0, 0)
    out = checked(set(range(m.global_count - m.put_quorum)))
    assert out["blobs_under_quorum"] == 0
    out = checked(set(range(m.global_count - m.put_quorum + 1)))
    assert (out["shards_missing"], out["shards_wrong"], out["blobs_under_quorum"]) == \
        (m.global_count - m.put_quorum + 1, 0, 1)
