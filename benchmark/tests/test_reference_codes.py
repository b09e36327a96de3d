"""The benchmark's plain reference against the port, on the host at tiny
sizes: the mode table, the shard rule, the policy tables and every stripe
byte the port's codec makes (device="cpu")."""

import os

import numpy as np
import pytest

from benchmark import system, traffic
from benchmark.reference import codes, gf256

MODES = sorted(codes.MODES)
CONFIGS = sorted(f[:-5] for f in os.listdir(os.path.join(os.path.dirname(traffic.__file__),
                                                           "configs")) if f.endswith(".json"))


@pytest.mark.parametrize("name", MODES)
def test_mode_table_matches_the_port(name):
    from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic

    m, t = codes.MODES[name], get_tactic(CodeMode[name])
    assert (m.code, m.N, m.M, 0, m.azs, m.put_quorum) == \
        (int(CodeMode[name]), t.N, t.M, t.L, t.az_count, t.put_quorum)
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


def test_any_n_rows_of_a_stripe_recover_the_data():
    """The reference's RS is MDS: its Cauchy generator is what it claims."""
    m = codes.MODES["EC6P6"]
    blob = np.random.default_rng(1).bytes(6 * 3000)
    s = codes.stripe(m, blob)
    gen = np.concatenate([np.eye(6, dtype=np.uint8), gf256.cauchy(6, 6)])
    for rows in ([6, 7, 8, 9, 10, 11], [0, 2, 4, 7, 9, 11], [3, 4, 5, 6, 8, 10]):
        # solve gen[rows] @ D = s[rows] by Gauss-Jordan over the field
        a = np.concatenate([gen[rows], s[rows]], axis=1).astype(np.uint8)
        mul = gf256.mul_table()
        for col in range(6):
            piv = next(r for r in range(col, 6) if a[r, col])
            a[[col, piv]] = a[[piv, col]]
            a[col] = mul[gf256.inv(int(a[col, col]))][a[col]]
            for r in range(6):
                if r != col and a[r, col]:
                    a[r] ^= mul[int(a[r, col])][a[col]]
        assert np.array_equal(a[:, 6:], s[:6])
