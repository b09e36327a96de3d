"""The cases of tests/test_codemode.py, run against the port's
codec/codemode.py: the CodeMode/Tactic table and stripe-geometry helpers.
One more case holds the whole table against the JAX package's."""

import pytest

from chubaofs_tpu_torch.codec import codemode
from chubaofs_tpu_torch.codec.codemode import CodeMode, get_tactic


def test_all_modes_valid():
    for mode in codemode.all_modes():
        t = get_tactic(mode)
        assert t.is_valid(), mode
        assert t.total == t.N + t.M + t.L


def test_lookup_by_name_and_int():
    assert get_tactic("EC12P4") == get_tactic(CodeMode.EC12P4) == get_tactic(9)
    assert get_tactic("EC12P4").N == 12
    assert get_tactic("EC12P4").M == 4


def test_ec6p10l2_layout_matches_reference_comment():
    """The documented layout at codemode.go:119-126."""
    t = get_tactic(CodeMode.EC6P10L2)
    assert t.global_stripe() == list(range(16))
    stripes = t.local_stripes()
    assert len(stripes) == 2
    idx0, ln, lm = stripes[0]
    assert idx0 == [0, 1, 2, 6, 7, 8, 9, 10, 16]
    assert (ln, lm) == (8, 1)
    idx1, _, _ = stripes[1]
    assert idx1 == [3, 4, 5, 11, 12, 13, 14, 15, 17]


def test_az_of_shard():
    t = get_tactic(CodeMode.EC6P10L2)
    assert [t.az_of_shard(i) for i in range(18)] == [
        0, 0, 0, 1, 1, 1,            # data
        0, 0, 0, 0, 0, 1, 1, 1, 1, 1, # parity
        0, 1,                         # local
    ]


def test_shard_size():
    t = get_tactic(CodeMode.EC6P6)
    assert t.shard_size(1) == 2048  # min shard size floor
    assert t.shard_size(6 * 2048) == 2048
    assert t.shard_size(6 * 2048 + 1) == 2049
    t0 = get_tactic(CodeMode.EC6P6Align0)
    assert t0.shard_size(5) == 1
    with pytest.raises(ValueError):
        t.shard_size(0)


def test_non_lrc_has_no_local_stripes():
    assert get_tactic(CodeMode.EC12P4).local_stripes() == []


def test_tactic_table_matches_jax():
    from chubaofs_tpu.codec import codemode as j_codemode

    modes = codemode.all_modes()
    assert [(m.name, int(m)) for m in modes] == \
        [(m.name, int(m)) for m in j_codemode.all_modes()]
    for mode in modes:
        t, jt = get_tactic(mode), j_codemode.get_tactic(mode.name)
        assert (t.N, t.M, t.L, t.az_count, t.put_quorum, t.min_shard_size) == \
            (jt.N, jt.M, jt.L, jt.az_count, jt.put_quorum, jt.min_shard_size), mode
        assert t.local_stripes() == jt.local_stripes(), mode
        for size in (1, 4096, 1 << 20, 8 * (1 << 20) + 7):
            assert t.shard_size(size) == jt.shard_size(size), (mode, size)
