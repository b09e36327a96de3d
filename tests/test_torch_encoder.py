"""The cases of tests/test_encoder.py, run against the port on the CPU.

Encoder API: split/encode/verify/reconstruct/join for RS and LRC modes.
Every encoder is new_encoder(..., device="cpu"). The file's two
CodecService cases are in test_torch_codec.py, under their own names."""

import io

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.codec import CodeMode, EncoderConfig
from chubaofs_tpu_torch.codec import new_encoder as _new_encoder
from chubaofs_tpu_torch.codec.encoder import InvalidShardsError

# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


def new_encoder(cfg, **kw):
    """The port's new_encoder on the host (its default is the CUDA device)."""
    return _new_encoder(cfg, device="cpu", **kw)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def roundtrip(mode, data_len, rng, kill):
    enc = new_encoder(mode)
    t = enc.tactic
    data = rng.integers(0, 256, data_len, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    assert len(shards) == t.total
    enc.encode(shards)
    assert enc.verify(shards)

    golden = [s.copy() for s in shards]
    for i in kill:
        shards[i][:] = 0
    enc.reconstruct(shards, kill)
    for i, (got, want) in enumerate(zip(shards, golden)):
        assert np.array_equal(got, want), f"shard {i}"
    assert enc.verify(shards)

    out = io.BytesIO()
    enc.join(out, shards, data_len)
    assert out.getvalue() == data


@pytest.mark.parametrize("mode", [CodeMode.EC6P3, CodeMode.EC12P4, CodeMode.EC6P6])
def test_rs_roundtrip(rng, mode):
    roundtrip(mode, 40_000, rng, kill=[0, 2])


def test_rs_max_erasures(rng):
    roundtrip(CodeMode.EC12P4, 10_000, rng, kill=[0, 5, 12, 15])


def test_small_blob_padding(rng):
    """Blobs below MinShardSize*N pad to MinShardSize shards (codemode.go:142-158)."""
    enc = new_encoder(CodeMode.EC6P6)
    shards = enc.split(b"hello")
    assert all(len(s) == 2048 for s in shards)
    enc.encode(shards)
    out = io.BytesIO()
    enc.join(out, shards, 5)
    assert out.getvalue() == b"hello"


@pytest.mark.parametrize("mode", [CodeMode.EC4P4L2, CodeMode.EC6P10L2, CodeMode.EC6P3L3])
def test_lrc_roundtrip(rng, mode):
    roundtrip(mode, 30_000, rng, kill=[0])


def test_lrc_local_stripe_repair(rng):
    """One missing shard inside an AZ repairs via the local stripe."""
    enc = new_encoder(CodeMode.EC6P10L2)
    data = rng.integers(0, 256, 20_000, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)
    golden = [s.copy() for s in shards]

    # shard 7 lives in AZ0's local stripe [0,1,2,6..10,16]
    shards[7][:] = 0
    enc.reconstruct(shards, [7])
    assert np.array_equal(shards[7], golden[7])

    # kill a local parity too
    shards[16][:] = 0
    shards[3][:] = 0
    enc.reconstruct(shards, [3, 16])
    for i in (3, 16):
        assert np.array_equal(shards[i], golden[i])
    assert enc.verify(shards)


def test_lrc_global_fallback(rng):
    """More erasures than a local stripe can fix fall back to the global stripe."""
    enc = new_encoder(CodeMode.EC6P10L2)  # local_m = 1 per AZ
    data = rng.integers(0, 256, 8_000, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)
    golden = [s.copy() for s in shards]

    kill = [0, 1, 2, 6, 7]  # five AZ0 shards: beyond local_m=1
    for i in kill:
        shards[i][:] = 0
    enc.reconstruct(shards, kill)
    for i in kill:
        assert np.array_equal(shards[i], golden[i])


def test_lrc_reconstruct_data_only(rng):
    enc = new_encoder(CodeMode.EC4P4L2)
    data = rng.integers(0, 256, 5_000, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)
    golden = [s.copy() for s in shards]
    shards[1][:] = 0
    shards[5][:] = 0
    enc.reconstruct_data(shards, [1, 5])
    assert np.array_equal(shards[1], golden[1])


def test_shards_in_idc():
    enc = new_encoder(CodeMode.EC6P10L2)
    shards = enc.split(b"x" * 1000)
    az0 = enc.get_shards_in_idc(shards, 0)
    assert len(az0) == 9
    assert len(enc.get_data_shards(shards)) == 6
    assert len(enc.get_parity_shards(shards)) == 10
    assert len(enc.get_local_shards(shards)) == 2


def test_unrecoverable_raises(rng):
    enc = new_encoder(CodeMode.EC6P3)
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)
    with pytest.raises(ValueError):
        enc.reconstruct(shards, [0, 1, 2, 3])


def test_enable_verify_catches_corruption(rng):
    enc = new_encoder(EncoderConfig(code_mode=CodeMode.EC6P3.value, enable_verify=True))
    data = rng.integers(0, 256, 1000, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)  # must not raise


def test_bytearray_shards(rng):
    """Caller-owned bytearray buffers are filled in place, Go-style."""
    enc = new_encoder(CodeMode.EC3P3)
    data = rng.integers(0, 256, 3 * 2048, dtype=np.uint8).tobytes()
    shards = [bytearray(data[i * 2048 : (i + 1) * 2048]) for i in range(3)]
    shards += [bytearray(2048) for _ in range(3)]
    enc.encode(shards)
    assert enc.verify(shards)
    golden = [bytes(s) for s in shards]
    shards[0][:] = bytes(2048)
    enc.reconstruct(shards, [0])
    assert bytes(shards[0]) == golden[0]


def test_mismatched_shard_sizes_raise():
    enc = new_encoder(CodeMode.EC3P3)
    shards = [np.zeros(10, np.uint8)] * 5 + [np.zeros(9, np.uint8)]
    with pytest.raises(InvalidShardsError):
        enc.encode(shards)


def test_invalid_custom_tactic_rejected():
    """A Tactic whose N/M/L don't divide az_count must be rejected up front."""
    from chubaofs_tpu_torch.codec.codemode import Tactic

    bad = Tactic(5, 2, 2, 2, put_quorum=6)
    with pytest.raises(ValueError):
        new_encoder(EncoderConfig(code_mode=bad))


def test_unknown_mode_name_raises_value_error():
    with pytest.raises(ValueError, match="unknown code mode"):
        new_encoder("EC999")


def test_readonly_shards_rejected_before_compute():
    enc = new_encoder(CodeMode.EC3P3)
    shards = [bytes(2048)] * 6  # immutable outputs
    with pytest.raises(InvalidShardsError, match="read-only"):
        enc.encode(shards)
    with pytest.raises(InvalidShardsError, match="read-only"):
        enc.reconstruct(shards, [0])


@pytest.mark.parametrize("mode", [CodeMode.EC4P4L2, CodeMode.EC6P10L2,
                                  CodeMode.EC6P3L3, CodeMode.EC16P20L2])
def test_lrc_composed_parity_matrix_matches_two_stage(rng, mode):
    """The single composed-generator matmul (lrc_parity_matrix) is bit-identical
    to the two-stage global+local encode for every LRC tactic."""
    from chubaofs_tpu_torch.codec.codemode import get_tactic
    from chubaofs_tpu_torch.codec.encoder import lrc_parity_matrix
    from chubaofs_tpu_torch.ops import gf256

    t = get_tactic(mode)
    enc = new_encoder(mode)
    data = rng.integers(0, 256, t.N * 512, dtype=np.uint8).tobytes()
    shards = enc.split(data)
    enc.encode(shards)  # two-stage reference result

    mat = lrc_parity_matrix(t)
    assert mat.shape == (t.M + t.L, t.N)
    parity = gf256.gf_matmul(mat, np.stack(shards[: t.N]))
    np.testing.assert_array_equal(parity, np.stack(shards[t.N :]))
