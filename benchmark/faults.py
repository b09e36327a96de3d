"""Faults planted under the timed path, for the controls of `correct`, and
one slowdown, for the control of a metric's sensitivity.

Each is a function of the live daemon that patches the program in this
process after the preload, before the window's warm-up; a run with a fault
must come out not correct.
The benchmark's own runs plant none: benchmark/control.py runs them on the
card at a cell's own size, benchmark/tests on the host at a small one.

  * parity_unwritten (the control for a cell's PUTs): the blobnodes drop
    every parity shard write and report success, so a PUT is acknowledged
    without its put quorum, the guarantee the configuration states.
  * decode_skipped (control, degraded GET cells): the codec's device batch
    returns zeros, so a degraded read serves data it never reconstructed.
  * shard_altered (control, healthy GET cell): a blobnode's shard read comes
    back with one byte flipped, a read answer altered where it is produced.
  * answer_altered: every codec result has one byte flipped where it is
    produced (parity of a PUT, rows of a decode).
  * half_batch: the codec computes only the first half of each device batch
    and leaves the rest zero.
  * state_unchanged: a shard write returns without storing anything.
  * full_stripe_decode (control of the range-pair cells' decoded bytes):
    every degraded read skips the windowed decode and takes the gateway's
    full-stripe path, so each answer is right but more is decoded than the
    degraded halves ask for.
  * decode_delayed, decode_delayed_1ms: every codec batch sleeps 3 ms (1
    ms) before its call, and computes the right answer. Controls of
    get_degraded_x's sensitivity (a slower decode has to raise it), not of
    `correct`: a run with either must come out correct.
"""

from __future__ import annotations

import time

import numpy as np

_REAL: dict = {}  # the codec's batch entry, while a fault wraps it


def _patch_batches(fn, delay_s: float = 0.0) -> None:
    """Wrap the codec's batch entry (rs.gf_matmul_hostbatch): fn(out) edits
    the (batch, rows, k) result in place; the call waits delay_s first."""
    from chubaofs_tpu_torch.ops import rs

    real = _REAL.setdefault("hostbatch", rs.gf_matmul_hostbatch)

    def broken(mat_bits, shards, device=None):
        time.sleep(delay_s)
        out = np.array(real(mat_bits, shards, device=device))
        fn(out.reshape(-1, *out.shape[-2:]))
        return out

    rs.gf_matmul_hostbatch = broken


def _patch_nodes(daemon, method: str, make) -> None:
    cluster = daemon.runner.handles["cluster"]
    for node in cluster.nodes.values():
        setattr(node, method, make(node, getattr(node, method), cluster))


def parity_unwritten(daemon) -> None:
    from chubaofs_tpu_torch.blobstore.clustermgr import parse_vuid

    def make(node, real, cluster):
        def put_shard(vuid, bid, payload):
            vid, idx, _ = parse_vuid(vuid)
            if idx >= cluster.cm.get_volume(vid).tactic().N:
                return None
            return real(vuid, bid, payload)
        return put_shard

    _patch_nodes(daemon, "put_shard", make)


def state_unchanged(daemon) -> None:
    _patch_nodes(daemon, "put_shard", lambda node, real, cluster: lambda vuid, bid, payload: None)


def shard_altered(daemon) -> None:
    def make(node, real, cluster):
        def get_shard(vuid, bid, offset=0, size=None):
            data = bytearray(real(vuid, bid, offset=offset, size=size))
            if data:
                data[len(data) // 2] ^= 0x5A
            return bytes(data)
        return get_shard

    _patch_nodes(daemon, "get_shard", make)


def decode_skipped(daemon) -> None:
    def zero(out):
        out[:] = 0
    _patch_batches(zero)


def answer_altered(daemon) -> None:
    def flip(out):
        out[:, 0, 0] ^= 0x5A
    _patch_batches(flip)


def half_batch(daemon) -> None:
    def drop(out):
        out[out.shape[0] // 2:] = 0
    _patch_batches(drop)


def full_stripe_decode(daemon) -> None:
    from chubaofs_tpu_torch.blobstore.access import Access

    _REAL.setdefault("window", Access._degraded_window)
    Access._degraded_window = lambda self, *args: None


def decode_delayed(daemon) -> None:
    _patch_batches(lambda out: None, delay_s=0.003)


def decode_delayed_1ms(daemon) -> None:
    _patch_batches(lambda out: None, delay_s=0.001)


FAULTS = {f.__name__: f for f in (parity_unwritten, decode_skipped, shard_altered,
                                  answer_altered, half_batch, state_unchanged,
                                  full_stripe_decode, decode_delayed, decode_delayed_1ms)}


def restore() -> None:
    """Undo a batch or gateway patch (node patches die with their daemon)."""
    from chubaofs_tpu_torch.blobstore.access import Access
    from chubaofs_tpu_torch.ops import rs

    if "hostbatch" in _REAL:
        rs.gf_matmul_hostbatch = _REAL.pop("hostbatch")
    if "window" in _REAL:
        Access._degraded_window = _REAL.pop("window")
