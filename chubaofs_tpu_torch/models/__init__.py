"""Flagship codec pipeline configs — the framework's "model zoo".

Each entry pairs a CodeMode with the stripe geometry used by a benchmark config in
BASELINE.md. The flagship is EC(12,4) at 8 MiB stripes (the encode /
reconstruct target); the archive config is EC(20,4)+LRC-style wide stripes.
"""

from __future__ import annotations

from dataclasses import dataclass

from chubaofs_tpu_torch.codec.codemode import CodeMode, Tactic, get_tactic


def _align_up(x: int, a: int) -> int:
    return -(-x // a) * a


@dataclass(frozen=True)
class CodecModel:
    """A benchmarkable codec configuration: layout + stripe geometry."""

    name: str
    mode: CodeMode
    stripe_bytes: int  # total data bytes per stripe

    @property
    def tactic(self) -> Tactic:
        return get_tactic(self.mode)

    @property
    def shard_len(self) -> int:
        """Per-shard bytes, 128-aligned: the same stripe geometry as the JAX
        package's zoo, so both packages bench identical shapes. (The CUDA
        kernel takes any length; 128 is a multiple of its 16-byte vectors.)"""
        return _align_up(-(-self.stripe_bytes // self.tactic.N), 128)


MiB = 1 << 20

EC4P2_1M = CodecModel("ec4p2-1mib", CodeMode.EC4P2, 1 * MiB)  # unit-bench scale
EC6P3_4M = CodecModel("ec6p3-4mib", CodeMode.EC6P3, 4 * MiB)  # access PUT streaming
EC12P4_8M = CodecModel("ec12p4-8mib", CodeMode.EC12P4, 8 * MiB)  # flagship
EC16P20L2_16M = CodecModel("ec16p20l2-16mib", CodeMode.EC16P20L2, 16 * MiB)  # wide-parity LRC
EC20P4L2_16M = CodecModel("ec20p4l2-16mib", CodeMode.EC20P4L2, 16 * MiB)  # BASELINE archive

FLAGSHIP = EC12P4_8M
ARCHIVE = EC20P4L2_16M  # the bench + multichip-dryrun LRC config

REGISTRY = {m.name: m for m in [
    EC4P2_1M, EC6P3_4M, EC12P4_8M, EC16P20L2_16M, EC20P4L2_16M,
]}
