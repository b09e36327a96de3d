"""Device grids and sharded codec dispatch (multi-device scale-out)."""

from chubaofs_tpu_torch.parallel.mesh import (
    codec_mesh,
    group_view,
    shard_stripes,
    sharded_codec_step,
    sharded_gf_matmul,
    ungroup_stripe,
)

__all__ = [
    "codec_mesh",
    "group_view",
    "shard_stripes",
    "sharded_codec_step",
    "sharded_gf_matmul",
    "ungroup_stripe",
]
