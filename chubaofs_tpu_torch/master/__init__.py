"""Master — cluster resource manager (reference master/ equivalent)."""

from chubaofs_tpu_torch.master.master import Master, MasterSM, VolumeView, MetaPartitionView

__all__ = ["Master", "MasterSM", "VolumeView", "MetaPartitionView"]
