"""Metadata plane — range-sharded, raft-replicated inode/dentry partitions
(reference metanode/ equivalent)."""

from chubaofs_tpu_torch.meta.partition import (
    Dentry,
    ExtentKey,
    Inode,
    MetaPartitionSM,
    MetaError,
    ROOT_INO,
)
from chubaofs_tpu_torch.meta.metanode import MetaNode

__all__ = [
    "Inode",
    "Dentry",
    "ExtentKey",
    "MetaPartitionSM",
    "MetaNode",
    "MetaError",
    "ROOT_INO",
]
