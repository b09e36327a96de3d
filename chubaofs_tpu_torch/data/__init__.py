"""Replicated data plane: chain-repl + raft datanodes (datanode/, repl/)."""

from chubaofs_tpu_torch.data.datanode import (  # noqa: F401
    DataNode, DataPartition, DataPartitionSM, SpaceManager,
)
from chubaofs_tpu_torch.data.repl import FollowerAckError, ReplError, ReplServer  # noqa: F401
