"""Multi-raft consensus — equivalent of the reference's vendored tiglabs/raft
(depends/tiglabs/raft: etcd-style multi-raft with merged heartbeats across
groups, separate heartbeat/replicate transports) and blobstore's single-group
common/raftserver. One implementation serves both roles here."""

from chubaofs_tpu_torch.raft.core import RaftCore, ROLE_FOLLOWER, ROLE_CANDIDATE, ROLE_LEADER, NotLeaderError
from chubaofs_tpu_torch.raft.server import MultiRaft, StateMachine, InProcNet

__all__ = [
    "RaftCore",
    "MultiRaft",
    "StateMachine",
    "InProcNet",
    "NotLeaderError",
    "ROLE_FOLLOWER",
    "ROLE_CANDIDATE",
    "ROLE_LEADER",
]
