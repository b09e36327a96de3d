"""Chaos — deterministic fault injection for the whole stack.

  * `chaos.failpoint(name)` call sites (rpc, evloop dispatch, raft drain and
    transport, datanode ops, extent-store IO and CRC path, meta submit,
    blobnode shard IO, access hedged gather, rs encode) are armed per name
    with error / delay /
    hang-until-released / drop / corrupt / return-value actions, globally or
    per node, with hit counters, budgets and probabilities. Zero-overhead
    no-ops while nothing is armed.
  * a seeded `ChaosScheduler` drives fault plans (node wedge, slow disk,
    link drop, shard bit-rot, process crash/restart) against a live
    MiniCluster on a virtual timeline with a reproducible event log;
    `corrupt_shard_on_disk` is its bit-rot injector.

Env-var control: `CFS_FAILPOINTS=rs.encode=delay(0.1);raft.send=drop@0.1` is
parsed on first import, so subprocesses inherit faults from the harness
environment.
"""

from chubaofs_tpu_torch.chaos.failpoints import (  # noqa: F401
    Dropped,
    FailpointError,
    arm,
    armed,
    corrupt_bytes,
    disarm,
    failpoint,
    fired,
    hits,
    load_env,
    load_spec,
    release,
    reset,
)
from chubaofs_tpu_torch.chaos.inject import corrupt_shard_on_disk  # noqa: F401
from chubaofs_tpu_torch.chaos.scheduler import (  # noqa: F401
    ChaosScheduler,
    Fault,
    FaultPlan,
    builtin_plan,
)

load_env()  # arm anything the harness put in CFS_FAILPOINTS
