"""Chaos — deterministic fault injection: the failpoint API.

`chaos.failpoint(name)` call sites (here: `rs.encode`) are armed per name
with error / delay / hang-until-released / drop / corrupt / return-value
actions, globally or per node, with hit counters, budgets and probabilities,
and are zero-overhead no-ops while nothing is armed.

Env-var control: `CFS_FAILPOINTS=rs.encode=delay(0.1)` is parsed on first
import, so subprocesses inherit faults from the harness environment.
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

load_env()  # arm anything the harness put in CFS_FAILPOINTS
