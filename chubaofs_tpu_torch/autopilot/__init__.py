"""Closed-loop autopilot: alerts drive actuators, auditably.

See controller.py for the decision pipeline and safety gates,
actuators.py for the remediation registry.
"""

from chubaofs_tpu_torch.autopilot.actuators import (  # noqa: F401
    cache_promote_nudge,
    client_actuators,
    default_bindings,
    knob_nudge,
    master_actuators,
    qos_parent_nudge,
    scrub_shed,
)
from chubaofs_tpu_torch.autopilot.controller import (  # noqa: F401
    DECISIONS,
    Actuator,
    Autopilot,
    Binding,
    activate_from_env,
    autopilot_status,
    deactivate,
    default_controller,
    enabled_from_env,
)
