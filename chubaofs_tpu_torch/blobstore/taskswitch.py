"""Runtime task switches (blobstore/common/taskswitch analog).

Reference counterpart: common/taskswitch/task_switch.go:26,102 — background
task kinds (balance, disk_repair, disk_drop, blob_delete, shard_repair,
vol_inspect) each get an on/off switch persisted in the clustermgr config KV
and polled by the scheduler; flipping a switch pauses the task fleet without
restarts. Kept: named switches backed by a pluggable config accessor
(clustermgr KV here too), a polling refresher, and WaitEnable for task loops.
"""

from __future__ import annotations

import threading

SWITCH_BALANCE = "balance"
SWITCH_DISK_REPAIR = "disk_repair"
SWITCH_DISK_DROP = "disk_drop"
SWITCH_BLOB_DELETE = "blob_delete"
SWITCH_SHARD_REPAIR = "shard_repair"
SWITCH_VOL_INSPECT = "vol_inspect"
SWITCH_TIER_MIGRATE = "tier_migrate"

ALL_SWITCHES = (SWITCH_BALANCE, SWITCH_DISK_REPAIR, SWITCH_DISK_DROP,
                SWITCH_BLOB_DELETE, SWITCH_SHARD_REPAIR, SWITCH_VOL_INSPECT,
                SWITCH_TIER_MIGRATE)


class TaskSwitch:
    def __init__(self, name: str, enabled: bool = True):
        self.name = name
        self._enabled = enabled
        self._cond = threading.Condition()

    def enabled(self) -> bool:
        return self._enabled

    def set(self, enabled: bool):
        with self._cond:
            self._enabled = enabled
            if enabled:
                self._cond.notify_all()

    def wait_enable(self, timeout: float | None = None) -> bool:
        """Block a task loop while its switch is off (task_switch.go:102)."""
        with self._cond:
            return self._cond.wait_for(lambda: self._enabled, timeout)


class SwitchMgr:
    """Named switch registry; syncs from a config-KV getter when given one."""

    CONFIG_PREFIX = "task_switch/"

    def __init__(self, config_get=None, config_set=None):
        self._switches = {n: TaskSwitch(n) for n in ALL_SWITCHES}
        self._config_get = config_get
        self._config_set = config_set

    def switch(self, name: str) -> TaskSwitch:
        sw = self._switches.get(name)
        if sw is None:
            sw = self._switches[name] = TaskSwitch(name)
        return sw

    def enabled(self, name: str) -> bool:
        return self.switch(name).enabled()

    def set(self, name: str, enabled: bool):
        self.switch(name).set(enabled)
        if self._config_set is not None:
            self._config_set(self.CONFIG_PREFIX + name, "true" if enabled else "false")

    def refresh(self):
        """Pull persisted values (the scheduler's periodic sync loop body)."""
        if self._config_get is None:
            return
        for name, sw in self._switches.items():
            v = self._config_get(self.CONFIG_PREFIX + name)
            if v is not None:
                sw.set(str(v).lower() != "false")
