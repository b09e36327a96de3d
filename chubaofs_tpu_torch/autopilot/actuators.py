"""Actuator registry — the remediations the autopilot is allowed to run.

Each factory returns `controller.Actuator` objects wrapping one existing
operator knob; none of them invents new mechanism. Two families:

  * knob nudges (reversible) — multiplicative scaling of a live runtime
    value with the old value as the undo token: cache promotion
    threshold (blobstore/cache.py `promote_hits`), blobnode scrub token
    budget (`_scrub_bucket.rate`), QoS parent-bucket rate
    (utils/qos.py FairLimiter parent). The strict-improvement gate rolls
    these back when the triggering alert does not resolve in the settle
    window.
  * sweeps (irreversible) — the master's `rebalance_hot` /
    `rebalance_meta` partition moves. A move cannot be un-moved; the
    gate still records the verdict (`autopilot_rolled_back` with
    reversed=false) so the timeline says whether the sweep helped.

`master_actuators` binds a local Master object (the in-process master
daemon registration); `client_actuators` binds a MasterClient (the
console-fed cfs-capacity `--autopilot` controller, which acts on the
cluster from outside).
"""

from __future__ import annotations

from chubaofs_tpu_torch.autopilot.controller import Actuator, Binding


def knob_nudge(name: str, getter, setter, factor: float,
               floor: float | None = None, ceiling: float | None = None,
               description: str = "") -> Actuator:
    """A reversible multiplicative nudge on one live knob: apply scales
    the current value by `factor` (clamped to [floor, ceiling]) and
    returns the old value; rollback restores it. Int knobs stay ints."""

    def _apply(fp, report):
        old = getter()
        new = old * factor
        if floor is not None:
            new = max(floor, new)
        if ceiling is not None:
            new = min(ceiling, new)
        if isinstance(old, int):
            new = int(round(new))
        setter(new)
        return old

    def _rollback(old):
        setter(old)

    return Actuator(name, apply=_apply, rollback=_rollback,
                    description=description or
                    f"scale by {factor} (undo restores)")


def cache_promote_nudge(cache, factor: float = 0.5) -> Actuator:
    """Cache-miss burn: HALVE the promotion threshold so hot keys reach
    the cache sooner (floor 1 — never disable promotion)."""
    return knob_nudge(
        "nudge_promote",
        lambda: cache.promote_hits,
        lambda v: setattr(cache, "promote_hits", v),
        factor, floor=1,
        description="lower cache promote_hits (promote sooner)")


def scrub_shed(node, factor: float = 0.5) -> Actuator:
    """Repair backlog: shed the CRC-scrub token budget so repair traffic
    gets the spindle. Raises at apply time when the node has no scrub
    bucket armed (surfaces as an autopilot error decision, not silence)."""

    def _get():
        if node._scrub_bucket is None:
            raise RuntimeError("scrub bucket not armed (CFS_SCRUB_RATE=0)")
        return node._scrub_bucket.rate

    def _set(v):
        node._scrub_bucket.rate = v

    return knob_nudge("shed_scrub", _get, _set, factor, floor=1.0,
                      description="shed scrub token budget for repair")


def qos_parent_nudge(plane, factor: float = 1.25) -> Actuator:
    """Tenant throttle-ratio burn: grow the QoS parent (borrow-pool)
    bucket so queued tenants drain — the parent-bucket rebalance."""

    def _get():
        if plane.rate is None or plane.rate.parent is None:
            raise RuntimeError("QoS rate parent bucket not configured")
        return plane.rate.parent.rate

    def _set(v):
        plane.rate.parent.rate = v

    return knob_nudge("qos_rebalance", _get, _set, factor,
                      description="grow QoS parent rate bucket")


def master_actuators(master, factor: float = 1.2,
                     max_moves: int = 2) -> list[Actuator]:
    """The master daemon's in-process sweeps (registered after boot).
    Leader-gated: a follower's apply raises, which the controller
    records as an error decision rather than a silent no-op.
    Irreversible: replica moves have no undo."""

    def _sweep(fn):
        def _apply(fp, report):
            if not getattr(master, "is_leader", True):
                raise RuntimeError("not the raft leader")
            return {"moved": fn(factor=factor, max_moves=max_moves)}

        return _apply

    return [
        Actuator("rebalance_hot", apply=_sweep(master.rebalance_hot),
                 description="shed hottest data replicas to cold nodes"),
        Actuator("rebalance_meta", apply=_sweep(master.rebalance_meta),
                 description="migrate hottest meta partitions"),
    ]


def client_actuators(client, factor: float = 1.2,
                     max_moves: int = 2) -> list[Actuator]:
    """MasterClient-backed sweeps for a console-fed controller (the
    cfs-capacity --autopilot harness): same names, acting over HTTP."""
    return [
        Actuator("rebalance_hot",
                 apply=lambda fp, report: client.rebalance_hot(
                     factor=factor, max_moves=max_moves),
                 description="HTTP /dataNode/rebalanceHot sweep"),
        Actuator("rebalance_meta",
                 apply=lambda fp, report: client.rebalance_meta(
                     factor=factor, max_moves=max_moves),
                 description="HTTP /metaPartition/rebalance sweep"),
    ]


def default_bindings(cooldown_s: float | None = None,
                     settle_s: float | None = None) -> list[Binding]:
    """The stock alert→actuator map (mirrors alerts.default_rules(): one
    set serves every daemon; a binding whose actuator never registers
    shows disarmed in status and decides nothing). Clocks default from
    CFS_AUTOPILOT_COOLDOWN_S / CFS_AUTOPILOT_SETTLE_S."""
    from chubaofs_tpu_torch.autopilot.controller import _env_f

    cd = float(cooldown_s if cooldown_s is not None
               else _env_f("CFS_AUTOPILOT_COOLDOWN_S", 60.0))
    st = float(settle_s if settle_s is not None
               else _env_f("CFS_AUTOPILOT_SETTLE_S", 30.0))
    mk = lambda *a, **kw: Binding(*a, cooldown_s=cd, settle_s=st, **kw)
    return [
        mk("hot-put-rebalance", "slo_failing", "rebalance_hot",
           match_labels=(("slo", "put_p99"),),
           description="PUT p99 burn: shed hot data replicas"),
        mk("hot-get-rebalance", "slo_failing", "rebalance_hot",
           match_labels=(("slo", "get_p99"),),
           description="GET p99 burn: shed hot data replicas"),
        mk("cache-promote", "slo_failing", "nudge_promote",
           match_labels=(("slo", "cache_miss_ratio"),),
           description="cache-miss burn: promote sooner"),
        mk("repair-shed", "repair_backlog", "shed_scrub",
           description="repair backlog: shed scrub token budget"),
        mk("tenant-qos", "slo_failing", "qos_rebalance",
           match_labels=(("slo", "qos_throttle:*"),),
           description="tenant throttle burn: grow QoS parent bucket"),
    ]
