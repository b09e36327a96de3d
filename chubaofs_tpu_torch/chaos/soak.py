"""Chaos soak — PUT -> fault -> degraded GET -> heal -> converge, seeded.

The acceptance cycle behind `tools/chaos_soak.py` and tests/test_chaos.py:
a MiniCluster takes writes, a ChaosScheduler injects a fault plan on the
virtual timeline, every ACKED blob must read back byte-identical in every
phase (degraded included) with bounded tail latency, and once the faults
lift the repair planes must converge to a quiet inspector sweep with zero
data loss. Everything is driven off seeded RNGs, so the injection event
log is reproducible run-over-run.

PUTs issued while a fault window is ACTIVE may be rejected by the put
quorum (EC quorums tolerate one lost unit; a wedged two-disk node can
legitimately hold two units of a stripe). A rejected PUT is correct
degraded behavior — the data was never acked — and the soak retries it
until it lands; an unacked blob is never counted against data loss. A
rejection while NO fault is active fails the soak.
"""

from __future__ import annotations

import random
import time

from chubaofs_tpu_torch.chaos import failpoints as fp
from chubaofs_tpu_torch.chaos.scheduler import (
    ChaosScheduler,
    Fault,
    FaultPlan,
    builtin_plan,
)

SIZES = [8_000, 120_000, 700_000, 2_000_000]


class SoakFailure(AssertionError):
    """A soak gate tripped. When the flight recorder captured an incident
    bundle for it, `bundle` carries the directory path (cfs-chaos-soak
    prints it in the failure report)."""

    bundle: str | None = None


def _capture_on_failure(fn):
    """Freeze an incident bundle the moment a soak gate trips — the rings
    the postmortem needs (events, slowops, metric history, traces) are
    in-process and still warm right here; by the time an operator reruns
    anything they've rotated. Explicit capture works even with CFS_FLIGHT
    unset (the on-demand contract); a capture error must never mask the
    soak failure itself."""
    import functools

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except SoakFailure as e:
            try:
                from chubaofs_tpu_torch.utils import flightrec

                man = flightrec.capture(trigger="soak_failure",
                                        fingerprint=f"soak:{fn.__name__}",
                                        alert={"name": fn.__name__,
                                               "error": str(e)})
                e.bundle = man.get("bundle")
            except Exception:
                pass
            raise

    return wrapped


class _AlertProbe:
    """The soak's alert-plane gate: a PRIVATE AlertManager + metric-history
    ring (never the process defaults — the probe neither inherits instance
    state from, nor clobbers the cfs_alerts_firing gauge of, whatever
    serving manager exists in this process; its slo_failing rule evaluates
    with track_flips=False for the same reason), ticked by the soak loop.
    Its alert_firing/alert_resolved transition events DO land on the
    journal — in a MiniCluster soak the probe IS the alert plane, and the
    lifecycle is exactly the timeline evidence the acceptance reads.
    `fired`/`firing` are what the gates assert on."""

    def __init__(self, infra_only: bool = False):
        from chubaofs_tpu_torch.utils.alerts import AlertManager, default_rules
        from chubaofs_tpu_torch.utils.metrichist import MetricHistory

        rules = default_rules()
        if infra_only:
            # the kill soak's exactly-one-alert contract: SLO burn windows
            # legitimately flip while a node is dead (PUT quorums reject,
            # p99 inflates — that's detection, and the capacity harness
            # owns gating it); the deterministic lifecycle this soak proves
            # is the INFRASTRUCTURE alert: broken disks fire, then resolve
            rules = [r for r in rules if r.kind != "slo_failing"]
        self.hist = MetricHistory(maxlen=64)
        self.am = AlertManager(rules=rules, private=True)

    def tick(self) -> None:
        self.hist.record()
        self.am.evaluate(self.hist.snapshots())

    def fired(self) -> list[str]:
        return self.am.fired_names()

    def firing(self) -> list[str]:
        return sorted({a["name"] for a in self.am.firing()})


def _timeline_events(journal, seq0: int) -> list[dict]:
    evs, _ = journal.query(since=seq0, n=10 ** 6)
    return evs


def _assert_causal_order(evs: list[dict], seed: int) -> list[dict]:
    """The kill soak's timeline acceptance: the injected kill, the broken-
    disk detection, the repair lease, and the rebuild-finished terminal
    event must all be PRESENT and in causal (monotonic) order — and the
    rebuild-finished event must carry the repair trace id so `cfs-events
    --correlate` can join it to the repair spans. Returns the four anchor
    events, in order."""

    def first(pred, what: str) -> dict:
        for e in evs:
            if pred(e):
                return e
        raise SoakFailure(
            f"kill soak seed {seed}: timeline has no {what} event "
            f"({len(evs)} events on the journal)")

    kill = first(lambda e: e["type"] == "chaos_inject"
                 and e["entity"] == "node_kill", "chaos_inject/node_kill")
    broken = first(lambda e: e["type"] == "disk_status"
                   and e["detail"].get("to") == "broken", "disk_broken")
    lease = first(lambda e: e["type"] == "lease_acquired"
                  and e["detail"].get("kind") == "disk_repair",
                  "disk-repair lease_acquired")
    finishes = [e for e in evs if e["type"] == "task_finished"
                and e["detail"].get("kind") == "disk_repair"]
    if not finishes:
        raise SoakFailure(f"kill soak seed {seed}: timeline has no "
                          f"disk-repair task_finished (rebuild-finished)")
    done = finishes[-1]
    chain = [kill, broken, lease, done]
    monos = [e["mono"] for e in chain]
    if monos != sorted(monos):
        raise SoakFailure(
            f"kill soak seed {seed}: timeline out of causal order: "
            + " -> ".join(f"{e['type']}@{e['mono']:.3f}" for e in chain))
    if not done.get("trace_id"):
        raise SoakFailure(
            f"kill soak seed {seed}: rebuild-finished event carries no "
            f"trace id (cfs-events --correlate would find nothing)")
    return chain


@_capture_on_failure
def run_soak(root: str, plan: FaultPlan | str, seed: int, rounds: int = 6,
             puts_per_round: int = 2, n_nodes: int = 9, disks_per_node: int = 2,
             sizes: list[int] | None = None, read_deadline: float = 0.5,
             write_deadline: float = 4.0, converge_sweeps: int = 12,
             device=None) -> dict:
    """One full soak cycle; returns {events, puts, gets, max_get_s, ok, ...}.
    Raises SoakFailure on data loss, latency-bound violation, or a cluster
    that will not converge after the faults lift. `device` is the
    MiniCluster's codec device: None means the CUDA device (and raises
    without one), "cpu" runs the codec math on the host."""
    import numpy as np

    from chubaofs_tpu_torch.blobstore.access import Access, AccessError
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster

    if isinstance(plan, str):
        plan = builtin_plan(plan, steps=rounds)
    sizes = sizes or SIZES
    rnd = random.Random(seed)          # op schedule
    rng = np.random.default_rng(seed)  # payload bytes
    c = MiniCluster(root, n_nodes=n_nodes, disks_per_node=disks_per_node,
                    device=device)
    # alert-plane probe: a CLEAN cluster (pre-fault) must evaluate quiet —
    # that's the gate; alerts firing while a fault window is ACTIVE are the
    # plane WORKING (a wedged node legitimately burns put_p99) and are
    # reported as evidence, not failed on
    probe = _AlertProbe()
    # soak-tuned gateway: a wedged node must cost fractions of a second, not
    # the production 3s/10s windows, and hung reads pin pool workers until
    # the fault lifts — size the pools for that (the displaced stock gateway
    # gives up its executors first: MiniCluster.close only sees the new one)
    c.access.close()
    c.access = Access(c.cm, c.proxy, c.nodes, codec=c.codec, max_workers=64,
                      read_deadline=read_deadline,
                      write_deadline=write_deadline)
    sched = ChaosScheduler(c, plan, seed=seed + 1)
    live = sched.blobs  # blob idx -> (Location, payload); shared by bitrot
    # degraded GETs must finish inside the hedged-gather budget even with
    # wedged replicas; generous margin for CI thread scheduling
    get_bound = write_deadline + read_deadline + 5.0
    stats = {"puts": 0, "puts_rejected": 0, "gets": 0, "max_get_s": 0.0}
    next_id = 0
    pending: list[bytes] = []  # payloads rejected under faults, to retry
    try:
        gated_clean = False
        for _ in range(rounds):
            for _ in range(puts_per_round):
                size = rnd.choice(sizes)
                pending.append(
                    rng.integers(0, 256, size, dtype=np.uint8).tobytes())
            retry = []
            for data in pending:
                try:
                    live[next_id] = (c.access.put(data), data)
                    next_id += 1
                    stats["puts"] += 1
                except AccessError:
                    if sched.quiesced():
                        raise SoakFailure(
                            f"t={sched.vtime}: PUT rejected with no fault "
                            f"active under plan {plan.name} seed {seed}")
                    stats["puts_rejected"] += 1
                    retry.append(data)  # never acked: retry after heal
            pending = retry

            # the clean-cluster gate: before the FIRST injection, the rule
            # set must evaluate quiet (plans inject at step >= 1, so round
            # 0 always exercises this)
            if not gated_clean and sched.quiesced():
                probe.tick()
                if probe.fired():
                    raise SoakFailure(
                        f"plan {plan.name} seed {seed}: alerts fired on a "
                        f"clean pre-fault cluster: {probe.fired()}")
                gated_clean = True

            sched.step()

            # pump the repair planes between faults
            for _ in range(4):
                s = c.run_background_once()
                if (s["repair_msgs"] == 0 and s["disk_tasks"] == 0
                        and s["tasks_ran"] == 0):
                    break
            probe.tick()

            # THE invariant: every acked blob reads byte-identical, degraded
            # or healed, inside the latency bound
            for idx, (loc, data) in live.items():
                t0 = time.monotonic()
                got = c.access.get(loc)
                dt = time.monotonic() - t0
                stats["gets"] += 1
                stats["max_get_s"] = max(stats["max_get_s"], dt)
                if got != data:
                    raise SoakFailure(
                        f"t={sched.vtime}: blob {idx} corrupted under "
                        f"plan {plan.name} seed {seed}")
                if dt > get_bound:
                    raise SoakFailure(
                        f"t={sched.vtime}: blob {idx} GET took {dt:.2f}s "
                        f"(bound {get_bound:.2f}s) under plan {plan.name}")

        # lift anything still active, land the retries, then CONVERGE:
        # repair planes drain and a full inspector sweep goes quiet
        sched.close()
        for data in pending:
            live[next_id] = (c.access.put(data), data)
            next_id += 1
            stats["puts"] += 1
        converged = False
        for _ in range(converge_sweeps):
            c.run_background_once()
            if c.scheduler.inspect_volumes(max_volumes=1000) == 0:
                converged = True
                break
        if not converged:
            raise SoakFailure(
                f"plan {plan.name} seed {seed}: inspector never went quiet "
                f"after faults lifted")
        for idx, (loc, data) in live.items():
            if c.access.get(loc) != data:
                raise SoakFailure(
                    f"post-heal: blob {idx} lost under plan {plan.name}")
        # final evaluation after convergence; fault-window alerts ride the
        # result as evidence (a wedge burning put_p99 is detection, not a
        # soak failure — the kill soak owns the fire-then-resolve contract)
        probe.tick()
        # how often each injection actually bit (anti-vacuous-green signal:
        # a soak whose faults never fire has tested nothing)
        fired = {n: fp.fired(n) for n in
                 ("access.read_shard", "access.write_shard", "raft.send")}
        return {"plan": plan.name, "seed": seed, "events": list(sched.events),
                "ok": True, "fired": {k: v for k, v in fired.items() if v},
                "alerts_fired": probe.fired(), **stats}
    finally:
        sched.close()
        fp.reset()  # never leak armings into the next soak/test
        c.close()


@_capture_on_failure
def run_kill_soak(root: str, seed: int, n_nodes: int = 9,
                  disks_per_node: int = 2, warm_puts: int = 10,
                  live_puts: int = 8, hb_timeout: float = 0.75,
                  wire_ms: float = 2.0, read_deadline: float = 0.5,
                  write_deadline: float = 4.0, max_wait_s: float = 120.0,
                  sizes: list[int] | None = None,
                  mode: int | str | None = None, device=None) -> dict:
    """Kill a blobnode under live PUT load; the repair plane must notice and
    rebuild (the repair plane's acceptance scenario).

    `mode` pins every PUT to one CodeMode (name or value; None = cluster
    default) — the regenerating-code axis: soaking RG6P6 drives the rebuild
    through the beta-fetch plane (and its multi-loss full-gather fallback
    when the killed node held two units of a stripe), under the SAME
    byte-identical read-back and convergence invariants as the default
    mode.

    Phases: warm PUTs land acked blobs -> a seeded node_kill closes one
    engine and removes it from routing (its heartbeats stop) -> the
    clustermgr heartbeat expiry must mark the dead node's disks broken, the
    scheduler must turn them into disk-repair tasks, and the windowed
    rebuild pipeline must re-home every affected stripe onto the survivors
    — all while fresh PUTs keep arriving. During the rebuild a
    deterministic `wire_ms` delay rides every shard read (the deployment's
    gateway->blobnode RTT, as in perfbench's _wire regime) so the
    download/decode overlap the pipeline exists for is measurable; the
    repair spans are captured and analyzed with the cfs-trace library.

    Fails (SoakFailure) on: detection/rebuild timeout, any acked blob not
    byte-identical after rebuild, zero rebuild throughput, or a stranded
    WORKING task at soak end. Returns rebuild throughput, repair-traffic
    accounting (bytes per repaired shard), the download/decode overlap
    ratio, and the seeded event log. `device` is the MiniCluster's codec
    device, as in run_soak."""
    import numpy as np

    from chubaofs_tpu_torch.blobstore import trace
    from chubaofs_tpu_torch.blobstore.access import Access, AccessError
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
    from chubaofs_tpu_torch.blobstore.clustermgr import DISK_NORMAL
    from chubaofs_tpu_torch.blobstore.proxy import TOPIC_SHARD_REPAIR
    from chubaofs_tpu_torch.blobstore.scheduler import TASK_PREPARED, TASK_WORKING
    from chubaofs_tpu_torch.blobstore.taskswitch import SWITCH_VOL_INSPECT
    from chubaofs_tpu_torch.tools.cfstrace import critical_path, stage_overlap
    from chubaofs_tpu_torch.utils.exporter import registry

    from chubaofs_tpu_torch.utils import events as ev

    from chubaofs_tpu_torch.codec.codemode import CodeMode

    sizes = sizes or SIZES
    if isinstance(mode, str):
        mode = CodeMode[mode]
    rnd = random.Random(seed)
    rng = np.random.default_rng(seed)
    c = MiniCluster(root, n_nodes=n_nodes, disks_per_node=disks_per_node,
                    device=device)
    c.access.close()
    c.access = Access(c.cm, c.proxy, c.nodes, codec=c.codec, max_workers=64,
                      read_deadline=read_deadline,
                      write_deadline=write_deadline)
    c.scheduler.hb_timeout_s = hb_timeout
    # event-timeline + alert-plane acceptance: everything this
    # soak injects and everything the repair plane does about it must land
    # on ONE queryable timeline, and the broken-disk alert must FIRE during
    # the outage and RESOLVE once the rebuild converges
    journal = ev.default_journal()
    seq0 = journal.last_seq()
    probe = _AlertProbe(infra_only=True)
    # capture every repair span for the cfs-trace overlap proof (restore
    # whatever hook — trace sink or none — was installed before us)
    records: list[dict] = []
    prev_hook = trace.finish_hook()

    def _collect(span):
        if span.operation == "scheduler.repair":
            records.append(span.to_record())
        if prev_hook is not None:
            # chain: an installed trace sink must keep seeing EVERY span
            # finished during the soak, not lose them to our capture
            prev_hook(span)

    trace.set_finish_hook(_collect)
    reg = registry("scheduler")
    shards0 = reg.counter("repaired_shards").value
    bytes0 = reg.counter("repair_bytes_downloaded").value
    beta0 = reg.counter("repair_beta_shards").value
    live: dict[int, tuple] = {}
    next_id = 0
    stats = {"puts": 0, "puts_rejected": 0, "live_puts": 0}

    def put_one(data: bytes) -> bool:
        nonlocal next_id
        try:
            live[next_id] = (c.access.put(data, code_mode=mode), data)
            next_id += 1
            stats["puts"] += 1
            return True
        except AccessError:
            stats["puts_rejected"] += 1
            return False

    try:
        for _ in range(warm_puts):
            data = rng.integers(0, 256, rnd.choice(sizes),
                                dtype=np.uint8).tobytes()
            while not put_one(data):
                pass  # pre-kill: a healthy cluster must ack every PUT
        # settle heartbeats once so no disk is stale at kill time
        c.run_background_once()
        # the clean half of the alert acceptance: before any fault, the
        # rule set evaluates quiet
        probe.tick()
        if probe.fired():
            raise SoakFailure(
                f"kill soak seed {seed}: alerts firing BEFORE the kill "
                f"(stale state or broken rules): {probe.fired()}")

        plan = FaultPlan("node_kill", [Fault("node_kill", at=0)])
        sched = ChaosScheduler(c, plan, seed=seed + 1)
        sched.step()  # the seeded kill; the victim choice is in the log
        killed = sched.events[-1]["node"]
        victim_disks = [d.disk_id for d in c.cm.disks.values()
                        if d.node_id == killed]

        # rebuild under the deployment's latency shape: every shard read
        # pays wire_ms, so download width is real and overlap measurable.
        # The inspector sweep is paused for the rebuild window (it reads
        # every shard of every volume per tick — detection here is
        # heartbeat-driven, not inspector-driven) and re-enabled for the
        # convergence proof below.
        c.scheduler.switches.set(SWITCH_VOL_INSPECT, False)
        if wire_ms > 0:
            fp.arm("blobnode.get_shard", f"delay({wire_ms / 1000.0})")
        t_kill = time.monotonic()
        t_detect = None
        rebuild_busy = 0.0  # wall time the worker actually spent rebuilding
        pending_live = [
            rng.integers(0, 256, rnd.choice(sizes), dtype=np.uint8).tobytes()
            for _ in range(live_puts)]
        try:
            while True:
                if time.monotonic() - t_kill > max_wait_s:
                    raise SoakFailure(
                        f"kill soak seed {seed}: rebuild did not finish in "
                        f"{max_wait_s:.0f}s (victim node {killed})")
                if pending_live:  # live PUT load rides the rebuild
                    if put_one(pending_live[0]):
                        stats["live_puts"] += 1
                        pending_live.pop(0)
                # the detection->repair chain, stepped discretely so the
                # worker drain's wall time is measurable on its own (the
                # rebuild-throughput denominator)
                for n in list(c.nodes.values()):
                    try:
                        n.heartbeat(c.cm)
                    except Exception:
                        pass
                c.scheduler.check_node_health()
                c.scheduler.reap_expired()
                c.scheduler.poll_repair_topic()
                c.scheduler.check_disks()
                statuses = {c.cm.disks[d].status for d in victim_disks}
                if t_detect is None and statuses != {DISK_NORMAL}:
                    t_detect = time.monotonic()
                # the outage window: evaluated BEFORE the worker drains, so
                # the broken->repairing state is observable (one drain pass
                # can take a small cluster all the way to DROPPED)
                probe.tick()
                t0w = time.monotonic()
                ran = 0
                while c.worker.run_once():
                    ran += 1
                if ran:
                    rebuild_busy += time.monotonic() - t0w
                open_tasks = (c.scheduler.tasks(state=TASK_PREPARED)
                              + c.scheduler.tasks(state=TASK_WORKING))
                if (t_detect is not None and DISK_NORMAL not in statuses
                        and not open_tasks
                        and c.proxy.topics[TOPIC_SHARD_REPAIR].lag(
                            "scheduler") == 0):
                    break
                time.sleep(0.05)  # let the heartbeat-silence clock advance
        finally:
            if wire_ms > 0:
                fp.disarm("blobnode.get_shard")
            c.scheduler.switches.set(SWITCH_VOL_INSPECT, True)
        t_done = time.monotonic()

        # recovery is confirmed (rebuild finished): drop the punish windows
        # the dead node earned so post-rebuild PUTs trust the healed layout
        c.access.clear_punishments()
        # land any live PUTs the quorum rejected mid-rebuild
        for data in pending_live:
            for _ in range(50):
                if put_one(data):
                    break
                c.run_background_once()
            else:
                raise SoakFailure(f"kill soak seed {seed}: PUT still "
                                  f"rejected after the rebuild converged")

        # converge: repair planes drain and a FULL inspector sweep is quiet
        converged = False
        for _ in range(16):
            c.run_background_once()
            if c.scheduler.inspect_volumes(max_volumes=1000) == 0:
                converged = True
                break
        if not converged:
            raise SoakFailure(f"kill soak seed {seed}: inspector never went "
                              f"quiet after the rebuild")

        # THE invariants: every acked blob byte-identical on the survivors,
        # no unit still mapped to a dead disk, zero stranded WORKING tasks
        for idx, (loc, data) in live.items():
            if c.access.get(loc) != data:
                raise SoakFailure(
                    f"kill soak seed {seed}: blob {idx} miscompares after "
                    f"rebuild of node {killed}")
        for vol in c.cm.volumes.values():
            for u in vol.units:
                if u.disk_id in victim_disks:
                    raise SoakFailure(
                        f"kill soak seed {seed}: unit {u.vuid} still on dead "
                        f"disk {u.disk_id}")
        stranded = c.scheduler.tasks(state=TASK_WORKING)
        if stranded:
            raise SoakFailure(
                f"kill soak seed {seed}: {len(stranded)} WORKING tasks "
                f"stranded at soak end")

        rebuilt = reg.counter("repaired_shards").value - shards0
        dl_bytes = reg.counter("repair_bytes_downloaded").value - bytes0
        rebuild_s = max(1e-9, rebuild_busy)
        if rebuilt <= 0:
            raise SoakFailure(
                f"kill soak seed {seed}: zero rebuild throughput "
                f"(no shards repaired after killing node {killed})")

        # the chaos half of the alert acceptance: the outage fired EXACTLY
        # one named alert (broken_disks) and, now that every victim disk is
        # DROPPED, it resolves
        probe.tick()
        if probe.fired() != ["broken_disks"]:
            raise SoakFailure(
                f"kill soak seed {seed}: expected exactly the broken_disks "
                f"alert to fire during the outage, got {probe.fired()}")
        if probe.firing():
            raise SoakFailure(
                f"kill soak seed {seed}: alerts still firing after the "
                f"rebuild converged: {probe.firing()}")

        # timeline acceptance: kill -> disk_broken -> repair lease ->
        # rebuild finished, causally ordered and trace-correlated
        tl = _timeline_events(journal, seq0)
        chain = _assert_causal_order(tl, seed)
        timeline = [{"t": round(e["mono"] - chain[0]["mono"], 3),
                     "type": e["type"], "entity": e["entity"],
                     "severity": e["severity"],
                     **({"trace_id": e["trace_id"]}
                        if e.get("trace_id") else {})}
                    for e in chain]
        # the cfs-trace proof: per-repair-trace download/decode overlap
        overlap, best_report = 0.0, None
        for rec in records:
            ov = stage_overlap([rec], "download", "codec.")
            if ov["ratio"] > overlap or best_report is None:
                overlap = max(overlap, ov["ratio"])
                best_report = critical_path([rec])
        return {
            "plan": "kill_blobnode", "seed": seed, "ok": True,
            "code_mode": CodeMode(mode).name if mode is not None else None,
            "beta_shards": int(
                reg.counter("repair_beta_shards").value - beta0),
            "events": list(sched.events), "killed_node": killed,
            "detect_s": round((t_detect or t_done) - t_kill, 3),
            "rebuild_s": round(rebuild_s, 3),
            "rebuilt_shards": int(rebuilt),
            "rebuild_shards_per_s": round(rebuilt / rebuild_s, 1),
            "bytes_per_repaired_shard": round(dl_bytes / rebuilt, 1),
            "repair_overlap_ratio": round(overlap, 3),
            "repair_traces": len(records),
            "critical_path": best_report,
            "timeline": timeline,
            "repair_trace_id": chain[-1].get("trace_id"),
            "alerts_fired": probe.fired(),
            "alerts_firing": probe.firing(),
            **stats,
        }
    finally:
        trace.set_finish_hook(prev_hook)
        fp.reset()
        c.close()


@_capture_on_failure
def run_meta_split_soak(root: str, seed: int, metanodes: int = 5,
                        dirs: int = 8, seed_files: int = 12,
                        creator_threads: int = 3, files_per_thread: int = 4000,
                        kill_delay_s: tuple = (0.05, 0.4),
                        settle_timeout_s: float = 120.0) -> dict:
    """Metadata scale-out chaos soak: crash-restart a metanode
    MID-SPLIT and MID-MIGRATION under live create load, over real daemon
    processes (ProcCluster — SIGKILL is the fault, WAL recovery + the
    master's resume/heal sweeps are the cure).

    Phases:
      1. seed a directory-heavy namespace (dirs interleaved with files so
         the median split balances directories);
      2. start creator threads (every ACKED create lands in a ledger);
      3. trigger a mid-range LOAD SPLIT of the dirs-heavy partition and,
         after a seeded delay, SIGKILL a metanode hosting it; respawn it;
         the split must finish — either the synchronous call won the race
         or the master's resume sweep drives it from the partition's
         replicated freeze record (heartbeat split reports);
      4. trigger a cross-metanode MIGRATION (rebalance_meta moves the
         hottest partition's replica to the spare metanode) and SIGKILL
         another metanode mid-dance; respawn; the master's
         ensure_replica_counts sweep heals any partial move;
      5. verify: ZERO created-file loss (every acked path stats and its
         dentry appears exactly once), NO double-owned inode (per-leader
         namespace dumps: every ino in exactly one partition, inside its
         view range), membership healed (3 peers per partition), and the
         kill timeline is visible via meta_split / meta_migrate events on
         the master journal (freeze -> commit -> complete causally
         ordered around the kill stamps).

    Raises SoakFailure on any violation; returns stats + the timeline."""
    import json as _json
    import threading

    from chubaofs_tpu_torch.master.api_service import MasterClient
    from chubaofs_tpu_torch.meta.service import RemoteMetaNode
    from chubaofs_tpu_torch.sdk.cluster import RemoteCluster
    from chubaofs_tpu_torch.testing.harness import ProcCluster
    from chubaofs_tpu_torch.tools.cfsstat import scrape

    rnd = random.Random(seed)
    vol = "soakvol"
    cluster = ProcCluster(root, masters=1, metanodes=metanodes, datanodes=0)
    stats = {"seed": seed, "creates_acked": 0, "creates_failed": 0,
             "kills": []}
    try:
        mc = cluster.client_master()
        mc.create_volume(vol, cold=True)
        fs0 = cluster.fs(vol)
        dir_inos = []
        for d in range(dirs):
            dir_inos.append(fs0.mkdirs(f"/d{d}"))
            for i in range(seed_files):
                fs0.create(f"/d{d}/seed{i}")
        ledger: list[str] = [f"/d{d}/seed{i}" for d in range(dirs)
                             for i in range(seed_files)]
        ledger_lock = threading.Lock()
        stop = threading.Event()

        def creator(t: int):
            fs = cluster.fs(vol)
            i = 0
            # runs until phase 5 stops it (the migrate phase needs LIVE
            # load in the heartbeat windows); files_per_thread is the
            # per-thread runaway cap bounding the ledger on a slow host
            while not stop.is_set() and i < files_per_thread:
                path = f"/d{(t + i) % dirs}/t{t}_f{i}"
                i += 1
                try:
                    fs.create(path)
                except Exception:
                    # NOT acked: never counted against data loss (the
                    # run_soak contract); a metanode kill can legitimately
                    # fail an op mid-election past the retry window
                    with ledger_lock:
                        stats["creates_failed"] += 1
                    continue
                with ledger_lock:
                    ledger.append(path)
                    stats["creates_acked"] += 1

        threads = [threading.Thread(target=creator, args=(t,), daemon=True)
                   for t in range(creator_threads)]
        for t in threads:
            t.start()

        def mps():
            return sorted(mc.meta_partitions(vol), key=lambda m: m["start"])

        def frozen_reported() -> bool:
            return any(n.get("splits")
                       for n in mc.get_cluster()["nodes"]
                       if n["kind"] == "meta")

        def await_settled(want_parts: int, what: str):
            deadline = time.monotonic() + settle_timeout_s
            last_view, last_frozen = None, None
            while time.monotonic() < deadline:
                try:
                    view = mps()
                    last_view, last_frozen = view, frozen_reported()
                    if len(view) >= want_parts and not last_frozen \
                            and all(len(m["peers"]) == 3 for m in view):
                        return view
                except Exception:
                    pass  # master mid-failover: poll again
                time.sleep(0.5)
            # diagnose from the LAST GOOD poll: the master may still be
            # flaky here, and a fresh RPC raising would replace this
            # SoakFailure with an unrelated ConnectionError
            raise SoakFailure(
                f"meta-split soak seed {seed}: {what} did not settle in "
                f"{settle_timeout_s:.0f}s (view: {last_view}, "
                f"frozen={last_frozen})")

        def kill_and_respawn(name: str, phase: str,
                             delay_range: tuple) -> None:
            delay = rnd.uniform(*delay_range)
            time.sleep(delay)
            t_kill = time.time()
            cluster.kill(name)
            stats["kills"].append({"phase": phase, "node": name,
                                   "delay_s": round(delay, 3),
                                   "ts": t_kill})
            time.sleep(rnd.uniform(0.2, 0.6))
            nid = int(name.replace("metanode", ""))
            cluster.spawn(name, cluster.metanode_cfg(nid))

        # -- phase 3: kill mid-split --------------------------------------
        target = mps()[0]
        peers = list(target["peers"])
        victim_id = rnd.choice(peers)
        split_res: dict = {}

        def do_split():
            try:
                split_res["new_pid"] = mc.split_meta_partition(
                    vol, target["partition_id"])["new_pid"]
            except Exception as e:  # the resume sweep owns completion
                split_res["error"] = str(e)

        splitter = threading.Thread(target=do_split, daemon=True)
        splitter.start()
        kill_and_respawn(f"metanode{victim_id}", "split", kill_delay_s)
        splitter.join(timeout=60)
        # a TAIL split chains a cursor split: expect >= 3 partitions
        view = await_settled(3, "split")
        stats["partitions_after_split"] = len(view)

        # -- phase 4: kill mid-migration ----------------------------------
        # make one partition's load dominate so rebalance_meta picks it,
        # then race the membership dance against a kill of a SURVIVOR peer
        mig_res: dict = {}

        def do_migrate():
            try:
                mig_res["moved"] = mc.rebalance_meta(
                    factor=0.5, max_moves=1)["moved"]
            except Exception as e:
                mig_res["error"] = str(e)

        migrator = threading.Thread(target=do_migrate, daemon=True)
        migrator.start()
        view = mps()
        peers_now = {p for m in view for p in m["peers"]}
        victim2 = rnd.choice(sorted(peers_now))
        kill_and_respawn(f"metanode{victim2}", "migrate", kill_delay_s)
        migrator.join(timeout=90)
        stats["migrate_moved"] = mig_res.get("moved", 0)
        stats["migrate_error"] = mig_res.get("error", "")
        view = await_settled(len(view), "migration heal")
        # the killed-mid-dance call may have moved nothing (raced the kill
        # or an empty load window): the migration half must still be
        # EXERCISED, so retry on the healed cluster until a replica moves
        # (creators keep the leaders' load windows nonzero)
        last_loads = None
        for _ in range(20):
            if stats["migrate_moved"]:
                break
            time.sleep(1.5)  # a heartbeat window of load accumulates
            try:
                res = mc.rebalance_meta(factor=0.5, max_moves=1)
                stats["migrate_moved"] = res["moved"]
                last_loads = res.get("loads")
            except Exception:
                continue
        if not stats["migrate_moved"]:
            # diagnose from the LAST GOOD attempt: a fresh RPC here could
            # raise against a still-flaky master and replace this
            # SoakFailure with an unrelated transport error
            raise SoakFailure(
                f"meta-split soak seed {seed}: rebalance_meta never moved "
                f"a replica (loads {last_loads})")
        view = await_settled(len(view), "post-retry migration heal")

        # -- phase 5: verification ----------------------------------------
        stop.set()
        for t in threads:
            t.join(timeout=120)
        with ledger_lock:
            acked = list(ledger)

        # zero created-file loss + exactly-once dentries
        census = RemoteCluster(cluster.master_addrs).client(vol)
        by_dir: dict[int, list[str]] = {}
        for path in acked:
            d = int(path.split("/")[1][1:])
            by_dir.setdefault(d, []).append(path.rsplit("/", 1)[1])
        for d, names in by_dir.items():
            listed = census.readdir(f"/d{d}")
            if len(listed) != len(set(listed)):
                raise SoakFailure(
                    f"meta-split soak seed {seed}: duplicate dentries "
                    f"in /d{d}")
            missing = set(names) - set(listed)
            if missing:
                raise SoakFailure(
                    f"meta-split soak seed {seed}: {len(missing)} acked "
                    f"file(s) LOST in /d{d}: {sorted(missing)[:5]}")
            for name in names[:: max(1, len(names) // 20)]:
                census.stat(f"/d{d}/{name}")  # resolvable end to end

        # no double-owned inode: per-leader namespace dumps
        view = mps()
        handles = {n["node_id"]: RemoteMetaNode(n["addr"])
                   for n in mc.get_cluster()["nodes"]
                   if n["kind"] == "meta" and n["addr"]}
        owner: dict[int, int] = {}
        try:
            for m in view:
                pid = m["partition_id"]
                end = m["end"] if m["end"] > 0 else (1 << 63)
                dump = None
                for _ in range(10):  # a fresh election may be settling
                    for p in m["peers"]:
                        try:
                            dump = handles[p].dump_namespace(pid)
                            break
                        except Exception:
                            continue
                    if dump is not None:
                        break
                    time.sleep(0.5)
                if dump is None:
                    raise SoakFailure(
                        f"meta-split soak seed {seed}: no leader dump for "
                        f"partition {pid}")
                for inode in dump["inodes"]:
                    ino = inode.ino
                    if not (m["start"] <= ino < end):
                        raise SoakFailure(
                            f"meta-split soak seed {seed}: partition {pid} "
                            f"holds out-of-range ino {ino} "
                            f"[{m['start']},{end})")
                    if ino in owner:
                        raise SoakFailure(
                            f"meta-split soak seed {seed}: ino {ino} "
                            f"DOUBLE-OWNED by partitions {owner[ino]} "
                            f"and {pid}")
                    owner[ino] = pid
        finally:
            for h in handles.values():
                h.close()
        stats["inodes_census"] = len(owner)

        # the kill timeline: meta_split freeze -> commit -> complete and
        # meta_migrate add_peer/remove_peer on the master journal
        evs = _json.loads(scrape(cluster.master_addrs[0],
                                 "/events?n=2000"))["events"]
        split_phases = [e["detail"].get("phase") for e in evs
                        if e["type"] == "meta_split"]
        for phase in ("freeze", "commit", "complete"):
            if phase not in split_phases:
                raise SoakFailure(
                    f"meta-split soak seed {seed}: no meta_split "
                    f"phase={phase} event on the master journal "
                    f"(saw {split_phases})")
        if stats["migrate_moved"]:
            mig_phases = [e["detail"].get("phase") for e in evs
                          if e["type"] == "meta_migrate"]
            for phase in ("add_peer", "remove_peer"):
                if phase not in mig_phases:
                    raise SoakFailure(
                        f"meta-split soak seed {seed}: no meta_migrate "
                        f"phase={phase} event (saw {mig_phases})")
        timeline = [{"t": e["ts"], "type": e["type"], "entity": e["entity"],
                     "phase": e["detail"].get("phase", "")}
                    for e in evs if e["type"] in ("meta_split",
                                                  "meta_migrate")]
        if stats["creates_acked"] == 0:
            raise SoakFailure(
                f"meta-split soak seed {seed}: zero creates acked under "
                f"chaos — the soak tested nothing")
        return {"plan": "meta_split", "ok": True, "timeline": timeline,
                "partitions": len(view), **stats}
    finally:
        cluster.close()


@_capture_on_failure
def run_cache_soak(root: str, seed: int, rounds: int = 4, objects: int = 12,
                   obj_kb: int = 32, gets_per_round: int = 24,
                   invalidate_delay: float = 0.05, promote_hits: int = 4,
                   cache_mb: int = 8, device=None) -> dict:
    """Cache-plane correctness soak: read-after-
    overwrite and read-after-delete through the tiered read cache, with the
    `cache.invalidate` failpoint DELAYING every punch-out — the write-
    through ordering (invalidate completes before the backend delete fans
    out) must carry correctness even when invalidation is slow.

    Per seeded round: zipfian GETs crc-verified against a per-key ledger
    (a cache or hot-tier read serving stale/torn bytes fails the soak),
    overwrites (new location PUT + old location delete, ledger re-keyed),
    hard deletes (every post-delete GET must error, never serve cached
    bytes), and a background tick so the deleter, scrubber, and tier
    promoter/demoter all run against the same traffic. promote_hits is
    tuned low so blobs cross into (and fall out of) the Replica3 hot
    engine DURING the soak — the crc ledger then also proves tier
    migration never changes bytes. `device` is the MiniCluster's codec
    device, as in run_soak."""
    import os as _os
    import zlib

    from chubaofs_tpu_torch.blobstore.access import AccessError
    from chubaofs_tpu_torch.blobstore.cache import BlobCache
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster

    rnd = random.Random(seed)
    cache = BlobCache(_os.path.join(root, "cache"), mem_mb=cache_mb,
                      promote_hits=promote_hits)
    c = MiniCluster(root, n_nodes=6, cache=cache, device=device)
    stats = {"gets": 0, "overwrites": 0, "deletes": 0, "delete_errors": 0}
    fp.arm("cache.invalidate", f"delay({invalidate_delay})")
    try:
        ledger: dict[int, tuple] = {}  # key -> (loc, crc)
        for k in range(objects):
            data = rnd.randbytes(obj_kb * 1024)
            ledger[k] = (c.access.put(data), zlib.crc32(data))
        weights = [1.0 / (r + 1) ** 1.1 for r in range(objects)]
        deleted: dict[int, object] = {}  # key -> dead location
        for rd in range(rounds):
            keys = sorted(ledger)
            for k in rnd.choices(keys, weights=weights[: len(keys)],
                                 k=gets_per_round):
                loc, crc = ledger[k]
                got = c.access.get(loc)
                stats["gets"] += 1
                if zlib.crc32(got) != crc:
                    raise SoakFailure(
                        f"cache soak seed {seed} round {rd}: key {k} served "
                        f"stale/corrupt bytes (crc mismatch)")
            # overwrite: the new location must serve the NEW bytes from its
            # first read — its fresh bids can never alias a cached entry
            for k in rnd.sample(sorted(ledger), k=min(2, len(ledger))):
                old_loc, _ = ledger[k]
                data = rnd.randbytes(obj_kb * 1024)
                new_loc = c.access.put(data)
                c.access.delete(old_loc)  # delayed punch-out via failpoint
                ledger[k] = (new_loc, zlib.crc32(data))
                stats["overwrites"] += 1
                if zlib.crc32(c.access.get(new_loc)) != ledger[k][1]:
                    raise SoakFailure(
                        f"cache soak seed {seed} round {rd}: key {k} read "
                        f"stale bytes immediately after overwrite")
            # hard delete: after the deleter punches the shards, the old
            # location must ERROR — cached bytes must not outlive the blob
            if len(ledger) > objects // 2:
                k = rnd.choice(sorted(ledger))
                loc, _ = ledger.pop(k)
                c.access.delete(loc)
                deleted[k] = loc
                stats["deletes"] += 1
            c.run_background_once()
            c.run_background_once()  # deleter + tier sweep both settle
            for k, loc in deleted.items():
                try:
                    c.access.get(loc)
                    raise SoakFailure(
                        f"cache soak seed {seed} round {rd}: deleted key {k} "
                        f"still readable (stale cache/tier copy)")
                except AccessError:
                    stats["delete_errors"] += 1
        return {
            "plan": "cache", "seed": seed, "ok": True, "rounds": rounds,
            "promoted_peak": len(c.cm.hot_blobs()),
            "cache_stats": cache.stats(), **stats,
        }
    finally:
        fp.disarm("cache.invalidate")
        c.close()
