"""Per-tenant QoS/admission plane for the S3 gateway.

Reference counterparts: blobstore/access/limiter.go (read/write bandwidth +
concurrency gates on the gateway) and the reference object gateway's
per-user traffic shaping — one abusive tenant must not flip every tenant's
SLO burn windows (the mixed-tenant regimes of arxiv 1709.05365 are the
workload model `cfs-capacity` drives).

Shape:

  * Tenant identity is the sigv4 ACCESS KEY the request claims (parsed
    pre-auth by `objectnode.auth.access_key_of`) — shaping runs BEFORE the
    signature check on purpose: throttling must cost less than the HMAC
    chain it protects. A spoofed key burns the spoofed tenant's budget; the
    signature check still rejects the request afterward, exactly like the
    reference gateways that shape on the parsed credential.
  * Two resources, each a `FairLimiter`: request RATE (cost 1/request) and
    BANDWIDTH (cost = body bytes in; response bytes are debited post-hoc,
    driving the bucket negative until the debt refills). Each limiter is a
    shared PARENT token bucket (the total cap) plus optional per-tenant
    child buckets (hard caps). Idle capacity is work-conserving: a lone
    tenant can use the whole parent; under saturation a deficit-style
    round-robin queue grants parent tokens fairly across the tenants
    waiting, so the noisy tenant queues behind its own backlog while the
    victim's occasional request is granted almost immediately.
  * Hard denials answer 429 (caps, queue timeout) or 503 (queue overflow)
    with a `Retry-After` estimate from the bucket's refill rate.
  * Observability: `cfs_objectnode_requests{tenant}`,
    `cfs_objectnode_throttled{tenant,bucket,reason}`,
    `cfs_objectnode_bytes{tenant,dir}` — tenant label values BOUNDED via
    `exporter.declare_label_values` (declared tenants + "other" +
    "anonymous"; undeclared keys fold into "other", so an attacker minting
    random access keys cannot mint metric series). A `qos_throttle` event
    (rate-limited to one per tenant+bucket per second) lands on the
    timeline with the deficit in the detail dict, and per-tenant
    throttle-ratio SLOs ride utils/slo.py's provider hook so ONLY the
    abusive tenant's objective flips.

Knobs (all unset = plane dormant, zero per-request overhead — the
middleware is simply never installed):

    CFS_QOS_RPS             total request-rate cap, requests/s (parent)
    CFS_QOS_BW_MB           total bandwidth cap, MiB/s (parent)
    CFS_QOS_TENANT_RPS      per-tenant hard request-rate cap (child)
    CFS_QOS_TENANT_BW_MB    per-tenant hard bandwidth cap (child)
    CFS_QOS_TENANT_MIN_RPS  per-tenant GUARANTEED request rate (reserve
                            child bucket — admitted without queueing; size
                            sum(guarantees) <= the parent cap)
    CFS_QOS_TENANT_MIN_BW_MB  per-tenant guaranteed bandwidth
    CFS_QOS_TENANTS       comma-separated declared tenant access keys
    CFS_QOS_QUEUE_MS      max fair-queue wait when saturated (default 200)
    CFS_QOS_QUEUE         max queued requests per tenant (default 64)
    CFS_SLO_QOS_THROTTLE  per-tenant SLO threshold on throttled/requests
                          (default 0.5), read at evaluation time
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from chubaofs_tpu_torch.utils.locks import SanitizedLock
from chubaofs_tpu_torch.utils.ratelimit import TokenBucket

ANON = "anonymous"
OTHER = "other"

# bandwidth DRR quantum: enough for a small op per turn, so mixed small/large
# tenants still alternate instead of a large op starving the wheel
_BW_QUANTUM = 64 << 10


def _env_f(name: str, default: float = 0.0) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_i(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, "") or default))
    except ValueError:
        return default


class Decision:
    """One admission verdict. `ok` admits; otherwise `status`/`reason`/
    `retry_after`/`deficit` describe the throttle for the reply, the
    metrics, and the timeline event."""

    __slots__ = ("ok", "status", "bucket", "reason", "retry_after", "deficit",
                 "queued_ms")

    def __init__(self, ok: bool, status: int = 0, bucket: str = "",
                 reason: str = "", retry_after: float = 0.0,
                 deficit: float = 0.0, queued_ms: float = 0.0):
        self.ok = ok
        self.status = status
        self.bucket = bucket
        self.reason = reason
        self.retry_after = retry_after
        self.deficit = deficit
        self.queued_ms = queued_ms


_OK = Decision(True)

# every live plane in this process: the bounded 'tenant' label declaration
# is the union of their label sets (see QosPlane.__init__/close)
_active_planes: list = []
_planes_lock = threading.Lock()


def _redeclare_tenants_locked() -> None:
    from chubaofs_tpu_torch.utils.exporter import declare_label_values

    if not _active_planes:
        declare_label_values("tenant", None)
        return
    union: set = set()
    for p in _active_planes:
        union |= p._labels
    declare_label_values("tenant", sorted(union))


class FairLimiter:
    """One resource's shared-parent + per-tenant-child shaping with a
    deficit-round-robin wait queue.

    Admission: the per-tenant HARD cap (child bucket) is checked first —
    a capped tenant is denied outright, no queueing (it asked for more
    than it bought). Then the shared parent: free tokens admit
    immediately WHEN NOBODY IS QUEUED (no line-jumping); a saturated
    parent parks the request in its tenant's FIFO and a deficit-style
    round-robin pump grants refilling parent tokens one tenant at a time,
    so capacity under contention splits fairly regardless of offered
    load. Bounded wait (`queue_ms`) then 429; bounded queue depth then
    503."""

    def __init__(self, name: str, parent_rate: float, tenant_rate: float,
                 reserve_rate: float = 0.0, quantum: float = 1.0,
                 queue_ms: float = 200.0, queue_len: int = 64):
        self.name = name  # "rate" | "bandwidth" (the metric/event label)
        self.parent = TokenBucket(parent_rate) if parent_rate > 0 else None
        self.tenant_rate = tenant_rate      # per-tenant HARD cap
        self.reserve_rate = reserve_rate    # per-tenant GUARANTEED share
        self.quantum = quantum
        self.queue_ms = queue_ms
        self.queue_len = queue_len
        self._children: dict[str, TokenBucket] = {}
        self._reserves: dict[str, TokenBucket] = {}
        self._queues: dict[str, deque] = {}
        self._rr: deque = deque()          # tenants with queued waiters
        self._deficit: dict[str, float] = {}
        self._waiting = 0                  # waiters currently parked
        # each parked waiter occupies an evloop dispatch worker for up to
        # queue_ms: bound the herd to HALF the worker pool so a shaped
        # flood's queue can never starve the workers that serve admitted
        # (reserve-bucket) requests
        self.max_waiting = max(4, _env_i("CFS_EVLOOP_WORKERS", 16) // 2)
        self._lock = SanitizedLock(name=f"qos.{name}")

    def _bucket(self, table: dict, tenant: str, rate: float) \
            -> TokenBucket | None:
        if rate <= 0:
            return None
        with self._lock:
            b = table.get(tenant)
            if b is None:
                b = table[tenant] = TokenBucket(rate)
            return b

    @staticmethod
    def _take(bucket: TokenBucket, cost: float) -> bool:
        """Acquire `cost` from a bucket whose burst may be SMALLER than the
        cost (a 20 MiB PUT under a 10 MiB/s cap): acquire the burst's
        worth and debit the remainder, so the big op is admitted once and
        PACED by the debt it leaves — never permanently unadmittable
        (try_acquire(cost>burst) would be False forever, the trap
        TokenBucket.acquire's own `n > burst` guard documents)."""
        take = min(cost, bucket.burst)
        if not bucket.try_acquire(take):
            return False
        if cost > take:
            bucket.debit(cost - take)
        return True

    def debit(self, tenant: str, cost: float) -> None:
        """Post-hoc charge (response bytes): every configured bucket the
        tenant draws from goes negative and pays the debt down at its
        refill rate."""
        for b in (self._bucket(self._reserves, tenant, self.reserve_rate),
                  self._bucket(self._children, tenant, self.tenant_rate),
                  self.parent):
            if b is not None:
                b.debit(cost)

    def admit(self, tenant: str, cost: float) -> Decision:
        child = self._bucket(self._children, tenant, self.tenant_rate)
        if child is not None and not self._take(child, cost):
            wait = child.wait_time(min(cost, child.burst))
            return Decision(False, 429, self.name, "tenant_cap",
                            retry_after=wait,
                            deficit=wait * max(self.tenant_rate, 1.0))
        # the tenant's GUARANTEED share (child reserve bucket): admitted
        # without touching the parent or the queue, so a within-guarantee
        # tenant never waits behind a noisy neighbor's backlog — the victim
        # p99 protection. Sizing sum(reserves) <= parent is the operator's
        # contract (the borrow pool is what's left)
        reserve = self._bucket(self._reserves, tenant, self.reserve_rate)
        if reserve is not None and self._take(reserve, cost):
            return _OK
        if self.parent is None:
            return _OK
        # the queued cost is clamped to the parent's burst (the pump grants
        # it and the remainder is debited at grant time) — a cost the
        # parent could never accrue would otherwise wait out queue_ms for
        # a grant that cannot happen
        pcost = min(cost, self.parent.burst)
        with self._lock:
            if not self._rr and self._take(self.parent, cost):
                return _OK  # free capacity, nobody queued: no line-jump risk
            q = self._queues.setdefault(tenant, deque())
            if len(q) >= self.queue_len:
                return Decision(False, 503, self.name, "queue_full",
                                retry_after=self.parent.wait_time(pcost),
                                deficit=float(len(q)))
            # every queued waiter PARKS a dispatch worker for up to
            # queue_ms; bound the herd below the evloop pool or a shaped
            # flood starves the very tenants admission just protected
            if self._waiting >= self.max_waiting:
                return Decision(False, 429, self.name, "saturated",
                                retry_after=max(0.05,
                                                self.parent.wait_time(pcost)),
                                deficit=float(self._waiting))
            self._waiting += 1
            ev = threading.Event()
            # [event, parent-clamped cost, granted, debit-remainder]
            waiter = [ev, pcost, False, cost - pcost]
            q.append(waiter)
            if tenant not in self._rr:
                self._rr.append(tenant)
        t0 = time.monotonic()
        deadline = t0 + self.queue_ms / 1e3
        while True:
            self._pump()
            if waiter[2]:
                return Decision(True, queued_ms=(time.monotonic() - t0) * 1e3)
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            # grants arrive via ev.set() from whichever waiter's pump runs;
            # the tick only exists so SOMEONE pumps as tokens refill. 20ms
            # keeps a saturated tenant's waiter herd from becoming a GIL
            # wakeup storm that the admitted tenants' tail latency pays for
            ev.wait(min(remaining, 0.02))
        with self._lock:
            granted = waiter[2]
            if not granted:
                try:
                    self._queues.get(tenant, deque()).remove(waiter)
                    self._waiting -= 1
                except ValueError:
                    granted = waiter[2]  # pump won the race after all
        if granted:
            return Decision(True, queued_ms=(time.monotonic() - t0) * 1e3)
        return Decision(False, 429, self.name, "saturated",
                        retry_after=max(0.05, self.parent.wait_time(pcost)),
                        deficit=self._deficit.get(tenant, 0.0))

    def _pump(self) -> None:
        """Grant refilled parent tokens to queued waiters, deficit-RR order:
        each pass around the wheel tops every waiting tenant's deficit up by
        one quantum and grants its head-of-line while the deficit and the
        parent both cover the cost — cost-fair across tenants whatever their
        op-size mix. Runs under the limiter lock; every waiter tick calls
        it, so refill progress needs no dedicated thread."""
        with self._lock:
            misses = 0
            while self._rr and misses < len(self._rr):
                t = self._rr[0]
                q = self._queues.get(t)
                if not q:
                    self._rr.popleft()
                    self._queues.pop(t, None)
                    self._deficit.pop(t, None)
                    continue
                self._deficit[t] = min(
                    self._deficit.get(t, 0.0) + self.quantum,
                    max(self.quantum, q[0][1]))
                if q[0][1] <= self._deficit[t] \
                        and self.parent.try_acquire(q[0][1]):
                    waiter = q.popleft()
                    self._deficit[t] -= waiter[1]
                    waiter[2] = True
                    if waiter[3]:  # burst-clamped cost: debit the rest so
                        self.parent.debit(waiter[3])  # the big op is paced
                    waiter[0].set()
                    self._waiting -= 1
                    misses = 0
                    # the serviced tenant goes to the BACK and the wheel
                    # position PERSISTS across pump calls — tokens that
                    # trickle in one at a time then alternate across
                    # waiting tenants instead of feeding whoever sits at
                    # the wheel's head (the whole fairness property)
                    if q:
                        self._rr.rotate(-1)
                    else:
                        self._rr.popleft()
                        self._queues.pop(t, None)
                        self._deficit.pop(t, None)
                else:
                    # can't serve this tenant NOW (deficit short or parent
                    # dry): let the others try this pass; capped deficits
                    # keep the repeated top-ups from accruing unfairly
                    self._rr.rotate(-1)
                    misses += 1


class QosPlane:
    """The gateway-side plane: admit/debit around every S3 request, wired
    as router middleware by objectnode when armed. Construction declares
    the bounded tenant label set, registers the per-tenant SLO provider,
    and mints the cfs_objectnode_* families; `close()` unwinds all of it
    (test hygiene)."""

    def __init__(self, tenants: tuple = (), rps: float = 0.0,
                 bw_mbs: float = 0.0, tenant_rps: float = 0.0,
                 tenant_bw_mbs: float = 0.0, tenant_min_rps: float = 0.0,
                 tenant_min_bw_mbs: float = 0.0, queue_ms: float = 200.0,
                 queue_len: int = 64):
        from chubaofs_tpu_torch.utils import slo
        from chubaofs_tpu_torch.utils.exporter import declare_label_values, registry

        self.tenants = tuple(tenants)
        self._labels = frozenset(self.tenants) | {ANON, OTHER}
        self.rate = FairLimiter("rate", rps, tenant_rps,
                                reserve_rate=tenant_min_rps, quantum=1.0,
                                queue_ms=queue_ms, queue_len=queue_len) \
            if (rps > 0 or tenant_rps > 0) else None
        self.bw = FairLimiter("bandwidth", bw_mbs * (1 << 20),
                              tenant_bw_mbs * (1 << 20),
                              reserve_rate=tenant_min_bw_mbs * (1 << 20),
                              quantum=_BW_QUANTUM,
                              queue_ms=queue_ms, queue_len=queue_len) \
            if (bw_mbs > 0 or tenant_bw_mbs > 0) else None
        self._reg = registry("objectnode")
        self._last_event: dict[tuple, float] = {}
        self._ev_lock = SanitizedLock(name="qos.events")
        # global surfaces (the bounded tenant label set, the SLO provider
        # table) are shared by every plane in the process — tests and
        # multi-gateway processes run several. Each plane registers under
        # its own key and the label declaration is the UNION of the active
        # planes', so constructing/closing one can neither 500 another's
        # admit() (undeclared-label ValueError) nor unregister its SLOs.
        with _planes_lock:
            _active_planes.append(self)
            _redeclare_tenants_locked()
        slo.register_slo_provider(f"qos:{id(self)}", self._slos)

    @classmethod
    def from_env(cls) -> "QosPlane | None":
        """CFS_QOS_*-armed plane, or None (the default: not installed, zero
        per-request overhead)."""
        rps = _env_f("CFS_QOS_RPS")
        bw = _env_f("CFS_QOS_BW_MB")
        t_rps = _env_f("CFS_QOS_TENANT_RPS")
        t_bw = _env_f("CFS_QOS_TENANT_BW_MB")
        if rps <= 0 and bw <= 0 and t_rps <= 0 and t_bw <= 0:
            return None
        tenants = tuple(t for t in
                        os.environ.get("CFS_QOS_TENANTS", "").split(",") if t)
        return cls(tenants, rps=rps, bw_mbs=bw, tenant_rps=t_rps,
                   tenant_bw_mbs=t_bw,
                   tenant_min_rps=_env_f("CFS_QOS_TENANT_MIN_RPS"),
                   tenant_min_bw_mbs=_env_f("CFS_QOS_TENANT_MIN_BW_MB"),
                   queue_ms=_env_f("CFS_QOS_QUEUE_MS", 200.0),
                   queue_len=int(_env_f("CFS_QOS_QUEUE", 64.0)))

    def close(self) -> None:
        from chubaofs_tpu_torch.utils import slo

        slo.unregister_slo_provider(f"qos:{id(self)}")
        with _planes_lock:
            if self in _active_planes:
                _active_planes.remove(self)
            _redeclare_tenants_locked()

    # -- admission -------------------------------------------------------------

    def label(self, tenant: str | None) -> str:
        """Bounded metric/SLO label for a claimed access key: declared keys
        keep their identity, everything else folds into OTHER (an attacker
        minting random keys cannot mint series), no key at all is ANON."""
        if tenant is None:
            return ANON
        return tenant if tenant in self._labels else OTHER

    def admit(self, tenant: str | None, nbytes: int = 0):
        """Admit or throttle one request: returns None to proceed, or an
        rpc Response (429/503 + Retry-After) to answer instead. `tenant`
        is the claimed access key (None = anonymous); `nbytes` the request
        body size (the PUT-side bandwidth cost — response bytes are
        debited via debit_out)."""
        label = self.label(tenant)
        self._reg.counter("requests", {"tenant": label}).add()
        decision = _OK
        if self.rate is not None:
            decision = self.rate.admit(label, 1.0)
        if decision.ok and self.bw is not None and nbytes > 0:
            decision = self.bw.admit(label, float(nbytes))
        if decision.ok:
            if nbytes:
                self._reg.counter("bytes",
                                  {"tenant": label, "dir": "in"}).add(nbytes)
            if decision.queued_ms:
                self._reg.summary("queue_wait_ms").observe(decision.queued_ms)
            return None
        self._reg.counter("throttled",
                          {"tenant": label, "bucket": decision.bucket,
                           "reason": decision.reason}).add()
        self._emit_throttle(label, decision)
        retry = max(1, int(decision.retry_after + 0.999))
        from chubaofs_tpu_torch.rpc.router import Response

        return Response(
            decision.status,
            {"Content-Type": "application/xml", "Retry-After": str(retry)},
            (f"<?xml version=\"1.0\"?><Error><Code>SlowDown</Code>"
             f"<Message>tenant {label} throttled: {decision.reason} "
             f"({decision.bucket})</Message></Error>").encode())

    def debit_out(self, tenant: str | None, nbytes: int) -> None:
        """Charge response bytes (GET bodies) against the bandwidth plane
        after the fact — the bucket goes negative and future admits wait."""
        if nbytes <= 0:
            return
        label = self.label(tenant)
        self._reg.counter("bytes", {"tenant": label, "dir": "out"}).add(nbytes)
        if self.bw is not None:
            self.bw.debit(label, float(nbytes))

    def _emit_throttle(self, label: str, decision: Decision) -> None:
        """qos_throttle -> timeline, rate-limited to one per tenant+bucket
        per second: the journal records the EPISODE, the counter the
        per-op volume."""
        now = time.monotonic()
        key = (label, decision.bucket)
        with self._ev_lock:
            if now - self._last_event.get(key, -9e9) < 1.0:
                return
            self._last_event[key] = now
        from chubaofs_tpu_torch.utils import events

        events.emit("qos_throttle", events.SEV_WARNING, entity=label,
                    detail={"tenant": label, "bucket": decision.bucket,
                            "reason": decision.reason,
                            "deficit": round(decision.deficit, 3),
                            "retry_after": round(decision.retry_after, 3)})

    # -- per-tenant SLOs --------------------------------------------------------

    def _slos(self) -> list:
        """One throttle-ratio objective per declared tenant (+ OTHER/ANON):
        throttled/requests over the burn windows, so a capped noisy tenant
        flips ITS objective while the victim's stays green — the fairness
        verdict cfs-capacity's gate reads."""
        from chubaofs_tpu_torch.utils.slo import SLO

        thr = _env_f("CFS_SLO_QOS_THROTTLE", 0.5)
        return [
            SLO(f"qos_throttle:{t}", "counter_ratio",
                "cfs_objectnode_throttled", thr,
                ops_family="cfs_objectnode_requests",
                label_in=("tenant", (t,)),
                description=f"tenant {t} throttled-request ratio")
            for t in sorted(self._labels)
        ]
