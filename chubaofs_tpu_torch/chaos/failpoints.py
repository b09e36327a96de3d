"""Failpoint registry — named fault hooks with per-name actions.

Reference analog: the `github.com/pingcap/failpoint` pattern CubeFS uses in
its tests (mock-injected error codes, SURVEY §4) plus freebsd's
`fail_point(9)` action grammar. A call site is one line:

    chaos.failpoint("blobnode.get_shard", node=self.node_id)

and stays a near-free no-op (one empty-dict lookup) until a test or the
`CFS_FAILPOINTS` env spec arms the name with an action:

    off                 disarm
    error[(msg)]        raise FailpointError (a ConnectionError, so IO call
                        sites route it down their existing failure paths)
    drop                raise Dropped (fire-and-forget sites catch + skip)
    delay(seconds)      sleep, then proceed
    hang[(max_s)]       block until release() (bounded by max_s, default 300)
    corrupt             flip one payload byte (corrupt_bytes call sites)
    return(json)        hand the call site a value override

Each action takes optional suffixes: `@p` fires with probability p from a
per-arming seeded RNG (deterministic given the call sequence), `*n` fires
for the first n matching hits only, `#node` restricts to one node id.
Example spec: `raft.send=drop@0.1;blobnode.get_shard=hang*5#2` (suffix
order matters: `@prob`, then `*times`, then `#node`).
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
import zlib

_HANG_MAX_S = 300.0  # safety net: a forgotten release() must not wedge CI


class FailpointError(ConnectionError):
    """Injected failure. Subclasses ConnectionError so IO call sites that
    already tolerate connection loss route the injection down their real
    failure paths without chaos-specific handling."""

    def __init__(self, name: str, msg: str = ""):
        super().__init__(f"failpoint {name}: {msg or 'injected error'}")
        self.name = name


class Dropped(FailpointError):
    """Injected message loss — fire-and-forget sites catch this and skip."""


class _Arming:
    __slots__ = ("kind", "arg", "prob", "times", "node", "hits", "fired",
                 "rng", "gate")

    def __init__(self, kind: str, arg=None, prob: float = 1.0,
                 times: int | None = None, node: int | None = None,
                 seed: int | None = None, name: str = ""):
        self.kind = kind
        self.arg = arg
        self.prob = prob
        self.times = times
        self.node = node
        self.hits = 0   # call sites that matched this arming
        self.fired = 0  # times the action actually triggered
        # deterministic by default: the name itself seeds the RNG, so a
        # given call sequence makes identical probability decisions run-
        # over-run (the chaos scheduler's reproducibility contract)
        self.rng = random.Random(zlib.adler32(name.encode())
                                 if seed is None else seed)
        self.gate = threading.Event()  # hang-until-released

    def describe(self) -> str:
        s = self.kind
        if self.arg is not None:
            s += f"({self.arg})"
        if self.prob < 1.0:
            s += f"@{self.prob}"
        if self.times is not None:
            s += f"*{self.times}"
        if self.node is not None:
            s += f"#{self.node}"
        return s


# name -> [armings]. The EMPTY dict is the entire unarmed fast path:
# failpoint() does one .get() against it and returns.
_ARMS: dict[str, list[_Arming]] = {}
_LOCK = threading.Lock()
# cumulative per-name counters, surviving disarm (a lifted fault's evidence
# must outlive the fault); cleared only by reset()
_TOTAL_HITS: dict[str, int] = {}
_TOTAL_FIRED: dict[str, int] = {}


def failpoint(name: str, node: int | None = None):
    """Evaluate a failpoint site. Returns None (proceed), raises
    FailpointError/Dropped, sleeps, hangs, or returns the matched _Arming
    for `corrupt`/`return` kinds (the call site interprets those)."""
    arms = _ARMS.get(name)
    if arms is None:
        return None
    return _fire(name, arms, node)


def _fire(name: str, arms: list[_Arming], node: int | None):
    act = None
    with _LOCK:
        for a in arms:
            if a.node is not None and a.node != node:
                continue
            a.hits += 1
            _TOTAL_HITS[name] = _TOTAL_HITS.get(name, 0) + 1
            if a.times is not None and a.fired >= a.times:
                continue
            if a.prob < 1.0 and a.rng.random() >= a.prob:
                continue
            a.fired += 1
            _TOTAL_FIRED[name] = _TOTAL_FIRED.get(name, 0) + 1
            act = a
            break
    if act is None:
        return None
    kind = act.kind
    if kind == "error":
        raise FailpointError(name, str(act.arg or ""))
    if kind == "drop":
        raise Dropped(name, "dropped")
    if kind == "delay":
        time.sleep(float(act.arg or 0.0))
        return None
    if kind == "hang":
        act.gate.wait(timeout=float(act.arg) if act.arg else _HANG_MAX_S)
        return None
    return act  # corrupt / return: the call site interprets


def corrupt_bytes(name: str, data: bytes, node: int | None = None) -> bytes:
    """Payload-corruption site: returns `data` with one byte flipped when
    the name is armed with `corrupt` (deterministic offset from the
    arming's RNG), `data` unchanged otherwise. Other kinds (error/delay/
    hang/drop) fire exactly as at a plain failpoint."""
    arms = _ARMS.get(name)
    if arms is None:
        return data
    act = _fire(name, arms, node)
    if act is None or act.kind != "corrupt" or not data:
        return data
    with _LOCK:
        pos = act.rng.randrange(len(data))
    out = bytearray(data)
    out[pos] ^= 0xFF
    return bytes(out)


# -- arming control ------------------------------------------------------------

_KINDS = {"off", "error", "drop", "delay", "hang", "corrupt", "return"}


def arm(name: str, action: str, node: int | None = None,
        times: int | None = None, prob: float | None = None,
        seed: int | None = None) -> None:
    """Arm `name` with an action spec (e.g. "delay(0.5)", "drop@0.1",
    "hang", "error(wedged)*3"). Explicit kwargs override spec suffixes.
    Arming the same name again stacks (first matching arming wins), so a
    per-node arming can coexist with a global one."""
    kind, arg, sprob, stimes, snode = _parse_action(action)
    if kind == "off":
        disarm(name, node=node if node is not None else snode)
        return
    a = _Arming(kind, arg=arg,
                prob=prob if prob is not None else sprob,
                times=times if times is not None else stimes,
                node=node if node is not None else snode,
                seed=seed, name=name)
    with _LOCK:
        _ARMS.setdefault(name, []).append(a)
    # arming is a state transition the forensics timeline needs: an injected
    # fault and its downstream detections then sort onto ONE timeline.
    # Lazy import keeps the unarmed failpoint() fast path untouched.
    from chubaofs_tpu_torch.utils import events

    events.emit("failpoint_armed", events.SEV_WARNING, entity=name,
                detail={"name": name, "action": a.describe()})


def disarm(name: str | None = None, node: int | None = None) -> None:
    """Disarm one name (optionally only its per-`node` armings) or, with no
    name, everything. Hung waiters of removed armings are released."""
    removed: list[str] = []
    with _LOCK:
        names = [name] if name is not None else list(_ARMS)
        for n in names:
            arms = _ARMS.get(n)
            if arms is None:
                continue
            keep = [] if node is None else [a for a in arms if a.node != node]
            for a in arms:
                if a not in keep:
                    a.gate.set()
            if len(keep) < len(arms):
                removed.append(n)
            if keep:
                _ARMS[n] = keep
            else:
                _ARMS.pop(n, None)
    if removed:
        from chubaofs_tpu_torch.utils import events

        for n in removed:
            events.emit("failpoint_disarmed", entity=n,
                        detail={"name": n,
                                **({"node": node} if node is not None
                                   else {})})


def release(name: str | None = None) -> None:
    """Release hang-until-released waiters (the arming stays armed; later
    hits pass straight through the opened gate)."""
    with _LOCK:
        for n, arms in _ARMS.items():
            if name is None or n == name:
                for a in arms:
                    a.gate.set()


def hits(name: str) -> int:
    """Call-site evaluations that matched an arming of `name` (including
    budget/probability misses) since the last reset() — cumulative across
    disarms, so a lifted fault's evidence survives its lift."""
    with _LOCK:
        return _TOTAL_HITS.get(name, 0)


def fired(name: str) -> int:
    """Times an action of `name` actually triggered since the last reset()."""
    with _LOCK:
        return _TOTAL_FIRED.get(name, 0)


def armed() -> dict[str, list[str]]:
    with _LOCK:
        return {n: [a.describe() for a in arms] for n, arms in _ARMS.items()}


def reset() -> None:
    """Disarm everything, release all waiters, zero counters (teardown)."""
    disarm()
    with _LOCK:
        _TOTAL_HITS.clear()
        _TOTAL_FIRED.clear()


# -- spec grammar --------------------------------------------------------------


def _parse_action(spec: str):
    """`kind[(arg)][@prob][*times][#node]` -> (kind, arg, prob, times, node)."""
    s = spec.strip()
    node = times = None
    prob = 1.0
    if "#" in s:
        s, _, tail = s.rpartition("#")
        node = int(tail)
    if "*" in s:
        s, _, tail = s.rpartition("*")
        times = int(tail)
    if "@" in s:
        s, _, tail = s.rpartition("@")
        prob = float(tail)
        if not 0.0 <= prob <= 1.0:
            raise ValueError(f"failpoint probability {prob} outside [0, 1]")
    arg = None
    if "(" in s:
        if not s.endswith(")"):
            raise ValueError(f"unterminated action args in {spec!r}")
        s, _, inner = s.partition("(")
        arg = inner[:-1]
    kind = s.strip()
    if kind not in _KINDS:
        raise ValueError(f"unknown failpoint action {kind!r} in {spec!r}")
    if kind == "delay":
        arg = float(arg if arg is not None else 0.0)
    elif kind == "hang" and arg is not None:
        arg = float(arg)
    elif kind == "return":
        arg = json.loads(arg) if arg else None
    return kind, arg, prob, times, node


def load_spec(spec: str) -> int:
    """Parse a `name=action[;name=action...]` spec and arm every entry;
    returns the number of entries armed."""
    n = 0
    for entry in spec.split(";"):
        entry = entry.strip()
        if not entry:
            continue
        if "=" not in entry:
            raise ValueError(f"failpoint entry {entry!r} has no '=' action")
        name, _, action = entry.partition("=")
        arm(name.strip(), action)
        n += 1
    return n


def load_env(env_var: str = "CFS_FAILPOINTS") -> int:
    """Arm the spec in `env_var` (daemon subprocesses inherit harness
    faults this way). Silent no-op when unset."""
    spec = os.environ.get(env_var, "")
    return load_spec(spec) if spec else 0
