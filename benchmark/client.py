"""The benchmark's HTTP client: a separate process that speaks the blobstore
gateway's documented surface over loopback and imports nothing of the port.

    PUT /put                       body: the object -> 200, a Location token
    GET /get?location=<token>      -> 200, the whole object
    GET /get?location=<token>      Range: bytes=lo-hi -> 206, Content-Range

`python benchmark/client.py <job.json>` runs one phase of a run:

  * `preload`: PUT the mix's dataset, `clients` at a time, and write every
    object's Location;
  * `window`: make the window's payloads, send the warm-up requests, print
    READY, wait for GO on stdin, then drive the mix's streams for `seconds`
    (open-loop PUTs, GETs and range pairs, each paced from its schedule; a
    range_pairs stream carries its `plan`, which the run builds from the
    stored layout after the loss), wait for every request issued, write one
    record per request and print DONE.

Every time is time.monotonic(), which all processes of the host share.
Every GET answer is compared with the object's bytes when it arrives; the
verdicts are read after the window.
"""

from __future__ import annotations

import http.client
import json
import os
import queue
import sys
import threading
import time
import urllib.parse
from dataclasses import asdict

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import traffic  # noqa: E402

ERRORS = (OSError, http.client.HTTPException)


class Conn:
    """One keep-alive connection to the gateway, reopened after an error."""

    def __init__(self, addr: str):
        self.host, port = addr.rsplit(":", 1)
        self.port = int(port)
        self.c = None

    def request(self, method: str, target: str, body=None, headers=None):
        if self.c is None:
            self.c = http.client.HTTPConnection(self.host, self.port, timeout=120)
        try:
            self.c.request(method, target, body=body, headers=headers or {})
            r = self.c.getresponse()
            return r.status, dict(r.getheaders()), r.read()
        except ERRORS:
            self.c.close()
            self.c = None
            raise

    def put(self, data: np.ndarray) -> tuple[int, str]:
        """(status, Location token or error text)."""
        try:
            status, _, body = self.request("PUT", "/put", body=memoryview(data))
        except ERRORS as e:
            return -1, repr(e)
        return status, body.decode("utf-8", "replace")

    def get(self, token: str, offset: int, length: int | None):
        target = "/get?location=" + urllib.parse.quote(token, safe="")
        headers = {} if length is None else {"Range": f"bytes={offset}-{offset + length - 1}"}
        try:
            return self.request("GET", target, headers=headers)
        except ERRORS as e:
            return -1, {}, repr(e).encode()


def run_threads(fn, n: int) -> None:
    threads = [threading.Thread(target=fn, args=(i,), daemon=True) for i in range(n)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()


def preload(job: dict) -> dict:
    mix, seed = job["mix"], job["seed"]
    n, clients = mix["preload"]["objects"], mix["preload"]["clients"]
    sizes = traffic.sizes(mix["preload"]["sizes"], n, seed, traffic.PRELOAD)
    locs: list = [None] * n
    errors: list = []

    def client(i: int):
        conn = Conn(job["addr"])
        for idx in range(i, n, clients):
            status, ans = conn.put(traffic.payload(seed, traffic.PRELOAD, idx, sizes[idx]))
            if status == 200:
                locs[idx] = ans
            else:
                errors.append(f"preload PUT {idx} ({sizes[idx]} B): {status} {ans[:200]}")

    run_threads(client, clients)
    return {"sizes": sizes, "locations": locs, "errors": errors}


def paced(addr: str, sched: list, t0: float, senders: int, send) -> float:
    """Open loop: a pacer thread hands each (due_s, item) of `sched` to
    `senders` workers when it is due (t0 + due_s); a worker calls
    send(conn, item, due). Returns how late the pacer ran at most."""
    q: queue.Queue = queue.Queue()
    late = 0.0

    def pace():
        nonlocal late
        for due_s, item in sched:
            due = t0 + due_s
            if (wait := due - time.monotonic()) > 0:
                time.sleep(wait)
            late = max(late, time.monotonic() - due)
            q.put((item, due))
        for _ in range(senders):
            q.put(None)

    def sender(_: int):
        conn = Conn(addr)
        while (got := q.get()) is not None:
            send(conn, *got)

    pacer = threading.Thread(target=pace, daemon=True)
    pacer.start()
    run_threads(sender, senders)
    pacer.join()
    return late


class PutStream:
    """Open-loop PUTs; a PUT's latency runs from when it was due to its
    answer."""

    def __init__(self, job: dict, stream: dict):
        self.job, self.stream = job, stream
        seed = job["seed"]
        self.sched = traffic.put_schedule(stream, seed, job["seconds"])
        self.bodies = [traffic.payload(seed, traffic.WINDOW, p.idx, p.size) for p in self.sched]

    def _drive(self, sched, bodies, t0: float, records: list) -> float:
        def send(conn: Conn, item, due: float):
            p, body = item
            status, ans = conn.put(body)
            records.append({"op": "put", "idx": p.idx, "size": p.size, "due": due,
                            "done": time.monotonic(), "status": status,
                            "loc": ans if status == 200 else None,
                            "err": None if status == 200 else ans[:300]})

        return paced(self.job["addr"], [(p.due_s, (p, b)) for p, b in zip(sched, bodies)],
                     t0, self.stream["senders"], send)

    def warm(self, records: list) -> None:
        """One PUT of each warm-up size (every policy band and shard bucket
        the window will use), all due at once."""
        seed = self.job["seed"]
        sched = [traffic.Put(0.0, i, s) for i, s in enumerate(self.job["warm_put_sizes"])]
        bodies = [traffic.payload(seed, traffic.WARM, p.idx, p.size) for p in sched]
        self._drive(sched, bodies, time.monotonic(), records)

    def run(self, t0: float, records: list) -> float:
        return self._drive(self.sched, self.bodies, t0, records)


class GetStream:
    """Open-loop GETs over the preloaded dataset; a GET's latency runs from
    when it was due to its last byte. Each answer is compared with the
    object's bytes on arrival."""

    def __init__(self, job: dict, stream: dict):
        self.job, self.stream = job, stream
        self.sizes = job["dataset"]["sizes"]
        self.locs = job["dataset"]["locations"]
        self.data = [traffic.payload(job["seed"], traffic.PRELOAD, k, s)
                      for k, s in enumerate(self.sizes)]
        self.sched, self.warm_reqs = self.plan()

    def plan(self) -> tuple[list, list]:
        """(the window's (due time, request) schedule, the warm-up GETs)."""
        seed = self.job["seed"]
        return (traffic.get_schedule(self.stream, self.sizes, seed, self.job["seconds"]),
                traffic.warm_gets(self.stream, self.sizes, seed))

    def _one(self, conn: Conn, g: traffic.Get, records: list, due: float | None = None) -> None:
        sent = time.monotonic()
        status, headers, body = conn.get(self.locs[g.key], g.offset, g.length)
        done = time.monotonic()
        size = self.sizes[g.key]
        if g.length is None:
            want_status, want_range, lo, hi = 200, None, 0, size
        else:
            lo, hi = g.offset, g.offset + g.length
            want_status, want_range = 206, f"bytes {lo}-{hi - 1}/{size}"
        ok = (status == want_status
              and headers.get("Content-Range") == want_range
              and np.array_equal(np.frombuffer(body, np.uint8), self.data[g.key][lo:hi]))
        served = status in (200, 206)
        records.append({"op": "get", **asdict(g),
                        "due": sent if due is None else due, "sent": sent, "done": done,
                        "status": status, "bytes": len(body) if served else 0, "ok": bool(ok),
                        "err": None if served else body[:300].decode("utf-8", "replace")})

    def warm(self, records: list) -> None:
        """The warm-up GETs, `senders` at a time."""
        reqs, senders = self.warm_reqs, self.stream["senders"]

        def client(i: int):
            conn = Conn(self.job["addr"])
            for g in reqs[i::senders]:
                self._one(conn, g, records)

        run_threads(client, senders)

    def run(self, t0: float, records: list) -> float:
        return paced(self.job["addr"], self.sched, t0, self.stream["senders"],
                     lambda conn, g, due: self._one(conn, g, records, due))


class PairStream(GetStream):
    """Range pairs over the preloaded dataset (traffic.range_pairs): the two
    halves of a pair, due at once, go to two senders back to back; each
    half's record carries its pair and role."""

    def plan(self) -> tuple[list, list]:
        plan = self.stream["plan"]
        return ([(due, traffic.Half(**h)) for due, h in plan["window"]],
                [traffic.Half(**h) for h in plan["warm"]])


STREAMS = {"put": PutStream, "get": GetStream, "range_pairs": PairStream}


def window(job: dict) -> None:
    streams = [STREAMS[s["op"]](job, s) for s in job["mix"]["window"]]
    warm: list = []
    for s in streams:
        s.warm(warm)
    print("READY", flush=True)
    if sys.stdin.readline().strip() != "GO":
        raise SystemExit("client: no GO on stdin")
    t0 = time.monotonic()
    records: list = []
    late = [0.0] * len(streams)

    def one(i: int):
        late[i] = streams[i].run(t0, records)

    run_threads(one, len(streams))
    with open(job["out"], "w") as f:
        json.dump({"t0": t0, "warm": warm, "records": records, "pacer_late_s": max(late)}, f)
    print("DONE", flush=True)


def main(argv: list[str]) -> int:
    with open(argv[1]) as f:
        job = json.load(f)
    if job["phase"] == "preload":
        out = preload(job)
        with open(job["out"], "w") as f:
            json.dump(out, f)
        return 1 if out["errors"] else 0
    window(job)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
