"""The PUT path's process-wide totals in the port.

`trace.Span.finish` adds each gateway PUT span's wall, count and per-stage
union to `registry("trace")`; the gateway's PUT records its caller-side
staging as the `submit` stage; the HTTP face counts its receive, queue,
handler and send time for PUTs in `registry("evloop")`; LRC's composed
parity counts as an encode job. The stage totals are held to the
benchmark's own arithmetic over recorded spans (benchmark/spans.py).
"""

import socket
import time

import numpy as np
import pytest

from benchmark import spans as bench_spans
from chubaofs_tpu_torch.blobstore import trace
from chubaofs_tpu_torch.blobstore.access import CodeModePolicy
from chubaofs_tpu_torch.blobstore.gateway import AccessClient
from chubaofs_tpu_torch.cmd import start_role
from chubaofs_tpu_torch.codec.codemode import CodeMode
from chubaofs_tpu_torch.rpc.httpevloop import HttpFramer
from chubaofs_tpu_torch.rpc.router import Response, Router
from chubaofs_tpu_torch.rpc.server import RPCServer
from chubaofs_tpu_torch.utils.exporter import registry

HTTP = ("recv", "queue", "handler", "send")


def _stage_total(op: str, stage: str) -> float:
    return registry("trace").counter("stage_seconds_total", {"op": op, "stage": stage}).value


def _http(method: str) -> dict:
    reg = registry("evloop")
    out = {p: reg.counter(f"http_{p}_seconds_total", {"method": method}).value for p in HTTP}
    out["requests"] = reg.counter("http_requests_total", {"method": method}).value
    return out


def _finished(op: str, wall: float, stages) -> trace.Span:
    """A span of `wall` seconds holding `stages` as (name, offset, dur)
    from its start, finished now."""
    span = trace.Span(op)
    span.start = time.perf_counter() - wall
    for name, off, dur in stages:
        span.add_stage(name, start=span.start + off, dur=dur)
    span.finish()
    return span


def _record(span: trace.Span) -> dict:
    """The span as the benchmark's SpanRecorder keeps it."""
    return {"op": span.operation, "start": span.start, "dur": span.finished_us / 1e6,
            "stages": [(n, span.start + off, d) for n, off, d in span.stages]}


# overlapping intervals of one stage, a stage that began before its span
# and one that outlasts it
STAGES = [("encode", 0.0, 0.3), ("encode", 0.2, 0.3), ("write", 0.4, 0.5),
          ("write", 0.45, 0.1), ("write", 0.95, 0.5), ("wait.codec", -0.2, 0.3),
          ("codec.launch", 0.9, 0.4), ("submit", 0.05, 0.01), ("submit", 0.05, 0.01)]


@pytest.mark.parametrize("stage", ["encode", "write", "wait.codec", "codec.launch", "submit"])
def test_stage_total_is_the_benchmark_share_numerator(stage):
    """Over two spans, what finish() adds to stage_seconds_total is what
    spans.share counts inside the stage over the same recorded spans."""
    before = _stage_total("access.put", stage)
    made = [_finished("access.put", 1.0, STAGES), _finished("access.put", 2.0, STAGES[::-1])]
    got = _stage_total("access.put", stage) - before
    ctx = {"spans": [_record(s) for s in made]}
    wall = sum(s["dur"] for s in ctx["spans"])
    want = bench_spans.share(ctx, "access.put", (stage,)) * wall / 100.0
    assert got == pytest.approx(want, abs=1e-9)
    assert got > 0


def test_totals_keep_put_spans_and_read_stages_only():
    """Only `access.put` spans are counted, and of their stages only those
    in TOTAL_STAGES."""
    reg = registry("trace")
    counts = {op: reg.counter("spans_total", {"op": op}).value
              for op in ("scheduler.repair", "access.get", "access.put")}
    wall = reg.counter("span_seconds_total", {"op": "access.put"}).value
    _finished("scheduler.repair", 0.5, [("download", 0.0, 0.2)])
    _finished("access.get", 0.5, [("decode", 0.0, 0.2)])
    span = _finished("access.put", 0.5, [("not.a.stage", 0.0, 0.2), ("decode", 0.0, 0.2)])
    assert reg.counter("spans_total", {"op": "scheduler.repair"}).value == counts["scheduler.repair"]
    assert reg.counter("spans_total", {"op": "access.get"}).value == counts["access.get"]
    assert reg.counter("spans_total", {"op": "access.put"}).value == counts["access.put"] + 1
    assert reg.counter("span_seconds_total", {"op": "access.put"}).value - wall == \
        pytest.approx(span.finished_us / 1e6)
    for stage in ("not.a.stage", "decode"):
        assert ("stage_seconds_total", (("op", "access.put"), ("stage", stage))) \
            not in reg._metrics
    assert ("stage_seconds_total", (("op", "access.get"), ("stage", "decode"))) \
        not in reg._metrics


def test_totals_count_with_no_hook_and_past_a_failing_one():
    prev = trace.finish_hook()
    try:
        for hook in (None, lambda span: 1 / 0):
            trace.set_finish_hook(hook)
            before = _stage_total("access.put", "encode")
            _finished("access.put", 0.2, [("encode", 0.0, 0.1)])
            assert _stage_total("access.put", "encode") - before == pytest.approx(0.1)
    finally:
        trace.set_finish_hook(prev)


def test_framer_stamps_every_request_of_a_burst():
    """First byte to body complete, for each request of a pipelined burst
    fed in small chunks: stamps in order, each request's after the last."""
    raw = (b"PUT /put HTTP/1.1\r\nHost: x\r\nContent-Length: 5\r\n\r\nabcde"
           b"GET /a HTTP/1.1\r\nHost: x\r\n\r\n"
           b"PUT /put HTTP/1.1\r\nHost: x\r\nContent-Length: 3\r\n\r\nxyz")
    framer = HttpFramer()
    t0 = time.perf_counter()
    msgs = []
    for i in range(0, len(raw), 7):
        msgs += [m for m, _ in framer.feed_chunk(memoryview(raw[i:i + 7]))]
    assert [m.method for m in msgs] == ["PUT", "GET", "PUT"]
    last = t0
    for m in msgs:
        assert last <= m.t_first <= m.t_read
        last = m.t_read


def _ask(addr: str, raw: bytes, rcvbuf: int | None = None, pause: float = 0.0) -> int:
    """Send one request on a fresh connection that closes after the reply;
    wait `pause` s before reading the reply whole. Returns its byte count."""
    host, port = addr.rsplit(":", 1)
    sk = socket.create_connection((host, int(port)))
    if rcvbuf:
        sk.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcvbuf)
    sk.sendall(raw)
    time.sleep(pause)
    got = 0
    sk.settimeout(30)
    while True:
        d = sk.recv(1 << 20)
        if not d:
            break
        got += len(d)
    sk.close()
    return got


def test_face_counts_put_replies_sent_whole_only():
    """A PUT whose small reply leaves whole counts once; a PUT whose reply
    has to queue for the shard's flush, and a GET, count nothing."""
    body = b"\x5a" * (16 << 20)
    r = Router()
    r.put("/small", lambda req: Response(200, {}, b"{}"))
    r.put("/big", lambda req: Response(200, {}, body))
    r.get("/small", lambda req: Response(200, {}, b"{}"))
    s = RPCServer(r, module="sendtotals").start()
    try:
        before, gets = _http("PUT"), _http("GET")
        _ask(s.addr, b"PUT /small HTTP/1.1\r\nHost: x\r\nContent-Length: 2\r\n"
                     b"Connection: close\r\n\r\nab")
        deadline = time.monotonic() + 10
        while _http("PUT")["requests"] == before["requests"] and time.monotonic() < deadline:
            time.sleep(0.01)
        after = _http("PUT")
        assert after["requests"] == before["requests"] + 1
        assert all(after[p] >= before[p] for p in HTTP)
        assert after["handler"] > before["handler"]
        got = _ask(s.addr, b"PUT /big HTTP/1.1\r\nHost: x\r\nContent-Length: 0\r\n"
                           b"Connection: close\r\n\r\n", rcvbuf=32 << 10, pause=0.3)
        assert got > len(body)
        _ask(s.addr, b"GET /small HTTP/1.1\r\nHost: x\r\nConnection: close\r\n\r\n")
        time.sleep(0.2)
        assert _http("PUT") == after
        assert _http("GET") == gets
    finally:
        s.stop()


def test_put_over_a_cpu_daemon_counts_the_face_and_an_lrc_encode(tmp_path):
    """One PUT through a CPU daemon's HTTP gateway under EC6P10L2: every
    http_*{method="PUT"} counter rises, the composed LRC parity counts as
    an encode job, and the gateway's PUT span reaches the trace totals."""
    codec = registry("codec")
    jobs = codec.counter("kind_jobs_total", {"kind": "encode"}).value
    batches = codec.counter("kind_batches_total", {"kind": "encode"}).value
    puts = registry("trace").counter("spans_total", {"op": "access.put"}).value
    before = _http("PUT")
    d = start_role({"role": "blobstore", "root": str(tmp_path / "blob"), "nodes": 6,
                    "disksPerNode": 3, "azs": 2, "listen": "127.0.0.1:0", "device": "cpu"})
    try:
        d.runner.handles["cluster"].access.policies = [
            CodeModePolicy(CodeMode.EC6P10L2, 0, 1 << 62)]
        data = np.random.default_rng(26).integers(0, 256, 300_000, dtype=np.uint8).tobytes()
        client = AccessClient([d.addr])
        loc = client.put(data)
        assert loc.code_mode == int(CodeMode.EC6P10L2)
        assert client.get(loc) == data
    finally:
        d.stop()
    after = _http("PUT")
    assert after["requests"] == before["requests"] + 1
    for p in HTTP:
        assert after[p] > before[p], p
    assert codec.counter("kind_jobs_total", {"kind": "encode"}).value == jobs + 1
    assert codec.counter("kind_batches_total", {"kind": "encode"}).value == batches + 1
    assert registry("trace").counter("spans_total", {"op": "access.put"}).value == puts + 1


@pytest.fixture
def recorded():
    """Every finished access span's stage names, by op, chained to any hook."""
    seen: dict[str, list[set]] = {"access.put": [], "access.get": []}
    prev = trace.finish_hook()

    def hook(span):
        if span.operation in seen:
            seen[span.operation].append({n for n, _, _ in span.stages})
        if prev is not None:
            prev(span)

    trace.set_finish_hook(hook)
    yield seen
    trace.set_finish_hook(prev)


@pytest.mark.parametrize("size", [200_000, 9 << 20], ids=["one_blob", "pipelined"])
def test_submit_stage_on_put_spans_and_never_on_get_spans(tmp_path, recorded, size):
    """A PUT's span holds `submit` (once a blob, beside its encode), and no
    GET's does, healthy or degraded."""
    from chubaofs_tpu_torch.blobstore.cluster import MiniCluster

    before = _stage_total("access.put", "submit")
    c = MiniCluster(str(tmp_path), device="cpu", n_nodes=9, disks_per_node=2)
    try:
        data = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()
        loc = c.access.put(data)
        assert c.access.get(loc) == data
        vol = c.cm.get_volume(loc.blobs[0].vid)
        c.nodes[vol.units[0].node_id].lose_shard(vol.units[0].vuid, loc.blobs[0].bid)
        assert c.access.get(loc, 0, 1000) == data[:1000]
    finally:
        c.close()
    (put,) = recorded["access.put"]
    assert {"submit", "encode", "write"} <= put
    assert len(recorded["access.get"]) == 2
    assert any("decode" in g for g in recorded["access.get"])
    assert not any("submit" in g for g in recorded["access.get"])
    assert _stage_total("access.put", "submit") > before
