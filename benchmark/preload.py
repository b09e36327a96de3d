"""Arithmetic the readers of the preload's PUT path share
(benchmark/metrics/access.put.*, codec.jobs_per_batch.put, http.put.face_pct).

They read the program's process-wide counters at the window's end: the
trace module's PUT span totals (`registry("trace")`, trace.add_totals), the
codec's encode batches (`registry("codec")`) and the HTTP face's PUT time
(`registry("evloop")`, rpc/httpevloop.py). The counters count from the
process's start. Each run is its own process, and no window of these cells
sends a PUT, so what they hold of PUTs is the run's preload.

| Reader | What |
|---|---|
| `access.put.encode_pct` | `encode` (each blob's wait for its stripe) over the `access.put` span wall |
| `access.put.wait_codec_pct` | `wait.codec` (the codec's queue) over the same wall |
| `access.put.codec_host_pct` | `codec.host` + `codec.launch` (the codec's batches) over it |
| `access.put.submit_pct` | `submit` (the caller's staging of a blob for the codec) over it |
| `access.put.write_pct` | `write` (a blob's shard fan-out) over it |
| `access.put.mean_ms` | mean `access.put` span wall |
| `codec.jobs_per_batch.put` | encode jobs a codec batch |
| `http.put.face_pct` | receive, queue and send over those and the handler, for PUTs at the daemon |

Each returns None when no PUT was counted, as in a program that keeps no
such counters, or where the window traced no span of the program (a
context no run of the program stands behind).
"""

from __future__ import annotations

from chubaofs_tpu_torch.utils.exporter import registry

PUT = {"op": "access.put"}


def _put_wall(ctx) -> float | None:
    """The preload's summed `access.put` span wall, in s, or None."""
    if not ctx["spans"]:
        return None
    reg = registry("trace")
    wall = reg.counter("span_seconds_total", PUT).value
    if reg.counter("spans_total", PUT).value <= 0 or wall <= 0:
        return None
    return wall


def put_share(ctx, stages: tuple[str, ...]) -> float | None:
    """% of the PUT span wall inside the named stages: the sum of each
    stage's total (each span's intervals merged and clipped to it), so
    stages named together must not overlap."""
    wall = _put_wall(ctx)
    if wall is None:
        return None
    reg = registry("trace")
    inside = sum(reg.counter("stage_seconds_total", {**PUT, "stage": s}).value
                 for s in stages)
    return 100.0 * inside / wall


def put_mean_ms(ctx) -> float | None:
    """Mean wall of the preload's `access.put` spans, in ms."""
    wall = _put_wall(ctx)
    if wall is None:
        return None
    return 1e3 * wall / registry("trace").counter("spans_total", PUT).value


def encode_jobs_per_batch(ctx) -> float | None:
    """The codec's `kind_jobs_total{kind="encode"}` over its
    `kind_batches_total{kind="encode"}`."""
    if not ctx["spans"]:
        return None
    reg = registry("codec")
    batches = reg.counter("kind_batches_total", {"kind": "encode"}).value
    if batches <= 0:
        return None
    return reg.counter("kind_jobs_total", {"kind": "encode"}).value / batches


def put_face_pct(ctx) -> float | None:
    """% of the PUT requests' time at the daemon in the HTTP face: receive,
    queue and send over the four with the handler."""
    if not ctx["spans"]:
        return None
    reg = registry("evloop")
    put = {"method": "PUT"}
    if reg.counter("http_requests_total", put).value <= 0:
        return None
    face = sum(reg.counter(f"http_{p}_seconds_total", put).value
               for p in ("recv", "queue", "send"))
    total = face + reg.counter("http_handler_seconds_total", put).value
    return 100.0 * face / total if total > 0 else None
