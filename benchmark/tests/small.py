"""Small copies of the cells' mixes, for the host tests: the same path
(daemon, client process, disks lost, checks) at a size a test can hold."""

from __future__ import annotations

import copy

from benchmark import run, traffic

SEED = 2**31 + 17


def small_mix(cell: str, traffic_name: str | None = None) -> dict:
    """The cell's mix (or the mix named), cut to a small size."""
    _, spec = run.cell_spec(cell)
    mix = copy.deepcopy(traffic.load_mix(traffic_name or spec["traffic"]))
    if mix["preload"]:
        mix["preload"].update(objects=12, clients=4)
        mix["preload"]["sizes"]["max"] = 4 << 20
    for s in mix["window"]:
        if s["op"] == "put":
            s.update(rate_per_s=min(s["rate_per_s"], 3), senders=4)
            s["sizes"]["max"] = 2 << 20
        else:
            s.update(senders=4, warm_requests=8)
    return mix


def rehearse(cell: str, fault=None, seed: int = SEED, traffic_name: str | None = None,
             config: dict | None = None, mix: dict | None = None) -> dict:
    """One run of the cell's path on the host: under the cell's small mix (or
    `traffic_name`'s, or `mix` as given) and its configuration (or
    `config`)."""
    from benchmark import faults

    try:
        return run.run_cell(cell, seed, 1.5, False, device="cpu", fault=fault,
                            mix=mix or small_mix(cell, traffic_name), config=config)
    finally:
        faults.restore()


def rehearse_all() -> None:
    for cell in run.load_benchmark()["workloads"]:
        line = rehearse(cell["name"])
        if not line["correct"]:
            raise AssertionError(f"{cell['name']}: {line['checks']}")
