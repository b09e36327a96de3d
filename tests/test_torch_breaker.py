"""The cases of tests/test_breaker.py, run against the port on the CPU.

Client-side circuit breaker around allocator/proxy calls (the access PUT
path's hystrix analog), on MiniCluster(device="cpu")."""

import time

import numpy as np
import pytest
import torch

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.cluster import MiniCluster
from chubaofs_tpu_torch.utils.breaker import CircuitBreaker, CircuitOpen


CPU = "cpu"
# small shapes: one intra-op thread is enough, and it leaves the other test
# workers' cores alone
torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


def test_breaker_opens_fails_fast_and_recovers(monkeypatch):
    calls = [0]

    def flaky():
        calls[0] += 1
        raise RuntimeError("down")

    b = CircuitBreaker("t", failures=3, window=5.0, cooldown=0.2)
    for _ in range(3):
        with pytest.raises(RuntimeError):
            b.call(flaky)
    assert b.state == "open"
    # open: dependency NOT touched, callers fail immediately
    n = calls[0]
    with pytest.raises(CircuitOpen):
        b.call(flaky)
    assert calls[0] == n
    # after cooldown one probe is admitted; its failure re-opens
    time.sleep(0.25)
    with pytest.raises(RuntimeError):
        b.call(flaky)
    assert calls[0] == n + 1
    assert b.state == "open"
    # next cooldown: a healthy probe closes the circuit
    time.sleep(0.25)
    assert b.call(lambda: 42) == 42
    assert b.state == "closed"
    assert b.call(lambda: 7) == 7


def test_access_put_fails_fast_when_allocator_down(tmp_path, rng):
    """A dead allocator/proxy makes PUTs fail in milliseconds (breaker
    open), not stack behind per-request errors; recovery is automatic."""
    c = MiniCluster(str(tmp_path), n_nodes=6, disks_per_node=1, device=CPU)
    try:
        data = rng.integers(0, 256, 100_000, dtype=np.uint8).tobytes()
        loc = c.access.put(data)  # healthy baseline
        assert c.access.get(loc) == data

        real_alloc = c.proxy.alloc_bids
        count = [0]

        def dead(*a, **k):
            count[0] += 1
            raise RuntimeError("allocator down")

        c.proxy.alloc_bids = dead
        c.access._alloc_breaker.cooldown = 0.3
        for _ in range(5):  # trip the breaker
            with pytest.raises(Exception):
                c.access.put(data)
        tripped = count[0]
        t0 = time.perf_counter()
        with pytest.raises(Exception):
            c.access.put(data)
        assert time.perf_counter() - t0 < 0.05  # fail fast, no dependency call
        assert count[0] == tripped
        # allocator heals: after cooldown the probe succeeds and PUTs flow
        c.proxy.alloc_bids = real_alloc
        time.sleep(0.35)
        loc2 = c.access.put(data)
        assert c.access.get(loc2) == data
    finally:
        c.close()
