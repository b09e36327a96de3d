"""The cases of tests/test_blobstore_ops.py, run against the port on the CPU.

Blobstore ops surface: module registry, graceful reload, admin API + CLI.
Every daemon here runs its codec on the host ("device": "cpu").

Reference: blobstore/cmd/cmd.go:63-80 (RegisterModule + graceful restart),
blobstore/cli (interactive admin CLI over the service APIs).
"""

import io
import json

import numpy as np
import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.blobstore.cmd import ModuleRunner
from chubaofs_tpu_torch.cli.blobstore import main as bs_cli


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


# -- module runner -------------------------------------------------------------


def test_module_runner_order_and_reload():
    events = []
    r = ModuleRunner(cfg={"x": 1})
    r.register("a", lambda c, h: events.append("up-a") or "A",
               lambda h: events.append("down-a"))
    r.register("b", lambda c, h: events.append("up-b") or h["a"] + "B",
               lambda h: events.append("down-b"))
    r.start()
    assert r.handles["b"] == "AB"  # consumers see providers' handles
    r.reload()
    assert events == ["up-a", "up-b", "down-b", "down-a", "up-a", "up-b"]
    assert r.reloads == 1
    r.stop()
    assert events[-2:] == ["down-b", "down-a"]
    assert r.status() == [{"name": "a", "running": False},
                          {"name": "b", "running": False}]


def test_module_runner_partial_start_unwinds():
    events = []
    r = ModuleRunner()
    r.register("ok", lambda c, h: events.append("up-ok") or 1,
               lambda h: events.append("down-ok"))
    r.register("boom", lambda c, h: (_ for _ in ()).throw(RuntimeError("x")))
    with pytest.raises(RuntimeError):
        r.start()
    assert events == ["up-ok", "down-ok"]  # no leaked service
    assert r.handles == {}


def test_module_runner_duplicate_name():
    r = ModuleRunner()
    r.register("a", lambda c, h: 1)
    with pytest.raises(ValueError):
        r.register("a", lambda c, h: 2)


# -- daemon-level graceful restart + admin API + CLI ---------------------------


@pytest.fixture
def daemon(tmp_path):
    from chubaofs_tpu_torch.cmd import start_role

    d = start_role({"role": "blobstore", "root": str(tmp_path / "blob"),
                    "nodes": 6, "disksPerNode": 2,
                    "listen": "127.0.0.1:0", "device": "cpu"})
    yield d
    d.stop()


def blob_bytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def test_graceful_reload_preserves_data_and_address(daemon, rng):
    from chubaofs_tpu_torch.blobstore.gateway import AccessClient

    client = AccessClient([daemon.addr])
    data = blob_bytes(rng, 200_000)
    loc = client.put(data)
    addr_before = daemon.addr

    daemon.runner.reload()  # drain-and-reload the whole stack

    assert daemon.runner.handles["gateway"].addr == addr_before
    assert client.get(loc) == data  # persisted state served by the new stack
    assert daemon.runner.reloads == 1


def test_admin_api_and_cli(daemon, rng):
    from chubaofs_tpu_torch.blobstore.gateway import AccessClient

    AccessClient([daemon.addr]).put(blob_bytes(rng, 50_000))

    def run(*cmd):
        out = io.StringIO()
        assert bs_cli(["--addr", daemon.addr, *cmd], stdout=out) == 0
        return out.getvalue()

    stat = json.loads(run("stat"))
    assert stat["disks"] == 12 and stat["volumes"] >= 1

    disks = run("disk", "ls")
    assert "DISK_ID" in disks and disks.count("\n") >= 12

    vols = run("vol", "ls")
    assert "VID" in vols
    first_vid = json.loads(run("vol", "info", "1"))  # vid 1 exists
    assert first_vid["vid"] == 1 and first_vid["units"]

    # switches round-trip
    sw = run("switch", "ls")
    assert "vol_inspect" in sw
    assert json.loads(run("switch", "set", "vol_inspect", "off")) == {
        "vol_inspect": False}
    assert "False" in run("switch", "ls")
    run("switch", "set", "vol_inspect", "on")

    assert "RUNNING" in run("module", "ls").upper()


def test_cli_reload_command(daemon, rng):
    import time

    out = io.StringIO()
    assert bs_cli(["--addr", daemon.addr, "reload"], stdout=out) == 0
    assert json.loads(out.getvalue())["reloading"] is True
    deadline = time.monotonic() + 10
    while daemon.runner.reloads < 1 and time.monotonic() < deadline:
        time.sleep(0.05)
    assert daemon.runner.reloads == 1


def test_cli_interactive_repl(daemon):
    from chubaofs_tpu_torch.cli.blobstore import BlobCli

    stdin = io.StringIO("stat\nswitch ls\nbogus\nexit\n")
    stdout = io.StringIO()
    BlobCli(daemon.addr).repl(stdin=stdin, stdout=stdout)
    text = stdout.getvalue()
    assert '"disks"' in text
    assert "vol_inspect" in text
    assert "unknown command" in text


def test_forgive_clears_punish_windows(daemon):
    """POST /admin/forgive (CLI: forgive) lifts access punish windows so
    writes trust a recovered host immediately instead of waiting out
    punish_secs (the dark-AZ soak's recovery lever, over the admin surface)."""
    access = daemon.runner.handles["cluster"].access
    access.punish_disk(4001, "test")
    assert access._is_punished(4001)

    out = io.StringIO()
    assert bs_cli(["--addr", daemon.addr, "forgive"], stdout=out) == 0
    assert "cleared" in out.getvalue()
    assert not access._is_punished(4001)
