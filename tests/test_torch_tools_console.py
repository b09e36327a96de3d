"""The cases of tests/test_tools_console.py whose modules the port has, run
against the port on the CPU: the master's GraphQL surface (master/gapi.py)
and the ProcCluster boot-failure guard (testing/harness.py). Every name and
assertion as in the reference, imports from chubaofs_tpu_torch, and the
FsCluster built with device="cpu". The fsck, fdstore, authtool, autofs,
preload, console and localcluster cases wait for the ports of those tools
and of console/.

The reference file's docstring:

Operator tools (fsck/fdstore/authtool/autofs/preload) + console/GraphQL."""

import pytest

from chubaofs_tpu_torch import chaos as t_chaos
from chubaofs_tpu_torch.deploy import FsCluster


@pytest.fixture(autouse=True)
def _port_chaos_clean():
    """tests/conftest.py resets the JAX package's failpoints; the port keeps
    its own registry, reset here."""
    yield
    t_chaos.reset()


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    c = FsCluster(str(tmp_path_factory.mktemp("tools")), n_nodes=3,
                  blob_nodes=6, data_nodes=0, device="cpu")
    c.create_volume("tl", cold=True)
    yield c
    c.close()


def test_graphql_queries(cluster):
    from chubaofs_tpu_torch.master.gapi import GQLError, GraphQLAPI

    api = GraphQLAPI(cluster.master())
    data = api.execute("""query Overview {
      clusterView { leaderID nodes { id kind } }
      volumeList { name cold metaPartitions { partitionID } }
    }""")
    assert data["clusterView"]["leaderID"] is not None
    assert {n["kind"] for n in data["clusterView"]["nodes"]} >= {"meta"}
    assert any(v["name"] == "tl" and v["cold"] for v in data["volumeList"])
    # arguments + variables, including a typed variable-definition list
    data = api.execute('query Q($v: String!) { volume(name: $v) { name owner } }',
                       {"v": "tl"})
    assert data["volume"]["name"] == "tl"
    # UTF-8 string literals survive (no unicode_escape mojibake)
    with pytest.raises(Exception, match="café"):
        api.execute('{ volume(name: "café") { name } }')
    # clusterStat: the dashboard capacity rollup rides the same endpoint
    data = api.execute(
        "{ clusterStat { nodes active volumes totalSpace zones { name nodes } } }")
    assert data["clusterStat"]["nodes"] >= 1
    assert data["clusterStat"]["volumes"] >= 1
    assert isinstance(data["clusterStat"]["zones"], list)
    # missing required argument is a GraphQL error, not a 500
    with pytest.raises(GQLError):
        api.execute("{ volume { name } }")
    with pytest.raises(GQLError):
        api.execute("{ nope }")
    with pytest.raises(GQLError):
        api.execute("mutation { hack }")


def test_proccluster_boot_failure_reaps_spawned_daemons(tmp_path, monkeypatch):
    """A partial boot (e.g. leader-election timeout) must not orphan already-
    spawned daemons: the constructor guard closes them before re-raising."""
    import subprocess
    import sys

    from chubaofs_tpu_torch.testing import harness

    spawned = {}

    def fake_boot(self, *a, **kw):
        p = subprocess.Popen([sys.executable, "-c", "import time; time.sleep(60)"])
        self.procs["master1"] = p
        spawned["p"] = p
        raise TimeoutError("no raft leader within 30s")

    monkeypatch.setattr(harness.ProcCluster, "_boot", fake_boot)
    try:
        with pytest.raises(TimeoutError):
            harness.ProcCluster(str(tmp_path / "boom"), masters=1, metanodes=0,
                                datanodes=0)
        assert spawned["p"].poll() is not None, (
            "orphaned daemon after boot failure")
    finally:
        if spawned["p"].poll() is None:  # a regression must not leak the child
            spawned["p"].kill()
            spawned["p"].wait(timeout=10)
