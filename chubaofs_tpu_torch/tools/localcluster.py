"""One-command local cluster — the `docker/run_docker.sh -r` analog.

The reference brings up 3 masters + 4 metanodes + 4 datanodes + objectnode +
client with docker compose (reference docker/docker-compose.yml:369-412,
run_docker.sh:39). Here the same topology launches as local daemon
subprocesses (the testing harness's ProcCluster promoted to an operator
entry): one command, ephemeral ports, a JSON line with every address, and a
clean teardown on SIGINT/SIGTERM.

    python -m chubaofs_tpu_torch.tools.localcluster --root /tmp/cfs --blobstore --objectnode

Intended for development and soak testing; production deployments run the
per-role daemons (`python -m chubaofs_tpu_torch.cmd -c role.json`) under
real supervision.
"""

from __future__ import annotations

import argparse
import json
import sys


def launch(args) -> "ProcCluster":
    """Boot the cluster `args` describes. `args.device` is the blobstore
    daemon's codec device: None (the default) is the CUDA device, and a
    blobstore on a host without one makes this raise; "cpu" runs the codec
    on the host. The other roles never touch a device."""
    from chubaofs_tpu_torch.testing.harness import ProcCluster

    return ProcCluster(
        args.root,
        masters=args.masters,
        metanodes=args.metanodes,
        datanodes=args.datanodes,
        blobstore=args.blobstore or args.objectnode,
        objectnode=args.objectnode,
        device=args.device,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="cfs-localcluster",
        description="spin up a full local chubaofs-tpu cluster (dev/test)")
    p.add_argument("--root", required=True, help="state directory")
    p.add_argument("--masters", type=int, default=3)
    p.add_argument("--metanodes", type=int, default=3)
    p.add_argument("--datanodes", type=int, default=3)
    p.add_argument("--blobstore", action="store_true",
                   help="also run the EC blobstore (cold tier)")
    p.add_argument("--objectnode", action="store_true",
                   help="also run the S3 gateway (implies --blobstore backing)")
    p.add_argument("--device", default=None,
                   help="the blobstore codec's device (default: the CUDA "
                        "device; cpu runs it on the host)")
    p.add_argument("--volume", default="",
                   help="create this volume once nodes register")
    args = p.parse_args(argv)

    from chubaofs_tpu_torch.utils.shutdown import await_shutdown, shutdown_event

    # handlers FIRST: a supervisor that signals the instant it sees the JSON
    # line must hit the graceful path, not the default handler
    stop = shutdown_event()
    cluster = launch(args)  # constructor already waits for node registration
    try:
        if args.volume:
            cluster.client_master().create_volume(args.volume, cold=False)
        print(json.dumps({
            "master_addrs": cluster.master_addrs,
            "access_addr": cluster.access_addr,
            "s3_addr": cluster.s3_addr,
            "root": cluster.root,
        }), flush=True)
        await_shutdown(stop)
        return 0
    finally:
        cluster.close()


if __name__ == "__main__":
    sys.exit(main())
