"""`python -m ray_tpu_torch start --address HOST:PORT`: join a running
session as a worker node.

The worker-join half of the reference's CLI (``ray_tpu/scripts/cli.py``
``_run_worker_node``), which ``cluster_utils.Cluster`` drives; the head,
stop, status, list and job commands come with the rest of the CLI
(ROADMAP.md section A8).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys


def _run_worker_node(args) -> None:
    """Join an existing cluster as a worker node: a NodeDaemon whose
    workers execute tasks/actors scheduled here (reference parity:
    `ray start --address`). The controller address must be routable;
    start the head with RAY_TPU_BIND_HOST=0.0.0.0 for multi-host."""
    from ._private.daemon import NodeDaemon
    from ._private.protocol import ClientPool

    host, _, port = args.address.rpartition(":")
    if not host or not port.isdigit():
        sys.exit(f"--address must be host:port (got {args.address!r})")
    controller_addr = (host, int(port))
    resources = json.loads(args.resources) if args.resources else {}
    if args.num_cpus is not None:
        resources["CPU"] = float(args.num_cpus)
    if args.num_gpus is not None:
        resources["GPU"] = float(args.num_gpus)
    labels = json.loads(args.labels) if args.labels else {}

    # A joining worker's daemon AND its worker processes must be
    # reachable from the head and from every other node (object pushes,
    # actor calls). Default the whole process tree to wildcard binding;
    # RpcServer advertises the primary outbound IP.
    os.environ.setdefault("RAY_TPU_BIND_HOST", "0.0.0.0")

    async def run():
        pool = ClientPool()
        info = await pool.get(controller_addr).call("get_session_info")
        await pool.close_all()
        daemon = NodeDaemon(controller_addr, info["session_name"],
                            resources=resources or None, labels=labels)
        await daemon.start()
        print(f"ray_tpu_torch worker node {daemon.node_id[:12]} joined "
              f"{args.address} with {daemon.resources}", flush=True)
        try:
            while True:
                await asyncio.sleep(3600)
        finally:
            await daemon.stop()

    try:
        asyncio.run(run())
    except KeyboardInterrupt:
        pass


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ray_tpu_torch", description="ray_tpu_torch node CLI")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("start", help="join a running session as a node")
    sp.add_argument("--address", required=True,
                    help="controller host:port to join as a worker node")
    sp.add_argument("--num-cpus", type=float, default=None)
    sp.add_argument("--num-gpus", type=float, default=None)
    sp.add_argument("--resources", default=None,
                    help='extra node resources as JSON, e.g. \'{"GPU": 1}\'')
    sp.add_argument("--labels", default=None, help="node labels as JSON")
    sp.set_defaults(fn=_run_worker_node)
    return p


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
