"""dfcache: the P2P cluster cache CLI (the port of
dragonfly2_tpu/cli/dfcache.py).

Parity with reference client/dfcache/dfcache.go:44-162 (Stat/Import/Export/
Delete a file in the cluster cache) + cmd/dfcache. Talks to the local daemon
over its unix-socket RPC, spawning it if needed (same behavior as dfget).

  python -m dragonfly2_tpu_torch.cli.dfcache import ./model.bin --tag llama
  python -m dragonfly2_tpu_torch.cli.dfcache stat   <task-id>
  python -m dragonfly2_tpu_torch.cli.dfcache export <task-id> -O ./copy.bin
  python -m dragonfly2_tpu_torch.cli.dfcache rm     <task-id>
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys

from dragonfly2_tpu_torch.cli.dfget import DEFAULT_SOCK, ensure_daemon
from dragonfly2_tpu_torch.rpc.core import RpcClient, RpcError


async def _amain(args: argparse.Namespace) -> int:
    if not await ensure_daemon(
        args.sock, args.scheduler, args.storage,
        no_spawn=args.no_spawn, spawn_timeout=args.spawn_timeout,
    ):
        return 1
    client = RpcClient(args.sock, timeout=args.timeout)
    try:
        if args.cmd == "import":
            result = await client.call(
                "import_file",
                {
                    "path": os.path.abspath(args.path),
                    "tag": args.tag,
                    "application": args.application,
                },
            )
            print(json.dumps(result))
        elif args.cmd == "stat":
            result = await client.call("stat_task", {"task_id": args.task_id})
            if result is None:
                print(f"error: task {args.task_id} not found in local cache", file=sys.stderr)
                return 1
            print(json.dumps(result))
        elif args.cmd == "export":
            await client.call(
                "export_task",
                {"task_id": args.task_id, "output": os.path.abspath(args.output)},
            )
            print(f"exported {args.task_id} -> {args.output}")
        elif args.cmd == "rm":
            await client.call("delete_task", {"task_id": args.task_id})
            print(f"deleted {args.task_id}")
        return 0
    except RpcError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await client.close()


def main() -> None:
    ap = argparse.ArgumentParser(prog="dfcache", description="P2P cluster cache CLI")
    ap.add_argument("--sock", default=DEFAULT_SOCK)
    ap.add_argument("--scheduler", default=None, help="scheduler addr (spawn only)")
    ap.add_argument("--storage", default=None, help="daemon storage root (spawn only)")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--spawn-timeout", type=float, default=15.0)
    ap.add_argument("--no-spawn", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("import", help="add a local file to the cluster cache")
    p.add_argument("path")
    p.add_argument("--tag", default="")
    p.add_argument("--application", default="")
    p = sub.add_parser("stat", help="stat a cached task")
    p.add_argument("task_id")
    p = sub.add_parser("export", help="export a cached task to a file")
    p.add_argument("task_id")
    p.add_argument("-O", "--output", required=True)
    p = sub.add_parser("rm", help="remove a task from the local cache")
    p.add_argument("task_id")
    args = ap.parse_args()
    sys.exit(asyncio.run(_amain(args)))


if __name__ == "__main__":
    main()
