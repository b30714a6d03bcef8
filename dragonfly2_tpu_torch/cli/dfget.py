"""dfget: download a URL through the P2P cluster (the port of
dragonfly2_tpu/cli/dfget.py; it drives either package's daemon, and spawns
the port's when none answers on ``--sock``).

Reference equivalent: cmd/dfget + client/dfget/dfget.go:47-138 (talks to the
daemon over its unix-socket RPC; spawns the daemon if absent, the
checkAndSpawnDaemon behavior at cmd/dfget/cmd/root.go:266).

  python -m dragonfly2_tpu_torch.cli.dfget http://origin/file -O /tmp/out \
      --scheduler 127.0.0.1:9000

``--trace-file`` records this download's trace (sampled at 100%) as JSON
lines, the input of ``dftrace``.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import subprocess
import sys
import time

from dragonfly2_tpu_torch.rpc.core import RpcClient

DEFAULT_SOCK = "/tmp/dragonfly2_tpu_daemon.sock"


async def _daemon_alive(sock: str) -> bool:
    if not os.path.exists(sock):
        return False
    client = RpcClient(sock, retries=0)
    try:
        return await client.healthy()
    finally:
        await client.close()


def spawn_daemon(sock: str, scheduler: str, storage: str | None, *, seed: bool = False) -> None:
    """Fork a daemon process and wait for its socket (ref checkAndSpawnDaemon)."""
    cmd = [
        sys.executable, "-m", "dragonfly2_tpu_torch.daemon.server",
        "--scheduler", scheduler, "--sock", sock,
    ]
    if storage:
        cmd += ["--storage", storage]
    if seed:
        cmd += ["--seed"]
    subprocess.Popen(
        cmd,
        stdout=subprocess.DEVNULL,
        stderr=subprocess.DEVNULL,
        start_new_session=True,  # detach: daemon outlives this CLI
    )


async def wait_daemon(sock: str, timeout: float) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if await _daemon_alive(sock):
            return True
        await asyncio.sleep(0.1)
    return False


async def ensure_daemon(
    sock: str,
    scheduler: str | None,
    storage: str | None,
    *,
    no_spawn: bool = False,
    spawn_timeout: float = 15.0,
    seed: bool = False,
) -> bool:
    """Shared alive/spawn/wait flow for all thin CLIs (ref checkAndSpawnDaemon).
    Prints the failure reason and returns False when no daemon is usable."""
    if await _daemon_alive(sock):
        return True
    if no_spawn:
        print(f"error: no daemon at {sock} (and --no-spawn set)", file=sys.stderr)
        return False
    if not scheduler:
        print("error: daemon not running; --scheduler required to spawn one", file=sys.stderr)
        return False
    spawn_daemon(sock, scheduler, storage, seed=seed)
    if not await wait_daemon(sock, spawn_timeout):
        print("error: daemon failed to start", file=sys.stderr)
        return False
    return True


async def single_download(
    client: RpcClient, args: argparse.Namespace, url: str, output: str
) -> None:
    from dragonfly2_tpu_torch.observability.tracing import default_tracer

    t0 = time.monotonic()
    # trace ROOT for the download chain: the rpc client ships this context
    # to the daemon, whose conductor/scheduler/parent-daemon spans all join
    # the one trace (`dftrace <files>` reassembles it)
    with default_tracer().span("dfget.download", url=url, output=output):
        result = await client.call(
            "download",
            {
                "url": url,
                "output": os.path.abspath(output),
                "tag": args.tag,
                "application": args.application,
                "digest": args.digest if url == args.url else "",
                "filters": args.filter,
                "range": args.range if url == args.url else "",
            },
            timeout=args.timeout,
        )
    elapsed = time.monotonic() - t0
    size = result.get("exported_bytes", result["content_length"])
    rate = size / max(elapsed, 1e-6) / (1 << 20)
    print(
        f"downloaded {url} -> {output}: {size} bytes, "
        f"{result['pieces']} pieces, {elapsed:.2f}s ({rate:.1f} MiB/s) "
        f"task={result['task_id'][:16]}"
    )


def _accepted(url: str, accept: str, reject: str) -> bool:
    import re

    if reject and re.search(reject, url):
        return False
    if accept and not re.search(accept, url):
        return False
    return True


async def recursive_download(client: RpcClient, args: argparse.Namespace) -> int:
    """Breadth-first directory download (ref client/dfget/dfget.go:312
    recursiveDownload + pkg/source URLEntry listing): list each directory URL
    via the source client, download file entries through the daemon into the
    mirrored tree under --output, queue subdirectories."""
    from collections import deque

    from dragonfly2_tpu_torch.daemon.source import SourceRegistry

    sources = SourceRegistry()
    # (url, output_dir, level) entries
    queue: deque[tuple[str, str, int]] = deque()  # dflint: disable=DF034 BFS frontier of the finite directory tree one CLI invocation crawls, drained in this same loop — not a service-lifetime buffer
    queue.append((args.url, args.output, args.level))
    seen: set[str] = set()
    failures = 0
    try:
        while queue:
            url, out_dir, level = queue.popleft()
            if args.level and level == 0:
                continue
            if url in seen:
                continue  # loop prevention (ref downloadMap)
            seen.add(url)
            try:
                entries = await sources.list_entries(url)
            except Exception as e:
                print(f"error: listing {url}: {e}", file=sys.stderr)
                failures += 1
                continue
            sem = asyncio.Semaphore(args.jobs)
            batch: list = []

            async def fetch(entry_url: str, out_path: str) -> int:
                async with sem:
                    try:
                        await single_download(client, args, entry_url, out_path)
                        return 0
                    except Exception as e:
                        print(f"error: {entry_url}: {e}", file=sys.stderr)
                        return 1

            for entry in entries:
                child_out = os.path.join(out_dir, entry.name)
                if entry.is_dir:
                    # accept-regex describes FILES; only reject prunes subtrees
                    # (ref recursiveDownload queues dirs before accept checks)
                    if args.reject_regex and not _accepted(entry.url, "", args.reject_regex):
                        continue
                    queue.append((entry.url, child_out, level - 1))
                    continue
                if not _accepted(entry.url, args.accept_regex, args.reject_regex):
                    continue
                if args.list_only:
                    print(entry.url)
                    continue
                batch.append(fetch(entry.url, child_out))
            if batch:
                failures += sum(await asyncio.gather(*batch))
    finally:
        await sources.close()
    return 1 if failures else 0


async def download(args: argparse.Namespace) -> int:
    sock = args.sock
    if args.recursive and args.list_only:
        # pure listing never touches the daemon
        return await recursive_download(None, args)
    if not await ensure_daemon(
        sock, args.scheduler, args.storage,
        no_spawn=args.no_spawn, spawn_timeout=args.spawn_timeout,
    ):
        return 1

    client = RpcClient(sock, timeout=args.timeout)
    try:
        if args.recursive:
            return await recursive_download(client, args)
        await single_download(client, args, args.url, args.output)
        return 0
    except Exception as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await client.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="dfget", description="P2P file download")
    ap.add_argument("url", help="source URL (http/https/file)")
    ap.add_argument("-O", "--output", required=True, help="output file path")
    ap.add_argument("--scheduler", default=os.environ.get("DF_SCHEDULER", "127.0.0.1:9000"))
    ap.add_argument("--sock", default=os.environ.get("DF_DAEMON_SOCK", DEFAULT_SOCK))
    ap.add_argument("--storage", default=None, help="daemon storage root (spawn only)")
    ap.add_argument("--tag", default="")
    ap.add_argument("--application", default="")
    ap.add_argument("--digest", default="", help="expected digest algo:hex")
    ap.add_argument("--range", default="",
                    help="byte range START-END (inclusive) to export from the task")
    ap.add_argument("--filter", action="append", default=[], help="query params to drop from task id")
    ap.add_argument("--recursive", action="store_true",
                    help="treat URL as a directory and mirror it under --output")
    ap.add_argument("--level", type=int, default=0,
                    help="recursion depth limit (0 = unlimited)")
    ap.add_argument("--accept-regex", default="", help="only download matching URLs")
    ap.add_argument("--reject-regex", default="", help="skip matching URLs")
    ap.add_argument("--list-only", action="store_true",
                    help="with --recursive: print file URLs without downloading")
    ap.add_argument("--jobs", type=int, default=8,
                    help="concurrent file downloads under --recursive")
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--spawn-timeout", type=float, default=10.0)
    ap.add_argument("--no-spawn", action="store_true", help="fail if daemon absent")
    ap.add_argument("--trace-file", default=os.environ.get("DRAGONFLY_TRACE_FILE", ""),
                    help="record this invocation's trace spans (JSON lines; "
                         "sampled at 100%% — merge with the services' files "
                         "via dftrace)")
    args = ap.parse_args(argv)
    from dragonfly2_tpu_torch.observability.tracing import configure_default_tracer

    # --trace-file: always sampled — the operator asked for THIS download's
    # timeline, not a 1% draw. Without it, the root still opens but at the
    # SERVICE default rate: a bare dfget must not ship an always-sampled
    # context that forces the whole cluster to record every download.
    configure_default_tracer(
        "dfget",
        trace_file=args.trace_file or None,
        sample_rate=1.0 if args.trace_file else None,
    )
    return asyncio.run(download(args))


if __name__ == "__main__":
    sys.exit(main())
