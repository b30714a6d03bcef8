"""dfcluster: the cluster-in-a-box — a real federation on localhost,
OUTSIDE pytest. The port of dragonfly2_tpu/cli/dfcluster.py: it boots the
port's processes, and only those (``dragonfly2_tpu_torch.manager.server``,
``.scheduler.server`` and ``.daemon.server``).

Boots manager + N schedulers (federated) + N daemons + an HTTP origin as
real subprocesses, runs a real dfget through the federation (first daemon
seeds from origin, second rides P2P), byte-verifies the outputs, and tears
everything down (the reference ships deploy/docker-compose; this is the
zero-dependency localhost equivalent):

    python -m dragonfly2_tpu_torch.cli.dfcluster demo
    python -m dragonfly2_tpu_torch.cli.dfcluster demo --keep     # stay up, Ctrl-C to stop
    python -m dragonfly2_tpu_torch.cli.dfcluster demo --swarm 100  # + dfstress swarm

With --verify-trace every process writes a span file and the run asserts
the federation's tracing story end to end: the dfget's scheduling rounds
land on EXACTLY ONE scheduler (ring ownership) while federation sync spans
appear on EVERY scheduler (the gossip is live).

Every process gets a deadline for its ready line, and writes its stderr to
``<dir>/<name>.log`` (passed through with ``-v``); ``Cluster.spawn_daemon``
adds a daemon with flags of its own (a seed, an upload port, a TLS dir)
after ``up()``.

Schedulers are chained with static --federation-peers (scheduler i lists
0..i-1): the push-pull sync converges both directions over a one-directional
peer edge, so the chain is enough for full convergence without waiting for
the manager's dynconfig refresh.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import tempfile
import time
from collections.abc import Sequence

# a process that prints no ready line in this long did not start
READY_TIMEOUT_S = 60.0


class ClusterError(RuntimeError):
    pass


class Cluster:
    """Subprocess lifecycle for one cluster-in-a-box."""

    def __init__(self, root: str, *, trace: bool = False, verbose: bool = False,
                 env: dict | None = None):
        """`env` adds variables to every process's environment."""
        self.root = root
        self.trace = trace
        self.verbose = verbose
        self.extra_env = dict(env or {})
        self.procs: list[tuple[str, subprocess.Popen]] = []
        self.manager_addr = ""
        self.rest_port: int | None = None
        self.scheduler_addrs: list[str] = []
        self.daemon_socks: list[str] = []
        self.origin_port = 0
        self.daemon_args: list[str] = []
        self.probe_interval = 2.0
        self.trace_dir = os.path.join(root, "traces")

    def _env(self, name: str) -> dict:
        env = dict(os.environ, PYTHONPATH=os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        env.update(self.extra_env)
        if self.trace:
            os.makedirs(self.trace_dir, exist_ok=True)
            env["DRAGONFLY_TRACE_FILE"] = os.path.join(self.trace_dir, f"{name}.jsonl")
            env["DRAGONFLY_TRACE_SAMPLE"] = "1.0"
        return env

    def log_path(self, name: str) -> str:
        """Where process `name` writes its stderr (unless verbose)."""
        return os.path.join(self.root, f"{name}.log")

    def _spawn(self, name: str, args: list[str], ready_prefix: str) -> str:
        """Start `python -m <args>` and return its ready line; a process
        silent past READY_TIMEOUT_S is killed."""
        if self.verbose:
            p = subprocess.Popen([sys.executable, "-m", *args], stdout=subprocess.PIPE,
                                 text=True, env=self._env(name))
        else:
            with open(self.log_path(name), "ab") as err:
                p = subprocess.Popen([sys.executable, "-m", *args], stdout=subprocess.PIPE,
                                     stderr=err, text=True, env=self._env(name))
        self.procs.append((name, p))
        with concurrent.futures.ThreadPoolExecutor(1) as pool:
            read = pool.submit(p.stdout.readline)
            try:
                line = read.result(timeout=READY_TIMEOUT_S)
            except concurrent.futures.TimeoutError:
                p.kill()  # ends the blocked read
                line = ""
        if not line.startswith(ready_prefix):
            raise ClusterError(f"{name} failed to start: {line!r}, exit {p.poll()}")
        return line

    def up(self, *, schedulers: int = 2, daemons: int = 2,
           federation_interval: float = 1.0, probe_interval: float = 2.0,
           extra_scheduler_args: list[str] | None = None,
           extra_daemon_args: list[str] | None = None) -> None:
        """extra_*_args append raw flags to every scheduler/daemon spawn —
        the hook harnesses use for fast keepalive
        cadences or an alternate evaluator without widening this signature
        per knob. The daemon flags also apply to ``spawn_daemon`` later."""
        t0 = time.monotonic()
        line = self._spawn(
            "manager",
            ["dragonfly2_tpu_torch.manager.server", "--port", "0", "--rest-port", "0",
             "--db", os.path.join(self.root, "manager.db")],
            "manager ready",
        )
        self.manager_addr = line.split("rpc=")[1].split()[0]
        self.rest_port = int(line.split("rest=")[1].split()[0])
        for i in range(schedulers):
            args = [
                "dragonfly2_tpu_torch.scheduler.server", "--port", "0",
                "--manager", self.manager_addr,
                "--hostname", f"sched-{i}",
                "--telemetry-dir", os.path.join(self.root, f"tel-{i}"),
                "--federation-interval", str(federation_interval),
            ]
            if self.scheduler_addrs:
                args += ["--federation-peers", ",".join(self.scheduler_addrs)]
            args += extra_scheduler_args or []
            line = self._spawn(f"scheduler-{i}", args, "SCHEDULER_READY")
            self.scheduler_addrs.append(line.split()[1])
        self.daemon_args = list(extra_daemon_args or [])
        self.probe_interval = probe_interval
        for _ in range(daemons):
            self.spawn_daemon()
        # plain stdlib HTTP origin (no Range support: the daemon's
        # sequential back-to-source path covers that shape too)
        origin_dir = os.path.join(self.root, "origin")
        os.makedirs(origin_dir, exist_ok=True)
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            self.origin_port = s.getsockname()[1]
        stderr = None if self.verbose else subprocess.DEVNULL
        p = subprocess.Popen(
            [sys.executable, "-m", "http.server", str(self.origin_port),
             "--bind", "127.0.0.1", "--directory", origin_dir],
            stdout=subprocess.DEVNULL, stderr=stderr,
        )
        self.procs.append(("origin", p))
        deadline = time.monotonic() + 10
        import urllib.request

        while time.monotonic() < deadline:
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{self.origin_port}/", timeout=1)
                break
            except OSError:
                time.sleep(0.1)
        else:
            raise ClusterError("origin server never came up")
        print(
            f"dfcluster: up in {time.monotonic() - t0:.1f}s — manager "
            f"{self.manager_addr}, schedulers {self.scheduler_addrs}, "
            f"{len(self.daemon_socks)} daemons, origin :{self.origin_port}",
            flush=True,
        )

    def spawn_daemon(self, extra_args: Sequence[str] = ()) -> int:
        """Start one more daemon against every scheduler with ``up()``'s
        daemon flags and `extra_args` after them (later flags win, so
        `extra_args` may rename its host or pin its upload port); returns
        its index, the one `dfget` takes."""
        i = len(self.daemon_socks)
        sock = os.path.join(self.root, f"daemon-{i}.sock")
        self._spawn(
            f"daemon-{i}",
            ["dragonfly2_tpu_torch.daemon.server",
             "--scheduler", ",".join(self.scheduler_addrs),
             "--manager", self.manager_addr,
             "--sock", sock,
             "--storage", os.path.join(self.root, f"store-{i}"),
             "--hostname", f"box-daemon-{i}",
             "--probe-interval", str(self.probe_interval),
             *self.daemon_args, *extra_args],
            "DAEMON_READY",
        )
        self.daemon_socks.append(sock)
        return i

    def write_origin_file(self, name: str, payload: bytes) -> str:
        path = os.path.join(self.root, "origin", name)
        with open(path, "wb") as f:
            f.write(payload)
        return f"http://127.0.0.1:{self.origin_port}/{name}"

    def dfget(self, daemon_index: int, url: str, out: str, *, timeout: float = 180.0,
              trace_name: str = "") -> subprocess.CompletedProcess:
        env = self._env(trace_name or f"dfget-{daemon_index}")
        cmd = [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfget", url,
               "-O", out, "--sock", self.daemon_socks[daemon_index], "--no-spawn",
               "--scheduler", ",".join(self.scheduler_addrs)]
        if self.trace and trace_name:
            cmd += ["--trace-file", os.path.join(self.trace_dir, f"{trace_name}.jsonl")]
        return subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=timeout)

    def down(self) -> None:
        for _, p in reversed(self.procs):
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for name, p in self.procs:
            try:
                p.wait(timeout=15)
            except subprocess.TimeoutExpired:
                print(f"dfcluster: {name} ignored SIGTERM, killing", file=sys.stderr)
                p.kill()
        self.procs.clear()


def verify_trace(cluster: Cluster, dfget_trace: str) -> None:
    """Federation tracing assertions:
    the dfget's scheduling rounds ride EXACTLY ONE scheduler; federation
    sync/apply spans show on EVERY scheduler."""
    from dragonfly2_tpu_torch.cli import dftrace

    client_spans = dftrace.load_spans(
        [os.path.join(cluster.trace_dir, f"{dfget_trace}.jsonl")])
    roots = [s for s in client_spans if s["name"] == "dfget.download"]
    if not roots:
        raise ClusterError(f"no dfget.download root span in {dfget_trace}")
    trace_id = roots[0]["trace_id"]

    schedulers_with_rounds = []
    schedulers_with_federation = []
    for i in range(len(cluster.scheduler_addrs)):
        path = os.path.join(cluster.trace_dir, f"scheduler-{i}.jsonl")
        spans = dftrace.load_spans([path]) if os.path.exists(path) else []
        if any(
            s["trace_id"] == trace_id and s["name"].startswith("scheduler.")
            for s in spans
        ):
            schedulers_with_rounds.append(i)
        if any(s["name"].startswith("federation.") for s in spans):
            schedulers_with_federation.append(i)
    if len(schedulers_with_rounds) != 1:
        raise ClusterError(
            f"dfget trace {trace_id[:8]} scheduling spans on schedulers "
            f"{schedulers_with_rounds}; ring affinity wants exactly one"
        )
    if len(schedulers_with_federation) != len(cluster.scheduler_addrs):
        raise ClusterError(
            f"federation spans only on schedulers {schedulers_with_federation} "
            f"of {len(cluster.scheduler_addrs)}"
        )
    print(
        f"dfcluster: trace ok — task rounds on scheduler-"
        f"{schedulers_with_rounds[0]} only, federation spans on all "
        f"{len(schedulers_with_federation)} schedulers",
        flush=True,
    )


def demo(args: argparse.Namespace) -> int:
    root = args.dir or tempfile.mkdtemp(prefix="dfcluster-")
    os.makedirs(root, exist_ok=True)
    cluster = Cluster(root, trace=args.verify_trace or args.trace,
                      verbose=args.verbose)
    rc = 0
    try:
        cluster.up(schedulers=args.schedulers, daemons=args.daemons,
                   federation_interval=args.federation_interval)
        payload = os.urandom(args.payload_kb * 1024)
        want = hashlib.sha256(payload).hexdigest()
        url = cluster.write_origin_file("demo.bin", payload)

        t0 = time.monotonic()
        r = cluster.dfget(0, url, os.path.join(root, "out-seed.bin"),
                          trace_name="dfget-seed")
        if r.returncode != 0:
            raise ClusterError(f"seed dfget failed: {r.stderr}")
        seed_s = time.monotonic() - t0
        t0 = time.monotonic()
        r = cluster.dfget(1 % args.daemons, url, os.path.join(root, "out-p2p.bin"),
                          trace_name="dfget-p2p")
        if r.returncode != 0:
            raise ClusterError(f"p2p dfget failed: {r.stderr}")
        p2p_s = time.monotonic() - t0
        for out in ("out-seed.bin", "out-p2p.bin"):
            with open(os.path.join(root, out), "rb") as f:
                got = hashlib.sha256(f.read()).hexdigest()
            if got != want:
                raise ClusterError(f"{out} corrupt: {got[:12]} != {want[:12]}")
        print(
            f"dfcluster: dfget ok — {args.payload_kb} KiB seeded in "
            f"{seed_s:.1f}s, P2P copy in {p2p_s:.1f}s, both bit-exact",
            flush=True,
        )

        # wait for at least one federation gossip round, then show the
        # merged view from every member
        time.sleep(args.federation_interval * 2 + 0.5)
        states = _federation_states(cluster)
        for i, st in enumerate(states):
            print(f"dfcluster: scheduler-{i} federation_state: {json.dumps(st)}",
                  flush=True)

        if args.swarm:
            swarm_cmd = [
                sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfstress", "--swarm",
                "--schedulers", ",".join(cluster.scheduler_addrs),
                "--peers", str(args.swarm), "--duration", str(args.swarm_duration),
            ]
            r = subprocess.run(swarm_cmd, capture_output=True, text=True,
                               env=cluster._env("dfstress"), timeout=600)
            if r.returncode != 0:
                raise ClusterError(f"swarm failed: {r.stderr or r.stdout}")
            print(f"dfcluster: swarm {r.stdout.strip()}", flush=True)

        if args.keep:
            print("dfcluster: up — Ctrl-C to tear down", flush=True)
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                pass

        if args.verify_trace:
            # SIGTERM first so every process flushes its span file fully
            cluster.down()
            verify_trace(cluster, "dfget-p2p")
    except ClusterError as e:
        print(f"dfcluster: FAIL — {e}", file=sys.stderr, flush=True)
        rc = 1
    except Exception as e:
        # unexpected failures (hung dfget -> TimeoutExpired, etc.) must also
        # take the rc=1 path, or the finally below would rmtree the state
        # dir the debugging message promises to keep
        import traceback

        traceback.print_exc()
        print(f"dfcluster: FAIL — unexpected {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
        rc = 1
    finally:
        cluster.down()
        if args.dir is None and rc == 0:
            shutil.rmtree(root, ignore_errors=True)
        elif args.dir is None:
            print(f"dfcluster: state kept at {root} for debugging", file=sys.stderr)
    return rc


def _federation_states(cluster: Cluster) -> list[dict]:
    import asyncio

    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

    async def fetch() -> list[dict]:
        out = []
        for addr in cluster.scheduler_addrs:
            c = RemoteSchedulerClient(addr, retries=0)
            try:
                out.append(await c.federation_state())
            except Exception as e:
                out.append({"error": str(e)})
            finally:
                await c.close()
        return out

    return asyncio.run(fetch())


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="dragonfly2_tpu_torch cluster-in-a-box (manager + federated "
                    "schedulers + daemons + origin on localhost)"
    )
    ap.add_argument("command", choices=["demo"],
                    help="demo: boot, run a real dfget through the federation, "
                         "verify, tear down")
    ap.add_argument("--dir", default=None,
                    help="state directory (default: fresh temp dir, removed on success)")
    ap.add_argument("--schedulers", type=int, default=2)
    ap.add_argument("--daemons", type=int, default=2)
    # default payload is multi-piece (> the 4 MiB piece size): the P2P copy
    # then runs a real NORMAL scheduling round (the SMALL single-piece fast
    # path has no scheduler.schedule span for --verify-trace to find)
    ap.add_argument("--payload-kb", type=int, default=8192)
    ap.add_argument("--federation-interval", type=float, default=1.0)
    ap.add_argument("--trace", action="store_true",
                    help="write per-process span files under <dir>/traces")
    ap.add_argument("--verify-trace", action="store_true",
                    help="assert ring ownership + federation spans from the traces")
    ap.add_argument("--swarm", type=int, default=0,
                    help="after the dfget, drive N dfstress swarm peers")
    ap.add_argument("--swarm-duration", type=float, default=5.0)
    ap.add_argument("--keep", action="store_true",
                    help="stay up after the demo until Ctrl-C")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="pass subprocess stderr through")
    args = ap.parse_args(argv)
    if args.schedulers < 1 or args.daemons < 1:
        ap.error("need at least 1 scheduler and 1 daemon")
    return demo(args)


if __name__ == "__main__":
    sys.exit(main())
