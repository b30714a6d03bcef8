"""Load generator for a peer daemon and for the scoring serving path.

The port of dragonfly2_tpu/cli/dfstress.py. Two modes, each printing one
JSON line (``metric``, ``value``, ``unit``, ``extra``):

    python -m dragonfly2_tpu_torch.cli.dfstress http://origin/file \\
        --sock /tmp/df.sock --concurrency 16 --duration 10

drives a daemon's ``download`` RPC with N concurrent workers for a duration
(or ``--count`` requests) over the port's ``RpcClient``, on the daemon's
unix socket or a ``host:port``; ``--unique`` appends a counter query
parameter so every request is a new task.

    python -m dragonfly2_tpu_torch.cli.dfstress --scoring [--device cpu]

builds a scoring artifact without JAX (``build_scoring_artifact``: the
port's synthetic cluster and GNN at the trainer's default widths, embedded
on the card), loads it through the scheduler's model loader
(``scheduler.manager_link.load_scorer_verified``: the native C++ scorer by
default, ``GNNScorer`` on the card with ``DRAGONFLY_NATIVE_SCORER=0``) and
drives 40-candidate rounds through three serving shapes (see
``run_scoring_stress``). Scoring runs on the card unless ``--device``
names another; with no card and no ``--device`` it raises.

    python -m dragonfly2_tpu_torch.cli.dfstress --swarm --schedulers a:1,b:2

drives N simulated peers (``--peers``, 200) through the full control-plane
round against a federation of schedulers (the port's or the reference's)
over the wire, through
the port's ``BalancedSchedulerClient`` (a consistent-hash ring over
``RemoteSchedulerClient``s, each with its own circuit breaker; see
``run_swarm``). It runs no torch work and needs no device. Exit code 1 when
any round failed.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.native import MicroBatchScorer, ScorerHandlePool
from dragonfly2_tpu_torch.rpc.balancer import BalancedSchedulerClient
from dragonfly2_tpu_torch.rpc.core import RpcClient
from dragonfly2_tpu_torch.rpc.scheduler import HostInfo, RemoteSchedulerClient, TaskMeta
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.trainer import artifacts, synthetic, train_gnn

# The daemon's default socket (dragonfly2_tpu/cli/dfget.py).
DEFAULT_SOCK = "/tmp/dragonfly2_tpu_daemon.sock"
# The scoring stress's cluster: the JAX package's tool runs at these.
STRESS_NODES, STRESS_SEED = 1024, 7
# Distinct pre-drawn rounds the drivers cycle through.
ROUND_POOL = 64
# Rounds per score_rounds call in the amortized probe.
PROBE_M, PROBE_ROUNDS = 8, 512


def usable_cpu_count() -> int:
    """CPUs this process may actually run on: the scheduling affinity mask
    when the platform exposes one (cgroup-pinned containers report the real
    grant here while os.cpu_count() reports the machine), else
    os.cpu_count()."""
    try:
        return len(os.sched_getaffinity(0)) or (os.cpu_count() or 1)
    except (AttributeError, OSError):  # non-Linux / restricted platforms
        return os.cpu_count() or 1


async def run_stress(args: argparse.Namespace) -> dict:
    client = RpcClient(args.sock, timeout=args.timeout)
    latencies: list[float] = []
    errors = 0
    counter = 0
    stop_at = time.monotonic() + args.duration if args.count is None else None

    def next_url() -> str | None:
        # no await points: atomic on the single-threaded event loop
        nonlocal counter
        if args.count is not None and counter >= args.count:
            return None
        if stop_at is not None and time.monotonic() >= stop_at:
            return None
        counter += 1
        if args.unique:
            sep = "&" if "?" in args.url else "?"
            return f"{args.url}{sep}stress={counter}"
        return args.url

    async def worker(priority: float) -> None:
        nonlocal errors
        while True:
            url = next_url()
            if url is None:
                return
            t0 = time.monotonic()
            try:
                await client.call(  # dflint: disable=DF025 load generator: one RPC per iteration IS the workload being measured
                    "download",
                    {"url": url, "output": None, "priority": priority},
                    timeout=args.timeout,
                )
                latencies.append(time.monotonic() - t0)
            except Exception:
                errors += 1

    # mixed tenant load: --priority-split N gives the first N workers the
    # high priority (--priority) and the rest weight 1.0, so the traffic
    # shaper's weighted fairness is drivable from the CLI
    split = min(getattr(args, "priority_split", 0), args.concurrency)
    weights = [getattr(args, "priority", 1.0)] * split + [1.0] * (args.concurrency - split)
    t0 = time.monotonic()
    await asyncio.gather(*(worker(w) for w in weights))
    elapsed = time.monotonic() - t0
    await client.close()

    lat = np.asarray(latencies) * 1000.0
    return {
        "metric": "daemon_download_rps",
        "value": round(len(latencies) / max(elapsed, 1e-9), 1),
        "unit": "requests/s",
        "extra": {
            "requests": len(latencies),
            "errors": errors,
            "elapsed_s": round(elapsed, 2),
            "concurrency": args.concurrency,
            "priority_split": split,
            "unique_tasks": bool(args.unique),
            "p50_ms": round(float(np.percentile(lat, 50)), 2) if len(lat) else None,
            "p90_ms": round(float(np.percentile(lat, 90)), 2) if len(lat) else None,
            "p99_ms": round(float(np.percentile(lat, 99)), 2) if len(lat) else None,
        },
    }


class ScoringArtifact(NamedTuple):
    """What ``build_scoring_artifact`` wrote: the directory, its
    ``artifact_digest``, the host index (``h{i}`` → graph row) and the
    cluster's pair feature rows, from which ``stress_rounds`` draws."""

    path: Path
    digest: str
    host_index: dict[str, int]
    pair_feats: np.ndarray


def build_scoring_artifact(
    out_dir: str | Path, *, n_nodes: int = STRESS_NODES, seed: int = STRESS_SEED,
    params: dict | None = None, device: str | torch.device | None = None,
) -> ScoringArtifact:
    """A whole GNN artifact directory for the scoring stress, written without
    JAX.

    The synthetic cluster (``n_nodes`` hosts, K=16, 4096 pairs, ``seed``),
    a TopoScorer at ``GNNTrainConfig``'s default widths initialised from
    ``seed`` (or from ``params``, a flax tree of numpy arrays) with no
    training step, on ``device`` (the card unless one is named). Hosts
    ``h{i}`` map to graph row ``i``. ``save_native`` embeds on ``device`` and
    writes ``scorer.dfsc`` beside the params and the graph, so both engines
    load the one directory.
    """
    cluster = synthetic.make_cluster(num_nodes=n_nodes, num_neighbors=16, num_pairs=4096, seed=seed)
    cfg = train_gnn.GNNTrainConfig()
    state = train_gnn.init_state(cfg, rng_seed=seed, params=params, device=device)
    d = artifacts.save_artifact(
        out_dir, model_type="gnn", version=f"stress-{seed}", params=state.model,
        config={"hidden": cfg.hidden, "embed_dim": cfg.embed_dim, "num_layers": cfg.num_layers},
    )
    host_index = {f"h{i}": i % n_nodes for i in range(n_nodes)}
    artifacts.save_graph(d, cluster.graph, {k.encode(): v for k, v in host_index.items()})
    artifacts.save_native(d, train_gnn.make_model(cfg), state.model, cluster.graph, device=device)
    return ScoringArtifact(d, artifacts.artifact_digest(d), host_index, cluster.pairs.feats)


def stress_rounds(
    host_index: dict[str, int], pair_feats: np.ndarray, *, hosts: int, concurrency: int, candidates: int,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROUND_POOL fixed rounds: ``(feats [ROUND_POOL, B, F], child
    [ROUND_POOL, B], parent [ROUND_POOL, B])``. Host ``i`` is graph row
    ``host_index[f"h{i % n}"]``; round ``r``'s child is host ``r %
    concurrency``, its parents the first ``candidates`` hosts past the first
    ``concurrency``, and its feature rows are drawn from ``pair_feats`` with
    a numpy generator seeded by STRESS_SEED."""
    n = len(host_index)
    rows = np.array([host_index[f"h{i % n}"] for i in range(hosts)], np.int32)
    parents = rows[concurrency:][:candidates]
    if not len(parents):
        raise ValueError(f"{hosts} hosts leave no candidate parents past {concurrency} children")
    rng = np.random.default_rng(STRESS_SEED)
    feats = pair_feats[rng.integers(0, len(pair_feats), (ROUND_POOL, len(parents)))]
    child = np.repeat(rows[np.arange(ROUND_POOL) % concurrency][:, None], len(parents), axis=1)
    parent = np.broadcast_to(parents, (ROUND_POOL, len(parents))).copy()
    return feats, child, parent


class _ServingShapes:
    """The stress's three serving shapes over one loaded scorer.

    ``microbatch``: rounds coalesce in one MicroBatchScorer. ``workers1`` /
    ``workers2``: a thread pool of 1 or 2 workers, each scoring whole rounds
    through its own thread's handle (``ScorerHandlePool`` forks one native
    handle per thread; the torch engine's workers share the one
    ``GNNScorer``, whose ``score`` holds no state between calls, so their
    rounds meet on the card's default stream). The pools live as long as
    the object."""

    def __init__(self, scorer, feats: np.ndarray, child: np.ndarray, parent: np.ndarray):
        self.scorer = scorer
        self.feats, self.child, self.parent = feats, child, parent
        self.microbatch = MicroBatchScorer(scorer)
        self.handles = ScorerHandlePool(scorer) if scorer.engine == "native" else None
        self.pools = {1: ThreadPoolExecutor(1, thread_name_prefix="df-stress1"),
                      2: ThreadPoolExecutor(2, thread_name_prefix="df-stress2")}

    def _score_on_worker(self, r: int) -> np.ndarray:
        scorer = self.scorer if self.handles is None else self.handles.get()
        return scorer.score(self.feats[r], child=self.child[r], parent=self.parent[r])

    def legs(self) -> dict:
        loop = asyncio.get_running_loop()

        def on_pool(workers: int):
            return lambda r: loop.run_in_executor(self.pools[workers], self._score_on_worker, r)

        return {
            "microbatch": lambda r: self.microbatch.score(
                self.feats[r], child=self.child[r], parent=self.parent[r]),
            "workers1": on_pool(1),
            "workers2": on_pool(2),
        }

    def probe_us(self) -> float:
        """Amortized scorer time per round: round 0 tiled PROBE_M times per
        ``score_rounds`` call, 5 warm-up calls, then PROBE_ROUNDS rounds."""
        mf = np.tile(self.feats[0], (PROBE_M, 1, 1))
        mc = np.tile(self.child[0], (PROBE_M, 1))
        mp = np.tile(self.parent[0], (PROBE_M, 1))
        for _ in range(5):
            self.scorer.score_rounds(mf, child=mc, parent=mp)
        t0 = time.perf_counter()
        for _ in range(PROBE_ROUNDS // PROBE_M):
            self.scorer.score_rounds(mf, child=mc, parent=mp)
        return (time.perf_counter() - t0) / PROBE_ROUNDS * 1e6

    def close(self) -> None:
        for p in self.pools.values():
            p.shutdown(wait=True)
        if self.handles is not None:
            self.handles.close()
        if self.scorer.engine == "native":
            self.scorer.close()


# The JAX package's extra keys that only its scheduler stack measures (the
# full round, the native round driver, the mirrored peer table, the
# evaluator's feature build and the ceiling built on it): null, never 0.0.
_SCHEDULER_ONLY_KEYS = (
    "full_round_rps", "full_round_best_config", "full_round_rps_serial",
    "full_round_rps_dispatcher", "full_round_p50_ms", "full_round_p99_ms",
    "round_driver_best_config", "round_driver_rounds_per_s", "round_driver_rps_workers1",
    "round_driver_rps_workers2", "native_speedup_vs_best_py", "best_py_config",
    "native_rounds_driven", "round_driver_mirror_best_config", "round_driver_mirror_rounds_per_s",
    "round_driver_mirror_rps_workers1", "round_driver_mirror_rps_workers2",
    "mirror_speedup_vs_best_py", "mirror_rounds_driven", "round_driver_stage_us",
    "round_driver_mirror_stage_us", "mirror_full_syncs", "mirror_stale_rounds",
    "prepare_us_per_round", "single_core_ceiling_rps", "ceiling_fraction_achieved",
    "ceiling_fraction_single_core",
)


async def run_scoring_stress(args: argparse.Namespace) -> dict:
    """Scoring stress: ``args.rounds`` 40-candidate rounds (``--candidates``)
    from ``--concurrency`` drivers through three serving shapes (each worker
    leg ``--worker-rounds`` when given, and ``unit`` says so), interleaved
    over 3 repetitions (median rounds/s per shape, latencies pooled over the
    repetitions), the best named in ``eval_best_config`` and reported as
    ``value``; then the scorer's amortized time per round through
    ``score_rounds`` (``ffi_us_per_round_amortized``).

    The artifact comes from ``build_scoring_artifact`` on ``args.device``
    (the card unless named), and the engine from the model loader: native
    by default, torch with ``DRAGONFLY_NATIVE_SCORER=0``; ``extra`` names
    both (``engine``, ``device``). No evaluator builds features here: each
    round's rows are drawn beforehand (``stress_rounds``), so this measures
    the scorer and its serving front, not the scheduler's round."""
    device = resolve_device(getattr(args, "device", None))
    with tempfile.TemporaryDirectory() as td:
        art = await asyncio.to_thread(build_scoring_artifact, Path(td) / "gnn-stress", device=device)
        scorer, host_index = await asyncio.to_thread(
            manager_link.load_scorer_verified, str(art.path), art.digest, device=device)
    shapes = _ServingShapes(scorer, *stress_rounds(
        host_index, art.pair_feats, hosts=args.hosts, concurrency=args.concurrency, candidates=args.candidates))
    try:
        legs = shapes.legs()
        pool = len(shapes.feats)
        # warm every path (first calls start the flusher, fork per-thread
        # handles and warm the card)
        for _ in range(3):
            for fn in legs.values():
                await asyncio.gather(*(fn(r) for r in range(args.concurrency)))

        async def measure(fn, n: int) -> tuple[float, np.ndarray]:
            done = 0
            lat: list[float] = []

            async def driver():
                nonlocal done
                while done < n:
                    r = done % pool
                    done += 1
                    t1 = time.perf_counter()
                    await fn(r)
                    lat.append(time.perf_counter() - t1)

            t0 = time.perf_counter()
            await asyncio.gather(*(driver() for _ in range(args.concurrency)))
            return n / (time.perf_counter() - t0), np.asarray(lat) * 1000

        worker_rounds = getattr(args, "worker_rounds", None) or args.rounds
        leg_rounds = {k: args.rounds if k == "microbatch" else worker_rounds for k in legs}
        rates: dict[str, list[float]] = {k: [] for k in legs}
        lats: dict[str, list[np.ndarray]] = {k: [] for k in legs}
        mb = shapes.microbatch
        flushes0, rounds0 = mb.flushes, mb.rounds
        for _rep in range(3):
            for name, fn in legs.items():
                rps, lat = await measure(fn, leg_rounds[name])
                rates[name].append(rps)
                lats[name].append(lat)
        flushes, rounds = mb.flushes - flushes0, mb.rounds - rounds0
        med = {k: float(np.median(v)) for k, v in rates.items()}
        best = max(legs, key=lambda k: med[k])
        best_lat = np.concatenate(lats[best])
        ffi_us = shapes.probe_us()
    finally:
        shapes.close()

    def pct(q: float) -> float | None:
        return round(float(np.percentile(best_lat, q)), 3) if len(best_lat) else None

    engine = scorer.engine
    where = str(scorer.device) if engine == "torch" else "cpu"
    return {
        "metric": "scorer_rounds_per_sec",
        "value": round(med[best], 1),
        "unit": (
            f"rounds/s (the {engine} scorer on {where} behind its serving front, round "
            f"features drawn beforehand; best config = {best}, see eval_best_config"
            + (f"; worker legs cut to {worker_rounds} rounds)" if worker_rounds != args.rounds else ")")
        ),
        "extra": {
            "candidates_per_round": shapes.feats.shape[1],
            "concurrency": args.concurrency,
            "rounds": args.rounds,
            "eval_p50_ms": pct(50),
            "eval_p99_ms": pct(99),
            "eval_best_config": best,
            "rounds_per_sec_microbatch": round(med["microbatch"], 1),
            "rounds_per_sec_workers1": round(med["workers1"], 1),
            "rounds_per_sec_workers2": round(med["workers2"], 1),
            "thread_scaling_speedup": round(med["workers2"] / max(med["workers1"], 1e-9), 3),
            "dispatch_workers": 2,
            **dict.fromkeys(_SCHEDULER_ONLY_KEYS),
            "native_flushes": flushes,
            "native_rounds": rounds,
            "ffi_us_per_round_amortized": round(ffi_us, 1),
            "host_cpu_count": usable_cpu_count(),
            "host_cpu_count_os": os.cpu_count(),
            "engine": engine,
            "device": where,
        },
    }


_SWARM_RPC_VERBS = frozenset({
    "register_peer", "report_task_metadata", "report_pieces",
    "report_piece_result", "report_peer_result", "announce_task",
    "announce_host", "sync_probes", "reschedule", "leave_peer", "leave_host",
    "stat_task",
})


class _CountingSchedulerClient:
    """RemoteSchedulerClient proxy counting RPCs per scheduler address — the
    swarm's per-scheduler load-share measurement (`register_peer` counts
    separately: one per round, so its share IS the ring's task placement)."""

    def __init__(self, addr: str, counts: dict, round_counts: dict):
        self._inner = RemoteSchedulerClient(addr)
        self._addr = addr
        self._counts = counts
        self._round_counts = round_counts

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name not in _SWARM_RPC_VERBS:
            return attr

        async def wrapped(*a, **k):
            self._counts[self._addr] = self._counts.get(self._addr, 0) + 1
            if name == "register_peer":
                self._round_counts[self._addr] = self._round_counts.get(self._addr, 0) + 1
            return await attr(*a, **k)

        return wrapped


async def run_swarm(
    scheduler_addrs: list[str],
    *,
    peers: int = 200,
    tasks: int = 32,
    pieces: int = 8,
    duration: float = 10.0,
    probe_every: int = 5,
    piece_size: int = 4 << 20,
) -> dict:
    """Swarm mode: N simulated lightweight peers driving the full
    control-plane round over the REAL wire against a scheduler federation —
    register → (seed: metadata + batched piece reports + result) or
    (child: scheduled parents + batched piece reports + result) — plus
    periodic probe syncs feeding the topology the federation gossips.

    No data plane: the swarm measures what the ring + federation can
    SCHEDULE, which is the control-plane scale story ("hundreds of peers per
    scheduler pair"). Peer ids are stable per (peer, task) so the resource
    pools stay bounded (re-registering a finished peer restarts it, the
    same reuse shape `run_stress` relies on)."""
    rpc_counts: dict[str, int] = {}
    round_counts: dict[str, int] = {}
    client = BalancedSchedulerClient(
        scheduler_addrs,
        client_factory=lambda a: _CountingSchedulerClient(a, rpc_counts, round_counts),
    )
    metas = [
        TaskMeta(f"swarm-task-{j:04d}", f"http://origin/swarm-{j}.bin")
        for j in range(tasks)
    ]
    content_length = pieces * piece_size
    rounds = 0
    errors = 0
    latencies: list[float] = []
    stop_at = time.monotonic() + duration

    async def peer_loop(i: int) -> None:
        nonlocal rounds, errors
        host = HostInfo(
            id=f"swarm-host-{i:04d}", ip=f"10.42.{i // 256}.{i % 256}",
            hostname=f"swarm-{i}", download_port=18000 + (i % 40000),
        )
        try:
            await client.announce_host(host)
        except Exception:
            errors += 1
        cycle = 0
        while time.monotonic() < stop_at:
            meta = metas[(i + cycle) % len(metas)]
            peer_id = f"swarm-p{i:04d}-{(i + cycle) % len(metas):04d}"
            t0 = time.monotonic()
            try:
                reg = await client.register_peer(peer_id, meta, host)  # dflint: disable=DF025 load generator: one round per iteration IS the workload being measured
                if reg.error:
                    # a refused registration did no reporting work — it must
                    # not count as a completed round (that would inflate
                    # rounds/s exactly when the federation is overloaded)
                    errors += 1
                    cycle += 1
                    continue
                if reg.back_to_source:
                    # first holder: publish metadata, then report the whole
                    # task as one batched flush — the seed leg of the round
                    await client.report_task_metadata(  # dflint: disable=DF025 load generator workload
                        meta.task_id, content_length=content_length,
                        piece_size=piece_size,
                    )
                    await client.report_pieces(  # dflint: disable=DF025 already the batched verb; one flush per round is the workload
                        peer_id, [(k, 8.0, "") for k in range(pieces)]
                    )
                    await client.report_peer_result(  # dflint: disable=DF025 load generator workload
                        peer_id, success=True, bandwidth_bps=2e8
                    )
                else:
                    parent = reg.parents[0].peer_id if reg.parents else ""
                    await client.report_pieces(  # dflint: disable=DF025 already the batched verb; one flush per round is the workload
                        peer_id, [(k, 5.0, parent) for k in range(pieces)]
                    )
                    await client.report_peer_result(  # dflint: disable=DF025 load generator workload
                        peer_id, success=True, bandwidth_bps=3e8
                    )
                if probe_every and cycle % probe_every == probe_every - 1:
                    dst = f"swarm-host-{(i + 1) % peers:04d}"
                    await client.sync_probes(  # dflint: disable=DF025 load generator workload: periodic probe round per peer
                        host.id,
                        [{"dst_host_id": dst, "rtt_ms": 1.0 + (i % 7), "success": True}],
                    )
                rounds += 1
                latencies.append(time.monotonic() - t0)
            except Exception:
                errors += 1
            cycle += 1

    t0 = time.monotonic()
    await asyncio.gather(*(peer_loop(i) for i in range(peers)))
    elapsed = time.monotonic() - t0
    await client.close()

    total_rpcs = sum(rpc_counts.values()) or 1
    total_rounds = sum(round_counts.values()) or 1
    lat = np.asarray(latencies) * 1000.0
    return {
        "metric": "swarm_rounds_per_sec",
        "value": round(rounds / max(elapsed, 1e-9), 1),
        "unit": "rounds/s (full control-plane cycle per simulated peer)",
        "extra": {
            "schedulers": list(scheduler_addrs),
            "peers": peers,
            "tasks": tasks,
            "pieces_per_round": pieces,
            "rounds": rounds,
            "errors": errors,
            "elapsed_s": round(elapsed, 2),
            "p50_ms": round(float(np.percentile(lat, 50)), 2) if len(lat) else None,
            "p99_ms": round(float(np.percentile(lat, 99)), 2) if len(lat) else None,
            # share of scheduling rounds (register_peer) per ring member —
            # the consistent-hash placement balance — plus the all-RPC share
            "per_scheduler_round_share": {
                a: round(round_counts.get(a, 0) / total_rounds, 3)
                for a in scheduler_addrs
            },
            "per_scheduler_rpc_share": {
                a: round(rpc_counts.get(a, 0) / total_rpcs, 3)
                for a in scheduler_addrs
            },
        },
    }


async def run_swarm_stress(args: argparse.Namespace) -> dict:
    addrs = [a.strip() for a in args.schedulers.split(",") if a.strip()]
    if not addrs:
        raise SystemExit("--swarm requires --schedulers host:port[,host:port...]")
    return await run_swarm(
        addrs,
        peers=args.peers,
        tasks=args.tasks,
        pieces=args.pieces,
        duration=args.duration,
        probe_every=args.probe_every,
    )


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="dragonfly2_tpu daemon load generator (PyTorch port)")
    ap.add_argument("url", nargs="?", default=None,
                    help="source URL to download repeatedly (download mode)")
    ap.add_argument("--sock", default=DEFAULT_SOCK)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--duration", type=float, default=10.0,
                    help="seconds to run (ignored with --count)")
    ap.add_argument("--count", type=int, default=None, help="fixed request count")
    ap.add_argument("--timeout", type=float, default=60.0)
    ap.add_argument("--unique", action="store_true",
                    help="unique task per request (full scheduler+piece path)")
    ap.add_argument("--priority", type=float, default=3.0,
                    help="tenant weight for the high-priority worker class")
    ap.add_argument("--priority-split", type=int, default=0,
                    help="first N workers request at --priority (rest at 1.0): "
                         "drives the traffic shaper's weighted fairness")
    ap.add_argument("--scoring", action="store_true",
                    help="stress the ml scoring serving path instead of downloads")
    ap.add_argument("--swarm", action="store_true",
                    help="simulated-peer swarm against a scheduler federation "
                         "over the real wire (control plane only, no data plane; "
                         "runs no torch work and needs no device)")
    ap.add_argument("--schedulers", default="",
                    help="scheduler addresses host:port[,host:port...] (--swarm)")
    ap.add_argument("--peers", type=int, default=200,
                    help="simulated peers in the swarm (--swarm)")
    ap.add_argument("--tasks", type=int, default=32,
                    help="distinct tasks the swarm cycles through (--swarm)")
    ap.add_argument("--pieces", type=int, default=8,
                    help="pieces reported per swarm round (--swarm)")
    ap.add_argument("--probe-every", type=int, default=5,
                    help="sync a probe round every N cycles per peer (--swarm)")
    ap.add_argument("--rounds", type=int, default=20000,
                    help="scoring rounds to drive (--scoring)")
    ap.add_argument("--worker-rounds", type=int, default=None,
                    help="rounds each worker leg drives (--scoring; default: --rounds)")
    ap.add_argument("--candidates", type=int, default=40,
                    help="candidate parents per round (--scoring)")
    ap.add_argument("--hosts", type=int, default=256,
                    help="hosts in the stress pool (--scoring)")
    ap.add_argument("--device", default=None,
                    help="device to build and score on (--scoring; default: the card, "
                         "'cpu' to run without one)")
    args = ap.parse_args(argv)
    if args.scoring:
        result = asyncio.run(run_scoring_stress(args))
        print(json.dumps(result), flush=True)
        return 0
    if args.swarm:
        result = asyncio.run(run_swarm_stress(args))
        print(json.dumps(result), flush=True)
        return 0 if result["extra"]["errors"] == 0 else 1
    if not args.url:
        ap.error("url is required unless --scoring")
    result = asyncio.run(run_stress(args))
    print(json.dumps(result), flush=True)
    return 0 if result["extra"]["errors"] == 0 else 1


if __name__ == "__main__":
    sys.exit(main())
