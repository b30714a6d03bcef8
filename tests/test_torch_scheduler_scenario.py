"""One seeded scheduler scenario, run through either package's
SchedulerService, for the port's scheduler parity tests
(tests/test_torch_scheduler.py, tests/test_torch_round_driver.py), and the
test that it is deterministic: the same seed gives the same observables in
two services, another seed others, so that an equality elsewhere is not
one of empty or constant results.

``run_scenario(svc, pkg)`` drives a service that ``make_service(pkg, ...)``
built (``pkg`` is ``REF`` or ``PORT``: the same module names in both
packages) on a ``VirtualClock``: announce hosts, sync probes, register
peers on a back-to-source task, a multi-piece task, a SMALL and a TINY task
and an announced one, report pieces (success, failure, batched) and
results, reschedule, run two passes of uncommitted find rounds, leave a
peer and a host, then two GC sweeps past the TTLs. It returns every
observable as plain values: register and reschedule results, probe targets, the DAG's
parent lists in vertex order, ``stat_task``, the GC removals, the download
and probe records and the decision records. Rounds are awaited one at a
time, so a dispatched leg consumes the sampling rng in the serial order.
"""

from __future__ import annotations

import asyncio
import random
import types
from dataclasses import asdict

import numpy as np
import pytest
import torch

from dragonfly2_tpu.native import scorer as ref_native
from dragonfly2_tpu.scheduler import evaluator as ref_evaluator
from dragonfly2_tpu.scheduler import resource as ref_resource
from dragonfly2_tpu.scheduler import scheduling as ref_scheduling
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu.telemetry import records as ref_records
from dragonfly2_tpu.utils import clock as ref_clock
from dragonfly2_tpu_torch.native import scorer as port_native
from dragonfly2_tpu_torch.scheduler import evaluator as port_evaluator
from dragonfly2_tpu_torch.scheduler import resource as port_resource
from dragonfly2_tpu_torch.scheduler import scheduling as port_scheduling
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.telemetry import records as port_records
from dragonfly2_tpu_torch.utils import clock as port_clock

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

REF = types.SimpleNamespace(
    name="ref", service=ref_service, scheduling=ref_scheduling, evaluator=ref_evaluator,
    resource=ref_resource, records=ref_records, clock=ref_clock, native=ref_native,
)
PORT = types.SimpleNamespace(
    name="port", service=port_service, scheduling=port_scheduling, evaluator=port_evaluator,
    resource=port_resource, records=port_records, clock=port_clock, native=port_native,
)

HOSTS = 40
NODES = 48  # rows of the scenario's scorer artifacts: hosts h0..h39 map to rows 0..39
LEGS = ("serial", "dispatch", "native", "mirror")

# the GC sweeps' TTLs; the scenario advances its clock past them
GC_TTLS = dict(peer_ttl=600.0, task_ttl=300.0, host_ttl=900.0)


def _host(pkg, i: int):
    return pkg.service.HostInfo(
        id=f"h{i}", ip=f"10.1.{i // 256}.{i % 256}", hostname=f"host{i}", port=9000 + i,
        download_port=8000 + i, type="seed" if i % 13 == 0 else "normal",
        idc=f"idc{i % 3}" if i % 5 else "", location=f"cn|r{i % 2}|z{i % 4}",
    )


def _record_dict(arr: np.ndarray) -> dict:
    return {name: arr[name].copy() for name in arr.dtype.names}


def make_service(pkg, tmp_path, *, leg: str = "serial", scorer=None, node_index=None,
                 decision_sample_rate: float = 1.0, seed: int = 0, evaluator: str | None = None):
    """A service of ``pkg`` for one leg: serial (no dispatcher, the default
    round driver), dispatch (two worker threads), native (one-round native
    driver batches on the loop) or mirror (native, with the native mirrored
    peer table). ``scorer`` (with ``node_index``) is attached to an ml
    evaluator; without one the evaluator is ``evaluator`` (default base)."""
    clock = pkg.clock.VirtualClock(start=100.0)
    cfg = pkg.scheduling.SchedulingConfig(
        retry_interval=0.001,
        dispatch_workers=2 if leg == "dispatch" else 0,
        round_driver="native" if leg in ("native", "mirror") else "auto",
    )
    ev = pkg.evaluator.new_evaluator(evaluator or ("ml" if scorer is not None else "base"))
    telemetry = pkg.records.TelemetryStorage(tmp_path / f"{pkg.name}-{leg}-telemetry")
    svc = pkg.service.SchedulerService(
        evaluator=ev, scheduling_config=cfg, telemetry=telemetry,
        gc_policy=pkg.resource.GCPolicy(**GC_TTLS), clock=clock,
        topology_rng=random.Random(seed + 1), decision_sample_rate=decision_sample_rate,
    )
    svc.scheduling.set_rng_state(random.Random(seed).getstate())
    if scorer is not None:
        ev.attach_scorer(scorer, node_index, version="scenario")
    if leg == "mirror":
        assert svc.enable_native_mirror() is not None, "the mirror needs a native bundle"
    return svc


def dag_edges(svc) -> dict:
    """Each task's peers in DAG vertex order, each with its parents in order."""
    return {
        tid: [(p.id, [q.id for q in task.parents_of(p.id)]) for p in task.dag.values()]
        for tid, task in sorted(svc.pool.tasks.items())
    }


async def run_scenario(svc, pkg, *, seed: int = 0) -> dict:
    """Drive ``svc`` (a service of ``pkg``) through the scenario; see the
    module docstring. Host and peer choices and every reported number come
    from ``seed`` alone, never from the service."""
    rng = np.random.default_rng(seed)
    clock = svc.clock
    out: dict = {"register": [], "reschedule": [], "targets": [], "batch": [], "find": []}
    hosts = [_host(pkg, i) for i in range(HOSTS)]
    for h in hosts:
        svc.announce_host(h, {"cpu_usage": float(rng.uniform(0, 1)), "mem_usage": 0.5, "bogus": 1.0})
    for i, h in enumerate(hosts):
        results = [
            {"dst_host_id": f"h{int(j)}", "rtt_ms": float(rng.uniform(0.2, 40.0)),
             "success": bool(rng.random() > 0.1)}
            for j in rng.choice(HOSTS, size=6, replace=False) if int(j) != i
        ]
        out["targets"].append(svc.sync_probes(h.id, results))

    # a multi-piece task: the first peer goes back to source, later ones schedule
    for k, (length, peers) in enumerate(((40 << 20, 16), (24 << 20, 12))):
        meta = pkg.service.TaskMeta(task_id=f"t{k}", url=f"http://origin/f{k}")
        total = -(-length // (4 << 20))
        for j in range(peers):
            host = hosts[(k * 7 + j * 3) % HOSTS]
            pid = f"p{k}-{j}"
            r = await svc.register_peer(pid, meta, host)  # dflint: disable=DF025 rounds run one at a time: the parity contract is the serial rng order
            out["register"].append(asdict(r))
            if r.back_to_source:
                svc.report_task_metadata(meta.task_id, content_length=length, piece_size=4 << 20, digest="sha256:x")
                svc.report_pieces(pid, [(i, float(rng.uniform(1, 20)), "") for i in range(total)])
                svc.report_peer_result(pid, success=True, bandwidth_bps=float(rng.uniform(1e8, 1e9)))
                continue
            parents = [p.peer_id for p in r.parents]
            if not parents:
                continue
            done = int(rng.integers(1, total + 1))
            for i in range(done):
                svc.report_piece_result(pid, i, success=True, cost_ms=float(rng.uniform(1, 80)),
                                        parent_id=parents[i % len(parents)])
            if rng.random() < 0.3:
                svc.report_piece_result(pid, done, success=False, parent_id=parents[0])
            if j % 3 == 0:
                out["batch"].append(svc.report_batch(
                    pid, [(i, float(rng.uniform(1, 80)), parents[0]) for i in range(done, total)],
                    result={"success": True, "bandwidth_bps": float(rng.uniform(1e7, 5e8))},
                ))
            elif j % 3 == 1:
                svc.report_peer_result(pid, success=bool(j % 2), bandwidth_bps=float(rng.uniform(1e7, 5e8)))
        clock.advance(1.5)  # depth memos age out between tasks

    # SMALL (one piece): a succeeded parent, found without sampling
    small = pkg.service.TaskMeta(task_id="small", url="http://origin/small")
    out["register"].append(asdict(await svc.register_peer("s-0", small, hosts[1])))
    svc.report_task_metadata("small", content_length=1 << 20, piece_size=4 << 20)
    svc.report_pieces("s-0", [(0, 3.0, "")])
    svc.report_peer_result("s-0", success=True, bandwidth_bps=2e8)
    for j in (1, 2):
        out["register"].append(asdict(await svc.register_peer(f"s-{j}", small, hosts[2 + j])))  # dflint: disable=DF025 one registration at a time, as above
    # TINY: the bytes ride inside the answer
    tiny = pkg.service.TaskMeta(task_id="tiny", url="http://origin/tiny")
    out["register"].append(asdict(await svc.register_peer("y-0", tiny, hosts[5])))
    svc.report_task_metadata("tiny", content_length=5, piece_size=4 << 20, direct_piece=b"hello")
    svc.report_peer_result("y-0", success=True)
    out["register"].append(asdict(await svc.register_peer("y-1", tiny, hosts[6])))
    # a peer announcing content it already holds, whole and partial
    held = pkg.service.TaskMeta(task_id="held", url="http://origin/held")
    svc.announce_task("a-0", held, hosts[8], content_length=12 << 20, piece_size=4 << 20,
                      piece_indices=[0, 1, 2], digest="sha256:h")
    svc.announce_task("a-1", held, hosts[9], content_length=12 << 20, piece_size=4 << 20,
                      piece_indices=[0])
    out["register"].append(asdict(await svc.register_peer("a-2", held, hosts[10])))

    for pid in ("p0-5", "p0-9", "p1-4", "a-2"):
        try:
            out["reschedule"].append(asdict(await svc.reschedule(pid)))  # dflint: disable=DF025 one round at a time, as above
        except KeyError:
            out["reschedule"].append("unknown")
    # the dispatcher's worker-side unit, twice over the same children with
    # nothing committed: the second pass finds every feature row cached, so
    # a native leg serves it whole
    children = [svc.pool.peer(f"p0-{j}") for j in (4, 6, 8, 10, 12, 14)]
    for _ in range(2):
        found = svc.scheduling._find_batch_entry()([(c, set()) for c in children])
        out["find"].append([[p.id for p in ps] for ps in found])
    svc.leave_peer("p0-3")
    svc.leave_host("h7")
    out["stat"] = {tid: svc.stat_task(tid) for tid in ("t0", "t1", "small", "tiny", "held", "nope")}
    out["edges"] = dag_edges(svc)
    out["federation"] = {k: v for k, v in svc.federation_state().items() if k != "epoch"}

    gc = []
    clock.advance(700.0)
    for h in hosts[::2]:
        svc.announce_host(h)
    with svc.state_lock:
        gc.append(svc.pool.gc())
    clock.advance(300.0)
    with svc.state_lock:
        gc.append(svc.pool.gc())
    out["gc"] = gc
    out["after_gc"] = (sorted(svc.pool.hosts), sorted(svc.pool.tasks), svc.pool.peer_count())

    svc.telemetry.flush()
    out["downloads"] = _record_dict(svc.telemetry.downloads.load_all())
    out["probes"] = _record_dict(svc.telemetry.probes.load_all())
    out["decisions"] = [
        {k: v for k, v in d.items() if k not in ("trace_id", "serving_mode", "seq")}
        for d in svc.decision_records(limit=1 << 20)["records"]
    ]
    return out


def assert_same(a: dict, b: dict, *, skip: tuple = ()) -> None:
    """Every observable of two scenario runs equal; record arrays field for
    field, bit for bit."""
    assert set(a) == set(b)
    for key in a:
        if key in skip:
            continue
        if key in ("downloads", "probes"):
            assert set(a[key]) == set(b[key])
            for field in a[key]:
                x, y = a[key][field], b[key][field]
                assert x.dtype == y.dtype and x.shape == y.shape, (key, field)
                assert x.tobytes() == y.tobytes(), (key, field)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("pkg", [PORT, REF], ids=["port", "ref"])
def test_the_scenario_is_deterministic_and_seed_driven(pkg, tmp_path):
    runs = []
    for seed in (0, 0, 1):
        svc = make_service(pkg, tmp_path / f"s{len(runs)}", seed=seed)
        try:
            runs.append(asyncio.run(asyncio.wait_for(run_scenario(svc, pkg, seed=seed), 120)))
        finally:
            svc.close()
    assert_same(runs[0], runs[1])
    with pytest.raises(AssertionError):
        assert_same(runs[0], runs[2])
    assert runs[0]["edges"] and runs[0]["gc"][0]["peers"] > 0 and len(runs[0]["decisions"]) >= 20
