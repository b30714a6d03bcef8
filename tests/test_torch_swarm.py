"""``dfstress --swarm`` on the port's scheduler client, balancer and
breaker, against reference schedulers whose evaluator is the port's.

The port's ``run_swarm`` and the reference's each run 1.5 s against the same
two in-process reference schedulers (evaluator
``plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator``): both see
no errors, report the same keys, and their round shares agree within 0.15
and with the ring's placement of the 32 task ids. One scheduler stopped:
its breaker opens in the port's balancer and new task ids go to the
survivor. ``main(["--swarm"])`` without ``--schedulers`` exits with the
reference's message. Last, the entry points end to end: two reference
scheduler processes booting the port's evaluator (its serving-mode line in
their logs) and ``python -m dragonfly2_tpu_torch.cli.dfstress --swarm`` over
them, exit code 0. Every server and process has a 30 s deadline.
"""

import asyncio
import json
import os
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import pytest
import torch

from dragonfly2_tpu.cli import dfstress as ref_dfstress
from dragonfly2_tpu.rpc import scheduler as ref_rpc_scheduler
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu.scheduler.evaluator import new_evaluator
from dragonfly2_tpu_torch.cli import dfstress
from dragonfly2_tpu_torch.resilience import backoff
from dragonfly2_tpu_torch.rpc.balancer import BalancedSchedulerClient, ConsistentHashRing
from dragonfly2_tpu_torch.rpc.core import RpcError
from dragonfly2_tpu_torch.rpc.scheduler import HostInfo, RemoteSchedulerClient, TaskMeta
from dragonfly2_tpu_torch.utils.proc import ready_address
from dragonfly2_tpu_torch.scheduler import evaluator as port_ev

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

DEADLINE_S = 30.0
SPEC = "plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator"
REPO = Path(__file__).resolve().parent.parent
SHARE_TOL = 0.15


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def ring_shares(addrs: list[str], tasks: int = 32) -> dict[str, float]:
    """The share of the swarm's task ids the ring places on each address."""
    ring = ConsistentHashRing(addrs)
    owners = Counter(ring.pick(f"swarm-task-{j:04d}") for j in range(tasks))
    return {a: owners[a] / tasks for a in addrs}


def test_port_and_reference_swarms_share_two_schedulers_alike():
    async def body():
        svcs = [ref_service.SchedulerService(evaluator=new_evaluator(SPEC)) for _ in range(2)]
        assert all(type(s.evaluator) is port_ev.MLEvaluator for s in svcs)
        servers = [ref_rpc_scheduler.serve_scheduler(s) for s in svcs]
        for s in servers:
            await s.start()
        addrs = [s.address for s in servers]
        try:
            port = await dfstress.run_swarm(addrs, peers=40, duration=1.5)
            ref = await ref_dfstress.run_swarm(addrs, peers=40, duration=1.5)
        finally:
            for s in servers:
                await s.stop()
            for s in svcs:
                s.close()
        return addrs, port, ref

    addrs, port, ref = _run(body())
    json.dumps(port)
    assert port.keys() == ref.keys() and port["extra"].keys() == ref["extra"].keys()
    assert port["metric"] == ref["metric"] == "swarm_rounds_per_sec"
    for out in (port, ref):
        ex = out["extra"]
        assert ex["errors"] == 0 and ex["rounds"] > 0 and out["value"] > 0, ex
        assert ex["p50_ms"] is not None and ex["p99_ms"] >= ex["p50_ms"]
    want = ring_shares(addrs)
    for a in addrs:
        got = port["extra"]["per_scheduler_round_share"][a]
        assert 0 < got < 1 and abs(got - ref["extra"]["per_scheduler_round_share"][a]) <= SHARE_TOL
        assert abs(got - want[a]) <= SHARE_TOL


def test_failover_routes_new_tasks_to_the_survivor():
    """One scheduler stops; its address's breaker opens in the port's
    balancer and new task ids it owned go to the survivor, as
    test_new_tasks_route_around_open_breaker asserts with a fake."""

    async def body():
        svcs = [ref_service.SchedulerService(evaluator=new_evaluator(SPEC)) for _ in range(2)]
        servers = [ref_rpc_scheduler.serve_scheduler(s) for s in svcs]
        for s in servers:
            await s.start()
        addrs = [s.address for s in servers]
        bc = BalancedSchedulerClient(addrs, client_factory=lambda a: RemoteSchedulerClient(
            a, retries=4, backoff=backoff.BackoffPolicy(base=0.01, jitter=0.0)))
        host = HostInfo(id="h1", ip="127.0.0.1", hostname="h1")
        dead, live = addrs
        owned = [f"task-{i:04d}" for i in range(400) if bc.ring.pick(f"task-{i:04d}") == dead][:3]
        try:
            await bc.announce_host(host)
            await servers[0].stop()
            with pytest.raises(OSError):  # five refused attempts open the breaker
                await bc.register_peer("p-dead", TaskMeta(owned[0], "http://o/0"), host)
            assert bc._client(dead).breaker.is_open
            for i, tid in enumerate(owned[1:]):
                reg = await bc.register_peer(f"p{i}", TaskMeta(tid, f"http://o/{i}"), host)  # dflint: disable=DF025 one new task each
                assert reg.error == "" and reg.task_id == tid and bc._task_addr[tid] == live
            assert svcs[1].stat_task(owned[1]) is not None and svcs[0].stat_task(owned[1]) is None
            # a learned route to the dead owner fast-fails at its breaker
            with pytest.raises(RpcError, match="circuit open"):
                await bc.report_peer_result("p-dead", success=True)
        finally:
            await bc.close()
            await servers[1].stop()
            for s in svcs:
                s.close()

    _run(body())


def test_swarm_without_schedulers_exits_with_the_references_message():
    with pytest.raises(SystemExit) as port:
        dfstress.main(["--swarm"])
    with pytest.raises(SystemExit) as ref:
        ref_dfstress.main(["--swarm"])
    assert str(port.value) == str(ref.value) == "--swarm requires --schedulers host:port[,host:port...]"


def test_the_swarm_cli_over_two_scheduler_processes(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "dragonfly2_tpu.scheduler.server", "--host", "127.0.0.1", "--port", "0",
           "--evaluator", SPEC]
    deadline = time.monotonic() + DEADLINE_S
    # both boot together, logging to files (a pipe left unread could fill);
    # each is stopped below whatever happens
    logs = [tmp_path / f"scheduler-{i}.log" for i in range(2)]
    procs = []
    for log in logs:
        with open(log, "w") as err:
            procs.append(subprocess.Popen(cmd, cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=err, text=True))
    try:
        addrs = [ready_address(proc, "SCHEDULER_READY", deadline) for proc in procs]
        p = subprocess.run(
            [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfstress", "--swarm", "--schedulers", ",".join(addrs),
             "--peers", "40", "--duration", "1.5"],
            cwd=tmp_path, env=env, capture_output=True, text=True, timeout=max(1.0, deadline - time.monotonic()),
        )
        assert p.returncode == 0, p.stderr[-2000:]
        out = json.loads(p.stdout.strip().splitlines()[-1])
        assert out["metric"] == "swarm_rounds_per_sec" and out["extra"]["errors"] == 0 and out["extra"]["rounds"] > 0
        assert set(out["extra"]["per_scheduler_round_share"]) == set(addrs)
    finally:
        for proc in procs:
            proc.terminate()
            try:
                proc.wait(timeout=DEADLINE_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    for log in logs:
        err = log.read_text()
        # the port's evaluator booted in each: _set_serving_mode's own line
        assert f"WARNING {port_ev.__name__} ml evaluator serving mode: base" in err, err[-2000:]
