"""The port's ``dfcluster`` and the vsock transport of its RPC core.

- ``dfcluster demo --verify-trace`` at a small multi-piece payload exits 0
  within 120 s: the seed and the P2P copy bit-exact, the dfget's rounds on
  exactly one scheduler and federation spans on both; every process it
  starts is the port's (each ``-m`` module it launches is
  ``dragonfly2_tpu_torch.*``, or the standard library's ``http.server``
  origin), never the reference package.
- ``parse_vsock`` answers the reference's for good and bad addresses; the
  vsock loopback round trip, with either package's client against the
  port's server, runs where the kernel has vsock loopback and skips with
  the reason where it has not.

Every process and coroutine runs under a deadline of 120 s.
"""

from __future__ import annotations

import asyncio
import subprocess

import pytest
import torch

from dragonfly2_tpu.rpc import core as ref_core
from dragonfly2_tpu_torch.cli import dfcluster
from dragonfly2_tpu_torch.rpc import core as port_core

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

DEADLINE_S = 120.0
# multi-piece (past the 4 MiB piece), so the P2P copy runs a real round
PAYLOAD_KB = "4608"


def test_demo_verify_trace_passes_launching_only_the_ports_processes(tmp_path, monkeypatch, capsys):
    """``demo --verify-trace`` within its deadline, every process it starts
    recorded: each ``-m`` module is the port's or the stdlib origin."""
    import time

    launched: list[list[str]] = []
    real = subprocess.Popen

    class Recording(real):
        def __init__(self, args, *a, **kw):
            launched.append(list(args))
            super().__init__(args, *a, **kw)

    monkeypatch.setattr(subprocess, "Popen", Recording)
    monkeypatch.setattr(dfcluster.subprocess, "Popen", Recording)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    t0 = time.monotonic()
    rc = dfcluster.main(["demo", "--verify-trace", "--payload-kb", PAYLOAD_KB, "--dir", str(tmp_path / "box")])
    elapsed = time.monotonic() - t0
    out = capsys.readouterr()
    assert rc == 0, out.out[-2000:] + out.err[-2000:]
    assert elapsed < DEADLINE_S
    assert "both bit-exact" in out.out
    assert "trace ok" in out.out and "federation spans on all 2 schedulers" in out.out
    traces = {f.name for f in (tmp_path / "box" / "traces").iterdir()}
    assert {"scheduler-0.jsonl", "scheduler-1.jsonl", "daemon-0.jsonl", "daemon-1.jsonl", "dfget-p2p.jsonl"} <= traces
    modules = [args[args.index("-m") + 1] for args in launched if "-m" in args]
    assert len(modules) == len(launched) >= 8  # manager, 2 schedulers, 2 daemons, origin, 2 dfgets
    assert set(modules) == {"dragonfly2_tpu_torch.manager.server", "dragonfly2_tpu_torch.scheduler.server",
                            "dragonfly2_tpu_torch.daemon.server", "dragonfly2_tpu_torch.cli.dfget", "http.server"}


@pytest.mark.parametrize("address", ["vsock://2:9000", "vsock://4294967295:1", "vsock://:9000", "vsock://2:",
                                     "vsock://host:90", "vsock://2", "vsock://3:x"])
def test_parse_vsock_answers_the_references(address):
    def answer(mod):
        try:
            return mod.parse_vsock(address)
        except ValueError as e:
            return ("ValueError", str(e))

    assert answer(port_core) == answer(ref_core)


@pytest.mark.parametrize("client_pkg", ["port", "ref"])
def test_the_vsock_loopback_round_trip(client_pkg):
    try:
        probe = port_core.vsock_socket()
        # CID 1 is VMADDR_CID_LOCAL (vsock_loopback): bind fails without it
        probe.bind((1, 0))
        port = probe.getsockname()[1]
        probe.close()
    except OSError as e:
        pytest.skip(f"no vsock loopback in this kernel: {e}")
    client_core = port_core if client_pkg == "port" else ref_core

    async def body():
        server = port_core.RpcServer(vsock_port=port)

        async def echo(p):
            return {"echo": p}

        server.register("echo", echo)
        await server.start()
        client = client_core.RpcClient(f"vsock://1:{port}", retries=0)
        try:
            return await client.call("echo", {"x": 1}), server.address
        finally:
            await client.close()
            await server.stop()

    out, address = asyncio.run(asyncio.wait_for(body(), DEADLINE_S))
    assert out == {"echo": {"x": 1}} and address == f"vsock://2:{port}"
