"""The port's faultline against the JAX package's, and its four sites.

One spec and one seed drive both registries over one scripted,
single-threaded traversal of ``fire``, ``check`` and ``mutate`` for every
kind: the outcomes (exception types and messages, mutated bytes, injection
counts) must be the same. ``parse_spec`` must refuse the same bad specs.
Then the sites: ``model.load`` corrupts or truncates the bytes the digest
reads, so ``load_scorer_verified`` refuses the artifact as
``digest_mismatch``, and its ``error``/``drop`` fire before verification
and classify as ``load_error``; ``rpc.read`` and ``rpc.write`` fail the
port client's call as they fail the reference client's, and on a server's
read and reply path as they do on the reference server's, each client
retrying with its defaults and meeting the fault as often. The two
registries are separate: each test enables only the one it names, and
every test leaves both disabled.
"""

import asyncio
import pathlib
import shutil
import time

import pytest
import torch

from dragonfly2_tpu.resilience import backoff as ref_backoff
from dragonfly2_tpu.resilience import faultline as ref_faultline
from dragonfly2_tpu.rpc import core as ref_core
from dragonfly2_tpu_torch.cli.dfstress import build_scoring_artifact
from dragonfly2_tpu_torch.resilience import backoff, faultline
from dragonfly2_tpu_torch.rpc import core
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.trainer import artifacts

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

DEADLINE_S = 60.0
# every kind on its own point, and two mutate rules sharing one
SPEC = (
    "p.fire:latency:0.3:0.001,p.fire:error:0.3,p.fire:drop:0.3,"
    "p.check:latency:0.5:0.001,p.check:error:0.2,p.check:drop:0.2,"
    "p.body:truncate:0.3,p.body:corrupt:0.5,p.cut:truncate:0.6:3,seed=13"
)
BAD_SPECS = ["p:bogus:0.5", "p:error:1.5", "p:error:-0.1", "p:error", "p:error:0.5:1:2",
             "p:error:abc", "p:latency:0.5:zz", "seed=x", "p::0.5"]


@pytest.fixture(autouse=True)
def _both_disabled():
    yield
    faultline.disable()
    ref_faultline.disable()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


def _traverse(fl) -> list:
    """The scripted traversal: one outcome per step."""

    async def body():
        out = []

        def record(fn, *args, **kw):
            try:
                res = fn(*args, **kw)
            except OSError as e:
                out.append(("raise", type(e).__name__, str(e)))
                return
            out.append(("ok",) if res is None else ("bytes", res))

        async def fired(point):
            try:
                await fl.fire(point)
            except OSError as e:
                return ("raise", type(e).__name__, str(e))
            return ("ok",)

        for i in range(60):
            payload = bytes(range(i % 7, i % 7 + 24))
            out.append(await fired("p.fire"))
            record(fl.check, "p.check")
            record(fl.check, "p.check", blocking_latency=True)
            record(fl.mutate, "p.body", payload)
            record(fl.mutate, "p.cut", payload)
            record(fl.mutate, "p.fire", payload)  # no mutate rule: passes through
            out.append(await fired("p.none"))
        return out

    return _run(body())


def test_one_spec_gives_the_reference_outcomes_over_one_traversal():
    assert faultline.KINDS == ref_faultline.KINDS
    mine, ref = faultline.parse_spec(SPEC), ref_faultline.parse_spec(SPEC)
    assert [(r.point, r.kind, r.rate, r.param) for r in mine.rules] == \
        [(r.point, r.kind, r.rate, r.param) for r in ref.rules]
    got, want = _traverse(mine), _traverse(ref)
    assert got == want
    assert mine.injected == ref.injected and mine.injected_total() == ref.injected_total()
    # the traversal reached every kind, and every outcome
    assert {k for _, k in mine.injected} == set(faultline.KINDS)
    assert {o[0] for o in got} == {"ok", "raise", "bytes"}
    assert {o[1] for o in got if o[0] == "raise"} == {"FaultError", "ConnectionResetError"}
    assert mine.injected_total("p.body") == ref.injected_total("p.body") > 0


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_spec_refuses_what_the_reference_refuses(spec):
    with pytest.raises(ValueError) as want:
        ref_faultline.parse_spec(spec)
    with pytest.raises(ValueError) as got:
        faultline.parse_spec(spec)
    assert str(got.value) == str(want.value)


def test_enable_disable_and_the_environment(monkeypatch):
    assert faultline.ACTIVE is None
    fl = faultline.enable("model.load:error:0.5,seed=4")
    assert faultline.ACTIVE is fl and fl.seed == 4 and ref_faultline.ACTIVE is None
    faultline.disable()
    assert faultline.ACTIVE is None
    monkeypatch.delenv("DF_FAULTS", raising=False)
    assert faultline.install_from_env() is None and faultline.ACTIVE is None
    monkeypatch.setenv("DF_FAULTS", "rpc.read:drop:0.25")
    fl = faultline.install_from_env()
    assert faultline.ACTIVE is fl and fl.rules[0].point == "rpc.read"
    monkeypatch.setenv("DF_FAULTS", "rpc.read:drop")
    with pytest.raises(ValueError):
        faultline.install_from_env()


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    art = build_scoring_artifact(tmp_path_factory.mktemp("fl") / "a", n_nodes=32, device="cpu")
    return str(art.path), art.digest


@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_model_load_mutation_is_refused_as_digest_mismatch(artifact, kind):
    path, digest = artifact
    files = sum(1 for p in pathlib.Path(path).rglob("*") if p.is_file())
    fl = faultline.enable(f"model.load:{kind}:1.0,seed=3")
    with pytest.raises(artifacts.ArtifactIntegrityError) as e:
        manager_link.load_scorer_verified(path, digest, device="cpu")
    assert manager_link.classify_swap_error(e.value) == "digest_mismatch"
    assert fl.injected_total("model.load") == files
    faultline.disable()
    scorer, hosts = manager_link.load_scorer_verified(path, digest, device="cpu")
    assert scorer.engine == "native" and len(hosts) == 32
    scorer.close()


@pytest.mark.parametrize("kind,exc", [("error", faultline.FaultError), ("drop", ConnectionResetError)])
def test_model_load_fault_fires_before_verification(artifact, tmp_path, kind, exc):
    path, digest = artifact
    missing = str(tmp_path / "never-written")
    faultline.enable(f"model.load:{kind}:1.0")
    # it fires before the digest is taken: a missing directory is not reached
    with pytest.raises(exc) as e:
        manager_link.load_scorer_verified(missing, digest, device="cpu")
    assert manager_link.classify_swap_error(e.value) == "load_error"
    faultline.enable("model.load:latency:1.0:0.2")
    t0 = time.perf_counter()
    scorer, _ = manager_link.load_scorer_verified(path, digest, device="cpu")
    assert time.perf_counter() - t0 >= 0.2
    scorer.close()


def test_model_load_corruption_reaches_only_its_own_registry(artifact, tmp_path):
    """A reference-only chaos spec does not reach the port's digest, and a
    spec enabled in both does."""
    path, digest = artifact
    copy = shutil.copytree(path, tmp_path / "copy")
    ref_faultline.enable("model.load:corrupt:1.0")
    assert artifacts.artifact_digest(copy) == digest
    faultline.enable("model.load:corrupt:1.0")
    assert artifacts.artifact_digest(copy) != digest


class _Echo:
    async def echo(self, p):
        return p


def _pair(port_client: bool, port_server: bool):
    """A server of one package and a client factory of one package; both
    clients keep their default retries, on one short fixed backoff."""
    server = (core.RpcServer if port_server else ref_core.RpcServer)(host="127.0.0.1", port=0)
    server.register_service(_Echo(), ["echo"])
    cls, policy = (core.RpcClient, backoff.BackoffPolicy) if port_client else (ref_core.RpcClient,
                                                                                ref_backoff.BackoffPolicy)
    return server, lambda a: cls(a, backoff=policy(base=0.01, jitter=0.0))


def _failure(port: bool, spec: str, *, faulted_client: bool) -> tuple:
    """What the first call on a new connection fails with when ``spec`` is
    enabled in one package's registry, and the call after it is disabled,
    with the number of faults injected (a client's retries meet the fault
    again). ``faulted_client``: that package's client against its own
    server; else that package's server against the other package's client."""

    async def body():
        server, make_client = _pair(port_client=port == faulted_client, port_server=port)
        await server.start()
        client = make_client(server.address)
        try:
            fl = (faultline if port else ref_faultline).enable(spec)
            try:
                await client.call("echo", 1, timeout=0.5)
                got = ("no error",)
            except OSError as e:  # FaultError / ConnectionResetError
                got = (type(e).__name__, str(e))
            except (core.RpcError, ref_core.RpcError) as e:
                got = (type(e).__name__, e.code)
            faultline.disable()
            ref_faultline.disable()
            assert await client.call("echo", 2) == 2  # the client recovers
            return got + (fl.injected_total(spec.split(":")[0]),)
        finally:
            await client.close()
            await server.stop()

    return _run(body())


@pytest.mark.parametrize("spec,want", [
    # the client meets the fault on its first attempt and on its 3 retries;
    # a read fault fires on the server's read and on the client's, each attempt
    ("rpc.write:error:1.0", ("FaultError", "faultline: injected error at rpc.write", 4)),
    ("rpc.read:drop:1.0", ("ConnectionClosed", "unavailable", 8)),
])
def test_rpc_faults_fail_the_port_client_as_the_reference_client(spec, want):
    assert _failure(True, spec, faulted_client=True) == _failure(False, spec, faulted_client=True) == want


@pytest.mark.parametrize("spec,want", [
    # a reply the server fails to write never comes: the caller's deadline,
    # which is not retried
    ("rpc.write:error:1.0", ("RpcError", "deadline_exceeded", 1)),
    ("rpc.write:drop:1.0", ("RpcError", "deadline_exceeded", 1)),
    # a failed read drops the connection, on each of the client's 4 attempts
    ("rpc.read:drop:1.0", ("ConnectionClosed", "unavailable", 4)),
    ("rpc.read:error:1.0", ("ConnectionClosed", "unavailable", 4)),
])
def test_rpc_faults_on_the_port_server_as_on_the_reference_server(spec, want):
    assert _failure(True, spec, faulted_client=False) == _failure(False, spec, faulted_client=False) == want


def test_rpc_read_latency_delays_the_port_call():
    async def body():
        server, make_client = _pair(port_client=True, port_server=True)
        await server.start()
        client = make_client(server.address)
        try:
            fl = faultline.enable("rpc.read:latency:1.0:0.1")
            t0 = time.perf_counter()
            assert await client.call("echo", 3) == 3
            # the server's read of the request and the client's of the reply
            assert time.perf_counter() - t0 >= 0.1 and fl.injected_total("rpc.read") >= 2
        finally:
            faultline.disable()
            await client.close()
            await server.stop()

    _run(body())
