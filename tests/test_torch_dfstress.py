"""The port's dfstress against the JAX package's, on the CPU.

- The scoring artifact: the JAX package's tool builds ``s.dfsc`` from the
  JAX trainer's init and a jitted embed; ``build_scoring_artifact`` given
  the same weights must write the same head weights bit for bit and the
  embeddings within the tolerance tests/test_torch_models.py holds the
  encoder to, and the reference's native scorer on the JAX file and the
  port's on the port file must score 64 seeded rounds within 5e-3.
- ``run_scoring_stress`` on ``device="cpu"``, both engines, at the
  reference test's sizes (tests/test_stress.py): its ``extra`` has the
  reference's keys plus ``engine`` and ``device``, the measured ones
  positive, the scheduler-only ones null, and the micro-batcher coalesced.
- ``main`` prints one JSON line and refuses to score without a card unless
  told; ``run_stress`` drives a port ``RpcServer`` on a unix socket; the
  wire works over a unix socket both ways between the packages.
"""

import argparse
import ast
import asyncio
import json
import pathlib
import struct

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.cli import dfstress as ref_dfstress
from dragonfly2_tpu.models.graphsage import TopoGraph as JaxTopoGraph
from dragonfly2_tpu.native import NativeScorer as RefNativeScorer, export_scorer_artifact as ref_export
from dragonfly2_tpu.rpc import core as ref_core
from dragonfly2_tpu.trainer import synthetic as jax_synthetic, train_gnn as jax_train_gnn
from dragonfly2_tpu_torch.cli import dfstress
from dragonfly2_tpu_torch.models.features import FEATURE_DIM
from dragonfly2_tpu_torch.native import NativeScorer
from dragonfly2_tpu_torch.rpc import core
from dragonfly2_tpu_torch.trainer import artifacts

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

SCORE_MAX_ABS = 5e-3  # the repo's serving tolerance (tests/test_torch_scorer.py)
# tests/test_torch_models.py's bounds on the port's embeddings against flax's
EMBED_MAX_ABS, EMBED_MIN_COSINE = 2e-2, 0.999
PARITY_NODES, SEED = 256, 7
DEADLINE_S = 60.0


def _reference_extra_keys() -> set:
    """The keys of the ``extra`` dict the JAX package's run_scoring_stress
    returns, read from its source (running it needs its whole scheduler)."""
    tree = ast.parse(pathlib.Path(ref_dfstress.__file__).read_text())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.AsyncFunctionDef) and n.name == "run_scoring_stress")
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return) and isinstance(n.value, ast.Dict))
    extra = next(v for k, v in zip(ret.value.keys, ret.value.values) if k.value == "extra")
    return {k.value for k in extra.keys}


def _dfsc(path) -> tuple[tuple, np.ndarray, bytes]:
    """(header, embeddings, head weight bytes) of a scorer.dfsc file."""
    b = pathlib.Path(path).read_bytes()
    head = struct.unpack("<7I", b[:28])
    n, d = head[2], head[3]
    z = np.frombuffer(b[28 : 28 + 4 * n * d], np.float32).reshape(n, d)
    return head, z, b[28 + 4 * n * d :]


def test_scoring_artifact_matches_the_jax_tools(tmp_path):
    # the JAX package's steps (cli/dfstress.py's run_scoring_stress), at 256 nodes
    cluster = jax_synthetic.make_cluster(num_nodes=PARITY_NODES, num_neighbors=16, num_pairs=4096, seed=SEED)
    cfg = jax_train_gnn.GNNTrainConfig()
    model = jax_train_gnn.make_model(cfg)
    state = jax_train_gnn.init_state(cfg, cluster.graph, rng_seed=SEED)
    g = JaxTopoGraph(*(jnp.asarray(a) for a in cluster.graph))
    z = np.asarray(jax.jit(lambda p, gg: model.apply(p, gg, method=model.embed))(state.params, g))
    ref_path = ref_export(state.params, z, tmp_path / "s.dfsc")

    params = jax.tree.map(np.asarray, state.params)
    d, digest, hosts, pair_feats = dfstress.build_scoring_artifact(
        tmp_path / "port", n_nodes=PARITY_NODES, seed=SEED, params=params, device="cpu")
    np.testing.assert_array_equal(pair_feats, cluster.pairs.feats)
    assert digest == artifacts.artifact_digest(d)
    assert hosts == {f"h{i}": i for i in range(PARITY_NODES)}
    assert artifacts.load_graph(d)[1] == hosts
    assert {p.name for p in d.iterdir()} == {"params.msgpack", "config.json", "graph.npz", "hosts.json",
                                              "scorer.dfsc"}

    want_head, want_z, want_w = _dfsc(ref_path)
    got_head, got_z, got_w = _dfsc(d / "scorer.dfsc")
    assert got_head == want_head and got_head[2:5] == (PARITY_NODES, cfg.embed_dim, FEATURE_DIM)
    assert got_w == want_w  # head weights bit for bit
    cos = (got_z * want_z).sum(-1) / (np.linalg.norm(got_z, axis=-1) * np.linalg.norm(want_z, axis=-1))
    assert np.abs(got_z - want_z).max() <= EMBED_MAX_ABS
    assert cos.min() >= EMBED_MIN_COSINE

    rng = np.random.default_rng(0)
    child = rng.integers(0, PARITY_NODES, (64, 40), dtype=np.int32)
    parent = rng.integers(0, PARITY_NODES, (64, 40), dtype=np.int32)
    feats = cluster.pairs.feats[rng.integers(0, len(cluster.pairs.feats), (64, 40))]
    ref, port = RefNativeScorer(ref_path), NativeScorer(d / "scorer.dfsc")
    try:
        want = ref.score_rounds(feats, child=child, parent=parent)
        got = port.score_rounds(feats, child=child, parent=parent)
    finally:
        ref.close()
        port.close()
    assert got.shape == (64, 40) and np.all((got > 0) & (got < 1))
    assert np.abs(got - want).max() <= SCORE_MAX_ABS


def test_stress_rounds_map_hosts_to_rows():
    hosts = {f"h{i}": (i * 5) % 16 for i in range(16)}
    pair_feats = np.arange(50 * 16, dtype=np.float32).reshape(50, 16)
    feats, child, parent = dfstress.stress_rounds(hosts, pair_feats, hosts=20, concurrency=3, candidates=40)
    pool = dfstress.ROUND_POOL
    assert feats.shape == (pool, 17, 16) and child.shape == parent.shape == (pool, 17)
    # every feature row is one of the given pair rows
    assert np.all(feats[..., 1:] - feats[..., :1] == np.arange(1, 16)) and np.all(feats[..., 0] % 16 == 0)
    rows = [hosts[f"h{i % 16}"] for i in range(20)]
    assert (child == np.array([rows[r % 3] for r in range(pool)])[:, None]).all()
    assert (parent == np.array(rows[3:])).all()
    again = dfstress.stress_rounds(hosts, pair_feats, hosts=20, concurrency=3, candidates=40)
    assert all(np.array_equal(a, b) for a, b in zip(again, (feats, child, parent)))
    with pytest.raises(ValueError, match="no candidate parents"):
        dfstress.stress_rounds(hosts, pair_feats, hosts=3, concurrency=3, candidates=40)


@pytest.mark.parametrize("engine", ["native", "torch"])
def test_scoring_stress_on_the_cpu(engine, monkeypatch):
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "1" if engine == "native" else "0")
    ns = argparse.Namespace(rounds=200, concurrency=4, candidates=40, hosts=64, device="cpu")
    result = asyncio.run(asyncio.wait_for(dfstress.run_scoring_stress(ns), DEADLINE_S))
    json.dumps(result)  # one-line JSON contract
    assert result["metric"] == "scorer_rounds_per_sec" and result["value"] > 0
    ex = result["extra"]
    assert set(ex) == _reference_extra_keys() | {"engine", "device"}
    assert (ex["engine"], ex["device"]) == (engine, "cpu")
    assert ex["candidates_per_round"] == 40 and ex["concurrency"] == 4 and ex["rounds"] == 200
    for key in ("eval_p50_ms", "rounds_per_sec_microbatch", "rounds_per_sec_workers1",
                "rounds_per_sec_workers2", "thread_scaling_speedup", "ffi_us_per_round_amortized",
                "host_cpu_count", "host_cpu_count_os", "dispatch_workers"):
        assert ex[key] > 0, key
    assert ex["eval_p99_ms"] >= ex["eval_p50_ms"]
    assert ex["eval_best_config"] in ("microbatch", "workers1", "workers2")
    assert result["value"] == ex[f"rounds_per_sec_{ex['eval_best_config']}"]
    for key in dfstress._SCHEDULER_ONLY_KEYS:
        assert ex[key] is None, key
    # the micro-batcher coalesced, over exactly the three microbatch legs
    assert ex["native_rounds"] == 3 * 200 and 0 < ex["native_flushes"] < ex["native_rounds"]


def test_main_prints_one_json_line(capsys):
    assert dfstress.main(["--scoring", "--rounds", "40", "--concurrency", "2", "--hosts", "48",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    out = json.loads(lines[0])
    assert out["metric"] == "scorer_rounds_per_sec" and out["extra"]["concurrency"] == 2


def test_main_cuts_only_the_worker_legs(capsys, monkeypatch):
    calls = []
    score_on_worker = dfstress._ServingShapes._score_on_worker
    monkeypatch.setattr(dfstress._ServingShapes, "_score_on_worker",
                        lambda self, r: calls.append(r) or score_on_worker(self, r))
    assert dfstress.main(["--scoring", "--rounds", "40", "--worker-rounds", "12", "--concurrency", "2",
                          "--hosts", "48", "--device", "cpu"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["extra"]["rounds"] == 40 and out["extra"]["native_rounds"] == 3 * 40
    assert "worker legs cut to 12 rounds" in out["unit"]
    # warm-up: 3 passes of 2 rounds on each worker leg; then 3 repetitions of 12
    assert len(calls) == 2 * (3 * 2 + 3 * 12)


def test_main_refuses_to_score_without_a_card_unless_told():
    if torch.cuda.is_available():
        pytest.skip("a card is present: --scoring would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dfstress.main(["--scoring", "--rounds", "10"])
    with pytest.raises(SystemExit):
        dfstress.main([])  # download mode needs a url


@pytest.mark.parametrize("failing", [0, 7], ids=["clean", "with_errors"])
def test_run_stress_over_a_unix_socket(tmp_path, failing):
    """Download mode against a port RpcServer on a unix socket whose stub
    ``download`` handler fails the first ``failing`` requests."""
    seen = []

    async def download(p):
        seen.append(p)
        if len(seen) <= failing:
            raise core.RpcError("origin unreachable", code="unavailable")
        return {"task_id": "t", "content_length": 14}

    async def body():
        server = core.RpcServer(unix_path=str(tmp_path / "d.sock"))
        server.register("download", download)
        await server.start()
        try:
            assert server.address == str(tmp_path / "d.sock")
            ns = argparse.Namespace(url="http://origin/f.bin?x=1", sock=server.address, concurrency=4,
                                    duration=30.0, count=25, timeout=30.0, unique=True,
                                    priority=3.0, priority_split=1)
            return await dfstress.run_stress(ns)
        finally:
            await server.stop()

    result = asyncio.run(asyncio.wait_for(body(), DEADLINE_S))
    json.dumps(result)
    ex = result["extra"]
    assert set(ex) == {"requests", "errors", "elapsed_s", "concurrency", "priority_split", "unique_tasks",
                       "p50_ms", "p90_ms", "p99_ms"}
    assert (ex["requests"], ex["errors"]) == (25 - failing, failing)
    assert ex["priority_split"] == 1 and ex["unique_tasks"] and result["value"] > 0
    assert sorted(p["url"] for p in seen) == sorted(f"http://origin/f.bin?x=1&stress={i}" for i in range(1, 26))
    assert {p["priority"] for p in seen} == {3.0, 1.0}  # one worker at --priority


class _Echo:
    async def echo(self, p):
        return p


@pytest.mark.parametrize("direction", ["port_client_ref_server", "ref_client_port_server"])
def test_the_wire_over_a_unix_socket(tmp_path, direction):
    # a colon in a path does not make it a TCP address
    sock = str(tmp_path / "rpc:1.sock")

    async def body():
        port_server = direction == "ref_client_port_server"
        server = (core.RpcServer if port_server else ref_core.RpcServer)(unix_path=sock)
        server.register_service(_Echo(), ["echo"])
        await server.start()
        client = ref_core.RpcClient(sock, retries=0) if port_server else core.RpcClient(sock)
        try:
            assert server.address == sock
            payload = {"data": b"\x00\x01" * 20_000, "rows": [1, -2, 3], "f": 0.5}
            assert await client.call("echo", payload) == payload
            got = await asyncio.gather(*(client.call("echo", i) for i in range(8)))
            assert got == list(range(8))
            assert await client.healthy()
        finally:
            await client.close()
            await server.stop()

    asyncio.run(asyncio.wait_for(body(), DEADLINE_S))


def test_a_tcp_address_stays_tcp():
    async def body():
        server = core.RpcServer(host="127.0.0.1", port=0)
        server.register_service(_Echo(), ["echo"])
        await server.start()
        client = core.RpcClient(f"localhost:{server.port}")
        try:
            assert await client.call("echo", "tcp") == "tcp"
        finally:
            await client.close()
            await server.stop()
        with pytest.raises(OSError):  # a path that names no socket
            await core.RpcClient("no-such-dir/x.sock").call("echo", 1)

    asyncio.run(asyncio.wait_for(body(), DEADLINE_S))
