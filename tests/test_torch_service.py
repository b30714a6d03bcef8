"""The port's trainer service, on the CPU: records in, MLP and GNN artifacts out.

The analogues of tests/test_trainer_service.py's full loop and thin-data
skip, and of tests/test_dataset_ingest.py's session, drainer and pool cases,
without the RPC front: the service is driven through its own coroutines, and
the manager is a fake that records ``publish_model`` calls. The GNN
artifact's graph is held bit for bit to the JAX package's ``build_dataset``
on the same records.
"""

import asyncio

import numpy as np
import pytest
import torch

from dragonfly2_tpu.trainer import dataset as jax_dataset
from dragonfly2_tpu.trainer import service as jax_service
from dragonfly2_tpu_torch.models import GNNScorer
from dragonfly2_tpu_torch.observability.metrics import default_registry
from dragonfly2_tpu_torch.observability.tracing import Tracer, default_tracer
from dragonfly2_tpu_torch.trainer import artifacts, train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer import metrics as train_metrics
from dragonfly2_tpu_torch.trainer.service import RUN_HISTORY_CAP, TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

CHUNK = 128


def _config(tmp_path, **kw):
    kw.setdefault("device", "cpu")
    return TrainerConfig(
        model_dir=str(tmp_path / "models"),
        mlp=train_mlp.MLPTrainConfig(hidden=(32, 16), steps=25, batch_size=64),
        gnn=train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=2),
        gnn_steps=12, gnn_steps_per_call=4, **kw,
    )


class FakeManager:
    """Records what the service publishes, as the manager client's
    ``publish_model`` would receive it."""

    def __init__(self):
        self.published = []

    async def publish_model(self, model_type, version, **kw):
        self.published.append((model_type, version, kw))
        return {"state": "active"}


async def _upload(svc, d, p, hostname="sch1", chunk=CHUNK):
    """One scheduler upload: open, all download chunks, all probe chunks, close."""
    token = (await svc.train_open({"hostname": hostname, "scheduler_id": 0}))["token"]
    for kind, arr in (("downloads", d), ("probes", p)):
        for s in range(0, len(arr), chunk):
            await svc.train_chunk(  # dflint: disable=DF025 the upload protocol is one train_chunk per chunk
                {"token": token, "kind": kind, "data": pack_records(arr[s : s + chunk])})
    return await svc.train_close({"token": token})


def test_pack_records_is_the_jax_wire_format():
    d, p = synth_telemetry_records(20, 10, 5, seed=1)
    for arr in (d, p):
        assert pack_records(arr) == jax_service.pack_records(arr)
        back = jax_service.unpack_records(pack_records(arr))
        assert back.dtype == arr.dtype and back.tobytes() == arr.tobytes()


def test_full_loop_gives_both_models(tmp_path):
    """Records → chunks → pool → dataset → MLP + GNN → artifacts → registry."""
    d, p = synth_telemetry_records(600, 400, 30, seed=3)
    manager = FakeManager()

    async def body():
        svc = TrainerService(_config(tmp_path), manager=manager)
        out = await _upload(svc, d, p)
        assert out["queued"]
        await svc.wait_idle()
        first = svc.last_result
        d2, p2 = synth_telemetry_records(200, 100, 40, seed=9)
        await _upload(svc, d2, p2, hostname="sch2")
        await svc.wait_idle()
        return svc, first, await svc.status()

    svc, res, status = asyncio.run(body())
    assert svc.trains_started == svc.trains_succeeded == 2
    assert "mlp" in res and "gnn" in res, res
    want = jax_dataset.build_dataset(d, p)
    assert (res["num_pairs"], res["num_nodes"]) == (want.num_pairs, want.num_nodes)

    for m in ("mlp", "gnn"):
        artifacts.verify_artifact(res[m]["artifact"], res[m]["digest"])
        sk = artifacts.load_sketch(res[m]["artifact"])
        np.testing.assert_array_equal(sk.counts, want.feature_sketch.counts)
        assert sk.rows == want.num_pairs
    # the GNN artifact's graph and host index are the JAX build's, bit for bit
    graph, hosts = artifacts.load_graph(res["gnn"]["artifact"])
    for name, a, b in zip(graph._fields, graph, want.graph):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert hosts == {k.decode(): v for k, v in want.host_index.items()}
    model, sd = artifacts.load_gnn(res["gnn"]["artifact"])
    scorer = GNNScorer(model, sd, device="cpu")
    scorer.refresh(graph)
    scores = scorer.score(want.pairs.feats[:5], child=want.pairs.child[:5], parent=want.pairs.parent[:5])
    assert scores.shape == (5,) and np.all((scores > 0) & (scores < 1))
    assert (tmp_path / "models" / f"gnn-{res['version']}" / "scorer.dfsc").exists()
    mlp, _ = artifacts.load_mlp(res["mlp"]["artifact"])
    assert mlp.hidden == (32, 16)

    assert res["mlp"]["telemetry"]["steps"] == 25 and res["gnn"]["telemetry"]["steps"] == 12
    assert res["gnn"]["evaluation"]["steps"] == 12 and np.isfinite(res["gnn"]["evaluation"]["final_loss"])
    assert set(res["mlp"]["evaluation"]) == {"train_mse", "eval_mse", "train_seconds"}

    # both versions registered cluster-wide, each run's pool contributors attached
    assert [(m, v) for m, v, _ in manager.published] == [
        ("mlp", res["version"]), ("gnn", res["version"]),
        ("mlp", svc.last_result["version"]), ("gnn", svc.last_result["version"])]
    assert svc.last_result["version"] != res["version"]
    for _, _, kw in manager.published[:2]:
        assert kw["scheduler_id"] == 0 and kw["evaluation"]["contributors"] == ["sch1"]
    assert manager.published[3][2]["evaluation"]["contributors"] == ["sch1", "sch2"]
    assert manager.published[1][2]["artifact_digest"] == res["gnn"]["digest"]
    assert status["pool_pairs"] == svc.last_result["num_pairs"] and not status["training"]
    assert status["trains_succeeded"] == 2 and status["open_sessions"] == 0

    # the run's spans parent to each other: run → build, mlp, gnn, publish
    spans = {s.name: s for s in default_tracer().finished() if s.name.startswith("trainer.")}
    run = spans["trainer.train_run"]
    for name in ("trainer.dataset_build", "trainer.train_mlp", "trainer.train_gnn", "trainer.publish"):
        assert spans[name].parent_id == run.span_id and spans[name].trace_id == run.trace_id


def test_thin_data_is_skipped(tmp_path):
    d, _ = synth_telemetry_records(3, 0, 4, seed=2)

    async def body():
        svc = TrainerService(_config(tmp_path, min_pairs=16))
        await _upload(svc, d, d[:0])
        await svc.wait_idle()
        with pytest.raises(KeyError):
            await svc.train_chunk({"token": "bogus", "kind": "downloads", "data": b""})
        token = (await svc.train_open({}))["token"]
        with pytest.raises(ValueError):
            await svc.train_chunk({"token": token, "kind": "bogus", "data": pack_records(d)})
        return svc, await svc.train_history()

    svc, hist = asyncio.run(body())
    assert "mlp" not in svc.last_result and "gnn" not in svc.last_result
    assert svc.trains_succeeded == 1 and hist["runs"][0]["status"] == "skipped"
    assert hist["runs"][0]["models"] == {}


def test_mlp_only_without_enough_probe_rows(tmp_path):
    d, p = synth_telemetry_records(300, 5, 20, seed=4)

    async def body():
        svc = TrainerService(_config(tmp_path, min_probe_rows=8))
        await _upload(svc, d, p)
        await svc.wait_idle()
        return svc

    svc = asyncio.run(body())
    assert "mlp" in svc.last_result and "gnn" not in svc.last_result


def test_evicted_or_uncommitted_session_contributes_nothing(tmp_path):
    d, p = synth_telemetry_records(200, 100, 10, seed=5)
    d2, p2 = synth_telemetry_records(80, 40, 10, seed=6)

    async def body():
        svc = TrainerService(_config(tmp_path, session_ttl=0.05, min_pairs=10_000))
        stale = (await svc.train_open({"hostname": "old"}))["token"]
        await svc.train_chunk({"token": stale, "kind": "downloads", "data": pack_records(d)})
        open_only = (await svc.train_open({"hostname": "streaming"}))["token"]
        await svc.train_chunk({"token": open_only, "kind": "probes", "data": pack_records(p)})
        assert (await svc.status())["pool_pairs"] == 0  # nothing is visible before a close commits
        await asyncio.sleep(0.06)
        await svc.train_chunk({"token": open_only, "kind": "probes", "data": pack_records(p[:1])})  # activity
        await _upload(svc, d2, p2, hostname="fresh")  # its open evicts the idle session
        await svc.wait_idle()
        with pytest.raises(KeyError):
            await svc.train_close({"token": stale})
        return svc, await svc.status()

    svc, status = asyncio.run(body())
    assert svc.sessions_evicted == 1 and status["open_sessions"] == 1
    want = jax_dataset.build_dataset(d2, p2)
    assert svc._acc.download_rows == len(d2) and svc._acc.probe_rows == len(p2)
    assert status["pool_pairs"] == want.num_pairs and status["pool_hosts"] == len(want.host_index)


def test_closes_on_the_same_pool_coalesce(tmp_path):
    async def body():
        svc = TrainerService(_config(tmp_path))
        ran, release = [], asyncio.Event()

        async def slow_training(sess):
            ran.append(sess.token)
            await release.wait()
            return {"version": sess.token, "num_pairs": 0, "num_nodes": 0}

        svc._run_training = slow_training
        tokens = [(await svc.train_open({"hostname": f"s{i}"}))["token"] for i in range(4)]
        await svc.train_close({"token": tokens[0]})
        await asyncio.sleep(0.01)  # the drainer enters run 1 and blocks
        for t in tokens[1:]:
            out = await svc.train_close({"token": t})  # dflint: disable=DF025 test drives N sequential closes to pin drainer coalescing
        assert out["queue_depth"] == 3 and (await svc.status())["training"]
        release.set()
        await svc.wait_idle()
        return svc, ran, tokens

    svc, ran, tokens = asyncio.run(body())
    # the three closes that landed mid-run share the pool: one run covers them
    assert ran == [tokens[0], tokens[3]] and svc.last_result["version"] == tokens[3]
    assert svc.trains_started == 2 and svc.trains_coalesced == 2 and svc.trains_succeeded == 2


@pytest.mark.parametrize("cap", ["pool_max_hosts", "pool_max_edges"])
def test_pool_rotates_past_its_caps(cap, tmp_path):
    d, p = synth_telemetry_records(100, 30, 20, seed=16)

    async def body():
        svc = TrainerService(_config(tmp_path, min_pairs=10_000, **{cap: 8}))
        await _upload(svc, d, p)
        await svc.wait_idle()
        first = svc.last_result
        await _upload(svc, d[:2], p[:0])  # under the caps: no second rotation
        await svc.wait_idle()
        return svc, first, await svc.status()

    svc, first, status = asyncio.run(body())
    # the queued run trained on the over-cap pool it folded into...
    assert first["num_nodes"] == len(jax_dataset.build_dataset(d, p).host_index)
    # ...and the shared pool was rotated fresh, so aggregates stay bounded
    assert svc.pool_rotations == 1 and status["pool_edges"] == 0
    assert status["pool_hosts"] == len(jax_dataset.build_dataset(d[:2], p[:0]).host_index) <= 4


def test_train_history_shape(tmp_path):
    d, p = synth_telemetry_records(300, 200, 20, seed=7)

    async def body():
        svc = TrainerService(_config(tmp_path))
        await _upload(svc, d, p)
        await svc.wait_idle()
        svc.cfg.min_pairs = 10_000
        await _upload(svc, d[:5], p[:0])
        await svc.wait_idle()
        return (await svc.train_history(), await svc.train_history({"limit": 1, "with_curves": False}),
                await svc.train_history({"with_curves": False}))

    full, one, compact = asyncio.run(body())
    assert full["total"] == 2 and [r["status"] for r in full["runs"]] == ["skipped", "ok"]
    ok = full["runs"][1]
    assert set(ok) == {"run_id", "started_at", "wall_s", "status", "scheduler", "dataset", "models"}
    assert set(ok["dataset"]) == {"pairs", "nodes", "build_seconds"} and ok["scheduler"] == "sch1"
    assert set(ok["models"]) == {"mlp", "gnn"}
    for info in ok["models"].values():
        assert {"artifact", "digest", "evaluation", "steps", "examples", "final_loss", "grad_norm",
                "steps_per_sec", "curve"} <= set(info)
        assert len(info["digest"]) == 16 and info["curve"] and "contributors" not in info["evaluation"]
    assert ok["models"]["gnn"]["curve"][-1][0] == 12 and ok["models"]["mlp"]["curve"][-1][0] == 25
    assert len(one["runs"]) == 1 and one["runs"][0]["status"] == "skipped" and one["total"] == 2
    assert all("curve" not in info for r in compact["runs"] for info in r["models"].values())
    assert RUN_HISTORY_CAP == jax_service.RUN_HISTORY_CAP


def _failing_run(tmp_path, monkeypatch, config_kw, patch):
    d, p = synth_telemetry_records(300, 200, 20, seed=8)
    if patch:
        def boom(*a, **kw):
            raise RuntimeError("trainer fault")

        monkeypatch.setattr(train_mlp, "train", boom)
    errors = train_metrics.TRAIN_RUNS_TOTAL.labels(result="error").value

    async def body():
        svc = TrainerService(_config(tmp_path, **config_kw))
        await _upload(svc, d, p)
        await svc.wait_idle()
        return svc, await svc.train_history()

    svc, hist = asyncio.run(body())
    assert svc.last_result == {"error": "training failed"} and svc.trains_succeeded == 0
    assert hist["runs"][0]["status"] == "error" and hist["runs"][0]["models"] == {}
    assert train_metrics.TRAIN_RUNS_TOTAL.labels(result="error").value == errors + 1
    assert f'dragonfly_train_runs_total{{result="error"}} {int(errors) + 1}' in default_registry().render_text()


def test_a_trainer_fault_is_recorded_as_an_error(tmp_path, monkeypatch):
    _failing_run(tmp_path, monkeypatch, {}, patch=True)


def test_the_default_device_never_falls_back_to_the_cpu(tmp_path, monkeypatch):
    """With no card, the default config's run fails through resolve_device:
    the service records the error and trains nothing on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _failing_run(tmp_path, monkeypatch, {"device": None}, patch=False)


def test_config_defaults_match_jax():
    mine, ref = TrainerConfig(), jax_service.TrainerConfig()
    for name in ("model_dir", "gnn_steps", "gnn_steps_per_call", "min_pairs", "min_probe_rows", "pool_rows",
                 "pool_max_hosts", "pool_max_edges", "session_ttl"):
        assert getattr(mine, name) == getattr(ref, name), name
    assert mine.device is None
    assert (mine.mlp.hidden, mine.mlp.batch_size, mine.mlp.steps) == (ref.mlp.hidden, ref.mlp.batch_size, ref.mlp.steps)
    assert (mine.gnn.hidden, mine.gnn.embed_dim, mine.gnn.num_layers, mine.gnn.batch_size) == \
        (ref.gnn.hidden, ref.gnn.embed_dim, ref.gnn.num_layers, ref.gnn.batch_size)


def test_spans_nest_take_an_explicit_parent_and_record_errors():
    tracer = Tracer()
    with tracer.span("root", a=1) as root:
        assert Tracer.current() is root and Tracer.current_context() == root.context
        with tracer.span("child") as child:
            pass
    with pytest.raises(RuntimeError):
        with tracer.span("late", parent=root.context):
            raise RuntimeError("boom")
    assert Tracer.current() is None
    late = tracer.finished()[-1]
    assert [s.name for s in tracer.finished()] == ["child", "root", "late"]
    assert child.parent_id == late.parent_id == root.span_id and root.parent_id == ""
    assert child.trace_id == late.trace_id == root.trace_id and len(root.trace_id) == 32
    # a sampled span carries its tracer's service name, as the reference's does
    assert root.attrs == {"a": 1, "service": tracer.service} and root.sampled and root.end >= root.start
    assert (late.status, late.error) == ("error", "RuntimeError: boom") and child.status == "ok"
