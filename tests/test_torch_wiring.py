"""The port wired into the system's control loop, end to end on the CPU.

Scheduler telemetry in a port ``TelemetryStorage`` → the port's
``TrainerAnnouncer`` → the port's trainer server (over the JAX package's
wire protocol) → ``TrainerService`` trains on the CPU → both models are
published to the reference ``ManagerServer`` → a reference
``SchedulerService`` whose ``ManagerLink`` loads through the port's
``load_scorer_verified``, ``classify_swap_error`` and drift loader (put in
place of its flax-bound static methods, as tests/test_rollout.py puts a
fake loader in place) attaches the model, serves a round scored by it with
``ML_SERVING_MODE{mode="native"}`` at 1, and refuses a corrupt version as
``digest_mismatch``. Then the reference's own announcer uploads to the
port's server, which trains again. A reference scheduler whose evaluator is
the port's (the reference's plugin slot) serves a torch-trained model with
the port's ``ML_SERVING_MODE`` at ``torch`` or ``native`` (its ManagerLink
loading through the port's loader) or at ``jax`` (through the reference's
own), its rounds ordered by the model's scores, through a swap and a
rollback. Last, the
entry point: ``python -m dragonfly2_tpu_torch.trainer.server --device cpu
--port 0`` prints ``TRAINER_READY`` and stops on SIGTERM.
"""

import asyncio
import functools
import logging
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from dragonfly2_tpu.manager.server import ManagerServer
from dragonfly2_tpu.observability.sketches import DriftDetector, FeatureSketch as RefFeatureSketch
from dragonfly2_tpu.rpc.manager import RemoteManagerClient
from dragonfly2_tpu.scheduler import metrics as sched_metrics
from dragonfly2_tpu.scheduler.announcer import TrainerAnnouncer as RefTrainerAnnouncer
from dragonfly2_tpu.scheduler.evaluator import new_evaluator
from dragonfly2_tpu.scheduler.manager_link import ManagerLink
from dragonfly2_tpu.scheduler.service import HostInfo as RefHostInfo
from dragonfly2_tpu.scheduler.service import SchedulerService
from dragonfly2_tpu.scheduler.service import TaskMeta as RefTaskMeta
from dragonfly2_tpu.telemetry import TelemetryStorage as RefTelemetryStorage
from dragonfly2_tpu_torch.models.features import BASE_WEIGHTS
from dragonfly2_tpu_torch.native import NativeScorer
from dragonfly2_tpu_torch.observability.tracing import default_tracer
from dragonfly2_tpu_torch.scheduler import evaluator as port_evaluator
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.scheduler import metrics as port_metrics
from dragonfly2_tpu_torch.scheduler.announcer import CHUNK_ROWS, TrainerAnnouncer
from dragonfly2_tpu_torch.telemetry import DOWNLOAD_DTYPE, ColumnarStore, TelemetryStorage
from dragonfly2_tpu_torch.trainer import train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.server import start_trainer, stop_trainer
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records
from test_scheduler import add_running_peer, make_pool_with_task

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

DEADLINE_S = 120.0
PORT_EVALUATOR_SPEC = "plugin:dragonfly2_tpu_torch.scheduler.evaluator:MLEvaluator"
REPO = Path(__file__).resolve().parent.parent


def _fill_telemetry(store, n_hosts: int = 10, n_rows: int = 250, seed: int = 3) -> None:
    """tests/test_trainer_service.py's telemetry, over the host ids the
    scheduler's pool uses (make_pool_with_task names them h0, h1, ...)."""
    rng = np.random.default_rng(seed)
    hosts = [f"h{i}".encode() for i in range(n_hosts)]
    capacity = rng.random(n_hosts) * 0.9 + 0.1
    for _ in range(n_rows):
        c, p = rng.integers(0, n_hosts, 2)
        feats = rng.random(16).astype(np.float32)
        feats[1] = capacity[p]
        store.downloads.append(
            task_id=b"t1", child_peer_id=b"c", parent_peer_id=b"p",
            child_host_id=hosts[c], parent_host_id=hosts[p],
            piece_count=10, piece_size=4 << 20, content_length=40 << 20,
            bandwidth_bps=capacity[p] * (1 << 30) * (0.8 + 0.4 * rng.random()), piece_cost_ms_mean=50.0,
            success=True, back_to_source=False, pair_features=feats,
        )
    for s in range(n_hosts):
        for d in rng.choice(n_hosts, size=4, replace=False):
            if d != s:
                store.probes.append(
                    src_host_id=hosts[s], dst_host_id=hosts[int(d)], rtt_mean_ms=rng.random() * 50,
                    rtt_std_ms=rng.random() * 5, rtt_min_ms=rng.random() * 20, probe_count=10,
                )


def _config(tmp_path) -> TrainerConfig:
    """tests/test_trainer_service.py's widths, on the CPU."""
    return TrainerConfig(
        model_dir=str(tmp_path / "models"), device="cpu",
        mlp=train_mlp.MLPTrainConfig(hidden=(32, 32), steps=60, batch_size=128),
        gnn=train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=128, warmup_steps=5),
        gnn_steps=20,
    )


def _install_drift_reference(ev, row: dict):
    """ManagerLink._install_drift_reference over the port's loader: the
    port's sketch, handed to the reference detector in its own type."""
    sketch = manager_link.load_drift_reference(row.get("artifact_path", ""))
    ref = None if sketch is None else RefFeatureSketch.from_dict(sketch.to_dict())
    ev.drift.set_reference(ref, version=row.get("version", ""))
    return ref


def _metric(metric, **labels) -> float:
    return float(metric.labels(**labels).value)


def test_a_scheduler_attaches_a_torch_trained_model(tmp_path, monkeypatch):
    monkeypatch.setattr(ManagerLink, "_load_scorer_verified",
                        staticmethod(functools.partial(manager_link.load_scorer_verified, device="cpu")))
    monkeypatch.setattr(ManagerLink, "_classify_swap_error", staticmethod(manager_link.classify_swap_error))
    monkeypatch.setattr(ManagerLink, "_install_drift_reference", staticmethod(_install_drift_reference))

    async def body():
        manager = ManagerServer(db_path=str(tmp_path / "m.db"))
        await manager.start()
        mc = RemoteManagerClient(manager.address)
        server, service = await start_trainer(_config(tmp_path), port=0, manager_addr=manager.address)
        store = TelemetryStorage(tmp_path / "telemetry")
        _fill_telemetry(store)
        ann = TrainerAnnouncer(store, server.address, hostname="sch1", scheduler_id=0)
        svc = SchedulerService(evaluator=new_evaluator("ml"))
        link = None
        try:
            # telemetry → the port's announcer → the port's trainer → the manager
            out = await ann.upload_once()
            assert out["downloads"] == 250 and out["probes"] > 0 and out["rows"] == 250 + out["probes"]
            assert len(store.downloads.load_all()) == 0  # the uploaded snapshot is discarded
            (span,) = [s for s in default_tracer().finished() if s.name == "announcer.upload"][-1:]
            assert span.attrs["rows"] == out["rows"] and span.attrs["scheduler"] == "sch1"
            await service.wait_idle()
            res = service.last_result
            assert service.trains_succeeded == 1 and "mlp" in res and "gnn" in res, res
            gnn_row, mlp_row = await mc.active_model("gnn", 0), await mc.active_model("mlp", 0)
            assert gnn_row["version"] == mlp_row["version"] == res["version"]
            assert gnn_row["state"] == mlp_row["state"] == "active"
            assert gnn_row["artifact_digest"] == res["gnn"]["digest"] and gnn_row["evaluation"]["steps"] == 20

            # a reference scheduler attaches it through the port's loader
            pool, task, hosts = make_pool_with_task(6)
            svc.pool = pool
            child = add_running_peer(pool, task, hosts[0])
            for h in hosts[1:]:
                add_running_peer(pool, task, h, pieces=2).host.upload_limit = 1000
            ev = svc.evaluator
            ev.drift = DriftDetector()
            link = ManagerLink(svc, manager.address, hostname="sch-test", ip="127.0.0.1", port=1)
            await link._check_model()
            bundle = ev.serving_bundle
            assert ev.serving_version == res["version"] and isinstance(bundle.scorer, NativeScorer)
            assert _metric(sched_metrics.ML_SERVING_MODE, mode="native") == 1.0
            assert ev.drift.reference_version == res["version"]
            fallbacks = sum(_metric(sched_metrics.ML_BASE_FALLBACK_TOTAL, reason=r)
                            for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded"))
            result = await svc.reschedule(child.id)
            assert result.parents and bundle.microbatch.rounds >= 1  # the round went through the model
            assert sum(_metric(sched_metrics.ML_BASE_FALLBACK_TOTAL, reason=r)
                       for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded")) == fallbacks

            # a corrupt version is refused and never attached
            bad = shutil.copytree(res["gnn"]["artifact"], tmp_path / "gnn-corrupt")
            (bad / "params.msgpack").write_bytes(b"CORRUPTED" + (bad / "params.msgpack").read_bytes()[9:])
            await mc.publish_model("gnn", "corrupt-1", scheduler_id=0, artifact_path=str(bad),
                                   artifact_digest=res["gnn"]["digest"])
            try:
                await link._check_model()
                raise AssertionError("a corrupt artifact attached")
            except Exception as e:
                assert manager_link.classify_swap_error(e) == "digest_mismatch", e
            assert _metric(sched_metrics.MODEL_SWAP_LAST_ERROR, error="digest_mismatch") == 1.0
            assert ev.serving_version == res["version"] and ev.serving_bundle is bundle

            # the reference's announcer uploads to the port's server, which trains again
            ref_store = RefTelemetryStorage(tmp_path / "ref-telemetry")
            _fill_telemetry(ref_store, n_rows=100, seed=9)
            ref_ann = RefTrainerAnnouncer(ref_store, server.address, hostname="sch2", scheduler_id=0)
            try:
                assert (await ref_ann.upload_once())["downloads"] == 100
            finally:
                await ref_ann.stop()
            await service.wait_idle()
            assert service.trains_succeeded == 2, service.last_result
            second = service.last_result["version"]
            assert second != res["version"] and (await mc.active_model("gnn", 0))["version"] == second
            await link._check_model()
            assert ev.serving_version == second
        finally:
            if link is not None:
                await link.manager.close()
            await ann.stop()
            await stop_trainer(server, service)
            await mc.close()
            await manager.stop()
            svc.close()

    asyncio.run(asyncio.wait_for(body(), DEADLINE_S))


@pytest.fixture(scope="module")
def two_versions(tmp_path_factory):
    """Two GNN artifacts, trained one after the other by the port's trainer
    service on the CPU from two telemetry draws: [(version, path, digest)]."""
    root = tmp_path_factory.mktemp("two")
    cfg = TrainerConfig(
        model_dir=str(root / "models"), device="cpu",
        mlp=train_mlp.MLPTrainConfig(hidden=(32, 16), steps=10, batch_size=64),
        gnn=train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=2),
        gnn_steps=8, gnn_steps_per_call=4,
    )

    async def body():
        svc = TrainerService(cfg)
        out = []
        for seed in (5, 6):
            d, p = synth_telemetry_records(500, 300, 24, seed=seed)
            token = (await svc.train_open({"hostname": "sch1"}))["token"]  # dflint: disable=DF025 one session per version
            for kind, arr in (("downloads", d), ("probes", p)):
                await svc.train_chunk({"token": token, "kind": kind, "data": pack_records(arr)})  # dflint: disable=DF025 one chunk per kind
            await svc.train_close({"token": token})  # dflint: disable=DF025 one session per version
            await svc.wait_idle()
            res = svc.last_result
            assert "gnn" in res, res
            out.append((res["version"], res["gnn"]["artifact"], res["gnn"]["digest"]))
        return out

    out = asyncio.run(asyncio.wait_for(body(), DEADLINE_S))
    assert out[0][0] != out[1][0]
    return out


def _port_gauges() -> dict:
    return {m: _metric(port_metrics.ML_SERVING_MODE, mode=m) for m in port_evaluator.SERVING_MODES}


def _serving(mode: str) -> dict:
    return {m: float(m == mode) for m in port_evaluator.SERVING_MODES}


def _port_fallbacks() -> float:
    return sum(_metric(port_metrics.ML_BASE_FALLBACK_TOTAL, reason=r)
               for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded"))


@pytest.mark.parametrize("engine", ["native", "torch", "jax"])
def test_a_reference_scheduler_serves_the_port_evaluator(engine, two_versions, tmp_path, monkeypatch, caplog):
    """The fix for the reference evaluator's missing "torch" label: a
    reference SchedulerService whose evaluator is the port's, loaded through
    the reference's plugin slot, attaches a torch-trained artifact through
    its ManagerLink. With the port's loader in the ManagerLink, the port's
    ML_SERVING_MODE reads the engine that serves (torch with
    DRAGONFLY_NATIVE_SCORER=0, else native) at 1 and the others at 0. With
    the reference's own loader and DRAGONFLY_NATIVE_SCORER=0 ("jax"), the
    reference's JAX GNNScorer serves: jax reads 1, with a warning that the
    native scorer is not active. In each, register_peer returns the parents
    in the order of the model's scores; a second publish swaps the bundle
    and a rollback restores the first."""
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "1" if engine == "native" else "0")
    if engine != "jax":
        monkeypatch.setattr(ManagerLink, "_load_scorer_verified",
                            staticmethod(functools.partial(manager_link.load_scorer_verified, device="cpu")))
        monkeypatch.setattr(ManagerLink, "_classify_swap_error", staticmethod(manager_link.classify_swap_error))
        monkeypatch.setattr(ManagerLink, "_install_drift_reference", staticmethod(_install_drift_reference))
    (v1, path1, digest1), (v2, path2, digest2) = two_versions

    async def body():
        manager = ManagerServer(db_path=str(tmp_path / "m.db"))
        await manager.start()
        mc = RemoteManagerClient(manager.address)
        svc = SchedulerService(evaluator=new_evaluator(PORT_EVALUATOR_SPEC), decision_sample_rate=1.0)
        ev = svc.evaluator
        link = None
        try:
            assert type(ev) is port_evaluator.MLEvaluator and _port_gauges() == _serving("base")
            await mc.publish_model("gnn", v1, scheduler_id=0, artifact_path=path1, artifact_digest=digest1)
            link = ManagerLink(svc, manager.address, hostname="sch-test", ip="127.0.0.1", port=1)
            caplog.clear()
            with caplog.at_level(logging.INFO, logger=port_evaluator.__name__):
                await link._check_model()
            first = ev.serving_bundle
            assert ev.serving_version == v1 and first.scorer.engine == engine
            assert _port_gauges() == _serving(engine)
            (rec,) = [r for r in caplog.records if r.name == port_evaluator.__name__]
            assert rec.levelname == ("WARNING" if engine == "jax" else "INFO"), rec.getMessage()
            assert rec.getMessage().startswith(f"ml evaluator serving mode: {engine}")
            assert ev.drift.reference_version == v1

            # a task with five running parents on hosts the model knows
            hosts = sorted(first.node_index)[:7]
            task = svc.pool.load_or_create_task("t1", "http://origin/f")
            task.set_metadata(100 << 20)
            for i, h in enumerate(hosts[1:6]):
                host = svc.pool.load_or_create_host(h, f"10.0.0.{i + 1}", f"host{i + 1}", download_port=8001 + i)
                add_running_peer(svc.pool, task, host, pieces=2 + i).host.upload_limit = 1000
            before = _port_fallbacks()
            rounds0 = first.microbatch.rounds
            child = RefHostInfo(id=hosts[0], ip="10.0.0.100", hostname="child", download_port=8100)
            res1 = await svc.register_peer("child-peer", RefTaskMeta(task_id="t1", url="http://origin/f"), child)
            assert res1.parents and not res1.back_to_source and first.microbatch.rounds == rounds0 + 1
            (rec,) = [r for r in svc.decisions.snapshot(task_id="t1") if r["child_peer"] == "child-peer"]
            assert rec["model_version"] == v1 and rec["serving_mode"] == engine
            # the recorded round's scores are the model's, and the parents
            # come back in their order
            feats = np.asarray(rec["feats"], np.float32)
            idx = first.node_index
            c = np.full(len(feats), idx[hosts[0]], np.int32)
            par = np.array([idx[p["host"]] for p in rec["parents"]], np.int32)
            model = first.scorer.score(feats, child=c, parent=par)
            np.testing.assert_allclose(rec["scores"], model, rtol=0, atol=0 if engine == "native" else 1e-6)
            assert not np.allclose(rec["scores"], feats @ BASE_WEIGHTS)
            assert [p.peer_id for p in res1.parents] == rec["chosen"]
            order = np.argsort(-np.asarray(rec["scores"], np.float32), kind="stable")
            assert rec["chosen"] == [rec["parents"][i]["peer"] for i in order[: len(rec["chosen"])]]
            assert _port_fallbacks() == before

            # a second publish swaps the bundle; a rollback restores the first
            await mc.publish_model("gnn", v2, scheduler_id=0, artifact_path=path2, artifact_digest=digest2)
            await link._check_model()
            assert ev.serving_version == v2 and ev.serving_bundle is not first and link._warm_prev is first
            assert _port_gauges() == _serving(engine)
            await link._rollback(["a test rollback"])
            assert ev.serving_version == v1 and ev.serving_bundle is first
            assert _port_gauges() == _serving(engine)
            res2 = await svc.register_peer("child-peer-2", RefTaskMeta(task_id="t1", url="http://origin/f"),
                                           RefHostInfo(id=hosts[6], ip="10.0.0.101", hostname="child2"))
            assert res2.parents and first.microbatch.rounds == rounds0 + 2 and _port_fallbacks() == before
        finally:
            if link is not None:
                await link.manager.close()
            await mc.close()
            await manager.stop()
            svc.close()

    asyncio.run(asyncio.wait_for(body(), DEADLINE_S))


def test_the_announcer_chunks_by_rows(tmp_path):
    """CHUNK_ROWS rows a frame, as the reference announcer sends them."""

    class Recorder:
        def __init__(self):
            self.chunks = []

        async def train_open(self, hostname, scheduler_id):
            return "tok"

        async def train_chunk(self, token, kind, arr):
            self.chunks.append((kind, len(arr)))
            return sum(n for _, n in self.chunks)

        async def train_close(self, token):
            return None

        async def close(self):
            return None

    store = TelemetryStorage(tmp_path / "t", rotate_rows=3000)
    for i in range(CHUNK_ROWS + 10):
        store.downloads.append(child_host_id=b"h%d" % (i % 7), parent_host_id=b"h1")
    store.downloads.append(child_host_id=b"late", parent_host_id=b"h1")
    ann = TrainerAnnouncer(store, "127.0.0.1:1", clear_after_upload=False)
    ann.trainer = Recorder()
    out = asyncio.run(ann.upload_once())
    assert ann.trainer.chunks == [("downloads", CHUNK_ROWS), ("downloads", 11)]
    assert out == {"rows": CHUNK_ROWS + 11, "downloads": CHUNK_ROWS + 11, "probes": 0}
    assert len(store.downloads) == CHUNK_ROWS + 11  # nothing discarded without clear_after_upload


def test_port_telemetry_files_are_the_references(tmp_path):
    """The same rows appended to either package's store rotate into files
    of the same name and the same records (their append times aside)."""
    port, ref = TelemetryStorage(tmp_path / "port"), RefTelemetryStorage(tmp_path / "ref")
    _fill_telemetry(port, n_rows=40)
    _fill_telemetry(ref, n_rows=40)
    for kind in ("downloads", "probes"):
        a, b = getattr(port, kind), getattr(ref, kind)
        assert a.flush().name == b.flush().name
        got = getattr(RefTelemetryStorage(tmp_path / "port"), kind).load_all()  # port files, reference reader
        want = b.load_all()
        assert got.dtype == want.dtype and len(got) == len(want) > 0
        for name in got.dtype.names:
            assert name == "created_at" or np.array_equal(got[name], want[name]), name


def test_extend_rotates_as_one_append_per_row(tmp_path):
    rows = np.zeros(700, DOWNLOAD_DTYPE)
    rows["child_host_id"] = [b"h%d" % i for i in range(700)]
    rows["created_at"] = np.arange(700)
    bulk, single = (ColumnarStore(tmp_path / name, "download", DOWNLOAD_DTYPE, rotate_rows=256, max_backups=10)
                    for name in ("bulk", "single"))
    bulk.extend(rows[:300])
    bulk.extend(rows[300:])
    for r in rows:
        single.append(**{k: r[k] for k in DOWNLOAD_DTYPE.names})
    assert [p.name for p in bulk._files()] == [p.name for p in single._files()] == ["download-0.npz", "download-1.npz"]
    assert bulk.load_all().tobytes() == single.load_all().tobytes() == rows.tobytes()


def test_trainer_server_entry_point_starts_on_the_cpu_and_stops_on_sigterm(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.trainer.server", "--device", "cpu", "--port", "0",
         "--model-dir", str(tmp_path / "models")],
        cwd=tmp_path, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
    )
    try:
        deadline = time.monotonic() + DEADLINE_S
        line = proc.stdout.readline()
        assert line.startswith("TRAINER_READY 127.0.0.1:"), (line, proc.poll())
        port = int(line.split(":")[-1])
        assert port > 0 and time.monotonic() < deadline
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=max(1.0, deadline - time.monotonic())) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()
        proc.stderr.close()


def test_trainer_server_refuses_to_start_without_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the server would start on it")
    p = subprocess.run(
        [sys.executable, "-m", "dragonfly2_tpu_torch.trainer.server", "--port", "0",
         "--model-dir", str(tmp_path / "models")],
        cwd=tmp_path, env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True, text=True,
        timeout=DEADLINE_S,
    )
    assert p.returncode != 0 and "TRAINER_READY" not in p.stdout and "no CUDA device" in p.stderr
