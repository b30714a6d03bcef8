"""The port's model loader against the JAX package's ``ManagerLink`` loader.

One artifact trained by the port's ``TrainerService`` on the CPU is loaded
by the port's ``scheduler.manager_link.load_scorer`` and by the reference's
``ManagerLink._load_scorer``: the same host index, bit-equal scores on the
native path (both serve ``scorer.dfsc`` through the C++ scorer) and scores
within 5e-3 of the JAX ``GNNScorer`` on the torch path. The swap-error
kinds (``missing``, ``digest_mismatch`` with bytes flipped on disk after
the digest was taken, ``load_error`` for a wrong format) match the
reference's, and the drift sketch loads as the reference's does. Then the
serving-mode label, against the reference evaluator: ``native`` reads 1 on
the default path; on the torch fallback all three gauges read 0 and the
round is still scored by the model, not by base (the port's evaluator
labels it ``torch``: tests/test_torch_wiring.py).
"""

import asyncio
import json
import logging
import shutil

import numpy as np
import pytest
import torch

from dragonfly2_tpu.scheduler import metrics as sched_metrics
from dragonfly2_tpu.scheduler import resource as res
from dragonfly2_tpu.scheduler.evaluator import new_evaluator
from dragonfly2_tpu.scheduler.manager_link import ManagerLink
from dragonfly2_tpu.trainer import artifacts as ref_artifacts
from dragonfly2_tpu.utils import idgen
from dragonfly2_tpu_torch.models import GNNScorer
from dragonfly2_tpu_torch.native import NativeScorer
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.trainer import artifacts, train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import synth_telemetry_records

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

SCORE_MAX_ABS = 5e-3
HOSTS = 24


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A GNN artifact and its digest, trained and written by the port's
    trainer service on the CPU."""
    root = tmp_path_factory.mktemp("loader")
    cfg = TrainerConfig(
        model_dir=str(root / "models"), device="cpu",
        mlp=train_mlp.MLPTrainConfig(hidden=(32, 16), steps=10, batch_size=64),
        gnn=train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=64, warmup_steps=2),
        gnn_steps=8, gnn_steps_per_call=4,
    )
    d, p = synth_telemetry_records(500, 300, HOSTS, seed=5)

    async def body():
        svc = TrainerService(cfg)
        token = (await svc.train_open({"hostname": "sch1"}))["token"]
        for kind, arr in (("downloads", d), ("probes", p)):
            await svc.train_chunk({"token": token, "kind": kind, "data": pack_records(arr)})  # dflint: disable=DF025 one chunk per kind
        await svc.train_close({"token": token})
        await svc.wait_idle()
        return svc.last_result

    out = asyncio.run(body())
    assert "gnn" in out, out
    return dict(root=root, path=out["gnn"]["artifact"], digest=out["gnn"]["digest"])


def _rounds(host_index: dict, seed: int = 0):
    rng = np.random.default_rng(seed)
    n = len(host_index)
    feats = rng.random((6, 16), dtype=np.float32)
    return feats, rng.integers(0, n, 6, dtype=np.int32), rng.integers(0, n, 6, dtype=np.int32)


def test_native_path_is_the_reference_loaders(trained):
    scorer, idx = manager_link.load_scorer_verified(trained["path"], trained["digest"], device="cpu")
    ref, ref_idx = ManagerLink._load_scorer_verified(trained["path"], trained["digest"])
    assert isinstance(scorer, NativeScorer) and scorer.engine == ref.engine == "native"
    assert idx == ref_idx and len(idx) == HOSTS
    feats, c, p = _rounds(idx)
    np.testing.assert_array_equal(scorer.score(feats, child=c, parent=p), ref.score(feats, child=c, parent=p))


def test_torch_path_is_within_5e3_of_jax(trained, monkeypatch):
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    scorer, idx = manager_link.load_scorer(trained["path"], device="cpu")
    ref, ref_idx = ManagerLink._load_scorer(trained["path"])
    assert isinstance(scorer, GNNScorer) and scorer.engine == "torch" and scorer.device.type == "cpu"
    assert type(ref).__module__ == "dragonfly2_tpu.models.scorer" and idx == ref_idx
    feats, c, p = _rounds(idx, seed=1)
    err = float(np.abs(scorer.score(feats, child=c, parent=p) - ref.score(feats, child=c, parent=p)).max())
    assert err <= SCORE_MAX_ABS, err


def test_the_torch_path_runs_on_the_card_unless_told(trained, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        manager_link.load_scorer(trained["path"])


def test_without_scorer_dfsc_the_loader_serves_torch(trained, tmp_path, caplog):
    d = shutil.copytree(trained["path"], tmp_path / "gnn")
    (d / "scorer.dfsc").unlink()
    with caplog.at_level(logging.INFO, logger=manager_link.__name__):
        scorer, _ = manager_link.load_scorer(str(d), device="cpu")
    assert scorer.engine == "torch"
    assert any("via engine torch on cpu" in r.getMessage() for r in caplog.records)


def test_a_broken_native_artifact_falls_back_to_torch_loudly(trained, tmp_path, caplog):
    d = shutil.copytree(trained["path"], tmp_path / "gnn")
    (d / "scorer.dfsc").write_bytes(b"\x00" * 64)
    with caplog.at_level(logging.INFO, logger=manager_link.__name__):
        scorer, _ = manager_link.load_scorer(str(d), device="cpu")
    assert scorer.engine == "torch"
    (err,) = [r for r in caplog.records if r.levelno == logging.ERROR]
    assert "native scorer unavailable" in err.getMessage() and err.exc_info is not None


def _case(kind: str, trained, tmp_path, monkeypatch) -> tuple[str, str]:
    if kind == "missing":
        return str(tmp_path / "gone"), trained["digest"]
    d = shutil.copytree(trained["path"], tmp_path / "gnn")
    if kind == "digest_mismatch":  # bytes flipped on disk after the digest was taken
        f = d / "params.msgpack"
        f.write_bytes(b"CORRUPTED" + f.read_bytes()[9:])
        return str(d), trained["digest"]
    # a wrong format, under a digest that matches it: only the torch path reads it
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    cfg = json.loads((d / "config.json").read_text())
    (d / "config.json").write_text(json.dumps({**cfg, "format": 1}))
    return str(d), artifacts.artifact_digest(d)


@pytest.mark.parametrize("kind", ["missing", "digest_mismatch", "load_error"])
def test_swap_errors_are_classified_as_the_reference_does(kind, trained, tmp_path, monkeypatch):
    path, digest = _case(kind, trained, tmp_path, monkeypatch)
    with pytest.raises(Exception) as port_exc:
        manager_link.load_scorer_verified(path, digest, device="cpu")
    with pytest.raises(Exception) as ref_exc:
        ManagerLink._load_scorer_verified(path, digest)
    assert manager_link.classify_swap_error(port_exc.value) == kind
    assert ManagerLink._classify_swap_error(ref_exc.value) == kind
    if kind == "digest_mismatch":
        # the reference's classifier knows only its own integrity error
        assert isinstance(port_exc.value, artifacts.ArtifactIntegrityError)
        assert ManagerLink._classify_swap_error(port_exc.value) == "load_error"


def test_drift_reference_loads_as_the_reference_does(trained, tmp_path, caplog):
    got = manager_link.load_drift_reference(trained["path"])
    want = ref_artifacts.load_sketch(trained["path"])
    assert got is not None and got.to_dict() == want.to_dict()
    d = shutil.copytree(trained["path"], tmp_path / "gnn")
    (d / "sketch.json").write_text("{not json")
    with caplog.at_level(logging.ERROR, logger=manager_link.__name__):
        assert manager_link.load_drift_reference(str(d)) is None
    assert any("reference sketch load failed" in r.getMessage() for r in caplog.records)
    (d / "sketch.json").unlink()
    assert manager_link.load_drift_reference(str(d)) is None


def _gauge(mode: str) -> float:
    return float(sched_metrics.ML_SERVING_MODE.labels(mode=mode).value)


def _fallbacks() -> float:
    return sum(float(sched_metrics.ML_BASE_FALLBACK_TOTAL.labels(reason=r).value)
               for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded"))


@pytest.mark.parametrize("engine", ["native", "torch"])
def test_serving_mode_label_on_the_reference_evaluator(engine, trained, monkeypatch):
    """The reference evaluator serving what the port's loader returns. It
    knows no "torch" mode, so on the torch engine its three gauges read 0
    though the model scores the round: a gap of that evaluator, which stays
    as it is. The port's own evaluator, loaded through the reference's
    plugin slot, closes it (tests/test_torch_wiring.py
    test_a_reference_scheduler_serves_the_port_evaluator)."""
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "1" if engine == "native" else "0")
    scorer, idx = manager_link.load_scorer(trained["path"], device="cpu")
    assert scorer.engine == engine
    pool = res.ResourcePool()
    task = pool.load_or_create_task("t1", "http://origin/f")
    task.set_metadata(100 << 20)
    peers = []
    for i, host_id in enumerate(sorted(idx)[:6]):
        host = pool.load_or_create_host(host_id, f"10.0.0.{i}", f"host{i}", download_port=8000 + i)
        peer = pool.create_peer(idgen.peer_id(host.ip, host.hostname), task, host)
        peer.fsm.fire("register")
        peer.fsm.fire("download")
        peers.append(peer)
    ev = new_evaluator("ml")
    ev.attach_scorer(scorer, idx, version="v1")
    if engine == "native":
        assert (_gauge("native"), _gauge("jax"), _gauge("base")) == (1.0, 0.0, 0.0)
    else:  # the reference evaluator has no "torch" mode: a gap of that evaluator
        assert (_gauge("native"), _gauge("jax"), _gauge("base")) == (0.0, 0.0, 0.0)
    before = _fallbacks()
    child, parents = peers[0], peers[1:]
    out = ev.evaluate(child, parents)
    feats, c, p, known = ev._prepare(child, parents, ev.serving_bundle)
    assert c is not None and (known is None or known.all())
    np.testing.assert_array_equal(out, scorer.score(feats, child=c, parent=p))  # the model's scores
    assert not np.array_equal(out, ev._base_from(feats)) and _fallbacks() == before
