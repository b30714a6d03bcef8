"""The port's CUDA kernels, serving, training, the trainer service, staging, an NCCL world of one, the scoring stress and the port's evaluator on a card.

Every test here is marked ``cuda`` and decides inside its fixture whether a
card is present, skipping with a reason on a host without one. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
a card and no JAX (the JAX test bootstrap in conftest.py is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import argparse
import asyncio
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.cli import dfstress
from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.native import MicroBatchScorer
from dragonfly2_tpu_torch.ops import neighbor_agg, neighbor_agg_cuda
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
from dragonfly2_tpu_torch.scheduler import evaluator as port_evaluator
from dragonfly2_tpu_torch.scheduler import manager_link
from dragonfly2_tpu_torch.scheduler import metrics as sched_metrics
from dragonfly2_tpu_torch.tpuvm import safetensors as stlib
from dragonfly2_tpu_torch.tpuvm import staging
from dragonfly2_tpu_torch.trainer import artifacts, dataset, synthetic, train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

# tests/test_ops.py's tolerances for the Pallas kernel against XLA
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def _graph(n, k, h, seed=0, p=0.7):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, h)).astype(np.float32),
            rng.integers(0, n, (n, k)).astype(np.int32),
            (rng.random((n, k)) < p).astype(np.float32))


def _case(name):
    shapes = {"100x7x33": (100, 7, 33), "128x16x256": (128, 16, 256), "257x4x64": (257, 4, 64),
              "1x2x8": (1, 2, 8), "4096x16x256": (4096, 16, 256),
              "k40_more_slots_than_lanes": (64, 40, 48), "h520_more_vectors_than_lanes": (33, 5, 520)}
    if name in shapes:
        return _graph(*shapes[name])
    h, nbr, mask = _graph(64, 4, 16)
    if name == "fully_masked_row":
        mask[3] = 0.0
    elif name == "duplicates":
        h = np.arange(12, dtype=np.float32).reshape(3, 4)
        nbr, mask = np.array([[1, 1], [0, 2], [0, 1]], np.int32), np.ones((3, 2), np.float32)
    elif name == "fractional_mask":
        mask = np.random.default_rng(4).random(mask.shape).astype(np.float32)
    elif name == "out_of_range":
        nbr[0, 0], mask[0, 0] = 64 + 5, 0.0
        nbr[1, 0], mask[1, 0] = -3, 1.0
        nbr[2, 1], mask[2, 1] = 64, 1.0
    elif name == "named_k_times":
        h, nbr, mask = _graph(32, 16, 64, p=1.0)
        nbr[0] = 5
    elif name == "node_named_by_no_slot":
        nbr[nbr == 0] = 1
    elif name == "padding_to_node_0":  # make_cluster's layout: dead slots index 0 with mask 0
        h, nbr, mask = _graph(512, 16, 256, p=1.0)
        for i, deg in enumerate(np.random.default_rng(6).integers(8, 17, 512)):
            nbr[i, deg:], mask[i, deg:] = 0, 0.0
    else:
        raise KeyError(name)
    return h, nbr, mask


CASES = ["100x7x33", "128x16x256", "257x4x64", "1x2x8", "4096x16x256", "k40_more_slots_than_lanes",
         "h520_more_vectors_than_lanes", "fully_masked_row", "duplicates", "fractional_mask", "out_of_range",
         "named_k_times", "node_named_by_no_slot", "padding_to_node_0"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_version(card, name, dtype):
    h, nbr, mask = (torch.from_numpy(a).to(card) for a in _case(name))
    h = h.to(dtype)
    before = neighbor_agg_cuda.LAUNCHES
    got = neighbor_agg.neighbor_aggregate(h, nbr, mask)  # "auto" takes the kernel on the card
    torch.cuda.synchronize()
    assert neighbor_agg_cuda.LAUNCHES == before + 1
    want = neighbor_agg_cuda.neighbor_aggregate_torch(h, nbr, mask)
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    if name == "fully_masked_row":
        assert bool((got[3] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_kernel_unaligned_rows_take_the_scalar_path(card, dtype):
    h, nbr, mask = (torch.from_numpy(a).to(card) for a in _graph(40, 5, 64, seed=2))
    h = torch.empty(h.numel() + 1, dtype=dtype, device=card)[1:].view(h.shape).copy_(h)
    assert h.is_contiguous() and h.data_ptr() % 16 != 0
    got = neighbor_agg_cuda.neighbor_aggregate_cuda(h, nbr, mask)
    torch.testing.assert_close(got.float(), neighbor_agg_cuda.neighbor_aggregate_torch(h, nbr, mask).float(),
                               **TOL[dtype])


def test_kernel_wrapper_refuses_what_it_cannot_take(card):
    h, nbr, mask = (torch.from_numpy(a).to(card) for a in _graph(16, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        neighbor_agg_cuda.neighbor_aggregate_cuda(h.t(), nbr[:8], mask[:8])
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        neighbor_agg_cuda.neighbor_aggregate_cuda(h.double(), nbr, mask)
    with pytest.raises(ValueError, match=r"\[N, K\]"):
        neighbor_agg_cuda.neighbor_aggregate_cuda(h, nbr[:15], mask[:15])
    with pytest.raises(ValueError, match="must lie on"):
        neighbor_agg_cuda.neighbor_aggregate_cuda(h, nbr, mask.cpu())
    out = neighbor_agg.neighbor_aggregate(h, nbr, mask, impl="torch")
    assert out.is_cuda and out.shape == h.shape


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_backward_kernel_matches_plain_version(card, name, dtype):
    h, nbr, mask = (torch.from_numpy(a).to(card) for a in _case(name))
    g = torch.from_numpy(np.random.default_rng(3).normal(size=tuple(h.shape)).astype(np.float32)).to(card, dtype)
    before = neighbor_agg_cuda.BWD_LAUNCHES
    got = neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(g, nbr, mask, h.shape[0])
    torch.cuda.synchronize()
    assert neighbor_agg_cuda.BWD_LAUNCHES == before + 1
    want = neighbor_agg_cuda.neighbor_aggregate_bwd_torch(g, nbr, mask, h.shape[0])
    assert got.dtype == want.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])
    named = torch.zeros(h.shape[0], dtype=torch.bool, device=card)
    live = (mask != 0) & (nbr >= 0) & (nbr < h.shape[0])
    named[nbr[live].long()] = True
    assert bool((got[~named] == 0).all())  # a node no live slot names gets exactly 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", CASES)
def test_kernels_are_bit_identical_over_two_launches(card, name, dtype):
    h, nbr, mask = (torch.from_numpy(a).to(card) for a in _case(name))
    h = h.to(dtype)
    n = h.shape[0]
    index = neighbor_agg_cuda.transpose_index(nbr, mask, n)
    runs = [(neighbor_agg_cuda.neighbor_aggregate_cuda(h, nbr, mask),
             neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(h, nbr, mask, n, index=index)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0][0], runs[1][0]) and torch.equal(runs[0][1], runs[1][1])
    # the wrapper's own index build gives the same bits as the one handed in
    assert torch.equal(neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(h, nbr, mask, n), runs[0][1])


@pytest.mark.parametrize("name", CASES)
def test_transposed_index_on_card_equals_cpu(card, name):
    _, nbr, mask = (torch.from_numpy(a) for a in _case(name))
    on_card = neighbor_agg_cuda.transpose_index(nbr.to(card), mask.to(card), nbr.shape[0])
    on_cpu = neighbor_agg_cuda.transpose_index(nbr, mask, nbr.shape[0])
    live = int(on_cpu.indptr[-1])
    assert torch.equal(on_card.indptr.cpu(), on_cpu.indptr)
    assert torch.equal(on_card.src[:live].cpu(), on_cpu.src[:live])
    torch.testing.assert_close(on_card.weight[:live].cpu(), on_cpu.weight[:live], rtol=1e-6, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_neighbor_aggregate_differentiates_through_the_kernels(card, dtype):
    h, nbr, mask = (torch.from_numpy(a).to(card) for a in _graph(100, 7, 33, seed=5))
    grads = {}
    for impl in ("cuda", "plain"):
        hh = h.to(dtype).requires_grad_()
        before = (neighbor_agg_cuda.LAUNCHES, neighbor_agg_cuda.BWD_LAUNCHES)
        if impl == "cuda":
            out = neighbor_agg.neighbor_aggregate(hh, nbr, mask, impl="cuda")
            assert out.requires_grad and out.grad_fn is not None
        else:
            out = neighbor_agg_cuda.neighbor_aggregate_torch(hh, nbr, mask)
        (grads[impl],) = torch.autograd.grad((out.float() ** 2).sum(), hh)
        torch.cuda.synchronize()
        launched = (neighbor_agg_cuda.LAUNCHES - before[0], neighbor_agg_cuda.BWD_LAUNCHES - before[1])
        assert launched == ((1, 1) if impl == "cuda" else (0, 0))
    torch.testing.assert_close(grads["cuda"].float(), grads["plain"].float(), **TOL[dtype])


def test_backward_wrapper_refuses_what_it_cannot_take(card):
    g, nbr, mask = (torch.from_numpy(a).to(card) for a in _graph(16, 4, 8))
    with pytest.raises(ValueError, match="contiguous"):
        neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(g.t(), nbr[:8], mask[:8], 16)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(g.double(), nbr, mask, 16)
    with pytest.raises(ValueError, match="must lie on"):
        neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(g, nbr.cpu(), mask, 16)
    with pytest.raises(ValueError, match="n must lie"):
        neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(g, nbr, mask, -1)
    with pytest.raises(ValueError, match="transpose_index"):  # an index built for another n
        neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(g, nbr, mask, 16, index=neighbor_agg_cuda.transpose_index(
            nbr, mask, 12))


def test_train_steps_on_card_match_cpu(card):
    cluster = synthetic.make_cluster(num_nodes=256, num_neighbors=8, num_pairs=2048, seed=1)
    cfg = train_gnn.GNNTrainConfig(hidden=64, embed_dim=32, num_layers=2, batch_size=256, warmup_steps=1)
    start = init_flax_like(train_gnn.make_model(cfg), seed=0)
    out = {}
    for dev in (card, torch.device("cpu")):
        state = train_gnn.init_state(cfg, params=start, device=dev)
        g = cluster.graph.to(dev)
        rng = np.random.default_rng(2)
        losses = []
        for _ in range(3):
            state, loss = train_gnn.train_step(state, g, synthetic.sample_batch(cluster.pairs, 256, rng))
            losses.append(float(loss))
        out[dev.type] = (losses, {k: v.cpu() for k, v in state.model.state_dict().items()})
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    assert np.abs(np.array(lg) - np.array(lc)).max() <= 2e-3
    assert max(float((pg[k] - pc[k]).abs().max()) for k in pc) <= 1e-2
    state = train_gnn.init_state(cfg, params=start, device=card)
    multi = train_gnn.make_multi_step(state, cluster.graph, cluster.pairs, batch_size=256, steps_per_call=4)
    state, losses = multi(state)
    assert losses.is_cuda and losses.shape == (4,) and bool(torch.isfinite(losses).all())
    bad = synthetic.PairBatch(cluster.pairs.child.copy(), *cluster.pairs[1:])
    bad.child[0] = 256
    with pytest.raises(ValueError, match="out of range"):  # checked on the host, no device assert
        train_gnn.train_step(state, cluster.graph.to(card), synthetic.PairBatch(*(a[:8] for a in bad)))


def test_gnn_scorer_on_card_matches_cpu(card):
    cluster = synthetic.make_cluster(num_nodes=256, num_neighbors=16, num_pairs=512, seed=1)
    model = TopoScorer(hidden=64, embed_dim=32, num_layers=2, head_hidden=64)
    sd = params_from_flax(init_flax_like(model, seed=0))
    p = cluster.pairs
    feats, child, parent = p.feats[:160].reshape(4, 40, -1), p.child[:160].reshape(4, 40), p.parent[:160].reshape(4, 40)
    scores = {}
    for dev in (card, "cpu"):
        s = GNNScorer(model, sd, device=dev)
        s.refresh(cluster.graph)
        scores[str(dev)] = s.score_rounds(feats, child=child, parent=parent)
    gpu, cpu = scores[str(card)], scores["cpu"]
    assert gpu.shape == (4, 40) and np.all((gpu > 0) & (gpu < 1))
    assert np.abs(gpu - cpu).max() <= 5e-3
    bad = GNNScorer(model, sd, device=card)
    bad.refresh(cluster.graph)
    with pytest.raises(ValueError, match="out of range"):  # checked on the host, no device assert
        bad.score(feats[0], child=child[0] + 256, parent=parent[0])


def test_mlp_train_steps_on_card_match_cpu(card):
    cluster = synthetic.make_cluster(num_nodes=128, num_neighbors=8, num_pairs=4096, seed=5)
    cfg = train_mlp.MLPTrainConfig(batch_size=512)
    start = init_flax_like(train_mlp.make_model(cfg), seed=0)
    rng = np.random.default_rng(3)
    batches = [synthetic.sample_batch(cluster.pairs, 512, rng) for _ in range(3)]
    out = {}
    for dev in (card, torch.device("cpu")):
        model = train_mlp.make_model(cfg)
        model.load_state_dict(params_from_flax(start))
        model.to(dev)
        opt = train_mlp.make_optimizer(cfg, model.parameters())
        losses = [float(train_mlp.train_step(model, opt, i, torch.from_numpy(b.feats).to(dev),
                                             torch.from_numpy(b.label).to(dev))[0]) for i, b in enumerate(batches)]
        out[dev.type] = (losses, {k: v.cpu() for k, v in model.state_dict().items()})
    (lg, pg), (lc, pc) = out["cuda"], out["cpu"]
    assert np.abs(np.array(lg) - np.array(lc)).max() <= 2e-3
    assert max(float((pg[k] - pc[k]).abs().max()) for k in pc) <= 1e-2
    model, ev = train_mlp.train(train_mlp.MLPTrainConfig(steps=20, batch_size=256), cluster.pairs,
                                eval_pairs=cluster.pairs, params=start)  # the card by default
    assert next(model.parameters()).is_cuda and np.isfinite(ev["eval_mse"])


def test_trainer_service_on_card_gives_verified_artifacts(card, tmp_path):
    d, p = synthetic.synth_telemetry_records(3000, 2000, 200, seed=7)
    cfg = TrainerConfig(model_dir=str(tmp_path), mlp=train_mlp.MLPTrainConfig(steps=40, batch_size=512),
                        gnn=train_gnn.GNNTrainConfig(hidden=64, embed_dim=32, num_layers=2, batch_size=512),
                        gnn_steps=20)  # the card by default

    async def body():
        svc = TrainerService(cfg)
        token = (await svc.train_open({"hostname": "s"}))["token"]
        for kind, arr in (("downloads", d), ("probes", p)):
            for s in range(0, len(arr), 512):
                await svc.train_chunk(  # dflint: disable=DF025 the upload protocol is one train_chunk per chunk
                    {"token": token, "kind": kind, "data": pack_records(arr[s : s + 512])})
        await svc.train_close({"token": token})
        await svc.wait_idle()
        return svc.last_result

    res = asyncio.run(body())
    assert "mlp" in res and "gnn" in res, res
    for m in ("mlp", "gnn"):
        artifacts.verify_artifact(res[m]["artifact"], res[m]["digest"])
    assert (pathlib.Path(res["gnn"]["artifact"]) / "scorer.dfsc").exists()
    graph, _ = artifacts.load_graph(res["gnn"]["artifact"])
    want = dataset.build_dataset(d, p)
    assert all(np.array_equal(a, b) for a, b in zip(graph, want.graph))
    model, _ = artifacts.load_mlp(res["mlp"]["artifact"])
    x = torch.from_numpy(want.pairs.feats[:1000])
    with torch.inference_mode():
        assert np.abs(model.to(card)(x.to(card)).cpu().numpy() - model.cpu()(x).numpy()).max() <= 5e-3


def test_staging_to_the_card_is_bit_equal_through_pinned_memory(card, tmp_path):
    rng = np.random.default_rng(8)
    src = {"w": (rng.standard_normal((512, 256), dtype=np.float32).view(np.uint32) >> 16).astype(np.uint16),
           "b": rng.standard_normal(256).astype(np.float32)}
    path = stlib.write_safetensors(tmp_path / "c.safetensors", src, bf16_names=["w"])
    out = staging.stage_tensors(path)  # the card by default
    assert out["w"].device.type == "cuda" and out["w"].dtype == torch.bfloat16
    assert out["w"].view(torch.int16).cpu().numpy().tobytes() == src["w"].tobytes()
    assert out["b"].cpu().numpy().tobytes() == src["b"].tobytes()


def test_world_of_one_under_nccl_in_a_subprocess(card):
    """mp_train joins an NCCL group from DF_DIST_* alone, on the card."""
    (done,) = dist_lib.launch_localhost(1, "dragonfly2_tpu_torch.parallel.mp_train", local_devices=0,
                                        extra_env={"DF_MP_STEPS": "10"}, timeout=300)
    lines = done.stdout.splitlines()
    ok = next(line for line in lines if line.startswith("mp_train ok"))
    assert "procs=1 devices=1" in ok and "mesh={'data': 1, 'model': 1}" in ok and "device=cuda" in ok
    losses = json.loads(next(line for line in lines if line.startswith("MP_LOSSES "))[len("MP_LOSSES "):])
    assert len(losses) == 10 and all(np.isfinite(v) for v in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 0.5, losses


def test_scoring_artifact_built_on_card_serves_both_engines(card, tmp_path, monkeypatch):
    path, digest, hosts, pair_feats = dfstress.build_scoring_artifact(tmp_path / "a", n_nodes=256)  # the card
    feats, child, parent = dfstress.stress_rounds(hosts, pair_feats, hosts=64, concurrency=4, candidates=40)
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "1")
    native, _ = manager_link.load_scorer_verified(str(path), digest)
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    on_card, _ = manager_link.load_scorer_verified(str(path), digest)
    assert native.engine == "native" and on_card.engine == "torch" and on_card.device.type == "cuda"
    a = native.score_rounds(feats, child=child, parent=parent)
    b = on_card.score_rounds(feats, child=child, parent=parent)
    native.close()
    assert np.all((b > 0) & (b < 1)) and np.abs(a - b).max() <= 5e-3


@pytest.mark.parametrize("engine", ["native", "torch"])
def test_short_scoring_stress_on_card(card, engine, monkeypatch):
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "1" if engine == "native" else "0")
    ns = argparse.Namespace(rounds=200, concurrency=4, candidates=40, hosts=64, device=None)
    ex = asyncio.run(dfstress.run_scoring_stress(ns))["extra"]
    assert ex["engine"] == engine
    assert (ex["device"] == "cpu") if engine == "native" else ex["device"].startswith("cuda")
    assert ex["rounds_per_sec_workers2"] > 0 and 0 < ex["native_flushes"] < ex["native_rounds"]


def _record(host_id: str):
    """A plain child or parent record: the evaluator reads only .host.id
    once the feature rows come precomputed."""
    return types.SimpleNamespace(host=types.SimpleNamespace(id=host_id))


@pytest.mark.parametrize("engine", ["native", "torch"])
def test_port_evaluator_serves_the_scorer_on_card(card, engine, tmp_path, monkeypatch):
    """The port's MLEvaluator attached to what the loader returns (GNNScorer
    on the card with DRAGONFLY_NATIVE_SCORER=0): ML_SERVING_MODE reads that
    engine, evaluate() equals the scorer's score() bit for bit and
    evaluate_async() through a MicroBatchScorer within 5e-3 (bit for bit
    natively), with no base fallback."""
    path, digest, hosts, pair_feats = dfstress.build_scoring_artifact(tmp_path / "a", n_nodes=256)  # the card
    feats, child, parent = dfstress.stress_rounds(hosts, pair_feats, hosts=64, concurrency=4, candidates=40)
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "1" if engine == "native" else "0")
    scorer, idx = manager_link.load_scorer_verified(str(path), digest)
    assert scorer.engine == engine and (engine == "native" or scorer.device.type == "cuda")
    ev = port_evaluator.MLEvaluator()
    ev.attach_scorer(scorer, idx, microbatch=MicroBatchScorer(scorer), version="v1")
    modes = {m: float(sched_metrics.ML_SERVING_MODE.labels(mode=m).value) for m in port_evaluator.SERVING_MODES}
    assert modes == {m: float(m == engine) for m in modes}
    name = {v: k for k, v in idx.items()}
    rounds = [(_record(name[int(child[r, 0])]), [_record(name[int(p)]) for p in parent[r]]) for r in range(len(feats))]
    rows = {id(kid): feats[r] for r, (kid, _ps) in enumerate(rounds)}
    ev.feature_builder = lambda kid, parents, topology, bandwidth: rows[id(kid)]
    fallbacks = sum(float(sched_metrics.ML_BASE_FALLBACK_TOTAL.labels(reason=r).value)
                    for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded"))
    want = np.stack([scorer.score(feats[r], child=child[r], parent=parent[r]) for r in range(len(feats))])
    got = np.stack([ev.evaluate(kid, ps) for kid, ps in rounds])
    assert got.tobytes() == want.astype(np.float32).tobytes()

    async def drive():
        return await asyncio.gather(*(ev.evaluate_async(kid, ps) for kid, ps in rounds))

    coalesced = np.stack(asyncio.run(drive()))
    gap = float(np.abs(coalesced - want).max())
    assert gap == 0.0 if engine == "native" else gap <= 5e-3
    assert ev.serving_bundle.microbatch.rounds == len(rounds)
    assert sum(float(sched_metrics.ML_BASE_FALLBACK_TOTAL.labels(reason=r).value)
               for r in ("no_scorer", "unknown_hosts", "scorer_error", "degraded")) == fallbacks
    if engine == "native":
        scorer.close()


def test_a_drained_bundle_releases_the_card(card, tmp_path, monkeypatch):
    """Two torch scorers on the card through the port's evaluator: the
    replaced bundle still holds its scorer and a MicroBatchScorer holds it
    too, yet closing the drained bundle (ModelBundle.close → GNNScorer.close)
    hands the card memory of its tables and weights back."""
    path, digest, hosts, pair_feats = dfstress.build_scoring_artifact(tmp_path / "a", n_nodes=4096)
    monkeypatch.setenv("DRAGONFLY_NATIVE_SCORER", "0")
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    ev = port_evaluator.MLEvaluator()
    first, idx = manager_link.load_scorer_verified(str(path), digest)
    ev.attach_scorer(first, idx, microbatch=MicroBatchScorer(first), version="v1")
    one = torch.cuda.memory_allocated() - base
    assert one > 0
    second, idx2 = manager_link.load_scorer_verified(str(path), digest)
    old = ev.attach_scorer(second, idx2, microbatch=MicroBatchScorer(second), version="v2")
    assert old.version == "v1" and torch.cuda.memory_allocated() - base >= 2 * one * 0.9
    old.begin()
    assert not old.close()  # a round is inside: refused
    old.end()
    assert old.close()
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() - base <= one * 1.1
    assert not first.ready and second.ready


def test_a_daemon_serving_the_proxy_runs_no_cuda_context(card, tmp_path):
    """The port's daemon process booted with the proxy, the HTTPS hijack, the
    SNI proxy and the object gateway, beside this process's CUDA context,
    answers a request through its proxy and maps no CUDA driver library and
    no NVIDIA device file, as this process does."""
    import os
    import re
    import subprocess
    import sys
    import time
    import urllib.request

    from dragonfly2_tpu_torch.utils.proc import ready_address

    torch.zeros(1, device=card)
    assert "libcuda" in pathlib.Path("/proc/self/maps").read_text()
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    procs = []

    def spawn(args, name):
        with open(tmp_path / f"{name}.log", "w") as err:
            p = subprocess.Popen([sys.executable, "-m", *args], cwd=tmp_path, env=env, stdout=subprocess.PIPE,
                                 stderr=err, text=True)
        procs.append(p)
        return p

    try:
        deadline = time.monotonic() + 60
        sched = ready_address(spawn(["dragonfly2_tpu_torch.scheduler.server", "--port", "0"], "scheduler"),
                              "SCHEDULER_READY", deadline)
        d = spawn(["dragonfly2_tpu_torch.daemon.server", "--scheduler", sched, "--storage", str(tmp_path / "d"),
                   "--sock", str(tmp_path / "d.sock"), "--proxy-port", "0", "--sni-proxy-port", "0",
                   "--hijack-ca-dir", "ca", "--object-storage-port", "0"], "daemon")
        ready_address(d, "DAEMON_READY", deadline)
        log = (tmp_path / "daemon.log").read_text()
        gateway = int(re.search(r"object gateway on [\d.]+:(\d+)", log).group(1))
        proxy = int(re.search(r"(?<!sni )proxy on [\d.]+:(\d+)", log).group(1))
        # the gateway's health check, asked through the proxy (a passthrough)
        opener = urllib.request.build_opener(urllib.request.ProxyHandler({"http": f"http://127.0.0.1:{proxy}"}))
        with opener.open(f"http://127.0.0.1:{gateway}/healthz", timeout=30) as r:
            assert json.loads(r.read()) == {"status": "ok"}
        maps = pathlib.Path(f"/proc/{d.pid}/maps").read_text()
        fds = [os.readlink(f) for f in pathlib.Path(f"/proc/{d.pid}/fd").iterdir()]
        assert "libcuda" not in maps and "libcudart" not in maps
        assert not [f for f in fds if "nvidia" in f]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
            p.stdout.close()


def test_a_daemon_on_the_mtls_piece_plane_runs_no_cuda_context(card, tmp_path):
    """The port's daemon process booted with --data-tls-dir, --metrics-port
    and a span file, beside this process's CUDA context, serves its piece
    server over mutual TLS and its /metrics, writes its spans, and maps no
    CUDA driver library and no NVIDIA device file."""
    import os
    import re
    import socket
    import subprocess
    import sys
    import time
    import urllib.request

    from dragonfly2_tpu_torch.observability.tracing import Tracer
    from dragonfly2_tpu_torch.rpc.core import RpcClient
    from dragonfly2_tpu_torch.security.ca import CertificateAuthority, write_issued
    from dragonfly2_tpu_torch.security.transport import data_client_ssl_context
    from dragonfly2_tpu_torch.utils.proc import ready_address

    torch.zeros(1, device=card)
    assert "libcuda" in pathlib.Path("/proc/self/maps").read_text()
    certs = write_issued(CertificateAuthority(tmp_path / "ca").issue("d", sans=["127.0.0.1"]), tmp_path / "certs")
    repo = pathlib.Path(__file__).resolve().parent.parent
    env = {**os.environ, "PYTHONPATH": str(repo)}
    traced = {"DRAGONFLY_TRACE_FILE": str(tmp_path / "spans.jsonl"), "DRAGONFLY_TRACE_SAMPLE": "1"}
    procs = []

    def spawn(args, name, extra=None):
        with open(tmp_path / f"{name}.log", "w") as err:
            p = subprocess.Popen([sys.executable, "-m", *args], cwd=tmp_path, env={**env, **(extra or {})},
                                 stdout=subprocess.PIPE, stderr=err, text=True)
        procs.append(p)
        return p

    try:
        deadline = time.monotonic() + 60
        sched = ready_address(spawn(["dragonfly2_tpu_torch.scheduler.server", "--port", "0"], "scheduler"),
                              "SCHEDULER_READY", deadline)
        d = spawn(["dragonfly2_tpu_torch.daemon.server", "--scheduler", sched, "--storage", str(tmp_path / "d"),
                   "--sock", str(tmp_path / "d.sock"), "--data-tls-dir", str(tmp_path / "certs"),
                   "--metrics-port", "0"], "daemon", traced)
        assert ready_address(d, "DAEMON_READY", deadline) == str(tmp_path / "d.sock")
        log = (tmp_path / "daemon.log").read_text()
        metrics = int(re.search(r"daemon metrics on [\d.]+:(\d+)", log).group(1))
        upload = int(re.search(r"upload server on [\d.]+:(\d+) \(mTLS, raw\)", log).group(1))
        with urllib.request.urlopen(f"http://127.0.0.1:{metrics}/metrics", timeout=30) as r:
            assert "dragonfly_dfdaemon_piece_tls_handshakes_total" in r.read().decode()
        ctx = data_client_ssl_context(certs["ca"], certs["cert"], certs["key"])
        with socket.create_connection(("127.0.0.1", upload), timeout=30) as raw, ctx.wrap_socket(raw) as s:
            assert s.version() == "TLSv1.2"
            s.sendall(b"GET /nothing HTTP/1.1\r\nHost: x\r\n\r\n")
            assert s.recv(12).startswith(b"HTTP/1.1 4")


        async def traced_ping():
            with Tracer().span("probe"):  # the call ships its context; the daemon continues it
                c = RpcClient(str(tmp_path / "d.sock"), retries=0)
                try:
                    return await c.call("_ping")
                finally:
                    await c.close()

        assert asyncio.run(asyncio.wait_for(traced_ping(), 30)) == "pong"
        maps = pathlib.Path(f"/proc/{d.pid}/maps").read_text()
        fds = [os.readlink(f) for f in pathlib.Path(f"/proc/{d.pid}/fd").iterdir()]
        assert "libcuda" not in maps and "libcudart" not in maps
        assert not [f for f in fds if "nvidia" in f]
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            p.wait(timeout=30)
            p.stdout.close()
    spans = [json.loads(ln) for ln in (tmp_path / "spans.jsonl").read_text().splitlines()]
    assert [s["name"] for s in spans] == ["rpc.server"] and spans[0]["attrs"]["method"] == "_ping"
