"""The port's CUDA kernels, serving and training on a card, against their plain versions.

Every test here is marked ``cuda`` and decides inside its fixture whether a
card is present, skipping with a reason on a host without one. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
a card and no JAX (the JAX test bootstrap in conftest.py is left out):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.ops import neighbor_agg, neighbor_agg_cuda
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

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
    else:
        raise KeyError(name)
    return h, nbr, mask


CASES = ["100x7x33", "128x16x256", "257x4x64", "1x2x8", "4096x16x256", "k40_more_slots_than_lanes",
         "h520_more_vectors_than_lanes", "fully_masked_row", "duplicates", "fractional_mask", "out_of_range"]


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
