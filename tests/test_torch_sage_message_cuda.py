"""K3 and K4, the fused SAGE message path, on a card.

Every test is marked ``cuda`` and skips with a reason on a host without a
card; the file imports neither JAX nor the JAX package, so it runs where
the card is:

    python -m pytest --noconftest -m cuda tests/test_torch_sage_message_cuda.py

The kernels round every op where the plain path rounds it on the card, so
they are held to it bit for bit: the GELU core (the op at K = 1 with s and
We at 0) on every finite bf16 value, with incoming gradients of every
magnitude; the op's output and gradients against the plain ops with the
edge term summed in the kernels' order, where only the order of an f32 sum
(over k, g_We's and g_u's) may move a result, by one bf16 rounding; and,
looser, against the plain path as the layer runs it (msg_edge's product
through cuBLAS).
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.models.graphsage import GraphSAGE, SAGELayer, TopoGraph, gelu
from dragonfly2_tpu_torch.ops import sage_message
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _bf16_grid(lo=-12.0, hi=12.0):
    """Every finite bf16 value in [lo, hi]."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x) & (x.float() >= lo) & (x.float() <= hi)]


def _incoming(kind, shape, dev):
    """The incoming gradient: normal from a seed, ones, or of random sign at
    large (1e20 to 3e38, where x·g and the VJP's products overflow) or
    subnormal magnitudes (under 2^-126, where they underflow), in bf16."""
    if kind == "one":
        return torch.ones(shape, dtype=torch.bfloat16, device=dev)
    rng = np.random.default_rng({"normal0": 0, "normal1": 1, "large": 2, "subnormal": 3}[kind])
    if kind.startswith("normal"):
        g = rng.normal(size=shape)
    else:
        lo, hi = (20.0, 38.5) if kind == "large" else (-40.5, -38.0)
        g = rng.choice([-1.0, 1.0], size=shape) * 10.0 ** rng.uniform(lo, hi, size=shape)
    return torch.from_numpy(g.astype(np.float32)).to(dev).bfloat16()


def _same_bits(a, b):
    """Equal bit for bit, NaN included, but for the sign of a zero: an f32
    sum that starts at +0 turns -0 into +0."""
    return (a.view(torch.int16) == b.view(torch.int16)) | ((a == 0) & (b == 0))


@pytest.mark.parametrize("lo,hi,g_kind", [
    (-12.0, 12.0, "normal0"), (-12.0, 12.0, "normal1"), (-12.0, 12.0, "one"),
    (-np.inf, np.inf, "normal0"), (-np.inf, np.inf, "one"), (-np.inf, np.inf, "large"),
    (-np.inf, np.inf, "subnormal"),
], ids=["g_normal0", "g_normal1", "g_one", "every_x_g_normal0", "every_x_g_one", "every_x_g_large",
        "every_x_g_subnormal"])
def test_gelu_core_equals_graphsage_gelu_bit_for_bit(card, lo, hi, g_kind):
    # through the op's own kernels: with K = 1, the mask 1, s = 0 and We = 0
    # the pre-activation is u, the mean's divisor bf16(1 + 1e-6) = 1, so agg
    # = gelu(u), and g_s and g_u are its VJP for the incoming gradient. Over
    # every finite bf16 x, x·x overflows past 1.8e19 and the VJP's 0·inf is
    # NaN, as it is in the plain ops
    x = _bf16_grid(lo, hi).to(card)
    h = 8
    u = torch.cat([x, x.new_zeros(-x.numel() % h)]).view(-1, h)
    n = u.shape[0]
    g = _incoming(g_kind, u.shape, card)
    nbr = torch.arange(n, dtype=torch.int32, device=card)[:, None]
    edge = torch.from_numpy(np.random.default_rng(2).normal(size=(n, 1, 1)).astype(np.float32)).to(card)
    uu, ss = u.clone().requires_grad_(), torch.zeros_like(u).requires_grad_()
    w = torch.zeros(h, 1, dtype=torch.bfloat16, device=card, requires_grad=True)
    agg = sage_message.sage_message(uu, ss, edge, w, nbr, torch.ones(n, 1, device=card))
    g_u, g_s, _ = torch.autograd.grad(agg, (uu, ss, w), g)
    y, dx, dx_u = (t.reshape(-1)[:x.numel()] for t in (agg, g_s, g_u))
    xr = x.clone().requires_grad_()
    want = gelu(xr)
    (want_dx,) = torch.autograd.grad(want, xr, g.reshape(-1)[:x.numel()])
    bad = ~(_same_bits(y, want) & _same_bits(dx, want_dx) & _same_bits(dx_u, want_dx))
    assert not bool(bad.any()), [float(a) for a in x[bad][:5]]
    low = x <= -3.06  # bf16's tanh is -1 there: the value exactly 0
    assert bool((y[low] == 0).all())
    if hi == 12.0:  # and the gradient, where x·g and x·x stay finite
        assert bool((dx[low] == 0).all())


def _inputs(n, k, h, *, e=4, seed=0, p=0.75, mask_kind="binary", dev="cuda"):
    """u, s (bf16), edge features (f32), msg_edge's weight (f32), neighbours,
    mask, and an incoming gradient, from a seed; dead slots point at 0."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    if mask_kind == "fractional":
        mask = rng.random((n, k)).astype(np.float32)
        mask[mask < 1 - p] = 0.0
    else:
        mask = (rng.random((n, k)) < p).astype(np.float32)
    if mask_kind == "fully_masked_rows":
        mask[[0, 3, n - 1]] = 0.0
    if mask_kind == "under_bf16":
        mask[1] = 1e-42  # f32 subnormal that rounds to 0 in bf16: dead
    nbr[mask == 0] = 0
    t = lambda a, dt=torch.float32: torch.from_numpy(a).to(dev).to(dt)  # noqa: E731
    return dict(
        u=t(rng.normal(size=(n, h)).astype(np.float32), torch.bfloat16),
        s=t(rng.normal(size=(n, h)).astype(np.float32), torch.bfloat16),
        edge_feats=t(rng.normal(size=(n, k, e)).astype(np.float32)),
        weight=t((rng.normal(size=(h, e)) * 0.5).astype(np.float32)),
        neighbors=t(nbr, torch.int32), mask=t(mask),
        g=t(rng.normal(size=(n, h)).astype(np.float32), torch.bfloat16),
    )


def _edge_term_in_kernel_order(edge_feats, weight):
    """msg_edge's product as the kernels sum it: e and We rounded to bf16,
    each product exact in f32, added in feature order, rounded once."""
    e, w = edge_feats.bfloat16().float(), weight.bfloat16().float()
    v = e[..., 0:1] * w[:, 0]
    for d in range(1, e.shape[-1]):
        v = v + e[..., d:d + 1] * w[:, d]
    return v.bfloat16()


def _run(fn, x, needs_grad=True):
    """agg and, with a gradient, (g_u, g_s, g_We) of ``fn(u, s, w)`` for the
    incoming gradient x["g"]; w is msg_edge's weight in bf16."""
    u, s = x["u"].clone().requires_grad_(needs_grad), x["s"].clone().requires_grad_(needs_grad)
    w = x["weight"].bfloat16().requires_grad_(needs_grad)
    with torch.set_grad_enabled(needs_grad):
        agg = fn(u, s, w)
    if not needs_grad:
        return agg, None
    return agg.detach(), torch.autograd.grad(agg, (u, s, w), x["g"])


def _fused(x):
    return lambda u, s, w: sage_message.sage_message(u, s, x["edge_feats"], w, x["neighbors"], x["mask"])


def _plain_in_kernel_order(x):
    def fn(u, s, w):
        v = _edge_term_in_kernel_order(x["edge_feats"], w)
        return sage_message.message_path(u, s, v, x["neighbors"], x["mask"])
    return fn


def _plain(x):
    return lambda u, s, w: sage_message.sage_message_torch(u, s, x["edge_feats"], w, x["neighbors"], x["mask"])


def _ulp(t):
    """bf16's spacing at |t| (the smallest subnormal at 0)."""
    a = t.float().abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8), torch.full_like(a, 2.0**-133))


def _within_one_rounding(name, got, want, min_equal):
    """Every element within one bf16 rounding, and at least ``min_equal`` of
    them bit-equal: only an f32 sum's order may differ."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, name
    d = (got.float() - want.float()).abs()
    tol = _ulp(torch.maximum(got.float().abs(), want.float().abs()))
    over = d > tol
    assert not bool(over.any()), f"{name}: {int(over.sum())} elements over one rounding, worst {float(d.max())}"
    equal = float((got == want).float().mean())
    assert equal >= min_equal, f"{name}: only {equal:.4%} bit-equal"
    return equal


MAIN = {"16384x16x256": (16384, 16, 256), "16384x16x512": (16384, 16, 512)}
EDGE = {
    "dead_slots": dict(n=300, k=16, h=64, p=0.5),
    "fully_masked_rows": dict(n=64, k=4, h=16, mask_kind="fully_masked_rows"),
    "fractional_mask": dict(n=500, k=16, h=128, mask_kind="fractional"),
    "mask_under_bf16": dict(n=64, k=6, h=32, mask_kind="under_bf16"),
    "k1": dict(n=64, k=1, h=64),
    "k5": dict(n=300, k=5, h=128),
    "k32": dict(n=128, k=32, h=64),
    "h8": dict(n=50, k=4, h=8),
    "h264_ragged_chunk": dict(n=100, k=7, h=264),
    "h520": dict(n=33, k=5, h=520),
    "e2": dict(n=80, k=8, h=64, e=2),
}


def _case(name):
    if name in MAIN:
        n, k, h = MAIN[name]
        return _inputs(n, k, h, seed=7)
    return _inputs(**EDGE[name], seed=11)


@pytest.mark.parametrize("name", [*MAIN, *EDGE])
def test_fused_op_equals_the_plain_ops_up_to_an_f32_sums_order(card, name):
    x = _case(name)
    before = (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES)
    agg, grads = _run(_fused(x), x)
    assert (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES) == (before[0] + 1, before[1] + 1)
    want_agg, want_grads = _run(_plain_in_kernel_order(x), x)
    # binary masks sum exactly; g_We sums N*K products, where an order can
    # round otherwise more often
    _within_one_rounding("agg", agg, want_agg, 0.99)
    for gname, got, want, min_equal in zip(("g_u", "g_s", "g_We"), grads, want_grads, (0.99, 0.99, 0.9)):
        _within_one_rounding(gname, got, want, min_equal)
    if name in MAIN or name == "fully_masked_rows":
        rows = x["mask"].sum(1) == 0
        assert bool((agg[rows] == 0).all()) and bool((grads[1][rows] == 0).all())


@pytest.mark.parametrize("name", [*MAIN, "fractional_mask", "k5"])
def test_fused_op_is_close_to_the_layers_plain_path(card, name):
    # the plain path takes the edge term and g_We from cuBLAS, which sums
    # them in its own order and precision (g_We's N*K products come back
    # rounded otherwise where they cancel), and a rounding of the
    # pre-activation moves the rest; so each is held to a share of its scale
    x = _case(name)
    agg, grads = _run(_fused(x), x)
    want_agg, want_grads = _run(_plain(x), x)
    torch.testing.assert_close(agg.float(), want_agg.float(), rtol=2e-2, atol=2e-2)
    for got, want in zip(grads, want_grads):
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2, atol=2e-2 * float(want.abs().max()))


@pytest.mark.parametrize("name", [*MAIN, "fractional_mask"])
def test_two_launches_are_bit_identical(card, name):
    x = _case(name)
    a, ga = _run(_fused(x), x)
    b, gb = _run(_fused(x), x)
    assert torch.equal(a, b) and all(torch.equal(p, q) for p, q in zip(ga, gb))
    c, _ = _run(_fused(x), x, needs_grad=False)  # K3 alone, no autograd node
    assert torch.equal(a, c)


def test_without_a_gradient_only_k3_runs_and_no_index_is_built(card, monkeypatch):
    built = []
    monkeypatch.setattr(sage_message, "slot_index", lambda *a: built.append(a))
    x = _case("k5")
    before = (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES)
    with torch.inference_mode():
        agg = sage_message.sage_message(x["u"], x["s"], x["edge_feats"], x["weight"], x["neighbors"], x["mask"])
    assert not agg.requires_grad and built == []
    assert (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES) == (before[0] + 1, before[1])


def test_the_wrapper_refuses_what_it_cannot_take(card):
    x = _case("k5")
    args = dict(u=x["u"], s=x["s"], edge_feats=x["edge_feats"], weight=x["weight"], neighbors=x["neighbors"],
                mask=x["mask"])
    call = lambda **kw: sage_message.sage_message(**{**args, **kw})  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        call(u=x["u"].cpu())
    with pytest.raises(ValueError, match="bf16"):
        call(u=x["u"].float())
    with pytest.raises(ValueError, match="multiple of 8"):
        call(u=x["u"][:, :12].contiguous(), s=x["s"][:, :12].contiguous(), weight=x["weight"][:12])
    with pytest.raises(ValueError, match="K <= 32"):
        y = _inputs(16, 33, 16)
        sage_message.sage_message(y["u"], y["s"], y["edge_feats"], y["weight"], y["neighbors"], y["mask"])
    with pytest.raises(ValueError, match="E <= 4"):
        y = _inputs(16, 4, 16, e=5)
        sage_message.sage_message(y["u"], y["s"], y["edge_feats"], y["weight"], y["neighbors"], y["mask"])
    with pytest.raises(ValueError, match="no gradient"):
        call(edge_feats=x["edge_feats"].clone().requires_grad_())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(x["u"].numel() + 1, dtype=torch.bfloat16, device=card)
        call(u=flat[1:].view_as(x["u"]).copy_(x["u"]))
    with pytest.raises(ValueError, match="neighbors"):
        call(neighbors=x["neighbors"].float())


def _layer_inputs(n, k, h, dev, seed=3):
    rng = np.random.default_rng(seed)
    g = TopoGraph(rng.normal(size=(n, 12)).astype(np.float32), rng.integers(0, n, (n, k)).astype(np.int32),
                  (rng.random((n, k)) < 0.75).astype(np.float32),
                  rng.normal(size=(n, k, 4)).astype(np.float32)).to(dev)
    return g, torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("width,dtype", [(12, torch.bfloat16), (16, torch.float32)], ids=["h12_bf16", "h16_f32"])
def test_a_layer_the_kernels_do_not_take_runs_the_plain_path(card, width, dtype):
    # H*2 bytes not a multiple of 16, or a compute dtype other than bf16
    from torch.profiler import ProfilerActivity, profile

    g, h = _layer_inputs(64, 4, width, card)
    layer = SAGELayer(width, width, dtype=dtype).to(card)
    before = (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        layer(h.requires_grad_(), g).float().sum().backward()
    assert (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES) == before
    names = sorted({e.name for e in prof.events() if e.name.startswith("gnn.sage.")})
    assert names == ["gnn.sage.gather", "gnn.sage.mean", "gnn.sage.message"]


def test_an_encoder_launches_k3_and_k4_once_a_layer_and_builds_one_index(card, monkeypatch):
    built = []
    real = sage_message.slot_index
    monkeypatch.setattr(sage_message, "slot_index", lambda *a: built.append(a) or real(*a))
    g, _ = _layer_inputs(256, 8, 64, card)
    enc = GraphSAGE(hidden=64, embed_dim=32, num_layers=3, node_dim=12).to(card)
    before = (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES)
    enc(g).square().sum().backward()
    assert (sage_message.LAUNCHES - before[0], sage_message.BWD_LAUNCHES - before[1]) == (3, 3)
    assert len(built) == 1
    assert all(torch.isfinite(p.grad).all() for p in enc.parameters())


def test_a_fused_layer_matches_its_plain_path_on_the_card(card):
    g, h = _layer_inputs(2048, 16, 256, card)
    layer = SAGELayer(256, 256).to(card)
    # a fixed random cotangent, not sum(y**2): LayerNorm keeps each row's sum
    # of squares fixed, so that loss's gradient is the bf16 rounding residual
    # of y, and one output rounded otherwise (the fused node update's f32 row
    # sums, like any other order of them, allow it) moves its whole row
    cot = torch.from_numpy(np.random.default_rng(5).normal(size=(2048, 256)).astype(np.float32)).to(card)
    out, grads = [], []
    for fused in (True, False):
        hh = h.clone().requires_grad_()
        if fused:
            y = layer(hh, g)
        else:  # the layer's own plain branch, as the CPU and the mesh run it
            hb = hh.to(torch.bfloat16)
            u, s = layer.msg_nbr(hb), layer.msg_self(hb)
            v = layer.msg_edge(g.edge_feats.to(torch.bfloat16))
            agg = sage_message.message_path(u, s, v, g.neighbors, g.mask)
            y = layer.LayerNorm_0(gelu(layer.Dense_0(hb) + agg))
        params = [hh, *layer.parameters()]
        out.append(y.detach())
        grads.append(torch.autograd.grad((y.float() * cot).sum(), params))
    torch.testing.assert_close(out[0].float(), out[1].float(), rtol=2e-2, atol=2e-2)
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=3e-2, atol=3e-2 * float(b.abs().max()))


def test_remat_runs_through_the_fused_op(card):
    cluster = synthetic.make_cluster(num_nodes=512, num_neighbors=16, num_pairs=4096, seed=2)
    cfg = train_gnn.GNNTrainConfig(hidden=128, embed_dim=32, num_layers=3, batch_size=512, warmup_steps=1)
    start = init_flax_like(train_gnn.make_model(cfg), seed=0)
    out = {}
    for remat in (False, True):
        state = train_gnn.init_state(cfg, params=start, device=card)
        step = train_gnn.make_train_step(remat)
        gd = cluster.graph.to(card)
        rng = np.random.default_rng(4)
        before = (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES)
        losses = []
        for _ in range(2):
            state, loss = step(state, gd, synthetic.sample_batch(cluster.pairs, 512, rng))
            losses.append(float(loss))
        # remat runs the forward again inside the backward: twice the K3 launches
        launched = (sage_message.LAUNCHES - before[0], sage_message.BWD_LAUNCHES - before[1])
        assert launched == ((12 if remat else 6), 6)
        assert all(bool(torch.isfinite(p).all()) for p in state.model.parameters())
        out[remat] = losses
    # the first step's forward is the same launches either way; the second
    # sees parameters whose gradients differ at most by atomics' f32 order in
    # the head's gather
    assert out[True][0] == out[False][0]
    assert abs(out[True][1] - out[False][1]) <= 1e-4 * abs(out[False][1])


def test_a_refresh_launches_k3_once_a_layer_and_no_k4(card):
    cluster = synthetic.make_cluster(num_nodes=256, num_neighbors=16, num_pairs=512, seed=1)
    model = TopoScorer(hidden=64, embed_dim=32, num_layers=3, head_hidden=64)
    scorer = GNNScorer(model, params_from_flax(init_flax_like(model, seed=0)), device=card)
    before = (sage_message.LAUNCHES, sage_message.BWD_LAUNCHES)
    scorer.refresh(cluster.graph)
    assert (sage_message.LAUNCHES - before[0], sage_message.BWD_LAUNCHES - before[1]) == (3, 0)


def test_the_edge_term_in_kernel_order_is_the_exact_sum_rounded_once(card):
    # the yardstick above: the kernels' f32 sum of E exact products lies
    # within one bf16 rounding of the exact sum, but for the f32 sum's own
    # error where the products cancel (at most 3 roundings of 2**-24 of the
    # largest partial sum), and equals msg_edge's cuBLAS product almost
    # everywhere (on the H100 cuBLAS parts from the exact sum by two bf16
    # roundings at a few elements)
    x = _case("16384x16x256")
    w = x["weight"].bfloat16()
    e = x["edge_feats"].bfloat16().double()
    mine = _edge_term_in_kernel_order(x["edge_feats"], w)
    cublas = F.linear(x["edge_feats"].bfloat16(), w)
    exact = e @ w.double().t()
    d = (mine.double() - exact).abs()
    tol = _ulp(mine).double() + 3 * 2.0**-24 * (e.abs() @ w.double().abs().t())
    assert not bool((d > tol).any()), float((d - tol).max())
    assert float((mine == exact.bfloat16()).float().mean()) >= 0.999
    assert float((mine == cublas).float().mean()) >= 0.999
