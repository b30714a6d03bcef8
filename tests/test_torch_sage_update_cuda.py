"""K5 and K6, the SAGE layer's fused node update, on a card.

Every test is marked ``cuda`` and skips with a reason on a host without a
card; the file imports neither JAX nor the JAX package, so it runs where the
card is:

    python -m pytest --noconftest -m cuda tests/test_torch_sage_update_cuda.py

The kernels round every op where the plain ops (``sage_update_torch``) round
it on the card, so they are held to them as closely as the order of an f32
sum allows: the GELU core and its VJP bit for bit on every finite bf16 value
in [-12, 12], through rows whose sums every order takes exactly; at the
train and refresh widths the forward within one bf16 rounding, and the
gradients within the roundings that a row sum's or a column sum's order can
move, each with its reason; a CUDA graph's replay and a second launch bit
for bit.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.models.graphsage import SAGELayer, TopoGraph
from dragonfly2_tpu_torch.ops import gelu as gelu_lib, sage_update
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _counts():
    return sage_update.LAUNCHES, sage_update.BWD_LAUNCHES


def _bf16_grid(lo=-12.0, hi=12.0):
    """Every finite bf16 value in [lo, hi]."""
    x = torch.arange(-32768, 32768, dtype=torch.int32).to(torch.int16).view(torch.bfloat16)
    return x[torch.isfinite(x) & (x.float() >= lo) & (x.float() <= hi)]


def _inputs(n, h, seed=0, dev="cuda"):
    """y, agg, b0 and the incoming gradient in bf16, LayerNorm's scale and
    bias in f32 (scale near 1, bias near 0, as a trained layer's), from a seed."""
    rng = np.random.default_rng(seed)
    t = lambda a, dt: torch.from_numpy(a.astype(np.float32)).to(dev).to(dt)  # noqa: E731
    return dict(y=t(rng.normal(size=(n, h)), torch.bfloat16), b0=t(rng.normal(size=h) * 0.2, torch.bfloat16),
                agg=t(rng.normal(size=(n, h)) * 0.5, torch.bfloat16),
                gamma=t(1 + 0.1 * rng.normal(size=h), torch.float32), beta=t(0.1 * rng.normal(size=h), torch.float32),
                g=t(rng.normal(size=(n, h)), torch.bfloat16))


NAMES = ("y", "b0", "agg", "gamma", "beta")


def _run(fn, x, needs_grad=True):
    """fn's output and, with a gradient, those of (y, b0, agg, gamma, beta)
    for the incoming gradient x["g"]."""
    args = [x[k].clone().requires_grad_(needs_grad) for k in NAMES]
    with torch.set_grad_enabled(needs_grad):
        out = fn(*args)
    if not needs_grad:
        return out, None
    return out.detach(), torch.autograd.grad(out, args, x["g"])


def _fused(*args):
    return sage_update.sage_update(*args)


def _ulp(t):
    """bf16's spacing at |t| (the smallest subnormal at 0)."""
    a = t.float().abs()
    _, e = torch.frexp(a)
    return torch.where(a > 0, torch.ldexp(torch.ones_like(a), e - 8), torch.full_like(a, 2.0**-133))


def _bf16_close(name, got, want, rounding, row_share, min_equal):
    """got within ``rounding`` bf16 roundings of want at the larger of the
    two, or within ``row_share`` of its row's largest |want|; at least
    ``min_equal`` of the elements bit-equal. Returns the bit-equal share."""
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape, name
    d = (got.float() - want.float()).abs()
    scale = torch.maximum(got.float().abs(), want.float().abs())
    row = want.float().abs().amax(dim=-1, keepdim=True) if want.dim() == 2 else want.float().abs().amax()
    over = (d > rounding * _ulp(scale)) & (d > row_share * row)
    assert not bool(over.any()), f"{name}: {int(over.sum())} elements over, worst {float(d[over].max())}"
    equal = float((got == want).float().mean())
    assert equal >= min_equal, f"{name}: only {equal:.4%} bit-equal"
    print(f"{name}: {equal:.4%} bit-equal")
    return equal


@pytest.mark.parametrize("g_seed", [0, 1, None], ids=["g_normal0", "g_normal1", "g_one"])
def test_gelu_core_and_its_vjp_equal_ops_gelu_bit_for_bit(card, g_seed):
    # Rows of H = 8 equal pre-activations x (y = x, b0 = agg = 0): every sum
    # of the row is exact in any order, so the row's mean is gelu(x) itself
    # (K5 saves it), c = a - mu = 0, the output is beta, and the LayerNorm's
    # backward for an incoming gradient on channel 0 alone has one nonzero
    # term in each row sum: g_a = bf16(g·r - g·r/8) on channel 0 and
    # bf16(-g·r/8) on the rest, with r = rsqrt(eps), in any order. So K6's g_x
    # is the GELU's VJP at x for those g_a, and must equal autograd through
    # the plain ops, ops/gelu.py's _Gelu.backward, bit for bit.
    x = _bf16_grid().to(card)
    n, h = x.numel(), 8
    y = x[:, None].expand(n, h).contiguous()
    zeros = torch.zeros(h, device=card)
    args = dict(y=y, b0=zeros.bfloat16(), agg=torch.zeros_like(y), gamma=torch.ones(h, device=card), beta=zeros)
    _, xs, mu, rstd = sage_update._launch_fwd(*args.values(), 1e-6, save=True)
    assert torch.equal(xs, y)
    want_a = gelu_lib.gelu(x)
    bad = mu != want_a.float()
    assert not bool(bad.any()), [float(v) for v in x[bad][:5]]
    assert bool((rstd > 0).all())  # var = 0 exactly: the clamp passes its gradient

    g0 = (torch.ones(n, device=card) if g_seed is None else
          torch.from_numpy(np.random.default_rng(g_seed).normal(size=n).astype(np.float32)).to(card))
    g = torch.zeros(n, h, device=card)
    g[:, 0] = g0
    x_in = dict(args, g=g.bfloat16())
    out, grads = _run(_fused, x_in)
    want_out, want_grads = _run(sage_update.sage_update_torch, x_in)
    assert torch.equal(out, want_out)
    for name, got, want in zip(("g_y", "g_agg"), (grads[0], grads[2]), (want_grads[0], want_grads[2])):
        bad = (got != want).any(dim=1)
        assert not bool(bad.any()), (name, [float(v) for v in x[bad][:5]])
    low = x <= -3.06  # bf16's tanh is -1 there: value and gradient exactly 0
    assert bool((mu[low] == 0).all()) and bool((grads[0][low] == 0).all())


MAIN = {"16384x256": (16384, 256), "16384x512": (16384, 512)}
EDGE = {"h8": (300, 8), "h264_ragged_vector": (200, 264), "h520": (100, 520), "h1024": (64, 1024), "n1": (1, 256)}

# Limits, each with its reason. The forward: only the order of the row's two
# f32 sums differs, which moves an output by one bf16 rounding, or, where
# (a - mu)·m + beta cancels to near 0, by the f32 error of mu·m: at most
# 2^-16 of the row's largest output. g_x: the row sums of the LayerNorm's
# backward (sum G·m and sum G·c·g) differ in order too, so g_a, rounded to
# bf16 before the GELU's VJP, can differ by one rounding, which the VJP's
# rounded ops carry into two of g_x; where the VJP cancels (near x = -0.75,
# where gelu' crosses 0) a rounding of its terms, as large as g_a, is many of
# g_x's own: within 2^-7 of the row's largest |g_x|. The parameter gradients
# are f32 sums over N rows in another order (runs of at most a few dozen
# rows a lane, then the warps, then the blocks in eight groups): g's and be's
# within 1e-5 of the sum of their terms' magnitudes; b0's, a sum of bf16 g_x
# rounded to bf16, within two roundings or 2^-8 of its largest element.
FWD = dict(rounding=1, row_share=2.0**-16)
GX = dict(rounding=2, row_share=2.0**-7)
B0 = dict(rounding=2, row_share=2.0**-8)


@pytest.mark.parametrize("name", [*MAIN, *EDGE])
def test_fused_op_is_within_the_stated_roundings_of_the_plain_ops(card, name):
    n, h = MAIN.get(name) or EDGE[name]
    x = _inputs(n, h, seed=7)
    before = _counts()
    out, grads = _run(_fused, x)
    assert _counts() == (before[0] + 1, before[1] + 1)
    want, want_grads = _run(sage_update.sage_update_torch, x)
    big = name in MAIN
    _bf16_close("out", out, want, **FWD, min_equal=0.999 if big else 0.99)
    g_y, g_b0, g_agg, g_gamma, g_beta = grads
    assert torch.equal(g_y, g_agg)  # one g_x for both
    _bf16_close("g_x", g_y, want_grads[0], **GX, min_equal=0.999 if big else 0.99)
    _bf16_close("g_b0", g_b0, want_grads[1], **B0, min_equal=0.9 if big else 0.5)
    # the column sums' terms, for their scale: g's sum_n |G·(a - mu)·r| and be's sum_n |G|
    a = gelu_lib.gelu(x["y"] + x["b0"] + x["agg"]).float()
    mu = a.mean(-1, keepdim=True)
    r = torch.rsqrt(torch.clamp((a * a).mean(-1, keepdim=True) - mu * mu, min=0.0) + 1e-6)
    gf = x["g"].float()
    mags = {"g_gamma": (gf * (a - mu) * r).abs().sum(0), "g_beta": gf.abs().sum(0)}
    for gname, got, want_g in (("g_gamma", g_gamma, want_grads[3]), ("g_beta", g_beta, want_grads[4])):
        assert got.dtype == torch.float32
        err = (got - want_g).abs()
        assert bool((err <= 1e-5 * mags[gname] + 1e-30).all()), (gname, float((err / mags[gname]).max()))


def test_two_launches_are_bit_identical_and_no_grad_saves_nothing(card):
    x = _inputs(*MAIN["16384x512"], seed=3)
    a, ga = _run(_fused, x)
    b, gb = _run(_fused, x)
    assert torch.equal(a, b) and all(torch.equal(p, q) for p, q in zip(ga, gb))
    before = _counts()
    with torch.inference_mode():
        c = sage_update.sage_update(*(x[k] for k in NAMES))
    assert torch.equal(a, c) and not c.requires_grad
    assert _counts() == (before[0] + 1, before[1])


def test_a_cuda_graph_replay_equals_the_eager_call(card):
    # a train call's use of the op: forward and backward captured once, then
    # replayed on new inputs copied into the captured buffers
    n, h = MAIN["16384x512"]
    first, second = _inputs(n, h, seed=11), _inputs(n, h, seed=12)
    static = {k: v.clone().requires_grad_(k != "g") for k, v in first.items()}

    def call():
        out = sage_update.sage_update(*(static[k] for k in NAMES))
        return (out, *torch.autograd.grad(out, [static[k] for k in NAMES], static["g"]))

    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()  # warm-up off the default stream, as capture wants
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    before = _counts()
    with torch.cuda.graph(graph):
        captured = call()
    assert _counts() == (before[0] + 1, before[1] + 1)
    for inputs in (second, first):
        with torch.no_grad():
            for k, v in inputs.items():
                static[k].copy_(v)
        graph.replay()
        torch.cuda.synchronize()
        out, grads = _run(_fused, inputs)
        assert torch.equal(captured[0], out)
        assert all(torch.equal(p, q) for p, q in zip(captured[1:], grads))
    assert _counts() == (before[0] + 3, before[1] + 3)  # the eager calls only: a replay runs no Python


def test_the_wrapper_refuses_what_it_cannot_take(card):
    x = _inputs(64, 64)
    args = {k: x[k] for k in NAMES}
    call = lambda **kw: sage_update.sage_update(**{**args, **kw})  # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA"):
        call(y=x["y"].cpu())
    with pytest.raises(ValueError, match="bf16"):
        call(y=x["y"].float())
    with pytest.raises(ValueError, match="multiple of 8"):
        call(y=x["y"][:, :12].contiguous(), agg=x["agg"][:, :12].contiguous(), b0=x["b0"][:12],
             gamma=x["gamma"][:12], beta=x["beta"][:12])
    with pytest.raises(ValueError, match="at most 1024"):
        y = _inputs(4, 1032)
        sage_update.sage_update(*(y[k] for k in NAMES))
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.empty(x["y"].numel() + 1, dtype=torch.bfloat16, device=card)
        call(y=flat[1:].view_as(x["y"]).copy_(x["y"]))
    with pytest.raises(ValueError, match="contiguous"):
        call(agg=x["agg"].t().contiguous().t())


def _graph(n, k, dev, seed=3):
    rng = np.random.default_rng(seed)
    return TopoGraph(rng.normal(size=(n, 12)).astype(np.float32), rng.integers(0, n, (n, k)).astype(np.int32),
                     (rng.random((n, k)) < 0.75).astype(np.float32),
                     rng.normal(size=(n, k, 4)).astype(np.float32)).to(dev)


@pytest.mark.parametrize("width,dtype", [(12, torch.bfloat16), (16, torch.float32)], ids=["h12_bf16", "h16_f32"])
def test_a_layer_the_kernels_do_not_take_runs_the_plain_ops(card, width, dtype):
    from torch.profiler import ProfilerActivity, profile

    g = _graph(64, 4, card)
    h = torch.from_numpy(np.random.default_rng(1).normal(size=(64, width)).astype(np.float32)).to(card)
    layer = SAGELayer(width, width, dtype=dtype).to(card)
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        layer(h.requires_grad_(), g).float().sum().backward()
    assert _counts() == before
    assert "gnn.sage.update" not in {e.name for e in prof.events()}


def test_a_fused_layer_equals_its_plain_ops_on_the_card(card, monkeypatch):
    # the layer's own call against the same layer's plain update: the fused
    # message path (K3, K4) feeds both, so only the update differs
    g = _graph(2048, 16, card)
    h = torch.from_numpy(np.random.default_rng(2).normal(size=(2048, 256)).astype(np.float32)).to(card)
    layer = SAGELayer(256, 256).to(card)
    with torch.no_grad():
        layer.LayerNorm_0.weight.add_(0.1 * torch.randn(256, device=card))
        layer.LayerNorm_0.bias.add_(0.1 * torch.randn(256, device=card))
    before = _counts()
    got = layer(h, g)
    assert _counts() == (before[0] + 1, before[1])
    monkeypatch.setattr(sage_update, "takes", lambda *a: False)
    want = layer(h, g)
    _bf16_close("layer out", got, want, **FWD, min_equal=0.99)


def test_a_train_step_launches_k5_and_k6_once_a_layer_and_a_refresh_k5_alone(card):
    cluster = synthetic.make_cluster(num_nodes=256, num_neighbors=16, num_pairs=512, seed=1)
    cfg = train_gnn.GNNTrainConfig(hidden=64, embed_dim=32, num_layers=3, batch_size=128)
    state = train_gnn.init_state(cfg, rng_seed=0, device=card)
    step = train_gnn.make_train_step()
    before = _counts()
    state, loss = step(state, cluster.graph.to(card), synthetic.sample_batch(cluster.pairs, 128,
                                                                           np.random.default_rng(0)))
    assert _counts() == (before[0] + 3, before[1] + 3) and bool(torch.isfinite(loss))
    model = TopoScorer(hidden=64, embed_dim=32, num_layers=3, head_hidden=64)
    scorer = GNNScorer(model, params_from_flax(init_flax_like(model, seed=0)), device=card)
    before = _counts()
    scorer.refresh(cluster.graph)
    assert _counts() == (before[0] + 3, before[1])


def test_the_plain_version_is_the_layers_plain_composition_on_the_card(card):
    # sage_update_torch is what the CPU and the mesh run: the layer's
    # Dense_0, gelu and LayerNorm_0, bit for bit on the card too
    layer = SAGELayer(64, 64).to(card)
    h = torch.randn(128, 64, device=card).bfloat16()
    agg = torch.randn(128, 64, device=card).bfloat16()
    want = layer.LayerNorm_0(gelu_lib.gelu(layer.Dense_0(h) + agg))
    got = sage_update.sage_update_torch(F.linear(h, layer.Dense_0.weight.bfloat16()),
                                        layer.Dense_0.bias.bfloat16(), agg, layer.LayerNorm_0.weight,
                                        layer.LayerNorm_0.bias)
    assert torch.equal(got, want)
