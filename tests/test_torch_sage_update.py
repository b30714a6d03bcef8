"""The fused node update's plain version and dispatch, on the CPU.

K5 and K6 (``ops/sage_update.py``, ``csrc/sage_update.cu``) run only on a
card; tests/test_torch_sage_update_cuda.py holds them against the plain ops
there. Here: ``sage_update_torch`` is the SAGE layer's node update as the
layer computed it before the kernels, ``LayerNorm_0(gelu(Dense_0(h) + agg))``,
bit for bit forward and backward; the layout check refuses f32, H not a
multiple of 8 or over 1024, non-contiguous and misaligned inputs, and the
device check the CPU; a SAGE layer on the CPU and on a DTensor runs the plain
ops and launches nothing; the kernels' GELU constants are ops/gelu.py's.
"""

import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from dragonfly2_tpu_torch.models.graphsage import Dense, LayerNorm, SAGELayer, TopoGraph
from dragonfly2_tpu_torch.ops import _build, gelu as gelu_lib, sage_message, sage_update
from dragonfly2_tpu_torch.parallel.distributed import free_port
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _counts():
    return sage_update.LAUNCHES, sage_update.BWD_LAUNCHES


def _layer_norm_as_written(x, weight, bias, eps, dtype):
    """models/graphsage.LayerNorm.forward as the layer ran it before the
    fused update: the reference the plain version is held to."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((x - mu) * mul + bias).to(dtype)


def _modules(width, dtype, seed):
    """Dense_0 and LayerNorm_0 of a layer of ``width``, with every parameter
    away from its initial value, and h and agg, from a seed."""
    gen = torch.Generator().manual_seed(seed)
    dense, norm = Dense(width, width, dtype=dtype), LayerNorm(width, dtype=dtype)
    with torch.no_grad():
        for p in (*dense.parameters(), *norm.parameters()):
            p.add_(0.1 * torch.randn(p.shape, generator=gen))
    n = 3 * width
    h = torch.randn(n, width, generator=gen).to(dtype)
    agg = (0.5 * torch.randn(n, width, generator=gen)).to(dtype)
    with torch.no_grad():
        agg[0] = -h[0] @ dense.weight.t().to(dtype)  # a row whose pre-activation nearly cancels
    return dense, norm, h, agg


@pytest.mark.parametrize("width,dtype", [(16, torch.bfloat16), (24, torch.bfloat16), (8, torch.bfloat16),
                                         (20, torch.float32)], ids=["h16_bf16", "h24_bf16", "h8_bf16", "h20_f32"])
def test_the_plain_version_is_the_layers_update_bit_for_bit(width, dtype):
    dense, norm, h, agg = _modules(width, dtype, seed=width)
    params = [*dense.parameters(), *norm.parameters()]
    g = torch.randn(h.shape[0], width, generator=torch.Generator().manual_seed(1)).to(dtype)
    outs, grads = [], []
    for plain in (False, True):
        hh, aa = h.clone().requires_grad_(), agg.clone().requires_grad_()
        if plain:
            out = sage_update.sage_update_torch(F.linear(hh, dense.weight.to(dtype)), dense.bias.to(dtype), aa,
                                                norm.weight, norm.bias, norm.eps)
        else:
            out = _layer_norm_as_written(gelu_lib.gelu(dense(hh) + aa), norm.weight, norm.bias, 1e-6, dtype)
        outs.append(out)
        grads.append(torch.autograd.grad(out, [hh, aa, *params], g))
    assert outs[0].dtype == dtype and torch.equal(outs[0], outs[1])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_the_layer_norm_module_is_the_formula_as_written():
    norm = LayerNorm(32)
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x = torch.randn(40, 32).bfloat16()
    x[3] = 0.75  # a constant row: the variance is 0
    assert torch.equal(norm(x), _layer_norm_as_written(x, norm.weight, norm.bias, 1e-6, torch.bfloat16))


def _graph(n=48, k=5, e=4, seed=0, p=0.7):
    rng = np.random.default_rng(seed)
    return TopoGraph(rng.normal(size=(n, 12)).astype(np.float32), rng.integers(0, n, (n, k)).astype(np.int32),
                     (rng.random((n, k)) < p).astype(np.float32),
                     rng.normal(size=(n, k, e)).astype(np.float32)).to("cpu")


def test_a_sage_layer_on_the_cpu_runs_the_plain_update_and_launches_nothing(tmp_path):
    g = _graph()
    layer = SAGELayer(16, 16)
    h = torch.from_numpy(np.random.default_rng(1).normal(size=(48, 16)).astype(np.float32)).requires_grad_()
    before = (_counts(), sage_message.LAUNCHES)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = layer(h, g)
        grads = torch.autograd.grad(got.float().square().sum(), [h, *layer.parameters()])
    assert (_counts(), sage_message.LAUNCHES) == before
    assert "gnn.sage.update" not in {e.name for e in prof.events()}
    hb = h.to(torch.bfloat16)
    u, s = layer.msg_nbr(hb), layer.msg_self(hb)
    agg = sage_message.message_path(u, s, layer.msg_edge(g.edge_feats.to(torch.bfloat16)), g.neighbors, g.mask)
    norm = layer.LayerNorm_0
    want = _layer_norm_as_written(gelu_lib.gelu(layer.Dense_0(hb) + agg), norm.weight, norm.bias, 1e-6,
                                  torch.bfloat16)
    assert torch.equal(got, want)
    assert all(torch.equal(a, b) for a, b in
               zip(grads, torch.autograd.grad(want.float().square().sum(), [h, *layer.parameters()])))


def _good(n=16, h=64):
    gen = torch.Generator().manual_seed(0)
    return dict(y=torch.randn(n, h, generator=gen).bfloat16(), b0=torch.randn(h, generator=gen).bfloat16(),
                agg=torch.randn(n, h, generator=gen).bfloat16(), gamma=torch.ones(h), beta=torch.zeros(h))


def _misaligned(t):
    flat = torch.empty(t.numel() + 1, dtype=t.dtype)
    return flat[1:].view_as(t).copy_(t)


REFUSED = {
    "f32_y_and_agg": lambda x: dict(x, y=x["y"].float(), agg=x["agg"].float()),
    "bf16_gamma": lambda x: dict(x, gamma=x["gamma"].bfloat16()),
    "h12_not_a_multiple_of_8": lambda x: {k: v[..., :12].contiguous() for k, v in x.items()},
    "h1032_over_1024": lambda x: _good(4, 1032),
    "non_contiguous_agg": lambda x: dict(x, agg=x["agg"].t().contiguous().t()),
    "misaligned_y": lambda x: dict(x, y=_misaligned(x["y"])),
    "agg_of_another_shape": lambda x: dict(x, agg=x["agg"][:8].contiguous()),
    "b0_of_another_width": lambda x: dict(x, b0=x["b0"][:56].contiguous()),
}


@pytest.mark.parametrize("case", REFUSED)
def test_the_layout_check_refuses_what_the_kernels_do_not_take(case):
    x = REFUSED[case](_good())
    assert not sage_update.fits(**x)


def test_the_layout_check_takes_the_layers_own_layout_and_the_device_check_refuses_the_cpu():
    for n, h in ((16, 64), (3, 8), (5, 1024), (2, 264)):
        x = _good(n, h)
        assert sage_update.fits(**x), (n, h)
        assert not sage_update.takes(**x)


def test_the_fused_op_refuses_cpu_tensors_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    before = _counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        sage_update.sage_update(**_good())
    assert _counts() == before


def test_the_kernels_gelu_constants_are_ops_gelu_in_bf16():
    src = (REPO / "dragonfly2_tpu_torch" / "csrc" / "sage_update.cu").read_text()
    consts = {name: float(v) for name, v in re.findall(r"constexpr float (k\w+) = ([0-9.e-]+)f;", src)}
    assert (consts["kGeluC"], consts["kGeluK"]) == gelu_lib._constants(torch.bfloat16)


def test_a_train_step_on_the_cpu_launches_nothing():
    cluster = synthetic.make_cluster(num_nodes=64, num_neighbors=4, num_pairs=256, seed=3)
    cfg = train_gnn.GNNTrainConfig(hidden=16, embed_dim=8, num_layers=2, batch_size=32)
    state = train_gnn.init_state(cfg, rng_seed=5, device="cpu")
    before = _counts()
    _, loss = train_gnn.make_train_step()(state, cluster.graph.to("cpu"),
                                          synthetic.sample_batch(cluster.pairs, 32, np.random.default_rng(0)))
    assert _counts() == before and bool(torch.isfinite(loss))


_DTENSOR = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_module, distribute_tensor
from torch.profiler import ProfilerActivity, profile
from dragonfly2_tpu_torch.models.graphsage import SAGELayer, TopoGraph
from dragonfly2_tpu_torch.ops import sage_update

torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{sys.argv[1]}", world_size=1, rank=0)
try:
    mesh = init_device_mesh("cpu", (1,))
    gen = torch.Generator().manual_seed(0)
    n, k = 32, 4
    graph = TopoGraph(torch.randn(n, 12, generator=gen), torch.randint(0, n, (n, k), generator=gen, dtype=torch.int32),
                      (torch.rand(n, k, generator=gen) < 0.7).float(), torch.randn(n, k, 4, generator=gen))
    h = torch.randn(n, 16, generator=gen)
    layer = SAGELayer(16, 16)
    local = layer(h, graph)
    distribute_module(layer, mesh)
    dg = TopoGraph(*(distribute_tensor(t, mesh, [Replicate()]) for t in graph))
    dh = distribute_tensor(h, mesh, [Replicate()])
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = layer(dh, dg)
        out.to_local().float().square().sum().backward()
    names = sorted({e.name for e in prof.events() if e.name.startswith("gnn.sage.")})
    print(json.dumps({"names": names, "counts": [sage_update.LAUNCHES, sage_update.BWD_LAUNCHES],
                      "dtensor": type(out).__name__, "equal": bool(torch.equal(out.to_local(), local))}))
finally:
    dist.destroy_process_group()
"""


def test_a_sage_layer_on_a_dtensor_runs_the_plain_update():
    p = subprocess.run([sys.executable, "-c", _DTENSOR, str(free_port())], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"names": ["gnn.sage.gather", "gnn.sage.mean", "gnn.sage.message"], "counts": [0, 0],
                   "dtensor": "DTensor", "equal": True}
