"""The fused SAGE message op's dispatch and index, on the CPU.

K3 and K4 (``ops/sage_message.py``, ``csrc/neighbor_agg.cu``) run only on a
card; tests/test_torch_sage_message_cuda.py holds them against the plain
path there. Here: a SAGE layer on the CPU, and on a DTensor, takes the plain
path (the gather, message and mean spans, no launch); the fused op refuses
CPU tensors before building anything; K4's transposed index lists every
live slot under its destination; the plain version equals the layer's path.
"""

import json
import re
import subprocess
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.profiler import ProfilerActivity, profile

from dragonfly2_tpu_torch.models.graphsage import GraphSAGE, SAGELayer, TopoGraph, gelu
from dragonfly2_tpu_torch.ops import _build, gelu as gelu_lib, sage_message
from dragonfly2_tpu_torch.parallel.distributed import free_port
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

torch.set_num_threads(1)

SAGE_STAGES = ("gnn.sage.gather", "gnn.sage.message", "gnn.sage.mean")
REPO = Path(__file__).resolve().parents[1]


def _graph(n=48, k=5, e=4, seed=0, p=0.7):
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n, (n, k)).astype(np.int32)
    mask = (rng.random((n, k)) < p).astype(np.float32)
    return TopoGraph(rng.normal(size=(n, 12)).astype(np.float32), nbr, mask,
                     rng.normal(size=(n, k, e)).astype(np.float32)).to("cpu")


def _counts():
    return sage_message.LAUNCHES, sage_message.BWD_LAUNCHES


def _stage_names(prof, tmp_path) -> Counter:
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return Counter(e["name"] for e in events if e.get("ph") == "X" and e.get("name", "").startswith("gnn.sage."))


@pytest.mark.parametrize("grad", [False, True], ids=["no_grad", "grad"])
def test_sage_layers_on_the_cpu_take_the_plain_path_with_its_three_spans(tmp_path, grad):
    g = _graph()
    enc = GraphSAGE(hidden=16, embed_dim=8, num_layers=2, node_dim=12)
    before = _counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.set_grad_enabled(grad):
            z = enc(g)
        if grad:
            z.square().sum().backward()
    assert _counts() == before
    assert _stage_names(prof, tmp_path) == {name: 2 for name in SAGE_STAGES}
    assert torch.isfinite(z).all()


def test_the_layer_path_is_the_plain_ops_of_the_message_path():
    g = _graph()
    layer = SAGELayer(16, 16)
    h = torch.from_numpy(np.random.default_rng(1).normal(size=(48, 16)).astype(np.float32))
    got = layer(h, g)
    hb = h.to(torch.bfloat16)
    u, s = layer.msg_nbr(hb), layer.msg_self(hb)
    agg = sage_message.sage_message_torch(u, s, g.edge_feats, layer.msg_edge.weight.to(torch.bfloat16),
                                          g.neighbors, g.mask)
    v = F.linear(g.edge_feats.to(torch.bfloat16), layer.msg_edge.weight.to(torch.bfloat16))
    assert torch.equal(agg, sage_message.message_path(u, s, v, g.neighbors, g.mask))
    want = layer.LayerNorm_0(gelu(layer.Dense_0(hb) + agg))
    assert torch.equal(got, want)


def test_the_kernels_gelu_constants_and_eps_are_the_plain_paths_in_bf16():
    src = (REPO / "dragonfly2_tpu_torch" / "csrc" / "neighbor_agg.cu").read_text()
    consts = {name: float(v) for name, v in re.findall(r"constexpr float (k\w+) = ([0-9.e-]+)f;", src)}
    assert (consts["kGeluC"], consts["kGeluK"]) == gelu_lib._constants(torch.bfloat16)
    assert consts["kMeanEps"] == 1e-6  # masked_mean's default eps, as an f32 operand


def test_a_cpu_graph_is_not_taken():
    g = _graph()
    u = torch.zeros(48, 16, dtype=torch.bfloat16)
    graph = sage_message.Graph(g.edge_feats, g.neighbors, g.mask)
    assert not graph.ok and not graph.takes(u, u.clone(), torch.zeros(16, 4))


def test_the_fused_op_refuses_cpu_tensors_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    g = _graph()
    u = torch.zeros(48, 16, dtype=torch.bfloat16)
    before = _counts()
    with pytest.raises(RuntimeError, match="CUDA"):
        sage_message.sage_message(u, u.clone(), g.edge_feats, torch.zeros(16, 4), g.neighbors, g.mask)
    assert _counts() == before


def _slots_by_destination(neighbors, mask, n):
    want = {j: [] for j in range(n)}
    for i, row in enumerate(neighbors.tolist()):
        for kk, j in enumerate(row):
            if float(mask[i, kk].to(torch.bfloat16)) != 0.0 and 0 <= j < n:
                want[j].append(i * neighbors.shape[1] + kk)
    return want


INDEX_CASES = ["random", "fully_masked_rows", "fractional_mask", "out_of_range", "mask_under_bf16", "k1", "k32"]


@pytest.mark.parametrize("case", INDEX_CASES)
def test_slot_index_lists_each_live_slot_under_its_destination_in_slot_order(case):
    n, k = {"k1": (40, 1), "k32": (64, 32)}.get(case, (50, 6))
    g = _graph(n=n, k=k, seed=INDEX_CASES.index(case))
    nbr, mask = g.neighbors.clone(), g.mask.clone()
    if case == "fully_masked_rows":
        mask[[0, 7, 49]] = 0.0
    elif case == "fractional_mask":
        mask = torch.from_numpy(np.random.default_rng(3).random((n, k)).astype(np.float32))
        mask[mask < 0.2] = 0.0
    elif case == "out_of_range":
        nbr[0, 0], mask[0, 0] = n + 3, 1.0
        nbr[1, 1], mask[1, 1] = -1, 1.0
        nbr[2, 2], mask[2, 2] = n, 1.0
    elif case == "mask_under_bf16":  # rounds to 0 in bf16: dead, as the kernels read it
        mask[4, :] = 1e-42
    indptr, slot = sage_message.slot_index(nbr, mask, n)
    assert indptr.dtype == slot.dtype == torch.int32 and indptr.shape == (n + 1,) and slot.shape == (n * k,)
    want = _slots_by_destination(nbr, mask, n)
    got = {j: slot[indptr[j]:indptr[j + 1]].tolist() for j in range(n)}
    assert got == want
    assert int(indptr[-1]) == sum(len(v) for v in want.values())


def test_the_encoder_prepares_one_graph_for_its_layers_and_builds_no_index_on_the_cpu(monkeypatch):
    made, built, seen = [], [], []
    real_graph, real_index = sage_message.Graph, sage_message.slot_index

    class Counting(real_graph):
        def __init__(self, *args):
            made.append(self)
            super().__init__(*args)

        def takes(self, *args):
            seen.append(self)
            return super().takes(*args)

    monkeypatch.setattr(sage_message, "Graph", Counting)
    monkeypatch.setattr(sage_message, "slot_index", lambda *a: built.append(a) or real_index(*a))
    enc = GraphSAGE(hidden=16, embed_dim=8, num_layers=3, node_dim=12)
    enc(_graph()).sum().backward()
    # one Graph a forward, asked by each layer; on the CPU it is not taken
    assert len(made) == 1 and seen == made * 3 and not made[0].ok
    assert built == []


_DTENSOR = """
import json, sys
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, distribute_module, distribute_tensor
from torch.profiler import ProfilerActivity, profile
from dragonfly2_tpu_torch.models.graphsage import SAGELayer, TopoGraph
from dragonfly2_tpu_torch.ops import sage_message

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
    names = [e.name for e in prof.events() if e.name.startswith("gnn.sage.")]
    print(json.dumps({"names": sorted(names), "counts": [sage_message.LAUNCHES, sage_message.BWD_LAUNCHES],
                      "dtensor": type(out).__name__, "equal": bool(torch.equal(out.to_local(), local))}))
finally:
    dist.destroy_process_group()
"""


def test_a_sage_layer_on_a_dtensor_takes_the_plain_path():
    p = subprocess.run([sys.executable, "-c", _DTENSOR, str(free_port())], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out == {"names": sorted(SAGE_STAGES), "counts": [0, 0], "dtensor": "DTensor", "equal": True}


def test_a_train_step_on_the_cpu_launches_nothing():
    cluster = synthetic.make_cluster(num_nodes=64, num_neighbors=4, num_pairs=256, seed=3)
    cfg = train_gnn.GNNTrainConfig(hidden=16, embed_dim=8, num_layers=2, batch_size=32)
    for remat in (False, True):
        state = train_gnn.init_state(cfg, rng_seed=5, device="cpu")
        before = _counts()
        state, loss = train_gnn.make_train_step(remat)(state, cluster.graph.to("cpu"),
                                                       synthetic.sample_batch(cluster.pairs, 32,
                                                                              np.random.default_rng(0)))
        assert _counts() == before and bool(torch.isfinite(loss))
