#!/usr/bin/env python3
"""Where the port's GNN training parts from the JAX package's, on the CPU.

    JAX_PLATFORMS=cpu python tools/torch_gap_probe.py floor [--seeds 0 1 2 3 4]
    JAX_PLATFORMS=cpu python tools/torch_gap_probe.py mesh

At the shapes of tests/test_torch_parallel.py (64 hosts, K=4, hidden 32,
embed 16, 2 SAGE layers, batch 128, six steps):

``floor`` trains one device in both frameworks from the same JAX init (one
run per init seed) on the same batches and counts, per framework, the
elements on the gradient floor: those whose gradient stays at or under
GRAD_FLOOR of its leaf's largest at every step. It prints how many there
are, how many the two frameworks share, how many of JAX's are exactly 0 at
some step where the port's is not, and how many final parameters part by
more than 1e-2 (and whether all of those lie on the floor).

``ops`` holds tanh-GELU alone, torch's fused ``F.gelu`` and the port's
``gelu``, against JAX's on every bf16 value in [-12, 12]: value and VJP,
and where JAX's VJP is exactly 0 and the port's is not.

``mesh`` takes the parameters of the port's single-process run before its
fifth step and that step's batch, and compares each leaf's gradient on a
(4, 1), a (1, 4) and a (2, 2) mesh with the single-process gradient, in the
port (four gloo ranks) and in JAX (four virtual CPU devices): the relative
gap of each leaf and of the global norm.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import sys
import tempfile
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=4").strip()
REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from dragonfly2_tpu.models.graphsage import TopoGraph as JaxTopoGraph  # noqa: E402
from dragonfly2_tpu.parallel import mesh as jax_mesh  # noqa: E402
from dragonfly2_tpu.trainer import synthetic as jax_synthetic  # noqa: E402
from dragonfly2_tpu.trainer import train_gnn as jax_train  # noqa: E402
from dragonfly2_tpu_torch.models.weights import params_from_flax, params_to_flax  # noqa: E402
from dragonfly2_tpu_torch.parallel import distributed as dist_lib  # noqa: E402
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn  # noqa: E402

torch.set_num_threads(1)

CLUSTER = dict(num_nodes=64, num_neighbors=4, num_pairs=2048, seed=1)
TRAIN = dict(hidden=32, embed_dim=16, num_layers=2, batch_size=128, warmup_steps=2)
STEPS, GRAD_FLOOR, PARAM_ABS = 6, 1e-4, 1e-2
MESHES = ((4, 1), (1, 4), (2, 2))


def _leaves(tree) -> dict[str, np.ndarray]:
    return {k: v.numpy().astype(np.float64) for k, v in params_from_flax(jax.tree.map(np.asarray, tree)).items()}


def _batches(jcluster) -> list:
    rng = np.random.default_rng(0)
    return [jax_synthetic.sample_batch(jcluster.pairs, TRAIN["batch_size"], rng) for _ in range(STEPS)]


def jax_run(seed: int, jcluster, batches):
    """JAX's jitted one-device step: start tree, every step's gradients, final parameters."""
    cfg = jax_train.GNNTrainConfig(**TRAIN)
    state = jax_train.init_state(cfg, jcluster.graph, rng_seed=seed)
    start = jax.tree.map(np.asarray, state.params)
    g = JaxTopoGraph(*map(jnp.asarray, jcluster.graph))
    step = jax.jit(jax_train.train_step)
    grad = jax.jit(jax.grad(functools.partial(jax_train.loss_fn, state.apply_fn)))
    grads = []
    for b in batches:
        jb = jax_synthetic.PairBatch(*(jnp.asarray(a) for a in b))
        grads.append(_leaves(grad(state.params, g, jb)))
        state, _ = step(state, g, jb)
    return start, grads, _leaves(state.params)


def port_run(start, batches, steps: int = STEPS):
    """The port's one-process step on the CPU from ``start``: every step's
    gradients (as the optimizer receives them), the parameters before each
    step, and the final parameters."""
    state = train_gnn.init_state(train_gnn.GNNTrainConfig(**TRAIN), params=start, device="cpu")
    g = synthetic.make_cluster(**CLUSTER).graph.to("cpu")
    step = train_gnn.make_train_step()
    grads, befores, optimizer_step = [], [], state.optimizer.step

    def spy(count):
        grads.append({n: q.grad.numpy().astype(np.float64) for n, q in state.model.named_parameters()})
        return optimizer_step(count)

    state.optimizer.step = spy
    for b in batches[:steps]:
        befores.append({k: v.detach().clone() for k, v in state.model.state_dict().items()})
        state, _ = step(state, g, b)
    final = {k: v.detach().numpy().astype(np.float64) for k, v in state.model.state_dict().items()}
    return grads, befores, final


def _steps(grads: list[dict], name: str) -> np.ndarray:
    """One leaf's gradient at every step, stacked."""
    return np.stack([step[name] for step in grads])


def on_floor(grads: list[dict], name: str) -> np.ndarray:
    g = np.abs(_steps(grads, name))
    leaf_max = g.reshape(len(g), -1).max(axis=1).reshape((-1,) + (1,) * (g.ndim - 1))
    return np.all(g <= GRAD_FLOOR * leaf_max, axis=0)


def floor(seeds: list[int]) -> list[dict]:
    jcluster = jax_synthetic.make_cluster(**CLUSTER)
    batches = _batches(jcluster)
    rows = []
    for seed in seeds:
        start, jgrads, jfinal = jax_run(seed, jcluster, batches)
        pgrads, _, pfinal = port_run(start, batches)
        row = {"seed": seed, "elements": 0, "jax_floor": 0, "port_floor": 0, "shared": 0,
               "jax_zero_port_not": 0, "gap_over_1e-2": 0, "gap_over_1e-2_on_jax_floor": 0,
               "max_gap_off_floor": 0.0, "max_gap_on_floor": 0.0, "floor_by_leaf": {}}
        for name in sorted(pfinal):
            jf, pf = on_floor(jgrads, name), on_floor(pgrads, name)
            jz = np.any(_steps(jgrads, name) == 0, axis=0)
            pnz = np.all(_steps(pgrads, name) != 0, axis=0)
            gap = np.abs(pfinal[name] - jfinal[name])
            row["elements"] += gap.size
            row["jax_floor"] += int(jf.sum())
            row["port_floor"] += int(pf.sum())
            row["shared"] += int((jf & pf).sum())
            row["jax_zero_port_not"] += int((jf & jz & pnz).sum())
            row["gap_over_1e-2"] += int((gap > PARAM_ABS).sum())
            row["gap_over_1e-2_on_jax_floor"] += int(((gap > PARAM_ABS) & jf).sum())
            row["max_gap_off_floor"] = max(row["max_gap_off_floor"], float(gap[~jf].max(initial=0.0)))
            row["max_gap_on_floor"] = max(row["max_gap_on_floor"], float(gap[jf].max(initial=0.0)))
            if jf.any():
                row["floor_by_leaf"][name] = [int(jf.sum()), int(pf.sum()), int((jf & pf).sum())]
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def _all_bf16(lo: float, hi: float) -> torch.Tensor:
    """Every finite bf16 value in [lo, hi]."""
    v = torch.from_numpy(np.arange(1 << 16, dtype=np.uint16).view(np.int16).copy()).view(torch.bfloat16)
    f = v.float()
    return v[torch.isfinite(f) & (f >= lo) & (f <= hi)]


def ops() -> list[dict]:
    """tanh-GELU's value and VJP, torch's fused F.gelu and the port's gelu
    each against jax.nn.gelu(approximate=True), on every bf16 value in
    [-12, 12] with one random bf16 cotangent each."""
    from dragonfly2_tpu_torch.models import graphsage

    x = _all_bf16(-12.0, 12.0)
    ct = torch.from_numpy(np.random.default_rng(0).standard_normal(len(x)).astype(np.float32)).to(torch.bfloat16)
    xj = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    jy, vjp = jax.vjp(lambda v: jax.nn.gelu(v, approximate=True), xj)
    (jg,) = vjp(jnp.asarray(ct.float().numpy()).astype(jnp.bfloat16))
    jy, jg = np.asarray(jy.astype(jnp.float32)), np.asarray(jg.astype(jnp.float32))
    xs = x.float().numpy()
    rows = []
    for name, fn in (("F.gelu", lambda v: torch.nn.functional.gelu(v, approximate="tanh")),
                     ("port gelu", graphsage.gelu)):
        xt = x.clone().requires_grad_(True)
        y = fn(xt)
        y.backward(ct)
        py, pg = y.detach().float().numpy(), xt.grad.float().numpy()
        row = {"op": name, "values": len(xs), "value_mismatches": int((py != jy).sum()),
               "value_max_abs": float(np.abs(py - jy).max()), "vjp_mismatches": int((pg != jg).sum()),
               "vjp_max_abs": float(np.abs(pg - jg).max()),
               "jax_vjp_zero_port_not": int(((jg == 0) & (pg != 0)).sum()),
               "largest_x_with_zero_vjp": {"jax": float(xs[jg == 0].max()), name: float(xs[pg == 0].max())}}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


_MESH_WORKER = """
import json, os
from pathlib import Path
import numpy as np
import torch
from dragonfly2_tpu_torch.models.weights import params_to_flax
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
from dragonfly2_tpu_torch.parallel import mesh as meshlib
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn
from dragonfly2_tpu_torch.trainer.synthetic import PairBatch

CLUSTER, TRAIN, MESHES = {cluster}, {train}, {meshes}
out = Path(os.environ["OUT"])
cfg = dist_lib.DistributedConfig.from_env()
dev = dist_lib.initialize(cfg, timeout=60)
try:
    with np.load(out / "before.npz") as z:
        start = params_to_flax({{k: torch.from_numpy(z[k]) for k in z.files}})
    with np.load(out / "batch.npz") as z:
        batch = PairBatch(*(z[k] for k in ("child", "parent", "feats", "label")))
    graph = synthetic.make_cluster(**CLUSTER).graph
    for dp, tp in MESHES:
        mesh = meshlib.make_mesh(model_parallel=tp)
        assert tuple(mesh.shape) == (dp, tp), mesh.shape
        state = train_gnn.init_state(train_gnn.GNNTrainConfig(**TRAIN), params=start, device=dev)
        state, g, _ = train_gnn.shard_for_training(state, graph, mesh)
        grads, optimizer_step = {{}}, state.optimizer.step

        def spy(count):
            for n, q in state.model.named_parameters():
                grads[n] = q.grad.full_tensor().numpy()
            return optimizer_step(count)

        state.optimizer.step = spy
        train_gnn.make_train_step()(state, g, batch)
        if cfg.process_id == 0:
            np.savez(out / f"grads_{{dp}}x{{tp}}.npz", **grads)
finally:
    dist_lib.shutdown()
"""


def mesh() -> dict:
    """Per-leaf relative gradient gaps of each mesh to one process, port and JAX."""
    jcluster = jax_synthetic.make_cluster(**CLUSTER)
    batches = _batches(jcluster)
    jstate = jax_train.init_state(jax_train.GNNTrainConfig(**TRAIN), jcluster.graph, rng_seed=0)
    start = jax.tree.map(np.asarray, jstate.params)
    at = 4  # the step whose pre-clip norm parts by 8.6e-3 in the four-rank test
    pgrads, befores, _ = port_run(start, batches, steps=at + 1)
    before, batch, one = befores[at], batches[at], pgrads[at]
    result: dict = {"step": at, "port": {}, "jax": {}}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        np.savez(out / "before.npz", **{k: v.numpy() for k, v in before.items()})
        np.savez(out / "batch.npz", child=batch.child, parent=batch.parent, feats=batch.feats, label=batch.label)
        (out / "gap_mesh_worker.py").write_text(
            _MESH_WORKER.format(cluster=repr(CLUSTER), train=repr(TRAIN), meshes=repr(MESHES)))
        dist_lib.launch_localhost(4, "gap_mesh_worker", local_devices=1,
                                  extra_env={"PYTHONPATH": str(out), "OUT": str(out)}, timeout=300)
        for dp, tp in MESHES:
            with np.load(out / f"grads_{dp}x{tp}.npz") as z:
                got = {k: z[k].astype(np.float64) for k in z.files}
            result["port"][f"{dp}x{tp}"] = _gaps(got, one)

    tree = jax.tree.map(jnp.asarray, params_to_flax(before))
    g = JaxTopoGraph(*map(jnp.asarray, jcluster.graph))
    jb = jax_synthetic.PairBatch(*(jnp.asarray(a) for a in batch))
    grad = jax.jit(jax.grad(functools.partial(jax_train.loss_fn, jstate.apply_fn)))
    jone = _leaves(grad(tree, g, jb))
    for dp, tp in MESHES:
        jm = jax_mesh.make_mesh(jax.devices()[:4], model_parallel=tp)
        sharded, sg, _ = jax_train.shard_for_training(jstate, jcluster.graph, jm)
        placed = jax.device_put(tree, jax.tree.map(lambda x: x.sharding, sharded.params))
        got = _leaves(grad(placed, sg, jax.device_put(jb, jax_mesh.batch_sharding(jm))))
        result["jax"][f"{dp}x{tp}"] = _gaps(got, jone)
    for fw in ("port", "jax"):
        for shape, gaps in result[fw].items():
            top = sorted(gaps["leaves"].items(), key=lambda kv: -kv[1])[:4]
            print(f"{fw} {shape}: global norm rel gap {gaps['norm']:.3g}; largest leaf gaps "
                  + ", ".join(f"{k} {v:.3g}" for k, v in top), flush=True)
    print(json.dumps(result), flush=True)
    return result


def _gaps(got: dict, ref: dict) -> dict:
    leaves = {k: float(np.linalg.norm(got[k] - ref[k]) / max(np.linalg.norm(ref[k]), 1e-30)) for k in ref}
    norm = lambda t: float(np.sqrt(sum(float((v * v).sum()) for v in t.values())))  # noqa: E731
    return {"norm": abs(norm(got) - norm(ref)) / norm(ref), "leaves": leaves}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["floor", "ops", "mesh"])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4])
    args = ap.parse_args()
    {"floor": lambda: floor(args.seeds), "ops": ops, "mesh": mesh}[args.what]()
    return 0


if __name__ == "__main__":
    sys.exit(main())
