"""Parity of the port's parallel/ layer and sharded trainer with the JAX package's.

The mesh-shape and per-leaf placement rules are pure functions, held to
JAX's on the conftest's 8 virtual CPU devices. Everything that needs a
process group runs in subprocesses through ``launch_localhost`` (gloo on
the CPU, one torch thread each), under a cluster deadline of 120 s and a
process-group timeout of 60 s or less: no group is ever initialized in the
pytest process. One four-rank launch on a (2, 2) mesh trains six steps from
JAX's own init and is held against JAX's ``shard_for_training`` on a (2, 2)
mesh and against the port's single-process step; the same launch stages
sharded tensors, saves an artifact and runs ``train_async``/``train`` on the
mesh. The JAX and single-process references run after the launch, so the
ranks never contend with JAX's thread pools for the host's cores.
"""

import asyncio
import functools
import json
import os
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from dragonfly2_tpu.models.graphsage import TopoGraph as JaxTopoGraph
from dragonfly2_tpu.models.graphsage import TopoScorer as JaxTopoScorer
from dragonfly2_tpu.parallel import distributed as jax_dist
from dragonfly2_tpu.parallel import mesh as jax_mesh
from dragonfly2_tpu.tpuvm import safetensors as jax_st
from dragonfly2_tpu.tpuvm.staging import stage_tensors as jax_stage_tensors
from dragonfly2_tpu.trainer import synthetic as jax_synthetic
from dragonfly2_tpu.trainer import train_gnn as jax_train
from dragonfly2_tpu_torch.models.weights import params_from_flax, params_to_flax
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
from dragonfly2_tpu_torch.parallel import mesh as meshlib
from dragonfly2_tpu_torch.trainer import artifacts, synthetic, train_gnn

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)

DEADLINE_S = 120.0  # one wall-clock deadline for a whole cluster
# Against JAX: the trajectory bounds of tests/test_torch_train.py (bf16 rounds at other places there).
JAX_LOSS_ABS, JAX_PARAM_ABS = 1e-3, 1e-2
# Adam turns a gradient of any size into a step of about lr. An element
# whose reference gradient stays at or under GRAD_FLOOR of its leaf's
# largest at every step (a saturated unit: JAX's gradient there is 1e-5 of
# the leaf's, or 0) moves in a direction that rounding sets, in JAX as in
# the port, and is held to what AdamW can move an element in STEPS steps
# (``_adam_reach``); every other element is held to JAX_PARAM_ABS. At most
# FLOOR_SHARE of the elements may lie on the floor.
GRAD_FLOOR, FLOOR_SHARE = 1e-4, 0.02
# On one device, with tanh-GELU's value and gradient JAX's op for op
# (ops/gelu.py ``_Gelu``), the port's gradient is 0 wherever JAX's
# is, and every parameter, on the floor or off it, ends within
# JAX_ONE_DEVICE_ABS of JAX's (3.6e-3 at most on these inputs; 1.096e-2,
# on four floor elements, with torch's fused F.gelu).
JAX_ONE_DEVICE_ABS = 5e-3
# Against the port's own single-process step: the same ops, but the mesh
# sums the gradient of each half of the batch, and the products over
# "model" shards, in other orders. Those partial sums are taken in f32 and
# round to bf16 once, as one device's do (models/graphsage.py ``Dense``,
# the f32 neighbour gather), so the pre-clip norm, compared at every step on
# the same parameters (the mesh run's, gathered before the step), stays
# within 1e-4 relative at step 0 and PORT_GNORM_REL at every step (the test
# prints the largest: 9.5e-5 on these inputs; 8.6e-3 at step 4 while the
# partials summed in bf16). JAX's own (2, 2) mesh against its one device, on
# the same parameters, meets 1e-4 at step 0 and parts by up to 5.6e-4 later
# as the loss falls (it sums its partials as it likes), held to
# JAX_GNORM_REL (``test_jax_itself_parts_from_one_device_as_the_loss_falls``).
PORT_LOSS_ABS, PORT_PARAM_ABS, PORT_GNORM0_REL, PORT_GNORM_REL = 1e-4, 1e-3, 1e-4, 2e-4
JAX_GNORM_REL = 1e-3

CLUSTER = dict(num_nodes=64, num_neighbors=4, num_pairs=2048, seed=1)
TRAIN = dict(hidden=32, embed_dim=16, num_layers=2, batch_size=128, warmup_steps=2)
STEPS = 6


# --- pure rules -----------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 4, 8])
@pytest.mark.parametrize("model_parallel", [None, 1, 2, 4])
def test_mesh_shape_matches_jax_make_mesh(n, model_parallel):
    try:
        want = jax_mesh.make_mesh(jax.devices()[:n], model_parallel=model_parallel).shape
    except ValueError:
        with pytest.raises(ValueError):
            meshlib.mesh_shape(n, model_parallel)
        return
    assert meshlib.mesh_shape(n, model_parallel) == (want["data"], want["model"])


def _flax_shapes(hidden, embed_dim, num_layers, head_hidden):
    """The flax parameter tree of a JAX TopoScorer, as zero numpy leaves."""
    g = jax_synthetic.make_cluster(num_nodes=8, num_neighbors=4, num_pairs=16, seed=0).graph
    model = JaxTopoScorer(hidden=hidden, embed_dim=embed_dim, num_layers=num_layers, head_hidden=head_hidden)
    idx = jnp.zeros((2,), jnp.int32)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), JaxTopoGraph(*map(jnp.asarray, g)), idx, idx,
                            jnp.zeros((2, jax_synthetic.FEATURE_DIM), jnp.float32))
    return jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)


def _torch_name(path) -> str:
    keys = [p.key for p in path][1:]  # drop "params"
    return ".".join(keys[:-1] + [{"kernel": "weight", "scale": "weight", "bias": "bias"}[keys[-1]]])


def _as_placements(spec, ndim: int) -> tuple:
    """JAX's spec of a flax leaf as the port's placements of the torch leaf
    (a 2-D kernel is the torch weight transposed)."""
    dims = [i for i, axis in enumerate(tuple(spec)) if axis == "model"]
    if not dims:
        return (Replicate(), Replicate())
    (d,) = dims
    return (Replicate(), Shard(ndim - 1 - d if ndim == 2 else d))


@pytest.mark.parametrize("widths", [(64, 32, 2, 256), (6, 5, 1, 10)], ids=["hidden64", "odd_widths"])
@pytest.mark.parametrize("dp_tp", [(2, 4), (4, 2), (8, 1)], ids=lambda s: f"mesh{s[0]}x{s[1]}")
def test_param_placements_match_jax_param_leaf_sharding(widths, dp_tp):
    tree = _flax_shapes(*widths)
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(dp_tp), ("data", "model"))
    leaves = jax.tree_util.tree_leaves_with_path(tree)
    names = {_torch_name(path): leaf for path, leaf in leaves}
    torch_params = params_from_flax(tree)
    assert names.keys() == torch_params.keys()  # matched by params_from_flax's names
    for name, leaf in names.items():
        sharding = jax_mesh.param_leaf_sharding(leaf, mesh)
        # the layout, not its spelling: "model" of one device replicates
        want = (Replicate(), Replicate()) if sharding.is_fully_replicated else _as_placements(sharding.spec, leaf.ndim)
        got = meshlib.param_leaf_placements(torch_params[name], dp_tp)
        assert got == want, (name, leaf.shape, got, want)
    assert meshlib.infer_param_placements(torch_params, dp_tp) == {
        n: meshlib.param_leaf_placements(t, dp_tp) for n, t in torch_params.items()
    }


def test_graph_and_batch_placements_match_jax():
    """Node rows and batch rows over "data", whole over "model", as JAX's
    ``graph_shardings`` and ``batch_sharding`` place them."""
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    specs = [s.spec for s in (*jax_mesh.graph_shardings(mesh), jax_mesh.batch_sharding(mesh))]
    assert specs == [P("data")] * 5
    assert meshlib.graph_placements((2, 2)) == (meshlib.batch_placements((2, 2)),) * 4
    assert meshlib.batch_placements((2, 2)) == (Shard(0), Replicate())


def test_distributed_config_env_round_trip(monkeypatch):
    cfg = dist_lib.DistributedConfig("127.0.0.1:1234", 4, 3, 1)
    env = cfg.env()
    assert env.keys() == jax_dist.DistributedConfig().env().keys()  # the same four DF_DIST_* variables
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert dist_lib.DistributedConfig.from_env() == cfg
    assert (cfg.backend, cfg.device()) == ("gloo", torch.device("cpu"))
    assert dist_lib.DistributedConfig(local_device_count=0).backend == "nccl"
    with pytest.raises(ValueError):
        dist_lib.DistributedConfig(local_device_count=2).device()  # a process is one device
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            dist_lib.DistributedConfig(local_device_count=0).device()


def test_data_row_slice_follows_the_data_coordinate():
    """On a (2, 2) mesh rank r sits at data coordinate r // 2: ranks 0 and 1
    hold the first half of the rows, ranks 2 and 3 the second."""
    dp, tp = 2, 2
    got = [dist_lib.data_row_slice(128, dp, rank // tp) for rank in range(dp * tp)]
    assert got == [(0, 64), (0, 64), (64, 128), (64, 128)]
    with pytest.raises(ValueError):
        dist_lib.data_row_slice(127, 2, 0)


def test_make_mesh_refuses_without_a_process_group():
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="no process group"):
        meshlib.make_mesh()


def test_device_and_mesh_are_exclusive():
    cluster = synthetic.make_cluster(num_nodes=16, num_neighbors=4, num_pairs=64, seed=0)
    cfg = train_gnn.GNNTrainConfig(**TRAIN)
    with pytest.raises(ValueError, match="not both"):
        train_gnn.train(cfg, cluster.graph, cluster.pairs, steps=1, device="cpu", mesh=object())
    with pytest.raises(ValueError, match="not both"):
        asyncio.run(train_gnn.train_async(cfg, cluster.graph, cluster.pairs, steps=1, device="cpu", mesh=object()))


# --- the launcher's deadlines ---------------------------------------------

_HANG = """
import os, time
import torch, torch.distributed as dist
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
dist_lib.initialize(timeout=float(os.environ["PG_TIMEOUT"]))
if os.environ["MODE"] == "collective" and dist.get_rank() == 0:
    dist.all_reduce(torch.ones(1))  # rank 1 never joins
time.sleep(300)
"""


@pytest.mark.parametrize("mode", ["collective", "sleep"])
def test_launch_localhost_kills_a_hung_cluster(tmp_path, mode):
    """A collective that one rank never joins fails at the group's timeout,
    and the launcher then kills the rank still waiting; a cluster that
    simply hangs is killed at the launcher's deadline."""
    (tmp_path / "hang_worker.py").write_text(_HANG)
    env = {"PYTHONPATH": str(tmp_path), "MODE": mode, "PG_TIMEOUT": "5"}
    t0 = time.monotonic()
    with pytest.raises(RuntimeError) as info:
        dist_lib.launch_localhost(2, "hang_worker", local_devices=1, extra_env=env,
                                  timeout=30 if mode == "collective" else 8)
    took = time.monotonic() - t0
    assert took < 30
    if mode == "collective":
        assert "a process failed" in str(info.value)
    else:
        assert "deadline" in str(info.value) and took >= 8


@pytest.mark.skipif(torch.cuda.is_available(), reason="the default puts the rank on this host's card")
def test_launch_localhost_defaults_to_the_card():
    """Without ``local_devices`` every rank is a card over NCCL: with no card
    the rank raises, and so does the launcher; nothing trains on the CPU."""
    with pytest.raises(RuntimeError, match="selects the card"):
        dist_lib.launch_localhost(1, "dragonfly2_tpu_torch.parallel.mp_train", timeout=DEADLINE_S)


# --- mp_train --------------------------------------------------------------


def test_mp_train_two_processes_loss_falls():
    done = dist_lib.launch_localhost(
        2, "dragonfly2_tpu_torch.parallel.mp_train", local_devices=1,
        extra_env={"DF_MP_STEPS": "10"}, timeout=DEADLINE_S,
    )
    lines = done[0].stdout.splitlines()
    ok = next(line for line in lines if line.startswith("mp_train ok"))
    assert "procs=2 devices=2" in ok and "mesh={'data': 1, 'model': 2}" in ok
    losses = json.loads(next(line for line in lines if line.startswith("MP_LOSSES "))[len("MP_LOSSES "):])
    assert len(losses) == 10 and all(np.isfinite(v) for v in losses)
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 0.5, losses
    assert done[1].stdout == ""  # only rank 0 reports


# --- one four-rank launch on a (2, 2) mesh ----------------------------------

_WORKER = """
import asyncio, dataclasses, json, os
from pathlib import Path

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Shard

from dragonfly2_tpu_torch.models.weights import full_state_dict, params_to_flax
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
from dragonfly2_tpu_torch.parallel import mesh as meshlib
from dragonfly2_tpu_torch.tpuvm import staging
from dragonfly2_tpu_torch.trainer import artifacts, synthetic, train_gnn

CLUSTER, TRAIN, STEPS = {cluster}, {train}, {steps}


def main():
    out = Path(os.environ["OUT"])
    cfg = dist_lib.DistributedConfig.from_env()
    dev = dist_lib.initialize(cfg, timeout=60)
    rank = cfg.process_id
    try:
        mesh = meshlib.make_mesh(model_parallel=2)
        report = {{"coordinate": mesh.get_coordinate(), "rows": dist_lib.local_row_slice(128, mesh)}}
        cluster = synthetic.make_cluster(**CLUSTER)
        tcfg = train_gnn.GNNTrainConfig(**TRAIN)
        with np.load(out / "start.npz") as z:
            start = params_to_flax({{k: torch.from_numpy(z[k]) for k in z.files}})
        state = train_gnn.init_state(tcfg, params=start, device=dev)
        state, g, _ = train_gnn.shard_for_training(state, cluster.graph, mesh)
        step = train_gnn.make_train_step(with_metrics=True)
        report["graph_rows"] = [[t.to_local().shape[0], t.shape[0]] for t in g]

        raw = {{}}
        optimizer_step = state.optimizer.step

        def spy(count):  # the gradients' placements as the backward left them
            if not raw:
                raw.update({{n: [repr(p) for p in q.grad.placements] for n, q in state.model.named_parameters()}})
            return optimizer_step(count)

        state.optimizer.step = spy
        rng = np.random.default_rng(0)
        losses, norms, batch_rows = [], [], []
        for i in range(STEPS):
            before = full_state_dict(state.model)  # a collective: every rank gathers
            if rank == 0:
                np.savez(out / f"before{{i}}.npz", **{{k: v.numpy() for k, v in before.items()}})
            b = synthetic.sample_batch(cluster.pairs, tcfg.batch_size, rng)
            if i % 2:  # this rank's rows, placed here; else the global host batch
                lo, hi = dist_lib.local_row_slice(tcfg.batch_size, mesh)
                b = synthetic.PairBatch(*(dist_lib.process_local_batch(mesh, a[lo:hi], a.shape) for a in b))
                batch_rows.append([b.child.to_local().shape[0], b.child.shape[0]])
            state, (loss, gnorm) = step(state, g, b)
            losses.append(float(loss))
            norms.append(float(gnorm))
        opt = state.optimizer
        report.update(losses=losses, norms=norms, batch_rows=batch_rows, raw_grad_placements=raw)
        report["param_placements"] = {{n: [repr(p) for p in q.placements] for n, q in state.model.named_parameters()}}
        report["all_dtensor"] = all(isinstance(t, DTensor) for t in (*opt.params, *opt.mu, *opt.nu))
        report["moments_placed_as_params"] = all(
            p.placements == m.placements == v.placements for p, m, v in zip(opt.params, opt.mu, opt.nu))
        try:
            torch._foreach_mul_([opt.mu[0], torch.zeros_like(opt.mu[0].to_local())], 1.0)
            report["mixed_foreach"] = "accepted"
        except Exception as e:  # the trap: torch refuses a mixed list
            report["mixed_foreach"] = type(e).__name__ + ": " + str(e)

        full = full_state_dict(state.model)  # a collective: every rank gathers
        np.savez(out / f"params{{rank}}.npz", **{{k: v.numpy() for k, v in full.items()}})
        artifacts.save_artifact(out / f"art{{rank}}", model_type="gnn", version="mesh", params=state.model,
                                config={{k: TRAIN[k] for k in ("hidden", "embed_dim", "num_layers")}})

        pl = (Shard(0), Shard(1))  # P("data", "model")
        staged = staging.stage_tensors(out / "stage.safetensors", mesh=mesh, placements=lambda name: pl)
        shards = {{}}
        for name, t in staged.items():
            local, whole = t.to_local(), t.full_tensor()
            if t.dtype == torch.bfloat16:
                local, whole = local.view(torch.int16), whole.view(torch.int16)
            shards[f"local_{{name}}"], shards[f"full_{{name}}"] = local.numpy(), whole.numpy()
            report[f"slice_{{name}}"] = [[s.start, s.stop] for s in staging.local_slices(tuple(t.shape), mesh, pl)]
        np.savez(out / f"staged{{rank}}.npz", **shards)

        _, report["async_losses"] = asyncio.run(train_gnn.train_async(
            tcfg, cluster.graph, cluster.pairs, steps=4, steps_per_call=2, mesh=mesh, seed=0))
        # 127 rows cannot split over dp=2: train() must round the batch up
        _, report["padded_losses"] = train_gnn.train(
            dataclasses.replace(tcfg, batch_size=127), cluster.graph, cluster.pairs, steps=2, mesh=mesh, log_every=1)
        (out / f"report{{rank}}.json").write_text(json.dumps(report))
    finally:
        dist_lib.shutdown()


main()
"""


def _stage_tensors():
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal((32, 16)).astype(np.float32)
    bf16 = (rng.standard_normal((32, 16)).astype(np.float32).view(np.uint32) >> 16).astype(np.uint16)
    return {"f32": f32, "bf16": bf16}


def _torch_leaves(tree) -> dict[str, np.ndarray]:
    """A flax tree (parameters or gradients) as float64 arrays under the
    port's names and layouts."""
    return {k: v.numpy().astype(np.float64) for k, v in params_from_flax(jax.tree.map(np.asarray, tree)).items()}


def _jax_run(cluster, batches, mesh=None):
    """JAX's shard_for_training on ``mesh``, or its jitted step on one
    device: the losses, the parameters before and after every step, and
    every step's gradients."""
    cfg = jax_train.GNNTrainConfig(**TRAIN)
    state = jax_train.init_state(cfg, cluster.graph, rng_seed=0)
    if mesh is None:
        g, step = JaxTopoGraph(*map(jnp.asarray, cluster.graph)), jax.jit(jax_train.train_step)
    else:
        state, g, step = jax_train.shard_for_training(state, cluster.graph, mesh)
    grad = jax.jit(jax.grad(functools.partial(jax_train.loss_fn, state.apply_fn)))
    losses, params, grads = [], [_torch_leaves(state.params)], []
    for b in batches:
        jb = jax_synthetic.PairBatch(*(jnp.asarray(a) for a in b))
        grads.append(_torch_leaves(grad(state.params, g, jb)))
        state, loss = step(state, g, jb)
        losses.append(float(loss))
        params.append(_torch_leaves(state.params))
    return np.array(losses), params, grads


def _state_dict(state) -> dict[str, np.ndarray]:
    return {k: v.detach().numpy().astype(np.float64) for k, v in state.model.state_dict().items()}


def _port_run(cluster, start, batches):
    """The port's single-process step on the CPU from the flax tree
    ``start``: the losses, the pre-clip norms, the parameters before and
    after every step, and every step's gradients."""
    state = train_gnn.init_state(train_gnn.GNNTrainConfig(**TRAIN), params=start, device="cpu")
    g = cluster.graph.to("cpu")
    step = train_gnn.make_train_step(with_metrics=True)
    grads, optimizer_step = [], state.optimizer.step

    def spy(count):  # the gradients as the optimizer receives them
        grads.append({n: q.grad.numpy().astype(np.float64) for n, q in state.model.named_parameters()})
        return optimizer_step(count)

    state.optimizer.step = spy
    losses, norms, params = [], [], [_state_dict(state)]
    for b in batches:
        state, (loss, gnorm) = step(state, g, b)
        losses.append(float(loss))
        norms.append(float(gnorm))
        params.append(_state_dict(state))
    return np.array(losses), np.array(norms), params, grads


def _port_norms_at(cluster, befores, batches) -> np.ndarray:
    """The port's single-process pre-clip gradient norm of each batch at
    the parameters ``befores`` gives for its step."""
    step = train_gnn.make_train_step(with_metrics=True)
    g = cluster.graph.to("cpu")
    norms = []
    for before, b in zip(befores, batches):
        start = params_to_flax({k: torch.from_numpy(v) for k, v in before.items()})
        _, (_, gnorm) = step(train_gnn.init_state(train_gnn.GNNTrainConfig(**TRAIN), params=start, device="cpu"), g, b)
        norms.append(float(gnorm))
    return np.array(norms)


def _adam_reach() -> float:
    """The most two AdamW runs of STEPS steps can part one element, whatever
    its gradients. Step k (from 1) moves it by lr·|m̂/(√v̂ + eps)| plus the
    decay, and by Cauchy-Schwarz |m̂|/√v̂ <= (1-b1)/(1-b1^k) ·
    √((1-b2^k)/(1-b2)) · √Σ_{j<k} (b1²/b2)^j, about 1 in these first steps.
    The decay moves two runs alike up to wd·lr times their gap, which is
    left out (1e-4 of 1e-2 here)."""
    opt = train_gnn.make_optimizer(train_gnn.GNNTrainConfig(**TRAIN), [])
    b1, b2 = opt.b1, opt.b2
    reach = 0.0
    for count in range(STEPS):
        k = count + 1
        ratio = ((1 - b1) / (1 - b1**k) * np.sqrt((1 - b2**k) / (1 - b2))
                 * np.sqrt(sum((b1 * b1 / b2) ** j for j in range(k))))
        reach += 2 * opt.schedule(count) * ratio
    return float(reach)


def _on_floor(grads: list[np.ndarray]) -> np.ndarray:
    """Where one leaf's gradient stays at or under GRAD_FLOOR of the leaf's
    largest at every step."""
    g = np.abs(np.stack(grads))
    leaf_max = g.reshape(len(g), -1).max(axis=1).reshape((-1,) + (1,) * (g.ndim - 1))
    return np.all(g <= GRAD_FLOOR * leaf_max, axis=0)


def _zeros(grads: list[dict], name: str) -> np.ndarray:
    """Where one leaf's gradient is exactly 0, step by step ([steps, ...])."""
    return np.stack([g[name] for g in grads]) == 0


def _floor_split(got, ref_params, ref_grads):
    """The gaps of ``got`` to the reference's final parameters, off the
    gradient floor and on it, and the floor's mask of each leaf."""
    masks = {k: _on_floor([step[k] for step in ref_grads]) for k in sorted(got)}
    gaps = {k: np.abs(got[k].astype(np.float64) - ref_params[-1][k]) for k in masks}
    off = np.concatenate([gaps[k][~m] for k, m in masks.items()])
    on = np.concatenate([gaps[k][m] for k, m in masks.items()])
    return off, on, masks


def _assert_within_jax_bounds(got, ref_params, ref_grads) -> tuple[float, float, int]:
    off, on, _ = _floor_split(got, ref_params, ref_grads)
    reach = _adam_reach()
    assert float(off.max()) <= JAX_PARAM_ABS, off.max()
    assert on.size <= FLOOR_SHARE * (on.size + off.size), on.size
    assert float(on.max(initial=0.0)) <= reach, (on.max(), reach)
    return float(off.max()), float(on.max(initial=0.0)), on.size


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("four_ranks")
    jcluster = jax_synthetic.make_cluster(**CLUSTER)
    start_flax = jax.tree.map(np.asarray, jax_train.init_state(
        jax_train.GNNTrainConfig(**TRAIN), jcluster.graph, rng_seed=0).params)
    start = params_from_flax(start_flax)
    np.savez(out / "start.npz", **{k: v.numpy() for k, v in start.items()})
    tensors = _stage_tensors()
    jax_st.write_safetensors(out / "stage.safetensors", tensors, bf16_names=["bf16"])
    (out / "four_rank_worker.py").write_text(
        _WORKER.format(cluster=repr(CLUSTER), train=repr(TRAIN), steps=STEPS))
    # the ranks first, then the references: the four processes and JAX's
    # thread pools never contend for the host's cores at once
    dist_lib.launch_localhost(4, "four_rank_worker", local_devices=1,
                              extra_env={"PYTHONPATH": str(out), "OUT": str(out)}, timeout=DEADLINE_S)

    rng = np.random.default_rng(0)
    batches = [jax_synthetic.sample_batch(jcluster.pairs, TRAIN["batch_size"], rng) for _ in range(STEPS)]
    cluster = synthetic.make_cluster(**CLUSTER)
    befores = []
    for i in range(STEPS):
        with np.load(out / f"before{i}.npz") as z:
            befores.append({k: z[k] for k in z.files})
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    jax_staged = jax_stage_tensors(out / "stage.safetensors",
                                   shardings=lambda name: NamedSharding(jmesh, P("data", "model")))
    return dict(
        out=out, reports=[json.loads((out / f"report{r}.json").read_text()) for r in range(4)],
        jax_mesh=_jax_run(jcluster, batches, jax_mesh.make_mesh(jax.devices()[:4], model_parallel=2)),
        jax_single=_jax_run(jcluster, batches), port=_port_run(cluster, start_flax, batches),
        port_norms_at_mesh=_port_norms_at(cluster, befores, batches), befores=befores, batches=batches,
        tensors=tensors,
        jax_staged={k: np.asarray(v) for k, v in jax_staged.items()},
    )


def _params(four_ranks, rank=0):
    with np.load(four_ranks["out"] / f"params{rank}.npz") as z:
        return {k: z[k] for k in z.files}


def test_four_ranks_match_jax_shard_for_training(four_ranks):
    jax_losses, jax_params, jax_grads = four_ranks["jax_mesh"]
    losses = np.array(four_ranks["reports"][0]["losses"])
    params = _params(four_ranks)
    assert params.keys() == jax_params[-1].keys()
    loss_gap = float(np.abs(losses - jax_losses).max())
    assert loss_gap <= JAX_LOSS_ABS, loss_gap
    off, on, n_on = _assert_within_jax_bounds(params, jax_params, jax_grads)
    print(f"four ranks vs JAX's shard_for_training: losses {loss_gap:.3g}, parameters {off:.4g} off the "
          f"gradient floor, {on:.4g} on it ({n_on} elements; AdamW's reach {_adam_reach():.4g})")


def test_port_single_device_gap_to_jax_lies_on_the_gradient_floor(four_ranks):
    """On one device, with no mesh, the port and JAX share their gradient
    floor (its elements come from the init draw: tools/torch_gap_probe.py
    counts them over five seeds), and the port's gradient is exactly 0
    wherever JAX's is: its GELU is JAX's op for op. Every parameter, on the
    floor or off it, ends within JAX_ONE_DEVICE_ABS of JAX's. The output
    lists the largest gap of each leaf."""
    jax_losses, jax_params, jax_grads = four_ranks["jax_single"]
    port_losses, _, port_params, port_grads = four_ranks["port"]
    assert float(np.abs(port_losses - jax_losses).max()) <= JAX_LOSS_ABS
    off, on, n_on = _assert_within_jax_bounds(port_params[-1], jax_params, jax_grads)
    _, _, masks = _floor_split(port_params[-1], jax_params, jax_grads)
    print(f"one device, port vs JAX: parameters {off:.4g} off the floor, {on:.4g} on it ({n_on} elements)")
    assert max(off, on) <= JAX_ONE_DEVICE_ABS, (off, on)
    shared = 0
    for name, mask in masks.items():
        port_mask = _on_floor([g[name] for g in port_grads])
        shared += int((mask & port_mask).sum())
        # where JAX's gradient is 0, so is the port's
        assert not np.any(_zeros(jax_grads, name) & ~_zeros(port_grads, name)), name
        gap = np.abs(port_params[-1][name] - jax_params[-1][name])
        print(f"  {name}: largest gap {gap.max():.3g}, {int(mask.sum())} elements on the floor")
    assert shared >= 0.99 * n_on, (shared, n_on)


def test_four_ranks_match_the_single_process_port_step(four_ranks):
    port_losses, _, port_params, _ = four_ranks["port"]
    rep = four_ranks["reports"][0]
    params = _params(four_ranks)
    loss_gap = float(np.abs(np.array(rep["losses"]) - port_losses).max())
    param_gap = max(float(np.abs(params[k] - port_params[-1][k]).max()) for k in params)
    norm_gaps = np.abs(np.array(rep["norms"]) - four_ranks["port_norms_at_mesh"]) / four_ranks["port_norms_at_mesh"]
    print(f"four ranks vs the port's single-process step: losses {loss_gap:.3g}, parameters {param_gap:.3g}, "
          f"pre-clip norms {norm_gaps.max():.3g} relative")
    assert loss_gap <= PORT_LOSS_ABS and param_gap <= PORT_PARAM_ABS, (loss_gap, param_gap)
    assert norm_gaps[0] <= PORT_GNORM0_REL and norm_gaps.max() <= PORT_GNORM_REL, norm_gaps
    # every rank took the same steps and holds the same full parameters
    for r in range(1, 4):
        assert four_ranks["reports"][r]["losses"] == rep["losses"]
        assert all(np.array_equal(v, params[k]) for k, v in _params(four_ranks, r).items())


def test_jax_itself_parts_from_one_device_as_the_loss_falls(four_ranks):
    """The reference's own sharding error, on the parameters the mesh run
    held before each step: JAX's gradient norm on its (2, 2) mesh against
    its one device. It meets 1e-4 at step 0 and may leave it as the loss
    falls (JAX_GNORM_REL); the port's mesh now stays within PORT_GNORM_REL."""
    jmesh = jax_mesh.make_mesh(jax.devices()[:4], model_parallel=2)
    cfg = jax_train.GNNTrainConfig(**TRAIN)
    graph = jax_synthetic.make_cluster(**CLUSTER).graph
    state = jax_train.init_state(cfg, graph, rng_seed=0)
    sharded, sg, _ = jax_train.shard_for_training(state, graph, jmesh)
    g = JaxTopoGraph(*map(jnp.asarray, graph))
    grad = jax.grad(functools.partial(jax_train.loss_fn, state.apply_fn))
    norm = jax.jit(lambda p, gg, b: optax.global_norm(grad(p, gg, b)))
    gaps = []
    for before, b in zip(four_ranks["befores"], four_ranks["batches"]):
        tree = jax.tree.map(jnp.asarray, params_to_flax({k: torch.from_numpy(v) for k, v in before.items()}))
        jb = jax_synthetic.PairBatch(*(jnp.asarray(a) for a in b))
        one = float(norm(tree, g, jb))
        placed = jax.device_put(tree, jax.tree.map(lambda x: x.sharding, sharded.params))
        on_mesh = float(norm(placed, sg, jax.device_put(jb, jax_mesh.batch_sharding(jmesh))))
        gaps.append(abs(on_mesh - one) / one)
    print("JAX (2, 2) vs one device, pre-clip norm on the mesh run's parameters:", [f"{v:.2g}" for v in gaps])
    assert gaps[0] <= PORT_GNORM0_REL and max(gaps) <= JAX_GNORM_REL, gaps


def test_each_rank_holds_only_its_data_rows(four_ranks):
    for r, rep in enumerate(four_ranks["reports"]):
        assert rep["coordinate"] == [r // 2, r % 2]
        assert rep["rows"] == [64 * (r // 2), 64 * (r // 2 + 1)]  # by data coordinate, not rank
        assert rep["graph_rows"] == [[32, 64]] * 4  # node_feats, neighbors, mask, edge_feats
        assert rep["batch_rows"] == [[64, 128]] * (STEPS // 2)


def test_gradients_come_back_partial_and_moments_are_dtensors(four_ranks):
    """The traps the optimizer handles: autograd leaves gradients in other
    layouts than their parameters' (a sum over "data" still to do), and
    torch refuses a ``_foreach`` list that mixes DTensors and tensors."""
    rep = four_ranks["reports"][0]
    raw, placed = rep["raw_grad_placements"], rep["param_placements"]
    assert raw.keys() == placed.keys()
    assert all(p[0] == "Replicate()" for p in placed.values())
    assert any(p[1].startswith("Shard(dim=0)") for p in placed.values())
    assert any(g[0] == "Partial(sum)" for g in raw.values())  # a sum over "data" still to do
    assert any(raw[n] != placed[n] for n in raw)
    assert rep["all_dtensor"] and rep["moments_placed_as_params"]
    assert rep["mixed_foreach"] != "accepted" and "DTensor" in rep["mixed_foreach"]


def test_sharded_staging_is_bit_equal_per_rank(four_ranks):
    tensors = four_ranks["tensors"]
    for r, rep in enumerate(four_ranks["reports"]):
        with np.load(four_ranks["out"] / f"staged{r}.npz") as z:
            for name, want in tensors.items():
                (a, b), (c, d) = rep[f"slice_{name}"]
                assert (a, b, c, d) == (16 * (r // 2), 16 * (r // 2 + 1), 8 * (r % 2), 8 * (r % 2 + 1))
                local, full = z[f"local_{name}"], z[f"full_{name}"]
                assert local.tobytes() == np.ascontiguousarray(want[a:b, c:d]).tobytes()
                assert full.tobytes() == want.tobytes()
                jax_full = four_ranks["jax_staged"][name]
                assert full.tobytes() == (jax_full.view(np.uint16) if name == "bf16" else jax_full).tobytes()


def test_artifact_of_a_mesh_run_loads_back_its_full_parameters(four_ranks):
    params = _params(four_ranks)
    digests = set()
    for r in range(4):
        model, sd = artifacts.load_gnn(four_ranks["out"] / f"art{r}")
        assert sd.keys() == params.keys()
        assert all(np.array_equal(sd[k].numpy(), params[k]) for k in params)
        digests.add(artifacts.artifact_digest(four_ranks["out"] / f"art{r}"))
    assert len(digests) == 1  # every rank publishes the same bytes


def test_train_async_on_the_mesh_matches_one_device(four_ranks):
    """The device-resident multi-step on the mesh draws the same global
    indices on every rank and keeps its data rows: the losses follow the
    single-device run of the same seed."""
    cluster = synthetic.make_cluster(**CLUSTER)
    _, want = asyncio.run(train_gnn.train_async(train_gnn.GNNTrainConfig(**TRAIN), cluster.graph, cluster.pairs,
                                                steps=4, steps_per_call=2, device="cpu", seed=0))
    for rep in four_ranks["reports"]:
        got = rep["async_losses"]
        assert len(got) == 4 and float(np.abs(np.array(got) - np.array(want)).max()) <= PORT_LOSS_ABS, (got, want)
        padded = rep["padded_losses"]
        assert len(padded) == 2 and np.all(np.isfinite(padded))


def test_no_process_group_is_left_in_the_pytest_process():
    import torch.distributed as dist

    assert not dist.is_initialized()
    assert os.environ.get("DF_DIST_NUM_PROCESSES") is None

