"""GNN training on one device or a mesh, in PyTorch (north-star configs 2-3).

The port of dragonfly2_tpu/trainer/train_gnn.py. One train step is the MSE
of ``TopoScorer`` against observed bandwidth, a global-norm clip in optax's
form and AdamW on a warm-up + cosine schedule, as the JAX package's optax
chain (``train_gnn.py:61-69``) defines it. Parameters, gradients and
optimizer state are float32; the model computes in bfloat16.

Every entry point runs on one ``device=`` (the card unless the caller names
another) or, as in the JAX package, sharded over a ("data", "model") mesh
(``mesh=``, parallel/mesh.py): parameters and Adam's moments become DTensors
placed by ``param_leaf_placements``, graph node rows and batch rows are
row-sharded over "data", and DTensor inserts the collectives that XLA
inserts from the JAX package's sharding annotations.
"""

from __future__ import annotations

import asyncio
import functools
import math
import time
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
import torch.utils.checkpoint
from torch import nn
from torch.distributed.tensor import DTensor, distribute_tensor

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.models.graphsage import TopoGraph, TopoScorer
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax
from dragonfly2_tpu_torch.observability.tracing import stage
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
from dragonfly2_tpu_torch.parallel import mesh as meshlib
from dragonfly2_tpu_torch.trainer.synthetic import PairBatch, sample_batch


@dataclass
class GNNTrainConfig:
    hidden: int = 256
    embed_dim: int = 128
    num_layers: int = 3
    batch_size: int = 4096
    learning_rate: float = 3e-3
    weight_decay: float = 1e-4
    warmup_steps: int = 100
    remat: bool = False


def make_model(cfg: GNNTrainConfig) -> TopoScorer:
    return TopoScorer(hidden=cfg.hidden, embed_dim=cfg.embed_dim, num_layers=cfg.num_layers)


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1): a linear ramp from
    init to peak over ``warmup_steps``, then a cosine from peak to end that
    ends at ``decay_steps`` counting the warm-up. With ``warmup_steps=0`` the
    ramp is skipped and step 0 already gives the peak, as optax's
    ``join_schedules`` does."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * cosine + alpha)

    return schedule


DECAY_STEPS = 20_000  # the trainer's schedule ends its cosine here (``make_optimizer``)


@functools.cache
def _bias_corrections(b: float) -> tuple[float, ...]:
    """``ClippedAdamW._bias_correction(b, count)`` for count 0, 1, ... up to
    the first that rounds to 1 in float32, after which every one does
    (``b**t`` only falls). One scalar op a count, as the host computed
    them a step at a time: torch's vectorised pow rounds a few counts
    differently."""
    out = [ClippedAdamW._bias_correction(b, 0)]
    while out[-1] != 1.0:
        out.append(ClippedAdamW._bias_correction(b, len(out)))
    return tuple(out)


def _step_table(schedule: Callable[[int], float], settles_at: int, b1: float, b2: float) -> torch.Tensor:
    """``[L, 3]`` float32 on the host: row ``count`` holds ``schedule(count)``
    and the bias corrections of b1 and b2 at ``count``, for every count up
    to where all three stop changing (``settles_at`` for the schedule); a
    later count reads the last row."""
    c1, c2 = _bias_corrections(b1), _bias_corrections(b2)
    n = max(settles_at + 1, len(c1), len(c2))
    return torch.tensor([(schedule(i), c1[min(i, len(c1) - 1)], c2[min(i, len(c2) - 1)]) for i in range(n)],
                        dtype=torch.float32)


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay))``
    over torch parameters, written out with ``torch._foreach_*`` ops.

    The clip is optax's: the gradients are divided by ``‖g‖/max_norm`` only
    when ``‖g‖ >= max_norm`` (1.0) (``clip_grad_norm_`` would add 1e-6 to the norm
    and scale every step). AdamW (b1 0.9, b2 0.999, eps 1e-8) decays every
    parameter, biases and LayerNorm scales included, as optax's ``adamw``
    does with no mask. The learning rate is the schedule at the step count
    before the update, so with a warm-up the first step runs at lr 0. With
    ``max_norm=None``, ``weight_decay=0`` and a constant schedule it is
    ``optax.adam`` (the MLP trainer's optimizer): no clip, and a decay term
    of ``0·p`` that leaves every finite update as it is.

    It is written out rather than taken from ``torch.optim.AdamW`` for one
    number: optax computes Adam's bias corrections ``1 - b**t`` in float32,
    and ``1 - 0.999`` in float32 is 1.3e-5 away from 0.001, which moves the
    first steps' updates by 6e-6 against torch's float64 corrections. Here
    they are float32 too. Nothing reads a device value on the host.

    The learning rate and both corrections are device values, read from
    ``table`` (``_step_table``: a row a step count, worked out once on the
    host with the arithmetic above) at the step's count, so that an update
    captured in a CUDA graph takes each replay's count from device memory
    and an eager update runs the same ops on the same numbers.
    ``settles_at`` is the count from which ``schedule`` no longer changes.

    On a mesh the parameters are DTensors and ``mu``/``nu`` are DTensors of
    the same placements (``zeros_like``), as JAX gives every optimizer leaf
    its parameter's sharding. A gradient comes back from autograd in
    whatever layout the backward left (a weight placed ``(Replicate(),
    Shard(0))`` comes back ``(Partial(sum), Shard(0))``), so each is first
    redistributed to its parameter's placements: the sum over "data" happens
    there. Everything after is elementwise on identically placed tensors,
    so the update runs on the local shards, whose ``_foreach`` lists then
    hold plain tensors only (torch refuses a list that mixes DTensors and
    plain tensors). The global norm is the norm of the full gradients: a
    leaf sharded over "model" sums its shards' squares over that axis, so it
    counts once, not tp times.
    """

    b1, b2, eps = 0.9, 0.999, 1e-8  # optax's adam and adamw defaults

    def __init__(self, params, schedule: Callable[[int], float], *, weight_decay: float,
                 max_norm: float | None = 1.0, settles_at: int):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.max_norm = max_norm
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]
        self.table = _step_table(schedule, settles_at, self.b1, self.b2).to(
            self.params[0].device if self.params else "cpu")

    @staticmethod
    def _bias_correction(b: float, count: int) -> float:
        """``1 - b**(count + 1)`` in float32, as optax's ``bias_correction``."""
        return float(1 - torch.tensor(b, dtype=torch.float32) ** torch.tensor(count + 1, dtype=torch.float32))

    def at(self, count: int | torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The learning rate and the two bias corrections at ``count`` as f32
        scalars on the table's device: a view of ``table``'s row for an int,
        a gather for a device integer scalar (what a captured step reads, so
        that each replay takes the count from device memory). Counts past
        the table's end read its last row."""
        last = self.table.shape[0] - 1
        if isinstance(count, torch.Tensor):
            row = self.table.index_select(0, count.reshape(1).clamp(max=last))[0]
        else:
            row = self.table[min(count, last)]
        return row.unbind(0)

    @torch.no_grad()
    def step(self, count: int | torch.Tensor) -> torch.Tensor:
        """Clip the parameters' ``.grad`` and take one AdamW step at
        ``schedule(count)``. ``count`` is the number of steps taken before:
        an int, or an integer scalar on the parameters' device (``at``).
        Returns the pre-clip global gradient norm (``optax.global_norm``), a
        float32 scalar on the parameters' device (this rank's, on a mesh)."""
        params, mu, nu = self.params, self.mu, self.nu
        grads = [p.grad for p in params]
        if isinstance(params[0], DTensor):
            grads = [g.redistribute(p.device_mesh, p.placements).to_local() for g, p in zip(grads, params)]
            gnorm = self._sharded_global_norm(grads)
            params, mu, nu = ([t.to_local() for t in ts] for ts in (params, mu, nu))
        else:
            gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if self.max_norm is not None:
            # 1 below the threshold, ‖g‖/max_norm at or above it: optax's select
            denom = torch.clamp(gnorm / self.max_norm, min=1.0)
            grads = [g / denom for g in grads]
        lr, c1, c2 = self.at(count)
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        mu_hat = torch._foreach_div(mu, c1)
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(update, params, alpha=self.weight_decay)
        torch._foreach_mul_(update, lr)
        torch._foreach_sub_(params, update)
        return gnorm

    def _sharded_global_norm(self, local_grads: list[torch.Tensor]) -> torch.Tensor:
        """‖g‖ over the full gradients from the local shards: the squares of
        the leaves sharded over the same mesh dims are summed and all-reduced
        over those dims, once per group of leaves."""
        import torch.distributed as dist

        mesh = self.params[0].device_mesh
        groups: dict[tuple[int, ...], list[torch.Tensor]] = {}
        for g, p in zip(local_grads, self.params):
            dims = tuple(i for i, pl in enumerate(p.placements) if pl.is_shard())
            groups.setdefault(dims, []).append(torch.linalg.vector_norm(g) ** 2)
        total = []
        for dims, squares in groups.items():
            s = torch.stack(squares).sum()
            for i in dims:
                dist.all_reduce(s, group=mesh.get_group(i))
            total.append(s)
        return torch.sqrt(torch.stack(total).sum())

    def distribute(self, params: list[nn.Parameter]) -> None:
        """Move onto a mesh: ``params`` (DTensor parameters, in this
        optimizer's order) replace the plain ones, and each moment becomes a
        DTensor of its parameter's mesh and placements."""
        self.mu = [distribute_tensor(m, q.device_mesh, q.placements) for m, q in zip(self.mu, params)]
        self.nu = [distribute_tensor(v, q.device_mesh, q.placements) for v, q in zip(self.nu, params)]
        self.params = params

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(cfg: GNNTrainConfig, params) -> ClippedAdamW:
    """The optax chain of ``init_state`` (``train_gnn.py:61-69``) over ``params``."""
    schedule = warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps, DECAY_STEPS, cfg.learning_rate * 0.05
    )
    return ClippedAdamW(params, schedule, weight_decay=cfg.weight_decay, settles_at=DECAY_STEPS)


@dataclass
class TrainState:
    """The counterpart of flax's ``TrainState``: the step count, the model
    (holding the f32 parameters) and its optimizer. Steps update all three in
    place. ``mesh`` is the ``DeviceMesh`` the parameters are placed on
    (``shard_for_training``), or None on one device."""

    step: int
    model: TopoScorer
    optimizer: ClippedAdamW
    mesh: Any = None


def init_state(
    cfg: GNNTrainConfig, graph: TopoGraph | None = None, rng_seed: int = 0, *,
    params: dict | None = None, device: str | torch.device | None = None,
) -> TrainState:
    """A fresh TrainState on ``device`` (the card unless one is named).

    ``params`` is a flax parameter tree (``{"params": ...}`` with numpy
    leaves) to start from; without it the start is ``init_flax_like`` drawn
    from ``rng_seed``, flax's init distribution but not its numbers. The
    graph is not needed to size the model (the JAX package traces its init
    on it); the argument stays for the same call shape.
    """
    del graph
    dev = resolve_device(device)
    model = make_model(cfg)
    tree = params if params is not None else init_flax_like(model, seed=rng_seed)
    model.load_state_dict(params_from_flax(tree))
    model.to(dev).train()
    return TrainState(step=0, model=model, optimizer=make_optimizer(cfg, model.parameters()))


def loss_fn(model: Callable, g: TopoGraph, batch: PairBatch) -> torch.Tensor:
    pred = model(g, batch.child, batch.parent, batch.feats)
    return torch.mean((pred - batch.label) ** 2)


def _device_of(state: TrainState) -> torch.device:
    return next(state.model.parameters()).device


def _check_pairs(pairs: PairBatch, n: int) -> None:
    """Node ids are checked on the host: on the card an out-of-range id would
    fire a device-side assert and take the CUDA context down with it."""
    for name, idx in (("child", np.asarray(pairs.child)), ("parent", np.asarray(pairs.parent))):
        if idx.size and (idx.min() < 0 or idx.max() >= n):
            raise ValueError(f"{name} node index out of range for {n}-node graph")


def _as_batch(child, parent, feats, label) -> PairBatch:
    return PairBatch(child.long(), parent.long(), feats.float(), label.float())


def _place_batch(batch: PairBatch, g: TopoGraph, state: TrainState) -> PairBatch:
    """A batch as tensors on the state's device, or on a mesh as DTensors
    whose rows lie over "data" (this rank keeps the rows of its data
    coordinate). Host batches are bounds-checked first; tensors are taken as
    checked (make_multi_step samples them from a checked pool)."""
    if isinstance(batch.child, DTensor):
        return _as_batch(*batch)
    if not isinstance(batch.child, torch.Tensor):
        _check_pairs(batch, g.node_feats.shape[0])
    if state.mesh is None:
        return _as_batch(*(torch.as_tensor(a).to(_device_of(state)) for a in batch))
    lo, hi = dist_lib.local_row_slice(len(batch.child), state.mesh)
    return _as_batch(*(_rows_to_mesh(torch.as_tensor(a)[lo:hi], len(a), state.mesh) for a in batch))


def _rows_to_mesh(local: torch.Tensor, global_rows: int, mesh) -> DTensor:
    """This rank's rows of a ``[global_rows, ...]`` tensor as the global
    DTensor, rows over "data"."""
    return dist_lib.process_local_batch(mesh, local, (global_rows, *local.shape[1:]))


def make_train_step(remat: bool = False, *, with_metrics: bool = False) -> Callable:
    """One optimizer step: ``step(state, g, batch) -> (state, loss)``.

    With ``remat`` the model call runs under ``torch.utils.checkpoint``, so
    the backward recomputes the GNN forward instead of holding its [N, K, H]
    activations (``jax.checkpoint`` in the JAX package). ``with_metrics``
    widens the return to ``(state, (loss, grad_norm))`` with the pre-clip
    global gradient norm. ``g`` lies on the state's device (on a mesh: as
    ``shard_for_training`` placed it); ``batch`` is a PairBatch of numpy
    arrays or of tensors (on a mesh: the global batch, or DTensors placed
    already). The loss and norm are device scalars (this rank's, on a
    mesh): nothing waits for the device. ``step(..., count=c)`` hands the
    optimizer ``c`` in place of ``state.step`` (``ClippedAdamW.at``: a
    device scalar, where a captured call replays the step).
    """

    def step(state: TrainState, g: TopoGraph, batch: PairBatch, *, count: torch.Tensor | None = None):
        batch = _place_batch(batch, g, state)
        model = state.model
        if remat:
            def apply(gg, c, p, f):
                return torch.utils.checkpoint.checkpoint(model, gg, c, p, f, use_reentrant=False)
        else:
            apply = model
        state.optimizer.zero_grad()
        with stage("gnn.train.forward"):
            loss = loss_fn(apply, g, batch)
            if state.mesh is not None:  # the mean over "data" rows comes back a partial sum
                loss = loss.redistribute(state.mesh, meshlib.replicated(state.mesh))
        with stage("gnn.train.backward"):
            loss.backward()
        with stage("gnn.train.optimizer"):
            gnorm = state.optimizer.step(state.step if count is None else count)
        state.step += 1
        loss = loss.detach()
        if state.mesh is not None:
            loss = loss.to_local()
        return (state, (loss, gnorm)) if with_metrics else (state, loss)

    return step


# the default (no-remat) step keeps its name, as in the JAX package
train_step = make_train_step(remat=False)


def pad_graph(g: TopoGraph, n_padded: int) -> TopoGraph:
    """Pad node dim to n_padded with masked isolated nodes (static shapes)."""
    n = g.node_feats.shape[0]
    if n_padded == n:
        return g
    pad = n_padded - n
    return TopoGraph(
        np.concatenate([g.node_feats, np.zeros((pad, g.node_feats.shape[1]), np.float32)]),
        np.concatenate([g.neighbors, np.zeros((pad, g.neighbors.shape[1]), np.int32)]),
        np.concatenate([g.mask, np.zeros((pad, g.mask.shape[1]), np.float32)]),
        np.concatenate(
            [g.edge_feats, np.zeros((pad,) + g.edge_feats.shape[1:], np.float32)]
        ),
    )


def _host_graph(g: TopoGraph) -> TopoGraph:
    return TopoGraph(*(a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a) for a in g))


def _place_sharded(state: TrainState, graph: TopoGraph, mesh) -> tuple[TrainState, TopoGraph]:
    """Shared placement, the counterpart of the JAX ``_place_sharded``: every
    parameter becomes a DTensor parameter of ``param_leaf_placements``
    (broadcast from rank 0), Adam's moments follow their parameters, and the
    graph, its node rows padded to a multiple of dp, is row-sharded over
    "data": this rank holds only the rows of its data coordinate. The model
    must lie on the mesh's device already (``init_state(device=...)``)."""
    if state.mesh is not None:
        raise ValueError("the state is placed on a mesh already")
    placed: dict[int, nn.Parameter] = {}
    for name, pl in meshlib.infer_param_placements(state.model, mesh).items():
        owner, _, leaf = name.rpartition(".")
        mod = state.model.get_submodule(owner)
        p = getattr(mod, leaf)
        placed[id(p)] = q = nn.Parameter(distribute_tensor(p.detach(), mesh, pl), requires_grad=p.requires_grad)
        mod.register_parameter(leaf, q)
    state.optimizer.distribute([placed[id(p)] for p in state.optimizer.params])
    state.mesh = mesh
    return state, _place_graph(graph, state)


def _place_graph(graph: TopoGraph, state: TrainState) -> TopoGraph:
    """The graph on the state's device, or row-sharded over its mesh's
    "data" axis (padded to a multiple of dp first); a graph placed already
    is returned as it is."""
    if state.mesh is None:
        return graph.to(_device_of(state))
    if isinstance(graph.node_feats, DTensor):
        return graph
    dp, _ = meshlib.axis_sizes(state.mesh)
    host = _host_graph(graph)
    host = pad_graph(host, meshlib.pad_to_multiple(host.node_feats.shape[0], dp))
    lo, hi = dist_lib.local_row_slice(host.node_feats.shape[0], state.mesh)
    return TopoGraph(*(dist_lib.process_local_batch(state.mesh, a[lo:hi], a.shape) for a in host))


def shard_for_training(
    state: TrainState, graph: TopoGraph, mesh, *, remat: bool = False
) -> tuple[TrainState, TopoGraph, Callable]:
    """Place state and graph per the mesh rules and return the step: node
    rows over "data" (N padded to dp), weights over "model", batch rows over
    "data". The step takes a PairBatch of the global batch (host arrays, of
    which each rank keeps its data rows) or of DTensors placed already."""
    state, g = _place_sharded(state, graph, mesh)
    return state, g, make_train_step(remat)


def shard_for_training_scan(
    state: TrainState,
    graph: TopoGraph,
    pairs: PairBatch,
    mesh,
    *,
    batch_size: int = 4096,
    steps_per_call: int = 10,
    remat: bool = False,
    with_metrics: bool = False,
    seed: int = 0,
) -> tuple[TrainState, TopoGraph, Callable]:
    """Device-resident training on a mesh: ``_place_sharded``, then
    ``make_multi_step`` with the batch rounded up to a multiple of dp.
    Returns (state, g, multi_step)."""
    dp, _ = meshlib.axis_sizes(mesh)
    state, g = _place_sharded(state, graph, mesh)
    multi = make_multi_step(
        state, g, pairs, batch_size=meshlib.pad_to_multiple(batch_size, dp),
        steps_per_call=steps_per_call, remat=remat, with_metrics=with_metrics, seed=seed,
    )
    return state, g, multi


def make_multi_step(
    state: TrainState,
    graph: TopoGraph,
    pool: PairBatch,
    *,
    batch_size: int,
    steps_per_call: int,
    remat: bool = False,
    with_metrics: bool = False,
    seed: int = 0,
) -> Callable:
    """Device-resident training, the counterpart of ``make_scan_step``.

    The graph and the pair pool are copied to the state's device once (the
    pool's node ids checked on the host first). Each call
    ``multi_step(state) -> (state, losses)`` runs ``steps_per_call`` steps,
    drawing each batch's pool rows with a ``torch.Generator`` on the device
    seeded from ``seed``; ``losses`` is a ``[steps_per_call]`` f32 tensor on
    the device, and with ``with_metrics`` the second value is ``(losses,
    grad_norms)``, each call's its own. Nothing returns to the host between
    steps; the caller pulls a call's values once. The generator's numbers
    differ from ``jax.random``'s: the distribution of batches is the same,
    the batches are not.

    On one CUDA device (plain tensors, no mesh) the call is a
    CUDA graph (``_GraphedCall``): the first call runs eagerly, the second
    captures the whole call (sampling, forward, backward, clip, AdamW and
    the writes of its losses and norms) and replays it, every later call
    replays it. A replay draws the rows the eager steps would draw, in the
    same order, and computes what they would compute; it frees the host
    from the step's ~1000 launches, so the card sets the pace. The
    multi-step then serves only the state it was made with.

    On a mesh (a state from ``_place_sharded``) the graph is row-sharded
    and the pool replicated: every rank seeds its generator alike, draws the
    same global indices and keeps the rows of its data coordinate, as
    ``make_scan_step`` constrains the sampled rows onto "data".
    """
    dev = _device_of(state)
    _check_pairs(pool, graph.node_feats.shape[0])
    g = _place_graph(graph, state)
    pool_t = _as_batch(*(torch.as_tensor(a).to(dev) for a in pool))
    n_pool = pool_t.child.shape[0]
    step = make_train_step(remat, with_metrics=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    lo, hi = (0, batch_size) if state.mesh is None else dist_lib.local_row_slice(batch_size, state.mesh)

    def steps(st: TrainState, out: torch.Tensor, counts: torch.Tensor | None = None) -> TrainState:
        """The call's steps, their losses and norms written to ``out`` [2,
        steps_per_call]; ``counts`` the optimizer's counts on the device
        (a captured call), else ``st.step`` on the host."""
        for i in range(steps_per_call):
            with stage("gnn.train.sample"):
                idx = torch.randint(0, n_pool, (batch_size,), generator=gen, device=dev)
                if st.mesh is None:
                    batch = PairBatch(*(a.index_select(0, idx) for a in pool_t))
                else:
                    batch = PairBatch(*(_rows_to_mesh(a.index_select(0, idx[lo:hi]), batch_size, st.mesh)
                                        for a in pool_t))
            st, (loss, gnorm) = step(st, g, batch, count=None if counts is None else counts[i])
            out[0, i] = loss
            out[1, i] = gnorm
        return st

    if _graphs(state):
        call = _GraphedCall(state, steps, gen, steps_per_call)
    else:
        def call(st: TrainState) -> tuple[TrainState, torch.Tensor]:
            out = torch.empty(2, steps_per_call, dtype=torch.float32, device=dev)
            return steps(st, out), out

    def multi_step(st: TrainState):
        st, out = call(st)
        losses, norms = out.unbind(0)
        return (st, (losses, norms)) if with_metrics else (st, losses)

    return multi_step


def _graphs(state: TrainState) -> bool:
    """Whether ``make_multi_step`` captures its call: the parameters are
    plain tensors on one CUDA device (no mesh, no DTensor). A ``remat`` step
    captures too: ``torch.utils.checkpoint``'s recompute runs inside the
    captured backward."""
    p = next(state.model.parameters())
    return p.is_cuda and state.mesh is None and not isinstance(p, DTensor)


class _GraphedCall:
    """One device's multi-step call as a CUDA graph: ``call(st) -> (st,
    out)``, ``out`` a fresh [2, steps_per_call] f32 tensor of the call's
    losses and norms.

    The first call runs ``steps`` eagerly: the warm-up that lets every lazy
    set-up (cuBLAS handles, K4's occupancy query, the allocator's blocks)
    happen outside a capture. The second captures ``steps`` once, with the
    optimizer's counts read from a device scalar (``base`` + i) and the
    batch generator registered with the graph, so that each replay reads
    the count ``base`` holds and advances the generator's offset by what
    the call's draws take, as the eager calls do; then it replays. Every
    later call writes ``st.step`` to ``base`` and replays. The step leaves
    nothing to set up per call: the graph's private memory pool gives every
    buffer of the step (the gradients included) a fixed address, and
    nothing reads a device value on the host. ``st.step`` advances by
    ``steps_per_call`` a call, as on the eager path. The replay, with the
    count's write before it and the copy of its output after it, runs
    under the stage ``gnn.train.replay``: the step's own stages open only
    while it is captured.
    """

    def __init__(self, state: TrainState, steps: Callable, gen: torch.Generator, steps_per_call: int):
        self.state, self.steps, self.gen, self.n = state, steps, gen, steps_per_call
        self.dev = _device_of(state)
        self.calls = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.base = torch.zeros((), dtype=torch.int64, device=self.dev)
        self.out = torch.zeros(2, steps_per_call, dtype=torch.float32, device=self.dev)

    def __call__(self, st: TrainState) -> tuple[TrainState, torch.Tensor]:
        if st is not self.state:
            raise ValueError("a captured multi-step replays the state it was made with, not another")
        self.calls += 1
        if self.calls == 1:
            out = torch.empty_like(self.out)
            return self.steps(st, out), out
        start = st.step
        if self.graph is None:
            self._capture(st)
        else:
            st.step += self.n
        with stage("gnn.train.replay"):
            self.base.fill_(start)
            self.graph.replay()
            out = self.out.clone()
        return st, out

    def _capture(self, st: TrainState) -> None:
        """Record the call's steps into ``self.graph`` (nothing runs on the
        card; ``st.step`` advances on the host as the steps are recorded)."""
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.gen)
        # on the state's card and a stream of its own; "thread_local": what
        # other threads of the process give the card meanwhile is not refused
        with torch.cuda.device(self.dev), torch.cuda.graph(graph, stream=torch.cuda.Stream(self.dev),
                                                           capture_error_mode="thread_local"):
            counts = self.base + torch.arange(self.n, device=self.dev)
            self.steps(st, self.out, counts)
        self.graph = graph


def _train_device(device, mesh) -> torch.device | str | None:
    """The device a training entry point initializes on: ``device``, or this rank's device
    of ``mesh``; both at once is an error."""
    if mesh is None:
        return device
    if device is not None:
        raise ValueError("pass device= or mesh=, not both")
    return meshlib.mesh_device(mesh)


async def train_async(
    cfg: GNNTrainConfig,
    graph: TopoGraph,
    pairs: PairBatch,
    *,
    steps: int,
    device: str | torch.device | None = None,
    seed: int = 0,
    steps_per_call: int = 10,
    log_every: int = 100,
    log: Callable[[str], None] = lambda s: None,
    telemetry=None,
    mesh=None,
) -> tuple[TrainState, list[float]]:
    """Cooperative training driver for asyncio hosts (the trainer service).

    Setup (init + placement) and each ``steps_per_call``-step call of
    ``make_multi_step`` run in a worker thread (``asyncio.to_thread``), so
    the event loop answers other coroutines between calls. Each call ends
    with one device-to-host pull of its losses and gradient norms. Returns
    (state, per-step losses), steps rounded up to whole calls.

    telemetry: any object with ``on_step(loss, grad_norm, examples=...)``
    (the trainer service's ``TrainRunTelemetry``); it is fed once per step
    after each call's pull, at no extra device sync.

    ``device`` (one device) and ``mesh`` (a ``DeviceMesh``, on which every
    rank of the group calls this alike) are exclusive. On a mesh the state
    goes through ``shard_for_training_scan``, the batch is rounded up to a
    multiple of dp, and the returned state's parameters are DTensors.
    """
    dev = _train_device(device, mesh)
    steps_per_call = max(1, min(steps_per_call, steps))
    calls = -(-steps // steps_per_call)
    batch_size = cfg.batch_size if mesh is None else meshlib.pad_to_multiple(cfg.batch_size, meshlib.axis_sizes(mesh)[0])

    def _setup():
        state = init_state(cfg, graph, seed, device=dev)
        if mesh is not None:
            state, _, multi = shard_for_training_scan(
                state, graph, pairs, mesh, batch_size=batch_size, steps_per_call=steps_per_call,
                remat=cfg.remat, with_metrics=True, seed=seed,
            )
            return state, multi
        multi = make_multi_step(
            state, graph, pairs, batch_size=batch_size, steps_per_call=steps_per_call,
            remat=cfg.remat, with_metrics=True, seed=seed,
        )
        return state, multi

    state, multi_step = await asyncio.to_thread(_setup)

    def _one_call(st):
        st, (ls, gn) = multi_step(st)
        pulled = torch.stack([ls, gn]).cpu().numpy()  # the call's one device-to-host pull
        return st, pulled[0], pulled[1]

    losses: list[float] = []
    t0 = time.perf_counter()
    for i in range(calls):
        state, ls, gn = await asyncio.to_thread(_one_call, state)
        if telemetry is not None:
            for lv, gv in zip(ls, gn):
                telemetry.on_step(float(lv), float(gv), examples=batch_size)
        losses.extend(float(x) for x in ls)
        done = len(losses)
        if done % log_every < steps_per_call or i == calls - 1:
            log(
                f"step {done}/{calls * steps_per_call} loss={losses[-1]:.5f} "
                f"({done / (time.perf_counter() - t0):.2f} steps/s)"
            )
    return state, losses


def train(
    cfg: GNNTrainConfig,
    graph: TopoGraph,
    pairs: PairBatch,
    *,
    steps: int,
    device: str | torch.device | None = None,
    seed: int = 0,
    log_every: int = 100,
    log: Callable[[str], None] = lambda s: None,
    mesh=None,
) -> tuple[TrainState, list[float]]:
    """Full training driver; returns final state + loss history.

    Batches are drawn on the host with ``sample_batch`` and
    ``np.random.default_rng(seed)``, as the JAX driver draws them, so both
    see the same batches; the loss is read back only when it is logged.
    ``device`` and ``mesh`` are exclusive, as in ``train_async``: on a mesh
    every rank draws the same global batch, rounded up to a multiple of dp,
    and keeps the rows of its data coordinate.
    """
    state = init_state(cfg, graph, seed, device=_train_device(device, mesh))
    dev = _device_of(state)
    batch_size = cfg.batch_size
    if mesh is None:
        g = graph.to(dev)
        step_fn = make_train_step(cfg.remat)
    else:
        state, g, step_fn = shard_for_training(state, graph, mesh, remat=cfg.remat)
        batch_size = meshlib.pad_to_multiple(batch_size, meshlib.axis_sizes(mesh)[0])
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = sample_batch(pairs, batch_size, rng)
        state, loss = step_fn(state, g, batch)
        if (i + 1) % log_every == 0 or i == 0:
            lv = float(loss)
            losses.append(lv)
            log(f"step {i + 1}/{steps} loss={lv:.5f} ({(i + 1) / (time.perf_counter() - t0):.2f} steps/s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, losses
