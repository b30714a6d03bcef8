"""GNN training on one device, in PyTorch (north-star configs 2-3).

The port of dragonfly2_tpu/trainer/train_gnn.py. One train step is the MSE
of ``TopoScorer`` against observed bandwidth, a global-norm clip in optax's
form and AdamW on a warm-up + cosine schedule, as the JAX package's optax
chain (``train_gnn.py:61-69``) defines it. Parameters, gradients and
optimizer state are float32; the model computes in bfloat16.

The JAX package shards the step over a ("data", "model") mesh. Here every
entry point takes ``device=`` instead (the card unless the caller names
another); the mesh and the ``parallel/`` rules are still to come.
"""

from __future__ import annotations

import asyncio
import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.utils.checkpoint

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.models.graphsage import TopoGraph, TopoScorer
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax
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


class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(1.0), adamw(schedule, weight_decay))``
    over torch parameters, written out with ``torch._foreach_*`` ops.

    The clip is optax's: the gradients are divided by ``‖g‖/max_norm`` only
    when ``‖g‖ >= max_norm`` (1.0) (``clip_grad_norm_`` would add 1e-6 to the norm
    and scale every step). AdamW (b1 0.9, b2 0.999, eps 1e-8) decays every
    parameter, biases and LayerNorm scales included, as optax's ``adamw``
    does with no mask. The learning rate is the schedule at the step count
    before the update, so with a warm-up the first step runs at lr 0.

    It is written out rather than taken from ``torch.optim.AdamW`` for one
    number: optax computes Adam's bias corrections ``1 - b**t`` in float32,
    and ``1 - 0.999`` in float32 is 1.3e-5 away from 0.001, which moves the
    first steps' updates by 6e-6 against torch's float64 corrections. Here
    they are float32 too. Nothing reads a device value on the host.
    """

    max_norm, b1, b2, eps = 1.0, 0.9, 0.999, 1e-8  # init_state's optax chain

    def __init__(self, params, schedule: Callable[[int], float], *, weight_decay: float):
        self.params = [p for p in params if p.requires_grad]
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    @staticmethod
    def _bias_correction(b: float, count: int) -> float:
        """``1 - b**(count + 1)`` in float32, as optax's ``bias_correction``."""
        return float(1 - torch.tensor(b, dtype=torch.float32) ** torch.tensor(count + 1, dtype=torch.float32))

    @torch.no_grad()
    def step(self, count: int) -> torch.Tensor:
        """Clip the parameters' ``.grad`` and take one AdamW step at
        ``schedule(count)``. Returns the pre-clip global gradient norm, a
        float32 scalar on the parameters' device."""
        grads = [p.grad for p in self.params]
        gnorm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        # 1 below the threshold, ‖g‖/max_norm at or above it: optax's select
        denom = torch.clamp(gnorm / self.max_norm, min=1.0)
        grads = [g / denom for g in grads]
        torch._foreach_mul_(self.mu, self.b1)
        torch._foreach_add_(self.mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(self.nu, self.b2)
        torch._foreach_addcmul_(self.nu, grads, grads, value=1 - self.b2)
        mu_hat = torch._foreach_div(self.mu, self._bias_correction(self.b1, count))
        den = torch._foreach_div(self.nu, self._bias_correction(self.b2, count))
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.eps)
        update = torch._foreach_div(mu_hat, den)
        torch._foreach_add_(update, self.params, alpha=self.weight_decay)
        torch._foreach_add_(self.params, update, alpha=-self.schedule(count))
        return gnorm

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None


def make_optimizer(cfg: GNNTrainConfig, params) -> ClippedAdamW:
    """The optax chain of ``init_state`` (``train_gnn.py:61-69``) over ``params``."""
    schedule = warmup_cosine_decay_schedule(
        0.0, cfg.learning_rate, cfg.warmup_steps, 20_000, cfg.learning_rate * 0.05
    )
    return ClippedAdamW(params, schedule, weight_decay=cfg.weight_decay)


@dataclass
class TrainState:
    """The counterpart of flax's ``TrainState``: the step count, the model
    (holding the f32 parameters) and its optimizer. Steps update all three in
    place."""

    step: int
    model: TopoScorer
    optimizer: ClippedAdamW


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


def _place_batch(batch: PairBatch, g: TopoGraph, dev: torch.device) -> PairBatch:
    """A batch as tensors on ``dev``: numpy batches are bounds-checked on the
    host first; tensors are taken as checked (make_multi_step samples them
    from a checked pool)."""
    if not isinstance(batch.child, torch.Tensor):
        _check_pairs(batch, g.node_feats.shape[0])
    child, parent, feats, label = (torch.as_tensor(a).to(dev) for a in batch)
    return PairBatch(child.long(), parent.long(), feats.float(), label.float())


def make_train_step(remat: bool = False, *, with_metrics: bool = False) -> Callable:
    """One optimizer step: ``step(state, g, batch) -> (state, loss)``.

    With ``remat`` the model call runs under ``torch.utils.checkpoint``, so
    the backward recomputes the GNN forward instead of holding its [N, K, H]
    activations (``jax.checkpoint`` in the JAX package). ``with_metrics``
    widens the return to ``(state, (loss, grad_norm))`` with the pre-clip
    global gradient norm. ``g`` lies on the state's device; ``batch`` is a
    PairBatch of numpy arrays or of tensors. The loss and norm are device
    scalars: nothing waits for the device.
    """

    def step(state: TrainState, g: TopoGraph, batch: PairBatch):
        dev = _device_of(state)
        batch = _place_batch(batch, g, dev)
        model = state.model
        if remat:
            def apply(gg, c, p, f):
                return torch.utils.checkpoint.checkpoint(model, gg, c, p, f, use_reentrant=False)
        else:
            apply = model
        state.optimizer.zero_grad()
        loss = loss_fn(apply, g, batch)
        loss.backward()
        gnorm = state.optimizer.step(state.step)
        state.step += 1
        loss = loss.detach()
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
    grad_norms)``. Nothing returns to the host between steps; the caller
    pulls a call's values once. The generator's numbers differ from
    ``jax.random``'s: the distribution of batches is the same, the batches
    are not.
    """
    dev = _device_of(state)
    _check_pairs(pool, graph.node_feats.shape[0])
    g = graph.to(dev)
    child, parent, feats, label = (torch.as_tensor(a).to(dev) for a in pool)
    pool_t = PairBatch(child.long(), parent.long(), feats.float(), label.float())
    n_pool = pool_t.child.shape[0]
    step = make_train_step(remat, with_metrics=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)

    def multi_step(st: TrainState):
        losses = torch.empty(steps_per_call, dtype=torch.float32, device=dev)
        norms = torch.empty(steps_per_call, dtype=torch.float32, device=dev)
        for i in range(steps_per_call):
            idx = torch.randint(0, n_pool, (batch_size,), generator=gen, device=dev)
            batch = PairBatch(*(a.index_select(0, idx) for a in pool_t))
            st, (loss, gnorm) = step(st, g, batch)
            losses[i] = loss
            norms[i] = gnorm
        return (st, (losses, norms)) if with_metrics else (st, losses)

    return multi_step


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
) -> tuple[TrainState, list[float]]:
    """Cooperative training driver for asyncio hosts (the trainer service).

    Setup (init + placement) and each ``steps_per_call``-step call of
    ``make_multi_step`` run in a worker thread (``asyncio.to_thread``), so
    the event loop answers other coroutines between calls. Each call ends
    with one device-to-host pull of its losses and gradient norms. Returns
    (state, per-step losses), steps rounded up to whole calls.

    telemetry: any object with ``on_step(loss, grad_norm, examples=...)``
    (the trainer service's ``TrainRunTelemetry``); it is fed once per step
    after each call's pull, at no extra device sync. ``device`` stands where
    the JAX driver takes ``mesh``; the mesh is still to come.
    """
    steps_per_call = max(1, min(steps_per_call, steps))
    calls = -(-steps // steps_per_call)

    def _setup():
        state = init_state(cfg, graph, seed, device=device)
        multi = make_multi_step(
            state, graph, pairs, batch_size=cfg.batch_size, steps_per_call=steps_per_call,
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
                telemetry.on_step(float(lv), float(gv), examples=cfg.batch_size)
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
) -> tuple[TrainState, list[float]]:
    """Full training driver; returns final state + loss history.

    Batches are drawn on the host with ``sample_batch`` and
    ``np.random.default_rng(seed)``, as the JAX driver draws them, so both
    see the same batches; the loss is read back only when it is logged.
    ``device`` stands where the JAX driver takes ``mesh``; the mesh is still
    to come.
    """
    state = init_state(cfg, graph, seed, device=device)
    dev = _device_of(state)
    g = graph.to(dev)
    step_fn = make_train_step(cfg.remat)
    rng = np.random.default_rng(seed)
    losses: list[float] = []
    t0 = time.perf_counter()
    for i in range(steps):
        batch = sample_batch(pairs, cfg.batch_size, rng)
        state, loss = step_fn(state, g, batch)
        if (i + 1) % log_every == 0 or i == 0:
            lv = float(loss)
            losses.append(lv)
            log(f"step {i + 1}/{steps} loss={lv:.5f} ({(i + 1) / (time.perf_counter() - t0):.2f} steps/s)")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return state, losses
