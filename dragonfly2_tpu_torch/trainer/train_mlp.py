"""MLP bandwidth-predictor training (north-star config 1), in PyTorch.

The port of dragonfly2_tpu/trainer/train_mlp.py. Trains models/mlp.py's
BandwidthMLP on (child, parent) pair features from the scheduler's download
records — the path the reference sketched as TrainMLPRequest CSV chunks
(scheduler/announcer/announcer.go:193) into a trainer that was never
written. One device: the model is tiny, so data parallelism buys nothing.

The semantics are the JAX trainer's: each step's batch is
``rng.integers(0, n, min(batch, n))`` from ``np.random.default_rng(seed)``,
so the same seed draws the same batches; the loss is the MSE; the optimizer
is ``optax.adam`` (``ClippedAdamW`` with no clip, no decay and a constant
rate, f32 bias corrections as optax computes them); the gradient norm is
the global norm of the unclipped gradients. The pair pool and every step's
host-drawn indices are uploaded to the device once, before the first step,
so no step waits on a copy from the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.models.features import PAIR_FEATURE_DIM
from dragonfly2_tpu_torch.models.mlp import BandwidthMLP
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax
from dragonfly2_tpu_torch.trainer.synthetic import PairBatch
from dragonfly2_tpu_torch.trainer.train_gnn import ClippedAdamW


@dataclass
class MLPTrainConfig:
    hidden: tuple[int, ...] = (256, 256, 128)
    batch_size: int = 4096
    learning_rate: float = 1e-3
    steps: int = 500


def make_model(cfg: MLPTrainConfig, in_features: int = PAIR_FEATURE_DIM) -> BandwidthMLP:
    """The config's BandwidthMLP (flax infers ``in_features`` from the first
    input; here the caller gives it)."""
    return BandwidthMLP(hidden=tuple(cfg.hidden), in_features=in_features)


def make_optimizer(cfg: MLPTrainConfig, params) -> ClippedAdamW:
    """``optax.adam(cfg.learning_rate)`` over ``params``."""
    lr = cfg.learning_rate
    return ClippedAdamW(params, lambda _count: lr, weight_decay=0.0, max_norm=None, settles_at=0)


def train_step(
    model: BandwidthMLP, optimizer: ClippedAdamW, count: int, x: torch.Tensor, y: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Adam step on the MSE of ``model(x)`` against ``y``; ``count`` is
    the number of steps taken before. Returns (loss, global gradient norm)
    as f32 device scalars: nothing waits for the device."""
    optimizer.zero_grad()
    loss = torch.mean((model(x) - y) ** 2)
    loss.backward()
    gnorm = optimizer.step(count)
    return loss.detach(), gnorm


# host-side loss/grad-norm pull cadence for the telemetry hook: every step
# would force a device sync per step; every Nth keeps the curve dense while
# costing one D2H pull per N steps
_TELEMETRY_EVERY = 10


@torch.inference_mode()
def eval_mse(model: BandwidthMLP, pairs: PairBatch, device: torch.device) -> float:
    """MSE of ``model`` over the whole of ``pairs``, in one call."""
    pred = model(torch.as_tensor(pairs.feats).to(device))
    return float(torch.mean((pred - torch.as_tensor(pairs.label).to(device)) ** 2))


def train(
    cfg: MLPTrainConfig,
    pairs: PairBatch,
    *,
    eval_pairs: PairBatch | None = None,
    seed: int = 0,
    log: Callable[[str], None] = lambda s: None,
    telemetry=None,
    params: dict | None = None,
    device: str | torch.device | None = None,
) -> tuple[BandwidthMLP, dict[str, float]]:
    """Returns (the trained model, evaluation dict with train/eval mse).

    ``params`` is a flax parameter tree (``{"params": ...}`` with numpy
    leaves) to start from; without it the start is ``init_flax_like`` drawn
    from ``seed``, flax's init distribution but not its numbers. ``device``
    is the card unless one is named. telemetry: optional
    trainer.metrics.TrainRunTelemetry — receives sampled per-step
    loss/grad-norm/examples (the dragonfly_train_* families)."""
    dev = resolve_device(device)
    model = make_model(cfg, pairs.feats.shape[1])
    tree = params if params is not None else init_flax_like(model, seed=seed)
    model.load_state_dict(params_from_flax(tree))
    model.to(dev).train()
    optimizer = make_optimizer(cfg, model.parameters())
    feats = torch.as_tensor(pairs.feats).to(dev, torch.float32)
    label = torch.as_tensor(pairs.label).to(dev, torch.float32)
    rng = np.random.default_rng(seed)
    n = len(pairs.child)
    batch = min(cfg.batch_size, n)
    # the same rng.integers call per step as the JAX loop, so the same batches
    idx = np.empty((cfg.steps, batch), dtype=np.int64)
    for i in range(cfg.steps):
        idx[i] = rng.integers(0, n, size=batch)
    idx_t = torch.from_numpy(idx).to(dev)
    loss = torch.zeros((), device=dev)
    pending = 0
    for i in range(cfg.steps):
        loss, gnorm = train_step(model, optimizer, i, feats.index_select(0, idx_t[i]), label.index_select(0, idx_t[i]))
        pending += 1
        if telemetry is not None and (pending >= _TELEMETRY_EVERY or i == cfg.steps - 1):
            telemetry.on_step(float(loss), float(gnorm), steps=pending, examples=pending * batch)
            pending = 0
        if (i + 1) % 100 == 0:
            log(f"mlp step {i + 1}/{cfg.steps} loss={float(loss):.5f}")
    model.eval()
    evaluation = {"train_mse": float(loss)}
    if eval_pairs is not None and len(eval_pairs.child):
        evaluation["eval_mse"] = eval_mse(model, eval_pairs, dev)
    return model, evaluation
