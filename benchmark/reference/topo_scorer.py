"""Plain reference of the topology GNN: GraphSAGE encoder, pairwise head,
MSE loss, its gradient, and the clipped AdamW update, in float32.

Written from the model's equations, not from the program: it imports torch
alone. Parameters are a flat dict keyed by their flax path
(``encoder/SAGELayer_0/msg_nbr/kernel``), kernels laid out [in, out].

Equations (N hosts, K probe slots, H hidden, D embed):
  h0 = x_node W + b                                      (encoder/Dense_0)
  per layer:  u = h Wn;  s = h Ws + bs;  v = e We        (msg_nbr, msg_self, msg_edge)
              m_ik = gelu(u[nbr_ik] + s_i + v_ik)
              a_i = sum_k mask_ik m_ik / (sum_k mask_ik + 1e-6)
              h = LayerNorm(gelu(h W0 + b0 + a))          (Dense_0, LayerNorm_0, eps 1e-6)
  z = normalise(h W1 + b1)                                (encoder/Dense_1; z / (|z| + 1e-6))
  score = sigmoid(head([zc, zp, zc * zp, pair_feats]))    (Dense 256, gelu, Dense 128, gelu, Dense 1)
gelu is the tanh approximation. Loss: mean((score - label)^2).

``q`` is the rounding applied wherever a lower-precision program would
round (operands and results of every product, each activation); the
reference itself passes the identity. The precision control passes
float8 training's rounding: values in e4m3 and their gradients in e5m2,
each tensor scaled by its absolute maximum.
"""

from __future__ import annotations

import math
from typing import Callable

import torch

Rounding = Callable[[torch.Tensor], torch.Tensor]

_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)


def identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _scaled(x: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """x rounded to ``dtype`` with one scale for the tensor (its absolute
    max onto ``top``, the format's largest finite value)."""
    amax = x.abs().amax()
    scale = torch.where(amax > 0, amax / top, torch.ones_like(amax))
    return (x / scale).to(dtype).to(x.dtype) * scale


class _Fp8(torch.autograd.Function):
    """float8 training's rounding: values in e4m3, gradients in e5m2, each
    tensor with its own scale."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return _scaled(x, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        return _scaled(g, torch.float8_e5m2, 57344.0)


def fp8_rounding(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 for the value, e5m2 for its gradient, per-tensor scales."""
    return _Fp8.apply(x)


def param_shapes(widths: dict) -> dict[str, tuple[int, ...]]:
    """Every parameter's flax path and shape for the given widths."""
    h, d, hh = widths["hidden"], widths["embed_dim"], widths["head_hidden"]
    fn, fe, fp = widths["node_features"], widths["edge_features"], widths["pair_features"]
    shapes: dict[str, tuple[int, ...]] = {
        "encoder/Dense_0/kernel": (fn, h), "encoder/Dense_0/bias": (h,),
    }
    for i in range(widths["num_layers"]):
        pre = f"encoder/SAGELayer_{i}/"
        shapes[pre + "msg_nbr/kernel"] = (h, h)
        shapes[pre + "msg_self/kernel"] = (h, h)
        shapes[pre + "msg_self/bias"] = (h,)
        shapes[pre + "msg_edge/kernel"] = (fe, h)
        shapes[pre + "Dense_0/kernel"] = (h, h)
        shapes[pre + "Dense_0/bias"] = (h,)
        shapes[pre + "LayerNorm_0/scale"] = (h,)
        shapes[pre + "LayerNorm_0/bias"] = (h,)
    shapes["encoder/Dense_1/kernel"] = (h, d)
    shapes["encoder/Dense_1/bias"] = (d,)
    shapes["head/layers_0/kernel"] = (3 * d + fp, hh)
    shapes["head/layers_0/bias"] = (hh,)
    shapes["head/layers_2/kernel"] = (hh, hh // 2)
    shapes["head/layers_2/bias"] = (hh // 2,)
    shapes["head/layers_4/kernel"] = (hh // 2, 1)
    shapes["head/layers_4/bias"] = (1,)
    return shapes


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.tanh(_SQRT_2_OVER_PI * (x + 0.044715 * x * x * x)))


def dense(p: dict, name: str, x: torch.Tensor, q: Rounding) -> torch.Tensor:
    y = q(q(x) @ q(p[name + "/kernel"]))
    bias = p.get(name + "/bias")
    return y if bias is None else q(y + q(bias))


def layer_norm(p: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + 1e-6) * p[name + "/scale"] + p[name + "/bias"]


def sage_layer(p: dict, i: int, h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor,
               edge_feats: torch.Tensor, q: Rounding) -> torch.Tensor:
    pre = f"encoder/SAGELayer_{i}/"
    n, k = neighbors.shape
    u = dense(p, pre + "msg_nbr", h, q)
    s = dense(p, pre + "msg_self", h, q)
    v = dense(p, pre + "msg_edge", edge_feats, q)
    nbr = u[neighbors.reshape(-1).long()].reshape(n, k, -1)
    msg = q(gelu(q(nbr + s[:, None, :] + v)))
    m = mask[..., None]
    agg = q((msg * m).sum(dim=1) / (m.sum(dim=1) + 1e-6))
    out = q(gelu(q(dense(p, pre + "Dense_0", h, q) + agg)))
    return q(layer_norm(p, pre + "LayerNorm_0", out))


def encode(p: dict, graph, num_layers: int, q: Rounding = identity) -> torch.Tensor:
    """[N, D] L2-normalised host embeddings of ``graph`` = (node_feats,
    neighbors, mask, edge_feats)."""
    node_feats, neighbors, mask, edge_feats = graph
    h = dense(p, "encoder/Dense_0", node_feats.float(), q)
    for i in range(num_layers):
        h = sage_layer(p, i, h, neighbors, mask.float(), edge_feats.float(), q)
    z = dense(p, "encoder/Dense_1", h, q)
    return z / (torch.linalg.vector_norm(z, dim=-1, keepdim=True) + 1e-6)


def head(p: dict, zc: torch.Tensor, zp: torch.Tensor, pair_feats: torch.Tensor,
         q: Rounding = identity) -> torch.Tensor:
    """Predicted normalised bandwidth in (0, 1) for each (child, parent) row."""
    x = torch.cat([zc, zp, zc * zp, pair_feats.float()], dim=-1)
    x = q(gelu(dense(p, "head/layers_0", x, q)))
    x = q(gelu(dense(p, "head/layers_2", x, q)))
    return torch.sigmoid(dense(p, "head/layers_4", x, q).squeeze(-1))


def scores(p: dict, graph, child: torch.Tensor, parent: torch.Tensor, pair_feats: torch.Tensor,
           num_layers: int, q: Rounding = identity) -> torch.Tensor:
    z = encode(p, graph, num_layers, q)
    return head(p, z[child.long()], z[parent.long()], pair_feats, q)


def loss(p: dict, graph, child, parent, pair_feats, label, num_layers: int,
         q: Rounding = identity, rows: slice | None = None) -> torch.Tensor:
    """MSE of the predicted bandwidth; ``rows`` restricts the mean to a
    slice of the batch (the fault of a batch half left out)."""
    pred = scores(p, graph, child, parent, pair_feats, num_layers, q)
    err = (pred - label.float()) ** 2
    return err.mean() if rows is None else err[rows].mean()


def learning_rate(count: int, hp: dict) -> float:
    """Linear warm-up from 0 to the peak over ``warmup_steps``, then a cosine
    to ``end_lr_ratio`` of the peak, reached at ``decay_steps``."""
    peak, warm = hp["learning_rate"], hp["warmup_steps"]
    if count < warm:
        return peak * count / warm
    t = min(count - warm, hp["decay_steps"] - warm) / (hp["decay_steps"] - warm)
    alpha = hp["end_lr_ratio"]
    return peak * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * t)) + alpha)


def train(p0: dict, graph, pool, batches: list[torch.Tensor], hp: dict, num_layers: int,
          q: Rounding = identity, rows: slice | None = None) -> dict:
    """``len(batches)`` steps of MSE, global-norm clip and AdamW from ``p0``.

    ``pool`` = (child, parent, pair_feats, label); ``batches`` holds each
    step's rows of the pool. Returns each step's loss, the first step's
    gradient per leaf as the optimiser takes it (after the clip), and the
    parameters after the last step.
    """
    params = {k: v.detach().clone().float().requires_grad_(True) for k, v in p0.items()}
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps = hp["adam_b1"], hp["adam_b2"], hp["adam_eps"]
    losses, first_grads = [], None
    for count, idx in enumerate(batches):
        child, parent, feats, label = (a[idx] for a in pool)
        value = loss(params, graph, child, parent, feats, label, num_layers, q, rows)
        grads = torch.autograd.grad(value, list(params.values()))
        losses.append(float(value.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((g.double() ** 2).sum() for g in grads))
            scale = 1.0 / max(float(gnorm) / hp["clip_norm"], 1.0)
            lr = learning_rate(count, hp)
            grads = dict(zip(params, (g * scale for g in grads)))
            if first_grads is None:
                first_grads = {k: g.clone() for k, g in grads.items()}
            for k, w in params.items():
                g = grads[k]
                mu[k].mul_(b1).add_(g, alpha=1 - b1)
                nu[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = mu[k] / (1 - b1 ** (count + 1))
                v_hat = nu[k] / (1 - b2 ** (count + 1))
                w.sub_(lr * (m_hat / (v_hat.sqrt() + eps) + hp["weight_decay"] * w))
        del grads, value
    return {"losses": losses, "first_grads": first_grads,
            "params": {k: v.detach() for k, v in params.items()}}


def linear_no_tf32() -> None:
    """float32 products in float32: TF32 off for matmuls and convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

