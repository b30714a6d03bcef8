"""tanh-GELU in the working dtype, JAX's op for op, forward and backward.

flax ``nn.gelu`` as the port's models compute it (models/graphsage.py's
SAGE layers and head, models/mlp.py): every op rounded to the input's
dtype where JAX rounds it. It lives among the ops because the fused SAGE
message kernels (ops/sage_message.py) compute the same function, op for
op, and their plain version calls this one.
"""

from __future__ import annotations

import functools
import math

import torch


@functools.cache
def _constants(dtype: torch.dtype) -> tuple[float, float]:
    """sqrt(2/pi) and 0.044715 rounded to ``dtype``, as jax.nn.gelu casts
    them; once a dtype, not once a call (each call would build two host
    tensors)."""
    return tuple(float(torch.tensor(c, dtype=dtype)) for c in (math.sqrt(2 / math.pi), 0.044715))


def _gelu_tanh(x: torch.Tensor, c: float, k: float) -> torch.Tensor:
    """tanh(c * (x + k * x**3)), each op rounded to x's dtype, in one buffer."""
    return (x**3).mul_(k).add_(x).mul_(c).tanh_()


class _Gelu(torch.autograd.Function):
    """jax.nn.gelu(approximate=True) op for op, in x's dtype:
    ``x * (0.5 * (1 + tanh(c * (x + k * x**3))))`` with every op rounded to
    that dtype, and a backward that is JAX's own VJP of it, op for op (its
    jaxpr: ``p = 0.5·x·g·(1 - t)``, ``s = c·(p + p·t)``, ``dx = (g·cdf + s)
    + k·s·3x²``). In bf16, tanh rounds to -1 for x <= -3.06, so the value
    and the gradient are exactly 0 there, as in JAX; torch's fused
    ``F.gelu`` works in f32 inside and leaves about 1e-7 of the gradient
    down to -5.03, which Adam turns into full steps on a saturated unit.
    Only x is kept for the backward, which recomputes the rest; the ops run
    in place where an operand is not needed again (the same roundings,
    fewer temporaries)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(x)
        c, k = _constants(x.dtype)
        return _gelu_tanh(x, c, k).add_(1.0).mul_(0.5).mul_(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor) -> torch.Tensor:
        (x,) = ctx.saved_tensors
        c, k = _constants(x.dtype)
        # in place only into buffers that came from g: on a mesh g may hold
        # partial sums, which a buffer from x cannot take in place
        t = _gelu_tanh(x, c, k)
        p = (x * g).mul_(0.5).mul_(torch.sub(1.0, t))  # 0.5·x·g·(1 - t)
        s = (p * t).add_(p).mul_(c)  # c·(p + p·t)
        del p
        dx = (g * t.add_(1.0).mul_(0.5)).add_(s)  # g·cdf + s
        return dx.add_(s.mul_(k).mul_((x * x).mul_(3.0)))


def gelu(x: torch.Tensor) -> torch.Tensor:
    """flax ``nn.gelu``: the tanh approximation, in x's dtype, with JAX's
    roundings and JAX's gradient (``_Gelu``)."""
    return _Gelu.apply(x)
