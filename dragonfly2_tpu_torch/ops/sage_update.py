"""K5 and K6: the SAGE layer's node update, fused into hand-written CUDA kernels.

``models/graphsage.SAGELayer`` ends in ``LayerNorm_0(gelu(Dense_0(h) + agg))``.
With y = Dense_0's product without its bias and b0 that bias in the layer's
dtype, the plain ops (``sage_update_torch``) run it as

    LayerNorm(gelu(bf16(bf16(y + b0) + agg)))

a bias add, the message add, ops/gelu.py's eight bf16 passes and
LayerNorm.forward's f32 ones, each written to and read back from device
memory, and autograd about as many again backward. K5 computes it in one pass,
one warp a row, and K6 its gradient with respect to y and agg (one g_x, the
same for both), b0 and the LayerNorm's scale and bias. Every op rounds where
the plain op rounds it on the card (the two bf16 adds, the tanh-GELU op for op
and its VJP, LayerNorm's f32 ops one at a time, g_a rounded to bf16 where the
backward of ``a.float()`` rounds it); only the order of an f32 sum differs
(the row's two sums, and the column sums of the three parameter gradients),
which can move a result by one bf16 rounding. Both live in
``csrc/sage_update.cu``, built by ops/_build.py and called through their C
entry points with ctypes; the source says what bounds them on the card and
how they are laid out.

The JAX package has no kernel here: its SAGELayer leaves this epilogue to
XLA, which fuses it on the TPU. These kernels were added because on the H100
the plain ops' elementwise passes took about a quarter of a training step
(PERF.md).

The kernels take plain CUDA tensors on one card (no DTensor): y and agg bf16
[N, H], H a multiple of 8 and at most 1024, b0 bf16 [H], the scale and bias
f32 [H], all contiguous and 16-byte aligned (``fits``, ``takes``). Everything
else, the CPU, the sharded mesh and f32 models among it, runs the plain ops,
which ``sage_update_torch`` is. ``sage_update`` is the checked op; ``fused``
the layer's call once it has asked ``takes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.distributed.tensor import DTensor

from dragonfly2_tpu_torch.ops import _build
from dragonfly2_tpu_torch.ops.gelu import gelu

# Launches of K5 (LAUNCHES) and K6 (BWD_LAUNCHES, its two kernels counted as
# one) in this process; a run sets them to 0 and reads them afterwards to
# show that its path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_WIDTH = 1024  # four 16-byte vectors a lane of a warp
_VEC = 8  # bf16 channels a lane loads at once: 16 bytes


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
               dtype: torch.dtype) -> torch.Tensor:
    """flax ``nn.LayerNorm`` as ``models/graphsage.LayerNorm`` computes it:
    mean and E[x²] in f32, the variance clamped at 0, the scale folded into
    the rsqrt, the result cast to ``dtype``."""
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.clamp((x * x).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
    mul = torch.rsqrt(var + eps) * weight
    return ((x - mu) * mul + bias).to(dtype)


def sage_update_torch(y: torch.Tensor, b0: torch.Tensor, agg: torch.Tensor, gamma: torch.Tensor,
                      beta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """K5's function in plain PyTorch, differentiable: the layer's
    ``LayerNorm_0(gelu(Dense_0(h) + agg))`` with Dense_0's product ``y`` and
    bias ``b0`` (in y's dtype) apart, LayerNorm_0's scale ``gamma`` and bias
    ``beta``."""
    return layer_norm(gelu(y + b0 + agg), gamma, beta, eps, y.dtype)


def fits(y: torch.Tensor, b0: torch.Tensor, agg: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> bool:
    """Whether the update's inputs have the kernels' layout, wherever they
    lie: y and agg bf16 [N, H], H a multiple of 8 and at most 1024, N*H under
    2**31; b0 bf16 [H]; gamma and beta f32 [H]; all contiguous and 16-byte
    aligned. Plain tensors only (``takes`` asks about DTensors first)."""
    ts = (y, b0, agg, gamma, beta)
    if tuple(t.dtype for t in ts) != (torch.bfloat16,) * 3 + (torch.float32,) * 2:
        return False
    if y.dim() != 2 or agg.shape != y.shape:
        return False
    n, h = y.shape
    return (0 < h <= MAX_WIDTH and h % _VEC == 0 and n * h < 2**31
            and all(t.shape == (h,) for t in (b0, gamma, beta))
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts))


def takes(y: torch.Tensor, b0: torch.Tensor, agg: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor) -> bool:
    """Whether K5 and K6 take a layer's node update: plain CUDA tensors on
    one card (no DTensor) that ``fit``. What the code can see in the inputs
    decides; there is no switch."""
    ts = (y, b0, agg, gamma, beta)
    if any(isinstance(t, DTensor) or not t.is_cuda or t.device != y.device for t in ts):
        return False
    return fits(y, b0, agg, gamma, beta)


@functools.cache
def _kernel():
    """The library's entry points, bound once with their C signatures."""
    lib = _build.load("sage_update")
    fwd = lib.df_sage_update_fwd
    fwd.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    blocks = lib.df_sage_update_bwd_blocks
    blocks.argtypes = [ctypes.c_int] * 3
    blocks.restype = ctypes.c_int
    bwd = lib.df_sage_update_bwd
    bwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    err = lib.df_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, blocks, bwd, err


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({_kernel()[-1](rc).decode()})")


def _launch_fwd(y, b0, agg, gamma, beta, eps: float, save: bool):
    """K5: the output [N, H] bf16, and with ``save`` also what K6 reads:
    x [N, H] bf16, the rows' mean and rstd [N] f32 (rstd negative where the
    variance's clamp bound)."""
    global LAUNCHES
    n, h = y.shape
    out = torch.empty_like(y)
    x = torch.empty_like(y) if save else None
    mu = torch.empty(n, dtype=torch.float32, device=y.device) if save else None
    rstd = torch.empty_like(mu) if save else None
    dev = y.device.index
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _kernel()[0](y.data_ptr(), b0.data_ptr(), agg.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                      out.data_ptr(), ptr(x), ptr(mu), ptr(rstd), n, h, eps, dev,
                      torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sage_update_fwd")
    LAUNCHES += 1
    return (out, x, mu, rstd) if save else out


@functools.cache
def _bwd_blocks(device: int, n: int, h: int) -> int:
    blocks = _kernel()[1](n, h, device)
    if blocks < 1:
        raise RuntimeError(f"sage_update_bwd: the card's occupancy query failed ({blocks})")
    return blocks


def _launch_bwd(g, x, mu, rstd, gamma):
    """K6: g_x [N, H] bf16, the gradients of b0 [H] bf16 and of the scale
    and bias [H] f32."""
    global BWD_LAUNCHES
    n, h = x.shape
    gx = torch.empty_like(x)
    if n == 0:
        return gx, torch.zeros(h, dtype=torch.bfloat16, device=x.device), torch.zeros_like(gamma), \
            torch.zeros_like(gamma)
    dev = x.device.index
    blocks = _bwd_blocks(dev, n, h)
    partial = torch.empty((blocks, 3, h), dtype=torch.float32, device=x.device)
    g_b0 = torch.empty(h, dtype=torch.bfloat16, device=x.device)
    g_gamma, g_beta = torch.empty_like(gamma), torch.empty_like(gamma)
    rc = _kernel()[2](g.data_ptr(), x.data_ptr(), mu.data_ptr(), rstd.data_ptr(), gamma.data_ptr(), gx.data_ptr(),
                      partial.data_ptr(), blocks, g_gamma.data_ptr(), g_beta.data_ptr(), g_b0.data_ptr(), n, h, dev,
                      torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sage_update_bwd")
    BWD_LAUNCHES += 1
    return gx, g_b0, g_gamma, g_beta


class SageUpdate(torch.autograd.Function):
    """K5 forward, K6 backward: ``apply(y, b0, agg, gamma, beta, eps)``.
    Saves x (bf16), the rows' mean and rstd and gamma; K6 recomputes the
    GELU from x."""

    @staticmethod
    def forward(ctx, y, b0, agg, gamma, beta, eps):
        out, x, mu, rstd = _launch_fwd(y, b0, agg, gamma, beta, eps, save=True)
        ctx.save_for_backward(x, mu, rstd, gamma)
        return out

    @staticmethod
    def backward(ctx, g):
        x, mu, rstd, gamma = ctx.saved_tensors
        g = g.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        gx, g_b0, g_gamma, g_beta = _launch_bwd(g, x, mu, rstd, gamma)
        return gx, g_b0, gx, g_gamma, g_beta, None


def fused(y: torch.Tensor, b0: torch.Tensor, agg: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float) -> torch.Tensor:
    """The update [N, H] bf16 through K5, differentiable through K6, for
    inputs that ``takes`` (not checked again here: the layer has asked).
    Where a gradient will be taken (grad mode on and an input needs one) the
    call goes through ``SageUpdate``; otherwise it launches K5 alone and
    saves nothing."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (y, b0, agg, gamma, beta)):
        return SageUpdate.apply(y, b0, agg, gamma, beta, eps)
    return _launch_fwd(y, b0, agg, gamma, beta, eps, save=False)


def sage_update(y: torch.Tensor, b0: torch.Tensor, agg: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``fused`` on the inputs of ``sage_update_torch``, checked: it raises
    on what the kernels do not take and never falls back to the plain ops."""
    if not all(t.is_cuda for t in (y, b0, agg, gamma, beta)):
        raise RuntimeError("the sage_update kernels need CUDA tensors; on the CPU call sage_update_torch")
    if not takes(y, b0, agg, gamma, beta):
        raise ValueError(
            "sage_update takes plain CUDA tensors on one card: y and agg bf16 [N, H], H a multiple of "
            f"{_VEC} and at most {MAX_WIDTH}; b0 bf16 [H]; gamma and beta f32 [H]; all contiguous and 16-byte "
            f"aligned; got y {tuple(y.shape)} {y.dtype}, b0 {tuple(b0.shape)} {b0.dtype}, agg {tuple(agg.shape)} "
            f"{agg.dtype}, gamma {tuple(gamma.shape)} {gamma.dtype}, beta {tuple(beta.shape)} {beta.dtype}"
        )
    return fused(y, b0, agg, gamma, beta, eps)
