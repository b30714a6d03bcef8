"""K1: fused neighbor gather + masked mean as a hand-written CUDA kernel.

The port of dragonfly2_tpu/ops/neighbor_agg_pallas.py (the Pallas TPU
kernel ``_agg_kernel``). The kernel lives in ``csrc/neighbor_agg.cu``, is
compiled with nvcc for sm_90a on first use (ops/_build.py) and is called
through its plain C entry point with ctypes. Its source header says what
bounds it on the card and how its design differs from the Pallas kernel.

``neighbor_aggregate_torch`` beside it is its plain PyTorch version: the
same function, the same f32 accumulation and the same out-of-range rule.
The CPU takes it; on the card the tests and chip_smoke.py hold the kernel
against it. The backward (the Pallas kernel's custom VJP) and the
``torch.autograd.Function`` around the kernel come with the training slice.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from dragonfly2_tpu_torch.ops import _build

# Launches of the kernel in this process; a run sets it to 0 and reads it
# afterwards to show that its path went through the kernel.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT32_MAX = 2**31 - 1


def neighbor_aggregate_torch(
    h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-6
) -> torch.Tensor:
    """[N, H] -> [N, H]: Σ_k mask·h[nbr] / (Σ_k mask + eps), in plain PyTorch.

    Accumulates in f32 and returns ``h.dtype``. A slot whose index lies
    outside [0, N) contributes nothing but its mask still counts, as in the
    Pallas kernel's one-hot formulation.
    """
    n = h.shape[0]
    nbr = neighbors.long()
    w = mask.float()
    valid = (nbr >= 0) & (nbr < n)
    rows = h.index_select(0, torch.where(valid, nbr, 0).reshape(-1))
    rows = rows.reshape(*nbr.shape, h.shape[-1]).float()
    total = torch.sum(rows * (w * valid)[..., None], dim=1)
    count = torch.sum(w, dim=1, keepdim=True)
    return (total / (count + eps)).to(h.dtype)


@functools.cache
def _kernel():
    """The library's two entry points, bound once with their C signatures."""
    lib = _build.load("neighbor_agg")
    fwd = lib.df_neighbor_agg_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    err = lib.df_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, err


def _check(h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor) -> None:
    if not h.is_cuda:
        raise RuntimeError(
            "neighbor_aggregate_cuda needs CUDA tensors; on the CPU call "
            "neighbor_aggregate(impl='auto') or neighbor_aggregate_torch"
        )
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"h must be float32 or bfloat16, not {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"h must be a contiguous [N, H] tensor, got shape {tuple(h.shape)}")
    if neighbors.dim() != 2 or neighbors.shape[0] != h.shape[0] or mask.shape != neighbors.shape:
        raise ValueError(
            f"neighbors {tuple(neighbors.shape)} and mask {tuple(mask.shape)} must both be "
            f"[N, K] with N = {h.shape[0]}"
        )
    if neighbors.device != h.device or mask.device != h.device:
        raise ValueError(f"neighbors and mask must lie on {h.device} with h")
    if neighbors.dtype.is_floating_point or neighbors.dtype.is_complex:
        raise TypeError(f"neighbors must be an integer tensor, not {neighbors.dtype}")
    if max(h.shape[0], h.shape[1], neighbors.shape[1]) > _INT32_MAX:
        raise ValueError("N, K and H must each fit in int32")


def neighbor_aggregate_cuda(
    h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-6
) -> torch.Tensor:
    """Launch the kernel on the current stream; [N, H] -> [N, H] in h.dtype.

    h: CUDA, contiguous, float32 or bfloat16. neighbors is cast to int32 and
    mask to float32 (both made contiguous), as the Pallas wrapper does.
    Raises on anything else, and if the launch is refused; it never falls
    back to the plain version.
    """
    global LAUNCHES
    _check(h, neighbors, mask)
    nbr = neighbors.to(torch.int32).contiguous()
    msk = mask.to(torch.float32).contiguous()
    out = torch.empty_like(h)
    n, hdim = h.shape
    if n == 0 or hdim == 0:
        return out
    fwd, err = _kernel()
    with torch.cuda.device(h.device):
        rc = fwd(
            h.data_ptr(), nbr.data_ptr(), msk.data_ptr(), out.data_ptr(),
            n, nbr.shape[1], hdim, _DTYPE_CODES[h.dtype], eps,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"neighbor_agg kernel launch failed: CUDA error {rc} ({err(rc).decode()})")
    LAUNCHES += 1
    return out
