"""K1 and K2: neighbour gather + masked mean and its backward, in CUDA.

The port of dragonfly2_tpu/ops/neighbor_agg_pallas.py: K1 is the Pallas TPU
kernel ``_agg_kernel``, K2 its custom VJP ``_agg_bwd``. Both live in
``csrc/neighbor_agg.cu``, are compiled with nvcc for sm_90a on first use
(ops/_build.py) and are called through their plain C entry points with
ctypes. The source header says what bounds them on the card and how their
design differs from the JAX package's.

K2 gathers over a transposed (CSR) copy of the neighbour table,
``transpose_index``, which the wrapper builds with torch's index ops (on the
CPU too) and ``NeighborAggregate`` builds once per forward.

``neighbor_aggregate_torch`` and ``neighbor_aggregate_bwd_torch`` beside
them are their plain PyTorch versions: the same functions, the same f32
accumulation and the same out-of-range rule. The CPU takes them (K2's
through the same index, ``neighbor_aggregate_bwd_index_torch``); on the
card the tests and chip_smoke.py hold the kernels against them.
``NeighborAggregate`` ties the two into one ``torch.autograd.Function``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from dragonfly2_tpu_torch.ops import _build

# Launches of K1 (LAUNCHES) and K2 (BWD_LAUNCHES) in this process; a run sets
# them to 0 and reads them afterwards to show that its path went through the
# kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

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


def neighbor_aggregate_bwd_torch(
    g: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, n: int, *, eps: float = 1e-6
) -> torch.Tensor:
    """[N, H] -> [n, H]: gh[j] = Σ_{nbr[i,k]=j} mask[i,k]·g[i] / (Σ_k mask[i,k] + eps).

    The gradient of ``neighbor_aggregate_torch`` with respect to h, in plain
    PyTorch: an f32 ``index_add_``, returned in ``g.dtype``. A slot whose
    index lies outside [0, n) adds nothing, as ``segment_sum`` drops it; a
    node that no slot names gets 0.
    """
    nbr = neighbors.long()
    w = mask.float()
    scale = w / (torch.sum(w, dim=1, keepdim=True) + eps)  # [N, K]
    live = (nbr >= 0) & (nbr < n) & (w != 0)
    rows = g.float()[:, None, :] * scale[..., None]  # [N, K, H]
    gh = torch.zeros((n, g.shape[-1]), dtype=torch.float32, device=g.device)
    return gh.index_add_(0, nbr[live], rows[live]).to(g.dtype)


class TransposedIndex(NamedTuple):
    """The neighbour table turned around, for K2's gather (CSR by destination).

    Row j's entries are ``[indptr[j], indptr[j+1])``: the live slots
    (mask != 0, 0 <= nbr < n) that name j, in (destination, flat slot
    i*K + k) order, each with its source row ``src`` (int32) and its weight
    mask[i,k] / (Σ_k mask[i,k] + eps) (f32). ``src`` and ``weight`` keep N*K
    places so that the build never waits on the device: the dead slots sort
    after every live one, past ``indptr[n]``, where no row's range reaches.
    """

    indptr: torch.Tensor  # [n + 1] int32
    src: torch.Tensor  # [N * K] int32
    weight: torch.Tensor  # [N * K] float32


def transpose_index(
    neighbors: torch.Tensor, mask: torch.Tensor, n: int, *, eps: float = 1e-6
) -> TransposedIndex:
    """Build K2's transposed index of (neighbors [N, K], mask [N, K]) over n
    destination rows, on their device, with torch's index ops: a stable sort
    of the destination ids (a dead slot's id is n) and a search of the sorted
    ids for each row's first entry. No host sync."""
    nbr = neighbors.to(torch.int32)
    w = mask.float()
    k = nbr.shape[1]
    indptr, order = live_order(nbr, w != 0, n)
    scale = (w / (torch.sum(w, dim=1, keepdim=True) + eps)).reshape(-1)
    return TransposedIndex(indptr, torch.div(order, max(k, 1), rounding_mode="floor").to(torch.int32), scale[order])


def live_order(nbr: torch.Tensor, nonzero: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The sort and search under a transposed index: of the slots of
    ``nbr`` [N, K] int32, the live ones (``nonzero`` [N, K] and 0 <= nbr <
    n) by destination row, stable in flat slot order, the rest after them.
    Returns ``indptr`` [n + 1] int32 (row j's entries are order[indptr[j]:
    indptr[j+1]]) and ``order`` [N * K] int64, the flat slots. No host
    sync."""
    live = nonzero & (nbr >= 0) & (nbr < n)
    key = torch.where(live, nbr, n).reshape(-1)
    sorted_key, order = torch.sort(key, stable=True)
    rows = torch.arange(n + 1, dtype=torch.int32, device=key.device)
    return torch.searchsorted(sorted_key, rows, out_int32=True), order


def neighbor_aggregate_bwd_index_torch(g: torch.Tensor, index: TransposedIndex) -> torch.Tensor:
    """K2's reduction over a transposed index in plain PyTorch: [N, H] ->
    [n, H] in g.dtype, f32 sums in entry order; equal to
    ``neighbor_aggregate_bwd_torch``.

    The CPU backward of ``NeighborAggregate``. It reads the index that the
    forward saved, the one K2 reads on the card, so a CPU gradient goes
    through the same index build and entry order as the card's; the
    slot-based ``neighbor_aggregate_bwd_torch`` stays the plain version that
    both are held against."""
    n = index.indptr.shape[0] - 1
    live = int(index.indptr[-1])
    counts = (index.indptr[1:] - index.indptr[:-1]).long()
    dst = torch.repeat_interleave(torch.arange(n, device=g.device), counts)
    rows = g.float()[index.src[:live].long()] * index.weight[:live, None]
    gh = torch.zeros((n, g.shape[-1]), dtype=torch.float32, device=g.device)
    return gh.index_add_(0, dst, rows).to(g.dtype)


@functools.cache
def _kernel():
    """The library's entry points, bound once with their C signatures."""
    lib = _build.load("neighbor_agg")
    fwd = lib.df_neighbor_agg_fwd
    fwd.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    bwd = lib.df_neighbor_agg_bwd
    bwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    err = lib.df_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, bwd, err


def _check(h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, name: str = "h") -> None:
    if not h.is_cuda:
        raise RuntimeError(
            "the neighbor_agg kernels need CUDA tensors; on the CPU call "
            "neighbor_aggregate(impl='auto') or the plain *_torch versions"
        )
    if h.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name} must be float32 or bfloat16, not {h.dtype}")
    if h.dim() != 2 or not h.is_contiguous():
        raise ValueError(f"{name} must be a contiguous [N, H] tensor, got shape {tuple(h.shape)}")
    if neighbors.dim() != 2 or neighbors.shape[0] != h.shape[0] or mask.shape != neighbors.shape:
        raise ValueError(
            f"neighbors {tuple(neighbors.shape)} and mask {tuple(mask.shape)} must both be "
            f"[N, K] with N = {h.shape[0]}"
        )
    if neighbors.device != h.device or mask.device != h.device:
        raise ValueError(f"neighbors and mask must lie on {h.device} with {name}")
    if neighbors.dtype.is_floating_point or neighbors.dtype.is_complex:
        raise TypeError(f"neighbors must be an integer tensor, not {neighbors.dtype}")
    if max(h.shape[0], h.shape[1], h.shape[0] * neighbors.shape[1]) > _INT32_MAX:
        raise ValueError("N, H and N*K must each fit in int32")


def _index_inputs(neighbors: torch.Tensor, mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """neighbors as contiguous int32 and mask as contiguous float32, as the
    kernels read them (no copy when they already are)."""
    return neighbors.to(torch.int32).contiguous(), mask.to(torch.float32).contiguous()


def _raise_on(rc: int, err, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({err(rc).decode()})")


def _launch_fwd(h: torch.Tensor, nbr: torch.Tensor, msk: torch.Tensor, eps: float) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty_like(h)
    n, hdim = h.shape
    if n == 0 or hdim == 0:
        return out
    fwd, _bwd, err = _kernel()
    with torch.cuda.device(h.device):
        rc = fwd(
            h.data_ptr(), nbr.data_ptr(), msk.data_ptr(), out.data_ptr(),
            n, nbr.shape[1], hdim, _DTYPE_CODES[h.dtype], eps,
            torch.cuda.current_stream(h.device).cuda_stream,
        )
    _raise_on(rc, err, "neighbor_agg_fwd")
    LAUNCHES += 1
    return out


def neighbor_aggregate_cuda(
    h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-6
) -> torch.Tensor:
    """Launch K1 on the current stream; [N, H] -> [N, H] in h.dtype.

    h: CUDA, contiguous, float32 or bfloat16. neighbors is cast to int32 and
    mask to float32 (both made contiguous), as the Pallas wrapper does.
    Raises on anything else, and if the launch is refused; it never falls
    back to the plain version. The result carries no gradient: differentiate
    through ``NeighborAggregate`` (``neighbor_aggregate``) instead.
    """
    _check(h, neighbors, mask)
    return _launch_fwd(h, *_index_inputs(neighbors, mask), eps)


def _launch_bwd(g: torch.Tensor, index: TransposedIndex) -> torch.Tensor:
    global BWD_LAUNCHES
    n, hdim = index.indptr.shape[0] - 1, g.shape[1]
    gh = torch.empty((n, hdim), dtype=g.dtype, device=g.device)
    if n == 0 or hdim == 0:
        return gh
    _fwd, bwd, err = _kernel()
    with torch.cuda.device(g.device):
        rc = bwd(
            g.data_ptr(), index.indptr.data_ptr(), index.src.data_ptr(), index.weight.data_ptr(), gh.data_ptr(),
            n, hdim, _DTYPE_CODES[g.dtype], torch.cuda.current_stream(g.device).cuda_stream,
        )
    _raise_on(rc, err, "neighbor_agg_bwd")
    BWD_LAUNCHES += 1
    return gh


def neighbor_aggregate_bwd_cuda(
    g: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, n: int, *, eps: float = 1e-6,
    index: TransposedIndex | None = None,
) -> torch.Tensor:
    """Launch K2 on the current stream; g [N, H] -> gh [n, H] in g.dtype.

    The same contract as ``neighbor_aggregate_bwd_torch``. g: CUDA,
    contiguous, float32 or bfloat16. ``index`` is ``transpose_index(neighbors,
    mask, n, eps=eps)``, built here when it is not given. Raises on what the
    kernel does not take and if the launch is refused.
    """
    _check(g, neighbors, mask, name="g")
    if not 0 <= n <= _INT32_MAX:
        raise ValueError(f"n must lie in [0, 2**31), not {n}")
    if index is None:
        index = transpose_index(neighbors, mask, n, eps=eps)
    elif index.indptr.shape != (n + 1,) or any(t.device != g.device for t in index):
        raise ValueError(f"index must be transpose_index(neighbors, mask, {n}) on {g.device}")
    return _launch_bwd(g, index)


class NeighborAggregate(torch.autograd.Function):
    """K1 forward, K2 backward: the counterpart of the Pallas kernel's
    ``jax.custom_vjp``. Differentiable with respect to h only.

    ``apply(h, neighbors, mask, eps, use_kernel)``: with ``use_kernel`` the
    forward launches K1 (and raises for a CPU tensor); without, it runs the
    plain version. The forward also builds K2's transposed index and saves
    it; the backward launches K2 over it for a CUDA gradient and runs the
    plain reduction over it for a CPU one. Apply it only where a gradient
    will be taken: ``neighbor_agg.neighbor_aggregate`` decides that, since
    only the caller sees grad mode (inside ``forward`` it is always off, and
    ``ctx.needs_input_grad`` follows h.requires_grad even under no_grad).
    """

    @staticmethod
    def forward(ctx, h, neighbors, mask, eps, use_kernel):
        if use_kernel:
            _check(h, neighbors, mask)
        nbr, msk = _index_inputs(neighbors, mask)
        ctx.save_for_backward(*transpose_index(nbr, msk, h.shape[0], eps=eps))
        if use_kernel:
            return _launch_fwd(h, nbr, msk, eps)
        return neighbor_aggregate_torch(h, nbr, msk, eps=eps)

    @staticmethod
    def backward(ctx, g):
        index = TransposedIndex(*ctx.saved_tensors)
        g = g.contiguous()
        gh = _launch_bwd(g, index) if g.is_cuda else neighbor_aggregate_bwd_index_torch(g, index)
        return gh, None, None, None, None
