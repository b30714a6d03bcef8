"""K3 and K4: the SAGE message path, fused into hand-written CUDA kernels.

``models/graphsage.SAGELayer`` aggregates its neighbours' messages as

    agg[n] = masked_mean_k(gelu(bf16(bf16(u[nbr[n,k]] + s[n]) + bf16(e[n,k] · We))), mask[n,k])

with u = msg_nbr(h), s = msg_self(h) and the edge term msg_edge(e). The
plain path (``message_path``) runs it as a gather, a dozen elementwise
passes and a reduction over [N, K, H] tensors, each written to and read back
from device memory, forward and backward. K3 computes agg in one pass and
K4 its gradient with respect to u, s and We; both recompute the edge term
from e[n,k,:E] and We, so neither the gathered rows, the pre-activations, the
messages nor their gradients leave registers, but for one bf16 write of the
per-edge gradient that K4 gathers back by destination. Every op rounds to
bf16 where the plain path's op rounds on the card (ops/gelu.py's tanh-GELU
op for op, the two adds, the mask's product, the mean's sum and divide); only
the order of an f32 sum differs (over k, the e · We contraction, g_We and
g_u), which can move a result by one bf16 rounding. Both kernels live in
``csrc/neighbor_agg.cu`` beside K1 and K2 (whose gather K4 reuses), built by
ops/_build.py and called through their C entry points with ctypes; the
source says what bounds them on the card and how they are laid out.

The JAX package has no kernel here: its SAGELayer leaves this path to XLA,
which fuses it on the TPU. These kernels were added because on the H100 the
plain path took most of a training step and of a refresh (PERF.md).

A ``Graph`` holds a graph's side of the op, checked, cast to the kernels'
forms and (when a gradient is taken) indexed once: the encoder makes one a
forward and hands it to every SAGE layer, whose call then checks only its
own u, s and weight (``Graph.takes``) and launches (``fused``). The kernels
take plain CUDA tensors (no DTensor), bf16, H a multiple of 8 (16-byte
rows), K at most 32 and at most 4 edge features; everything else, the CPU
and the sharded mesh among it, runs ``message_path``. ``sage_message`` is
the checked op on the six inputs of ``sage_message_torch``, its plain
version: ``message_path`` with the edge term as msg_edge computes it.
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from dragonfly2_tpu_torch.observability.tracing import stage
from dragonfly2_tpu_torch.ops import _build, neighbor_agg_cuda
from dragonfly2_tpu_torch.ops.gelu import gelu
from dragonfly2_tpu_torch.ops.neighbor_agg import masked_mean, neighbor_gather

# Launches of K3 (LAUNCHES) and K4 (BWD_LAUNCHES, its three kernels counted
# as one) in this process; a run sets them to 0 and reads them afterwards to
# show that its path went through the kernels.
LAUNCHES = 0
BWD_LAUNCHES = 0

MAX_NEIGHBORS = 32  # one slot a lane of a warp
MAX_EDGE_FEATURES = 4
_VEC = 8  # bf16 channels a lane loads at once: 16 bytes


def message_path(u: torch.Tensor, s: torch.Tensor, v: torch.Tensor, neighbors: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """The plain path: gather u's rows (in f32, exact, so that the gather's
    backward sums each row's gradient over its slots in f32, where a bf16
    index_add would round at every add, and on a mesh in another order
    across "data" shards than on one device), the message, the masked mean.
    u, s: [N, H]; v: [N, K, H] the edge term; in u's dtype."""
    with stage("gnn.sage.gather"):
        nbr = neighbor_gather(u.float(), neighbors).to(u.dtype)
    with stage("gnn.sage.message"):
        msg = gelu(nbr + s[:, None, :] + v)  # [N, K, H]
    with stage("gnn.sage.mean"):
        return masked_mean(msg, mask.to(u.dtype))  # [N, H]


def sage_message_torch(u: torch.Tensor, s: torch.Tensor, edge_feats: torch.Tensor, weight: torch.Tensor,
                       neighbors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """K3's function in plain PyTorch, differentiable: ``message_path`` with
    the edge term msg_edge's product ``F.linear(edge_feats, weight)`` in u's
    dtype (``weight`` [H, E], in that dtype)."""
    return message_path(u, s, F.linear(edge_feats.to(u.dtype), weight), neighbors, mask)


def slot_index(neighbors: torch.Tensor, mask: torch.Tensor, n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """K4's transposed index of (neighbors [N, K], mask [N, K]) over n
    destination rows: ``indptr`` [n + 1] int32 and ``slot`` [N * K] int32,
    row j's entries ``slot[indptr[j]:indptr[j+1]]`` the flat slots i*K + k
    that name j, in slot order. Only live slots enter, those whose bf16 mask
    is not 0 and whose index lies in [0, n), the slots K4's first pass writes
    a gradient for; the rest sort after every live one, past ``indptr[n]``.
    K2's sort and search (``neighbor_agg_cuda.live_order``), on the tensors'
    device: no host sync."""
    indptr, order = neighbor_agg_cuda.live_order(neighbors.to(torch.int32), mask.to(torch.bfloat16) != 0, n)
    return indptr, order.to(torch.int32)


def _graph_fits(edge_feats: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor) -> bool:
    ts = (edge_feats, neighbors, mask)
    if any(isinstance(t, DTensor) or not t.is_cuda or t.device != edge_feats.device for t in ts):
        return False
    if edge_feats.dim() != 3 or neighbors.dim() != 2 or mask.shape != neighbors.shape:
        return False
    n, k, e = edge_feats.shape
    return (neighbors.shape == (n, k) and edge_feats.dtype.is_floating_point and not edge_feats.requires_grad
            and not mask.requires_grad and not (neighbors.dtype.is_floating_point or neighbors.dtype.is_complex)
            and 1 <= k <= MAX_NEIGHBORS and 1 <= e <= MAX_EDGE_FEATURES and n * k < 2**31)  # K4's int32 slots


class Graph:
    """One graph's side of K3 and K4, prepared once and shared by the
    layers of an encoder call. ``ok``: whether the kernels take the graph
    (plain CUDA tensors on one device, no DTensor; edge_feats [N, K, E]
    floating and needing no gradient, neighbors (integer) and mask [N, K];
    1 <= K <= 32, 1 <= E <= 4). Where they do, its tensors in the kernels'
    forms, without a copy where they have it already: edge features f32,
    neighbours int32, mask f32, contiguous (the kernels round e and the mask
    to bf16 as the plain path casts them). K4's index (``slot_index``) is
    built by the first backward that needs it: never without a gradient."""

    def __init__(self, edge_feats: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor):
        self.ok = _graph_fits(edge_feats, neighbors, mask)
        self._index: tuple[torch.Tensor, torch.Tensor] | None = None
        if self.ok:
            self.device = edge_feats.device
            self.n, self.k, self.edim = edge_feats.shape
            self.e = edge_feats.to(torch.float32).contiguous()
            self.nbr = neighbors.to(torch.int32).contiguous()
            self.msk = mask.to(torch.float32).contiguous()

    def takes(self, u: torch.Tensor, s: torch.Tensor, weight: torch.Tensor) -> bool:
        """Whether K3 and K4 take a layer's u and s (bf16 [N, H] on the
        graph's card, contiguous and 16-byte aligned, H a multiple of 8,
        N*H under 2**31) and msg_edge's weight [H, E] (the parameter, in any
        float dtype) on this graph. What the code can see in the inputs
        decides; there is no switch."""
        if not self.ok or any(isinstance(t, DTensor) or t.device != self.device for t in (u, s, weight)):
            return False
        if u.dtype != torch.bfloat16 or s.dtype != torch.bfloat16 or u.dim() != 2 or s.shape != u.shape:
            return False
        n, h = u.shape
        return (n == self.n and h % _VEC == 0 and n * h < 2**31 and weight.shape == (h, self.edim)
                and weight.dtype.is_floating_point and u.is_contiguous() and s.is_contiguous()
                and u.data_ptr() % 16 == 0 and s.data_ptr() % 16 == 0)

    def index(self) -> tuple[torch.Tensor, torch.Tensor]:
        if self._index is None:
            self._index = slot_index(self.nbr, self.msk, self.n)
        return self._index


@functools.cache
def _kernel():
    """The library's entry points, bound once with their C signatures."""
    lib = _build.load("neighbor_agg")
    fwd = lib.df_sage_message_fwd
    fwd.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fwd.restype = ctypes.c_int
    blocks = lib.df_sage_message_bwd_blocks
    blocks.argtypes = [ctypes.c_int] * 3
    blocks.restype = ctypes.c_int
    bwd = lib.df_sage_message_bwd
    bwd.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    bwd.restype = ctypes.c_int
    err = lib.df_cuda_error_string
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fwd, blocks, bwd, err


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {rc} ({_kernel()[-1](rc).decode()})")


def _launch_fwd(u: torch.Tensor, s: torch.Tensor, w: torch.Tensor, graph: Graph) -> torch.Tensor:
    global LAUNCHES
    out = torch.empty_like(u)
    dev = graph.device.index
    rc = _kernel()[0](u.data_ptr(), s.data_ptr(), w.data_ptr(), graph.e.data_ptr(), graph.nbr.data_ptr(),
                      graph.msk.data_ptr(), out.data_ptr(), graph.n, graph.k, u.shape[1], graph.edim, dev,
                      torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sage_message_fwd")
    LAUNCHES += 1
    return out


@functools.cache
def _bwd_blocks(device: int, n: int, h: int) -> int:
    blocks = _kernel()[1](n, h, device)
    if blocks < 1:
        raise RuntimeError(f"sage_message_bwd: the card's occupancy query failed ({blocks})")
    return blocks


def _launch_bwd(g: torch.Tensor, u: torch.Tensor, s: torch.Tensor, w: torch.Tensor, graph: Graph):
    global BWD_LAUNCHES
    n, h = u.shape
    gu, gs = torch.empty_like(u), torch.empty_like(s)
    if n == 0:
        return gu, gs, torch.zeros_like(w)
    dev = graph.device.index
    indptr, slot = graph.index()
    gw = torch.empty_like(w)
    blocks = _bwd_blocks(dev, n, h)
    dx = torch.empty((n * graph.k, h), dtype=torch.bfloat16, device=u.device)
    partial = torch.empty((blocks, h, graph.edim), dtype=torch.float32, device=u.device)
    rc = _kernel()[2](g.data_ptr(), u.data_ptr(), s.data_ptr(), w.data_ptr(), graph.e.data_ptr(),
                      graph.nbr.data_ptr(), graph.msk.data_ptr(), indptr.data_ptr(), slot.data_ptr(), dx.data_ptr(),
                      partial.data_ptr(), blocks, gu.data_ptr(), gs.data_ptr(), gw.data_ptr(), n, graph.k, h,
                      graph.edim, dev, torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(rc, "sage_message_bwd")
    BWD_LAUNCHES += 1
    return gu, gs, gw


class SageMessage(torch.autograd.Function):
    """K3 forward, K4 backward, differentiable with respect to u, s and the
    bf16 weight: ``apply(u, s, w, graph)``. Only u, s and w are saved, the
    graph's tensors held by ``graph``: K4 recomputes the rest, so under
    ``torch.utils.checkpoint`` nothing of [N, K, H] is held either way."""

    @staticmethod
    def forward(ctx, u, s, w, graph):
        ctx.save_for_backward(u, s, w)
        ctx.graph = graph
        return _launch_fwd(u, s, w, graph)

    @staticmethod
    def backward(ctx, g):
        u, s, w = ctx.saved_tensors
        g = g.contiguous()
        if g.data_ptr() % 16:
            g = g.clone()
        gu, gs, gw = _launch_bwd(g, u, s, w, ctx.graph)
        return gu, gs, gw, None


def fused(u: torch.Tensor, s: torch.Tensor, weight: torch.Tensor, graph: Graph) -> torch.Tensor:
    """agg [N, H] bf16 through K3, differentiable through K4, for inputs
    that ``graph.takes`` (not checked again here: the layer has asked).
    ``weight`` is msg_edge's [H, E], cast to bf16 as the plain path casts
    it. Where a gradient will be taken (grad mode on and u, s or weight
    needs one) the call goes through ``SageMessage``; otherwise it launches
    K3 alone and saves nothing."""
    w = weight.to(torch.bfloat16).contiguous()
    if torch.is_grad_enabled() and (u.requires_grad or s.requires_grad or w.requires_grad):
        return SageMessage.apply(u, s, w, graph)
    return _launch_fwd(u, s, w, graph)


def sage_message(u: torch.Tensor, s: torch.Tensor, edge_feats: torch.Tensor, weight: torch.Tensor,
                 neighbors: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """``fused`` on the six inputs of ``sage_message_torch``, checked: it
    raises on what the kernels do not take and never falls back to the
    plain path."""
    if not all(t.is_cuda for t in (u, s, edge_feats, weight, neighbors, mask)):
        raise RuntimeError("the sage_message kernels need CUDA tensors; on the CPU call message_path or "
                           "sage_message_torch")
    graph = Graph(edge_feats, neighbors, mask)
    if not graph.takes(u, s, weight):
        raise ValueError(
            "sage_message takes plain CUDA tensors on one device: u and s bf16 [N, H], contiguous, 16-byte "
            f"aligned, H a multiple of {_VEC}; neighbors (integer) and mask [N, K], 1 <= K <= "
            f"{MAX_NEIGHBORS}; edge_feats [N, K, E] floating with no gradient, 1 <= E <= {MAX_EDGE_FEATURES}; "
            f"weight [H, E]; got u {tuple(u.shape)} {u.dtype}, s {tuple(s.shape)} {s.dtype}, edge_feats "
            f"{tuple(edge_feats.shape)}, weight {tuple(weight.shape)}, neighbors {tuple(neighbors.shape)} "
            f"{neighbors.dtype}, mask {tuple(mask.shape)}"
        )
    return fused(u, s, weight, graph)
