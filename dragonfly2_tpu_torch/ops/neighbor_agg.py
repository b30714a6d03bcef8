"""Neighbor gather + masked mean: the GraphSAGE aggregation hot op.

The port of dragonfly2_tpu/ops/neighbor_agg.py. The topology graph is a
dense padded neighbor table — ``neighbors[N, K]`` int32 with a float mask —
so aggregation is a static-shaped gather, a masked mean and matmuls.

``neighbor_gather`` + ``masked_mean`` are the plain path that ``SAGELayer``
uses, as in the JAX package; ``neighbor_aggregate`` dispatches the fused
form to the hand-written CUDA kernel (ops/neighbor_agg_cuda.py) the way the
JAX package dispatches it to its Pallas kernel.
"""

from __future__ import annotations

import torch

from dragonfly2_tpu_torch.ops import neighbor_agg_cuda


def neighbor_gather(h: torch.Tensor, neighbors: torch.Tensor) -> torch.Tensor:
    """Gather node states for each padded neighbor slot.

    h: [N, H] node states; neighbors: [N, K] int indices, all in [0, N)
    (padding points at a valid row, typically 0 — the mask zeroes its
    contribution). Returns [N, K, H].
    """
    return h.index_select(0, neighbors.reshape(-1)).reshape(*neighbors.shape, h.shape[-1])


def masked_mean(x: torch.Tensor, mask: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Mean over axis 1 counting only mask==1 slots. x: [N, K, H], mask: [N, K].

    Works in ``x.dtype``, mask and count included, as the JAX package's
    XLA path does; the CUDA kernel's f32-accumulating function is
    ``neighbor_agg_cuda.neighbor_aggregate_torch``, kept apart on purpose.
    """
    m = mask.to(x.dtype)[..., None]
    total = torch.sum(x * m, dim=1)
    count = torch.sum(m, dim=1)
    return total / (count + eps)


def neighbor_aggregate(
    h: torch.Tensor, neighbors: torch.Tensor, mask: torch.Tensor, *, impl: str = "auto"
) -> torch.Tensor:
    """Gather + masked mean: [N, H] -> [N, H] neighborhood means.

    impl: "auto" (the CUDA kernel for a CUDA tensor, its plain PyTorch
    version for a CPU tensor), "cuda" (the kernel; raises for a CPU
    tensor), or "torch" (gather + masked_mean, the counterpart of the JAX
    package's "xla").
    """
    if impl == "torch":
        return masked_mean(neighbor_gather(h, neighbors), mask)
    if impl not in ("auto", "cuda"):
        raise ValueError(f"impl must be 'auto', 'cuda' or 'torch', not {impl!r}")
    if impl == "cuda" or h.is_cuda:
        return neighbor_agg_cuda.neighbor_aggregate_cuda(h, neighbors, mask)
    return neighbor_agg_cuda.neighbor_aggregate_torch(h, neighbors, mask)


def segment_mean(values: torch.Tensor, segment_ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """COO-style aggregation for data prep: mean of values rows per segment.

    values: [E, ...]; segment_ids: [E]. Ids outside [0, num_segments) are
    dropped, as ``jax.ops.segment_sum`` drops them; an empty segment gives 0.
    """
    keep = (segment_ids >= 0) & (segment_ids < num_segments)
    ids = segment_ids[keep].long()
    vals = values[keep]
    shape = (num_segments, *values.shape[1:])
    total = torch.zeros(shape, dtype=values.dtype, device=values.device).index_add_(0, ids, vals)
    count = torch.zeros((num_segments, *vals.shape[1:-1], 1), dtype=values.dtype, device=values.device)
    count.index_add_(0, ids, torch.ones_like(vals[..., :1]))
    return total / torch.clamp(count, min=1.0)
