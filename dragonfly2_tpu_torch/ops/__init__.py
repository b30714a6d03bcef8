"""GNN hot ops: plain PyTorch paths and the hand-written CUDA kernels."""

from dragonfly2_tpu_torch.ops.neighbor_agg import (  # noqa: F401
    masked_mean,
    neighbor_aggregate,
    neighbor_gather,
    segment_mean,
)
from dragonfly2_tpu_torch.ops.neighbor_agg_cuda import NeighborAggregate  # noqa: F401
