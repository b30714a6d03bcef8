"""MLP bandwidth predictor (north-star config 1), as a PyTorch module.

The port of dragonfly2_tpu/models/mlp.py. Trains on scheduler download
records (the reference streams these CSVs as TrainMLPRequest chunks —
scheduler/announcer/announcer.go:193; the receiving trainer was never
built). Input: PAIR_FEATURE_DIM features for a (child, parent) pair; output:
predicted download bandwidth (normalized) usable directly as a parent score.

Numerics follow the flax module: compute in bfloat16 with float32
parameters, each ``Dense`` casting input, kernel and bias to bf16 and adding
the bias after the product, the tanh GELU, and the last layer's output cast
to f32 before the sigmoid. The layers are named ``Dense_0`` .. ``Dense_<n>``
as flax names them, so models/weights.py carries the parameters by name.
"""

from __future__ import annotations

import torch
from torch import nn

from dragonfly2_tpu_torch.models.features import PAIR_FEATURE_DIM
from dragonfly2_tpu_torch.models.graphsage import Dense, gelu


class BandwidthMLP(nn.Module):
    def __init__(self, hidden: tuple[int, ...] = (256, 256, 128), in_features: int = PAIR_FEATURE_DIM,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.hidden, self.dtype = tuple(hidden), dtype
        widths = (in_features, *self.hidden)
        for i, (w_in, w_out) in enumerate(zip(widths, widths[1:])):
            self.add_module(f"Dense_{i}", Dense(w_in, w_out, dtype=dtype))
        self.add_module(f"Dense_{len(self.hidden)}", Dense(widths[-1], 1, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, PAIR_FEATURE_DIM] float32 → [B] predicted bandwidth in [0,1]."""
        h = x.to(self.dtype)
        for i in range(len(self.hidden)):
            h = gelu(getattr(self, f"Dense_{i}")(h))
        out = getattr(self, f"Dense_{len(self.hidden)}")(h)
        return torch.sigmoid(out.float()).squeeze(-1)
