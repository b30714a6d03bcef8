"""dragonfly2_tpu_torch — the ML scheduling plane of dragonfly2_tpu in PyTorch.

A port of the JAX package ``dragonfly2_tpu`` to PyTorch and CUDA on an NVIDIA
H100. The JAX package stays the reference; this package mirrors its paths
and names (``models/graphsage.py`` here is ``models/graphsage.py`` there) so
each module has an obvious counterpart, and imports nothing of it.

Layout:
  models/   feature schema, GraphSAGE TopoScorer, flax weight carry-over,
            the cached-embedding GNNScorer
  ops/      neighbour gather / masked mean, and the hand-written CUDA
            neighbour-aggregation kernel (csrc/neighbor_agg.cu)
  trainer/  the synthetic cluster generator
  native/   the micro-batching request front

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless one is named.

    Raises RuntimeError when a CUDA device is wanted (explicitly, or by
    default) and none is present — an entry point never carries on on the
    CPU that the caller did not ask for.
    """
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
