"""Mesh + placement helpers (dp/tp over torch.distributed), the port of
dragonfly2_tpu/parallel/."""

from dragonfly2_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    graph_placements,
    infer_param_placements,
    make_mesh,
)
