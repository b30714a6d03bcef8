"""PyTorch models of the ML scheduling plane: the feature schema, the
GraphSAGE TopoScorer, the MLP bandwidth predictor, flax weight carry-over
and the batched scorers."""

from dragonfly2_tpu_torch.models.features import (  # noqa: F401
    EDGE_FEATURE_DIM,
    FEATURE_DIM,
    FEATURE_NAMES,
    NODE_FEATURE_DIM,
    PAIR_FEATURE_DIM,
)
from dragonfly2_tpu_torch.models.graphsage import GraphSAGE, SAGELayer, TopoGraph, TopoScorer  # noqa: F401
from dragonfly2_tpu_torch.models.mlp import BandwidthMLP  # noqa: F401
from dragonfly2_tpu_torch.models.scorer import GNNScorer, LinearScorer  # noqa: F401
from dragonfly2_tpu_torch.models.weights import (  # noqa: F401
    init_flax_like,
    params_from_flax,
    params_to_flax,
)
