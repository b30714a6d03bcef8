"""PyTorch models of the ML scheduling plane: the feature schema, the
GraphSAGE TopoScorer, the MLP bandwidth predictor, flax weight carry-over
and the batched scorers.

Each name below loads its module on first use, so a process that needs
only the feature schema (the evaluator inside a scheduler, which reads
``models.features``) does not import torch until a model is loaded.
"""

import importlib

_EXPORTS = {
    "EDGE_FEATURE_DIM": "features", "FEATURE_DIM": "features", "FEATURE_NAMES": "features",
    "NODE_FEATURE_DIM": "features", "PAIR_FEATURE_DIM": "features",
    "GraphSAGE": "graphsage", "SAGELayer": "graphsage", "TopoGraph": "graphsage", "TopoScorer": "graphsage",
    "BandwidthMLP": "mlp",
    "GNNScorer": "scorer", "LinearScorer": "scorer",
    "init_flax_like": "weights", "params_from_flax": "weights", "params_to_flax": "weights",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
