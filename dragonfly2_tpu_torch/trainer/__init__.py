"""Training-side code of the port: the synthetic cluster and telemetry
generators, the telemetry-to-dataset ingest, MLP and GNN training on one
device or a mesh, the trainer service that joins them and its RPC server,
and the artifacts it publishes.

Each name below loads its module on first use, as ``models`` does, so a
process that needs only the wire codec (``trainer._msgpack``, which the
port's RPC core reads) does not import torch: a scheduler whose evaluator
serves no model stays free of it.
"""

import importlib

_EXPORTS = {
    "ARTIFACT_FORMAT": "artifacts", "ArtifactIntegrityError": "artifacts",
    "IncompatibleArtifact": "artifacts", "artifact_digest": "artifacts",
    "load_config": "artifacts", "load_gnn": "artifacts", "load_graph": "artifacts",
    "load_mlp": "artifacts", "load_native": "artifacts", "load_sketch": "artifacts",
    "save_artifact": "artifacts", "save_graph": "artifacts",
    "save_native": "artifacts", "save_sketch": "artifacts",
    "verify_artifact": "artifacts",
    "Dataset": "dataset", "DatasetAccumulator": "dataset", "build_dataset": "dataset",
    "split_pairs": "dataset",
    "TrainRunTelemetry": "metrics",
    "TrainerConfig": "service", "TrainerService": "service", "pack_records": "service",
    "unpack_records": "service",
    "GNNTrainConfig": "train_gnn", "TrainState": "train_gnn",
    "init_state": "train_gnn", "make_multi_step": "train_gnn",
    "make_train_step": "train_gnn", "shard_for_training": "train_gnn",
    "shard_for_training_scan": "train_gnn", "train": "train_gnn",
    "train_async": "train_gnn", "train_step": "train_gnn",
    "MLPTrainConfig": "train_mlp",
}


def __getattr__(name: str):
    module = _EXPORTS.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(f"{__name__}.{module}"), name)
