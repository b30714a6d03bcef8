"""Training-side code of the port: the synthetic cluster and telemetry
generators, the telemetry-to-dataset ingest, MLP and GNN training on one
device or a mesh, the trainer service that joins them and its RPC server,
and the artifacts it publishes."""

from dragonfly2_tpu_torch.trainer.artifacts import (  # noqa: F401
    ARTIFACT_FORMAT,
    ArtifactIntegrityError,
    IncompatibleArtifact,
    artifact_digest,
    load_config,
    load_gnn,
    load_graph,
    load_mlp,
    load_native,
    load_sketch,
    save_artifact,
    save_graph,
    save_native,
    save_sketch,
    verify_artifact,
)
from dragonfly2_tpu_torch.trainer.dataset import (  # noqa: F401
    Dataset,
    DatasetAccumulator,
    build_dataset,
    split_pairs,
)
from dragonfly2_tpu_torch.trainer.metrics import TrainRunTelemetry  # noqa: F401
from dragonfly2_tpu_torch.trainer.service import (  # noqa: F401
    TrainerConfig,
    TrainerService,
    pack_records,
    unpack_records,
)
from dragonfly2_tpu_torch.trainer.train_gnn import (  # noqa: F401
    GNNTrainConfig,
    TrainState,
    init_state,
    make_multi_step,
    make_train_step,
    shard_for_training,
    shard_for_training_scan,
    train,
    train_async,
    train_step,
)
from dragonfly2_tpu_torch.trainer.train_mlp import MLPTrainConfig  # noqa: F401
