"""Training-side code of the port: the synthetic cluster generator, GNN
training on one device, and the artifacts it publishes. The dataset twin
and the MLP trainer follow in later slices."""

from dragonfly2_tpu_torch.trainer.artifacts import (  # noqa: F401
    ARTIFACT_FORMAT,
    ArtifactIntegrityError,
    IncompatibleArtifact,
    artifact_digest,
    load_config,
    load_gnn,
    load_graph,
    save_artifact,
    save_graph,
    save_native,
    verify_artifact,
)
from dragonfly2_tpu_torch.trainer.train_gnn import (  # noqa: F401
    GNNTrainConfig,
    TrainState,
    init_state,
    make_multi_step,
    make_train_step,
    train,
    train_async,
    train_step,
)
