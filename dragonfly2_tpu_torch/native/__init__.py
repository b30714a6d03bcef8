"""Serving front of the port: the micro-batching request front, and the
writer of the native C++ scorer's artifact."""

from dragonfly2_tpu_torch.native.microbatch import MicroBatchScorer
from dragonfly2_tpu_torch.native.scorer import export_scorer_artifact

__all__ = ["MicroBatchScorer", "export_scorer_artifact"]
