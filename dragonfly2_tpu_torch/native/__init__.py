"""Serving front of the port: the micro-batching request front, and the
native C++ scorer (its ``scorer.dfsc`` writer, its ctypes binding, the
mirrored peer table's binding and the per-thread handle pool)."""

from dragonfly2_tpu_torch.native.microbatch import MicroBatchScorer
from dragonfly2_tpu_torch.native.scorer import (
    NativeMirror,
    NativeScorer,
    ScorerHandlePool,
    export_scorer_artifact,
)

__all__ = ["MicroBatchScorer", "NativeMirror", "NativeScorer", "ScorerHandlePool", "export_scorer_artifact"]
