"""Serving front of the port: the micro-batching request front."""

from dragonfly2_tpu_torch.native.microbatch import MicroBatchScorer

__all__ = ["MicroBatchScorer"]
