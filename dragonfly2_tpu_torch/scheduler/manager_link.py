"""The scheduler's model loader, for artifacts the port or the JAX package wrote.

The port of the loader half of dragonfly2_tpu/scheduler/manager_link.py
(``ManagerLink._load_scorer_verified``, ``_load_scorer``,
``_classify_swap_error`` and the drift-reference load), as plain functions
with the same signatures, so that a scheduler's model watch can call them
in place of the JAX package's, which reach flax:

- ``load_scorer_verified(path, digest)``: the faultline ``model.load``
  point first, then the registry digest recomputed over the artifact's
  files; only a bit-exact artifact is loaded.
- ``load_scorer(path)``: ``(scorer, host_index)``. The native C++ scorer
  when the artifact has a ``scorer.dfsc`` and ``DRAGONFLY_NATIVE_SCORER`` is
  not ``0`` (engine ``"native"``, on the host's CPU); otherwise the port's
  ``GNNScorer`` refreshed on the artifact's graph, on the card unless a
  ``device`` is named (engine ``"torch"``). A native load that raises is
  logged with its traceback and falls back to torch, as the reference's
  falls back to JAX. The engine returned is logged either way.
- ``classify_swap_error(exc)``: the reference's swap-error kinds.
- ``load_drift_reference(path)``: the artifact's training-reference
  ``FeatureSketch``, or None.
"""

from __future__ import annotations

import logging
import os

import torch

from dragonfly2_tpu_torch.models.scorer import GNNScorer
from dragonfly2_tpu_torch.observability.sketches import FeatureSketch
from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.trainer import artifacts

logger = logging.getLogger(__name__)


def load_scorer_verified(path: str, digest: str = "", *, device: str | torch.device | None = None):
    """Verify the artifact against the registry row's digest, then load it.
    An injected ``model.load`` fault fires before verification (a latency
    rule blocks: a load runs off the event loop); a ``corrupt`` or
    ``truncate`` rule damages the bytes the digest reads."""
    if faultline.ACTIVE is not None:
        faultline.ACTIVE.check("model.load", blocking_latency=True)
    artifacts.verify_artifact(path, digest)
    return load_scorer(path, device=device)


def load_scorer(path: str, *, device: str | torch.device | None = None):
    """The artifact's scorer and its host-id → graph-row index."""
    graph, host_index = artifacts.load_graph(path)
    if os.environ.get("DRAGONFLY_NATIVE_SCORER", "1") != "0":
        try:
            native = artifacts.load_native(path)
        except Exception:
            logger.exception("native scorer unavailable for %s; falling back to torch", path)
        else:
            if native is not None:
                logger.info("serving model %s via engine %s (host CPU)", path, native.engine)
                return native, host_index
    model, state_dict = artifacts.load_gnn(path)
    scorer = GNNScorer(model, state_dict, device=device)
    scorer.refresh(graph)
    logger.info("serving model %s via engine %s on %s", path, scorer.engine, scorer.device)
    return scorer, host_index


def classify_swap_error(exc: Exception) -> str:
    """The swap-error kind of a failed load: ``digest_mismatch``, ``missing``
    or ``load_error``."""
    if isinstance(exc, artifacts.ArtifactIntegrityError):
        return "digest_mismatch"
    if isinstance(exc, FileNotFoundError):
        return "missing"
    return "load_error"


def load_drift_reference(path: str) -> FeatureSketch | None:
    """The artifact's training-reference sketch; None for an artifact
    written without one, or (logged) for one that fails to load."""
    try:
        return artifacts.load_sketch(path)
    except Exception:
        logger.exception("reference sketch load failed for %s", path)
        return None
