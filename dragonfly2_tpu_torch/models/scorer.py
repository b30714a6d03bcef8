"""Batched parent scorer serving the scheduler's hot loop, in PyTorch.

The port of dragonfly2_tpu/models/scorer.py. Node embeddings are cached
(recomputed only when telemetry refreshes, ``refresh()``), and a round
scores all ~40 candidates through the pairwise head in one call.

Two engines:
  LinearScorer  — the reference's default evaluator weights (base fallback).
  GNNScorer     — TopoScorer embeddings + head, on the card by default.
"""

from __future__ import annotations

import copy
from typing import Any, Mapping

import numpy as np
import torch

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.models.features import BASE_WEIGHTS, FEATURE_DIM
from dragonfly2_tpu_torch.models.graphsage import TopoGraph, TopoScorer


class LinearScorer:
    """Reference-default linear blend (evaluator_base.go:31-49 weights)."""

    def score(self, pair_feats: np.ndarray, **_: Any) -> np.ndarray:
        return np.asarray(pair_feats[:, : len(BASE_WEIGHTS)] @ BASE_WEIGHTS[: pair_feats.shape[1]])


def _dot_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with both operands rounded to bf16 and the product in f32:
    ``jnp.dot(bf16, bf16, preferred_element_type=f32)``. Products of bf16
    values are exact in f32, so an f32 GEMM of the rounded operands gives it;
    callers keep TF32 off."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


class GNNScorer:
    """Cached-embedding GNN scorer; one head call per scheduling round.

    ``model`` is a TopoScorer that fixes the widths; the scorer runs its own
    copy of it, loaded with ``state_dict``, on ``device`` (the card unless
    the caller names another; it raises when no card is present). The JAX
    GNNScorer pins serving to the host CPU instead; whether a 40-candidate
    round pays for the trip to the card is for measurement to decide.

    Threads: ``score`` reads only the tables ``refresh`` cached and builds
    its own inputs, so the scheduler's round dispatcher workers call one
    scorer at once (a torch bundle has no per-thread handles; its
    ``thread_scorer()`` is this scorer). On the card their kernels queue on
    the device's one default stream: concurrent calls overlap their host
    legs, not their device work. ``refresh`` and ``update_params`` must not
    run beside them.
    """

    # The serving-mode label a scheduler reads. The port's evaluator
    # (scheduler/evaluator.py, loaded into a reference scheduler through its
    # plugin slot) sets ML_SERVING_MODE{mode="torch"} for it; the JAX
    # package's own evaluator knows "native", "jax" and "base" only and sets
    # all three to 0, a gap of that evaluator, not a label to dress up as
    # "jax". A scheduler attaching through scheduler.manager_link serves the
    # native C++ scorer ("native") whenever the artifact has a scorer.dfsc;
    # this engine is its fallback.
    engine = "torch"

    def __init__(self, model: TopoScorer, state_dict: Mapping[str, torch.Tensor],
                 device: str | torch.device | None = None):
        self._device = resolve_device(device)
        self._model = copy.deepcopy(model).to(self._device).eval()
        self._model.load_state_dict(state_dict)
        self._z: torch.Tensor | None = None
        self._uc: torch.Tensor | None = None
        self._up: torch.Tensor | None = None

    @property
    def device(self) -> torch.device:
        return self._device

    @torch.inference_mode()
    def refresh(self, graph: TopoGraph) -> None:
        """Recompute cached node embeddings + head partials (call when
        telemetry updates).

        The head's first Dense sees x = [zc, zp, zc*zp, feats], so its
        kernel splits row-wise into per-term blocks; the zc and zp blocks
        depend only on the node, and projecting the whole table once here
        leaves only the zc*zp and feats blocks per candidate. The partials
        are f32 products of bf16 operands, so their per-round sum loses
        nothing against the single fused product.
        """
        z = self._model.embed(graph.to(self._device))
        w1 = self._model.head.layers_0.weight.T  # flax layout [in, out]
        e = z.shape[1]
        self._uc = _dot_f32(z, w1[:e])
        self._up = _dot_f32(z, w1[e : 2 * e])
        self._z = z
        if self._device.type == "cuda":
            torch.cuda.synchronize(self._device)

    @property
    def num_nodes(self) -> int:
        """Rows in the cached embedding table (micro-batcher bounds checks)."""
        return 0 if self._z is None else int(self._z.shape[0])

    @property
    def feature_dim(self) -> int:
        return FEATURE_DIM

    def update_params(self, state_dict: Mapping[str, torch.Tensor]) -> None:
        self._model.load_state_dict(state_dict)
        self._z = self._uc = self._up = None

    @property
    def ready(self) -> bool:
        return self._z is not None

    def close(self) -> None:
        """Drop the cached tables and the model, so that a retired scorer
        frees its card memory even while another object (a micro-batcher, a
        drained bundle) still holds it. ``ModelBundle.close`` calls this once
        no round is inside the bundle; scoring after it raises."""
        self._z = self._uc = self._up = None
        self._model = None

    @torch.inference_mode()
    def score(
        self, pair_feats: np.ndarray, *, child: np.ndarray, parent: np.ndarray
    ) -> np.ndarray:
        if self._z is None:
            raise RuntimeError("GNNScorer.refresh(graph) must run before score()")
        child = np.asarray(child, np.int32)
        parent = np.asarray(parent, np.int32)
        feats = np.asarray(pair_feats, np.float32)
        n, e = self._z.shape
        head = self._model.head
        w1 = head.layers_0.weight.T  # [3e + Fp, H1]
        if w1.shape[0] != 3 * e + feats.shape[-1]:
            raise ValueError(
                f"head layer-1 kernel {tuple(w1.shape)} no longer matches the "
                f"[zc, zp, zc*zp, feats] split (e={e}, Fp={feats.shape[-1]}) — "
                "update GNNScorer's precompute decomposition"
            )
        # An out-of-range id would fire a device-side assert on the card and
        # take the CUDA context down with it; check on the host instead.
        for name, idx in (("child", child), ("parent", parent)):
            if idx.size and (idx.min() < 0 or idx.max() >= n):
                raise ValueError(f"{name} node index out of range for {n}-node graph")
        dev = self._device
        c = torch.from_numpy(child).to(dev)
        p = torch.from_numpy(parent).to(dev)
        f = torch.from_numpy(feats).to(dev)
        zc = self._z.index_select(0, c)
        zp = self._z.index_select(0, p)
        # f32 partial sum; bf16 rounding happens once, at the gelu input,
        # exactly where the single fused Dense rounds its output
        h = (
            self._uc.index_select(0, c)
            + self._up.index_select(0, p)
            + _dot_f32(zc * zp, w1[2 * e : 3 * e])
            + f @ w1[3 * e :]
            + head.layers_0.bias
        )
        v = h.to(self._model.dtype)
        for layer in list(head)[1:]:
            v = layer(v)
        out = torch.sigmoid(v.float().squeeze(-1))
        return out.cpu().numpy()

    def score_rounds(
        self, pair_feats: np.ndarray, *, child: np.ndarray, parent: np.ndarray
    ) -> np.ndarray:
        """Multi-round entry: [M, B, F] feats + [M, B] indices → [M, B].
        Rounds are independent, so the flattened [M*B] batch rides one head
        call, the one dispatch per flush the micro-batcher amortizes."""
        f = np.asarray(pair_feats, np.float32)
        m, b = f.shape[0], f.shape[1]
        flat = self.score(
            f.reshape(m * b, -1),
            child=np.asarray(child, np.int32).reshape(-1),
            parent=np.asarray(parent, np.int32).reshape(-1),
        )
        return flat.reshape(m, b)
