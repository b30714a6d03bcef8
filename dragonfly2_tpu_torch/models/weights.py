"""Carry parameters between the flax tree of the JAX package and the port.

A flax ``TopoScorer`` keeps its parameters as a nested dict under
``params``: ``encoder.Dense_0.{kernel, bias}``,
``encoder.SAGELayer_{i}.{msg_nbr, msg_self, msg_edge, Dense_0,
LayerNorm_0}``, ``encoder.Dense_1`` and ``head.layers_{0,2,4}``. The port's
modules carry the same names (models/graphsage.py), so the mapping is by
name alone: a Dense ``kernel`` [in, out] is a ``weight`` [out, in], a
LayerNorm ``scale`` is a ``weight``, a ``bias`` is a ``bias``.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

# flax leaf name -> torch parameter name (kernels are transposed)
_TO_TORCH = {"kernel": "weight", "scale": "weight", "bias": "bias"}


def params_from_flax(tree: Mapping[str, Any]) -> "OrderedDict[str, torch.Tensor]":
    """A flax parameter tree (``{"params": {...}}`` or its inside; numpy
    leaves, or anything ``np.asarray`` reads) as the port's state_dict."""
    tree = tree.get("params", tree)
    out: OrderedDict[str, torch.Tensor] = OrderedDict()

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for key, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{key}.")
                continue
            if key not in _TO_TORCH:
                raise KeyError(f"unexpected flax parameter {prefix}{key}")
            arr = np.asarray(val, np.float32)  # dflint: disable=DF033 one parameter tensor per leaf, not a row
            if key == "kernel":
                arr = arr.T
            out[f"{prefix}{_TO_TORCH[key]}"] = torch.from_numpy(np.array(arr, order="C"))

    walk(tree, "")
    return out


def full_state_dict(params: nn.Module | Mapping[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    """A module's or state_dict's tensors, each DTensor gathered to its full
    tensor (``full_tensor()``, a collective: on a mesh every rank calls
    this alike), so a model trained on a mesh gives what one device would."""
    sd = params.state_dict() if isinstance(params, nn.Module) else params
    return OrderedDict((k, v.full_tensor() if hasattr(v, "full_tensor") else v) for k, v in sd.items())


def params_to_flax(params: nn.Module | Mapping[str, torch.Tensor]) -> dict:
    """The inverse of ``params_from_flax``: a module or state_dict as the
    flax tree ``{"params": {...}}`` with float32 numpy leaves (DTensors
    gathered, as ``full_state_dict`` does)."""
    sd = full_state_dict(params)
    tree: dict = {}
    for name, val in sd.items():
        *path, leaf = name.split(".")
        arr = val.detach().to("cpu", torch.float32).numpy()
        if leaf == "weight":
            leaf, arr = ("kernel", arr.T) if arr.ndim == 2 else ("scale", arr)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = np.ascontiguousarray(arr)
    return {"params": tree}


def _truncated_normal(rng: np.random.Generator, shape: tuple[int, ...]) -> np.ndarray:
    """Standard normal samples redrawn until they lie in [-2, 2]."""
    x = rng.standard_normal(shape)
    bad = np.abs(x) > 2.0
    while bad.any():
        x[bad] = rng.standard_normal(int(bad.sum()))
        bad = np.abs(x) > 2.0
    return x


def init_flax_like(model: nn.Module, seed: int = 0) -> dict:
    """Fresh parameters for ``model`` in flax's tree and at flax's init scale.

    Dense kernels are lecun_normal (a normal truncated at ±2 std, scaled to
    variance 1/fan_in), biases 0, LayerNorm scales 1. Drawn with numpy from
    ``seed``: the numbers differ from ``jax.random``'s, the distribution
    does not. Returns ``{"params": {...}}`` with float32 numpy leaves.
    """
    rng = np.random.default_rng(seed)
    sd: OrderedDict[str, torch.Tensor] = OrderedDict()
    for name, val in model.state_dict().items():
        if name.endswith(".weight") and val.dim() == 2:
            fan_in = val.shape[1]
            std = np.sqrt(1.0 / fan_in) / 0.87962566103423978  # std of N(0,1) cut at ±2
            arr = _truncated_normal(rng, (val.shape[1], val.shape[0])).T * std
        elif name.endswith(".weight"):
            arr = np.ones(tuple(val.shape))
        else:
            arr = np.zeros(tuple(val.shape))
        sd[name] = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    return params_to_flax(sd)
