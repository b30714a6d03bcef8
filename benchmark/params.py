"""The benchmark's weights in the two forms the port's entry points take:
a flax tree with numpy leaves (``train_gnn.init_state(params=...)``) and
a torch state_dict (``GNNScorer(model, state_dict)``). Kernels are [in,
out] in flax and [out, in] in torch; a LayerNorm ``scale`` is a torch
``weight``.
"""

from __future__ import annotations

from collections import OrderedDict

import torch


def torch_name(path: str) -> str:
    *mods, leaf = path.split("/")
    return ".".join(mods + ["weight" if leaf in ("kernel", "scale") else leaf])


def state_dict(p: dict[str, torch.Tensor]) -> "OrderedDict[str, torch.Tensor]":
    return OrderedDict(
        (torch_name(k), v.t().contiguous() if k.endswith("/kernel") else v) for k, v in p.items()
    )


def flax_tree(p: dict[str, torch.Tensor]) -> dict:
    tree: dict = {}
    for path, v in p.items():
        *mods, leaf = path.split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = v.detach().cpu().numpy()
    return {"params": tree}
