"""The native C++ scorer's artifact format, written by the port.

The port's own copy of ``export_scorer_artifact`` from
dragonfly2_tpu/native/scorer.py: the TopoScorer head weights and the cached
node embeddings flattened into ``scorer.dfsc``, the binary format the C++
batched scorer (``native/scorer.cc``) loads. Only the writer is copied here;
the ctypes loader waits for the slice that wires the port into the
scheduler.
"""

from __future__ import annotations

import struct
from pathlib import Path
from typing import Any

import numpy as np

_MAGIC = 0x44465343
_VERSION = 1


def export_scorer_artifact(params: Any, z: np.ndarray, path: str | Path) -> Path:
    """Write the binary scoring artifact: cached embeddings + head weights.

    params: the TopoScorer parameters as a flax tree ({'params': {'head':
    {'layers_0': ...}}}, ``models.weights.params_to_flax`` gives it);
    z: [N, D] float32 node embeddings from TopoScorer.embed.
    """
    head = params["params"]["head"]
    w1 = np.asarray(head["layers_0"]["kernel"], np.float32)
    b1 = np.asarray(head["layers_0"]["bias"], np.float32)
    w2 = np.asarray(head["layers_2"]["kernel"], np.float32)
    b2 = np.asarray(head["layers_2"]["bias"], np.float32)
    w3 = np.asarray(head["layers_4"]["kernel"], np.float32)
    b3 = np.asarray(head["layers_4"]["bias"], np.float32)
    z = np.ascontiguousarray(np.asarray(z, np.float32))

    n, d = z.shape
    in_dim, h1 = w1.shape
    fp = in_dim - 3 * d
    if fp < 0:
        raise ValueError(f"head input {in_dim} < 3*embed_dim {3*d}: wrong params/z pairing")
    if w2.shape != (h1, w2.shape[1]) or w3.shape[0] != w2.shape[1] or w3.shape[1] != 1:
        raise ValueError(f"unexpected head shapes: {w1.shape}, {w2.shape}, {w3.shape}")
    h2 = w2.shape[1]

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<7I", _MAGIC, _VERSION, n, d, fp, h1, h2))
        for arr in (z, w1, b1, w2, b2, w3, b3):
            f.write(np.ascontiguousarray(arr, np.float32).tobytes())
    tmp.replace(path)
    return path
