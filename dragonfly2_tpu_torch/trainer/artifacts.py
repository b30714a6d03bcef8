"""Model artifact (de)serialization for the registry, GNN half, in PyTorch.

The port of dragonfly2_tpu/trainer/artifacts.py. One artifact = one
directory: ``params.msgpack`` (the flax parameter tree, written and read by
the port's own msgpack codec, byte for byte what ``flax.serialization``
writes), ``config.json`` (model hyperparameters + type + version + format),
and beside them the GNN's ``graph.npz``/``hosts.json`` and ``scorer.dfsc``.
Either package reads what the other writes. ``artifact_digest`` covers every
file, so tampering with any of them fails ``verify_artifact`` before a
scorer attaches it.

Still to come with later slices: the MLP loader, ``load_native`` (the C++
scorer's ctypes binding), the training-reference feature sketch, and the
fault-injection hook that the JAX digest passes each file through.
"""

from __future__ import annotations

import copy
import hashlib
import json
from pathlib import Path
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.models.graphsage import TopoGraph, TopoScorer
from dragonfly2_tpu_torch.models.weights import params_from_flax, params_to_flax
from dragonfly2_tpu_torch.native.scorer import export_scorer_artifact
from dragonfly2_tpu_torch.trainer import _msgpack

# Bumped whenever the flax param-tree structure changes; loaders refuse
# mismatched artifacts with a clear error. 2: SAGELayer pre-projection
# decomposition (msg_nbr/msg_self/msg_edge). The same number as the JAX
# package's, since both read the same files.
ARTIFACT_FORMAT = 2


class IncompatibleArtifact(Exception):
    pass


class ArtifactIntegrityError(IOError):
    """The on-disk artifact does not match the registry row's digest:
    truncated, corrupt or partly written files must never attach to a live
    scorer."""


def artifact_digest(directory: str | Path) -> str:
    """Content digest of a whole artifact directory: sha256 over every
    regular file (sorted relative path + contents, length-framed so file
    boundaries can't alias). The JAX package's digest of the same directory
    is the same string."""
    d = Path(directory)
    h = hashlib.sha256()
    for f in sorted(p for p in d.rglob("*") if p.is_file()):
        data = f.read_bytes()
        rel = f.relative_to(d).as_posix().encode()
        h.update(len(rel).to_bytes(4, "big"))
        h.update(rel)
        h.update(len(data).to_bytes(8, "big"))
        h.update(data)
    return h.hexdigest()


def verify_artifact(directory: str | Path, expected_digest: str) -> None:
    """Raise ArtifactIntegrityError unless the directory's recomputed digest
    matches the registry row's. An empty expected digest (an unverified row)
    passes; the caller decides that policy."""
    if not expected_digest:
        return
    d = Path(directory)
    if not d.is_dir():
        raise FileNotFoundError(f"artifact directory {d} missing")
    got = artifact_digest(d)
    if got != expected_digest:
        raise ArtifactIntegrityError(
            f"artifact {d} digest mismatch: registry {expected_digest[:16]}…, "
            f"disk {got[:16]}… (truncated/corrupt artifact must not attach)"
        )


def _state_dict(params: nn.Module | Mapping[str, torch.Tensor]) -> Mapping[str, torch.Tensor]:
    return params.state_dict() if isinstance(params, nn.Module) else params


def save_artifact(
    directory: str | Path, *, model_type: str, version: str,
    params: nn.Module | Mapping[str, torch.Tensor], config: dict,
) -> Path:
    """Write ``params.msgpack`` (the module's or state_dict's parameters as
    the flax tree) and ``config.json``."""
    d = Path(directory)
    d.mkdir(parents=True, exist_ok=True)
    (d / "params.msgpack").write_bytes(_msgpack.to_bytes(params_to_flax(_state_dict(params))))
    (d / "config.json").write_text(
        json.dumps({"type": model_type, "version": version, "format": ARTIFACT_FORMAT, **config})
    )
    return d


def _check_format(cfg: dict, directory: Any) -> None:
    fmt = cfg.get("format", 1)
    if fmt != ARTIFACT_FORMAT:
        raise IncompatibleArtifact(
            f"artifact {directory} has format {fmt}, this build expects "
            f"{ARTIFACT_FORMAT}; retrain to republish"
        )


def load_config(directory: str | Path) -> dict:
    return json.loads((Path(directory) / "config.json").read_text())


def load_gnn(directory: str | Path) -> tuple[TopoScorer, "dict[str, torch.Tensor]"]:
    """The artifact's TopoScorer (widths from ``config.json``, parameters
    loaded, on the CPU) and its state_dict, ready for ``GNNScorer``. Raises
    IncompatibleArtifact for another type or format, and on a parameter tree
    that does not fit the model."""
    cfg = load_config(directory)
    if cfg.get("type") != "gnn":
        raise IncompatibleArtifact(f"artifact {directory} holds a {cfg.get('type')!r} model, not 'gnn'")
    _check_format(cfg, directory)
    model = TopoScorer(hidden=cfg["hidden"], embed_dim=cfg["embed_dim"], num_layers=cfg["num_layers"])
    sd = params_from_flax(_msgpack.from_bytes((Path(directory) / "params.msgpack").read_bytes()))
    try:
        model.load_state_dict(sd)
    except RuntimeError as e:
        raise IncompatibleArtifact(f"artifact {directory}: parameters do not fit its config: {e}") from e
    return model, sd


def _host_array(a: Any) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def save_graph(directory: str | Path, graph: TopoGraph, host_index: dict[bytes, int]) -> None:
    """Snapshot the topology graph + host→row mapping beside the GNN params:
    a scorer needs both to refresh embeddings and map live host ids to
    graph rows."""
    d = Path(directory)
    np.savez_compressed(
        d / "graph.npz",
        node_feats=_host_array(graph.node_feats),
        neighbors=_host_array(graph.neighbors),
        mask=_host_array(graph.mask),
        edge_feats=_host_array(graph.edge_feats),
    )
    (d / "hosts.json").write_text(
        json.dumps({k.decode("utf-8", "replace"): v for k, v in host_index.items()})
    )


def load_graph(directory: str | Path) -> tuple[TopoGraph, dict[str, int]]:
    d = Path(directory)
    with np.load(d / "graph.npz") as z:
        graph = TopoGraph(z["node_feats"], z["neighbors"], z["mask"], z["edge_feats"])
    host_index = json.loads((d / "hosts.json").read_text())
    return graph, {k: int(v) for k, v in host_index.items()}


def save_native(
    directory: str | Path, model: TopoScorer, params: nn.Module | Mapping[str, torch.Tensor],
    graph: TopoGraph, *, device: str | torch.device | None = None,
) -> Path:
    """Write ``scorer.dfsc`` beside the params: the node embeddings computed
    once with ``model.embed`` on ``device`` (the card unless one is named),
    then the head weights + embeddings in the C++ scorer's binary format."""
    dev = resolve_device(device)
    sd = _state_dict(params)
    m = copy.deepcopy(model).to(dev).eval()
    m.load_state_dict(sd)
    with torch.inference_mode():
        z = m.embed(graph.to(dev)).float().cpu().numpy()
    return export_scorer_artifact(params_to_flax(sd), z, Path(directory) / "scorer.dfsc")
