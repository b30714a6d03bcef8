"""Device mesh + placement rules for the trainer, on torch.distributed.

The port of dragonfly2_tpu/parallel/mesh.py. Axes, as in the JAX package:

  data  — data parallelism: training pairs and graph node rows are
          row-sharded here; DTensor all-gathers node rows where the
          neighbour gather needs them and sums gradients over it.
  model — tensor parallelism: Dense weights sharded on the output dim.

A mesh is a ``DeviceMesh`` over an initialized process group, one process
per device (parallel/distributed.py). ``make_mesh`` raises without a group:
there is no quiet single-device mesh. The placement rules are pure
functions of a tensor's shape and the mesh's (dp, tp) shape, so the tests
hold them to JAX's ``param_leaf_sharding`` without any group.
"""

from __future__ import annotations

import math
from typing import Any, Mapping, Sequence

import torch
from torch import nn
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"


def mesh_shape(n: int, model_parallel: int | None = None) -> tuple[int, int]:
    """(dp, tp) for ``n`` devices, by the JAX ``make_mesh`` rule:
    ``model_parallel`` defaults to the largest of 2 and 4 that divides n
    (tp stays small, dp takes the rest); a tp that does not divide n raises."""
    if model_parallel is None:
        model_parallel = 1
        for cand in (2, 4):
            if n % cand == 0 and cand <= n:
                model_parallel = cand
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return n // model_parallel, model_parallel


def make_mesh(model_parallel: int | None = None):
    """A ("data", "model") ``DeviceMesh`` over every rank of the initialized
    process group, of ``mesh_shape(world_size, model_parallel)``; rank r sits
    at (r // tp, r % tp). The device type follows the group's backend: NCCL
    gives "cuda", gloo "cpu". Raises RuntimeError when no group is
    initialized."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "no process group is initialized: call parallel.distributed.initialize() first"
        )
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(
        device_type, mesh_shape(dist.get_world_size(), model_parallel),
        mesh_dim_names=(DATA_AXIS, MODEL_AXIS),
    )


def axis_sizes(mesh: Any) -> tuple[int, int]:
    """(dp, tp) of a ``DeviceMesh``, or of a ``(dp, tp)`` pair as given."""
    dp, tp = mesh if isinstance(mesh, Sequence) else mesh.shape
    return int(dp), int(tp)


def param_leaf_placements(leaf: Any, mesh: Any) -> tuple:
    """Tensor-parallel rule for one parameter (or optimizer-state) tensor:
    a 2-D weight shards its output dim over "model" when tp divides it, a
    1-D leaf of more than one element (bias, LayerNorm scale or bias) the
    same; anything else is replicated. Parameters are always replicated
    over "data". ``leaf`` is a tensor or a shape; ``mesh`` a ``DeviceMesh``
    or a ``(dp, tp)`` pair.

    A torch weight is [out, in], the transpose of flax's kernel, so JAX's
    ``P(None, "model")`` on the kernel is ``Shard(0)`` here. A "model" axis
    of one device holds every tensor whole, so there the rule replicates:
    JAX's spec on such an axis is the same fully replicated layout, and
    DTensor refuses some views (the head's ``squeeze(-1)``) of a dim sharded
    over one device.
    """
    shape = tuple(getattr(leaf, "shape", leaf))
    _, tp = axis_sizes(mesh)
    if tp == 1:
        return (Replicate(), Replicate())
    if len(shape) == 2 and shape[0] % tp == 0:
        return (Replicate(), Shard(0))
    if len(shape) == 1 and shape[0] > 1 and shape[0] % tp == 0:
        return (Replicate(), Shard(0))
    return (Replicate(), Replicate())


def infer_param_placements(params: nn.Module | Mapping[str, torch.Tensor], mesh: Any) -> dict[str, tuple]:
    """``param_leaf_placements`` for every named parameter of a module or
    state_dict."""
    named = params.named_parameters() if isinstance(params, nn.Module) else params.items()
    return {name: param_leaf_placements(t, mesh) for name, t in named}


def graph_placements(mesh: Any) -> tuple:
    """Placements of the four TopoGraph fields: node rows over "data"."""
    row = batch_placements(mesh)
    return (row, row, row, row)  # node_feats, neighbors, mask, edge_feats


def batch_placements(mesh: Any) -> tuple:
    """Rows over "data", whole on each rank of "model"."""
    del mesh
    return (Shard(0), Replicate())


def replicated(mesh: Any) -> tuple:
    del mesh
    return (Replicate(), Replicate())


def mesh_device(mesh) -> torch.device:
    """This rank's device on the mesh: for a CUDA mesh the card that
    ``distributed.initialize`` gave the rank (rank % device count), in any
    thread (CUDA's current device is per thread)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", mesh.get_rank() % torch.cuda.device_count())
    return torch.device(mesh.device_type)


def contiguous_stride(shape: Sequence[int]) -> tuple[int, ...]:
    """The strides of a contiguous tensor of ``shape``."""
    stride, acc = [], 1
    for n in reversed(tuple(shape)):
        stride.append(acc)
        acc *= n
    return tuple(reversed(stride))


def pad_to_multiple(n: int, multiple: int) -> int:
    return int(math.ceil(n / multiple) * multiple)
