"""Shard-aware staging: safetensors file(s) → tensors on the device, or
DTensors over a mesh.

The port of dragonfly2_tpu/tpuvm/staging.py. With placements, each rank
reads only its own slice of the memmap and builds the DTensor from it
(``DTensor.from_local``), as ``jax.make_array_from_callback`` reads per
shard: a host faults in only the pages its mesh slice covers, with no
whole-tensor host copy and no whole-checkpoint RAM spike.

BF16 tensors travel as uint16 raw bits (numpy has no bfloat16); they are
viewed as int16 (the same bits) and bit-cast to ``torch.bfloat16``. The
memmap is read-only, so each slice is copied once before torch sees it: for
a card into a pinned host buffer, which then goes over with a non-blocking
copy; for the CPU into an ordinary array.
"""

from __future__ import annotations

import logging
import math
from pathlib import Path
from typing import Any, Callable, Mapping

import numpy as np
import torch

from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.parallel import mesh as meshlib
from dragonfly2_tpu_torch.tpuvm import safetensors as stlib

logger = logging.getLogger(__name__)

Placements = Mapping[str, Any] | Callable[[str], Any] | None


def local_slices(shape: tuple[int, ...], mesh, placements) -> tuple[slice, ...]:
    """This rank's slice of a global tensor of ``shape`` under
    ``placements`` (``Shard`` or ``Replicate`` per mesh dim), split as
    DTensor's ``Shard`` splits: ``torch.chunk`` sizes, the last chunks
    shorter or empty."""
    coord = mesh.get_coordinate()
    ranges = [(0, n) for n in shape]
    for mesh_dim, pl in enumerate(placements):
        if pl.is_replicate():
            continue
        if not pl.is_shard():
            raise ValueError(f"cannot stage a tensor with placement {pl}")
        d = pl.dim % len(shape)
        lo, hi = ranges[d]
        chunk = math.ceil((hi - lo) / mesh.size(mesh_dim))
        start = min(lo + coord[mesh_dim] * chunk, hi)
        ranges[d] = (start, min(start + chunk, hi))
    return tuple(slice(lo, hi) for lo, hi in ranges)


def _copy_to(arr: np.ndarray, is_bf16: bool, dev: torch.device) -> torch.Tensor:
    """One copy of a (memmap) slice onto ``dev``: through a pinned buffer
    and a non-blocking copy for a card, into a writable array for the CPU."""
    if is_bf16:
        arr = arr.view(np.int16)  # the same bits; torch views int16 as bfloat16
    if dev.type == "cuda":
        host = torch.empty(arr.shape, dtype=torch.from_numpy(np.empty(0, arr.dtype)).dtype, pin_memory=True)
        host.numpy()[...] = arr
        t = host.to(dev, non_blocking=True)
    else:
        t = torch.from_numpy(np.array(arr)).to(dev)
    return t.view(torch.bfloat16) if is_bf16 else t


def stage_tensor(
    path: str | Path,
    name: str,
    *,
    mesh=None,
    placements=None,
    device: str | torch.device | None = None,
    header: dict | None = None,
    data_start: int | None = None,
):
    """Stage one tensor. With ``placements`` (on ``mesh``) this rank reads
    only its local slice and gets the global DTensor; without, the tensor
    lands whole on ``device`` (the card unless one is named)."""
    from torch.distributed.tensor import DTensor

    path = Path(path)
    if header is None or data_start is None:
        header, data_start = stlib.read_header_ex(path)
    mm = stlib.read_tensor(path, name, header=header, data_start=data_start)
    is_bf16 = header[name]["dtype"] == "BF16"
    if placements is None:
        return _copy_to(mm, is_bf16, resolve_device(device))
    if mesh is None or device is not None:
        raise ValueError("placements need a mesh, whose device a sharded tensor goes to")
    local = _copy_to(mm[local_slices(mm.shape, mesh, placements)], is_bf16, meshlib.mesh_device(mesh))
    shape = torch.Size(mm.shape)
    return DTensor.from_local(local, mesh, placements, run_check=False, shape=shape,
                              stride=meshlib.contiguous_stride(shape))


def stage_tensors(
    path: str | Path,
    *,
    mesh=None,
    placements: Placements = None,
    names: list[str] | None = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Stage many tensors from one safetensors file.

    placements: dict (missing names → whole on ``device``) or callable
    name → placements (None → whole).
    """
    path = Path(path)
    header, data_start = stlib.read_header_ex(path)
    out: dict[str, Any] = {}
    if names is None:  # [] means "none requested", not "all"
        names = [k for k in header if k != "__metadata__"]
    for name in names:
        if callable(placements):
            pl = placements(name)
        elif placements is not None:
            pl = placements.get(name)
        else:
            pl = None
        out[name] = stage_tensor(path, name, mesh=mesh, placements=pl, device=None if pl else device,
                                 header=header, data_start=data_start)
    return out


def stage_checkpoint_dir(
    directory: str | Path,
    *,
    mesh=None,
    placements: Placements = None,
    device: str | torch.device | None = None,
) -> dict[str, Any]:
    """Stage every *.safetensors file in a fetched checkpoint directory into
    one flat {tensor_name: tensor} dict (multi-file checkpoints store
    disjoint tensor sets per file); a name in two files raises."""
    directory = Path(directory)
    out: dict[str, Any] = {}
    files = sorted(directory.rglob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {directory}")
    for f in files:
        tensors = stage_tensors(f, mesh=mesh, placements=placements, device=device)
        overlap = out.keys() & tensors.keys()
        if overlap:
            raise ValueError(f"{f}: duplicate tensors across files: {sorted(overlap)[:3]}")
        out.update(tensors)
    logger.info("staged %d tensors from %d files", len(out), len(files))
    return out
