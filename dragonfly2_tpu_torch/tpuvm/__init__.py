"""Checkpoint staging for the port: the safetensors reader/writer and the
shard-aware staging onto the card or a mesh, the port of
dragonfly2_tpu/tpuvm/ (its P2P checkpoint fan-out, ``checkpoint.py``, is
not ported yet)."""

from dragonfly2_tpu_torch.tpuvm.safetensors import (
    read_header,
    read_header_ex,
    read_tensor,
    tensor_names,
    write_safetensors,
)

__all__ = [
    "read_header",
    "read_header_ex",
    "read_tensor",
    "tensor_names",
    "write_safetensors",
]
