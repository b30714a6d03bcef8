"""Parity of the port's safetensors reader/writer and unsharded staging with
the JAX package's (tpuvm/).

The same numpy tensors from a seed go through both writers (byte for byte
the same file) and both stagers (bit for bit the same values), f32 and
BF16. Sharded staging needs a process group and is held to JAX's in the
four-rank launch of tests/test_torch_parallel.py; here its slicing rule is
held to ``torch.chunk``, which DTensor's ``Shard`` follows.
"""

import ml_dtypes
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from dragonfly2_tpu.tpuvm import safetensors as jax_st
from dragonfly2_tpu.tpuvm import staging as jax_staging
from dragonfly2_tpu_torch.tpuvm import safetensors as st
from dragonfly2_tpu_torch.tpuvm import staging

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools, and torch's default of one thread per core
# oversubscribes them (on an 8-core host a 1.9 s training test took 116 s).
torch.set_num_threads(1)


def _tensors():
    rng = np.random.default_rng(3)
    bf16 = rng.standard_normal((8, 12)).astype(np.float32).astype(ml_dtypes.bfloat16)
    return {
        "layers.0.w": rng.standard_normal((16, 32)).astype(np.float32),
        "layers.0.b": rng.standard_normal((32,)).astype(np.float32),
        "tok.embed": rng.integers(0, 100, size=(10, 4)).astype(np.int32),
        "scalar": np.float64(2.5).reshape(()),
        "mask": rng.random((3, 5)) < 0.5,
        "w_bf16": bf16.view(np.uint16),
    }


def test_writer_is_byte_equal_to_jax(tmp_path):
    tensors = _tensors()
    kw = dict(metadata={"format": "pt", "v": "1"}, bf16_names=["w_bf16"])
    mine = st.write_safetensors(tmp_path / "port.safetensors", tensors, **kw)
    theirs = jax_st.write_safetensors(tmp_path / "jax.safetensors", tensors, **kw)
    assert mine.read_bytes() == theirs.read_bytes()
    assert st.read_header(theirs) == jax_st.read_header(theirs)
    assert st.tensor_names(theirs) == jax_st.tensor_names(theirs)
    for name, want in tensors.items():
        got = st.read_tensor(theirs, name)
        assert got.dtype == want.dtype and got.tobytes() == np.ascontiguousarray(want).tobytes()


@pytest.mark.parametrize("name", ["layers.0.w", "w_bf16", "tok.embed", "mask"])
def test_stage_tensor_is_bit_equal_to_jax(tmp_path, name):
    tensors = _tensors()
    path = st.write_safetensors(tmp_path / "m.safetensors", tensors, bf16_names=["w_bf16"])
    got = staging.stage_tensor(path, name, device="cpu")
    want = np.asarray(jax_staging.stage_tensor(path, name))
    if name == "w_bf16":
        assert got.dtype == torch.bfloat16 and want.dtype == ml_dtypes.bfloat16
        assert got.view(torch.int16).numpy().tobytes() == want.tobytes() == tensors[name].tobytes()
    else:
        assert got.numpy().dtype == want.dtype and got.numpy().tobytes() == want.tobytes()
    assert tuple(got.shape) == want.shape
    if got.dtype == torch.bool:  # a writable copy, not the memmap
        got.logical_not_()
    else:
        got.add_(1)
    assert st.read_tensor(path, name).tobytes() == tensors[name].tobytes()


def test_stage_tensors_matches_jax_and_empty_names_stage_nothing(tmp_path):
    tensors = _tensors()
    path = st.write_safetensors(tmp_path / "m.safetensors", tensors, bf16_names=["w_bf16"])
    assert staging.stage_tensors(path, names=[], device="cpu") == {} == jax_staging.stage_tensors(path, names=[])
    got = staging.stage_tensors(path, device="cpu")
    want = jax_staging.stage_tensors(path)
    assert got.keys() == want.keys() == tensors.keys()
    for name, t in got.items():
        t = (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy()
        assert t.tobytes() == tensors[name].tobytes()
        w = np.asarray(want[name])  # dflint: disable=DF033 one staged tensor per name, not a row
        if name != "scalar":  # JAX without x64 narrows F64 to f32; the port keeps it
            assert t.tobytes() == (w.view(np.int16) if w.dtype == ml_dtypes.bfloat16 else w).tobytes()


def test_corrupt_headers_are_rejected(tmp_path):
    bad = tmp_path / "bad.safetensors"
    bad.write_bytes(b"\xff" * 4)
    with pytest.raises(st.SafetensorsError):
        st.read_header(bad)
    huge = tmp_path / "huge.safetensors"
    huge.write_bytes((200 << 20).to_bytes(8, "little"))
    with pytest.raises(st.SafetensorsError):
        st.read_header(huge)
    path = st.write_safetensors(tmp_path / "m.safetensors", {"x": np.zeros(4, np.float32)})
    with pytest.raises(st.SafetensorsError):
        staging.stage_tensor(path, "missing", device="cpu")
    with pytest.raises(st.SafetensorsError):
        st.write_safetensors(tmp_path / "w.safetensors", {"x": np.zeros(2, np.float32)}, bf16_names=["x"])


def test_checkpoint_dir_merges_files_and_rejects_duplicates(tmp_path):
    d = tmp_path / "ck"
    d.mkdir()
    st.write_safetensors(d / "a.safetensors", {"x": np.zeros(4, np.float32)})
    st.write_safetensors(d / "b.safetensors", {"y": np.ones(4, np.float32)})
    out = staging.stage_checkpoint_dir(d, device="cpu")
    assert sorted(out) == sorted(jax_staging.stage_checkpoint_dir(d)) == ["x", "y"]
    assert torch.equal(out["y"], torch.ones(4))
    st.write_safetensors(d / "c.safetensors", {"x": np.zeros(2, np.float32)})
    with pytest.raises(ValueError, match="duplicate"):
        staging.stage_checkpoint_dir(d, device="cpu")
    with pytest.raises(ValueError):
        jax_staging.stage_checkpoint_dir(d)
    with pytest.raises(FileNotFoundError):
        staging.stage_checkpoint_dir(tmp_path / "empty", device="cpu")


def test_staging_goes_to_the_card_unless_asked_and_placements_need_a_mesh(tmp_path):
    path = st.write_safetensors(tmp_path / "m.safetensors", {"x": np.zeros(4, np.float32)})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            staging.stage_tensor(path, "x")
    with pytest.raises(ValueError, match="mesh"):
        staging.stage_tensor(path, "x", placements=(Shard(0), Replicate()))


class _Layout:
    """The two calls ``local_slices`` makes of a DeviceMesh, with no group."""

    def __init__(self, shape, coordinate):
        self.shape, self.coordinate = shape, coordinate

    def get_coordinate(self):
        return list(self.coordinate)

    def size(self, mesh_dim):
        return self.shape[mesh_dim]


@pytest.mark.parametrize("placements", [(Shard(0), Shard(1)), (Shard(1), Replicate()), (Shard(0), Shard(0)),
                                        (Replicate(), Replicate()), (Replicate(), Shard(-1))],
                         ids=["data_model", "cols_over_data", "rows_over_both", "replicated", "negative_dim"])
def test_local_slices_split_as_torch_chunk(placements):
    """Uneven shapes too: torch.chunk's sizes, the last chunks shorter or
    empty, nested where two mesh dims shard one tensor dim."""
    shape, mesh_shape = (10, 7), (3, 2)
    full = torch.arange(70).reshape(shape)
    for c0 in range(mesh_shape[0]):
        for c1 in range(mesh_shape[1]):
            want = full
            for mesh_dim, pl in enumerate(placements):
                if pl.is_shard():
                    chunks = torch.chunk(want, mesh_shape[mesh_dim], dim=pl.dim)
                    c = (c0, c1)[mesh_dim]
                    want = chunks[c] if c < len(chunks) else want.narrow(pl.dim % 2, 0, 0)
            got = full[staging.local_slices(shape, _Layout(mesh_shape, (c0, c1)), placements)]
            assert torch.equal(got, want), (placements, c0, c1)

