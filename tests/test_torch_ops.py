"""Parity of the PyTorch port's neighbour-aggregation ops with the JAX package.

The K1 plain version (``neighbor_agg_cuda.neighbor_aggregate_torch``) is held
against the Pallas kernel in interpret mode and against the XLA path, on
tests/test_ops.py's cases and tolerances; K2's plain version
(``neighbor_aggregate_bwd_torch``) against the Pallas kernel's custom VJP
``_agg_bwd``, and the gradient of ``neighbor_aggregate`` against
``jax.grad`` through the Pallas kernel; the plain ops (gather, masked mean,
segment mean) against their JAX counterparts. Inputs are numpy arrays from
a seed, handed to both packages. The CUDA kernels themselves run only on a
card: tests/test_torch_cuda.py holds them against these plain versions there.
"""

import os
import stat

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dragonfly2_tpu.ops import neighbor_agg as jax_agg
from dragonfly2_tpu.ops.neighbor_agg_pallas import _agg_bwd, neighbor_aggregate_pallas
from dragonfly2_tpu_torch.ops import _build, neighbor_agg, neighbor_agg_cuda

# tests/test_ops.py's tolerances for the Pallas kernel against XLA
TOL = {np.float32: dict(rtol=2e-4, atol=2e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _random_graph(n=100, k=7, h=33, seed=0):
    rng = np.random.default_rng(seed)
    states = rng.normal(size=(n, h)).astype(np.float32)
    neighbors = rng.integers(0, n, size=(n, k)).astype(np.int32)
    mask = (rng.random((n, k)) < 0.7).astype(np.float32)
    return states, neighbors, mask


def _case(name):
    """(h, neighbors, mask, dtype, compare_with_xla) for one named case."""
    shapes = {"100x7x33": (100, 7, 33), "128x16x256": (128, 16, 256),
              "257x4x64": (257, 4, 64), "1x2x8": (1, 2, 8)}
    if name in shapes:
        return (*_random_graph(*shapes[name]), np.float32, True)
    if name == "fully_masked_row":
        h, nbr, mask = _random_graph(64, 4, 16)
        mask[3] = 0.0
        return h, nbr, mask, np.float32, True
    if name == "duplicates":
        h = np.arange(12, dtype=np.float32).reshape(3, 4)
        return h, np.array([[1, 1], [0, 2], [0, 1]], np.int32), np.ones((3, 2), np.float32), np.float32, True
    if name == "bfloat16":
        return (*_random_graph(128, 8, 64), "bfloat16", True)
    if name == "fractional_mask":
        h, nbr, _ = _random_graph(96, 6, 24, seed=3)
        mask = np.random.default_rng(4).random((96, 6)).astype(np.float32)
        return h, nbr, mask, np.float32, True
    if name == "out_of_range":
        # XLA's take fills out-of-range rows with NaN, so only the Pallas
        # kernel's rule (no contribution, the mask still counts) applies
        h, nbr, mask = _random_graph(50, 6, 32, seed=5)
        nbr[0, 0], mask[0, 0] = 55, 0.0
        nbr[1, 0], mask[1, 0] = -3, 1.0
        nbr[2, 1], mask[2, 1] = 50, 1.0
        return h, nbr, mask, np.float32, False
    raise KeyError(name)


CASES = ["100x7x33", "128x16x256", "257x4x64", "1x2x8", "fully_masked_row",
         "duplicates", "bfloat16", "fractional_mask", "out_of_range"]


def _to_torch(h, nbr, mask, dtype):
    th = torch.from_numpy(h)
    if dtype == "bfloat16":
        th = th.to(torch.bfloat16)
    return th, torch.from_numpy(nbr), torch.from_numpy(mask)


def _to_jax(h, nbr, mask, dtype):
    jh = jnp.asarray(h)
    if dtype == "bfloat16":
        jh = jh.astype(jnp.bfloat16)
    return jh, jnp.asarray(nbr), jnp.asarray(mask)


@pytest.mark.parametrize("name", CASES)
def test_k1_plain_version_matches_pallas_and_xla(name):
    h, nbr, mask, dtype, with_xla = _case(name)
    got = neighbor_agg_cuda.neighbor_aggregate_torch(*_to_torch(h, nbr, mask, dtype))
    assert got.shape == h.shape
    assert got.dtype == (torch.bfloat16 if dtype == "bfloat16" else torch.float32)
    got = got.float().numpy()
    jh, jn, jm = _to_jax(h, nbr, mask, dtype)
    pallas = np.asarray(neighbor_aggregate_pallas(jh, jn, jm, interpret=True), np.float32)
    np.testing.assert_allclose(got, pallas, **TOL[dtype])
    if with_xla:
        xla = np.asarray(jax_agg.neighbor_aggregate(jh, jn, jm, impl="xla"), np.float32)
        np.testing.assert_allclose(got, xla, **TOL[dtype])
    if name == "fully_masked_row":
        assert np.all(got[3] == 0.0)
    if name == "duplicates":
        np.testing.assert_allclose(got[0], h[1], rtol=1e-5)


# the gradient cases: test_ops.py's gradient test (96x5x24), and the cases the
# backward's scatter must get right
GRAD_CASES = ["96x5x24", "100x7x33", "fully_masked_row", "duplicates", "bfloat16",
              "fractional_mask", "out_of_range"]
# tests/test_ops.py:65's tolerance for the f32 gradient; bf16 as its forward
GRAD_TOL = {np.float32: dict(rtol=1e-3, atol=1e-5), "bfloat16": dict(rtol=3e-2, atol=3e-2)}


def _grad_case(name):
    if name == "96x5x24":
        return (*_random_graph(96, 5, 24), np.float32)
    h, nbr, mask, dtype, _ = _case(name)
    return h, nbr, mask, dtype


@pytest.mark.parametrize("name", GRAD_CASES)
def test_k1_gradient_matches_pallas_custom_vjp(name):
    """d/dh sum(neighbor_aggregate(h)**2) through NeighborAggregate against
    jax.grad through the Pallas kernel (interpret mode) and its _agg_bwd."""
    h, nbr, mask, dtype = _grad_case(name)
    th, tn, tm = _to_torch(h, nbr, mask, dtype)
    th.requires_grad_()
    out = neighbor_agg.neighbor_aggregate(th, tn, tm)
    assert out.requires_grad and out.grad_fn is not None
    (out**2).sum().backward()
    jh, jn, jm = _to_jax(h, nbr, mask, dtype)
    want = jax.grad(lambda a: jnp.sum(neighbor_aggregate_pallas(a, jn, jm, interpret=True) ** 2))(jh)
    assert th.grad.dtype == th.dtype and th.grad.shape == th.shape
    np.testing.assert_allclose(th.grad.float().numpy(), np.asarray(want, np.float32), **GRAD_TOL[dtype])


@pytest.mark.parametrize("name", GRAD_CASES)
def test_k2_plain_version_matches_jax_agg_bwd(name):
    h, nbr, mask, dtype = _grad_case(name)
    g = np.random.default_rng(7).normal(size=h.shape).astype(np.float32)
    tg, tn, tm = _to_torch(g, nbr, mask, dtype)
    got = neighbor_agg_cuda.neighbor_aggregate_bwd_torch(tg, tn, tm, h.shape[0])
    assert got.dtype == tg.dtype and got.shape == h.shape
    jg, jn, jm = _to_jax(g, nbr, mask, dtype)
    want, none_nbr, none_mask = _agg_bwd(1e-6, True, (h.shape, jn, jm), jg)
    assert none_nbr is None and none_mask is None  # no gradient for the table or the mask
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **TOL[dtype])
    named = np.zeros(h.shape[0], bool)
    named[nbr[(mask != 0) & (nbr >= 0) & (nbr < h.shape[0])]] = True
    assert np.all(got.float().numpy()[~named] == 0.0)  # a node no live slot names gets exactly 0


def test_neighbor_gather_matches_jax():
    h, nbr, _ = _random_graph(40, 5, 12, seed=1)
    got = neighbor_agg.neighbor_gather(torch.from_numpy(h), torch.from_numpy(nbr))
    want = jax_agg.neighbor_gather(jnp.asarray(h), jnp.asarray(nbr))
    assert got.shape == (40, 5, 12)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_masked_mean_matches_jax(dtype):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(30, 6, 10)).astype(np.float32)
    mask = (rng.random((30, 6)) < 0.6).astype(np.float32)
    mask[0] = 0.0
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = neighbor_agg.masked_mean(tx, torch.from_numpy(mask).to(tx.dtype))
    want = jax_agg.masked_mean(jx, jnp.asarray(mask).astype(jx.dtype))
    assert got.dtype == tx.dtype
    tol = dict(rtol=1e-6, atol=1e-6) if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    assert np.all(got[0].float().numpy() == 0.0)


def test_segment_mean_matches_jax():
    rng = np.random.default_rng(3)
    values = rng.normal(size=(50, 4)).astype(np.float32)
    ids = rng.integers(0, 8, 50).astype(np.int32)
    ids[:3] = [10, -1, 12]  # outside [0, 10): dropped, as segment_sum drops them
    got = neighbor_agg.segment_mean(torch.from_numpy(values), torch.from_numpy(ids), 10)
    want = jax_agg.segment_mean(jnp.asarray(values), jnp.asarray(ids), 10)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    assert np.all(got[8:].numpy() == 0.0)  # empty segments


def test_auto_dispatch_on_cpu_takes_plain_version():
    h, nbr, mask = (torch.from_numpy(a) for a in _random_graph(32, 4, 8))
    before = (neighbor_agg_cuda.LAUNCHES, neighbor_agg_cuda.BWD_LAUNCHES)
    out = neighbor_agg.neighbor_aggregate(h, nbr, mask)
    assert torch.equal(out, neighbor_agg_cuda.neighbor_aggregate_torch(h, nbr, mask))
    hg = h.clone().requires_grad_()
    neighbor_agg.neighbor_aggregate(hg, nbr, mask).sum().backward()
    assert torch.equal(hg.grad, neighbor_agg_cuda.neighbor_aggregate_bwd_torch(torch.ones_like(h), nbr, mask, 32))
    assert (neighbor_agg_cuda.LAUNCHES, neighbor_agg_cuda.BWD_LAUNCHES) == before
    plain = neighbor_agg.neighbor_aggregate(h, nbr, mask, impl="torch")
    assert torch.equal(plain, neighbor_agg.masked_mean(neighbor_agg.neighbor_gather(h, nbr), mask))
    np.testing.assert_allclose(out.numpy(), plain.numpy(), rtol=1e-5, atol=1e-6)


def test_cuda_impl_on_cpu_tensor_raises_without_building(monkeypatch):
    def no_build(name):
        raise AssertionError("the kernel must not be built for a CPU tensor")

    monkeypatch.setattr(_build, "load", no_build)
    h, nbr, mask = (torch.from_numpy(a) for a in _random_graph(8, 2, 4))
    before = (neighbor_agg_cuda.LAUNCHES, neighbor_agg_cuda.BWD_LAUNCHES)
    with pytest.raises(RuntimeError, match="CUDA"):
        neighbor_agg.neighbor_aggregate(h, nbr, mask, impl="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        neighbor_agg_cuda.neighbor_aggregate_cuda(h, nbr, mask)
    with pytest.raises(RuntimeError, match="CUDA"):
        neighbor_agg_cuda.neighbor_aggregate_bwd_cuda(h, nbr, mask, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        neighbor_agg.neighbor_aggregate(h.clone().requires_grad_(), nbr, mask, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        neighbor_agg.neighbor_aggregate(h, nbr, mask, impl="pallas")
    assert (neighbor_agg_cuda.LAUNCHES, neighbor_agg_cuda.BWD_LAUNCHES) == before


def _fake_nvcc(tmp_path, body):
    bindir = tmp_path / "cuda" / "bin"
    bindir.mkdir(parents=True)
    nvcc = bindir / "nvcc"
    nvcc.write_text("#!/bin/sh\n" + body)
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    return nvcc


def test_build_finds_nvcc_keys_on_source_and_caches(tmp_path, monkeypatch):
    # a stand-in nvcc that writes its -o target: the build logic without a toolkit
    nvcc = _fake_nvcc(tmp_path, 'while [ "$1" != "-o" ]; do shift; done; echo "ptxas info : Used 8 registers"; : > "$2"\n')
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("// v1\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    assert _build.find_nvcc() == str(nvcc)
    assert _build.sources() == ["k"]
    first = _build.build("k")
    assert first["path"].exists() and "registers" in first["log"]
    assert _build.build("k")["seconds"] == 0.0  # built already: reused
    old = _build.library_path("k")
    (csrc / "k.cu").write_text("// v2\n")
    assert _build.library_path("k") != old
    assert not os.path.exists(_build.library_path("k"))


def test_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    _fake_nvcc(tmp_path, 'echo "k.cu(3): error: identifier undefined"; exit 2\n')
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text("broken\n")
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="identifier undefined"):
        _build.build("k")
    assert list((tmp_path / "build").iterdir()) == []
