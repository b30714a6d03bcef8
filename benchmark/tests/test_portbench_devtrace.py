"""Reduction of a profiler trace: the busy union, GEMM against other
kernels, and idle gaps labelled by the host's ranges."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import devtrace  # noqa: E402


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def trace():
    return [
        ev("user_annotation", "bench.slice", 1000, 1000),
        ev("user_annotation", "bench.multi_step", 1000, 600),
        ev("cpu_op", "aten::mm", 1010, 20),
        ev("user_annotation", "bench.pull", 1650, 350),
        ev("cuda_runtime", "cudaMemcpyAsync", 1660, 290),
        ev("kernel", "sm90_xmma_gemm_bf16bf16_bf16f32", 1100, 100),  # GEMM
        ev("kernel", "nvjet_tst_128x256_64x4", 1150, 100),  # GEMM, overlaps the first
        ev("kernel", "void at::native::vectorized_elementwise_kernel<4>", 1300, 200),
        ev("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 1900, 50),
        ev("kernel", "outside", 5000, 10),  # after the slice
        ev("kernel", "straddles", 1990, 20),  # ends after the slice: clipped
    ]


def test_busy_is_the_union_of_device_spans_in_the_slice():
    r = devtrace.reduce(trace())
    assert r["window_s"] == pytest.approx(1000e-6)
    # [1100, 1250] + [1300, 1500] + [1900, 1950] + [1990, 2000]
    assert r["busy_s"] == pytest.approx(410e-6)
    assert r["gemm_s"] == pytest.approx(200e-6)
    assert r["nongemm_s"] == pytest.approx(210e-6)
    names = [n for n, _ in r["device_ops"]]
    assert names[0].startswith("void at::native") and "outside" not in names


def test_idle_gaps_are_labelled_by_the_host_range_open_over_them():
    r = devtrace.reduce(trace())
    gaps = dict((round(s * 1e6), label) for label, s in r["idle_gaps"])
    assert gaps[400] == "bench.pull > cudaMemcpyAsync"  # 1500 .. 1900
    assert gaps[100] == "bench.multi_step"  # 1000 .. 1100
    assert r["idle_gaps"][0][1] == pytest.approx(400e-6)


def test_nothing_to_read_gives_none():
    assert devtrace.reduce([ev("kernel", "k", 0, 5)]) is None
    assert devtrace.reduce([ev("user_annotation", "bench.slice", 0, 5)]) is None


def test_gemm_names():
    pats = devtrace.gemm_patterns()
    assert devtrace.is_gemm("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64", pats)
    assert devtrace.is_gemm("nvjet_tst_64x8_64x16_4x1_v_bz_TNT", pats)
    assert devtrace.is_gemm("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm>", pats)
    assert not devtrace.is_gemm("void at::native::index_select_large_index<float>", pats)
    assert not devtrace.is_gemm("void at::native::reduce_kernel<512, 1>", pats)


def test_a_traced_run_without_a_card_reports_only_what_it_can_read():
    import torch

    from benchmark import harness

    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    small = {"hosts": 64, "hidden": 32, "pair_pool": 256, "batch_size": 64, "embed_dim": 16}
    r = harness.run_cell(spec, "train-h512-16k", seed=4, seconds=2.0, trace=True,
                         device=torch.device("cpu"), config_override=small)
    # the CPU's trace holds no device span: no device metric, no breakdown, no mfu without a peak
    assert set(r["metrics"]) == {"host_enqueue_ms_per_step.train"}
    assert "breakdown" not in r and "busy_s" not in r["device"]
