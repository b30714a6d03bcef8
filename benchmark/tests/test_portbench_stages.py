"""Reduction of a profiled slice by the program's stages: device time
charged by launch, idle time by the innermost stage, and the readings that
go blank when a stage is missing, miscounted or leaves device work
uncovered."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import devtrace, stages  # noqa: E402


def ev(cat, name, ts, dur, corr=None, tid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def staged_trace(outside_us=30):
    """A training step's stages, forward with a nested gather, and the
    kernels they launch, one from autograd's thread and one through the
    driver API; a last kernel, ``outside_us`` long, is launched outside
    any stage."""
    return [
        ev("user_annotation", "bench.slice", 1000, 1000),
        ev("user_annotation", "bench.multi_step", 1000, 990),
        ev("user_annotation", "gnn.train.forward", 1000, 300),
        ev("user_annotation", "gnn.sage.gather", 1050, 100),
        ev("user_annotation", "gnn.train.backward", 1300, 400),
        ev("user_annotation", "gnn.train.optimizer", 1700, 200),
        ev("cpu_op", "autograd::engine::evaluate_function: MmBackward0", 1360, 40, tid=2),
        ev("cuda_runtime", "cudaLaunchKernel", 1060, 5, 1),
        ev("cuda_runtime", "cudaLaunchKernel", 1200, 5, 2),
        ev("cuda_runtime", "cudaLaunchKernel", 1400, 5, 3, tid=2),
        ev("cuda_driver", "cuLaunchKernelEx", 1750, 5, 4),
        ev("cuda_runtime", "cudaLaunchKernel", 1950, 5, 5),
        ev("kernel", "gather", 1100, 100, 1),
        ev("kernel", "message", 1250, 100, 2),  # runs under the backward, launched by the forward
        ev("kernel", "mm_backward", 1400, 200, 3),
        ev("kernel", "nvjet_adamw", 1800, 50, 4),
        ev("kernel", "after", 1950, outside_us, 5),
    ]


def test_device_time_goes_to_the_stage_that_launched_it_on_any_thread():
    r = stages.reduce(staged_trace())
    got = {k: (round(v["device_s"] * 1e6, 6), v["count"]) for k, v in r["stages"].items()}
    assert got == {
        "gnn.train.forward": (200, 1),  # gather + message: the nested stage counts in its parent
        "gnn.sage.gather": (100, 1),
        "gnn.train.backward": (200, 1),  # launched on tid 2, matched by correlation id
        "gnn.train.optimizer": (50, 1),  # a driver-API launch
    }
    assert r["busy_s"] == pytest.approx(480e-6)
    assert r["busy_s"] == pytest.approx(devtrace.reduce(staged_trace())["busy_s"])
    # every stage's launches, each device span once: all but the kernel launched outside them
    assert r["staged_s"] == pytest.approx(450e-6)
    assert r["bench_host_s"] == {"bench.multi_step": pytest.approx(990e-6)}


def test_idle_time_splits_by_the_innermost_stage_and_adds_up():
    r = stages.reduce(staged_trace())
    idle = {k: round(v["idle_s"] * 1e6, 6) for k, v in r["stages"].items()}
    assert idle == {"gnn.train.forward": 100, "gnn.sage.gather": 50, "gnn.train.backward": 150,
                    "gnn.train.optimizer": 150}
    assert r["none_idle_s"] == pytest.approx(70e-6)
    total = sum(v["idle_s"] for v in r["stages"].values()) + r["none_idle_s"]
    assert total == pytest.approx(r["window_s"] - r["busy_s"])


def test_idle_gaps_name_the_innermost_stage_between_the_bench_range_and_the_host_op():
    r = stages.reduce(staged_trace())
    assert [lab for lab, _ in r["idle_gaps"]] == [
        "bench.multi_step > gnn.train.optimizer",  # 1600 .. 1800
        "bench.multi_step > gnn.sage.gather",  # 1000 .. 1100
        "bench.multi_step > gnn.train.optimizer",  # 1850 .. 1950
        "bench.multi_step > gnn.train.forward",  # 1200 .. 1250
        "bench.multi_step > gnn.train.backward > autograd::engine::evaluate_function: MmBackward0",  # 1350 .. 1400
        "bench.multi_step",  # 1980 .. 2000: no stage open
    ]
    # the gaps and their lengths are devtrace's own, and so is each label without a stage in it
    plain = devtrace.reduce(staged_trace())["idle_gaps"]
    assert [s for _, s in r["idle_gaps"]] == [s for _, s in plain]
    assert plain[4][0] == "bench.multi_step > autograd::engine::evaluate_function: MmBackward0"


def test_no_slice_range_gives_none():
    assert stages.reduce([ev("kernel", "k", 0, 5)]) is None


def red(spans, idle_s=2e-3, busy_s=0.1, staged_s=0.1):
    return {"busy_s": busy_s, "staged_s": staged_s,
            "stages": {n: dict(s, idle_s=idle_s) for n, s in spans.items()}}


READ = [(kind, metric) for kind, (_, table) in stages.READINGS.items() for metric in table]


@pytest.mark.parametrize("kind, metric", READ)
def test_a_reading_reads_its_stages_and_none_when_one_is_missing_or_miscounted(kind, metric):
    names, per, what = stages.READINGS[kind][1][metric]
    per = 3 if per == "num_layers" else per
    config = {"num_layers": 3}
    whole = {n: {"device_s": 0.012, "count": 4 * per} for n in names}
    want = (2e-3 if what == "idle" else 0.012 * len(names)) / 4 * 1e3
    assert stages.readings(kind, red(whole), 4, config)[metric] == pytest.approx(want)
    assert stages.readings(kind, red(whole, staged_s=0.097), 4, config)[metric] == pytest.approx(want)
    assert stages.readings(kind, red({}), 4, config)[metric] is None
    short = dict(whole, **{names[-1]: {"device_s": 0.012, "count": 4 * per - 1}})
    assert stages.readings(kind, red(short), 4, config)[metric] is None
    # device work launched outside every stage: every reading goes blank
    assert stages.readings(kind, red(whole, staged_s=0.0969), 4, config)[metric] is None
    assert stages.readings(kind, None, 4, config)[metric] is None
    assert stages.readings(kind, red(whole), 0, config)[metric] is None


@pytest.mark.parametrize("outside_us, want", [(30, None), (10, 0.2)])
def test_readings_count_only_while_the_stages_cover_the_busy_time(outside_us, want):
    # the step of ``staged_trace`` with its last kernel, launched outside every
    # stage, 30 us (6% of busy time) or 10 us (2%) long
    r = stages.reduce(staged_trace(outside_us))
    r["stages"] = {"gnn.train.forward": r["stages"]["gnn.train.forward"]}
    got = stages.readings("train", r, 1, {"num_layers": 1})["forward_ms_per_step.train"]
    assert got == (None if want is None else pytest.approx(want))


@pytest.mark.parametrize("cell, unit, per_unit", [
    ("train-h512-16k", "slice_steps", {"gnn.train.sample": 1, "gnn.train.forward": 1, "gnn.train.backward": 1,
                                       "gnn.train.optimizer": 1, "gnn.sage.gather": 2, "gnn.sage.message": 2,
                                       "gnn.sage.mean": 2}),
    ("embed-h256-16k", "slice_refreshes", {"gnn.refresh.upload": 1, "gnn.refresh.encode": 1,
                                           "gnn.refresh.partials": 1, "gnn.sage.gather": 2,
                                           "gnn.sage.message": 2, "gnn.sage.mean": 2}),
])
def test_a_cells_slice_holds_each_stage_of_the_program_its_number_of_times(cell, unit, per_unit):
    import torch

    from benchmark import harness

    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    small = {"hosts": 64, "hidden": 32, "pair_pool": 256, "batch_size": 64, "embed_dim": 16, "num_layers": 2}
    r = stages.run_stages(spec, cell, seed=2**31 + 11, seconds=5.0, device=torch.device("cpu"),
                          config_override=small)
    assert r["unit"] == unit and r["units"] > 0 and isinstance(r["correct"], bool)
    assert {n: s["count"] for n, s in r["stages"].items()} == {n: c * r["units"] for n, c in per_unit.items()}
    # the CPU's trace holds no device span: nothing to read
    assert set(r["readings"].values()) == {None}
    assert r["staged_share"] is None
