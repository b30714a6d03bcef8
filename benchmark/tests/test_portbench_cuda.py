"""A short run of each cell on the card: the result line's keys and the
device it names. Skips without a card."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]

pytestmark = pytest.mark.cuda


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", ["train-h512-16k", "embed-h256-16k"])
def test_a_short_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the benchmark measures the card")
    # a traced window long enough to reach and close its profiled slice
    seconds = "8" if trace else "2"
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", cell, "--seed", str(2**31 + 77),
                        "--seconds", seconds, "--trace", str(trace)], cwd=REPO, capture_output=True, text=True,
                       timeout=600)
    assert p.returncode == 0, p.stderr[-4000:]
    r = json.loads(p.stdout.strip().splitlines()[-1])
    assert r["correct"] is True, r["checks"]
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"] and list(r)[-1] == "checks"
    assert r["device"]["platform"] == "gpu" and r["device"]["kind"] == torch.cuda.get_device_name(0)
    assert p.stderr.strip().splitlines()[-1].startswith("check ")
    if trace:
        assert r["device"]["busy_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}
