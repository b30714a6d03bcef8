"""What the benchmark may load, and that a cell is added by data alone."""

from __future__ import annotations

import ast
import hashlib
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "benchmark"
sys.path.insert(0, str(REPO))

from benchmark import run  # noqa: E402

# the benchmark's yardstick: inputs, reference, arithmetic and comparison
YARDSTICK = ["reference/topo_scorer.py", "inputs.py", "flops.py", "compare.py", "devtrace.py", "params.py"]


def imported(path: Path) -> set[str]:
    """Top-level names of every absolute import in a file."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    for f in files:
        bad = imported(f) & set(run.FORBIDDEN)
        assert not bad, f"{f.relative_to(REPO)} imports {bad}"


@pytest.mark.parametrize("rel", YARDSTICK)
def test_the_yardstick_imports_nothing_of_the_program(rel):
    names = imported(BENCH / rel)
    assert "dragonfly2_tpu_torch" not in names
    if rel.startswith("reference/"):
        assert names <= {"__future__", "math", "typing", "torch"}, names


def test_the_run_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "dragonfly2_tpu_torch_probe", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "dragonfly2_tpu.models", object())
    assert run.forbidden_modules() == ["dragonfly2_tpu"]


def test_without_a_card_a_run_exits_non_zero_and_prints_no_result(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "embed-h256-16k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def test_in_a_folder_of_the_benchmark_alone_a_run_prints_no_result(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "train-h512-16k", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path, env=env, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


def digest(root: Path) -> dict[str, str]:
    return {str(f.relative_to(root)): hashlib.sha256(f.read_bytes()).hexdigest()
            for f in sorted(root.rglob("*")) if f.is_file() and "__pycache__" not in f.parts}


def test_a_cell_is_added_by_data_files_alone(tmp_path):
    shutil.copytree(BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", tmp_path)
    before = digest(tmp_path / "benchmark")
    # a throwaway cell: a new traffic mix and its checks, and entries in BENCHMARK.json
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    mix = json.loads((BENCH / "traffic" / "train-calls.json").read_text())
    (tmp_path / "benchmark" / "traffic" / "train-calls-5.json").write_text(json.dumps(dict(mix, steps_per_call=5)))
    (tmp_path / "benchmark" / "checks" / "throwaway.json").write_text(
        (BENCH / "checks" / "train-h512-16k.json").read_text())
    spec["workloads"].append({"name": "throwaway", "config": "topo-h512-16k", "traffic": "train-calls-5",
                              "chips": 1, "why": "a cell added by data alone"})
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "train-h512-16k" in m.get("workloads", []):
            m["workloads"].append("throwaway")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    script = (
        "import json, sys, torch\n"
        "sys.path.insert(0, '.')\n"
        "from benchmark import harness\n"
        "assert harness.HERE == harness.REPO / 'benchmark' and str(harness.REPO) == sys.argv[1]\n"
        "spec = harness.load_json(harness.REPO / 'BENCHMARK.json')\n"
        "small = dict(hosts=64, hidden=32, pair_pool=256, batch_size=64, embed_dim=16)\n"
        "r = harness.run_cell(spec, 'throwaway', seed=9, seconds=0.5, trace=False,\n"
        "                     device=torch.device('cpu'), config_override=small)\n"
        "print(json.dumps(r))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    p = subprocess.run([sys.executable, "-c", script, str(tmp_path)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-3000:]
    result = json.loads(p.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["attempted"] % 5 == 0
    assert set(result["metrics"]) == {"train_steps_per_s", "setup_s"}
    after = digest(tmp_path / "benchmark")
    assert {k: v for k, v in after.items() if k in before} == before
