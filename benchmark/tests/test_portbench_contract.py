"""BENCHMARK.json against the rules its reader holds it to: keys, names,
units, lengths, bounds, and every file it names."""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(REPO))

from benchmark import harness  # noqa: E402

SPEC = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")


def line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(SPEC["paths"]) <= 16 and all(PATH.match(p) and not p.startswith("/") for p in SPEC["paths"])
    assert 1 <= len(SPEC["command"]) <= 32 and all(line(w) for w in SPEC["command"])
    assert isinstance(SPEC["run_seconds"], int) and 1 <= SPEC["run_seconds"] <= 51


def test_configs():
    assert 1 <= len(SPEC["configs"]) <= 24
    used = {w["config"] for w in SPEC["workloads"]}
    files = set()
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"]) and c["name"] in used
        assert c["file"].startswith("benchmark/") and (REPO / c["file"]).is_file() and c["file"] not in files
        files.add(c["file"])
        conf = json.loads((REPO / c["file"]).read_text())
        assert conf["reduced"] == c["reduced"] == [] and "assumed" in conf and len(conf["source"]) <= 200


def test_workloads():
    assert 1 <= len(SPEC["workloads"]) <= 24
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"]) and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.find_cell(SPEC, w["name"])  # its files are found by name
        assert cell.driver.is_file() and cell.limits
    assert sum(w["chips"] == 4 for w in SPEC["workloads"]) <= max(1, len(SPEC["workloads"]) // 4)


def test_metrics():
    e2e, per = SPEC["end_to_end"], SPEC["per_layer"]
    names = [m["name"] for m in e2e + per]
    assert len(names) == len(set(names)) and 1 <= len(e2e) <= 16 and 1 <= len(per) <= 128
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    layers = {}
    for m in per:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert line(m["layer"]) and m["moves"] in {x["name"] for x in e2e} and m["moves"] != "setup_s"
        assert (REPO / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        layers.setdefault(m["layer"], set()).add(m["name"])
        for w in m["workloads"]:
            moved = next(x for x in e2e if x["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
        if m["unit"] == "%" and ("mfu" in m["name"] or m["name"].endswith("_roofline")):
            assert m["better"] == "higher"
    for m in e2e + per:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
    for cell in cells:  # every cell reports set-up, another end-to-end metric and a per-layer one
        reported = {m["name"] for m in e2e if harness.applies(m, cell)}
        assert "setup_s" in reported and len(reported) >= 2
        assert any(harness.applies(m, cell, reported) for m in per)


def test_a_full_check_fits_its_time_with_the_full_24_cells():
    runs = 2 + 14 * 24
    assert runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
