"""Run one cell of ``BENCHMARK.json`` once and build its result line.

Everything that belongs to one configuration, traffic mix, check or
per-layer metric sits in a file of its own, found by name:

  configs/<config>.json     sizes, hyper-parameters, source, assumptions
  traffic/<traffic>.json    the mix's parameters; ``kind`` names its driver
  drivers/<kind>.py         drives the port for that kind of traffic
  checks/<cell>.json        the limit of each number that decides ``correct``
  metrics/<metric>.py       ``read(record)``: one per-layer number, or None
  peaks.json                the chips' published peaks, by device name
"""

from __future__ import annotations

import importlib.util
import json
import time
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType, SimpleNamespace

import torch

from benchmark import compare

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


@dataclass
class Ctx:
    """What a driver is given: the cell's files, the run's arguments, the
    device and the host clock's reading at process start."""

    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float


@dataclass
class Outcome:
    """What a driver hands back."""

    e2e: dict[str, float]
    attempted: int
    failed: int
    setup_s: float
    memory_peak_bytes: int
    readings: dict[str, float]
    host: dict = field(default_factory=dict)  # host-clock numbers the per-layer readers take
    trace: dict | None = None  # devtrace.reduce of the profiled slice


def load_json(path: Path) -> dict:
    return json.loads(path.read_text())


def load_module(path: Path) -> ModuleType:
    """A module from its file, whatever characters its name holds."""
    spec = importlib.util.spec_from_file_location(f"benchmark_file_{path.stem.replace('.', '_')}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell(SimpleNamespace):
    """One entry of ``workloads`` with its files read."""


def find_cell(spec: dict, name: str) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    traffic = load_json(HERE / "traffic" / f"{w['traffic']}.json")
    return Cell(
        name=name, entry=w, config=load_json(REPO / conf["file"]), traffic=traffic,
        driver=HERE / "drivers" / f"{traffic['kind']}.py",
        limits=load_json(HERE / "checks" / f"{name}.json")["limits"],
    )


def applies(metric: dict, cell: str, reported: set[str] | None = None) -> bool:
    """A metric is read in a cell its ``workloads`` lists; without the key,
    an end-to-end metric in every cell and a per-layer one in every cell
    that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return reported is None or metric["moves"] in reported


def peaks(device_name: str) -> dict | None:
    return load_json(HERE / "peaks.json")["devices"].get(device_name)


def run_cell(spec: dict, name: str, *, seed: int, seconds: float, trace: bool,
             device: torch.device, t0: float | None = None, config_override: dict | None = None) -> dict:
    """Run the cell once; the result line as a dict, ``checks`` last.
    ``config_override`` replaces configuration keys (the tests' small sizes)."""
    cell = find_cell(spec, name)
    config = dict(cell.config, **(config_override or {}))
    ctx = Ctx(config, cell.traffic, seed, seconds, trace, device,
              time.perf_counter() if t0 is None else t0)
    out: Outcome = load_module(cell.driver).run(ctx)

    e2e_names = [m["name"] for m in spec["end_to_end"] if applies(m, name)]
    reported = set(e2e_names)
    metrics: dict[str, dict] = {}
    if not trace:
        for m in spec["end_to_end"]:
            if m["name"] in reported:
                value = out.setup_s if m["name"] == "setup_s" else out.e2e[m["name"]]
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        name_of = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
        record = SimpleNamespace(cell=name, config=config, traffic=cell.traffic, host=out.host,
                                 trace=out.trace, peaks=peaks(name_of))
        for m in spec["per_layer"]:
            if applies(m, name, reported):
                value = load_module(HERE / "metrics" / f"{m['name']}.py").read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {
        "platform": "gpu" if device.type == "cuda" else device.type,
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": cell.entry["chips"],
        "memory_peak_bytes": out.memory_peak_bytes,
    }
    result = {"correct": out.failed == 0 and compare.verdict(out.readings, cell.limits),
              "attempted": out.attempted, "failed": out.failed, "metrics": metrics, "device": dev}
    if trace and out.trace is not None:
        dev["busy_s"] = out.trace["busy_s"]
        dev["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"], "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = {
        k: {"value": out.readings.get(k), "limit": lim["limit"]} for k, lim in cell.limits.items()
    }
    return result
