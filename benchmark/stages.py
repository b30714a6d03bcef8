"""Device and idle time of the program's stages in a cell's profiled slice.

While a ``torch.profiler`` records, the port opens a profiler range around
each stage of its device work (``observability.tracing.stage``: the
``gnn.train.*``, ``gnn.sage.*`` and ``gnn.refresh.*`` ranges). This script
runs one cell traced, through the cell's own driver and profiled slice as
``run.py --trace 1`` runs it, and reduces the slice's trace by those
ranges:

    python3 -m benchmark.stages --workload <name> --seed <n> --seconds <s>

The last line on standard output is one JSON object: the run's ``correct``,
the card, the slice's busy and window time a unit of work (a step or a
refresh), each stage's device time, idle time and count, the share of busy
time the stages launched (``staged_share``), the per-unit readings of
``READINGS``, the host time of the benchmark's own ranges a unit, and the
longest idle gaps labelled by the innermost stage open over them.

A device span (kernel, copy or set) is charged to every stage range that
holds its launch: the ``cuda_runtime`` or ``cuda_driver`` event with the
same ``args.correlation``, on any thread, so the kernels autograd's thread
launches count under ``gnn.train.backward``, and a nested stage counts in
its parent too. Idle time is split by the innermost stage open on the host,
any thread; idle time under none goes under ``"none"``.
"""

from __future__ import annotations

import bisect
import time

from benchmark import devtrace

STAGE = "gnn."  # the prefix of the program's stage ranges
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
COVERED = 0.97  # the least share of busy time the stages must launch for a reading to count

# per driver kind: the unit of work (the driver's ``host`` key counting the
# slice's units) and each reading's stages, times a unit, and kind
READINGS = {
    "train": ("slice_steps", {
        "forward_ms_per_step.train": (["gnn.train.forward"], 1, "device"),
        "backward_ms_per_step.train": (["gnn.train.backward"], 1, "device"),
        "optimizer_ms_per_step.train": (["gnn.train.optimizer"], 1, "device"),
        "message_path_ms_per_step.train": (["gnn.sage.gather", "gnn.sage.message", "gnn.sage.mean"],
                                           "num_layers", "device"),
    }),
    "refresh": ("slice_refreshes", {
        "upload_ms.embed": (["gnn.refresh.upload"], 1, "device"),
        "encode_ms.embed": (["gnn.refresh.encode"], 1, "device"),
        "upload_idle_ms.embed": (["gnn.refresh.upload"], 1, "idle"),
    }),
}


def _charged_s(dev: list[tuple], launch: dict, spans: list[tuple[float, float]]) -> float:
    """Seconds of the union of the device spans whose launch lies inside one
    of the host intervals ``spans``."""
    merged = devtrace.merge(spans)
    starts = [a for a, _ in merged]
    picked = []
    for a, b, corr in dev:
        t = launch.get(corr)
        if t is None:
            continue
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= merged[j][1]:
            picked.append((a, b))
    return sum(b - a for a, b in devtrace.merge(picked)) * 1e-6


def _innermost(t: float, ivs: list[tuple]) -> str | None:
    """The name of the shortest stage interval open at ``t``, or None."""
    open_ = [iv for iv in ivs if iv[0] <= t <= iv[1]]
    return min(open_, key=lambda iv: iv[1] - iv[0])[2] if open_ else None


def _idle_by_stage(idle: list[tuple[float, float]], ivs: list[tuple], lo: float, hi: float) -> dict[str, float]:
    """Idle seconds split by the innermost stage interval open over them;
    ``"none"`` where no stage is."""
    cuts = sorted({lo, hi} | {x for a, b, _ in ivs for x in (a, b) if lo < x < hi})
    inner = [_innermost(0.5 * (p + q), ivs) or "none" for p, q in zip(cuts, cuts[1:])]
    out = {name: 0.0 for _, _, name in ivs}
    out["none"] = 0.0
    for a, b in idle:
        j = max(0, bisect.bisect_right(cuts, a) - 1)
        while j < len(inner) and cuts[j] < b:
            out[inner[j]] += max(0.0, min(b, cuts[j + 1]) - max(a, cuts[j])) * 1e-6
            j += 1
    return out


def reduce(events: list[dict], top: int = 10) -> dict | None:
    """The slice's numbers by stage from a chrome trace's events, or None
    when the trace holds no slice range."""
    marks = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and e.get("name") == devtrace.SLICE]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, ivs, host = [], [], []
    launch: dict = {}  # correlation id -> the launch's host time
    bench: dict[str, float] = {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        cat, name = e.get("cat"), e.get("name", "?")
        corr = (e.get("args") or {}).get("correlation")
        if cat in LAUNCH_CATS and corr is not None:
            launch[corr] = a
        if b <= lo or a >= hi:
            continue
        if cat in devtrace.DEVICE_CATS:
            dev.append((max(a, lo), min(b, hi), corr))
        elif cat in devtrace.HOST_CATS:
            host.append({"ts": a, "dur": b - a, "name": name})
            if cat == "user_annotation" and name.startswith(STAGE):
                ivs.append((a, b, name))
            elif cat == "user_annotation" and name.startswith("bench.") and name != devtrace.SLICE:
                bench[name] = bench.get(name, 0.0) + (b - a) * 1e-6
    merged = devtrace.merge([(a, b) for a, b, _ in dev])
    bounds = [lo] + [x for iv in merged for x in iv] + [hi]
    idle = [(a, b) for a, b in zip(bounds[::2], bounds[1::2]) if b > a]
    idle_by = _idle_by_stage(idle, ivs, lo, hi)
    busy_s = sum(b - a for a, b in merged) * 1e-6
    staged_s = _charged_s(dev, launch, [(a, b) for a, b, _ in ivs])
    stages = {}
    for name in sorted({n for _, _, n in ivs}):
        spans = [(a, b) for a, b, n in ivs if n == name]
        stages[name] = {"device_s": _charged_s(dev, launch, spans), "idle_s": idle_by[name], "count": len(spans)}
    gaps = sorted(idle, key=lambda g: g[0] - g[1])[:top]
    labels = []
    for a, b in gaps:
        t = 0.5 * (a + b)
        label = devtrace._label(t, host)
        inner = _innermost(t, ivs)
        if inner is not None and inner not in label:
            label = label.replace(" > ", f" > {inner} > ", 1) if " > " in label else f"{label} > {inner}"
        labels.append([label, (b - a) * 1e-6])
    return {
        "window_s": (hi - lo) * 1e-6, "busy_s": busy_s, "staged_s": staged_s,
        "stages": stages, "none_idle_s": idle_by["none"],
        "bench_host_s": dict(sorted(bench.items())),
        "idle_gaps": labels,
    }


def readings(kind: str, red: dict | None, units: int, config: dict) -> dict[str, float | None]:
    """Each reading of ``READINGS[kind]`` in ms a unit of work. A reading is
    None when a stage of it is missing, or held other than its count a unit
    (1, or ``num_layers`` for the SAGE stages), so that a stage gone missing
    reads as missing, not as free; and all are None when the stages launched
    under ``COVERED`` of the busy time, so that device work outside every
    stage shows."""
    _, table = READINGS[kind]
    if red is None or not units or red["busy_s"] <= 0 or red["staged_s"] < COVERED * red["busy_s"]:
        return dict.fromkeys(table)
    out: dict[str, float | None] = {}
    for metric, (names, per, what) in table.items():
        per = config[per] if isinstance(per, str) else per
        st = red["stages"]
        if any(n not in st or st[n]["count"] != units * per for n in names):
            out[metric] = None
        else:
            out[metric] = sum(st[n]["device_s" if what == "device" else "idle_s"] for n in names) / units * 1e3
    return out


def run_stages(spec: dict, name: str, *, seed: int, seconds: float, device, t0: float | None = None,
               config_override: dict | None = None) -> dict:
    """Run the cell once, traced, and reduce its slice by stage."""
    from benchmark import compare, harness

    cell = harness.find_cell(spec, name)
    config = dict(cell.config, **(config_override or {}))
    ctx = harness.Ctx(config, cell.traffic, seed, seconds, True, device,
                      time.perf_counter() if t0 is None else t0)
    kept: list[list[dict]] = []
    plain = devtrace.reduce

    def keep(events, top=10):  # the slice's events, kept as the driver's own reduction reads them
        kept.append(events)
        return plain(events, top)

    devtrace.reduce = keep
    try:
        out = harness.load_module(cell.driver).run(ctx)
    finally:
        devtrace.reduce = plain
    kind = cell.traffic["kind"]
    unit_key, _ = READINGS[kind]
    units = out.host.get(unit_key, 0)
    red = reduce(kept[0]) if kept else None
    result = {
        "cell": name, "seed": seed,
        "correct": out.failed == 0 and compare.verdict(out.readings, cell.limits),
        "units": units, "unit": unit_key,
        "readings": readings(kind, red, units, config),
    }
    if red is not None and units:
        per = 1e3 / units
        result.update({
            "busy_ms": red["busy_s"] * per, "window_ms": red["window_s"] * per,
            "staged_share": red["staged_s"] / red["busy_s"] if red["busy_s"] > 0 else None,
            "stages": {n: {"device_ms": s["device_s"] * per, "idle_ms": s["idle_s"] * per, "count": s["count"]}
                       for n, s in red["stages"].items()},
            "none_idle_ms": red["none_idle_s"] * per,
            "bench_host_ms": {n: s * per for n, s in red["bench_host_s"].items()},
            "idle_gaps": red["idle_gaps"],
        })
    return result


def main(argv: list[str] | None = None) -> int:
    import argparse
    import json
    import sys

    from benchmark import run as bench

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)

    bench.cache_dirs()
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    result = run_stages(harness.load_json(bench.REPO / "BENCHMARK.json"), args.workload, seed=args.seed,
                        seconds=args.seconds, device=torch.device("cuda", 0))
    result["card"] = bench.power_limit()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
