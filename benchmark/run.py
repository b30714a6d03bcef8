"""Run one cell of the port's benchmark once.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port
(``dragonfly2_tpu_torch``) on a machine with as many CUDA cards as the
cell asks for. The last line on standard output is the result as one
JSON object; the numbers that decide ``correct`` are the last lines on
standard error. With no card, too few cards, or the JAX package loaded
once the window has closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up counts from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "dragonfly2_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = REPO / ".bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)
    os.environ["USE_FLAX"] = "0"


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def power_limit() -> str:
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=20)
        return p.stdout.strip() or p.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({e})"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache_dirs()
    sys.path[0] = str(REPO)  # the checkout's packages, not this folder's modules, at top level
    import torch

    from benchmark import harness

    spec = harness.load_json(REPO / "BENCHMARK.json")
    chips = harness.find_cell(spec, args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s); found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(f"card: {power_limit()}", file=sys.stderr)
    result = harness.run_cell(spec, args.workload, seed=args.seed, seconds=args.seconds,
                              trace=bool(args.trace), device=torch.device("cuda", 0), t0=T0)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)} (the JAX package or JAX itself)", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
