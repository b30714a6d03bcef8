"""Readings that the limits of ``checks/<cell>.json`` are set from.

    python3 benchmark/calibrate.py --workload <name> --seeds 1,2,3 [--seconds 1] [--out FILE]

For each seed, in one process: the number the program reads in a run of
the cell (a short window), and what each stand-in reads when it takes the
program's place against the plain float32 reference at the cell's own
size: the reference rounded to float8 (the precision control), to
bfloat16 (what the program's own precision should read), and each fault
the cell can have. One JSON line a seed on standard output and in --out.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def bf16_rounding(x):
    import torch

    return x.to(torch.bfloat16).to(x.dtype)


def stand_ins(cell, ctx) -> dict:
    """Readings of each stand-in against the float32 reference."""
    from benchmark import compare
    from benchmark.drivers import refresh, train
    from benchmark.reference import topo_scorer as ref

    ref.linear_no_tf32()
    if cell.traffic["kind"] == "train":
        cluster, p0, bseed = train.build(ctx)
        sound = train.reference_observation(ctx, cluster, p0, bseed)
        half = slice(0, ctx.config["batch_size"] // 2)
        obs = {
            "control_fp8": train.reference_observation(ctx, cluster, p0, bseed, q=ref.fp8_rounding),
            "ref_bf16": train.reference_observation(ctx, cluster, p0, bseed, q=bf16_rounding),
            "fault_half_batch": train.reference_observation(ctx, cluster, p0, bseed, rows=half),
            "fault_state_unchanged": dict(sound, change={k: v * 0 for k, v in sound["change"].items()}),
        }
        return {k: compare.train_readings(v, sound) for k, v in obs.items()}
    cluster, ring, p0, rounds = refresh.build(ctx)
    last, before = ring[-1], ring[-2]
    sound = refresh.reference_scores(ctx, last, p0, rounds)
    k = last.mask.shape[1]
    half_mask = last.mask.clone()
    half_mask[:, k // 2:] = 0
    shifted = sound.copy()
    shifted[0] = sound[0][list(range(1, sound.shape[1])) + [0]]
    return {
        "control_fp8": compare.score_readings(refresh.reference_scores(ctx, last, p0, rounds, ref.fp8_rounding), sound),
        "ref_bf16": compare.score_readings(refresh.reference_scores(ctx, last, p0, rounds, bf16_rounding), sound),
        "fault_stale_refresh": compare.score_readings(refresh.reference_scores(ctx, before, p0, rounds), sound),
        "fault_half_neighbors": compare.score_readings(
            refresh.reference_scores(ctx, last._replace(mask=half_mask), p0, rounds), sound),
        "fault_answer_shifted": compare.score_readings(shifted, sound),
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path[0] = str(REPO)
    import torch

    from benchmark import compare, harness

    spec = harness.load_json(REPO / "BENCHMARK.json")
    dev = torch.device("cuda", 0)
    cell = harness.find_cell(spec, args.workload)
    out = open(args.out, "a") if args.out else None
    driver = harness.load_module(cell.driver)
    for seed in (int(s) for s in args.seeds.split(",")):
        ctx = harness.Ctx(cell.config, cell.traffic, seed, args.seconds, False, dev, 0.0)
        run = driver.run(ctx)
        line = {"workload": args.workload, "seed": seed, "program": run.readings,
                "correct": compare.verdict(run.readings, cell.limits), "e2e": run.e2e,
                **stand_ins(cell, ctx)}
        print(json.dumps(line), flush=True)
        if out:
            out.write(json.dumps(line) + "\n")
            out.flush()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
