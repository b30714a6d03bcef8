"""dfsim — run a swarm-simulation scenario against the real control plane
(the port's own copy of dragonfly2_tpu/cli/dfsim.py, over the port's
scheduler, evaluator and federation).

    python -m dragonfly2_tpu_torch.cli.dfsim flash-crowd --peers 100000 --json
    python -m dragonfly2_tpu_torch.cli.dfsim partition-and-heal --peers 2000
    python -m dragonfly2_tpu_torch.cli.dfsim cross-region-cold-start --seed 3

Human output: a per-interval table (arrivals, scheduling rounds, same-region
placement, origin egress) plus the summary block. `--json` emits ONE json
object with the stable contract keys below (chip_smoke.py's sim phase reads
them):

  scenario, peers, schedulers, seed, events, wall_s, virtual_s,
  events_per_sec, time_compression,
  placement: {rounds, same_region_frac, same_rack_frac, mean_parent_rtt_ms}
  origin_egress: {bytes_per_region, max_region_fetches}
  fairness: {jain_upload_index}
  outcomes: {completed, failed, refused, back_to_source, reschedules,
             departed, crashed}
  violations: {departed_parent_rounds}
  federation: {syncs_ok, syncs_failed, first_remote_edge_s} | null
  overload: {refused, retries, timeouts, admitted_p50_ms, admitted_p99_ms,
             shed_by_class} | null      (the chaos packs)
  degradation: {max_level, final_level} | null
  manager: {agents, unreachable_declared, recovered, rejoined} | null
  telemetry: {nodes, edges, pairs, download_rows, probe_rows} | null
  assertions: {passed: bool, error: str | null}
"""

from __future__ import annotations

import argparse
import json
import shutil
import sys
import tempfile
from typing import Any

from dragonfly2_tpu_torch.sim.scenarios import SCENARIOS


def run_scenario(
    name: str,
    *,
    peers: int | None = None,
    schedulers: int | None = None,
    seed: int = 0,
    telemetry: bool = True,
    check: bool = True,
    **kw: Any,
) -> dict[str, Any]:
    """Build, run, bridge, and check one scenario; returns the JSON contract
    dict (the in-process entry the tests and chip_smoke.py share with the CLI)."""
    builder = SCENARIOS[name]
    build_kw: dict[str, Any] = {"seed": seed, **kw}
    if peers is not None:
        build_kw["peers"] = peers
    if schedulers is not None and name == "flash-crowd":
        build_kw["schedulers"] = schedulers
    own_dir = None
    if telemetry and "telemetry_dir" not in build_kw:
        own_dir = tempfile.mkdtemp(prefix=f"dfsim-{name}-")
        build_kw["telemetry_dir"] = own_dir
    scenario = builder(**build_kw)
    try:
        rep = scenario.sim.run()
        telemetry_stats = None
        if telemetry:
            ds = scenario.sim.build_dataset()
            telemetry_stats = {k: v for k, v in ds.items() if k != "dataset"}
        passed, error = True, None
        if check:
            try:
                scenario.check(rep)
            except AssertionError as e:
                passed, error = False, str(e)
        content = scenario.content_length
        return {
            "scenario": rep.scenario,
            "peers": rep.peers,
            "schedulers": len(scenario.sim.names),
            "seed": seed,
            "events": rep.events,
            "wall_s": rep.wall_s,
            "virtual_s": rep.virtual_s,
            "events_per_sec": rep.events_per_sec,
            "time_compression": rep.time_compression,
            "scheduler": {
                # the sim-scale round-loop meter. scoring reports
                # what actually served (an ml-* request degrades to "base"
                # when the native toolchain is missing); rounds_per_s is
                # rounds / seconds INSIDE schedule_candidate_parents.
                "scoring": rep.scoring,
                "rounds": rep.sched_rounds,
                "sched_s": rep.sched_s,
                "rounds_per_s": rep.sched_rounds_per_s,
                "native_rounds": rep.native_rounds,
                # the mirror-driven split of native_rounds (cached-row
                # fast path vs stale-revalidated) + the full-export counter —
                # must equal the scheduler count (one attach each, then
                # deltas only)
                "mirror_rounds": rep.mirror_rounds,
                "mirror_stale_rounds": rep.mirror_stale_rounds,
                "mirror_full_syncs": rep.mirror_full_syncs,
            },
            "placement": {
                "rounds": rep.rounds_with_parents,
                "same_region_frac": rep.same_region_frac,
                "same_rack_frac": rep.same_rack_frac,
                "mean_parent_rtt_ms": rep.mean_parent_rtt_ms,
            },
            "origin_egress": {
                "bytes_per_region": dict(rep.origin_egress_bytes),
                "max_region_fetches": round(
                    max(rep.origin_egress_bytes.values(), default=0) / content, 2
                ),
            },
            "fairness": {"jain_upload_index": rep.fairness_jain},
            "outcomes": {
                "completed": rep.completed,
                "failed": rep.failed,
                "refused": rep.refused,
                "back_to_source": rep.back_to_source,
                "reschedules": rep.reschedules,
                "departed": rep.departed,
                "crashed": rep.crashed,
            },
            "violations": {"departed_parent_rounds": rep.departed_parent_rounds},
            "overload": (
                {
                    "refused": rep.overload_refused,
                    "retries": rep.overload_retries,
                    "timeouts": rep.register_timeouts,
                    "admitted_p50_ms": rep.admitted_p50_ms,
                    "admitted_p99_ms": rep.admitted_p99_ms,
                    "shed_by_class": dict(rep.shed_by_class),
                }
                if (rep.overload_refused or rep.register_timeouts
                    or rep.admitted_p99_ms)
                else None
            ),
            "degradation": (
                {"max_level": rep.degradation["max_level"],
                 "final_level": rep.degradation["final_level"]}
                if rep.degradation else None
            ),
            "manager": dict(rep.manager) if rep.manager else None,
            "federation": (
                {k: rep.federation[k] for k in
                 ("syncs_ok", "syncs_failed", "first_remote_edge_s")}
                if rep.federation else None
            ),
            "telemetry": telemetry_stats,
            "assertions": {"passed": passed, "error": error},
            "_buckets": rep.buckets,
        }
    finally:
        scenario.sim.close()
        if own_dir is not None:
            # a dir this call created is this call's to remove — repeated
            # CLI/smoke runs must not accumulate record files in /tmp
            # (callers passing their own telemetry_dir keep theirs)
            shutil.rmtree(own_dir, ignore_errors=True)


def _print_human(out: dict) -> None:
    print(f"── dfsim · {out['scenario']} ─ {out['peers']} peers, "
          f"{out['schedulers']} scheduler(s), seed {out['seed']}")
    buckets = out.pop("_buckets", [])
    if buckets:
        print(f"{'t(s)':>7} {'arrive':>7} {'rounds':>7} {'local%':>7} "
              f"{'done':>7} {'b2s':>4} {'origin MB':>10} {'p2p GB':>8}")
        for b in buckets:
            if not (b["arrivals"] or b["rounds"] or b["completions"]):
                continue
            local = 100.0 * b["same_region"] / b["parents"] if b["parents"] else 0.0
            print(f"{b['t_s']:>7.0f} {b['arrivals']:>7} {b['rounds']:>7} "
                  f"{local:>6.1f}% {b['completions']:>7} {b['back_to_source']:>4} "
                  f"{b['origin_bytes'] / 1e6:>10.1f} {b['p2p_bytes'] / 1e9:>8.2f}")
    pl, eg = out["placement"], out["origin_egress"]
    oc, fed = out["outcomes"], out["federation"]
    print(f"events {out['events']} in {out['wall_s']}s wall "
          f"({out['events_per_sec']}/s, {out['virtual_s']}s virtual, "
          f"{out['time_compression']}x compression)")
    print(f"placement: {pl['rounds']} rounds, "
          f"{100 * pl['same_region_frac']:.1f}% same-region, "
          f"mean parent RTT {pl['mean_parent_rtt_ms']:.2f} ms")
    print(f"origin egress: {eg['bytes_per_region']} "
          f"(max {eg['max_region_fetches']} task-sized fetches/region)")
    print(f"outcomes: {oc} · fairness jain {out['fairness']['jain_upload_index']}")
    if fed:
        print(f"federation: {fed}")
    if out["telemetry"]:
        print(f"telemetry -> dataset: {out['telemetry']}")
    a = out["assertions"]
    print("scenario assertions:", "PASS" if a["passed"] else f"FAIL — {a['error']}")


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dfsim", description="discrete-event swarm simulator (virtual clock)"
    )
    ap.add_argument("scenario", choices=sorted(SCENARIOS))
    ap.add_argument("--peers", type=int, default=None,
                    help="simulated peers (scenario default if omitted)")
    ap.add_argument("--schedulers", type=int, default=None,
                    help="ring members (flash-crowd only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--no-telemetry", action="store_true",
                    help="skip record capture + dataset bridge (pure control plane)")
    ap.add_argument("--scoring", choices=("base", "ml-serial", "ml-native"),
                    default="base",
                    help="scoring plane: base (no model), ml-serial (synthetic "
                         "native model, per-round Python loop), ml-native (same "
                         "model through the df_round_drive round driver). "
                         "flash-crowd only; ml legs skip the placement-quality "
                         "checks (policy under a synthetic model is not the "
                         "scenario contract — the round-loop A/B is)")
    ap.add_argument("--json", action="store_true", help="one JSON object on stdout")
    args = ap.parse_args(argv)

    kw: dict[str, Any] = {}
    if args.scoring != "base":
        if args.scenario != "flash-crowd":
            ap.error("--scoring is flash-crowd only")
        kw["scoring"] = args.scoring
        kw["check"] = False
    out = run_scenario(
        args.scenario,
        peers=args.peers,
        schedulers=args.schedulers,
        seed=args.seed,
        telemetry=not args.no_telemetry,
        **kw,
    )
    if args.json:
        out.pop("_buckets", None)
        print(json.dumps(out))
    else:
        _print_human(out)
    return 0 if out["assertions"]["passed"] else 1


if __name__ == "__main__":
    sys.exit(main())
