"""dfmodel: drive the serving-model rollout state machine (the port's own
copy of dragonfly2_tpu/cli/dfmodel.py).

The rollout operations talk straight to the MANAGER registry — no daemon
involved:

  python -m dragonfly2_tpu_torch.cli.dfmodel status   --manager host:port [--type gnn]
  python -m dragonfly2_tpu_torch.cli.dfmodel promote  --manager host:port --version vNNN   (or --id N)
  python -m dragonfly2_tpu_torch.cli.dfmodel rollback --manager host:port [--type gnn] [--reason why]

`status` prints the active row, candidates mid-shadow (with their aggregate
divergence windows), and recent rejects; `promote` pushes a candidate /
shadowing version active (the manual gate when auto_promote is off);
`rollback` rejects the current active version and re-activates the previous
one — the registry half of what a scheduler's auto-rollback does on a
post-swap health regression.

The parser is the reference's, `publish` and `fetch` included: they import
a checkpoint directory into the P2P cache and pull a manifest's files
through the piece engine, which needs the daemon. The port has no daemon
yet (ROADMAP.md §1, queue item 4), so both exit 2 with a message naming it,
as the port's servers do for flags they have not ported.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from dragonfly2_tpu_torch.rpc.core import RpcError

# the reference's daemon socket default (its dfget.DEFAULT_SOCK), kept so the
# parser takes the same flags; nothing here opens it
DEFAULT_SOCK = "/tmp/dragonfly2_tpu_daemon.sock"
DAEMON_LEFT_OUT = (
    "dfmodel {cmd}: needs the daemon (publish/fetch ride its P2P piece "
    "engine), which the port has not ported yet — ROADMAP.md §1, queue item 4"
)

ROLLOUT_CMDS = ("status", "promote", "rollback")


async def _rollout_main(args: argparse.Namespace) -> int:
    """Manager-registry subcommands (status/promote/rollback)."""
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient

    mc = RemoteManagerClient(args.manager, timeout=args.timeout)
    try:
        if args.cmd == "status":
            st = await mc.rollout_status(args.type, args.scheduler_id)
            if args.json:
                print(json.dumps(st, indent=2, default=str))
                return 0
            pol = st["policy"]
            print(
                f"rollout[{args.type}]: gated={pol['gated']} "
                f"auto_promote={pol['auto_promote']} "
                f"min_rounds={pol['gates']['min_rounds']}"
            )
            act = st["active"]
            print(
                "  active:    "
                + (f"{act['version']} (id {act['id']})" if act else "<none>")
            )
            for c in st["candidates"]:
                agg = (c.get("rollout") or {}).get("aggregate") or {}
                # worst-round slicing: min/p99 expose a candidate
                # that is fine on average but catastrophic on a sliver of
                # rounds — the aggregate means alone hid that
                mn = agg.get("topk_overlap_min")
                p99 = agg.get("abs_delta_p99")
                topk = f"topk={agg.get('topk_overlap_mean', 0.0):.3f}"
                if mn is not None:
                    topk += f"(min={mn:.3f})"
                delta = f"delta={agg.get('abs_delta_mean', 0.0):.4f}"
                if p99 is not None:
                    delta += f"(p99<={p99:.3f})"
                print(
                    f"  {c['state']:<9}  {c['version']} (id {c['id']})"
                    f"  rounds={agg.get('rounds', 0)}"
                    f" {topk}"
                    f" corr={agg.get('rank_corr_mean', 0.0):.3f}"
                    f" {delta}"
                    f" errors={agg.get('errors', 0)}"
                )
                # per-population slicing: region × peer-count-band
                # buckets expose a candidate that only mis-ranks one child
                # population (e.g. a single region's flash crowds)
                ws = agg.get("worst_slice")
                sl = (agg.get("slices") or {}).get(ws)
                if ws and sl:
                    print(
                        f"             worst slice {ws}:"
                        f" rounds={sl.get('rounds', 0)}"
                        f" topk={sl.get('topk_overlap_mean', 0.0):.3f}"
                        f"(min={sl.get('topk_overlap_min', 0.0):.3f})"
                        f" corr={sl.get('rank_corr_mean', 0.0):.3f}"
                        f" delta={sl.get('abs_delta_mean', 0.0):.4f}"
                    )
            for r in st["rejected"]:
                reason = (r.get("rollout") or {}).get("rejected_reason", "")
                print(f"  rejected:  {r['version']} (id {r['id']})  {reason}")
            # feature drift: each scheduler member's max PSI vs
            # the serving model's training reference, read off the stats
            # frames the members already push — best-effort (a cluster with
            # no frames yet just prints nothing extra)
            try:
                # ONE decision boundary: sketches.classify_psi is what the
                # alert rule and dfml read too
                from dragonfly2_tpu_torch.observability.sketches import classify_psi

                cs = await mc.cluster_stats()
                for m in cs.get("members") or []:
                    if m.get("source_type") != "scheduler":
                        continue
                    rates = (m.get("frame") or {}).get("rates") or {}
                    drift = rates.get("feature_drift_max")
                    if drift is None:
                        continue
                    label = classify_psi(drift)
                    flag = f" [{label}]" if label != "stable" else ""
                    print(
                        f"  drift:     {m.get('hostname', '?')} "
                        f"feature_drift_max={drift:.3f}{flag}"
                    )
            except Exception:  # dflint: disable=DF031 drift line is best-effort decoration on status — a frameless cluster or old manager must not fail the command
                pass
            return 0
        if args.cmd == "promote":
            model_id = args.id
            if model_id is None:
                # scheduler_id is part of the row key (UNIQUE(type, version,
                # scheduler_id)) — without it the lowest-id row of ANOTHER
                # scheduler could be promoted instead of the one asked for
                rows = await mc.list_models(
                    type=args.type, version=args.version,
                    scheduler_id=args.scheduler_id,
                )
                if not rows:
                    print(
                        f"error: no {args.type} model {args.version} "
                        f"(scheduler_id {args.scheduler_id})",
                        file=sys.stderr,
                    )
                    return 1
                model_id = rows[0]["id"]
            row = await mc.promote_model(model_id)
            print(json.dumps({"id": row["id"], "version": row["version"], "state": row["state"]}))
            return 0
        # rollback
        out = await mc.rollback_model(args.type, args.scheduler_id, reason=args.reason)
        print(
            json.dumps(
                {
                    "rolled_back": out["rolled_back"]["version"],
                    "active": out["active"]["version"],
                }
            )
        )
        return 0
    except RpcError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await mc.close()


async def _amain(args: argparse.Namespace) -> int:
    if args.cmd in ROLLOUT_CMDS:
        if not args.manager:
            print(f"error: dfmodel {args.cmd} requires --manager", file=sys.stderr)
            return 2
        return await _rollout_main(args)
    print(f"error: {DAEMON_LEFT_OUT.format(cmd=args.cmd)}", file=sys.stderr)
    return 2


def main() -> None:
    ap = argparse.ArgumentParser(prog="dfmodel", description="P2P checkpoint fan-out CLI")
    ap.add_argument("--sock", default=DEFAULT_SOCK)
    ap.add_argument("--scheduler", default=None, help="scheduler addr (spawn only)")
    ap.add_argument("--storage", default=None, help="daemon storage root (spawn only)")
    ap.add_argument("--timeout", type=float, default=3600.0)
    ap.add_argument("--spawn-timeout", type=float, default=15.0)
    ap.add_argument("--no-spawn", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("publish", help="import a checkpoint dir into the P2P cache")
    p.add_argument("directory")
    p.add_argument("--name", default="")
    p = sub.add_parser("fetch", help="pull a manifest's files through P2P")
    p.add_argument("manifest", help="manifest path or URL")
    p.add_argument("-O", "--output", required=True)
    p.add_argument("--concurrency", type=int, default=4)

    def rollout_parser(name: str, help_: str):
        rp = sub.add_parser(name, help=help_)
        rp.add_argument("--manager", required=True, help="manager address host:port")
        rp.add_argument("--type", default="gnn", help="model type (default gnn)")
        rp.add_argument("--scheduler-id", type=int, default=0)
        return rp

    p = rollout_parser("status", "rollout state: active / shadowing / rejected versions")
    p.add_argument("--json", action="store_true")
    p = rollout_parser("promote", "promote a candidate/shadowing version to active")
    p.add_argument("--version", default=None)
    p.add_argument("--id", type=int, default=None)
    p = rollout_parser("rollback", "reject the active version, re-activate the previous")
    p.add_argument("--reason", default="operator rollback")
    args = ap.parse_args()
    if args.cmd == "promote" and args.version is None and args.id is None:
        ap.error("promote needs --version or --id")
    sys.exit(asyncio.run(_amain(args)))


if __name__ == "__main__":
    main()
