"""dftop: the cluster as one live screen (the port's own copy of
dragonfly2_tpu/cli/dftop.py, over the port's RemoteManagerClient).

Renders the manager's `cluster_stats` view — every member's windowed rates
(rounds/s, piece MB/s, loop lag p95, dispatcher utilization), serving mode,
rollout state, and active SLO alerts — refreshing in place like top(1).
The data is the stats frames services push on their keepalive ticks
(observability/timeseries.build_stats_frame), so dftop needs exactly one
RPC per refresh regardless of cluster size.

  python -m dragonfly2_tpu_torch.cli.dftop --manager 127.0.0.1:9200
  python -m dragonfly2_tpu_torch.cli.dftop --manager 127.0.0.1:9200 --once --json

--once --json prints one raw cluster_stats document and exits 0 when every
live member carries a fresh frame — the scripting/CI entry chip_smoke.py's
rollout phase drives.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

_CLEAR = "\x1b[2J\x1b[H"


def _fmt(v, nd: int = 2, width: int = 9) -> str:
    if v is None:
        return "-".rjust(width)
    if isinstance(v, float):
        return f"{v:.{nd}f}".rjust(width)
    return str(v).rjust(width)


def render(stats: dict, *, clear: bool = False) -> str:
    """One screenful of cluster state (pure text — unit-testable)."""
    cluster = stats.get("cluster") or {}
    rates = cluster.get("rates") or {}
    alerts = cluster.get("alerts") or []
    lines: list[str] = []
    if clear:
        lines.append(_CLEAR.rstrip("\n"))
    ts = stats.get("ts")
    when = time.strftime("%H:%M:%S", time.localtime(ts)) if ts else "-"
    lines.append(
        f"dftop — {when}  members {cluster.get('members_live', 0)} live"
        f" / {cluster.get('members_stale', 0)} stale"
        f"  cluster: {_fmt(rates.get('rounds_per_s')).strip()} rounds/s"
        f"  {_fmt(rates.get('piece_down_mb_per_s')).strip()} MB/s down"
        f"  {_fmt(rates.get('piece_up_mb_per_s')).strip()} MB/s up"
    )
    if alerts:
        names = ", ".join(f"{a['name']}@{a['member']}" for a in alerts)
        lines.append(f"ALERTS: {names}")
    else:
        lines.append("alerts: none")
    header = (
        f"{'member':<18} {'type':<9} {'age':>5} "
        f"{'work/s':>9} {'p95ms':>7} {'down MB/s':>10} {'up MB/s':>9} "
        f"{'cipher':>8} {'lag p95':>8} {'util':>5} {'deg':>4} {'serving':>8} "
        f"{'drift':>6} {'rollout':>12} alerts"
    )
    lines.append(header)
    lines.append("-" * len(header))
    for m in stats.get("members") or []:
        frame = m.get("frame") or {}
        r = frame.get("rates") or {}
        name = m.get("hostname", "?")
        if m.get("stale"):
            name += " (stale)"
        member_alerts = ",".join(frame.get("alerts") or ()) or "-"
        # brownout rung: 0..4 while the member's degradation
        # ladder is engaged; a member in manager-blackout autonomy flags it
        # next to its alerts so the operator sees BOTH failure planes here
        if r.get("manager_unreachable"):
            member_alerts = (
                "mgr_down" if member_alerts == "-" else member_alerts + ",mgr_down"
            )
        # "work/s" is each member's native unit of work: scheduling rounds
        # for a scheduler, training steps for a trainer (a trainer member
        # shows live learner work, not a blank)
        work = r.get("rounds_per_s")
        if work is None:
            work = r.get("train_steps_per_s")
        lines.append(
            f"{name:<18} {m.get('source_type', '?'):<9} "
            f"{_fmt(m.get('age_s'), 0, 5)} "
            f"{_fmt(work)} "
            f"{_fmt(r.get('round_p95_ms'), 2, 7)} "
            f"{_fmt(r.get('piece_down_mb_per_s'), 2, 10)} "
            f"{_fmt(r.get('piece_up_mb_per_s'), 2, 9)} "
            f"{str(frame.get('piece_cipher', '-')):>8} "
            f"{_fmt(r.get('loop_lag_p95_ms'), 1, 8)} "
            f"{_fmt(r.get('dispatcher_utilization'), 2, 5)} "
            f"{_fmt(r.get('degradation_level'), 0, 4)} "
            f"{str(frame.get('serving_mode', '-')):>8} "
            f"{_fmt(r.get('feature_drift_max'), 2, 6)} "
            f"{str(frame.get('rollout_state', '-')):>12} "
            f"{member_alerts}"
        )
    if not stats.get("members"):
        lines.append("(no members have reported a stats frame yet)")
    return "\n".join(lines)


def members_healthy(stats: dict, *, max_age_s: float | None = None) -> bool:
    """True when every non-stale member carries a frame with a rates dict
    (the --once exit-code contract the smoke leg gates on)."""
    members = [m for m in (stats.get("members") or []) if not m.get("stale")]
    if not members:
        return False
    for m in members:
        frame = m.get("frame") or {}
        if not isinstance(frame.get("rates"), dict):
            return False
        if max_age_s is not None and m.get("age_s", 1e9) > max_age_s:
            return False
    return True


async def _amain(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.rpc.core import RpcError
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient

    mc = RemoteManagerClient(args.manager, timeout=args.timeout)
    try:
        if args.once:
            stats = await mc.cluster_stats(history=args.history)
            if args.json:
                print(json.dumps(stats, indent=2, default=str))
            else:
                print(render(stats))
            return 0 if members_healthy(stats) else 3
        while True:
            try:
                stats = await mc.cluster_stats()
                print(render(stats, clear=True), flush=True)
            except RpcError as e:
                print(f"{_CLEAR}dftop: manager unreachable: {e}", flush=True)
            await asyncio.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    except RpcError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    finally:
        await mc.close()


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dftop", description="live cluster metrics dashboard (manager cluster_stats)"
    )
    ap.add_argument("--manager", required=True, help="manager RPC address host:port")
    ap.add_argument("--interval", type=float, default=2.0,
                    help="refresh cadence in seconds (live mode)")
    ap.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (0 = every live member "
                         "reported a frame, 3 = members missing/frameless)")
    ap.add_argument("--json", action="store_true",
                    help="with --once: print the raw cluster_stats JSON")
    ap.add_argument("--history", type=int, default=0,
                    help="with --once: include the last N frames per member")
    ap.add_argument("--timeout", type=float, default=10.0)
    args = ap.parse_args(argv)
    try:
        return asyncio.run(_amain(args))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
