"""dfml: the ML plane's operator CLI — decision-record replay and
training-run history (the port's own copy of dragonfly2_tpu/cli/dfml.py).

`explain` answers "why did THOSE parents win that scheduling round": it
fetches the scheduler's sampled decision records (scheduler/evaluator.py
DecisionRecorder over the `decision_records` RPC; also at /debug/decisions),
replays the recorded score vector through the SAME stable top-k argsort the
scheduler used, asserts the replayed choice matches the recorded one
bit-exact, and prints the per-candidate evidence — scores, ranks, and the
feature columns that separated winners from losers.

`decisions` lists recent records; `train` prints the trainer's per-run
manifests (run id, dataset size, steps, final loss, wall) with ASCII loss
curves from the bounded per-run telemetry.

  dfml explain   --scheduler host:port TASK CHILD
  dfml decisions --scheduler host:port [--task T] [--limit N] [--json]
  dfml train     --trainer host:port [--json] [--no-curves]

Exit codes: 0 ok; 1 RPC/usage error; 2 no matching record; 3 replay
mismatch (the recorded chosen set does not reproduce from the recorded
scores — a determinism bug worth paging on).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

import numpy as np

_SPARK = "▁▂▃▄▅▆▇█"


def sparkline(values: list[float], width: int = 48) -> str:
    """Bounded ASCII curve: downsample to `width` evenly-spaced samples
    (linspace, so the FIRST and LAST points always render — a stride-and-
    truncate would drop the curve's tail, hiding end-of-run divergence),
    scaled to the 8-level block ramp. Non-finite points render as '!'."""
    if not values:
        return ""
    idxs = np.linspace(0, len(values) - 1, min(width, len(values)))
    vals = [values[int(round(i))] for i in idxs]
    finite = [v for v in vals if np.isfinite(v)]
    if not finite:
        return "!" * len(vals)
    lo, hi = min(finite), max(finite)
    span = (hi - lo) or 1.0
    out = []
    for v in vals:
        if not np.isfinite(v):
            out.append("!")
        else:
            out.append(_SPARK[int((v - lo) / span * (len(_SPARK) - 1))])
    return "".join(out)


def replay_topk(scores: list[float], k: int) -> list[int]:
    """EXACTLY Scheduling._top_parents' selection: stable argsort of the
    negated scores, first k indices. The bit-exact replay contract
    `explain` (and chip_smoke.py's rollout phase) gates on lives here."""
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    return [int(i) for i in order[:k]]


def explain_record(record: dict, *, out=print) -> bool:
    """Render one decision record + verify the replay. Returns replay_exact."""
    scores = record["scores"]
    parents = record["parents"]
    k = int(record.get("topk", 4))
    replay_idx = replay_topk(scores, k)
    replayed = [parents[i]["peer"] for i in replay_idx]
    exact = replayed == list(record.get("chosen", []))
    out(
        f"decision seq={record['seq']} ts={record['ts']:.3f} "
        f"task={record['task_id']} child={record['child_peer']}@{record['child_host']}"
    )
    out(
        f"  model={record.get('model_version') or '<base>'} "
        f"mode={record.get('serving_mode', '?')} "
        f"trace={record.get('trace_id') or '-'} "
        f"candidates={len(parents)} topk={k}"
    )
    feats = record.get("feats")
    fnames = None
    fmat = None
    if feats:
        from dragonfly2_tpu_torch.models.features import FEATURE_NAMES

        if len(feats[0]) == len(FEATURE_NAMES):
            fnames = FEATURE_NAMES
        fmat = np.asarray(feats, np.float64)
        col_mean = fmat.mean(axis=0)
    order = np.argsort(-np.asarray(scores, np.float64), kind="stable")
    chosen_set = set(record.get("chosen", []))
    for rank, i in enumerate(order):
        p = parents[int(i)]
        mark = "*" if p["peer"] in chosen_set else " "
        line = (
            f"  {mark} #{rank + 1:<2} {p['peer']:<24} host={p['host']:<16} "
            f"score={scores[int(i)]:+.6f}"
        )
        if fmat is not None and fnames is not None and rank < k:
            # the columns that most separate this winner from the field:
            # largest |value - candidate-set mean| — model-agnostic evidence
            # (base/MLP weights are linear; the GNN's saliency is not, but
            # "what was unusual about this candidate" is always answerable)
            row = fmat[int(i)]
            top = np.argsort(-np.abs(row - col_mean))[:3]
            line += "  " + " ".join(
                f"{fnames[j]}={row[j]:.3f}(μ{col_mean[j]:+.3f})" for j in top
            )
        out(line)
    verdict = (
        "== recorded (bit-exact)" if exact
        else f"!= recorded {list(record.get('chosen', []))}"
    )
    out(f"  replay: argsort(stable) top-{k} -> {replayed} {verdict}")
    return exact


async def _explain(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

    sc = RemoteSchedulerClient(args.scheduler, timeout=args.timeout)
    try:
        doc = await sc.decision_records(
            task_id=args.task, child=args.child, limit=args.limit
        )
    finally:
        await sc.close()
    records = doc.get("records") or []
    if args.json:
        # machine-readable: ONLY the JSON document on stdout (with the
        # replay verdict folded in), same contract as the sibling
        # subcommands — the human rendering below must not trail it
        verdicts = [
            [r["parents"][i]["peer"] for i in replay_topk(r["scores"], int(r.get("topk", 4)))]
            == list(r.get("chosen", []))
            for r in records
        ]
        print(json.dumps(
            {**doc, "records": records, "replay_exact": verdicts},
            indent=2, default=str,
        ))
        if not records:
            return 2
        return 0 if all(verdicts) else 3
    if not records:
        stats = doc.get("recorder") or {}
        print(
            f"no recorded decision for task={args.task} child={args.child} "
            f"(recorder: {stats.get('records', 0)} records, sample_rate="
            f"{stats.get('sample_rate')}; raise DRAGONFLY_DECISION_SAMPLE "
            f"or retry after more rounds)",
            file=sys.stderr,
        )
        return 2
    drift = doc.get("drift") or {}
    if drift.get("psi_max") is not None:
        from dragonfly2_tpu_torch.observability.sketches import classify_psi

        label = classify_psi(drift["psi_max"])
        flag = f" [{label.upper()} SHIFT]" if label != "stable" else ""
        print(
            f"feature drift vs {drift.get('reference_version') or '?'}: "
            f"psi_max={drift['psi_max']}{flag} "
            f"drifted={drift.get('drifted') or []}"
        )
    ok = True
    for record in records[: 1 if not args.all else len(records)]:
        if not explain_record(record):
            ok = False
    return 0 if ok else 3


async def _decisions(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

    sc = RemoteSchedulerClient(args.scheduler, timeout=args.timeout)
    try:
        doc = await sc.decision_records(
            task_id=args.task, limit=args.limit, with_features=False
        )
    finally:
        await sc.close()
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
        return 0
    stats = doc.get("recorder") or {}
    print(
        f"decision recorder: {stats.get('records', 0)} records "
        f"(sample_rate={stats.get('sample_rate')}, "
        f"rounds_seen={stats.get('rounds_seen')}), serving="
        f"{doc.get('serving_version') or '<base>'}"
    )
    for r in doc.get("records") or []:
        print(
            f"  seq={r['seq']:<5} ts={r['ts']:.3f} task={r['task_id']:<20} "
            f"child={r['child_peer']:<22} candidates={len(r['parents']):<3} "
            f"chosen={','.join(r['chosen'])}"
        )
    return 0


async def _train(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.rpc.trainer import RemoteTrainerClient

    tc = RemoteTrainerClient(args.trainer, timeout=args.timeout)
    try:
        doc = await tc.train_history(
            limit=args.limit, with_curves=not args.no_curves
        )
    finally:
        await tc.close()
    if args.json:
        print(json.dumps(doc, indent=2, default=str))
        return 0
    runs = doc.get("runs") or []
    print(f"train runs: {doc.get('total', len(runs))} recorded")
    if not runs:
        return 0
    for r in runs:
        ds = r.get("dataset") or {}
        print(
            f"  {r['run_id']:<22} {r.get('status', '?'):<8} "
            f"pairs={ds.get('pairs', 0):<8} nodes={ds.get('nodes', 0):<7} "
            f"wall={r.get('wall_s', 0.0):>7.2f}s"
        )
        for m, info in sorted((r.get("models") or {}).items()):
            line = (
                f"    {m}: steps={info.get('steps', 0)} "
                f"loss={info.get('final_loss')} "
                f"grad_norm={info.get('grad_norm')} "
                f"steps/s={info.get('steps_per_sec')}"
            )
            print(line)
            curve = info.get("curve") or []
            if curve and not args.no_curves:
                print(f"    {m} loss {sparkline([c[1] for c in curve])}")
    return 0


async def _amain(args: argparse.Namespace) -> int:
    from dragonfly2_tpu_torch.rpc.core import RpcError

    try:
        if args.cmd == "explain":
            return await _explain(args)
        if args.cmd == "decisions":
            return await _decisions(args)
        return await _train(args)
    except RpcError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="dfml",
        description="ML-plane observability: decision replay + train history",
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("explain", help="replay a recorded scoring decision")
    p.add_argument("--scheduler", required=True, help="scheduler RPC host:port")
    p.add_argument("task", help="task id the round scheduled")
    p.add_argument("child", help="child peer id or child host id")
    p.add_argument("--limit", type=int, default=8)
    p.add_argument("--all", action="store_true",
                   help="explain every matching record, not just the newest")
    p.add_argument("--json", action="store_true")
    p.add_argument("--timeout", type=float, default=10.0)

    p = sub.add_parser("decisions", help="list recent decision records")
    p.add_argument("--scheduler", required=True, help="scheduler RPC host:port")
    p.add_argument("--task", default=None)
    p.add_argument("--limit", type=int, default=16)
    p.add_argument("--json", action="store_true")
    p.add_argument("--timeout", type=float, default=10.0)

    p = sub.add_parser("train", help="training-run history + loss curves")
    p.add_argument("--trainer", required=True, help="trainer RPC host:port")
    p.add_argument("--limit", type=int, default=16)
    p.add_argument("--no-curves", action="store_true")
    p.add_argument("--json", action="store_true")
    p.add_argument("--timeout", type=float, default=10.0)

    args = ap.parse_args(argv)
    return asyncio.run(_amain(args))


if __name__ == "__main__":
    sys.exit(main())
