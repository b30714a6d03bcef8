"""Refresh traffic: ``GNNScorer.refresh`` back to back over a ring of
probe-graph snapshots, each handed over as host arrays the way the
scheduler's topology hands a new snapshot to the scorer.

Set-up makes the cluster, the ring, the weights and the check's rounds
from the seed, builds the scorer and makes the traffic's warm-up
refreshes. The window's refreshes each end in the scorer's own
synchronise; the first one started after ``seconds`` ran out is its last,
on a snapshot of its own that no refresh has seen, so that tables left
from any earlier refresh cannot pass for it. The scorer then scores the
check's rounds through ``score_rounds``; with the scorer freed, the plain
reference scores them again from that last snapshot.
"""

from __future__ import annotations

import contextlib
import gc
import time

import torch
from torch.profiler import record_function

from benchmark import compare, devtrace, inputs, params
from benchmark.harness import Ctx, Outcome
from benchmark.reference import topo_scorer as ref


def build(ctx: Ctx):
    """The seed's inputs: cluster, snapshots, weights and rounds."""
    c, t = ctx.config, ctx.traffic
    cluster = inputs.make_cluster(c, ctx.seed, ctx.device)
    # the ring, and one snapshot more for the window's last refresh
    ring = inputs.snapshot_ring(cluster, ctx.seed, t["ring"] + 1, t["rtt_jitter"], t["degree_redraw_share"])
    rounds = inputs.make_rounds(cluster, ctx.seed, t["check_rounds"], c["candidates"], c["pair_features"])
    return cluster, ring, inputs.make_weights(c, ctx.seed, ctx.device), rounds


def reference_scores(ctx: Ctx, graph, p0: dict, rounds, q=ref.identity):
    """The rounds' scores on ``graph`` by the plain reference."""
    child, parent, feats = rounds
    with torch.no_grad():
        s = ref.scores(p0, graph, child.reshape(-1), parent.reshape(-1), feats.reshape(-1, feats.shape[-1]),
                       ctx.config["num_layers"], q)
    return s.reshape(child.shape).cpu().numpy()


def run(ctx: Ctx) -> Outcome:
    from dragonfly2_tpu_torch.models.graphsage import TopoGraph, TopoScorer
    from dragonfly2_tpu_torch.models.scorer import GNNScorer

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    _, snapshots, p0, rounds = build(ctx)
    host_ring = [TopoGraph(*(a.cpu().numpy() for a in g)) for g in snapshots]
    host_last = host_ring.pop()
    model = TopoScorer(hidden=c["hidden"], embed_dim=c["embed_dim"], num_layers=c["num_layers"],
                       head_hidden=c["head_hidden"])
    scorer = GNNScorer(model, params.state_dict(p0), device=dev)
    n = len(host_ring)
    for i in range(t["warmup_refreshes"]):
        scorer.refresh(host_ring[i % n])
    setup_s = time.perf_counter() - ctx.t0

    rf = record_function if ctx.trace else (lambda _name: contextlib.nullcontext())
    first = t["profile_after_refreshes"]
    last = first + t["profile_refreshes"] - 1
    prof = devtrace.Slice(cuda)
    spans = []
    try:
        t_open = time.perf_counter()
        i = 0
        over = False
        while not over:
            over = time.perf_counter() - t_open >= ctx.seconds
            if ctx.trace and i == first - 1:
                prof.start()
            if ctx.trace and i == first:
                prof.open()
            ts = time.perf_counter()
            with rf("bench.refresh"):
                scorer.refresh(host_last if over else host_ring[i % n])
            spans.append((ts, time.perf_counter(), ctx.trace and first - 1 <= i <= last))
            if ctx.trace and i == last:
                prof.close()
            i += 1
    finally:
        prof.close()
        slice_refreshes = max(0, min(i - 1, last) - first + 1) if ctx.trace else 0
    t_close = spans[-1][1]
    child, parent, feats = (a.cpu().numpy() for a in rounds)
    served = scorer.score_rounds(feats, child=child, parent=parent)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    plain = [(a, b) for a, b, traced in spans if not traced]
    host = {"refresh_s": sum(b - a for a, b in plain), "plain_refreshes": len(plain),
            "slice_refreshes": slice_refreshes}

    scorer.close()
    del scorer, model
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref.linear_no_tf32()
    readings = compare.score_readings(served, reference_scores(ctx, snapshots[-1], p0, rounds))
    count = len(spans)
    return Outcome(
        e2e={"embed_refresh_ms": (t_close - t_open) / count * 1e3},
        attempted=count, failed=0, setup_s=setup_s, memory_peak_bytes=int(memory_peak),
        readings=readings, host=host, trace=prof.trace,
    )
