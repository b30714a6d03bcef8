#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dragonfly2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must hold or the run exits non-zero at once:

1. device    the card's name and count, nvidia-smi's name and power limit;
             TF32 off for matmuls and cuDNN.
2. build     every kernel source under dragonfly2_tpu_torch/csrc/ compiled with
             nvcc for sm_90a, one nvcc per source, all started together.
3. serving   the first main path at full width: a 16384-host cluster (K=16)
             and a TopoScorer with hidden 256, embed 128, 3 SAGE layers, head
             256, random weights from a seed at flax's init scale. GNNScorer
             refreshes on the card, 256 concurrent 40-candidate rounds go
             through MicroBatchScorer, and neighbor_aggregate (impl "auto")
             runs on the encoder's first hidden state over the cluster's
             neighbour table. The card is then held against the CPU on a
             1024-host cluster.
4. training  the second main path at full width: the same cluster and
             GNNTrainConfig(hidden 512, embed 128, 3 layers, batch 16384),
             trained from init_flax_like(seed 0) by train_async through the
             device-resident multi-step path, 2 calls of 10 steps, then 2
             calls of 10 with remat (the first remat call pays
             torch.utils.checkpoint's one-time import, so the second gives
             its steady rate); then the gradient of neighbor_aggregate
             on the trained encoder's first hidden state. Steps/s, peak
             memory with and without remat and the telemetry stub's count.
             Then 3 steps on the card against 3 on the CPU from the same
             start and batches, at 1024 hosts / hidden 256.
5. artifact  the trained model saved (save_artifact, save_graph, save_native),
             digested and verified, loaded back (load_gnn, load_graph) into a
             GNNScorer on the card, and 256 concurrent rounds served from it,
             equal to a scorer built from the in-memory trained weights.
6. kernels   each kernel against its plain PyTorch version on the card, at the
             main paths' shapes and on edge cases, then timed with CUDA events
             beside its plain version, its bound and one PyTorch library call.

Launch counts are set to 0 just before each main path and read just after.
Prints a ``{"kernels": [...]}`` line, the card line, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import concurrent.futures
import contextlib
import copy
import dataclasses
import json
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.native import MicroBatchScorer
from dragonfly2_tpu_torch.ops import _build, neighbor_agg_cuda, neighbor_aggregate
from dragonfly2_tpu_torch.ops.neighbor_agg_cuda import (
    neighbor_aggregate_bwd_cuda,
    neighbor_aggregate_bwd_torch,
    neighbor_aggregate_cuda,
    neighbor_aggregate_torch,
)
from dragonfly2_tpu_torch.trainer import artifacts, train_gnn
from dragonfly2_tpu_torch.trainer.synthetic import make_cluster, sample_batch

NUM_HOSTS, NUM_NEIGHBORS, GRAPH_SEED = 16384, 16, 7
MODEL = dict(hidden=256, embed_dim=128, num_layers=3, head_hidden=256)
WEIGHT_SEED = 0
ROUNDS, CANDIDATES, FLUSH_ROUNDS = 256, 40, 64
CPU_CHECK_HOSTS = 1024
# the repo's full-cluster training shape (bench.py:459, north-star config 3)
TRAIN = train_gnn.GNNTrainConfig(hidden=512, embed_dim=128, num_layers=3, batch_size=16384)
TRAIN_CALLS, REMAT_CALLS, STEPS_PER_CALL = 2, 2, 10
# the card against the CPU at bench.py:438's shape, 3 steps past a 1-step warm-up
CPU_TRAIN = train_gnn.GNNTrainConfig(hidden=256, embed_dim=128, num_layers=3, batch_size=4096, warmup_steps=1)
CPU_TRAIN_STEPS, TRAIN_LOSS_MAX_ABS, TRAIN_PARAM_MAX_ABS = 3, 2e-3, 1e-2
RELOAD_SCORE_MAX_ABS = 1e-6
# tests/test_ops.py's own tolerances for the Pallas kernel against XLA
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
EMBED_MIN_COSINE, SCORE_MAX_ABS = 0.999, 5e-3
# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
# A device-side spin of about 50 ms at the H100's ~2 GHz clock: long enough
# for the host to queue every launch of a timed run behind it.
SPIN_CYCLES = 100_000_000


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def nvidia_smi_line() -> str:
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return p.stdout.strip().splitlines()[0]


def events_ms(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Mean device time of fn() in ms, by CUDA events.

    With ``flush``, the buffer is rewritten before each launch so that the
    launch finds the 50 MB L2 cold, and events bracket each launch; the
    rewrite keeps the device busy while the host queues the launch. Without,
    launches run back to back behind a spin on the stream that lasts until
    the host has queued them all, so the events time the device and not the
    host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush.add_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def host_us_per_call(fn, iters: int) -> float:
    """Host time to issue one fn() while the device is held busy, in us."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    g, w = got.float().cpu(), want.float().cpu()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    tol = TOL[want.dtype]
    if got.dtype != want.dtype or got.shape != want.shape or not torch.allclose(g, w, **tol):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err {err:.3g}, "
            f"dtype {got.dtype} vs {want.dtype}, shape {tuple(got.shape)} vs {tuple(want.shape)})"
        )
    print(f"  {name}: max abs err {err:.3g}")
    return err


def round_inputs(cluster, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROUNDS rounds of CANDIDATES random (child, parent) pairs over the cluster."""
    rng = np.random.default_rng(seed)
    n = cluster.graph.node_feats.shape[0]
    child = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
    parent = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
    feats = cluster.pairs.feats[rng.integers(0, len(cluster.pairs.feats), (ROUNDS, CANDIDATES))]
    return feats, child, parent


def drive_rounds(scorer, feats, child, parent) -> tuple[MicroBatchScorer, np.ndarray, np.ndarray]:
    """All rounds at once through a MicroBatchScorer: (batcher, scores, per-round ms)."""

    async def drive():
        mb = MicroBatchScorer(scorer, max_rounds_per_flush=FLUSH_ROUNDS)

        async def one(r: int):
            t = time.perf_counter()
            out = await mb.score(feats[r], child=child[r], parent=parent[r])
            return out, time.perf_counter() - t

        res = await asyncio.gather(*(one(r) for r in range(len(feats))))
        return mb, res

    mb, res = asyncio.run(drive())
    scores = np.stack([out for out, _ in res])
    if scores.shape != child.shape or not np.all(np.isfinite(scores)):
        raise AssertionError(f"round scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if not np.all((scores > 0) & (scores < 1)):
        raise AssertionError("round scores fall outside (0, 1)")
    if mb.rounds != len(feats) or mb.flushes != -(-len(feats) // FLUSH_ROUNDS):
        raise AssertionError(f"{mb.rounds} rounds in {mb.flushes} flushes")
    return mb, scores, np.array([dt for _, dt in res]) * 1e3


def timed_refresh(scorer, graph) -> float:
    """Host ms of a second refresh (the first warms up); refresh ends in a
    device synchronise."""
    scorer.refresh(graph)
    t0 = time.perf_counter()
    scorer.refresh(graph)
    return (time.perf_counter() - t0) * 1e3


def serving(cluster, model, sd) -> tuple[dict, torch.Tensor]:
    """The first main path. Returns its numbers and the encoder's first
    hidden state, on which it ran the neighbour aggregation."""
    g = cluster.graph
    feats, child, parent = round_inputs(cluster, 11)

    torch.cuda.reset_peak_memory_stats()
    scorer = GNNScorer(model, sd, device="cuda")
    refresh_ms = timed_refresh(scorer, g)
    print(f"  refresh: {refresh_ms:.2f} ms (host clock, graph upload included)")
    drive_rounds(scorer, feats, child, parent)  # warm-up
    mb, scores, lat_ms = drive_rounds(scorer, feats, child, parent)
    # All rounds queue before the first flush, and the flusher drains them in
    # order, FLUSH_ROUNDS at a time; direct calls with the same grouping run
    # the same shapes and must agree exactly.
    direct = np.concatenate([
        scorer.score_rounds(feats[i : i + FLUSH_ROUNDS], child=child[i : i + FLUSH_ROUNDS],
                            parent=parent[i : i + FLUSH_ROUNDS])
        for i in range(0, ROUNDS, FLUSH_ROUNDS)
    ])
    if not np.array_equal(direct, scores):
        raise AssertionError(
            f"micro-batched scores differ from direct score_rounds by {np.abs(direct - scores).max():.3g}"
        )
    whole = scorer.score_rounds(feats, child=child, parent=parent)
    print(f"  {mb.rounds} rounds in {mb.flushes} flushes; p50 {np.percentile(lat_ms, 50):.3f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms; equal to direct score_rounds; "
          f"one {ROUNDS}-round call differs by {np.abs(whole - scores).max():.3g}")

    # neighbor_aggregate through the public dispatch, on the slice's own data
    enc = copy.deepcopy(model).cuda().eval()
    enc.load_state_dict(sd)
    with torch.inference_mode():
        gd = g.to("cuda")
        h0 = enc.encoder.Dense_0(gd.node_feats)  # [N, hidden] bf16
        agg = neighbor_aggregate(h0, gd.neighbors, gd.mask)
        torch.cuda.synchronize()
    if agg.shape != h0.shape or not torch.isfinite(agg).all():
        raise AssertionError("neighbor_aggregate gave non-finite values or the wrong shape")
    numbers = {
        "refresh_ms": refresh_ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "rounds": mb.rounds, "flushes": mb.flushes, "candidates": CANDIDATES,
        "round_p50_ms": float(np.percentile(lat_ms, 50)),
        "round_p99_ms": float(np.percentile(lat_ms, 99)),
    }
    print(f"  peak device memory: {numbers['max_memory_allocated_bytes'] / 2**20:.1f} MiB")
    return numbers, h0


def cpu_check(model, sd) -> dict:
    """The same weights on the card and on the CPU, on a smaller cluster."""
    small = make_cluster(num_nodes=CPU_CHECK_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
    mods = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).eval()
        m.load_state_dict(sd)
        mods[dev] = m
    with torch.inference_mode():
        zg = mods["cuda"].embed(small.graph.to("cuda")).cpu()
        zc = mods["cpu"].embed(small.graph.to("cpu"))
    cos = float(torch.nn.functional.cosine_similarity(zg, zc, dim=-1).min())
    rng = np.random.default_rng(12)
    child = rng.integers(0, CPU_CHECK_HOSTS, (64, CANDIDATES), dtype=np.int32)
    parent = rng.integers(0, CPU_CHECK_HOSTS, (64, CANDIDATES), dtype=np.int32)
    feats = small.pairs.feats[rng.integers(0, len(small.pairs.feats), (64, CANDIDATES))]
    out = {}
    for dev in ("cuda", "cpu"):
        s = GNNScorer(model, sd, device=dev)
        s.refresh(small.graph)
        out[dev] = s.score_rounds(feats, child=child, parent=parent)
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    print(f"  card vs CPU at {CPU_CHECK_HOSTS} hosts: embedding min cosine {cos:.6f}, "
          f"embedding max abs {float((zg - zc).abs().max()):.3g}, score max abs {err:.3g}")
    if cos < EMBED_MIN_COSINE or err > SCORE_MAX_ABS:
        raise AssertionError(f"card and CPU disagree: cosine {cos} < {EMBED_MIN_COSINE} or "
                             f"score err {err} > {SCORE_MAX_ABS}")
    return {"embed_min_cosine": cos, "score_max_abs": err}


class StepClock:
    """A telemetry stub: counts ``on_step`` calls and notes when each call's
    first step arrives, which is just after that call's one loss pull."""

    def __init__(self, steps_per_call: int):
        self.steps_per_call = steps_per_call
        self.steps: list[tuple[float, float]] = []
        self.pulled_at: list[float] = []

    def on_step(self, loss: float, grad_norm: float, *, examples: int) -> None:
        if len(self.steps) % self.steps_per_call == 0:
            self.pulled_at.append(time.perf_counter())
        self.steps.append((loss, grad_norm))


def train_run(cluster, cfg, calls: int) -> tuple[train_gnn.TrainState, list[float], dict]:
    """train_async through the multi-step path; its numbers."""
    clock = StepClock(STEPS_PER_CALL)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, losses = asyncio.run(train_gnn.train_async(
        cfg, cluster.graph, cluster.pairs, steps=calls * STEPS_PER_CALL, device="cuda", seed=WEIGHT_SEED,
        steps_per_call=STEPS_PER_CALL, log_every=STEPS_PER_CALL, log=lambda line: print(f"    train_async: {line}"),
        telemetry=clock,
    ))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(losses) != calls * STEPS_PER_CALL or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses: {len(losses)} of {calls * STEPS_PER_CALL}, finite {np.isfinite(losses).all()}")
    if len(clock.steps) != len(losses) or [lv for lv, _ in clock.steps] != losses:
        raise AssertionError(f"telemetry saw {len(clock.steps)} steps of {len(losses)}")
    # steps/s of each call after the first, on the host clock between pulls;
    # the first call's window opens at train_async's start, set-up included
    rates = [STEPS_PER_CALL / (b - a) for a, b in zip(clock.pulled_at, clock.pulled_at[1:])]
    first_s = clock.pulled_at[0] - t0
    numbers = {
        "steps": len(losses), "on_step_calls": len(clock.steps), "remat": cfg.remat,
        "first_loss": losses[0], "last_loss": losses[-1],
        "steps_per_s_after_first_call": rates, "first_call_s_with_setup": first_s, "wall_s": wall,
        "max_memory_allocated_bytes": peak,
    }
    rate_txt = ", ".join(f"{r:.2f}" for r in rates) or "n/a (one call)"
    print(f"  remat={cfg.remat}: {len(losses)} steps in {calls} calls, loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"steps/s after the first call {rate_txt}; first call {first_s:.2f} s with set-up; "
          f"peak device memory {peak / 2**30:.2f} GiB; on_step calls {len(clock.steps)}")
    return state, losses, numbers


def training(cluster) -> tuple[dict, train_gnn.TrainState]:
    """The second main path: train at full width, then the gradient of
    neighbor_aggregate on the trained encoder's first hidden state."""
    start = params_from_flax(init_flax_like(train_gnn.make_model(TRAIN), seed=WEIGHT_SEED))
    state, losses, plain = train_run(cluster, TRAIN, TRAIN_CALLS)
    trained = state.model.state_dict()
    moved = max(float((trained[k].cpu() - start[k]).abs().max()) for k in start)
    if moved == 0.0:
        raise AssertionError("training left every parameter where it started")
    _, remat_losses, remat = train_run(cluster, dataclasses.replace(TRAIN, remat=True), REMAT_CALLS)
    # the same seed draws the same batches, so remat retraces the plain run
    remat["loss_max_abs_vs_no_remat"] = float(np.abs(np.array(remat_losses) - np.array(losses)).max())
    print(f"  parameters moved by up to {moved:.3g}; remat's losses differ from the plain run's by up to "
          f"{remat['loss_max_abs_vs_no_remat']:.3g} (atomic-order noise in the backward)")

    gd = cluster.graph.to("cuda")
    with torch.no_grad():
        h0 = state.model.encoder.Dense_0(gd.node_feats)  # [N, hidden] bf16
    h0.requires_grad_()
    agg = neighbor_aggregate(h0, gd.neighbors, gd.mask)
    (gh,) = torch.autograd.grad((agg.float() ** 2).sum(), h0)
    torch.cuda.synchronize()
    if agg.grad_fn is None or gh.shape != h0.shape or not torch.isfinite(gh).all():
        raise AssertionError("neighbor_aggregate's gradient is missing, non-finite or of the wrong shape")
    return {"no_remat": plain, "remat": remat, "max_param_move": moved}, state


def cpu_train_check() -> dict:
    """3 steps on the card and 3 on the CPU from the same start and batches."""
    small = make_cluster(num_nodes=CPU_CHECK_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
    start = init_flax_like(train_gnn.make_model(CPU_TRAIN), seed=WEIGHT_SEED)
    rng = np.random.default_rng(13)
    batches = [sample_batch(small.pairs, CPU_TRAIN.batch_size, rng) for _ in range(CPU_TRAIN_STEPS)]
    out = {}
    for dev in ("cuda", "cpu"):
        state = train_gnn.init_state(CPU_TRAIN, params=start, device=dev)
        g = small.graph.to(dev)
        t0 = time.perf_counter()
        losses = [float(train_gnn.train_step(state, g, b)[1]) for b in batches]
        out[dev] = (losses, {k: v.cpu() for k, v in state.model.state_dict().items()}, time.perf_counter() - t0)
    (lg, pg, tg), (lc, pc, tc) = out["cuda"], out["cpu"]
    loss_err = float(np.abs(np.array(lg) - np.array(lc)).max())
    param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    print(f"  card vs CPU training at {CPU_CHECK_HOSTS} hosts / hidden {CPU_TRAIN.hidden}: losses "
          f"{[round(v, 6) for v in lg]} vs {[round(v, 6) for v in lc]}, max abs {loss_err:.3g}; "
          f"parameters max abs {param_err:.3g} ({tg:.1f} s on the card, {tc:.1f} s on the CPU)")
    if loss_err > TRAIN_LOSS_MAX_ABS or param_err > TRAIN_PARAM_MAX_ABS or not np.all(np.isfinite(lg)):
        raise AssertionError(f"card and CPU training disagree: loss {loss_err} > {TRAIN_LOSS_MAX_ABS} "
                             f"or parameters {param_err} > {TRAIN_PARAM_MAX_ABS}")
    return {"loss_max_abs": loss_err, "param_max_abs": param_err}


def artifact_handoff(cluster, state: train_gnn.TrainState) -> dict:
    """Save the trained model, verify it, load it back and serve from it."""
    trained = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    config = {"hidden": TRAIN.hidden, "embed_dim": TRAIN.embed_dim, "num_layers": TRAIN.num_layers}
    hosts = {f"host-{i}".encode(): i for i in range(NUM_HOSTS)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        artifacts.save_artifact(tmp, model_type="gnn", version="smoke", params=trained, config=config)
        artifacts.save_graph(tmp, cluster.graph, hosts)
        artifacts.save_native(tmp, train_gnn.make_model(TRAIN), trained, cluster.graph, device="cuda")
        save_s = time.perf_counter() - t0
        digest = artifacts.artifact_digest(tmp)
        artifacts.verify_artifact(tmp, digest)
        model, sd = artifacts.load_gnn(tmp)
        graph, host_index = artifacts.load_graph(tmp)
    if any(not torch.equal(sd[k], trained[k]) for k in trained) or len(host_index) != NUM_HOSTS:
        raise AssertionError("the reloaded artifact's parameters or host index differ from what was saved")
    feats, child, parent = round_inputs(cluster, 14)
    loaded = GNNScorer(model, sd, device="cuda")
    refresh_ms = timed_refresh(loaded, graph)
    mb, got, lat_ms = drive_rounds(loaded, feats, child, parent)
    memory = GNNScorer(state.model, trained, device="cuda")
    memory.refresh(cluster.graph)
    _, want, _ = drive_rounds(memory, feats, child, parent)
    err = float(np.abs(got - want).max())
    print(f"  artifact saved in {save_s:.1f} s, digest {digest[:16]}… verified; reloaded scorer: refresh "
          f"{refresh_ms:.2f} ms at hidden {TRAIN.hidden}; {mb.rounds} rounds in {mb.flushes} flushes, "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms; max abs vs the in-memory model {err:.3g}")
    if err > RELOAD_SCORE_MAX_ABS:
        raise AssertionError(f"reloaded scores differ from the in-memory model's by {err} > {RELOAD_SCORE_MAX_ABS}")
    return {"refresh_ms_hidden512": refresh_ms, "rounds": mb.rounds, "reload_score_max_abs": err,
            "round_p50_ms": float(np.percentile(lat_ms, 50))}


def edge_case_inputs() -> dict:
    """Named (h, neighbors, mask) CPU inputs that each kernel must get right."""
    rng = np.random.default_rng(0)

    def graph(n, k, h, p=0.7, lo=0):
        return (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)),
                torch.from_numpy(rng.integers(lo, n, (n, k)).astype(np.int32)),
                torch.from_numpy((rng.random((n, k)) < p).astype(np.float32)))

    cases = {f"random {n}x{k}x{h}": graph(n, k, h) for n, k, h in [(100, 7, 33), (257, 4, 64), (1, 2, 8)]}
    h, nbr, mask = graph(64, 4, 16)
    mask[3] = 0.0
    cases["fully masked row"] = (h, nbr, mask)
    cases["duplicate neighbours"] = (torch.arange(12.0).reshape(3, 4),
                                     torch.tensor([[1, 1], [0, 2], [0, 1]], dtype=torch.int32),
                                     torch.ones(3, 2))
    h, nbr, _ = graph(128, 8, 64)
    cases["fractional mask"] = (h, nbr, torch.from_numpy(rng.random((128, 8)).astype(np.float32)))
    h, nbr, mask = graph(50, 6, 32, p=1.0)
    nbr[0, 0], mask[0, 0] = 50 + 5, 0.0  # out of range, masked out
    nbr[1, 0] = -3                       # out of range, mask 1
    nbr[2, 1] = 50                       # out of range, mask 1
    cases["out-of-range index"] = (h, nbr, mask)
    cases["unaligned h (scalar path)"] = graph(40, 5, 64)
    cases["node 0 named by no slot"] = graph(48, 6, 64, p=0.8, lo=1)
    h, nbr, mask = graph(32, 16, 64, p=1.0)
    nbr[0] = 5
    cases["one neighbour named K times"] = (h, nbr, mask)
    return cases


def on_card(h: torch.Tensor, dt: torch.dtype, unaligned: bool) -> torch.Tensor:
    hd = h.to(dt).cuda()
    if unaligned:  # contiguous, but 2 or 4 bytes off a 16-byte line
        hd = torch.empty(h.numel() + 1, dtype=dt, device="cuda")[1:].view(h.shape).copy_(hd)
        if hd.data_ptr() % 16 == 0:
            raise AssertionError("unaligned case is aligned")
    return hd


def edge_cases() -> None:
    for name, (h, nbr, mask) in edge_case_inputs().items():
        n, nbr, mask = h.shape[0], nbr.cuda(), mask.cuda()
        for dt in (torch.float32, torch.bfloat16):
            hd = on_card(h, dt, name.startswith("unaligned"))
            got = neighbor_aggregate_cuda(hd, nbr, mask)
            compare(f"fwd {name} {str(dt)[6:]}", got, neighbor_aggregate_torch(hd, nbr, mask))
            if name == "fully masked row" and not bool((got[3] == 0).all()):
                raise AssertionError("fully masked row is not exactly 0")
            if name == "duplicate neighbours" and not torch.allclose(got[0].float(), hd[1].float(), rtol=1e-5):
                raise AssertionError("duplicate neighbours: the mean of h[1], h[1] is not h[1]")
            gh = neighbor_aggregate_bwd_cuda(hd, nbr, mask, n)  # h's values serve as the incoming gradient
            compare(f"bwd {name} {str(dt)[6:]}", gh, neighbor_aggregate_bwd_torch(hd, nbr, mask, n))
            if name == "node 0 named by no slot" and not bool((gh[0] == 0).all()):
                raise AssertionError("a node that no slot names does not get exactly 0")


def time_three(fns: dict) -> tuple[dict, dict]:
    """Mean ms of each fn with the L2 flushed before each launch, and back to back."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cold = {name: events_ms(fn, 50, flush) for name, fn in fns.items()}
    warm = {name: events_ms(fn, 50, None) for name, fn in fns.items()}
    return cold, warm


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def live_slots(nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (mask != 0) & (nbr >= 0) & (nbr < nbr.shape[0])


def kernel_row_fwd(h0: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, launches: int) -> dict:
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        h = h0.to(dt).contiguous()
        errs[dt] = compare(f"fwd main case [{h.shape[0]}, {nbr.shape[1]}, {h.shape[1]}] {str(dt)[6:]}",
                           neighbor_aggregate_cuda(h, nbr, mask), neighbor_aggregate_torch(h, nbr, mask))

    h = h0.contiguous()  # bf16, as the main path gives it
    n, k = nbr.shape
    hdim, b = h.shape[1], h.element_size()
    eps = 1e-6
    w = (mask / (mask.sum(dim=1, keepdim=True) + eps)).to(h.dtype)
    nbr64 = nbr.long()
    lib_out = F.embedding_bag(nbr64, h, per_sample_weights=w, mode="sum")
    lib_err = float((lib_out.float() - neighbor_aggregate_torch(h, nbr, mask).float()).abs().max())
    cold, warm = time_three({
        "kernel": lambda: neighbor_aggregate_cuda(h, nbr, mask),
        "plain": lambda: neighbor_aggregate_torch(h, nbr, mask),
        "library": lambda: F.embedding_bag(nbr64, h, per_sample_weights=w, mode="sum"),
    })
    host_us = host_us_per_call(lambda: neighbor_aggregate_cuda(h, nbr, mask), 50)

    # The least work this run's data needs: every h row that some live slot
    # names, read once; the whole mask; the indices of live slots; the output.
    live = live_slots(nbr, mask)
    rows = int(torch.unique(nbr[live]).numel())
    n_live = int(live.sum())
    nbytes = rows * hdim * b + n * k * 4 + n_live * 4 + n * hdim * b
    bound_ms, bound_by = bound(nbytes, 2 * n_live * hdim)
    print(f"  fwd timing bf16 [{n}, {k}, {hdim}] (L2 flushed / back to back): kernel {cold['kernel']:.4f} / "
          f"{warm['kernel']:.4f} ms, plain {cold['plain']:.4f} / {warm['plain']:.4f} ms, "
          f"embedding_bag {cold['library']:.4f} / {warm['library']:.4f} ms "
          f"(its max abs err vs plain {lib_err:.3g}); the kernel's wrapper takes {host_us:.1f} us "
          f"of host time a call")
    print(f"  fwd bound: {nbytes} bytes ({rows} distinct rows, {n_live} live slots) = {bound_ms * 1e3:.2f} us "
          f"({bound_by}); the formula N*H*b*2 + N*K*8 gives "
          f"{(2 * n * hdim * b + 8 * n * k) / HBM_BYTES_PER_S * 1e6:.2f} us")
    return {
        "name": "neighbor_agg_fwd", "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/neighbor_agg.cu",
        "replaces": "dragonfly2_tpu/ops/neighbor_agg_pallas.py:33",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
        "ms": cold["kernel"], "plain_ms": cold["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cold["library"],
        "ms_l2_warm": warm["kernel"], "plain_ms_l2_warm": warm["plain"], "library_ms_l2_warm": warm["library"],
        "host_us_per_launch": host_us,
        "dtype": "bfloat16", "shape": [n, k, hdim], "ok": True,
    }


def kernel_row_bwd(nbr: torch.Tensor, mask: torch.Tensor, hdim: int, launches: int) -> dict:
    n, k = nbr.shape
    g32 = torch.from_numpy(np.random.default_rng(21).normal(size=(n, hdim)).astype(np.float32)).cuda()
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        g = g32.to(dt)
        errs[dt] = compare(f"bwd main case [{n}, {k}, {hdim}] {str(dt)[6:]}",
                           neighbor_aggregate_bwd_cuda(g, nbr, mask, n), neighbor_aggregate_bwd_torch(g, nbr, mask, n))
        # the autograd path: K1 forward + K2 backward against autograd through the plain version
        grads = []
        for use_kernel in (True, False):
            h = g32.to(dt).requires_grad_()
            out = neighbor_aggregate(h, nbr, mask, impl="cuda") if use_kernel else neighbor_aggregate_torch(h, nbr, mask)
            grads.append(torch.autograd.grad((out.float() ** 2).sum(), h)[0])
        compare(f"autograd of neighbor_aggregate [{n}, {k}, {hdim}] {str(dt)[6:]}", *grads)

    g = g32.to(torch.bfloat16)  # the training path's dtype
    scale = mask / (mask.sum(dim=1, keepdim=True) + 1e-6)
    rows = (g.float()[:, None, :] * scale[..., None]).reshape(-1, hdim)  # the library call's input
    flat = nbr.reshape(-1).long()
    cold, warm = time_three({
        "kernel": lambda: neighbor_aggregate_bwd_cuda(g, nbr, mask, n),
        "plain": lambda: neighbor_aggregate_bwd_torch(g, nbr, mask, n),
        "library": lambda: torch.zeros(n, hdim, dtype=torch.float32, device="cuda").index_add_(0, flat, rows),
    })
    host_us = host_us_per_call(lambda: neighbor_aggregate_bwd_cuda(g, nbr, mask, n), 50)
    del rows

    # The least work this run's data needs: every g row with a live slot read
    # once; the whole mask; the indices of live slots; gh written once.
    live = live_slots(nbr, mask)
    src_rows = int(live.any(dim=1).sum())
    n_live = int(live.sum())
    b = g.element_size()
    nbytes = src_rows * hdim * b + n * k * 4 + n_live * 4 + n * hdim * b
    bound_ms, bound_by = bound(nbytes, 2 * n_live * hdim)
    print(f"  bwd timing bf16 [{n}, {k}, {hdim}] (L2 flushed / back to back): kernel {cold['kernel']:.4f} / "
          f"{warm['kernel']:.4f} ms, plain {cold['plain']:.4f} / {warm['plain']:.4f} ms, "
          f"index_add_ {cold['library']:.4f} / {warm['library']:.4f} ms; the kernel's wrapper takes "
          f"{host_us:.1f} us of host time a call")
    print(f"  bwd bound: {nbytes} bytes ({src_rows} source rows, {n_live} live slots) = {bound_ms * 1e3:.2f} us "
          f"({bound_by}); the formula N*H*b*2 + N*K*8 gives "
          f"{(2 * n * hdim * b + 8 * n * k) / HBM_BYTES_PER_S * 1e6:.2f} us; the f32 workspace adds "
          f"{n * hdim * 4 * 3 / HBM_BYTES_PER_S * 1e6:.2f} us (zeroing, read-modify-write, cast)")
    return {
        "name": "neighbor_agg_bwd", "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/neighbor_agg.cu",
        "replaces": "dragonfly2_tpu/ops/neighbor_agg_pallas.py:80",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
        "ms": cold["kernel"], "plain_ms": cold["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cold["library"],
        "ms_l2_warm": warm["kernel"], "plain_ms_l2_warm": warm["plain"], "library_ms_l2_warm": warm["library"],
        "host_us_per_launch": host_us,
        "dtype": "bfloat16", "shape": [n, k, hdim], "ok": True,
    }


def counts() -> dict:
    return {"neighbor_agg_fwd": neighbor_agg_cuda.LAUNCHES, "neighbor_agg_bwd": neighbor_agg_cuda.BWD_LAUNCHES}


def zero_counts() -> None:
    neighbor_agg_cuda.LAUNCHES = neighbor_agg_cuda.BWD_LAUNCHES = 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    with phase("device"):
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        card = nvidia_smi_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  device: {kind}, count {count}; nvidia-smi: {card}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; allow_tf32: matmul "
              f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")

    with phase("build"):
        t0 = time.perf_counter()
        names = _build.sources()
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(names)) as pool:
            built = dict(zip(names, pool.map(_build.build, names)))
        print(f"  {len(built)} kernel source(s) built in {time.perf_counter() - t0:.1f} s")
        for name, info in built.items():
            print(f"  {name}: " + (f"nvcc {info['seconds']:.1f} s" if info["log"] else "built already"))
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas: {line.strip()}")

    launches = {"neighbor_agg_fwd": 0, "neighbor_agg_bwd": 0}
    with phase("serving"):
        t0 = time.perf_counter()
        cluster = make_cluster(num_nodes=NUM_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
        print(f"  cluster: {NUM_HOSTS} hosts, K={NUM_NEIGHBORS}, built in {time.perf_counter() - t0:.1f} s")
        model = TopoScorer(**MODEL)
        sd = params_from_flax(init_flax_like(model, seed=WEIGHT_SEED))
        zero_counts()
        numbers, h0 = serving(cluster, model, sd)
        seen = counts()
        print(f"  kernel launches on the serving path: {seen}")
        if seen["neighbor_agg_fwd"] == 0:
            raise AssertionError("the serving path never launched neighbor_agg_fwd")
        launches = {k: launches[k] + v for k, v in seen.items()}
        numbers.update(cpu_check(model, sd))
        print(json.dumps({"serving": numbers, "card": card}))

    with phase("training"):
        zero_counts()
        train_numbers, state = training(cluster)
        seen = counts()
        print(f"  kernel launches on the training path: {seen}")
        if 0 in seen.values():
            raise AssertionError(f"the training path left a kernel unlaunched: {seen}")
        launches = {k: launches[k] + v for k, v in seen.items()}
        train_numbers["card_vs_cpu"] = cpu_train_check()
        print(json.dumps({"training": train_numbers, "card": card}))

    with phase("artifact"):
        print(json.dumps({"artifact": artifact_handoff(cluster, state), "card": card}))
        del state

    with phase("kernels"):
        g = cluster.graph.to("cuda")
        rows = [kernel_row_fwd(h0, g.neighbors, g.mask, launches["neighbor_agg_fwd"]),
                kernel_row_bwd(g.neighbors, g.mask, TRAIN.hidden, launches["neighbor_agg_bwd"])]
        edge_cases()

    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
