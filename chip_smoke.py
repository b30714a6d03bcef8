#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dragonfly2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must hold or the run exits non-zero at once:

1. device   the card's name and count, nvidia-smi's name and power limit;
            TF32 off for matmuls and cuDNN.
2. build    every kernel under dragonfly2_tpu_torch/csrc/ compiled with nvcc
            for sm_90a.
3. serving  the main path at full width: a 16384-host cluster (K=16) and a
            TopoScorer with hidden 256, embed 128, 3 SAGE layers, head 256,
            random weights from a seed at flax's init scale. GNNScorer
            refreshes on the card, 256 concurrent 40-candidate rounds go
            through MicroBatchScorer, and neighbor_aggregate (impl "auto")
            runs on the encoder's first hidden state over the cluster's
            neighbour table. Launch counts are zeroed just before and read
            just after. The card is then held against the CPU on a
            1024-host cluster.
4. kernels  each kernel against its plain PyTorch version on the card, at the
            main path's shapes and on edge cases, then timed with CUDA events
            beside its plain version, its bound and one PyTorch library call.

Prints a ``{"kernels": [...]}`` line, the card line, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import asyncio
import contextlib
import copy
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.native import MicroBatchScorer
from dragonfly2_tpu_torch.ops import _build, neighbor_agg_cuda, neighbor_aggregate
from dragonfly2_tpu_torch.ops.neighbor_agg_cuda import neighbor_aggregate_cuda, neighbor_aggregate_torch
from dragonfly2_tpu_torch.trainer.synthetic import make_cluster

NUM_HOSTS, NUM_NEIGHBORS, GRAPH_SEED = 16384, 16, 7
MODEL = dict(hidden=256, embed_dim=128, num_layers=3, head_hidden=256)
WEIGHT_SEED = 0
ROUNDS, CANDIDATES, FLUSH_ROUNDS = 256, 40, 64
CPU_CHECK_HOSTS = 1024
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


def serving(cluster, model, sd) -> tuple[dict, torch.Tensor]:
    """The main path. Returns its numbers and the encoder's first hidden
    state, on which it ran the neighbour aggregation."""
    g = cluster.graph
    rng = np.random.default_rng(11)
    child = rng.integers(0, NUM_HOSTS, (ROUNDS, CANDIDATES), dtype=np.int32)
    parent = rng.integers(0, NUM_HOSTS, (ROUNDS, CANDIDATES), dtype=np.int32)
    feats = cluster.pairs.feats[rng.integers(0, len(cluster.pairs.feats), (ROUNDS, CANDIDATES))]

    torch.cuda.reset_peak_memory_stats()
    scorer = GNNScorer(model, sd, device="cuda")
    scorer.refresh(g)  # warm-up
    t0 = time.perf_counter()
    scorer.refresh(g)  # ends in torch.cuda.synchronize()
    refresh_ms = (time.perf_counter() - t0) * 1e3
    print(f"  refresh: {refresh_ms:.2f} ms (host clock, graph upload included)")

    async def drive():
        mb = MicroBatchScorer(scorer, max_rounds_per_flush=FLUSH_ROUNDS)

        async def one(r: int):
            t = time.perf_counter()
            out = await mb.score(feats[r], child=child[r], parent=parent[r])
            return out, time.perf_counter() - t

        res = await asyncio.gather(*(one(r) for r in range(ROUNDS)))
        return mb, res

    asyncio.run(drive())  # warm-up
    mb, res = asyncio.run(drive())
    scores = np.stack([out for out, _ in res])
    lat_ms = np.array([dt for _, dt in res]) * 1e3
    if scores.shape != (ROUNDS, CANDIDATES) or not np.all(np.isfinite(scores)):
        raise AssertionError(f"round scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if not np.all((scores > 0) & (scores < 1)):
        raise AssertionError("round scores fall outside (0, 1)")
    # All rounds queue before the first flush, and the flusher drains them in
    # order, FLUSH_ROUNDS at a time; direct calls with the same grouping run
    # the same shapes and must agree exactly.
    if mb.rounds != ROUNDS or mb.flushes != ROUNDS // FLUSH_ROUNDS:
        raise AssertionError(f"{mb.rounds} rounds in {mb.flushes} flushes")
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


def edge_cases() -> None:
    rng = np.random.default_rng(0)

    def graph(n, k, h, p=0.7):
        return (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)),
                torch.from_numpy(rng.integers(0, n, (n, k)).astype(np.int32)),
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
    for name, (h, nbr, mask) in cases.items():
        for dt in (torch.float32, torch.bfloat16):
            hd = h.to(dt).cuda()
            if name.startswith("unaligned"):  # contiguous, but 2 or 4 bytes off a 16-byte line
                hd = torch.empty(h.numel() + 1, dtype=dt, device="cuda")[1:].view(h.shape).copy_(hd)
                if hd.data_ptr() % 16 == 0:
                    raise AssertionError("unaligned case is aligned")
            got = neighbor_aggregate_cuda(hd, nbr.cuda(), mask.cuda())
            compare(f"{name} {str(dt)[6:]}", got, neighbor_aggregate_torch(hd, nbr.cuda(), mask.cuda()))
            if name == "fully masked row" and not bool((got[3] == 0).all()):
                raise AssertionError("fully masked row is not exactly 0")
            if name == "duplicate neighbours" and not torch.allclose(got[0].float(), hd[1].float(), rtol=1e-5):
                raise AssertionError("duplicate neighbours: the mean of h[1], h[1] is not h[1]")


def kernel_row(h0: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, launches: int) -> dict:
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        h = h0.to(dt).contiguous()
        errs[dt] = compare(f"main case [{h.shape[0]}, {nbr.shape[1]}, {h.shape[1]}] {str(dt)[6:]}",
                           neighbor_aggregate_cuda(h, nbr, mask), neighbor_aggregate_torch(h, nbr, mask))
    edge_cases()

    h = h0.contiguous()  # bf16, as the main path gives it
    n, k = nbr.shape
    hdim, b = h.shape[1], h.element_size()
    eps = 1e-6
    w = (mask / (mask.sum(dim=1, keepdim=True) + eps)).to(h.dtype)
    nbr64 = nbr.long()
    lib_out = F.embedding_bag(nbr64, h, per_sample_weights=w, mode="sum")
    lib_err = float((lib_out.float() - neighbor_aggregate_torch(h, nbr, mask).float()).abs().max())
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    fns = {
        "kernel": lambda: neighbor_aggregate_cuda(h, nbr, mask),
        "plain": lambda: neighbor_aggregate_torch(h, nbr, mask),
        "library": lambda: F.embedding_bag(nbr64, h, per_sample_weights=w, mode="sum"),
    }
    cold = {name: events_ms(fn, 50, flush) for name, fn in fns.items()}
    warm = {name: events_ms(fn, 50, None) for name, fn in fns.items()}
    host_us = host_us_per_call(fns["kernel"], 50)

    # The least work this run's data needs: every h row that some live slot
    # names, read once; the whole mask; the indices of live slots; the output.
    live = (mask != 0) & (nbr >= 0) & (nbr < n)
    rows = int(torch.unique(nbr[live]).numel())
    n_live = int(live.sum())
    nbytes = rows * hdim * b + n * k * 4 + n_live * 4 + n * hdim * b
    flops = 2 * n_live * hdim
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    print(f"  timing bf16 [{n}, {k}, {hdim}] (L2 flushed / back to back): kernel {cold['kernel']:.4f} / "
          f"{warm['kernel']:.4f} ms, plain {cold['plain']:.4f} / {warm['plain']:.4f} ms, "
          f"embedding_bag {cold['library']:.4f} / {warm['library']:.4f} ms "
          f"(its max abs err vs plain {lib_err:.3g}); the kernel's wrapper takes {host_us:.1f} us "
          f"of host time a call")
    print(f"  bound: {nbytes} bytes ({rows} distinct rows, {n_live} live slots) = {bytes_ms * 1e3:.2f} us "
          f"at 3.35 TB/s; {flops} flops = {flops_ms * 1e3:.3f} us; the formula N*H*b*2 + N*K*8 gives "
          f"{(2 * n * hdim * b + 8 * n * k) / HBM_BYTES_PER_S * 1e6:.2f} us")
    return {
        "name": "neighbor_agg_fwd", "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/neighbor_agg.cu",
        "replaces": "dragonfly2_tpu/ops/neighbor_agg_pallas.py:33",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
        "ms": cold["kernel"], "plain_ms": cold["plain"],
        "bound_ms": max(bytes_ms, flops_ms), "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "library_ms": cold["library"],
        "ms_l2_warm": warm["kernel"], "plain_ms_l2_warm": warm["plain"], "library_ms_l2_warm": warm["library"],
        "host_us_per_launch": host_us,
        "dtype": "bfloat16", "shape": [n, k, hdim], "ok": True,
    }


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
        built = {name: _build.build(name) for name in _build.sources()}
        print(f"  {len(built)} kernel source(s) built in {time.perf_counter() - t0:.1f} s")
        for name, info in built.items():
            print(f"  {name}: " + (f"nvcc {info['seconds']:.1f} s" if info["log"] else "built already"))
            for line in info["log"].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"    ptxas: {line.strip()}")

    with phase("serving"):
        t0 = time.perf_counter()
        cluster = make_cluster(num_nodes=NUM_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
        print(f"  cluster: {NUM_HOSTS} hosts, K={NUM_NEIGHBORS}, built in {time.perf_counter() - t0:.1f} s")
        model = TopoScorer(**MODEL)
        sd = params_from_flax(init_flax_like(model, seed=WEIGHT_SEED))
        neighbor_agg_cuda.LAUNCHES = 0
        numbers, h0 = serving(cluster, model, sd)
        launches = neighbor_agg_cuda.LAUNCHES
        print(f"  kernel launches on the main path: neighbor_agg_fwd {launches}")
        if launches == 0:
            raise AssertionError("the main path never launched neighbor_agg_fwd")
        numbers.update(cpu_check(model, sd))
        print(json.dumps({"serving": numbers, "card": card}))

    with phase("kernels"):
        g = cluster.graph.to("cuda")
        row = kernel_row(h0, g.neighbors, g.mask, launches)

    print(json.dumps({"kernels": [row]}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
