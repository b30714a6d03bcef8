"""Training traffic: back-to-back ``train_gnn.make_multi_step`` calls, each
followed by its one pull of the call's losses and gradient norms, as the
trainer's ``train_async`` drives them.

Set-up builds the train state and the multi-step from the seed's weights,
graph and pair pool, and makes the traffic's warm-up calls. The first of
them is observed: the optimiser's state after its first step and the
parameters after the checked steps are copied out as they happen. The
same state and multi-step then run the window. Once the window has closed
and the program's state is freed, the plain reference works the checked
steps out again from the same inputs and batch rows.
"""

from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from benchmark import compare, devtrace, inputs, params
from benchmark.harness import Ctx, Outcome
from benchmark.reference import topo_scorer as ref


def _batch_seed(seed: int) -> int:
    """The trainer's batch-generator seed, from the run's seed."""
    return int(torch.randint(0, 2**62, (1,), generator=inputs.generator(seed, "cpu", 4)))


def hyper(c: dict) -> dict:
    return {k: c[k] for k in ("learning_rate", "weight_decay", "warmup_steps", "decay_steps",
                              "end_lr_ratio", "clip_norm", "adam_b1", "adam_b2", "adam_eps")}


def build(ctx: Ctx):
    """The seed's inputs: cluster, weights and the trainer's batch seed."""
    c = ctx.config
    return inputs.make_cluster(c, ctx.seed, ctx.device), inputs.make_weights(c, ctx.seed, ctx.device), \
        _batch_seed(ctx.seed)


def reference_observation(ctx: Ctx, cluster, p0: dict, batch_seed: int,
                          q=ref.identity, rows: slice | None = None) -> dict:
    """The checked steps worked out by the plain reference (``q`` and
    ``rows`` give the precision control and the half-batch fault)."""
    c, t = ctx.config, ctx.traffic
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(batch_seed)
    batches = inputs.batch_rows(gen, c["pair_pool"], c["batch_size"], t["checked_steps"], ctx.device)
    out = ref.train(p0, cluster.graph, cluster.pairs, batches, hyper(c), c["num_layers"], q, rows)
    return {"losses": out["losses"], "grad": out["first_grads"],
            "change": {k: out["params"][k] - p0[k] for k in p0}}


def _observe_first_call(state, multi, checked: int, b1: float):
    """Run the first call with the optimiser's step observed: its moments
    after step 1 and its parameters after step ``checked`` are copied.
    Returns the call's pulled losses and norms, and the copies."""
    opt = state.optimizer
    step = opt.step
    seen: dict[str, list[torch.Tensor]] = {}

    def observed(count: int):
        gnorm = step(count)
        if count == 0:
            seen["grad"] = [m.detach() / (1 - b1) for m in opt.mu]
        if count == checked - 1:
            seen["params"] = [p.detach().clone() for p in opt.params]
        return gnorm

    opt.step = observed
    try:
        state, (losses, norms) = multi(state)
        pulled = torch.stack([losses, norms]).cpu().numpy()
    finally:
        del opt.step
    return state, pulled, seen


def run(ctx: Ctx) -> Outcome:
    from dragonfly2_tpu_torch.models.graphsage import TopoGraph
    from dragonfly2_tpu_torch.trainer import train_gnn
    from dragonfly2_tpu_torch.trainer.synthetic import PairBatch

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    cuda = dev.type == "cuda"
    steps = t["steps_per_call"]
    cluster, p0, batch_seed = build(ctx)
    cfg = train_gnn.GNNTrainConfig(
        hidden=c["hidden"], embed_dim=c["embed_dim"], num_layers=c["num_layers"], batch_size=c["batch_size"],
        learning_rate=c["learning_rate"], weight_decay=c["weight_decay"], warmup_steps=c["warmup_steps"],
    )
    state = train_gnn.init_state(cfg, params=params.flax_tree(p0), device=dev)
    pool = PairBatch(*(a.cpu().numpy() for a in cluster.pairs))
    multi = train_gnn.make_multi_step(state, TopoGraph(*cluster.graph), pool, batch_size=c["batch_size"],
                                      steps_per_call=steps, with_metrics=True, seed=batch_seed)
    names = {id(p): n for n, p in state.model.named_parameters()}
    by_torch = {params.torch_name(k): k for k in p0}
    leaves = [by_torch[names[id(p)]] for p in state.optimizer.params]
    p0_program = params.state_dict(p0)

    state, first, seen = _observe_first_call(state, multi, t["checked_steps"], c["adam_b1"])
    flax_layout = {k: (lambda w, k=k: w.t() if k.endswith("/kernel") else w) for k in leaves}
    program = {
        "losses": [float(x) for x in first[0][: t["checked_steps"]]],
        "grad": {k: flax_layout[k](g) for k, g in zip(leaves, seen.pop("grad"))},
        "change": {k: flax_layout[k](w - p0_program[params.torch_name(k)]) for k, w in zip(leaves, seen.pop("params"))},
    }
    for _ in range(t["warmup_calls"] - 1):
        state, (losses, norms) = multi(state)
        torch.stack([losses, norms]).cpu()
    setup_s = time.perf_counter() - ctx.t0

    # the window: calls back to back; it closes at the pull of the last
    # call started before ``seconds`` ran out. A traced run profiles
    # ``profile_calls`` calls, the profiler on from the call before them.
    rf = record_function if ctx.trace else (lambda _name: contextlib.nullcontext())
    first, last = t["profile_after_calls"], t["profile_after_calls"] + t["profile_calls"] - 1
    prof = devtrace.Slice(cuda)
    calls, pulled = [], []
    try:
        t_open = time.perf_counter()
        i = 0
        while time.perf_counter() - t_open < ctx.seconds:
            if ctx.trace and i == first - 1:
                prof.start()
            if ctx.trace and i == first:
                prof.open()
            ts = time.perf_counter()
            with rf("bench.multi_step"):
                state, (losses, norms) = multi(state)
            tr = time.perf_counter()
            with rf("bench.pull"):
                pulled.append(torch.stack([losses, norms]).cpu().numpy())
            tp = time.perf_counter()
            calls.append((ts, tr, tp, ctx.trace and first - 1 <= i <= last))
            if ctx.trace and i == last:
                prof.close()
            i += 1
    finally:
        prof.close()
        slice_calls = max(0, min(i - 1, last) - first + 1) if ctx.trace else 0
    t_close = calls[-1][2]
    values = np.concatenate(pulled, axis=1)
    memory_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    plain = [(ts, tr, tp) for ts, tr, tp, traced in calls if not traced]
    host = {
        "steps_per_call": steps,
        "enqueue_s": sum(tr - ts for ts, tr, _ in plain),
        "call_s": sum(tp - ts for ts, _, tp in plain),
        "plain_steps": steps * len(plain),
        "slice_steps": steps * slice_calls,
    }
    attempted = values.shape[1]
    failed = int((~np.isfinite(values)).any(axis=0).sum())

    del multi, state
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    ref.linear_no_tf32()
    readings = compare.train_readings(program, reference_observation(ctx, cluster, p0, batch_seed))
    return Outcome(
        e2e={"train_steps_per_s": attempted / (t_close - t_open)}, attempted=attempted, failed=failed,
        setup_s=setup_s, memory_peak_bytes=int(memory_peak), readings=readings, host=host,
        trace=prof.trace,
    )
