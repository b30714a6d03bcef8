"""The train step's device-side schedule and the multi-step's choice of path, on the CPU.

``ClippedAdamW`` reads its learning rate and Adam's bias corrections from a
table on the parameters' device, indexed by the step count, so that a
CUDA graph of the call takes each replay's count from device memory. The
table must hold, at every count, the float the host computed at that
count (rounded to float32, as the update's kernels take it). On one CUDA
device ``make_multi_step`` captures its call (tests/test_torch_train_graph_cuda.py);
everywhere else it runs eagerly, and its calls equal a loop of
``make_train_step`` over the same rows bit for bit.
"""

import types

import numpy as np
import pytest
import torch

from dragonfly2_tpu_torch.trainer import synthetic, train_gnn, train_mlp

# One intra-op thread: the suite runs six xdist workers on the host's cores.
torch.set_num_threads(1)

PAST = train_gnn.DECAY_STEPS + 100  # every count from 0 to past the schedule's end


@pytest.fixture(scope="module")
def host_corrections():
    """Each count's bias corrections as the host computed them a step at a time."""
    opt = train_gnn.ClippedAdamW
    return {b: [opt._bias_correction(b, c) for c in range(PAST)] for b in (opt.b1, opt.b2)}


def _optimizers():
    gnn = {f"gnn-warmup{w}": train_gnn.make_optimizer(train_gnn.GNNTrainConfig(warmup_steps=w), [])
           for w in (0, 1, 100)}
    return {**gnn, "mlp": train_mlp.make_optimizer(train_mlp.MLPTrainConfig(), [])}


@pytest.mark.parametrize("name", sorted(_optimizers()))
def test_the_step_table_holds_the_hosts_floats_at_every_count(name, host_corrections):
    opt = _optimizers()[name]
    table = opt.table.tolist()
    assert opt.table.dtype == torch.float32
    for count in range(PAST):
        want = (float(np.float32(opt.schedule(count))), host_corrections[opt.b1][count],
                host_corrections[opt.b2][count])
        got = tuple(table[min(count, len(table) - 1)])
        assert got == want, (count, got, want)


def test_an_int_count_and_a_device_count_read_the_same_row():
    opt = train_gnn.make_optimizer(train_gnn.GNNTrainConfig(warmup_steps=100), [])
    for count in (0, 1, 99, 100, 17_320, train_gnn.DECAY_STEPS, PAST, 10**9):
        by_int = torch.stack(opt.at(count))
        by_tensor = torch.stack(opt.at(torch.tensor(count, dtype=torch.int64)))
        assert all(t.dim() == 0 for t in opt.at(count))
        assert torch.equal(by_int, by_tensor), count
    assert torch.equal(torch.stack(opt.at(PAST)), opt.table[-1])


def test_an_update_at_an_int_count_equals_one_at_a_device_count():
    cfg = train_gnn.GNNTrainConfig(hidden=16, embed_dim=8, num_layers=1, warmup_steps=3)
    states = [train_gnn.init_state(cfg, rng_seed=2, device="cpu") for _ in range(2)]
    rng = np.random.default_rng(0)
    for count in range(5):
        grads = [torch.from_numpy(rng.standard_normal(p.shape).astype(np.float32))
                 for p in states[0].optimizer.params]
        for st, c in zip(states, (count, torch.tensor(count))):
            for p, gr in zip(st.optimizer.params, grads):
                p.grad = gr.clone()
            st.optimizer.step(c)
    for a, b in zip(states[0].optimizer.params, states[1].optimizer.params):
        assert torch.equal(a, b)


def _stub_state(cuda: bool, mesh=None):
    param = types.SimpleNamespace(is_cuda=cuda)
    return types.SimpleNamespace(model=types.SimpleNamespace(parameters=lambda: iter([param])), mesh=mesh)


def test_only_one_plain_cuda_device_captures_the_call():
    assert train_gnn._graphs(_stub_state(cuda=True))
    assert not train_gnn._graphs(_stub_state(cuda=True, mesh=object()))
    assert not train_gnn._graphs(_stub_state(cuda=False))
    cfg = train_gnn.GNNTrainConfig(hidden=16, embed_dim=8, num_layers=1)
    assert not train_gnn._graphs(train_gnn.init_state(cfg, device="cpu"))


def test_cpu_calls_run_eagerly_and_equal_a_loop_of_train_steps_over_the_same_rows():
    cluster = synthetic.make_cluster(num_nodes=64, num_neighbors=4, num_pairs=512, seed=2)
    cfg = train_gnn.GNNTrainConfig(hidden=32, embed_dim=16, num_layers=2, batch_size=48, warmup_steps=2)
    calls, per_call, seed = 3, 3, 11

    state = train_gnn.init_state(cfg, rng_seed=1, device="cpu")
    multi = train_gnn.make_multi_step(state, cluster.graph, cluster.pairs, batch_size=cfg.batch_size,
                                      steps_per_call=per_call, with_metrics=True, seed=seed)
    outs = []
    for _ in range(calls):
        state, (losses, norms) = multi(state)
        outs.append((losses, norms))
    assert state.step == calls * per_call
    assert len({t.data_ptr() for pair in outs for t in pair}) == 2 * calls  # no call's values overwritten

    ref = train_gnn.init_state(cfg, rng_seed=1, device="cpu")
    g = cluster.graph.to("cpu")
    pool = train_gnn._as_batch(*(torch.as_tensor(a) for a in cluster.pairs))
    gen = torch.Generator().manual_seed(seed)
    step = train_gnn.make_train_step(with_metrics=True)
    want = []
    for _ in range(calls * per_call):
        idx = torch.randint(0, len(pool.child), (cfg.batch_size,), generator=gen)
        ref, (loss, gnorm) = step(ref, g, synthetic.PairBatch(*(a.index_select(0, idx) for a in pool)))
        want.append((loss, gnorm))
    got_losses = torch.cat([losses for losses, _ in outs])
    got_norms = torch.cat([norms for _, norms in outs])
    assert torch.equal(got_losses, torch.stack([w[0] for w in want]))
    assert torch.equal(got_norms, torch.stack([w[1] for w in want]))
    for a, b in zip(state.model.parameters(), ref.model.parameters()):
        assert torch.equal(a, b)
