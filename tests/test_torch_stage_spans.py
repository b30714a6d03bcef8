"""Stage spans of the port's train step and scorer refresh, on the CPU.

``observability.tracing.stage`` opens a profiler range only while a
``torch.profiler`` records; with no profiler the stages cost one flag
read and enter no range. The ranges sit in the profiler's chrome trace,
where ``benchmark/stages.py`` charges device time to them, and change no
number the program computes.
"""

import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer
from dragonfly2_tpu_torch.models.weights import init_flax_like, params_from_flax
from dragonfly2_tpu_torch.observability import tracing
from dragonfly2_tpu_torch.trainer import synthetic, train_gnn

torch.set_num_threads(1)

NODES, NEIGHBORS, HIDDEN, EMBED, LAYERS, BATCH, STEPS = 64, 4, 16, 8, 2, 32, 2
TRAIN_STAGES = ("gnn.train.sample", "gnn.train.forward", "gnn.train.backward", "gnn.train.optimizer")
SAGE_STAGES = ("gnn.sage.gather", "gnn.sage.message", "gnn.sage.mean")
REFRESH_STAGES = ("gnn.refresh.upload", "gnn.refresh.encode", "gnn.refresh.partials")
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cluster():
    return synthetic.make_cluster(num_nodes=NODES, num_neighbors=NEIGHBORS, num_pairs=256, seed=3)


def _train_call(cluster):
    """One make_multi_step call of STEPS steps from a fixed start: its
    losses and gradient norms."""
    cfg = train_gnn.GNNTrainConfig(hidden=HIDDEN, embed_dim=EMBED, num_layers=LAYERS, batch_size=BATCH)
    state = train_gnn.init_state(cfg, rng_seed=5, device="cpu")
    multi = train_gnn.make_multi_step(state, cluster.graph, cluster.pairs, batch_size=BATCH,
                                      steps_per_call=STEPS, with_metrics=True, seed=9)
    _, (losses, norms) = multi(state)
    return losses, norms


def _refresh(cluster):
    """One GNNScorer.refresh on the CPU: the cached tables."""
    model = TopoScorer(hidden=HIDDEN, embed_dim=EMBED, num_layers=LAYERS)
    scorer = GNNScorer(model, params_from_flax(init_flax_like(model, seed=7)), device="cpu")
    scorer.refresh(cluster.graph)
    return scorer._z, scorer._uc, scorer._up


def _ranges(prof, tmp_path) -> Counter:
    """The names of the profiler ranges in the chrome trace, counted."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return Counter(e["name"] for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation")


def test_the_profiler_flag_stage_reads_is_a_bool_set_while_recording():
    # stage() reads this module attribute; were it renamed, every stage would
    # silently fall back to the no-op, so the name is pinned here
    flag = lambda: torch.autograd.profiler._is_profiler_enabled  # noqa: E731
    assert flag() is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag() is True
        assert tracing.stage("gnn.x") is not tracing._NO_STAGE
    assert flag() is False


def test_without_a_profiler_stages_are_the_shared_noop_and_enter_no_range(cluster, monkeypatch):
    entered = []
    real = torch.autograd.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.autograd.profiler, "record_function", Counting)
    a, b = tracing.stage("gnn.a"), tracing.stage("gnn.b")
    assert a is tracing._NO_STAGE and b is tracing._NO_STAGE
    with a as got:
        assert got is None
    _train_call(cluster)
    _refresh(cluster)
    assert entered == []
    # the counter does count once a profiler records
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.stage("gnn.c"):
            pass
    assert entered == ["gnn.c"]


def test_under_the_profiler_every_stage_shows_the_expected_number_of_times(cluster, tmp_path):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train_call(cluster)
        _refresh(cluster)
    names = _ranges(prof, tmp_path)
    want = {n: STEPS for n in TRAIN_STAGES}
    want.update({n: STEPS * LAYERS + LAYERS for n in SAGE_STAGES})  # train forwards, then the refresh's encoder
    want.update({n: 1 for n in REFRESH_STAGES})
    assert {n: c for n, c in names.items() if n.startswith("gnn.")} == want


def test_spans_change_no_number(cluster):
    off = _train_call(cluster), _refresh(cluster)
    with profile(activities=[ProfilerActivity.CPU]):
        on = _train_call(cluster), _refresh(cluster)
    for x, y in zip((*off[0], *off[1]), (*on[0], *on[1])):
        assert torch.equal(x, y)


def test_the_tracer_imports_and_stages_without_torch():
    code = ("import sys; from dragonfly2_tpu_torch.observability import tracing as t; "
            "s = t.stage('gnn.x'); assert s is t._NO_STAGE, s; "
            "sp = t.Tracer().span('a'); sp.__enter__(); sp.__exit__(None, None, None); "
            "assert 'torch' not in sys.modules; print('ok')")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=60)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
