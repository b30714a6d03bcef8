"""``correct`` comes out false when the timed path is broken underneath a
run, and when the precision control takes the program's place; a sound
run at the same size and seed comes out true. Small sizes on the CPU,
the cells' own limits, which were set on the card at the cells' sizes:
the CPU's bfloat16 paths at these sizes read closer to them, so the
sound run is one fixed seed and each broken run reports that seed."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import calibrate, compare, harness  # noqa: E402

SMALL = {
    "train-h512-16k": {"hosts": 512, "hidden": 64, "pair_pool": 8192, "batch_size": 4096, "embed_dim": 32},
    "embed-h256-16k": {"hosts": 64, "hidden": 32, "embed_dim": 16, "head_hidden": 32},
}
CPU = torch.device("cpu")


def run_small(cell: str, seed: int = 2**31 + 17) -> dict:
    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    return harness.run_cell(spec, cell, seed=seed, seconds=0.3, trace=False, device=CPU,
                            config_override=SMALL[cell])


@pytest.mark.parametrize("cell", sorted(SMALL))
def test_a_sound_run_is_correct(cell):
    r = run_small(cell)
    assert r["correct"] is True, r["checks"]
    assert list(r)[-1] == "checks"


def _state_unchanged(monkeypatch):
    from dragonfly2_tpu_torch.trainer import train_gnn

    def step(self, count):
        return torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(p.grad) for p in self.params]))

    monkeypatch.setattr(train_gnn.ClippedAdamW, "step", step)


def _half_batch(monkeypatch):
    from dragonfly2_tpu_torch.trainer import train_gnn

    def loss_fn(model, g, batch):
        pred = model(g, batch.child, batch.parent, batch.feats)
        half = pred.shape[0] // 2
        return torch.mean((pred[:half] - batch.label[:half]) ** 2)

    monkeypatch.setattr(train_gnn, "loss_fn", loss_fn)


def _stale_refresh(monkeypatch):
    from dragonfly2_tpu_torch.models.scorer import GNNScorer

    refresh = GNNScorer.refresh

    def once(self, graph):
        if self._z is None:
            refresh(self, graph)

    monkeypatch.setattr(GNNScorer, "refresh", once)


def _half_neighbors(monkeypatch):
    from dragonfly2_tpu_torch.models import graphsage
    from dragonfly2_tpu_torch.ops.neighbor_agg import masked_mean

    def half(x, mask, eps=1e-6):
        k = mask.shape[1] // 2
        return masked_mean(x[:, :k], mask[:, :k], eps=eps)

    monkeypatch.setattr(graphsage, "masked_mean", half)


def _answer_shifted(monkeypatch):
    from dragonfly2_tpu_torch.models.scorer import GNNScorer

    score_rounds = GNNScorer.score_rounds

    def shifted(self, pair_feats, *, child, parent):
        out = score_rounds(self, pair_feats, child=child, parent=parent)
        out[0] = out[0][list(range(1, out.shape[1])) + [0]]
        return out

    monkeypatch.setattr(GNNScorer, "score_rounds", shifted)


@pytest.mark.parametrize("cell,fault", [
    ("train-h512-16k", _state_unchanged),
    ("train-h512-16k", _half_batch),
    ("embed-h256-16k", _stale_refresh),
    ("embed-h256-16k", _half_neighbors),
    ("embed-h256-16k", _answer_shifted),
], ids=lambda v: v if isinstance(v, str) else v.__name__.strip("_"))
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = run_small(cell)
    assert r["correct"] is False, r["checks"]


@pytest.mark.parametrize("cell", sorted(SMALL))
@pytest.mark.parametrize("seed", [1, 2**31 + 5, 2**32 + 9])
def test_the_float8_control_is_not_correct(cell, seed):
    spec = harness.load_json(harness.REPO / "BENCHMARK.json")
    c = harness.find_cell(spec, cell)
    ctx = harness.Ctx(dict(c.config, **SMALL[cell]), c.traffic, seed, 0.3, False, CPU, 0.0)
    readings = calibrate.stand_ins(c, ctx)["control_fp8"]
    assert compare.verdict(readings, c.limits) is False, readings
