"""The numbers that decide ``correct``: each a gap between what the
program produced and what the plain reference works out from the same
inputs. A number at or under its limit passes.
"""

from __future__ import annotations

import math
import statistics


def loss_gap(program: list[float], reference: list[float]) -> float:
    """The widest relative gap between the two sides' loss, step by step."""
    return max(abs(p - r) / abs(r) for p, r in zip(program, reference, strict=True))


def _norm(t) -> float:
    return float(t.double().norm())


def worst_leaf_gap(program: dict, reference: dict, leaves: list[str] | None = None) -> float:
    """The widest gap, over ``leaves``, between the program's norm of a leaf
    and the reference's (not the norm of their difference), over the larger
    of that leaf's reference norm and the median leaf's."""
    ref = {k: _norm(v) for k, v in reference.items()}
    leaves = sorted(ref) if leaves is None else leaves
    floor = statistics.median(ref.values())
    return max(abs(_norm(program[k]) - ref[k]) / max(ref[k], floor) for k in leaves)


def moved_leaves(grads: dict, share: float = 1e-3) -> list[str]:
    """Leaves whose reference gradient is at least ``share`` of the median
    leaf's: the others move under Adam by round-off alone."""
    norms = {k: _norm(v) for k, v in grads.items()}
    floor = share * statistics.median(norms.values())
    return sorted(k for k, v in norms.items() if v >= floor)


def train_readings(program: dict, reference: dict) -> dict[str, float]:
    """``program`` and ``reference`` each hold ``losses`` (the checked
    steps), ``grad`` (each leaf's first gradient as the optimiser takes
    it) and ``change`` (each leaf's change over the checked steps)."""
    moved = moved_leaves(reference["grad"])
    return {
        "loss_gap": loss_gap(program["losses"], reference["losses"]),
        "grad_gap": worst_leaf_gap(program["grad"], reference["grad"]),
        "change_gap": worst_leaf_gap(program["change"], reference["change"], moved),
    }


def score_readings(program, reference) -> dict[str, float]:
    """The widest gap between a served score and the reference's."""
    import numpy as np

    gap = np.abs(np.asarray(program, np.float64) - np.asarray(reference, np.float64))
    return {"score_gap": float(gap.max())}


def verdict(readings: dict[str, float], limits: dict[str, dict]) -> bool:
    """Every limit has its reading, each finite and at or under its limit."""
    return all(
        name in readings and math.isfinite(readings[name]) and readings[name] <= lim["limit"]
        for name, lim in limits.items()
    )
