"""The port's scheduling rounds against the reference's, leg by leg.

One seeded scenario (tests/test_torch_scheduler_scenario.py: hosts, probes,
registrations on back-to-source, multi-piece, SMALL, TINY and announced
tasks, piece and peer results, reschedules, leaves, GC) runs through the
reference's SchedulerService and the port's, on a VirtualClock in both, on
each leg of the round loop:

- serial: no dispatcher, rounds on the event loop;
- dispatch: the round dispatcher's two worker threads;
- native: one-round batches through the native round driver
  (``df_round_drive`` over ``Scheduling``'s ``_RoundArena``);
- mirror: the native driver against the native mirrored peer table
  (``df_mirror_drive``, the rng's 625-word MT buffer folded back into
  Python's ``random.Random`` on every serial draw).

With the base evaluator and with the native scorer over one artifact (the
same ``scorer.cc`` in both packages), every observable is equal: the
RegisterResults (parents, back-to-source), the DAG's parent lists, stat_task,
the GC removals, and the download and probe records field for field, bit for
bit. Within the port, every leg equals its serial leg, and the native legs
really took the native path. No assertion reads a host clock.
"""

import asyncio

import pytest
import torch

from dragonfly2_tpu.sim.engine import _synthetic_scorer_artifact
from tests.test_torch_scheduler_scenario import (
    LEGS,
    NODES,
    PORT,
    REF,
    assert_same,
    make_service,
    run_scenario,
)

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

DEADLINE_S = 120


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """One native scorer artifact (seeded random weights, NODES rows) that
    both packages' NativeScorer load."""
    return _synthetic_scorer_artifact(str(tmp_path_factory.mktemp("rd") / "scorer.dfsc"), n_nodes=NODES, seed=3)


def _node_index() -> dict[str, int]:
    # every fourth host is outside the embedding table: those rounds take
    # the counted unknown_hosts fallback on every leg
    return {f"h{i}": i for i in range(NODES) if i % 4 != 3}


def _run(pkg, tmp_path, leg: str, artifact: str | None):
    scorer = pkg.native.NativeScorer(artifact) if artifact else None
    svc = make_service(pkg, tmp_path, leg=leg, scorer=scorer, node_index=_node_index())
    try:
        out = asyncio.run(asyncio.wait_for(run_scenario(svc, pkg), DEADLINE_S))
        stats = {
            "native_rounds": svc.scheduling.native_rounds_served,
            "mirror_rounds": svc.scheduling.mirror_rounds_served,
        }
    finally:
        svc.close()
        if scorer is not None:
            scorer.close()
    return out, stats


# the mirror needs a native bundle: a base service never enables it
@pytest.mark.parametrize(
    "engine,leg", [("base", leg) for leg in LEGS if leg != "mirror"] + [("native", leg) for leg in LEGS]
)
def test_every_leg_is_the_references_bit_for_bit(engine, leg, tmp_path, artifact):
    art = artifact if engine == "native" else None
    port, port_stats = _run(PORT, tmp_path, leg, art)
    ref, ref_stats = _run(REF, tmp_path, leg, art)
    assert_same(port, ref)
    assert port_stats == ref_stats
    # the scenario schedules: parents were handed out, records were written
    assert sum(bool(r["parents"]) for r in port["register"]) >= 20
    assert len(port["downloads"]["task_id"]) > 20 and len(port["probes"]["rtt_mean_ms"]) > 100
    if engine == "native" and leg in ("native", "mirror", "dispatch"):
        assert port_stats["native_rounds"] > 0
    if leg == "mirror":
        assert port_stats["mirror_rounds"] > 0
    if leg != "serial":
        serial, _ = _run(PORT, tmp_path / "serial", "serial", art)
        assert_same(port, serial)
