"""The port's scenario packs and ``dfsim``'s ``run_scenario`` against the
reference's, on the CPU.

Every scenario in ``SCENARIOS`` runs through both packages'
``run_scenario`` at the reference tests' own reduced sizes
(``tests/test_sim.py``), with telemetry bridged to a dataset. The JSON must
be equal apart from the wall-time meters (``wall_s``, ``events_per_sec``,
``time_compression``, ``scheduler.sched_s``, ``scheduler.rounds_per_s``),
the per-interval buckets included, and both must pass their checks.
``flash-crowd`` also runs under ``ml-serial`` and ``ml-native``, where a
synthetic model scores every round through the C++ scorer; the two
packages' scorers are bit-equal (``tests/test_torch_native.py``), so the
placement is too. The port's synthetic scorer artifact is byte-equal to the
reference's.

Both packages run inside one interpreter, so under one hash seed: the order
of events depends on string hashing, in the reference as in the port.
"""

import shutil

import pytest
import torch

from dragonfly2_tpu.cli import dfsim as ref_dfsim
from dragonfly2_tpu.sim import engine as ref_engine
from dragonfly2_tpu.sim.scenarios import SCENARIOS as REF_SCENARIOS
from dragonfly2_tpu_torch.cli import dfsim as port_dfsim
from dragonfly2_tpu_torch.sim import engine as port_engine
from dragonfly2_tpu_torch.sim.scenarios import SCENARIOS

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools.
torch.set_num_threads(1)

# tests/test_sim.py's sizes for each pack
SIZES = {
    "flash-crowd": dict(peers=1_200),
    "cross-region-cold-start": dict(peers=900),
    "partition-and-heal": dict(peers=1_000),
    "overload-flash": dict(peers=800),
    "manager-blackout": dict(peers=200, agents=10),
    "gray-parents": dict(peers=600),
    "thundering-rejoin": dict(peers=800),
}
# the only fields the two packages' answers may differ in: wall-time meters
WALL = ("wall_s", "events_per_sec", "time_compression")
SCHED_WALL = ("sched_s", "rounds_per_s")

NO_GXX = pytest.mark.skipif(shutil.which("g++") is None, reason="no C++ toolchain for the native scorer")
CASES = [pytest.param(name, "base", id=name) for name in SIZES] + [
    pytest.param("flash-crowd", scoring, id=f"flash-crowd-{scoring}", marks=NO_GXX)
    for scoring in ("ml-serial", "ml-native")
]


def _strip(out: dict) -> dict:
    out = dict(out)
    for k in WALL:
        assert out.pop(k) >= 0
    out["scheduler"] = dict(out["scheduler"])
    for k in SCHED_WALL:
        assert out["scheduler"].pop(k) >= 0
    return out


def test_the_registry_is_the_references():
    assert list(SCENARIOS) == list(REF_SCENARIOS) == list(SIZES)


@pytest.mark.parametrize("name,scoring", CASES)
def test_run_scenario_is_the_references(name, scoring):
    kw = dict(SIZES[name], seed=0)
    if scoring != "base":
        # the ml legs: dfsim's own rule, no placement checks under a synthetic model
        kw.update(peers=300, scoring=scoring, check=False)
    port = port_dfsim.run_scenario(name, **kw)
    ref = ref_dfsim.run_scenario(name, **kw)
    assert port["assertions"] == ref["assertions"] == {"passed": True, "error": None}
    assert port["wall_s"] > 0 and port["events"] > 0
    assert _strip(port) == _strip(ref)
    s = port["scheduler"]
    assert s["scoring"] == scoring
    if name != "thundering-rejoin":
        assert s["rounds"] > 0 and port["telemetry"]["download_rows"] > 0
    if scoring == "ml-native":
        # the reference's coverage contract (tests/test_sim.py)
        assert s["native_rounds"] >= s["rounds"] - port["schedulers"]
        assert s["mirror_rounds"] + s["mirror_stale_rounds"] == s["native_rounds"]
        assert s["mirror_full_syncs"] == port["schedulers"]
    elif scoring == "ml-serial":
        assert s["native_rounds"] == 0


def test_the_synthetic_scorer_artifact_is_the_references(tmp_path):
    for seed in (0, 5):
        mine = port_engine._synthetic_scorer_artifact(str(tmp_path / f"port-{seed}.dfsc"), seed=seed)
        theirs = ref_engine._synthetic_scorer_artifact(str(tmp_path / f"ref-{seed}.dfsc"), seed=seed)
        with open(mine, "rb") as a, open(theirs, "rb") as b:
            data = a.read()
            assert data == b.read() and len(data) > 4096


def test_scoring_modes_are_the_references_three():
    with pytest.raises(ValueError, match="unknown scoring mode"):
        port_engine.Simulation(port_engine.SimConfig(scoring="torch"))
    with pytest.raises(ValueError, match="unknown scoring mode"):
        ref_engine.Simulation(ref_engine.SimConfig(scoring="torch"))
