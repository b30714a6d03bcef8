"""The PyTorch port stands alone: no JAX, no flax, no optax, nothing of the
JAX package, no triton and no msgpack (the card's machine does not promise
it; the port carries its own codec), whether imported or named in its
sources, and no process of the JAX package launched from its sources or
chip_smoke.py; it stays dflint-clean; and chip_smoke.py refuses to run
without a card."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "dragonfly2_tpu_torch"

_IMPORT_ALL = """
import importlib, pkgutil, sys
import dragonfly2_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "triton", "msgpack", "dragonfly2_tpu")
)
print(len(names), ",".join(bad))
"""

# `dragonfly2_tpu\\b` stops before `_torch`: the port may import itself
_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(?:jax|jaxlib|flax|optax|triton|msgpack|dragonfly2_tpu)\b(?!_)", re.MULTILINE
)


# a process launch of the reference package: ``"-m", "dragonfly2_tpu.<module>"``
# in an argument list (a docstring naming the command line is not a launch)
_LAUNCH = re.compile(r"""["']-m["']\s*,\s*["']dragonfly2_tpu\.""")


def _port_sources():
    return sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]


def test_port_imports_nothing_of_jax_or_the_jax_package():
    p = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    count, _, bad = p.stdout.strip().partition(" ")
    assert int(count) >= 10  # every module of the package was imported
    assert bad == "", f"the port loaded {bad}"


def test_port_sources_name_no_jax_import():
    offenders = [
        f"{path.relative_to(REPO)}: {m.group(0).strip()}"
        for path in _port_sources()
        for m in _FORBIDDEN.finditer(path.read_text())
    ]
    assert offenders == []
    # the pattern itself must catch what it is meant to, and spare the port
    assert _FORBIDDEN.search("import jax.numpy as jnp") and _FORBIDDEN.search("from dragonfly2_tpu.ops import x")
    assert _FORBIDDEN.search("import msgpack") and _FORBIDDEN.search("from msgpack import packb")
    assert not _FORBIDDEN.search("from dragonfly2_tpu_torch.ops import x")


def test_port_sources_launch_no_reference_process():
    offenders = [
        f"{path.relative_to(REPO)}: {m.group(0)}"
        for path in _port_sources()
        for m in _LAUNCH.finditer(path.read_text())
    ]
    assert offenders == []
    # the pattern catches a launch of the reference package, and spares the port's
    assert _LAUNCH.search('cmd = [sys.executable, "-m", "dragonfly2_tpu.scheduler.server", "--port", "0"]')
    assert _LAUNCH.search("['-m', 'dragonfly2_tpu.cli.dfstress']")
    assert not _LAUNCH.search('[sys.executable, "-m", "dragonfly2_tpu_torch.scheduler.server"]')
    assert not _LAUNCH.search("python -m dragonfly2_tpu.scheduler.server --evaluator plugin:x")


def test_port_is_dflint_clean():
    p = subprocess.run(
        [sys.executable, str(REPO / "tools" / "dflint.py"), "dragonfly2_tpu_torch", "chip_smoke.py"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert p.returncode == 0, p.stdout + p.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run")
    p = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=120)
    assert p.returncode != 0
    assert '"ok"' not in p.stdout
