"""tools/time_limit.py: the wall-clock limit the root conftest.py puts on
every phase of every tier-1 test.

Limits do not nest, and every test here already runs under one, so the
cases that arm a limit of their own run it in a child process."""

from __future__ import annotations

import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

from tools.time_limit import time_limit

REPO = Path(__file__).resolve().parent.parent


def _child(source: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", source], cwd=REPO, capture_output=True, text=True, timeout=60)


_SPIN = """
from tools.time_limit import TimeLimitExceeded, time_limit
try:
    with time_limit(0.3, "spin"):
        while True:
            pass
except TimeLimitExceeded as e:
    print(e)
"""


def test_a_spin_is_cut_at_the_limit_it_names():
    p = _child(_SPIN)
    assert (p.returncode, p.stdout.strip()) == (0, "spin: still running after its limit of 0.3 s"), p.stderr


_CALLBACK = """
import asyncio, time
from tools.time_limit import TimeLimitExceeded, time_limit

def spin():
    while True:
        pass

async def main():
    asyncio.get_running_loop().call_soon(spin)
    await asyncio.sleep(60)

started = time.monotonic()
try:
    with time_limit(0.3, "callback"):
        asyncio.run(main())
except TimeLimitExceeded:
    print(f"cut after {time.monotonic() - started:.1f} s")
"""


def test_a_spin_inside_a_loop_callback_is_cut():
    p = _child(_CALLBACK)
    assert p.returncode == 0, p.stderr
    # the first exception ended the callback, and the loop dropped it; the
    # re-armed timer's next one ended asyncio.run
    assert "Exception in callback" in p.stderr
    waited = float(p.stdout.split()[2])
    assert waited < 10, p.stdout


_IN_TIME = """
import os, signal
from tools.time_limit import time_limit

def mine(signum, frame):
    pass

signal.signal(signal.SIGALRM, mine)
fds = sorted(os.listdir("/proc/self/fd"))
with time_limit(5, "brief"):
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0
assert signal.getitimer(signal.ITIMER_REAL) == (0.0, 0.0), signal.getitimer(signal.ITIMER_REAL)
assert signal.getsignal(signal.SIGALRM) is mine
assert sorted(os.listdir("/proc/self/fd")) == fds
print("ok")
"""


def test_a_block_that_ends_in_time_leaves_the_timer_and_handler_as_it_found_them():
    p = _child(_IN_TIME)
    assert (p.returncode, p.stdout.strip()) == (0, "ok"), p.stderr


def test_a_limit_inside_a_limit_is_refused_and_leaves_the_outer_one_armed():
    # this test's own limit, from the root conftest, is the outer one
    handler = signal.getsignal(signal.SIGALRM)
    left = signal.getitimer(signal.ITIMER_REAL)[0]
    assert left > 0
    with pytest.raises(RuntimeError, match="do not nest"):
        with time_limit(5, "inner"):
            pass
    assert signal.getsignal(signal.SIGALRM) is handler
    assert 0 < signal.getitimer(signal.ITIMER_REAL)[0] <= left


def test_off_the_main_thread_it_does_nothing():
    handler = signal.getsignal(signal.SIGALRM)
    seen = {}

    def body():
        try:
            with time_limit(0.05, "thread"):
                time.sleep(0.3)
            seen["outcome"] = "ran to its end"
        except Exception as e:
            seen["outcome"] = repr(e)

    t = threading.Thread(target=body)
    t.start()
    t.join(30)
    assert not t.is_alive()
    assert seen == {"outcome": "ran to its end"}
    assert signal.getsignal(signal.SIGALRM) is handler


@pytest.fixture
def timer_in_setup():
    yield signal.getitimer(signal.ITIMER_REAL)[0]
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0, "teardown runs without a limit"


def test_every_phase_of_a_test_runs_under_the_limit(timer_in_setup):
    assert timer_in_setup > 0, "setup runs without a limit"
    assert signal.getitimer(signal.ITIMER_REAL)[0] > 0, "the call runs without a limit"


@pytest.fixture
def no_timer_in_setup():
    yield signal.getitimer(signal.ITIMER_REAL)[0]
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0, "teardown runs under a limit"


@pytest.mark.slow
def test_a_slow_test_runs_without_the_limit(no_timer_in_setup):
    # tier-1 deselects this; the next test runs it in a child pytest
    assert no_timer_in_setup == 0, "setup runs under a limit"
    assert signal.getitimer(signal.ITIMER_REAL)[0] == 0, "the call runs under a limit"


def test_slow_tests_run_without_the_limit():
    probe = f"{Path(__file__).relative_to(REPO)}::test_a_slow_test_runs_without_the_limit"
    p = subprocess.run(
        [sys.executable, "-m", "pytest", probe, "-m", "slow", "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=REPO,
        capture_output=True,
        text=True,
        timeout=180,
    )
    assert p.returncode == 0 and "1 passed" in p.stdout, p.stdout + p.stderr


def test_the_root_conftest_imports_neither_jax_nor_torch():
    # it loads before tests/conftest.py, which must set JAX's platform first
    p = _child("import sys, conftest; print(sorted({'jax', 'torch'} & set(sys.modules)))")
    assert (p.returncode, p.stdout.strip()) == (0, "[]"), p.stderr
