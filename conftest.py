"""One wall-clock limit for every phase of every tier-1 test.

A test that hangs fails by itself, named by the limit, instead of holding
its xdist worker until the whole run is killed. ``asyncio.wait_for`` bounds
in the tests cannot do this: a coroutine that never yields defeats them.

Tests marked ``slow``, which tier-1 leaves out, run without it: their own
docstrings give them several minutes. Under the limit pytest's
``faulthandler_timeout`` does nothing, since the limit arms faulthandler's
one stack dump for itself; it still works for the ``slow`` tests.

This file sits at the repository root so that it stays apart from
``tests/conftest.py``, which must set JAX's platform before jax is
imported; it imports neither jax nor torch.
"""

from __future__ import annotations

import pytest

from tools.time_limit import time_limit

# The slowest phase on record, tests/test_rpc.py's federated ML loop, took
# 57.5 s alone and 67.69 s in a loaded run of the whole suite: the limit is
# over three times that. A constant: no option, marker or per-test override.
LIMIT_S = 240


def _limited(item: pytest.Item, phase: str):
    if item.get_closest_marker("slow"):
        return (yield)
    with time_limit(LIMIT_S, f"{item.nodeid} {phase}"):
        return (yield)


# tryfirst puts these wrappers outside pytest's capture, so the limit's
# stack dump copies the real stderr.
@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_setup(item):
    return (yield from _limited(item, "setup"))


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_call(item):
    return (yield from _limited(item, "call"))


@pytest.hookimpl(wrapper=True, tryfirst=True)
def pytest_runtest_teardown(item):
    return (yield from _limited(item, "teardown"))
