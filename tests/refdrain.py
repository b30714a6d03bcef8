"""The reference conductor, draining deferred writes as the port's does.

The reference's ``PeerTaskConductor._drain_writes`` loops on ``await
asyncio.gather(...)`` over tasks that have already finished. On Python 3.12
such a gather does not yield, so the loop spins and holds the event loop,
and no ``asyncio.wait_for`` bound fires (the port's fix is held by
tests/test_torch_daemon.py::test_draining_a_landed_write_returns). Tests that
drive the reference's engines next to the port's give its conductor the
port's drain: in process through the fixture, in a child process by running
this file, which starts the reference's daemon.
"""

from __future__ import annotations

import pytest


def drain_reference_as_the_ports(set_attr=setattr) -> None:
    from dragonfly2_tpu.daemon import conductor as ref
    from dragonfly2_tpu_torch.daemon import conductor as port

    set_attr(ref.PeerTaskConductor, "_drain_writes", port.PeerTaskConductor._drain_writes)


@pytest.fixture
def reference_drain_as_the_ports(monkeypatch):
    drain_reference_as_the_ports(monkeypatch.setattr)


if __name__ == "__main__":
    drain_reference_as_the_ports()
    from dragonfly2_tpu.daemon.server import main

    main()
