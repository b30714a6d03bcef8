"""The data-plane transport seam: ``AsyncPlainTransport``, the port's copy
of the plain side of dragonfly2_tpu/security/transport.py.

The reference's TLS side of the seam (``AsyncTlsTransport``, the
``DataPlaneTls`` bundle, cipher autoselection and session resumption) comes
with ``security/`` (ROADMAP.md §1, 'Still to do' item 4): the port's piece
plane runs plain TCP until then.
"""

from __future__ import annotations

import asyncio
import socket


class AsyncPlainTransport:
    """The no-TLS side of the transport seam: thin delegation to the loop's
    sock_* fast paths so daemon/rawrange.py speaks one API either way (the
    extra method call costs nanoseconds against a 64 KiB recv)."""

    __slots__ = ("_sock", "_loop")
    tls = False

    def __init__(self, sock: socket.socket, loop=None):
        self._sock = sock
        self._loop = loop or asyncio.get_running_loop()

    async def recv(self, n: int) -> bytes:
        return await self._loop.sock_recv(self._sock, n)

    async def recv_into(self, view: memoryview) -> int:
        return await self._loop.sock_recv_into(self._sock, view)

    async def sendall(self, data) -> None:
        await self._loop.sock_sendall(self._sock, data)

    def close(self) -> None:
        self._sock.close()

    def fileno(self) -> int:
        return self._sock.fileno()
