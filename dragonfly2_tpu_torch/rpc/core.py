"""Framed msgpack RPC core, the wire of dragonfly2_tpu/rpc/core.py.

Wire format: 4-byte big-endian length + msgpack map
  request:  {"i": id, "m": method, "p": payload, "t"?: traceparent}
  response: {"i": id, "r": result} | {"i": id, "e": {"code", "message"}}
Payloads are msgpack-native types (dicts/lists/str/bytes/numbers/None),
encoded by the port's own codec (``trainer/_msgpack.packb``/``unpackb``,
byte-equal to ``msgpack.packb(use_bin_type=True)``), so either package's
client talks to the other's server. The server accepts a request's ``"t"``
(a caller's trace context) and ignores it.

Server: asyncio server on TCP or a unix socket (``unix_path=``), a
method registry, a per-server QPS token bucket (``qps_limit`` /
``qps_burst``, the reference's 10k QPS / 20k burst; past it a request is
answered ``resource_exhausted``), the JAX package's error mapping (an
unknown method is ``unimplemented``; an ``RpcError`` keeps its code and its
``retry_after_s`` hint; any other exception is ``internal`` with its type
and message).
Client: one connection, requests multiplexed on it by id, reconnect after
the connection drops, and the reference client's call semantics: up to
``retries`` further attempts on a dropped connection, a transport error or
``resource_exhausted``, paced by a ``BackoffPolicy``; a per-client
``CircuitBreaker`` (``.breaker``: the per-target breaker, one client being
one address) fed exactly as the reference feeds it; an optional
``RetryBudget`` (``retry_budget=``) consulted before each retry and pre-charged by a
server's ``retry_after_s``; and a timeout of min(per-call timeout, the
caller's ``resilience.deadline`` remaining), ``deadline_exceeded`` past it.
An address is TCP only when it ends in ``:<digits>``; any other address is
a unix socket path, the JAX package's rule.

Fault injection (``resilience.faultline``): ``rpc.read`` fires at the top
of every frame read, client and server; ``rpc.write`` is checked before
every frame the server or the client writes. An injected fault fails the
read or write as a broken transport would: a server drops the connection
or the reply; on a client it feeds the retry path, as in the reference.

Left out (the JAX package has them): TLS, vsock, the write coalescer, the
zero-copy big-frame read and write paths and trace-context continuation.
"""

from __future__ import annotations

import asyncio
import logging
import struct
from typing import Any, Awaitable, Callable

from dragonfly2_tpu_torch.resilience import deadline as dl
from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.resilience.backoff import BackoffPolicy
from dragonfly2_tpu_torch.resilience.breaker import CircuitBreaker
from dragonfly2_tpu_torch.trainer._msgpack import packb, unpackb
from dragonfly2_tpu_torch.utils.ratelimit import TokenBucket

logger = logging.getLogger(__name__)

_LEN = struct.Struct(">I")
MAX_FRAME = 256 << 20


class RpcError(Exception):
    def __init__(self, message: str, code: str = "internal", retry_after_s: float = 0.0):
        super().__init__(message)
        self.code = code
        # a server's overload hint ("come back in N seconds"), carried in the
        # error frame; a client pre-charges its RetryBudget with it
        self.retry_after_s = retry_after_s


class ConnectionClosed(RpcError):
    def __init__(self) -> None:
        super().__init__("connection closed", code="unavailable")


async def _read_frame(reader: asyncio.StreamReader) -> Any:
    if faultline.ACTIVE is not None:
        await faultline.ACTIVE.fire("rpc.read")
    (length,) = _LEN.unpack(await reader.readexactly(_LEN.size))
    if length > MAX_FRAME:
        raise RpcError(f"frame too large: {length}", code="resource_exhausted")
    return unpackb(await reader.readexactly(length))


def _frame(msg: dict) -> bytes:
    body = packb(msg)
    if len(body) > MAX_FRAME:
        raise RpcError(f"frame too large: {len(body)}", code="resource_exhausted")
    return _LEN.pack(len(body)) + body


Handler = Callable[[Any], Awaitable[Any]]


class RpcServer:
    def __init__(
        self,
        *,
        host: str = "127.0.0.1",
        port: int = 0,
        unix_path: str | None = None,
        qps_limit: float = 10_000,
        qps_burst: float = 20_000,
    ):
        self._handlers: dict[str, Handler] = {}
        self.host = host
        self.port = port
        self.unix_path = unix_path
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[asyncio.StreamWriter] = set()
        self._bucket = TokenBucket(qps_limit, qps_burst)
        self.register("_ping", self._ping)

    async def _ping(self, payload: Any) -> str:
        return "pong"

    def register(self, method: str, handler: Handler) -> None:
        self._handlers[method] = handler

    def register_service(self, obj: Any, methods: list[str]) -> None:
        """Expose async methods of obj taking/returning msgpack-able payloads."""
        for name in methods:
            self.register(name, getattr(obj, name))

    async def start(self) -> None:
        if self.unix_path:
            self._server = await asyncio.start_unix_server(self._on_conn, path=self.unix_path)
        else:
            self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
            self.port = self._server.sockets[0].getsockname()[1]

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            # drop live connections too: wait_closed() waits for their
            # handlers, which otherwise run until the peer hangs up
            for w in list(self._conns):
                w.close()
            await self._server.wait_closed()
            self._server = None

    @property
    def address(self) -> str:
        return self.unix_path or f"{self.host}:{self.port}"

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter) -> None:
        tasks: set[asyncio.Task] = set()
        self._conns.add(writer)
        try:
            while True:
                try:
                    msg = await _read_frame(reader)
                except (asyncio.IncompleteReadError, OSError):
                    break  # the peer hung up or the transport failed
                except (RpcError, ValueError) as e:
                    logger.warning("bad frame (%s), closing connection", e)
                    break
                if not isinstance(msg, dict):
                    logger.warning("malformed frame (%s), closing connection", type(msg).__name__)
                    break
                t = asyncio.ensure_future(self._dispatch(msg, writer))
                tasks.add(t)
                t.add_done_callback(tasks.discard)
        finally:
            self._conns.discard(writer)
            for t in tasks:
                t.cancel()
            writer.close()
            try:
                await writer.wait_closed()
            except OSError as e:
                logger.debug("connection close: %r", e)

    async def _dispatch(self, msg: dict, writer: asyncio.StreamWriter) -> None:
        rid = msg.get("i")
        method = msg.get("m", "")
        handler = self._handlers.get(method)
        if handler is None:
            out = {"i": rid, "e": {"code": "unimplemented", "message": f"no method {method!r}"}}
        elif not self._bucket.try_acquire():
            out = {"i": rid, "e": {"code": "resource_exhausted", "message": "rate limited"}}
        else:
            try:
                out = {"i": rid, "r": await handler(msg.get("p"))}
            except RpcError as e:
                err = {"code": e.code, "message": str(e)}
                if e.retry_after_s > 0:
                    err["retry_after_s"] = e.retry_after_s
                out = {"i": rid, "e": err}
            except Exception as e:
                logger.exception("rpc handler %s failed", method)
                out = {"i": rid, "e": {"code": "internal", "message": f"{type(e).__name__}: {e}"}}
        try:
            frame = _frame(out)
        except (TypeError, ValueError, RpcError) as e:  # a result the wire cannot carry
            logger.exception("rpc handler %s returned an unencodable result", method)
            frame = _frame({"i": rid, "e": {"code": "internal", "message": f"{type(e).__name__}: {e}"}})
        if writer.is_closing():
            return
        try:
            if faultline.ACTIVE is not None:
                faultline.ACTIVE.check("rpc.write")
            writer.write(frame)
            await writer.drain()
        except OSError as e:  # the peer is gone, or an injected fault; its client owns recovery
            logger.debug("response write for %s failed: %r", method, e)


class RpcClient:
    def __init__(
        self,
        address: str,
        *,
        timeout: float = 30.0,
        retries: int = 3,
        backoff: BackoffPolicy | None = None,
        breaker: CircuitBreaker | None = None,
        retry_budget=None,
    ):
        self.address = address
        self.timeout = timeout
        self.retries = retries
        # None: retries unbudgeted (the reference's default with no target class)
        self.retry_budget = retry_budget
        self.backoff = backoff or BackoffPolicy(base=0.2, multiplier=2.0, max_delay=5.0, jitter=0.5)
        # one client is one address, so this breaker is the per-target one
        # (the balancer keeps one client per scheduler)
        self.breaker = breaker or CircuitBreaker()
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._pending: dict[int, asyncio.Future] = {}
        self._next_id = 0
        self._recv_task: asyncio.Task | None = None
        # binds to the running loop on first await (a client lives on one loop)
        self._conn_lock = asyncio.Lock()

    async def _connect(self) -> asyncio.StreamWriter:
        async with self._conn_lock:
            if self._writer is None or self._writer.is_closing():
                # TCP only when the address ends in ":<digits>"; anything
                # else (absolute, relative or colon-holding paths) is a unix socket
                host, _, port = self.address.rpartition(":")
                if port.isdigit():
                    reader, writer = await asyncio.open_connection(host, int(port))
                else:
                    reader, writer = await asyncio.open_unix_connection(self.address)
                self._reader, self._writer = reader, writer
                self._recv_task = asyncio.ensure_future(self._recv_loop(reader))
            return self._writer

    async def _recv_loop(self, reader: asyncio.StreamReader) -> None:
        try:
            while True:
                msg = await _read_frame(reader)
                fut = self._pending.pop(msg.get("i"), None) if isinstance(msg, dict) else None
                if fut is None or fut.done():
                    continue
                if "e" in msg:
                    err = msg["e"]
                    fut.set_exception(RpcError(
                        err.get("message", ""), err.get("code", "internal"),
                        retry_after_s=float(err.get("retry_after_s", 0.0)),
                    ))
                else:
                    fut.set_result(msg.get("r"))
        except (asyncio.IncompleteReadError, OSError, RpcError, ValueError, asyncio.CancelledError) as e:
            logger.debug("rpc connection to %s ended: %r", self.address, e)
        finally:
            self._fail_pending()
            async with self._conn_lock:
                if self._reader is reader:  # this connection, not a newer one
                    self._drop()

    def _fail_pending(self) -> None:
        for fut in self._pending.values():
            if not fut.done():
                fut.set_exception(ConnectionClosed())
        self._pending.clear()

    def _drop(self) -> None:
        """Forget the connection. Callers hold _conn_lock, or run with no
        await around the call (the retry path), which is as atomic on the
        loop thread."""
        if self._writer is not None:
            self._writer.close()
        self._reader = self._writer = None  # dflint: disable=DF023 under _conn_lock or in one step of the loop thread
        self._recv_task = None  # dflint: disable=DF023 under _conn_lock or in one step of the loop thread

    def _effective_timeout(self, timeout: float | None, method: str) -> float:
        """min(per-call timeout, the propagated deadline's remaining); a spent
        deadline fails at once rather than issue a call that cannot finish."""
        per_op = timeout or self.timeout
        rem = dl.remaining()
        if rem is None:
            return per_op
        if rem <= 0:
            raise RpcError(f"{method}: deadline exhausted before call", code="deadline_exceeded")
        return min(per_op, rem)

    async def call(self, method: str, payload: Any = None, *, timeout: float | None = None) -> Any:
        last_err: Exception | None = None
        for attempt in range(self.retries + 1):
            if not self.breaker.allow():
                raise RpcError(
                    f"circuit open to {self.address}" + (f" (last: {last_err})" if last_err else ""),
                    code="unavailable",
                )
            # outside the try: a caller's spent deadline is not the target's
            # fault and must not feed the breaker
            per_op = timeout or self.timeout
            effective = self._effective_timeout(timeout, method)
            try:
                result = await self._call_once(method, payload, effective)
                self.breaker.record_success()
                return result
            except (ConnectionClosed, ConnectionError, OSError) as e:
                self.breaker.record_failure()
                last_err = e
                self._drop_connection()
                if attempt < self.retries:  # no sleep before the last raise
                    self._spend_retry(method, last_err)
                    await self.backoff.sleep(attempt)
            except RpcError as e:
                if e.code == "deadline_exceeded":
                    if effective >= per_op:
                        # silent for the whole per-call window: the target's fault
                        self.breaker.record_failure()
                    # else the caller's deadline shrank the window: record nothing
                else:
                    # any decoded answer, an error too, shows the target alive
                    self.breaker.record_success()
                if e.retry_after_s > 0 and self.retry_budget is not None:
                    self.retry_budget.charge(e.retry_after_s)
                if e.code == "resource_exhausted" and attempt < self.retries:
                    last_err = e
                    self._spend_retry(method, last_err)
                    await self.backoff.sleep(attempt)
                    continue
                raise
        raise last_err or RpcError("rpc call failed")

    def _spend_retry(self, method: str, last_err: Exception | None) -> None:
        """Ask the retry budget for one retry (first attempts are free);
        past it, fail at once so the caller moves to its next fallback."""
        b = self.retry_budget
        if b is None:
            return
        if not b.spend():
            raise RpcError(
                f"{method}: retry budget exhausted for {b.name or self.address}"
                + (f" (last: {last_err})" if last_err else ""),
                code="unavailable",
            )

    async def _call_once(self, method: str, payload: Any, timeout: float) -> Any:
        writer = await self._connect()
        self._next_id += 1
        rid = self._next_id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rid] = fut
        try:
            # an injected rpc.write fault raises here and feeds call()'s retry path
            if faultline.ACTIVE is not None:
                faultline.ACTIVE.check("rpc.write")
            writer.write(_frame({"i": rid, "m": method, "p": payload}))
            await writer.drain()
            return await asyncio.wait_for(fut, timeout)
        except asyncio.TimeoutError:
            raise RpcError(f"{method} timed out after {timeout}s", code="deadline_exceeded") from None
        finally:
            self._pending.pop(rid, None)

    def _drop_connection(self) -> None:
        """The retry path's reset: stop the reader and forget the connection
        now, so the next attempt reconnects."""
        if self._recv_task is not None:
            self._recv_task.cancel()
        self._drop()

    async def close(self) -> None:
        async with self._conn_lock:
            task, writer = self._recv_task, self._writer
            self._drop()
        self._fail_pending()
        if task is not None:
            task.cancel()
        if writer is not None:
            try:
                await writer.wait_closed()
            except OSError as e:
                logger.debug("rpc close of %s: %r", self.address, e)

    async def healthy(self) -> bool:
        try:
            return await self.call("_ping", timeout=2.0) == "pong"
        except (RpcError, OSError) as e:
            logger.debug("health probe of %s failed: %r", self.address, e)
            return False
