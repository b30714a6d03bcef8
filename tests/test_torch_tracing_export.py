"""The port's span exporters (observability/tracing.py), trace-context
continuation on the RPC core, and ``dftrace`` against the reference's.

- With the same span ids and clock, the JSON-lines records and the OTLP
  requests (file, and the bodies posted to a collector) of one sequence of
  spans are the reference's, compared as parsed JSON.
- The OTLP endpoint posts its batches to a local fake collector at
  ``/v1/traces``; the age flush exports a partial batch with no timer
  thread, through the one exporter worker.
- A trace continues across either package's RPC client and server: the
  server's handler runs in the caller's trace, under an ``rpc.server`` span
  whose parent is the client's ``rpc.client`` span; an unsampled context
  stays unrecorded on the far side; a non-string ``"t"`` still gets its
  answer from the port's server.
- Both packages' ``dftrace`` print the same text and JSON over span files
  that both packages wrote (JSON lines and OTLP, one trace across them),
  and skip a torn line alike.
- ``python -m dragonfly2_tpu_torch.cli.dfget --trace-file`` writes a
  ``dfget.download`` root whose context the daemon's RPC server continues.

Every coroutine and process runs under a deadline of 120 s.
"""

from __future__ import annotations

import asyncio
import contextlib
import http.server
import io
import itertools
import json
import os
import secrets
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest
import torch

from dragonfly2_tpu.cli import dftrace as ref_dftrace
from dragonfly2_tpu.observability import tracing as ref_tracing
from dragonfly2_tpu.rpc import core as ref_core
from dragonfly2_tpu_torch.cli import dftrace as port_dftrace
from dragonfly2_tpu_torch.observability import tracing as port_tracing
from dragonfly2_tpu_torch.rpc import core as port_core
from dragonfly2_tpu_torch.trainer._msgpack import packb, unpackb

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent
DEADLINE_S = 120.0
TRACING = {"port": port_tracing, "ref": ref_tracing}
CORE = {"port": port_core, "ref": ref_core}
DFTRACE = {"port": port_dftrace, "ref": ref_dftrace}


def run(coro):
    return asyncio.run(asyncio.wait_for(coro, DEADLINE_S))


@contextlib.contextmanager
def fixed_ids_and_clock(monkeypatch):
    """Span ids from a counter and a clock that steps 1 ms a read, the same
    sequence for each ``with``."""
    ids = itertools.count(1)
    ticks = itertools.count()
    with monkeypatch.context() as m:
        m.setattr(secrets, "token_hex", lambda n: f"{next(ids):0{2 * n}x}")
        m.setattr(time, "time", lambda: 1_700_000_000.0 + next(ticks) / 1000)
        yield


def _spans(mod, tracer) -> None:
    """One sequence of spans: nesting, typed attributes, an error, and a
    continuation of a remote context."""
    with tracer.span("parent", task_id="t1") as parent:
        with tracer.span("child", piece=3, ratio=0.5, ok=True, dispatched=False, queue_wait_ms=0.0):
            pass
        with contextlib.suppress(RuntimeError):
            with tracer.span("broken"):
                raise RuntimeError("boom")
    remote = mod.SpanContext("ab" * 16, "cd" * 8, sampled=True)
    with tracer.span("rpc.server", parent=remote, method="download"):
        pass
    with tracer.span("unsampled", parent=mod.SpanContext("ef" * 16, "01" * 8, sampled=False)):
        pass
    return parent


def _exports(pkg: str, tmp_path: Path, monkeypatch) -> tuple[list, list]:
    mod = TRACING[pkg]
    jsonl, otlp = tmp_path / f"{pkg}.jsonl", tmp_path / f"{pkg}.otlp.jsonl"
    with fixed_ids_and_clock(monkeypatch):
        tracer = mod.Tracer(service="svc-x", path=str(jsonl), otlp_path=str(otlp), otlp_batch=3)
        _spans(mod, tracer)
        tracer.close()
    return ([json.loads(ln) for ln in jsonl.read_text().splitlines()],
            [json.loads(ln) for ln in otlp.read_text().splitlines()])


def test_jsonl_records_and_otlp_requests_equal_the_references(tmp_path, monkeypatch):
    for var in ("DRAGONFLY_TRACE_FILE", "DRAGONFLY_OTLP_FILE", "DRAGONFLY_OTLP_ENDPOINT", "DRAGONFLY_TRACE_SAMPLE"):
        monkeypatch.delenv(var, raising=False)
    port_lines, port_otlp = _exports("port", tmp_path, monkeypatch)
    ref_lines, ref_otlp = _exports("ref", tmp_path, monkeypatch)
    assert port_lines == ref_lines and port_otlp == ref_otlp
    assert [r["name"] for r in port_lines] == ["child", "broken", "parent", "rpc.server"]
    assert port_lines[1]["status"] == "error" and "boom" in port_lines[1]["error"]
    # batches of 3, then the rest flushed by close()
    assert [len(r["resourceSpans"][0]["scopeSpans"][0]["spans"]) for r in port_otlp] == [3, 1]


def test_spans_to_otlp_equals_the_references(monkeypatch):
    got = {}
    for pkg, mod in TRACING.items():
        with fixed_ids_and_clock(monkeypatch):
            tracer = mod.Tracer(service="svc-y")
            _spans(mod, tracer)
            got[pkg] = mod.spans_to_otlp(tracer.finished(), "svc-y")
    assert got["port"] == got["ref"]


class _Collector:
    """A fake OTLP collector: records the JSON bodies POSTed to /v1/traces."""

    def __init__(self):
        bodies = self.bodies = []

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_POST(self):  # noqa: N802 - the stdlib's name
                body = self.rfile.read(int(self.headers["Content-Length"]))
                bodies.append((self.path, json.loads(body)))
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = http.server.ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(10)


def test_the_otlp_endpoint_posts_what_the_reference_posts(monkeypatch):
    monkeypatch.delenv("DRAGONFLY_TRACE_SAMPLE", raising=False)
    posted = {}
    for pkg, mod in TRACING.items():
        with _Collector() as collector, fixed_ids_and_clock(monkeypatch):
            tracer = mod.Tracer(service="svc-z", otlp_endpoint=collector.url, otlp_batch=2)
            _spans(mod, tracer)
            tracer.close()  # the last partial batch goes out in the caller's thread
            posted[pkg] = sorted(collector.bodies, key=json.dumps)
    assert posted["port"] == posted["ref"]
    assert {p for p, _ in posted["port"]} == {"/v1/traces"}
    assert sum(len(b["resourceSpans"][0]["scopeSpans"][0]["spans"]) for _, b in posted["port"]) == 4


def test_the_age_flush_starts_no_timer_thread(tmp_path):
    before = set(threading.enumerate())
    tracer = port_tracing.Tracer(service="t", otlp_path=str(tmp_path / "o.jsonl"), otlp_max_age_s=0.2)
    try:
        for i in range(5):
            with tracer.span(f"s{i}"):
                pass
        new = [t for t in threading.enumerate() if t not in before]
        assert not [t for t in new if isinstance(t, threading.Timer)]
        assert len(new) == 1 and new[0].daemon  # the one exporter worker
        deadline = time.monotonic() + 5
        while not ((tmp_path / "o.jsonl").exists() and (tmp_path / "o.jsonl").read_text().strip()):
            assert time.monotonic() < deadline, "the age flush never exported"
            time.sleep(0.05)
        (req,) = [json.loads(ln) for ln in (tmp_path / "o.jsonl").read_text().splitlines()]
        assert len(req["resourceSpans"][0]["scopeSpans"][0]["spans"]) == 5
    finally:
        tracer.close()
    assert not new[0].is_alive()


# ---------------------------------------------------------------------------
# trace-context continuation across the packages


@pytest.fixture
def swapped(tmp_path):
    """Both packages' process tracers recording in memory for the test."""
    saved = {pkg: mod._default for pkg, mod in TRACING.items()}
    for pkg, mod in TRACING.items():
        mod._default = mod.Tracer(service=f"{pkg}-svc")
    yield {pkg: mod._default for pkg, mod in TRACING.items()}
    for pkg, mod in TRACING.items():
        mod._default.close()
        mod._default = saved[pkg]


@pytest.mark.parametrize("client_pkg,server_pkg", [("port", "ref"), ("ref", "port"), ("port", "port")])
@pytest.mark.parametrize("sampled", [True, False])
def test_a_trace_continues_across_either_packages_client_and_server(swapped, client_pkg, server_pkg, sampled):
    client_tracing, server_tracing = TRACING[client_pkg], TRACING[server_pkg]
    seen: list = []

    async def body():
        srv = CORE[server_pkg].RpcServer(port=0)

        async def peek(p):
            seen.append(server_tracing.Tracer.current_context())
            return "ok"

        srv.register("peek", peek)
        await srv.start()
        client = CORE[client_pkg].RpcClient(f"127.0.0.1:{srv.port}", retries=0)
        try:
            root_tracer = client_tracing.Tracer(service="root", sample_rate=1.0 if sampled else 0.0)
            with root_tracer.span("root") as root:
                await client.call("peek")
            await client.call("peek")  # no active trace: no "t", no server context
            return root
        finally:
            await client.close()
            await srv.stop()

    root = run(body())
    assert seen[1] is None
    assert seen[0] is not None and seen[0].trace_id == root.trace_id and seen[0].sampled is sampled
    client_spans = {s.name: s for s in swapped[client_pkg].finished()}
    server_spans = {s.name: s for s in swapped[server_pkg].finished()}
    if not sampled:
        assert "rpc.server" not in server_spans and "rpc.client" not in client_spans
        return
    assert client_spans["rpc.client"].trace_id == root.trace_id
    assert client_spans["rpc.client"].attrs["method"] == "peek"
    assert server_spans["rpc.server"].parent_id == client_spans["rpc.client"].span_id
    assert server_spans["rpc.server"].attrs["method"] == "peek"


def test_a_non_string_trace_field_still_gets_its_answer():
    async def body():
        srv = port_core.RpcServer(port=0)

        async def echo(p):
            return p

        srv.register("echo", echo)
        await srv.start()
        reader, writer = await asyncio.open_connection("127.0.0.1", srv.port)
        try:
            frame = packb({"i": 7, "m": "echo", "p": "x", "t": 5})
            writer.write(struct.pack(">I", len(frame)) + frame)
            await writer.drain()
            (length,) = struct.unpack(">I", await asyncio.wait_for(reader.readexactly(4), 5))
            return unpackb(await asyncio.wait_for(reader.readexactly(length), 5))
        finally:
            writer.close()
            await srv.stop()

    assert run(body()) == {"i": 7, "r": "x"}


# ---------------------------------------------------------------------------
# dftrace


def _mixed_files(tmp_path: Path) -> list[str]:
    """One trace across both packages: a port JSON-lines root, a reference
    JSON-lines span, then a reference OTLP child with a port OTLP
    grandchild (the critical path); and a second trace."""
    a = port_tracing.Tracer(service="svc-a", path=str(tmp_path / "a.jsonl"))
    b = ref_tracing.Tracer(service="svc-b", otlp_path=str(tmp_path / "b.otlp.jsonl"), otlp_batch=100)
    c = port_tracing.Tracer(service="svc-c", otlp_path=str(tmp_path / "c.otlp.jsonl"), otlp_batch=100)
    d = ref_tracing.Tracer(service="svc-d", path=str(tmp_path / "d.jsonl"))
    with a.span("root"):
        with d.span("other", parent=port_tracing.Tracer.current_context(), method="x"):
            pass
        with b.span("remote.child", parent=port_tracing.Tracer.current_context(), k=1, dispatched=False,
                    queue_wait_ms=0.0, piece=5) as child:
            time.sleep(0.002)
            with c.span("grandchild", parent=port_tracing.SpanContext(child.trace_id, child.span_id)):
                time.sleep(0.001)
    with a.span("second-root"):
        pass
    for t in (a, b, c, d):
        t.close()
    return [str(tmp_path / n) for n in ("a.jsonl", "b.otlp.jsonl", "c.otlp.jsonl", "d.jsonl")]


def _cli(pkg: str, argv: list[str]) -> tuple[int, str]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = DFTRACE[pkg].main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("extra", [[], ["--json"], ["--top", "1"], ["--trace", "PREFIX"]])
def test_both_dftraces_print_the_same_over_both_packages_files(tmp_path, extra):
    files = _mixed_files(tmp_path)
    spans = port_dftrace.load_spans(files)
    assert spans == ref_dftrace.load_spans(files) and len(spans) == 5
    root = next(s for s in spans if s["name"] == "root")
    argv = [a.replace("PREFIX", root["trace_id"][:8]) for a in extra] + files
    port, ref = _cli("port", argv), _cli("ref", argv)
    assert port == ref and port[0] == 0
    traces = port_dftrace.assemble_traces(spans)
    path = [s["name"] for s, _ in port_dftrace.critical_path(traces[root["trace_id"]])]
    assert path == ["root", "remote.child", "grandchild"]


def test_both_dftraces_skip_a_torn_line(tmp_path):
    p = tmp_path / "torn.jsonl"
    p.write_text('{"trace_id": "t1", "span_id": "s1", "parent_id": "", "name": "a", '
                 '"start": 1.0, "duration_ms": 5.0, "attrs": {}}\n{"trace_id": "t1", "spa')
    assert port_dftrace.load_spans([str(p)]) == ref_dftrace.load_spans([str(p)])
    assert len(port_dftrace.load_spans([str(p)])) == 1


# ---------------------------------------------------------------------------
# dfget --trace-file


def test_dfget_trace_file_writes_a_root_the_daemon_continues(tmp_path, swapped):
    """The port's dfget as a process against a port RpcServer on a unix
    socket with a stub ``download``: the span file holds the
    ``dfget.download`` root and its ``rpc.client``, and the server's
    ``rpc.server`` span is that client span's child."""
    sock = str(tmp_path / "d.sock")

    async def body():
        srv = port_core.RpcServer(unix_path=sock)

        async def download(p):
            return {"content_length": 3, "pieces": 1, "task_id": "ab" * 32}

        srv.register("download", download)
        await srv.start()
        try:
            proc = await asyncio.create_subprocess_exec(
                sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfget", "http://127.0.0.1:9/f", "-O",
                str(tmp_path / "out"), "--sock", sock, "--no-spawn", "--trace-file", str(tmp_path / "t.jsonl"),
                env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.PIPE)
            out, err = await asyncio.wait_for(proc.communicate(), DEADLINE_S)
            return proc.returncode, out.decode(), err.decode()
        finally:
            await srv.stop()

    rc, out, err = run(body())
    assert rc == 0, err
    assert "downloaded http://127.0.0.1:9/f" in out
    spans = {s["name"]: s for s in map(json.loads, (tmp_path / "t.jsonl").read_text().splitlines())}
    root, client = spans["dfget.download"], spans["rpc.client"]
    assert root["parent_id"] == "" and root["attrs"]["service"] == "dfget"
    assert client["parent_id"] == root["span_id"] and client["attrs"]["method"] == "download"
    (server,) = [s for s in swapped["port"].finished() if s.name == "rpc.server"]
    assert server.trace_id == root["trace_id"] and server.parent_id == client["span_id"]
