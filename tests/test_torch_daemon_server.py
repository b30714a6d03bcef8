"""The port's daemon as a process, with dfget, dfcache and dfmodel.

- ``python -m dragonfly2_tpu_torch.daemon.server`` prints ``DAEMON_READY
  <sock> <upload port>``; importing the module loads no torch; SIGTERM right
  after the ready line stops it with exit code 0 and removes its socket.
- Either package's dfget drives either package's daemon process, bit-exact,
  the origin serving each file once; a file fetched by one package's daemon
  goes to the other's peer to peer (the origin not touched again).
- dfcache import, stat, export and rm on the port's daemon; the reference's
  dfcache reads the same stat.
- dfmodel publish and fetch through the daemons: the port's manifest equals
  the reference's apart from ``created_at``; a checkpoint published by the
  reference's daemon is fetched by the port's, bit-equal.
- The image-acceleration front and the object gateway: a daemon process
  booted with each of their flags, or their YAML section, answers on the
  server it starts (the proxy, the registry mirror, the hijack's forged
  leaf, a tunnel, the SNI proxy, the gateway on the fs and s3 backends); a
  daemon booted with all of them and driven through each has loaded no
  torch.
- The flags and the YAML section the port once refused boot a serving
  daemon: the mTLS piece plane (``--data-tls-dir``, ``--piece-cipher``),
  ``--vsock-port``, ``--metrics-port`` and a ``tracing:`` exporter; a bad
  ``--piece-cipher`` exits 2 as a process; ``dfget --trace-file`` records
  its trace, the daemon's spans joining it.

One port scheduler process, one port daemon and one reference daemon serve
the module; every process has a deadline of 60 s.
"""

import asyncio
import concurrent.futures
import hashlib
import io
import json
import os
import re
import shutil
import signal
import ssl
import subprocess
import sys
import threading
import time
from contextlib import redirect_stderr, redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch
from aiohttp import web

from fakes3 import FakeS3

from dragonfly2_tpu.cli import dfcache as ref_dfcache
from dragonfly2_tpu.cli import dfget as ref_dfget
from dragonfly2_tpu.cli import dfmodel as ref_dfmodel
from dragonfly2_tpu_torch.cli import dfcache, dfget, dfmodel, dfstore
from dragonfly2_tpu_torch.daemon import server as daemon_server
from dragonfly2_tpu_torch.tpuvm import safetensors as stlib
from dragonfly2_tpu_torch.utils.proc import ready_address
from dragonfly2_tpu_torch.utils.pieces import parse_http_range

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

TESTS = Path(__file__).resolve().parent
REPO = TESTS.parent
DEADLINE_S = 60.0
PORT_DAEMON = [sys.executable, "-m", "dragonfly2_tpu_torch.daemon.server"]
# the reference's daemon, its conductor draining deferred writes with the port's
REF_DAEMON = [sys.executable, str(TESTS / "refdrain.py")]


@pytest.fixture(autouse=True)
def _tracers_as_found():
    """dfget's main configures its process's default tracer, as a CLI's
    entry point does (service name, head-sampling rate); these tests call it
    in process, so each test leaves both packages' tracers as it found
    them for the tests that run after it in the same process."""
    from dragonfly2_tpu.observability import tracing as ref_tracing
    from dragonfly2_tpu_torch.observability import tracing as port_tracing

    saved = [(t, t.service, t.sample_rate, t.path)
             for t in (ref_tracing.default_tracer(), port_tracing.default_tracer())]
    yield
    for t, service, rate, path in saved:
        if t.path != path:
            t.close()  # flushes and closes the span file a test named
        t.service, t.sample_rate, t.path = service, rate, path


def _env() -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1", "JAX_PLATFORMS": "cpu"}


class ThreadOrigin:
    """An aiohttp origin with Range support on its own loop and thread,
    counting the bytes it serves per file."""

    def __init__(self):
        self.files: dict[str, bytes] = {}
        self.sent: dict[str, int] = {}
        self.port = 0
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def add(self, name: str, data: bytes) -> str:
        self.files[name] = data
        return f"http://127.0.0.1:{self.port}/{name}"

    async def _handle(self, request):
        name = request.match_info["name"]
        data = self.files.get(name)
        if data is None:
            raise web.HTTPNotFound()
        if request.method == "HEAD":
            return web.Response(headers={"Content-Length": str(len(data)), "Accept-Ranges": "bytes"})
        rng = request.headers.get("Range")
        if rng:
            r = parse_http_range(rng, len(data))
            body = data[r.start:r.start + r.length]
            self.sent[name] = self.sent.get(name, 0) + len(body)
            return web.Response(status=206, body=body,
                                headers={"Content-Range": f"bytes {r.start}-{r.end}/{len(data)}"})
        self.sent[name] = self.sent.get(name, 0) + len(data)
        return web.Response(body=data)

    def _run(self):
        asyncio.set_event_loop(self._loop)
        app = web.Application()
        app.router.add_get("/{name}", self._handle)
        runner = web.AppRunner(app, access_log=None)
        self._loop.run_until_complete(runner.setup())
        site = web.TCPSite(runner, "127.0.0.1", 0)
        self._loop.run_until_complete(site.start())
        self.port = site._server.sockets[0].getsockname()[1]
        self._ready.set()
        self._loop.run_forever()
        self._loop.run_until_complete(runner.cleanup())
        self._loop.close()

    def start(self):
        self._thread.start()
        assert self._ready.wait(DEADLINE_S)
        return self

    def stop(self):
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(DEADLINE_S)


def _spawn(cmd: list[str], cwd: Path, log: Path, env: dict | None = None) -> subprocess.Popen:
    with open(log, "w") as err:
        return subprocess.Popen(cmd, cwd=cwd, env={**_env(), **(env or {})}, stdout=subprocess.PIPE, stderr=err,
                                text=True)


def _stop(procs: list[subprocess.Popen]) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGTERM)
    for p in procs:
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p.stdout.close()


def _daemon(cmd: list[str], tmp: Path, name: str, sched: str, procs: list, args: tuple = (),
            env: dict | None = None) -> dict:
    sock = tmp / f"{name}.sock"
    p = _spawn([*cmd, "--scheduler", sched, "--storage", str(tmp / name), "--sock", str(sock),
                "--hostname", name, *args], tmp, tmp / f"{name}.log", env)
    procs.append(p)
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        line = pool.submit(p.stdout.readline)
        try:
            line = line.result(timeout=DEADLINE_S)
        except concurrent.futures.TimeoutError:
            p.kill()
            raise
    assert line.startswith("DAEMON_READY "), (line, (tmp / f"{name}.log").read_text()[-2000:])
    return {"sock": str(sock), "ready": line.split()[1:], "proc": p, "log": tmp / f"{name}.log"}


@pytest.fixture(scope="module")
def cluster(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("daemons")
    procs: list[subprocess.Popen] = []
    origin = ThreadOrigin().start()
    try:
        sched = _spawn([sys.executable, "-m", "dragonfly2_tpu_torch.scheduler.server", "--host", "127.0.0.1",
                        "--port", "0"], tmp, tmp / "scheduler.log")
        procs.append(sched)
        addr = ready_address(sched, "SCHEDULER_READY", time.monotonic() + DEADLINE_S)
        yield {
            "tmp": tmp, "origin": origin, "scheduler": addr,
            "port": _daemon(PORT_DAEMON, tmp, "port-d", addr, procs),
            "ref": _daemon(REF_DAEMON, tmp, "ref-d", addr, procs),
        }
    finally:
        _stop(procs)
        origin.stop()


def cli(main, argv: list[str], *, prog: str = "cli", sys_argv: bool = False) -> tuple[int, str, str]:
    """Exit code, standard output and standard error of one CLI call;
    ``sys_argv`` for a ``main()`` that reads ``sys.argv``."""
    out, err = io.StringIO(), io.StringIO()
    saved = sys.argv
    with redirect_stdout(out), redirect_stderr(err):
        try:
            if sys_argv:
                sys.argv = [prog, *argv]
                rc = main()
            else:
                rc = main(argv)
        except SystemExit as e:
            rc = e.code
        finally:
            sys.argv = saved
    return rc or 0, out.getvalue(), err.getvalue()


def _payload(seed: int, size: int = 9 << 20) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


# ---------------------------------------------------------------------------
# the process


def test_the_daemon_prints_its_ready_line(cluster):
    sock, port = cluster["port"]["ready"]
    assert sock == cluster["port"]["sock"] and int(port) > 0
    assert Path(sock).exists()


def test_importing_the_daemon_server_loads_no_torch():
    probe = ("import sys, dragonfly2_tpu_torch.daemon.server, dragonfly2_tpu_torch.cli.dfget; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in "
             "('torch', 'jax', 'flax', 'dragonfly2_tpu')))")
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO, env=_env(), capture_output=True, text=True,
                       timeout=DEADLINE_S)
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "[]"


def test_sigterm_stops_the_daemon_with_exit_code_0(tmp_path, cluster):
    procs: list[subprocess.Popen] = []
    try:
        d = _daemon(PORT_DAEMON, tmp_path, "term-d", cluster["scheduler"], procs)
        t0 = time.monotonic()
        d["proc"].send_signal(signal.SIGTERM)
        assert d["proc"].wait(timeout=10) == 0, d["log"].read_text()[-2000:]
        assert time.monotonic() - t0 < 10
        assert not Path(d["sock"]).exists()
    finally:
        _stop(procs)


# ---------------------------------------------------------------------------
# dfget against either package's daemon


@pytest.mark.parametrize("cli_pkg,daemon", [("port", "ref"), ("ref", "port"), ("port", "port"), ("ref", "ref")])
def test_dfget_drives_either_packages_daemon(cluster, tmp_path, cli_pkg, daemon):
    name = f"{cli_pkg}-cli-{daemon}-daemon.bin"
    data = _payload(len(name))
    url = cluster["origin"].add(name, data)
    main = dfget.main if cli_pkg == "port" else ref_dfget.main
    out = tmp_path / "out.bin"
    rc, text, err = cli(main, [url, "-O", str(out), "--sock", cluster[daemon]["sock"], "--no-spawn",
                               "--timeout", str(DEADLINE_S)])
    assert rc == 0, err
    assert text.startswith(f"downloaded {url} -> {out}: {len(data)} bytes")
    assert hashlib.sha256(out.read_bytes()).digest() == hashlib.sha256(data).digest()
    assert cluster["origin"].sent[name] == len(data)


@pytest.mark.parametrize("first,second", [("ref", "port"), ("port", "ref")])
def test_a_file_crosses_the_packages_peer_to_peer(cluster, tmp_path, first, second):
    """The second daemon takes every piece from the first's upload server:
    the port's conductor from the reference's upload server, and the
    reverse."""
    name = f"p2p-{first}-then-{second}.bin"
    data = _payload(len(name) + 100)
    url = cluster["origin"].add(name, data)
    for i, daemon in enumerate((first, second)):
        out = tmp_path / f"out{i}.bin"
        rc, _, err = cli(dfget.main, [url, "-O", str(out), "--sock", cluster[daemon]["sock"], "--no-spawn",
                                      "--timeout", str(DEADLINE_S)])
        assert rc == 0, err
        assert out.read_bytes() == data
        assert cluster["origin"].sent[name] == len(data)


# ---------------------------------------------------------------------------
# dfcache and dfmodel


def test_dfcache_import_stat_export_rm(cluster, tmp_path):
    sock = ["--sock", cluster["port"]["sock"], "--no-spawn", "--timeout", str(DEADLINE_S)]
    blob = tmp_path / "blob.bin"
    blob.write_bytes(_payload(77, 5 << 20))
    rc, out, err = cli(dfcache.main, [*sock, "import", str(blob), "--tag", "t"], prog="dfcache", sys_argv=True)
    assert rc == 0, err
    imported = json.loads(out)
    task = imported["task_id"]
    rc, out, err = cli(dfcache.main, [*sock, "stat", task], prog="dfcache", sys_argv=True)
    assert rc == 0, err
    stat = json.loads(out)
    assert stat == {"task_id": task, "content_length": 5 << 20, "pieces": imported["pieces"],
                    "total_pieces": imported["pieces"], "done": True}
    ref_rc, ref_out, _ = cli(ref_dfcache.main, [*sock, "stat", task], prog="dfcache", sys_argv=True)
    assert (ref_rc, json.loads(ref_out)) == (0, stat)
    copy = tmp_path / "copy.bin"
    rc, out, err = cli(dfcache.main, [*sock, "export", task, "-O", str(copy)], prog="dfcache", sys_argv=True)
    assert rc == 0 and copy.read_bytes() == blob.read_bytes(), err
    rc, out, err = cli(dfcache.main, [*sock, "rm", task], prog="dfcache", sys_argv=True)
    assert rc == 0 and out.strip() == f"deleted {task}"
    rc, out, err = cli(dfcache.main, [*sock, "stat", task], prog="dfcache", sys_argv=True)
    assert rc == 1 and "not found" in err


def _checkpoint(directory: Path, seed: int) -> Path:
    rng = np.random.default_rng(seed)
    directory.mkdir(parents=True)
    stlib.write_safetensors(directory / "model-00001.safetensors",
                            {"a": rng.standard_normal((256, 256)).astype(np.float32)})
    stlib.write_safetensors(directory / "model-00002.safetensors",
                            {"b": (rng.integers(0, 1 << 16, (512, 64))).astype(np.uint16)}, bf16_names=["b"])
    (directory / "config.json").write_text(json.dumps({"model_type": "demo", "seed": seed}))
    return directory


def _manifest(directory: Path) -> dict:
    m = json.loads((directory / "dragonfly-checkpoint.json").read_text())
    assert m.pop("created_at") > 0
    return m


@pytest.mark.parametrize("argv", [["publish"], ["fetch", "-O"], ["--no-spawn", "publish", "--name", "custom"]],
                         ids=["publish", "fetch-O", "no-spawn-publish-name"])
def test_dfmodel_publish_and_fetch_through_the_daemon(cluster, tmp_path, argv):
    seed = {"publish": 1, "fetch": 2}.get(argv[0], 3)
    src = _checkpoint(tmp_path / "ref" / "ckpt", seed)
    rest = argv[argv.index("--name"):] if "--name" in argv else []
    head = (["--no-spawn"] if argv[0] == "--no-spawn" else []) + ["--timeout", str(DEADLINE_S)]
    # the reference's dfmodel publishes through the reference's daemon
    rc, out, err = cli(ref_dfmodel.main, [*head, "--sock", cluster["ref"]["sock"], "publish", str(src), *rest],
                       prog="dfmodel", sys_argv=True)
    assert rc == 0, err
    want = _manifest(src)
    if argv[0] == "fetch":
        # the port's fetches the reference daemon's manifest peer to peer
        dest = tmp_path / "staged"
        rc, out, err = cli(dfmodel.main, [*head, "--sock", cluster["port"]["sock"], "fetch",
                                          str(src / "dragonfly-checkpoint.json"), "-O", str(dest)],
                           prog="dfmodel", sys_argv=True)
        assert rc == 0, err
        result = json.loads(out)
        assert (result["name"], result["files"]) == ("ckpt", 3)
        for entry in want["files"]:
            assert (dest / entry["path"]).read_bytes() == (src / entry["path"]).read_bytes()
        assert _manifest(dest) == want
        return
    port_src = shutil.copytree(src, tmp_path / "port" / "ckpt", ignore=shutil.ignore_patterns("dragonfly-*"))
    rc, out, err = cli(dfmodel.main, [*head, "--sock", cluster["port"]["sock"], "publish", str(port_src), *rest],
                       prog="dfmodel", sys_argv=True)
    assert rc == 0, err
    result = json.loads(out)
    got = _manifest(port_src)
    assert got == want
    assert result == {"name": got["name"], "files": 3, "total_bytes": sum(e["size"] for e in got["files"]),
                      "manifest": str(port_src) + "/dragonfly-checkpoint.json"}
    assert got["name"] == (rest[1] if rest else "ckpt")


# ---------------------------------------------------------------------------
# refusals


REFUSED = [
    (["--data-tls-dir", "certs"], "DataPlaneTls"),
    (["--piece-cipher", "aes-gcm"], "DataPlaneTls"),
    (["--vsock-port", "5000"], "rpc/core.py"),
    (["--metrics-port", "0"], "observability/server.py"),
    (["--config", "tracing.yaml"], "tracing exporters"),
]


def _certs(tmp_path: Path) -> Path:
    """One leaf for 127.0.0.1 from a port CA, in --data-tls-dir's layout."""
    from dragonfly2_tpu_torch.security.ca import CertificateAuthority, write_issued

    ca = CertificateAuthority(tmp_path / "ca")
    write_issued(ca.issue("daemon", sans=["127.0.0.1"]), tmp_path / "certs")
    return tmp_path / "certs"


def _scrape(port: int) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


@pytest.mark.parametrize("args,item", REFUSED, ids=[" ".join(a) for a, _ in REFUSED])
def test_flags_the_port_has_not_ported_are_refused(cluster, args, item, tmp_path):
    """Once refused with exit code 2, now ported: each boots a daemon that
    serves what the flag turned on (the mTLS piece server with its cipher,
    the vsock listener, the debug server, the span file)."""
    (tmp_path / "tracing.yaml").write_text(f"tracing:\n  trace_file: {tmp_path / 'spans.jsonl'}\n"
                                           "  sample_rate: 1.0\n")
    certs = _certs(tmp_path)
    args = list(args) + (["--data-tls-dir", str(certs)] if args[0] == "--piece-cipher" else [])
    if args[0] == "--vsock-port":
        # a free vsock port: the host's kernel may hold this one already
        from dragonfly2_tpu_torch.rpc.core import vsock_socket

        with vsock_socket() as s:
            import socket as socketlib

            s.bind((socketlib.VMADDR_CID_ANY, socketlib.VMADDR_PORT_ANY))
            args[1] = str(s.getsockname()[1])
    procs: list[subprocess.Popen] = []
    try:
        d = _daemon(PORT_DAEMON, tmp_path, "flag-d", cluster["scheduler"], procs, tuple(args))
        log = d["log"].read_text()
        if item == "DataPlaneTls":
            want = "aes-gcm" if "--piece-cipher" in args else ""
            assert f"data-plane mTLS on: cipher={want}" in log and "(mTLS, raw)" in log, log[-2000:]
        elif item == "rpc/core.py":
            assert f"daemon vsock rpc on vsock://2:{args[1]}" in log, log[-2000:]
        elif item == "observability/server.py":
            m = re.search(r"daemon metrics on [\d.]+:(\d+)", log)
            assert m, log[-2000:]
            assert "# TYPE dragonfly_dfdaemon_piece_tls_handshakes_total counter" in _scrape(int(m.group(1)))
    finally:
        _stop(procs)
    assert procs[0].returncode == 0, d["log"].read_text()[-2000:]


def test_a_refused_flag_exits_2_as_a_process(tmp_path):
    """A cipher outside the data plane's two is refused with exit code 2."""
    p = subprocess.run([*PORT_DAEMON, "--scheduler", "127.0.0.1:9", "--storage", str(tmp_path / "s"),
                        "--sock", str(tmp_path / "d.sock"), "--data-tls-dir", str(tmp_path),
                        "--piece-cipher", "rc4"],
                       cwd=tmp_path, env=_env(), capture_output=True, text=True, timeout=DEADLINE_S)
    assert p.returncode == 2
    assert "--piece-cipher" in p.stderr and "rc4" in p.stderr, p.stderr
    assert "DAEMON_READY" not in p.stdout and not (tmp_path / "s").exists()


def test_dfget_refuses_a_trace_file(cluster, tmp_path):
    """Once refused with exit code 2, now ported: ``--trace-file`` records
    the download's ``dfget.download`` root, and the daemon's RPC server span
    continues its trace."""
    from dragonfly2_tpu_torch.observability.tracing import default_tracer

    url = cluster["origin"].add("traced.bin", _payload(31, 1 << 20))
    rc, out, err = cli(dfget.main, [url, "-O", str(tmp_path / "x"), "--trace-file", str(tmp_path / "t.jsonl"),
                                    "--sock", cluster["port"]["sock"], "--no-spawn"])
    assert rc == 0, err
    default_tracer().close()
    spans = [json.loads(ln) for ln in (tmp_path / "t.jsonl").read_text().splitlines()]
    (root,) = [s for s in spans if s["name"] == "dfget.download"]
    assert root["parent_id"] == "" and root["attrs"]["url"] == url and root["status"] == "ok"
    client = [s for s in spans if s["name"] == "rpc.client"]
    assert client and all(s["trace_id"] == root["trace_id"] for s in client)


# ---------------------------------------------------------------------------
# the image-acceleration front and the object gateway


class ThreadFakeS3:
    """``tests/fakes3.py`` (which verifies with the reference's signer) on its
    own loop and thread."""

    def __init__(self):
        self.s3 = FakeS3()
        self._loop = asyncio.new_event_loop()
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        asyncio.set_event_loop(self._loop)
        self._loop.run_until_complete(self.s3.__aenter__())
        self._ready.set()
        self._loop.run_forever()
        self._loop.run_until_complete(self.s3.__aexit__(None, None, None))
        self._loop.close()

    def __enter__(self):
        self._thread.start()
        assert self._ready.wait(DEADLINE_S)
        return self.s3

    def __exit__(self, *exc):
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._thread.join(DEADLINE_S)


_SERVES = {"proxy": r"(?<!sni )proxy on [\d.]+:(\d+)", "sni": r"sni proxy on [\d.]+:(\d+)",
           "gateway": r"object gateway on [\d.]+:(\d+)"}


def _listening(d: dict, server: str) -> int:
    """The port a booted daemon's log names for one of its servers."""
    m = re.search(_SERVES[server], d["log"].read_text())
    assert m, d["log"].read_text()[-2000:]
    return int(m.group(1))


async def _http(method: str, url: str, **kw) -> tuple[int, dict, bytes]:
    import aiohttp

    async with aiohttp.ClientSession() as sess:
        async with sess.request(method, url, **kw) as r:
            return r.status, dict(r.headers), await r.read()


async def _connect(port: int, target: str) -> tuple[asyncio.StreamReader, asyncio.StreamWriter, bytes]:
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    writer.write(f"CONNECT {target} HTTP/1.1\r\n\r\n".encode())
    await writer.drain()
    status = await reader.readline()
    while (await reader.readline()) not in (b"\r\n", b"\n", b""):
        pass
    return reader, writer, status


async def _forged_leaf_subject(port: int, ca_pem: Path, connect: str | None) -> dict:
    """A TLS handshake as "localhost" that trusts only the hijack CA, on the
    proxy through a CONNECT or on the SNI proxy straight: the leaf's subject."""
    trust = ssl.create_default_context(cafile=str(ca_pem))
    if connect is not None:
        reader, writer, status = await _connect(port, connect)
        assert b" 200 " in status, status
    else:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        await writer.start_tls(trust, server_hostname="localhost")
        return dict(x[0] for x in writer.get_extra_info("peercert")["subject"])
    finally:
        writer.close()


FRONT = {
    "proxy-port": ["--proxy-port", "0"],
    "proxy-rule": ["--proxy-port", "0", "--proxy-rule", r"\.bin$"],
    "registry-mirror": ["--proxy-port", "0", "--registry-mirror", "{origin}"],
    "hijack-ca-dir": ["--proxy-port", "0", "--hijack-ca-dir", "ca"],
    "hijack-host": ["--proxy-port", "0", "--hijack-ca-dir", "ca", "--hijack-host", "^nomatch$"],
    "sni-proxy-port": ["--sni-proxy-port", "0", "--hijack-ca-dir", "ca"],
    "object-storage-port": ["--object-storage-port", "0"],
    "object-storage-root": ["--object-storage-port", "0", "--object-storage-root", "objects"],
    "object-storage-backend": ["--object-storage-port", "0", "--object-storage-backend", "s3"],
    "proxy.yaml": ["--config", "proxy.yaml"],
    "objects.yaml": ["--config", "objects.yaml"],
}


async def _front_answer(case: str, d: dict, tmp: Path, origin: ThreadOrigin, s3) -> None:
    """Drive the server ``case`` started in the booted daemon ``d``."""
    name = f"front-{case}.bin"
    data = _payload(len(name), 3 << 20)
    url = origin.add(name, data)
    if case in ("proxy-port", "proxy-rule", "proxy.yaml"):
        port = _listening(d, "proxy")
        status, headers, body = await _http("GET", url, proxy=f"http://127.0.0.1:{port}")
        assert (status, body) == (200, data)
        assert headers.get("X-Dragonfly-Via") == (None if case == "proxy-port" else "p2p")
    elif case == "registry-mirror":
        status, headers, body = await _http("GET", f"http://127.0.0.1:{_listening(d, 'proxy')}/{name}")
        assert (status, body) == (200, data)
    elif case in ("hijack-ca-dir", "sni-proxy-port"):
        server = "proxy" if case == "hijack-ca-dir" else "sni"
        subject = await _forged_leaf_subject(_listening(d, server), tmp / "ca" / "ca.pem",
                                             "localhost:9" if server == "proxy" else None)
        assert subject["commonName"] == "localhost"
    elif case == "hijack-host":
        reader, writer, status = await _connect(_listening(d, "proxy"), f"127.0.0.1:{origin.port}")
        assert b" 200 " in status, status
        writer.write(f"GET /{name} HTTP/1.1\r\nHost: 127.0.0.1\r\nConnection: close\r\n\r\n".encode())
        await writer.drain()
        resp = await reader.read()
        writer.close()
        assert resp.startswith(b"HTTP/1.1 200") and resp.endswith(data)
    else:
        data = data[:512 << 10]  # one simple PUT within the s3 fake's 1 MiB body limit
        port = _listening(d, "gateway")
        status, _, body = await _http("GET", f"http://127.0.0.1:{port}/healthz")
        assert (status, json.loads(body)) == (200, {"status": "ok"})
        store = dfstore.Dfstore(f"http://127.0.0.1:{port}")
        try:
            await store.create_bucket("front")
            put = await store.put_object("front", "k.bin", data)
            assert put["content_length"] == len(data)
            assert await store.get_object("front", "k.bin", direct=True) == data
        finally:
            await store.close()
        root = {"object-storage-port": tmp / "front-d-objects", "object-storage-root": tmp / "objects",
                "objects.yaml": tmp / "yaml-objects"}.get(case)
        if root is not None:
            assert (root / "front" / "k.bin").read_bytes() == data
        else:
            assert s3.buckets["front"]["k.bin"][0] == data


@pytest.mark.parametrize("case", list(FRONT))
def test_the_image_front_and_gateway_flags_boot_a_serving_daemon(cluster, tmp_path, case):
    (tmp_path / "proxy.yaml").write_text("proxy:\n  port: 0\n  rules: ['\\.bin$']\n")
    (tmp_path / "objects.yaml").write_text("object_storage:\n  port: 0\n  root: yaml-objects\n")
    origin = cluster["origin"]
    args = [a.replace("{origin}", f"http://127.0.0.1:{origin.port}") for a in FRONT[case]]
    procs: list[subprocess.Popen] = []
    with ThreadFakeS3() as s3:
        env = {"AWS_ENDPOINT_URL": s3.endpoint, "AWS_ACCESS_KEY_ID": "testkey", "AWS_SECRET_ACCESS_KEY": "testsecret"}
        try:
            d = _daemon(PORT_DAEMON, tmp_path, "front-d", cluster["scheduler"], procs, args, env)
            asyncio.run(asyncio.wait_for(_front_answer(case, d, tmp_path, origin, s3), DEADLINE_S))
        finally:
            _stop(procs)
    assert procs[0].returncode == 0, d["log"].read_text()[-2000:]


_PROBE = """
import asyncio, runpy, sys
from dragonfly2_tpu_torch.utils import proc

serve = proc.run_until_signalled

async def probed(ready_event=None, on_ready=None):
    await serve(ready_event, on_ready)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax", "flax", "dragonfly2_tpu"))
    print("LOADED " + ",".join(bad), flush=True)

proc.run_until_signalled = probed
sys.argv = ["daemon", *sys.argv[1:]]
runpy.run_module("dragonfly2_tpu_torch.daemon.server", run_name="__main__")
"""


def test_a_daemon_serving_the_whole_front_loads_no_torch(cluster, tmp_path):
    origin = cluster["origin"]
    procs: list[subprocess.Popen] = []
    # the mirror names the origin as localhost, so that the rule, not the
    # mirror, routes the absolute-form 127.0.0.1 URLs
    args = ("--proxy-port", "0", "--proxy-rule", r"\.bin$", "--registry-mirror", f"http://localhost:{origin.port}",
            "--hijack-ca-dir", "ca", "--hijack-host", "^localhost$", "--sni-proxy-port", "0",
            "--object-storage-port", "0")
    try:
        d = _daemon([sys.executable, "-c", _PROBE], tmp_path, "front-d", cluster["scheduler"], procs, args)

        async def drive():
            for case in ("proxy-rule", "registry-mirror", "hijack-ca-dir", "sni-proxy-port", "object-storage-port"):
                await _front_answer(case, d, tmp_path, origin, None)
            # a gateway read peer to peer: the engine pulls the file:// origin
            store = dfstore.Dfstore(f"http://127.0.0.1:{_listening(d, 'gateway')}")
            try:
                assert await store.get_object("front", "k.bin") == (tmp_path / "front-d-objects" / "front"
                                                                    / "k.bin").read_bytes()
            finally:
                await store.close()

        asyncio.run(asyncio.wait_for(drive(), DEADLINE_S))
        d["proc"].send_signal(signal.SIGTERM)
        out, _ = d["proc"].communicate(timeout=DEADLINE_S)
    finally:
        _stop(procs)
    assert d["proc"].returncode == 0, d["log"].read_text()[-2000:]
    assert out.strip() == "LOADED", out


def test_a_daemon_with_every_secure_and_observable_flag_loads_no_torch(cluster, tmp_path):
    """--data-tls-dir, --piece-cipher, --vsock-port, --metrics-port and a
    tracing: exporter at once: the daemon serves a download over the mTLS
    piece plane (to a second such daemon) and has loaded no torch."""
    from dragonfly2_tpu_torch.rpc.core import vsock_socket

    certs = _certs(tmp_path)
    (tmp_path / "tracing.yaml").write_text(f"tracing:\n  trace_file: {tmp_path / 'spans.jsonl'}\n")
    procs: list[subprocess.Popen] = []
    try:
        ds = []
        for name in ("tls-a", "tls-b"):
            with vsock_socket() as s:
                import socket as socketlib

                s.bind((socketlib.VMADDR_CID_ANY, socketlib.VMADDR_PORT_ANY))
                vport = s.getsockname()[1]
            ds.append(_daemon([sys.executable, "-c", _PROBE], tmp_path, name, cluster["scheduler"], procs,  # dflint: disable=DF026 one daemon process per loop turn
                              ("--data-tls-dir", str(certs), "--piece-cipher", "chacha20", "--vsock-port",
                               str(vport), "--metrics-port", "0", "--config", "tracing.yaml")))
        data = _payload(17, 9 << 20)
        url = cluster["origin"].add("secure.bin", data)
        for d, out in zip(ds, ("a.bin", "b.bin")):
            rc, _, err = cli(dfget.main, [url, "-O", str(tmp_path / out), "--sock", d["sock"], "--no-spawn"])
            assert rc == 0, err
            assert (tmp_path / out).read_bytes() == data
        done = re.search(r"task done: (\d+) piece\(s\) from parents \{.+\}, 0 byte\(s\) from source",
                         ds[1]["log"].read_text())
        assert done and int(done.group(1)) == 3, ds[1]["log"].read_text()[-2000:]
        outs = []
        for d in ds:
            d["proc"].send_signal(signal.SIGTERM)
            outs.append(d["proc"].communicate(timeout=DEADLINE_S)[0])
    finally:
        _stop(procs)
    assert [d["proc"].returncode for d in ds] == [0, 0]
    assert [o.strip() for o in outs] == ["LOADED", "LOADED"], outs
