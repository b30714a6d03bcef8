"""The port's hdfs:// and oras:// sources (dragonfly2_tpu_torch/daemon/
{hdfs,oras}_source.py), its scheme registry, and utils/unit.py, against the
reference's.

- The registry hands out each scheme's client: s3, oss, hdfs and oras beside
  http(s) and file.
- hdfs:// against the WebHDFS fake of ``tests/test_hdfs.py`` (namenode and a
  datanode redirect): info, ranged reads and listings equal to the
  reference client's; then a P2P pull through a port swarm, the second peer
  taking every piece from the first (the namenode's OPEN count unchanged).
- oras:// against ``tests/fakeregistry.py``: URL parsing and the auth
  challenge parse equal to the reference's; info, ranged reads and one token
  fetch; a missing artifact raises; then a P2P pull through a port swarm.
- ``parse_bytes`` and ``format_bytes`` equal to the reference's on a table.

Every async body runs under asyncio.wait_for with a 60 s bound.
"""

import asyncio
import hashlib

import numpy as np
import pytest
import torch

from fakeregistry import FakeRegistry
from test_hdfs import FakeWebHDFS

from dragonfly2_tpu.daemon import hdfs_source as ref_hdfs
from dragonfly2_tpu.daemon import oras_source as ref_oras
from dragonfly2_tpu.utils import unit as ref_unit
from dragonfly2_tpu_torch.daemon import hdfs_source as port_hdfs
from dragonfly2_tpu_torch.daemon import metrics as port_metrics
from dragonfly2_tpu_torch.daemon import oras_source as port_oras
from dragonfly2_tpu_torch.daemon import source as port_source
from dragonfly2_tpu_torch.daemon.conductor import ConductorConfig
from dragonfly2_tpu_torch.daemon.engine import InProcessSchedulerClient, PeerEngine
from dragonfly2_tpu_torch.scheduler.service import SchedulerService
from dragonfly2_tpu_torch.utils import unit as port_unit
from dragonfly2_tpu_torch.utils.pieces import Range

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

BOUND_S = 60.0
PAYLOAD = np.random.default_rng(17).integers(0, 256, 9 << 20, dtype=np.uint8).tobytes()  # 3 pieces


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


@pytest.mark.parametrize("url,cls", [
    ("s3://bucket/key", port_source.S3SourceClient),
    ("oss://bucket/key", port_source.OSSSourceClient),
    ("hdfs://namenode:9870/path", port_hdfs.HDFSSourceClient),
    ("oras://registry.local/repo:tag", port_oras.ORASSourceClient),
    ("https://origin.local/f", port_source.HTTPSourceClient),
    ("/local/file", port_source.FileSourceClient),
], ids=["s3", "oss", "hdfs", "oras", "https", "file"])
def test_the_registry_returns_each_schemes_client(url, cls):
    reg = port_source.SourceRegistry()
    try:
        client = reg.client_for(url)
        assert type(client) is cls
        if url.split(":")[0] in ("s3", "oss", "hdfs", "oras"):
            assert client.scheme == url.split(":")[0]
    finally:
        bounded(reg.close())


async def _p2p_pull(tmp_path, url: str) -> tuple[list[str], float]:
    """Peer A fetches ``url`` from its origin, then peer B from peer A: the
    sha256 of both copies and B's pieces taken from parents."""
    sched = InProcessSchedulerClient(SchedulerService())
    cfg = ConductorConfig(metadata_poll_interval=0.02, piece_timeout=10.0)
    a = PeerEngine(storage_root=tmp_path / "a", scheduler=sched, hostname="pa", conductor_config=cfg)
    b = PeerEngine(storage_root=tmp_path / "b", scheduler=sched, hostname="pb", conductor_config=cfg)
    await a.start()
    await b.start()
    try:
        ts_a = await a.download_task(url)
        before = port_metrics.PIECE_DOWNLOAD_TOTAL.labels(source="parent").value
        ts_b = await b.download_task(url)
        parents = port_metrics.PIECE_DOWNLOAD_TOTAL.labels(source="parent").value - before
        shas = [hashlib.sha256(ts.data_path.read_bytes()).hexdigest() for ts in (ts_a, ts_b)]
        assert ts_a.pins == 0 and ts_b.pins == 0
        return shas, parents
    finally:
        await a.stop()
        await b.stop()


# ---------------------------------------------------------------------------
# hdfs://


async def _hdfs_answers(mod, nn) -> dict:
    c = mod.HDFSSourceClient()
    base = f"hdfs://127.0.0.1:{nn.port}"
    out = {}
    try:
        info = await c.info(f"{base}/models/weights.bin")
        out["info"] = (info.content_length, info.supports_range, info.last_modified)
        out["whole"] = hashlib.sha256(b"".join([ch async for ch in c.download(f"{base}/models/weights.bin")])).hexdigest()
        out["part"] = b"".join([ch async for ch in c.download(f"{base}/models/weights.bin", rng=Range(500, 1000))])
        out["open"] = dict(nn.open_requests[-1])
        out["list"] = sorted((e.name, e.is_dir, e.url) for e in await c.list_entries(f"{base}/models"))
        for name, url in (("dir", f"{base}/models"), ("missing", f"{base}/nope.bin")):
            try:
                await c.info(url)
                out[name] = "no error"
            except Exception as e:
                out[name] = (type(e).__name__, str(e))
    finally:
        await c.close()
    return out


def test_hdfs_answers_equal_the_references(monkeypatch):
    monkeypatch.setenv("DF_HDFS_USER", "dragonfly")
    files = {"/models/weights.bin": PAYLOAD[:100_000], "/models/sub/extra.bin": b"x" * 10,
             "/models/odd?name.bin": b"qq"}

    async def body():
        async with FakeWebHDFS(files) as nn:
            return {mod: await _hdfs_answers(mod, nn) for mod in (ref_hdfs, port_hdfs)}

    got = bounded(body())
    assert got[port_hdfs] == got[ref_hdfs]
    port = got[port_hdfs]
    assert port["info"][:2] == (100_000, True) and port["part"] == PAYLOAD[500:1500]
    assert port["open"]["offset"] == "500" and port["open"]["user.name"] == "dragonfly"
    assert ("odd?name.bin", False) in [e[:2] for e in port["list"]]
    assert "directory" in port["dir"][1] and "not found" in port["missing"][1]


def test_an_hdfs_file_is_pulled_peer_to_peer(tmp_path):
    async def body():
        async with FakeWebHDFS({"/ckpt/model.bin": PAYLOAD}) as nn:
            url = f"hdfs://127.0.0.1:{nn.port}/ckpt/model.bin"
            shas, parents = await _p2p_pull(tmp_path, url)
            opens = len(nn.open_requests)
            return shas, parents, opens

    shas, parents, opens = bounded(body())
    assert shas == [hashlib.sha256(PAYLOAD).hexdigest()] * 2
    assert parents == 3 and opens == 3  # A read three pieces from the datanode, B none


# ---------------------------------------------------------------------------
# oras://


@pytest.mark.parametrize("url", ["oras://reg.io/repo:v1", "oras://reg.io:5000/org/app/model:latest",
                                 "oras://reg.io/repo", "oras://reg.io", "oras://reg.io/repo:", "oras:///x:y"])
def test_oras_url_parsing_equals_the_references(url):
    def parse(mod):
        try:
            return mod.ORASSourceClient.parse(url)
        except mod.SourceError as e:
            return ("error", str(e))

    assert parse(port_oras) == parse(ref_oras)


def test_oras_auth_challenge_parse_equals_the_references():
    for challenge in ('realm="https://auth.docker.io/token",service="registry.docker.io",'
                      'scope="repository:a/b:pull,push"', 'realm=http://r/t, error="insufficient_scope"', ""):
        assert port_oras.parse_auth_challenge(challenge) == ref_oras.parse_auth_challenge(challenge)


def test_oras_info_ranged_reads_and_one_token(monkeypatch):
    monkeypatch.setenv("DF_ORAS_PLAIN_HTTP", "127.0.0.1")

    async def body():
        reg = FakeRegistry()
        digest = reg.push("org/model", "v1", PAYLOAD[:200_000])
        await reg.start()
        c = port_oras.ORASSourceClient()
        try:
            url = f"oras://127.0.0.1:{reg.port}/org/model:v1"
            info = await c.info(url)
            whole = b"".join([ch async for ch in c.download(url)])
            part = b"".join([ch async for ch in c.download(url, rng=Range(1000, 4096))])
            tokens = reg.token_fetches
            with pytest.raises(port_source.SourceError, match="404"):
                await c.info(f"oras://127.0.0.1:{reg.port}/no/such:v9")
            return (info.content_length, info.supports_range, info.etag), whole, part, tokens, digest
        finally:
            await c.close()
            await reg.stop()

    info, whole, part, tokens, digest = bounded(body())
    assert info == (200_000, True, digest)
    assert whole == PAYLOAD[:200_000] and part == PAYLOAD[1000:5096]
    assert tokens == 1  # one token covered every request (cached per host and repo)


def test_an_oras_artifact_is_pulled_peer_to_peer(tmp_path, monkeypatch):
    monkeypatch.setenv("DF_ORAS_PLAIN_HTTP", "127.0.0.1")

    async def body():
        reg = FakeRegistry()
        reg.push("org/weights", "r4", PAYLOAD)
        await reg.start()
        try:
            return await _p2p_pull(tmp_path, f"oras://127.0.0.1:{reg.port}/org/weights:r4")
        finally:
            await reg.stop()

    shas, parents = bounded(body())
    assert shas == [hashlib.sha256(PAYLOAD).hexdigest()] * 2
    assert parents == 3


# ---------------------------------------------------------------------------
# utils/unit.py


@pytest.mark.parametrize("value", ["0", "512", "4K", "4KiB", "1.5M", "2 GB", "3Ti", " 7 mib ", 1024, 2.5,
                                   "", "12X", "-1K", "K"])
def test_byte_units_equal_the_references(value):
    def answer(mod):
        try:
            n = mod.parse_bytes(value)
            return n, mod.format_bytes(n)
        except ValueError as e:
            return ("error", str(e))

    assert answer(port_unit) == answer(ref_unit)
