"""The port's daemon data plane (dragonfly2_tpu_torch/daemon/, tpuvm/checkpoint.py)
against the reference's, in one interpreter.

- Storage: the same writes give the same data bytes and the same
  metadata.json bytes; the same seeded store gives the same reclaim
  decisions under the TTL, capacity and disk-watermark triggers, pinned tasks
  immune; a store written by either package is recovered by the other.
- Pipeline and shaper: HashPump's digests equal hashlib's at seeded sizes and
  chunkings; the traffic shaper's allocations are equal on seeded flows.
- An in-process swarm: three PeerEngines over InProcessSchedulerClient and a
  local aiohttp origin, once per package: the same bytes, the origin's bytes
  served once, and the same pieces by source, with deferred store writes
  forced on and off; one case schedules through the port's MLEvaluator with a
  GNNScorer on the CPU.
- The wire across packages: a port child fetches its pieces from a reference
  parent's upload server and the reverse.
- The conductor's round workers end with a cancelled conductor (the
  reference's outlive it).
- The checkpoint fan-out: a traversing manifest entry is refused, an
  already-staged file is skipped.

Every async body runs under asyncio.wait_for with a 60 s bound.
"""

import asyncio
import hashlib
import json
import random
import shutil
import threading
import time
from dataclasses import dataclass

import numpy as np
import pytest
import torch

from refdrain import reference_drain_as_the_ports  # noqa: F401 - a fixture, used by name
from test_e2e import Origin

from dragonfly2_tpu.daemon import conductor as ref_conductor
from dragonfly2_tpu.daemon import engine as ref_engine
from dragonfly2_tpu.daemon import metrics as ref_metrics
from dragonfly2_tpu.daemon import pipeline as ref_pipeline
from dragonfly2_tpu.daemon import storage as ref_storage
from dragonfly2_tpu.daemon import traffic_shaper as ref_shaper
from dragonfly2_tpu.scheduler import service as ref_service
from dragonfly2_tpu_torch.daemon import conductor as port_conductor
from dragonfly2_tpu_torch.daemon import engine as port_engine
from dragonfly2_tpu_torch.daemon import metrics as port_metrics
from dragonfly2_tpu_torch.daemon import pipeline as port_pipeline
from dragonfly2_tpu_torch.daemon import storage as port_storage
from dragonfly2_tpu_torch.daemon import traffic_shaper as port_shaper
from dragonfly2_tpu_torch.scheduler import metrics as port_sched_metrics
from dragonfly2_tpu_torch.scheduler.evaluator import FALLBACK_REASONS
from dragonfly2_tpu_torch.scheduler import service as port_service
from dragonfly2_tpu_torch.tpuvm import checkpoint as port_checkpoint

# One intra-op thread: the suite runs six xdist workers on the host's cores
# beside JAX's thread pools (see tests/test_torch_evaluator.py).
torch.set_num_threads(1)

BOUND_S = 60.0
FIXED_NOW = 1_760_000_000.0


def bounded(coro):
    return asyncio.run(asyncio.wait_for(coro, BOUND_S))


pytestmark = pytest.mark.usefixtures("reference_drain_as_the_ports")


@dataclass(frozen=True)
class Pkg:
    name: str
    storage: object
    engine: object
    conductor: object
    service: object
    metrics: object


REF = Pkg("ref", ref_storage, ref_engine, ref_conductor, ref_service, ref_metrics)
PORT = Pkg("port", port_storage, port_engine, port_conductor, port_service, port_metrics)
BOTH = (REF, PORT)


# ---------------------------------------------------------------------------
# storage


def _piece_bytes(rng: np.random.Generator, n: int) -> bytes:
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


async def _write_task(pkg: Pkg, root, seed: int) -> None:
    """One seeded sequence of storage writes: a multi-piece task written out
    of order through both write paths, completed, and a partial one."""
    rng = np.random.default_rng(seed)
    sm = pkg.storage.StorageManager(root)
    length = 3 * 4096 + 1000
    # created_at's default factory is bound at import: pass it
    ts = sm.register_task("a" * 64, url="http://origin.example/a", tag="t", application="app",
                          created_at=FIXED_NOW)
    ts.set_task_info(content_length=length, piece_size=4096, total_pieces=4, digest="")
    pieces = [_piece_bytes(rng, 4096) for _ in range(3)] + [_piece_bytes(rng, 1000)]
    for idx in rng.permutation(4):
        data = pieces[idx]
        if idx % 2:
            await ts.write_piece(int(idx), data, expected_digest=hashlib.sha256(data).hexdigest())
        else:
            await ts.write_piece_view(int(idx), memoryview(bytearray(data)),
                                      digest=hashlib.sha256(data).hexdigest())
    ts.mark_done()
    part = sm.register_task("b" * 64, url="http://origin.example/b", created_at=FIXED_NOW)
    part.set_task_info(content_length=2 * 4096, piece_size=4096, total_pieces=2)
    await part.write_piece(1, _piece_bytes(rng, 4096))
    sm.flush_all()


def _tree(root) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_storage_writes_give_the_reference_bytes_and_metadata(tmp_path, monkeypatch):
    monkeypatch.setattr(time, "time", lambda: FIXED_NOW)
    trees = {}
    for pkg in BOTH:
        bounded(_write_task(pkg, tmp_path / pkg.name, seed=3))
        trees[pkg.name] = _tree(tmp_path / pkg.name)
    assert sorted(trees["port"]) == sorted(trees["ref"])
    assert "a" * 64 + "/metadata.json" in trees["port"]
    for name, blob in trees["ref"].items():
        assert trees["port"][name] == blob, name


def _seeded_store(pkg: Pkg, root, seed: int):
    """Twelve tasks with seeded sizes, ages, completion and pins."""
    rng = random.Random(seed)
    sm = pkg.storage.StorageManager(root)
    for i in range(12):
        size = rng.randrange(1, 64) * 1024
        ts = sm.register_task(f"{i:02d}" + "f" * 62, url=f"http://origin.example/{i}")
        ts.set_task_info(content_length=size, piece_size=size, total_pieces=1)
        ts.meta.updated_at = FIXED_NOW - rng.uniform(0, 7200)
        ts.last_access = ts.meta.updated_at + rng.choice((0.0, rng.uniform(0, 3600)))
        if rng.random() < 0.75:
            ts._bitset.set(0)
            ts.meta.done = True
        if rng.random() < 0.25:
            ts.pin()
    return sm


@pytest.mark.parametrize("trigger", ["ttl", "capacity", "disk"])
def test_reclaim_decisions_equal_the_reference(tmp_path, monkeypatch, trigger):
    monkeypatch.setattr(time, "time", lambda: FIXED_NOW)
    kw = {"ttl": {"ttl": 3600.0},
          "capacity": {"ttl": 1e9, "capacity_bytes": 200 * 1024},
          "disk": {"ttl": 1e9, "disk_high_ratio": 0.9}}[trigger]
    # a disk 300 KiB past its 90% watermark
    usage = type(shutil.disk_usage("/"))
    used = int(0.9 * (1 << 30)) + 300 * 1024
    monkeypatch.setattr(shutil, "disk_usage", lambda _p: usage(1 << 30, used, (1 << 30) - used))
    kept, removed = {}, {}
    for pkg in BOTH:
        sm = _seeded_store(pkg, tmp_path / pkg.name, seed=11)
        removed[pkg.name] = sm.reclaim(**kw)
        kept[pkg.name] = sorted(ts.meta.task_id for ts in sm.tasks())
        pinned = [ts for ts in sm.tasks() if ts.pins]
        assert pinned, "the seeded store pins some tasks"
    assert removed["port"] == removed["ref"]
    assert kept["port"] == kept["ref"]
    assert sum(removed["port"].values()) > 0 and len(kept["port"]) < 12


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)], ids=["ref-to-port", "port-to-ref"])
def test_a_store_written_by_one_package_is_recovered_by_the_other(tmp_path, writer, reader):
    root = tmp_path / "store"
    bounded(_write_task(writer, root, seed=5))
    # a torn piece: the partial task's one claimed piece no longer matches
    torn = root / ("b" * 64) / "data"
    with open(torn, "r+b") as f:
        f.seek(4096)
        f.write(b"\x00" * 16)
    got = {}
    for pkg in (writer, reader):
        # each recovery on its own copy: the audit rewrites the metadata
        copy = shutil.copytree(root, tmp_path / f"recovered-by-{pkg.name}")
        sm = pkg.storage.StorageManager(copy)
        got[pkg.name] = sorted((ts.meta.task_id, kept, list(dropped)) for ts, kept, dropped in sm.recover())
        done = sm.get("a" * 64)
        assert done.meta.done and done.is_complete()
    assert got[reader.name] == got[writer.name]
    assert (("b" * 64), 0, [1]) in got[reader.name]


# ---------------------------------------------------------------------------
# pipeline and shaper


@pytest.mark.parametrize("size,chunk", [(1000, 1000), (600 * 1024, 37_013), (4 << 20, 65536)])
def test_hash_pump_digests_equal_hashlib(size, chunk):
    payload = np.random.default_rng(size).integers(0, 256, size, dtype=np.uint8).tobytes()

    async def body(pkg) -> str:
        pipeline = pkg.PiecePipeline(hash_chunk_bytes=64 << 10, inline_hash_bytes=4096)
        try:
            view = memoryview(bytearray(size))
            pump = pipeline.hash_pump(view)
            off = 0
            while off < size:
                n = min(chunk, size - off)
                view[off:off + n] = payload[off:off + n]
                off += n
                pump.feed(off)
            return await pump.finish()
        finally:
            pipeline.close()

    want = hashlib.sha256(payload).hexdigest()
    assert bounded(body(port_pipeline)) == want
    assert bounded(body(ref_pipeline)) == want


def _shaper_run(mod, seed: int) -> list[dict]:
    rng = random.Random(seed)
    sh = mod.SamplingTrafficShaper(total_rate_bps=1e6, per_flow_cap_bps=6e5, min_flow_rate_bps=2e4,
                                   interval_s=0.1)
    flows = [sh.open_flow(f"f{i}", weight=rng.choice((0.5, 1.0, 3.0))) for i in range(5)]
    out = []
    for tick in range(6):
        now = 1000.0 + tick  # the sampler's clock, fixed: elapsed time scales the rates
        for f in flows:
            f.created_at = 0.0  # past the newcomer grace
            f.window_bytes = rng.uniform(0, 2e5)
            f.blocked_in_window = rng.random() < 0.5
        if tick == 3:
            flows.pop(rng.randrange(len(flows))).close()
        sh._last_sample = now - 0.2
        assert sh.maybe_resample(now=now)
        out.append(sh.allocations())
    return out


@pytest.mark.parametrize("seed", [1, 2])
def test_traffic_shaper_allocations_equal_the_reference(seed):
    assert _shaper_run(port_shaper, seed) == _shaper_run(ref_shaper, seed)


# ---------------------------------------------------------------------------
# the in-process swarm


def _pieces_by_source(pkg: Pkg) -> dict:
    return {s: pkg.metrics.PIECE_DOWNLOAD_TOTAL.labels(source=s).value for s in ("parent", "back_to_source")}


def _engine(pkg: Pkg, tmp_path, client, name: str, defer: bool):
    cfg = pkg.conductor.ConductorConfig(metadata_poll_interval=0.02, piece_timeout=10.0,
                                        defer_piece_writes=defer)
    return pkg.engine.PeerEngine(storage_root=tmp_path / pkg.name / name, scheduler=client, hostname=name,
                                 conductor_config=cfg)


def _ml_scorer(host_ids: list[str]):
    """A GNNScorer on the CPU over a small graph whose node index names the
    engines' hosts (every other node is padding)."""
    from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
    from dragonfly2_tpu_torch.trainer.synthetic import make_cluster

    cluster = make_cluster(num_nodes=16, num_neighbors=4, seed=3)
    model = TopoScorer(hidden=16, embed_dim=8, num_layers=2, head_hidden=16)
    scorer = GNNScorer(model, params_from_flax(init_flax_like(model, seed=0)), device="cpu")
    scorer.refresh(cluster.graph)
    return scorer, {h: i for i, h in enumerate(host_ids)}


async def _swarm(pkg: Pkg, tmp_path, payload: bytes, defer: bool, ml: bool) -> dict:
    ev = None
    if ml:
        from dragonfly2_tpu_torch.scheduler.evaluator import MLEvaluator

        ev = MLEvaluator()
    svc = pkg.service.SchedulerService(evaluator=ev, decision_sample_rate=1.0) if ev is not None \
        else pkg.service.SchedulerService()
    client = pkg.engine.InProcessSchedulerClient(svc)
    before = _pieces_by_source(pkg)
    async with Origin({"f.bin": payload}) as origin:
        url = origin.url("f.bin")
        engines = [_engine(pkg, tmp_path, client, f"peer{i}", defer) for i in range(3)]
        for e in engines:
            await e.start()
        try:
            if ev is not None:
                scorer, index = _ml_scorer([e.host_id for e in engines])
                ev.attach_scorer(scorer, index, version="cpu-test")
            outs = [tmp_path / pkg.name / f"out{i}" for i in range(3)]
            await engines[0].download_task(url, output=outs[0])
            await asyncio.gather(*(e.download_task(url, output=o) for e, o in zip(engines[1:], outs[1:])))
            got = {
                "sha": [hashlib.sha256(o.read_bytes()).hexdigest() for o in outs],
                "origin_bytes": origin.bytes_sent,
                "served": sum(e.upload.bytes_served for e in engines),
            }
        finally:
            for e in engines:
                await e.stop()
    after = _pieces_by_source(pkg)
    got["pieces"] = {s: after[s] - before[s] for s in after}
    if ev is not None:
        answer = svc.decision_records(limit=1000)
        got["records"] = [r["serving_mode"] for r in answer["records"]]
        got["fallbacks"] = answer["fallbacks"]
    return got


@pytest.mark.parametrize("defer,ml", [(True, False), (False, False), (None, True)],
                         ids=["deferred-writes", "inline-writes", "ml-evaluator-cpu"])
def test_in_process_swarm_equals_the_reference(tmp_path, defer, ml):
    payload = np.random.default_rng(9).integers(0, 256, 10 << 20, dtype=np.uint8).tobytes()
    want = hashlib.sha256(payload).hexdigest()
    fallbacks0 = port_sched_metrics.ML_BASE_FALLBACK_TOTAL.value
    port = bounded(_swarm(PORT, tmp_path, payload, defer, ml))
    ref = bounded(_swarm(REF, tmp_path, payload, defer, False))
    for got in (port, ref):
        assert got["sha"] == [want] * 3
        assert got["origin_bytes"] == len(payload)
    assert port["pieces"] == ref["pieces"] == {"parent": 6.0, "back_to_source": 3.0}
    assert port["served"] == ref["served"] == 2 * len(payload)
    if ml:
        # the later peers' rounds scored on the CPU model, none fell back
        assert port["records"] and set(port["records"]) == {"torch"}
        assert port_sched_metrics.ML_BASE_FALLBACK_TOTAL.value == fallbacks0
        # the answer's fallbacks are the process's counters by reason
        assert port["fallbacks"] == {r: port_sched_metrics.ML_BASE_FALLBACK_TOTAL.labels(reason=r).value
                                     for r in FALLBACK_REASONS}


@pytest.mark.parametrize("parent_pkg,child_pkg", [(REF, PORT), (PORT, REF)],
                         ids=["port-child-of-ref-upload", "ref-child-of-port-upload"])
def test_pieces_cross_the_packages_upload_servers(tmp_path, parent_pkg, child_pkg):
    """One port SchedulerService; the parent engine of one package seeds the
    task from the origin, the child engine of the other fetches every piece
    from the parent's upload server."""
    payload = np.random.default_rng(4).integers(0, 256, 10 << 20, dtype=np.uint8).tobytes()

    async def body() -> None:
        svc = port_service.SchedulerService()
        async with Origin({"f.bin": payload}) as origin:
            url = origin.url("f.bin")
            parent = _engine(parent_pkg, tmp_path, parent_pkg.engine.InProcessSchedulerClient(svc), "parent", None)
            child = _engine(child_pkg, tmp_path, child_pkg.engine.InProcessSchedulerClient(svc), "child", None)
            await parent.start()
            await child.start()
            try:
                await parent.download_task(url)
                sent = origin.bytes_sent
                out = tmp_path / "child.bin"
                await child.download_task(url, output=out)
                assert out.read_bytes() == payload
                assert origin.bytes_sent == sent == len(payload)
                assert parent.upload.bytes_served == len(payload)
            finally:
                await parent.stop()
                await child.stop()

    bounded(body())


# ---------------------------------------------------------------------------
# the conductor under cancellation


def _alive_workers() -> list[str]:
    return [t.get_coro().__qualname__ for t in asyncio.all_tasks()
            if t.get_coro().__qualname__ == "PeerTaskConductor._piece_worker"]


async def _cancel_mid_round(pkg: Pkg, fl, tmp_path) -> tuple[list[str], int, int]:
    """A child conductor with deferred writes, slowed store writes and a
    faulting parent, cancelled while a deferred write is pending: its round
    workers still alive a moment later, and its landed pieces then and 0.3 s
    later."""
    from dragonfly2_tpu_torch.scheduler.service import HostInfo

    payload = bytes(range(256)) * (40 * 1024 * 4)  # 40 MiB: ten pieces
    svc = pkg.service.SchedulerService()
    client = pkg.engine.InProcessSchedulerClient(svc)
    src = __import__(f"{pkg.engine.__name__.rsplit('.', 2)[0]}.daemon.source", fromlist=["SourceRegistry"])
    async with Origin({"f.bin": payload}) as origin:
        url = origin.url("f.bin")
        parent = _engine(pkg, tmp_path, client, "parent", None)
        await parent.start()
        try:
            await parent.download_task(url)
            cfg = pkg.conductor.ConductorConfig(metadata_poll_interval=0.02, piece_timeout=10.0,
                                                defer_piece_writes=True, piece_workers=2)
            c = pkg.conductor.PeerTaskConductor(
                peer_id="child-peer", meta=parent.make_meta(url),
                host=HostInfo(id="child-host", ip="127.0.0.1", hostname="child"),
                scheduler=client, storage=pkg.storage.StorageManager(tmp_path / pkg.name / "child"),
                sources=src.SourceRegistry(), config=cfg)
            fl.enable("storage.write:latency:1.0:0.5,parent.fetch:error:0.3,seed=3")
            try:
                task = asyncio.ensure_future(c.run())
                while not c._pending_writes:
                    await asyncio.sleep(0.001)
                task.cancel()
                with pytest.raises(asyncio.CancelledError):
                    await task
                await asyncio.sleep(0.05)
                alive, landed = _alive_workers(), c.ts.finished_count()
                await asyncio.sleep(0.3)
                return alive, landed, c.ts.finished_count()
            finally:
                fl.disable()
        finally:
            await parent.stop()


def test_a_cancelled_conductor_leaves_no_round_worker_running(tmp_path):
    """Cancelling a conductor mid-round ends its piece workers with it: none
    is alive after the cancellation, and no piece lands after it. The
    reference's workers outlive its conductor (they go on fetching and
    writing, ROADMAP.md §3); this test fails on that copy."""
    from dragonfly2_tpu_torch.resilience import faultline

    alive, landed, later = bounded(_cancel_mid_round(PORT, faultline, tmp_path))
    assert alive == []
    assert later == landed


def _drain_after_a_landed_write(conductor_mod, storage_mod, tmp_path) -> dict:
    """A conductor whose one deferred write finished in the loop step before
    ``_drain_writes`` runs: the write is done, and its done callback, which
    takes it out of the pending set, is scheduled but has not run. The drain
    runs on a thread of its own; the outcome says whether it returned."""
    from dragonfly2_tpu_torch.scheduler.service import HostInfo, TaskMeta

    c = conductor_mod.PeerTaskConductor(
        peer_id="peer", meta=TaskMeta(task_id="d" * 64, url="http://origin.example/d"),
        host=HostInfo(id="host", ip="127.0.0.1", hostname="host"), scheduler=None,
        storage=storage_mod.StorageManager(tmp_path), sources=None)
    out: dict = {}

    async def scenario() -> None:
        async def write() -> bool:
            return True

        t = asyncio.ensure_future(write())
        c._pending_writes.add(t)
        t.add_done_callback(c._pending_writes.discard)
        await asyncio.sleep(0)  # the write runs to its end in this step
        out["landed_and_pending"] = t.done() and t in c._pending_writes
        await c._drain_writes()
        out["returned"] = True

    th = threading.Thread(target=asyncio.run, args=(scenario(),), daemon=True)
    th.start()
    th.join(10)
    return out


def test_draining_a_landed_write_returns(tmp_path):
    """The drain returns. On the reference's copy it spins at 100% CPU and
    holds the loop, so no timeout fires (a gather over finished tasks
    completes without yielding on Python 3.12+): the pre-port tier-1 hangs
    in daemon/conductor.py's ``_drain_writes`` (ROADMAP.md §3)."""
    out = _drain_after_a_landed_write(port_conductor, port_storage, tmp_path)
    assert out == {"landed_and_pending": True, "returned": True}


# ---------------------------------------------------------------------------
# the checkpoint fan-out


def test_checkpoint_fetch_refuses_a_traversing_entry(tmp_path):
    m = port_checkpoint.Manifest(name="evil", created_at=0.0, files=[
        port_checkpoint.ManifestEntry(path="../../escape.bin", size=4, digest="sha256:" + "0" * 64,
                                      task_id="t" * 64)])
    with pytest.raises(ValueError, match="escapes destination"):
        bounded(port_checkpoint.fetch_checkpoint(None, m, tmp_path / "dest"))
    assert not (tmp_path / "escape.bin").exists()


def test_checkpoint_fetch_skips_an_already_staged_file(tmp_path):
    """A file already in the destination with the manifest's size and digest
    is not downloaded again (the engine is never asked)."""
    data = b"staged bytes" * 100
    dest = tmp_path / "dest"
    dest.mkdir()
    (dest / "w.safetensors").write_bytes(data)
    entry = port_checkpoint.ManifestEntry(path="w.safetensors", size=len(data),
                                          digest="sha256:" + hashlib.sha256(data).hexdigest(), task_id="c" * 64)
    m = port_checkpoint.Manifest(name="m", created_at=1.0, files=[entry])

    class NoEngine:
        async def download_task(self, *a, **kw):
            raise AssertionError("an already-staged file was downloaded")

    bounded(port_checkpoint.fetch_checkpoint(NoEngine(), m, dest))
    assert json.loads((dest / port_checkpoint.MANIFEST_NAME).read_text())["files"][0]["task_id"] == "c" * 64
