"""Multi-process initialization and data feeding, on torch.distributed.

The port of dragonfly2_tpu/parallel/distributed.py. In the port one
process is one device:

  ``local_device_count > 0`` — the process is one CPU device and the
      group runs over gloo: the CI mode, which the JAX field selects with
      virtual CPU devices. The JAX package can give a process several
      virtual devices; here a count above 1 is refused.
  ``local_device_count == 0`` — the process is the card
      ``cuda:{process_id % torch.cuda.device_count()}`` and the group runs
      over NCCL. NCCL puts no two ranks on one card, so one card is a world
      of one.

  initialize()          — ``init_process_group`` from DF_DIST_* (or a
                          config), for a world of one too: the mesh needs a
                          group. The JAX ``_force_cpu_devices`` has no
                          counterpart: torch has no virtual devices to force.
  process_local_batch() — a global DTensor from this rank's rows.
  launch_localhost()    — an n-process cluster on 127.0.0.1 under one
                          wall-clock deadline, for tests and dry runs.
"""

from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Sequence

import numpy as np
import torch

from dragonfly2_tpu_torch.parallel import mesh as meshlib

_ENV_COORD = "DF_DIST_COORDINATOR"
_ENV_NPROCS = "DF_DIST_NUM_PROCESSES"
_ENV_PROC_ID = "DF_DIST_PROCESS_ID"
_ENV_LOCAL_DEVICES = "DF_DIST_LOCAL_DEVICES"

# torch's own default is 30 minutes: a hung collective would hold a job (or
# a test run) that long. A collective of this trainer never waits a minute.
DEFAULT_TIMEOUT_S = 60.0

_PACKAGE_ROOT = str(Path(__file__).resolve().parents[2])


@dataclass
class DistributedConfig:
    """One process's view of the cluster."""

    coordinator_address: str = ""
    num_processes: int = 1
    process_id: int = 0
    # >0 → this process is one CPU device, collectives over gloo (CI mode);
    # 0 → this process is one card, collectives over NCCL.
    local_device_count: int = 0

    @classmethod
    def from_env(cls) -> "DistributedConfig":
        return cls(
            coordinator_address=os.environ.get(_ENV_COORD, ""),
            num_processes=int(os.environ.get(_ENV_NPROCS, "1")),
            process_id=int(os.environ.get(_ENV_PROC_ID, "0")),
            local_device_count=int(os.environ.get(_ENV_LOCAL_DEVICES, "0")),
        )

    def env(self) -> dict[str, str]:
        return {
            _ENV_COORD: self.coordinator_address,
            _ENV_NPROCS: str(self.num_processes),
            _ENV_PROC_ID: str(self.process_id),
            _ENV_LOCAL_DEVICES: str(self.local_device_count),
        }

    @property
    def backend(self) -> str:
        return "gloo" if self.local_device_count > 0 else "nccl"

    def device(self) -> torch.device:
        """This process's one device; raises when it names a card and none
        is present, or more than one CPU device."""
        if self.local_device_count > 1:
            raise ValueError(
                f"local_device_count={self.local_device_count}: a process of the port is one device"
            )
        if self.local_device_count == 1:
            return torch.device("cpu")
        if not torch.cuda.is_available():
            raise RuntimeError("DF_DIST_LOCAL_DEVICES=0 selects the card, and no CUDA device is present")
        return torch.device("cuda", self.process_id % torch.cuda.device_count())


def initialize(cfg: DistributedConfig | None = None, *, timeout: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group (gloo on the CPU, NCCL on the card) and
    return this process's device, which becomes the current CUDA device.
    ``timeout`` (seconds) bounds every collective. A world of one with no
    coordinator takes a free localhost port."""
    import torch.distributed as dist

    cfg = cfg or DistributedConfig.from_env()
    dev = cfg.device()
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    coord = cfg.coordinator_address
    if not coord:
        if cfg.num_processes > 1:
            raise ValueError(f"{_ENV_COORD} is needed for {cfg.num_processes} processes")
        coord = f"127.0.0.1:{free_port()}"
    dist.init_process_group(
        cfg.backend, init_method=f"tcp://{coord}", rank=cfg.process_id,
        world_size=cfg.num_processes, timeout=datetime.timedelta(seconds=timeout),
    )
    return dev


def shutdown() -> None:
    """Destroy the process group, if one is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def process_local_batch(mesh, local_rows: Any, global_shape: Sequence[int]):
    """A global DTensor of ``global_shape`` from this rank's rows
    (``local_row_slice``; host arrays, or tensors on any device), which are
    moved onto the mesh's device and placed by ``batch_placements`` (rows
    over "data")."""
    from torch.distributed.tensor import DTensor

    t = local_rows if isinstance(local_rows, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(local_rows))
    t = t.to(meshlib.mesh_device(mesh)).contiguous()
    shape = torch.Size(global_shape)
    return DTensor.from_local(
        t, mesh, meshlib.batch_placements(mesh), run_check=False,
        shape=shape, stride=meshlib.contiguous_stride(shape),
    )


def data_row_slice(global_rows: int, dp: int, data_index: int) -> tuple[int, int]:
    """[start, stop) of the rows that data coordinate ``data_index`` of
    ``dp`` holds (equal split)."""
    if global_rows % dp:
        raise ValueError(f"global batch {global_rows} not divisible by {dp} data shards")
    per = global_rows // dp
    return data_index * per, (data_index + 1) * per


def local_row_slice(global_rows: int, mesh) -> tuple[int, int]:
    """[start, stop) of the rows this rank holds: by its coordinate on
    "data", not by its rank (ranks that share a data coordinate hold the
    same rows; in JAX a process's devices are contiguous, so its index
    serves)."""
    dp, _ = meshlib.axis_sizes(mesh)
    return data_row_slice(global_rows, dp, mesh.get_coordinate()[0])


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_localhost(
    num_processes: int,
    module: str,
    *,
    local_devices: int = 0,
    extra_env: dict[str, str] | None = None,
    timeout: float = 600.0,
) -> list[subprocess.CompletedProcess]:
    """Run ``python -m <module>`` as an n-process localhost cluster.

    Each process gets the DF_DIST_* env (coordinator on a free port,
    ``local_devices`` as DF_DIST_LOCAL_DEVICES: 0, the default, puts each
    rank on a card over NCCL, and a rank raises when there is none; 1 puts
    each on one CPU device over gloo), one torch thread
    (OMP_NUM_THREADS=1) and this package's root on PYTHONPATH, after
    ``extra_env``'s, which is also how a worker takes its input. Returns the completed processes in process-id order;
    raises if any exits non-zero.

    ``timeout`` is ONE wall-clock deadline for the whole cluster. When it
    passes, or as soon as one process fails (the others would wait on its
    collectives), every process still running is killed and the call
    raises.
    """
    deadline = time.monotonic() + timeout
    coord = f"127.0.0.1:{free_port()}"
    procs: list[subprocess.Popen] = []
    failed: list[str] = []
    with tempfile.TemporaryDirectory(prefix="df-launch-") as logs:
        outs = []
        try:
            for pid in range(num_processes):
                cfg = DistributedConfig(coord, num_processes, pid, local_devices)
                env = {**os.environ, **cfg.env(), **(extra_env or {}), "OMP_NUM_THREADS": "1"}
                env["PYTHONPATH"] = os.pathsep.join(p for p in (env.get("PYTHONPATH"), _PACKAGE_ROOT) if p)
                out = open(Path(logs) / f"{pid}.out", "w+")
                err = open(Path(logs) / f"{pid}.err", "w+")
                outs.append((out, err))
                procs.append(subprocess.Popen([sys.executable, "-m", module], env=env,
                                              stdin=subprocess.DEVNULL, stdout=out, stderr=err))
            while True:
                codes = [p.poll() for p in procs]
                if all(c is not None for c in codes):
                    break
                if any(c not in (None, 0) for c in codes):
                    failed.append("a process failed: the others were killed")
                    break
                if time.monotonic() >= deadline:
                    failed.append(f"the cluster's deadline of {timeout} s passed: every process was killed")
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            done = []
            for pid, (p, (out, err)) in enumerate(zip(procs, outs)):
                out.seek(0)
                err.seek(0)
                done.append(subprocess.CompletedProcess(p.args, p.returncode, out.read(), err.read()))
                out.close()
                err.close()
                if p.returncode != 0:
                    failed.append(f"process {pid} rc={p.returncode}: {done[-1].stderr.strip()[-800:]}")
    if failed:
        raise RuntimeError("localhost cluster failed:\n" + "\n".join(failed))
    return done
