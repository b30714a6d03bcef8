"""dragonfly2_tpu_torch — the ML scheduling plane of dragonfly2_tpu in PyTorch.

A port of the JAX package ``dragonfly2_tpu`` to PyTorch and CUDA on an NVIDIA
H100. The JAX package stays the reference; this package mirrors its paths
and names (``models/graphsage.py`` here is ``models/graphsage.py`` there) so
each module has an obvious counterpart, and imports nothing of it.

Layout:
  models/         feature schema, GraphSAGE TopoScorer, BandwidthMLP, flax
                  weight carry-over, the cached-embedding GNNScorer
  ops/            neighbour gather / masked mean, the hand-written CUDA
                  neighbour-aggregation kernel (csrc/neighbor_agg.cu), and
                  the nvcc and g++ builds of csrc/
  trainer/        synthetic cluster and telemetry generators, the
                  telemetry-to-dataset ingest, MLP and GNN training (on one
                  device or sharded over a mesh), the trainer service and
                  its RPC server, artifacts
  parallel/       the ("data", "model") DeviceMesh and its placement rules,
                  process-group set-up (gloo on the CPU, NCCL on the card),
                  the localhost launcher and one multi-process training job
  tpuvm/          safetensors reader/writer and checkpoint staging onto the
                  card or a mesh
  telemetry/      the download and probe record schemas, their stores and
                  the per-edge bandwidth history
  observability/  metric registry, span tracer with head sampling, feature
                  sketch, drift detector, event-loop health monitor
  utils/          the injectable clock, the entry points' signal wait, the
                  token bucket, plugin loading by import path, the id, piece,
                  bitset, DAG, FSM and delta-clock helpers, the YAML config
                  layer, the GC registry and per-component logging
  native/         the micro-batching request front, the native C++ scorer
                  (csrc/scorer.cc) and its scorer.dfsc writer
  rpc/            the JAX package's wire protocol (TCP or a unix socket)
                  with its client's retries and breaker, the trainer's RPC
                  adapters, the manager client's trainer-side subset, the
                  scheduler's RPC server and client and the client's
                  consistent-hash balancer
  scheduler/      the scheduler itself: resource pool, network topology,
                  scheduling rounds (serial, dispatched, native driver and
                  mirror), SchedulerService, its YAML config, the brownout
                  ladder and the process (python -m
                  dragonfly2_tpu_torch.scheduler.server); the evaluator (which
                  a reference scheduler also loads as a plugin), the model
                  loader a scheduler attaches artifacts through and the
                  announcer that uploads telemetry to the trainer
  resilience/     backoff, circuit breaker, retry budget, deadlines, and
                  the seeded fault injection (faultline) on the port's
                  artifact loads and RPC wire
  cli/            dfstress, the load generator (daemon downloads, the
                  scoring stress over both engines, the scheduler swarm)

Entry points run on the card unless the caller asks for the CPU.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch

__version__ = "0.1.0"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device an entry point runs on: ``cuda:0`` unless one is named.

    Raises RuntimeError when a CUDA device is wanted (explicitly, or by
    default) and none is present — an entry point never carries on on the
    CPU that the caller did not ask for.
    """
    import torch  # here, not at import: the package's torch-free modules stay so

    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device present; pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
