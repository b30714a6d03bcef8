#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (dragonfly2_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which must hold or the run exits non-zero at once:

1. device    the card's name and count, nvidia-smi's name and power limit;
             TF32 off for matmuls and cuDNN.
2. build     every kernel source under dragonfly2_tpu_torch/csrc/ compiled with
             nvcc for sm_90a, one nvcc per source, all started together, and
             beside them csrc/scorer.cc (the native scorer) with g++.
3. serving   the first main path at full width: a 16384-host cluster (K=16)
             and a TopoScorer with hidden 256, embed 128, 3 SAGE layers, head
             256, random weights from a seed at flax's init scale. GNNScorer
             refreshes on the card, 256 concurrent 40-candidate rounds go
             through MicroBatchScorer, and neighbor_aggregate (impl "auto")
             runs on the encoder's first hidden state over the cluster's
             neighbour table. The card is then held against the CPU on a
             1024-host cluster.
4. training  the second main path at full width: the same cluster and
             GNNTrainConfig(hidden 512, embed 128, 3 layers, batch 16384),
             trained from init_flax_like(seed 0) by train_async through the
             device-resident multi-step path, 2 calls of 10 steps, then 2
             calls of 10 with remat (the first remat call pays
             torch.utils.checkpoint's one-time import, so the second gives
             its steady rate); then the gradient of neighbor_aggregate
             on the trained encoder's first hidden state. Steps/s, peak
             memory with and without remat and the telemetry stub's count.
             Then 3 steps on the card against 3 on the CPU from the same
             start and batches, at 1024 hosts / hidden 256.
5. artifact  the trained model saved (save_artifact, save_graph, save_native),
             digested and verified, loaded back (load_gnn, load_graph) into a
             GNNScorer on the card, and 256 concurrent rounds served from it,
             equal to a scorer built from the in-memory trained weights.
6. ingest    the trainer service's main path at its own default widths:
             synth_telemetry_records(500,000 downloads, 500,000 probes, 16384
             hosts, seed 7), the trainer's default pool (pool_rows), folded
             through TrainerService.train_open / train_chunk in ColumnarStore's
             65,536-row chunks (all downloads, then all probes) / train_close /
             wait_idle, with the default device (the card) and no manager. The
             MLP (256, 256, 128) trains 500 steps at batch 4096, the GNN (hidden
             256, embed 128, 3 layers, batch 4096) 100 steps in calls of 10:
             cut in GNN steps only (the default is 300). Both models must come
             out; both artifacts verify; the GNN artifact's graph equals the
             one-shot build_dataset's bit for bit and both sketches its counts;
             the loaded MLP on the card is held against the CPU over the eval
             split, and 3 MLP steps on the card against 3 on the CPU.
7. sharded   the sharded trainer (parallel/) in a world of one under NCCL: a
             process group on a free localhost port and make_mesh()'s (1, 1)
             mesh; train_async(mesh=) at the training phase's widths, 2 calls
             of 10 steps, against train_async(device="cuda") from the same
             start and seed (losses within 2e-3 and 1e-4, parameters within
             1e-2 and 1e-3: a world of one runs no real collective, which
             only the CPU tests' four gloo ranks exercise);
             launch_localhost(1, mp_train, local_devices=0), a subprocess that
             joins NCCL from DF_DIST_* alone, whose losses must fall; then
             about 1 GiB of bf16 and f32 tensors from a seed written as
             safetensors and staged onto the card whole and with
             param_leaf_placements on the mesh, each bit-equal to its source.
             Steps/s of both runs, peak memory and staging GB/s. One card is a
             world of one: NCCL puts no two ranks on one device.
8. wiring    the port's control loop, at the ingest phase's records and widths:
             the records written into a port TelemetryStorage; the port's
             trainer server started in-process on a free localhost port,
             training on the card, publishing to a manager stub (a port
             RpcServer that records publish_model rows); the port's
             TrainerAnnouncer.upload_once sends the records over TCP in
             CHUNK_ROWS chunks; both rows must be published within 120 s.
             The GNN row's artifact is loaded by load_scorer_verified: the
             native C++ scorer (host CPU) must come back, and with
             DRAGONFLY_NATIVE_SCORER=0 GNNScorer on the card. The same 256
             concurrent 40-candidate rounds go through MicroBatchScorer from
             both, agreeing within 5e-3; a corrupt copy of the artifact must
             be refused as digest_mismatch. Upload seconds and rows/s, close
             to published, load + verify, per-round p50/p99 of each scorer.
             Cut as the ingest phase is, in GNN steps only.
9. stress    the port's dfstress --scoring at the tool's own size: the artifact
             of build_scoring_artifact on the card (1024 hosts, K=16,
             GNNTrainConfig's default widths: hidden 256, embed 128, 3 layers),
             loaded by load_scorer_verified as the native C++ scorer (host
             CPU) and, with DRAGONFLY_NATIVE_SCORER=0, as GNNScorer on the
             card; both score the same 64 fixed rounds of 40 within 5e-3, every
             score finite and in (0, 1); a model.load:corrupt faultline makes
             the loader refuse the artifact as digest_mismatch, and is disabled
             after. Then run_scoring_stress at the CLI's defaults (256 hosts,
             40 candidates, concurrency 8) once per engine, each of which must
             serve as named (native on the host, torch on the card), with
             fewer micro-batch flushes than rounds. Cut in rounds only: 2,000
             a leg, where the CLI's default is 20,000, and 400 in each torch
             worker leg. Each engine's score() on one fixed round is timed
             on the main thread, on a worker thread, and on a worker thread
             fed by 8 asyncio drivers (the workers1 leg's shape); for the
             card's engine each window is traced with torch.profiler too,
             and the union of its kernel, copy and set spans over the
             untraced window's time gives the card's busy share.
10. evaluator the port's evaluator (scheduler/evaluator.MLEvaluator) on its own
             at the stress phase's size: build_scoring_artifact on the card
             (1024 hosts, K=16, hidden 256, embed 128, 3 layers, seed 7), loaded
             by load_scorer_verified as the native C++ scorer and, with
             DRAGONFLY_NATIVE_SCORER=0, as GNNScorer on the card, each attached
             in turn to one MLEvaluator with a MicroBatchScorer. The rounds'
             rows are precomputed here, set as the evaluator's feature_builder
             on the instance (drawn from the artifact's pair features as
             stress_rounds draws them, for child and parent records that carry
             only .host.id), so that this phase times the evaluator against the
             bare micro-batcher; the scheduler phase runs the feature build
             live. ML_SERVING_MODE must read the serving engine alone;
             evaluate() on one round must equal the scorer's score() bit for
             bit; legs of 2,000 rounds of 40 from 8 concurrent drivers (cut as
             the stress phase's legs are: the CLI's default is 20,000), three
             times in turn through the bundle's bare MicroBatchScorer and
             through evaluate_async, must equal score() bit for bit on the
             native engine and within 5e-3 on the card; the engines agree
             within 5e-3; no round falls back to base, but one with an unknown
             child host does, counted as unknown_hosts; swap_bundle back to the
             first bundle serves the native scores again. Rounds/s (medians),
             p50/p99 and the µs a round the evaluator adds: the difference of
             the two legs' median round times.
11. scheduler the port's SchedulerService (scheduler/service.py) in process on
             the card's host, at the GNN serving cell's cluster: 16384 hosts
             announced (8 idcs, 64 seed hosts), each reporting 8 seeded probe
             results through sync_probes. A wave is 256 tasks of 64 peers on
             seeded hosts, from 32 concurrent drivers: the first peer of a task
             goes back to source; every later registration is one scheduling
             round of up to 40 candidates with the feature build live, then
             its 16 pieces and its result in one report_batch. Not cut. In
             order: a base wave (the MLEvaluator with no model, as a scheduler
             boots: every round counted no_scorer) whose TelemetryStorage
             collects the download and probe records; the loop in the port
             alone: the port's TrainerAnnouncer uploads those records to the
             port's trainer on the card (start_trainer, a manager stub, the
             wiring phase's widths and cut), the published GNN artifact is
             loaded by load_scorer_verified natively and, with
             DRAGONFLY_NATIVE_SCORER=0, as GNNScorer on the card; then ML waves
             on fresh task ids over the same hosts, each engine installed as a
             scheduler's ManagerLink installs it (a MicroBatchScorer; a
             ScorerHandlePool under the dispatcher): torch on the card with no
             dispatcher and with dispatch_workers=2, native with none, native
             with 2 (the native round driver) and native with 2 and
             enable_native_mirror(). Every registration after a task's first
             must get parents; no ML round falls back to base but by reason
             unknown_hosts; the native waves with workers must drive rounds
             natively, the mirror wave through the mirror; each torch wave's
             decision records, rescored by the native scorer on the same rows,
             agree within 5e-3. Per wave: rounds/s, register-to-parents
             p50/p99 (host clock), µs a round in the feature build (_prepare
             and the row export, timed by wrapping both), fallbacks by reason,
             native and mirror rounds; upload, train-to-published, load and
             attach seconds; and the card's busy share over a traced torch
             wave of 32 tasks (the union of its kernel, copy and set spans).
12. swarm    the port's dfstress --swarm against two of the port's scheduler
             processes (python -m dragonfly2_tpu_torch.scheduler.server --port
             0 --evaluator ml, each bound to a port of its own choosing that
             its READY line names, in base mode: no model is attached), each of
             which must print SCHEDULER_READY within 60 s and is killed when
             the phase ends, whatever happens. run_swarm at the CLI's defaults
             (200 peers, 32 tasks, 8 pieces, a probe every 5 cycles) over both
             addresses, cut from 10 s to 5 s: no errors, rounds served, each
             scheduler's share of the rounds within 0.15 of the share the ring
             gives it of the 32 task ids, and each scheduler's log holding the
             port evaluator's serving-mode line (mode base). Rounds/s,
             p50/p99, the shares and the host CPU.
13. rollout  the live-model rollout in the port alone. (a) In process, at the
             scheduler phase's cluster (16384 hosts, 8 seeded probes each,
             waves from 32 drivers, cut to 32 tasks of 64 peers a wave): the
             port's ManagerServer (real RPC on a free port, its sqlite file in
             a temp dir), a SchedulerService with the port's MLEvaluator and
             the port's ManagerLink on it, registered and ticked by hand
             (_check_model, keepalive_once), its loader counted; models trained
             on the card by the port's trainer (start_trainer, the wiring
             phase's widths and cut) from the phase's own wave records through
             the announcer, published to that manager; DRAGONFLY_NATIVE_SCORER
             =0, so the link loads GNNScorer on the card. In order: a base wave;
             ungated v1 installed by one tick, MODEL_SWAP_TOTAL{ok} +1, serving
             mode torch, an ML wave served by it; the model_rollout row gated
             (its gates set before any run), v2 from a second run published as
             a candidate, attached, shadow-scored on a wave at sample rate 1.0,
             reported, promoted and swapped by the fast path with no second
             load; v3, a corrupt copy of v2's artifact under v2's digest,
             refused as digest_mismatch, rejected in the registry, nothing
             attached; the row's gates set to the default DivergenceGates,
             then v2's artifact copied and wrapped to negate every score
             (a broken head) published as a candidate, shadow-scored on a
             wave, reported and rejected by the gate: the registry reads it
             rejected with the gate's reasons, the candidate slot empties,
             v2 serves on; v4, v2's artifact copied, wrapped to raise on every
             round once armed, shadows clean, promotes, is armed, and the
             health window rolls back to the warm v2: v2's scores on a fixed
             round bit-equal to before, the registry v4 rejected and v2
             active, MODEL_ROLLBACK_TOTAL +1; the manager stopped: two failed
             keepalives set MANAGER_UNREACHABLE, the watch freezes, a wave
             still scores on v2; the manager restarted on its port and file
             and the link rejoins. Per step: seconds, card memory allocated,
             swap counts by result, the merged shadow divergence; per wave
             rounds/s. (b) Processes: python -m
             dragonfly2_tpu_torch.manager.server and two python -m
             dragonfly2_tpu_torch.scheduler.server --evaluator ml --manager
             <addr> --federation-peers auto with 1 s keepalive, model-watch
             and federation intervals (the address book refreshes every 60
             s, as the reference's does), one with
             DRAGONFLY_NATIVE_SCORER=0 (torch on the card), one native; each
             prints its ready line within 60 s and is stopped when the phase
             ends, whatever happens. v2's artifact published ungated through
             RemoteManagerClient; within 60 s cluster_stats shows both
             schedulers' frames serving torch and native; run_swarm at its
             defaults cut to 5 s over both, no errors; within 30 s after it
             each scheduler's federation_state (over RPC) holds remote edges
             (a sync is push-pull, so one side's syncs move deltas both ways:
             the scheduler that registered second finds the first in its
             book at boot, while the first sees the second only at its next
             60 s refresh), and the frames in cluster_stats carry both
             schedulers' federation families, at least one naming its peer
             with successful syncs. Then the operator CLIs: in leg (a),
             dfml train --json through the port's cli.dfml.main against
             the leg's trainer lists both runs trained on the card; in leg
             (b), after a wave of 4 tasks of 64 peers driven over RPC on
             the torch scheduler (hosts the model knows, so its rounds score
             on the card), python -m dragonfly2_tpu_torch.cli.dftop --once
             --json exits 0 with both schedulers serving torch and native,
             cli.dfmodel status --json shows v2's artifact active, cli.dfml
             decisions --json returns the wave's records and cli.dfml
             explain on one scored on the card exits 0, its replay
             bit-exact. Each call under a 60 s deadline.
14. sim      the swarm simulator (sim/) over the port's control plane, at
             tools/check.sh's sim-smoke shape: flash_crowd(peers=10,000,
             seed=0), 2 federated schedulers, 3 regions, churn at a 600 s
             mean lifetime with 25% crashes, on a virtual clock. (a) The base
             run with its records captured: the scenario's check and
             check.sh's bounds (completed >= 9,500, placement rounds >
             9,000, same-region share >= 0.5, 0 < origin fetches a region
             <= 8, no departed-parent round, a dataset with nodes and edges),
             then build_dataset, its training pairs split by idc_match
             (count and mean label) and its rtt column's spread. (b) python -m dragonfly2_tpu_torch.cli.dfsim
             flash-crowd --peers 10000 --seed 0 --scoring ml-native --json,
             a process of its own beside (a) and (c) (the native C++ scorer
             on the host), under a 600 s deadline: tests/test_sim.py's
             coverage contract (native rounds >= rounds - schedulers, mirror
             + stale = native, one full sync a scheduler) and no
             departed-parent round. (c) A GNN (hidden 256, embed 128, 3
             layers, batch 4096) trained by train_async on the card from
             (a)'s dataset, 100 steps in calls of 10, whose losses must fall;
             saved (save_artifact, save_graph, save_native), digested, loaded
             by load_scorer_verified with DRAGONFLY_NATIVE_SCORER=0 as
             GNNScorer on the card, and attached through attach_scorer
             (version sim-trained, no micro-batcher, no dispatcher: the
             virtual-clock loop sees nothing a thread resolves) to every
             scheduler of a fresh flash_crowd(10,000, seed 0) whose
             evaluators record one round in 20. Every evaluator serves
             torch; no round falls back as scorer_error, no_scorer or
             degraded, at most 1% as unknown_hosts; no departed-parent
             round, completed >= 9,500; at least 128 recorded rounds scored
             on the card, and every record the rings hold re-scored by the
             same artifact on the CPU within 5e-3. The scenario's check is
             printed, not gated: placement under a learned model is this
             leg's finding. Per leg: events, events/s, time compression,
             rounds/s inside schedule_candidate_parents, placement and
             outcomes; for (c) also the dataset, train seconds and steps/s,
             load + verify seconds, card memory and fallbacks by reason.
15. kernels  each kernel against its plain PyTorch version on the card, at the
             main paths' shapes and on edge cases, and against itself over two
             launches (bit for bit), then timed with CUDA events beside its
             plain version, its bound and one PyTorch library call. K2 is
             timed with its transposed index built beforehand; the index
             build is timed on its own.

This script imports and launches nothing of the JAX package.
Launch counts are set to 0 just before each main path and read just after.
Prints a ``{"kernels": [...]}`` line, the card line, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import concurrent.futures
import contextlib
import copy
import dataclasses
import io
import json
import os
import pathlib
import platform
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import types

import numpy as np
import torch
import torch.nn.functional as F

from dragonfly2_tpu_torch.models import GNNScorer, TopoScorer, init_flax_like, params_from_flax
from dragonfly2_tpu_torch.native import MicroBatchScorer, ScorerHandlePool
from dragonfly2_tpu_torch.ops import _build, neighbor_agg_cuda, neighbor_aggregate
from dragonfly2_tpu_torch.ops.neighbor_agg_cuda import (
    neighbor_aggregate_bwd_cuda,
    neighbor_aggregate_bwd_torch,
    neighbor_aggregate_cuda,
    neighbor_aggregate_torch,
    transpose_index,
)
from dragonfly2_tpu_torch import resolve_device
from dragonfly2_tpu_torch.cli import dfml, dfstress
from dragonfly2_tpu_torch.models.features import BASE_WEIGHTS, FEATURE_DIM, FEATURE_NAMES
from dragonfly2_tpu_torch.models.weights import full_state_dict
from dragonfly2_tpu_torch.parallel import distributed as dist_lib
from dragonfly2_tpu_torch.parallel import mesh as meshlib
from dragonfly2_tpu_torch.resilience import faultline
from dragonfly2_tpu_torch.rpc.balancer import ConsistentHashRing
from dragonfly2_tpu_torch.rpc.core import RpcServer
from dragonfly2_tpu_torch.scheduler import manager_link, scheduling
from dragonfly2_tpu_torch.scheduler import metrics as sched_metrics
from dragonfly2_tpu_torch.scheduler.evaluator import SERVING_MODES, DecisionRecorder, MLEvaluator
from dragonfly2_tpu_torch.scheduler.announcer import CHUNK_ROWS, TrainerAnnouncer
from dragonfly2_tpu_torch.scheduler.service import HostInfo, SchedulerService, TaskMeta
from dragonfly2_tpu_torch.sim import scenarios as sim_scenarios
from dragonfly2_tpu_torch.telemetry import TelemetryStorage
from dragonfly2_tpu_torch.tpuvm import safetensors as stlib
from dragonfly2_tpu_torch.tpuvm import staging
from dragonfly2_tpu_torch.trainer import artifacts, dataset, train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.server import start_trainer, stop_trainer
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import make_cluster, sample_batch, synth_telemetry_records
from dragonfly2_tpu_torch.utils import proc as proc_lib

NUM_HOSTS, NUM_NEIGHBORS, GRAPH_SEED = 16384, 16, 7
MODEL = dict(hidden=256, embed_dim=128, num_layers=3, head_hidden=256)
WEIGHT_SEED = 0
ROUNDS, CANDIDATES, FLUSH_ROUNDS = 256, 40, 64
CPU_CHECK_HOSTS = 1024
# the repo's full-cluster training shape (bench.py:459, north-star config 3)
TRAIN = train_gnn.GNNTrainConfig(hidden=512, embed_dim=128, num_layers=3, batch_size=16384)
TRAIN_CALLS, REMAT_CALLS, STEPS_PER_CALL = 2, 2, 10
# the card against the CPU at bench.py:438's shape, 3 steps past a 1-step warm-up
CPU_TRAIN = train_gnn.GNNTrainConfig(hidden=256, embed_dim=128, num_layers=3, batch_size=4096, warmup_steps=1)
CPU_TRAIN_STEPS, TRAIN_LOSS_MAX_ABS, TRAIN_PARAM_MAX_ABS = 3, 2e-3, 1e-2
RELOAD_SCORE_MAX_ABS = 1e-6
# the trainer's default pool (TrainerConfig.pool_rows) of each record kind,
# over the serving cluster's host count, in ColumnarStore's rotate_rows chunks
INGEST_ROWS, INGEST_HOSTS, INGEST_SEED, INGEST_CHUNK = 500_000, 16384, 7, 65536
INGEST_GNN_STEPS = 100  # the one cut: TrainerConfig's default is 300
MLP_CPU_STEPS, MLP_EVAL_MAX_ABS = 3, 5e-3
# the wiring phase: the ingest phase's records and widths, uploaded over TCP;
# the published rows must come within the deadline, and the native and torch
# scorers of the one artifact must agree on every round within the bound
WIRING_DEADLINE_S, WIRING_ROUND_SEED = 120.0, 21
# the sharded phase: the training phase's shape on a (1, 1) mesh, held to the
# card-vs-CPU bounds and to tight ones: on a world of one the collectives are
# identities, so the mesh run differs from one device only by the order of
# the backward's atomic adds (tests/test_torch_parallel.py holds mesh against
# one process to the same 1e-4 / 1e-3); mp_train's own cluster (128 hosts, 12 steps)
SHARDED_CALLS, MP_TRAIN_DEADLINE_S = 2, 300.0
SHARDED_LOSS_MAX_ABS, SHARDED_PARAM_MAX_ABS = 1e-4, 1e-3
# about 1 GiB of checkpoint-like tensors: 7 bf16 [8192, 8192] weights, one
# f32 [8192, 4096] and two f32 [8192] vectors
STAGE_BF16, STAGE_F32, STAGE_SEED = [(8192, 8192)] * 7, [(8192, 4096), (8192,), (8192,)], 17
# the stress phase: the CLI's defaults, cut from 20,000 rounds a leg; the
# engines held on STRESS_CHECK_ROUNDS fixed rounds to the serving bound
STRESS_ROUNDS, STRESS_HOSTS, STRESS_CANDIDATES, STRESS_CONCURRENCY = 2000, 256, 40, 8
# Rounds of each torch worker leg (at 1.4-1.6 ms a round), and score() calls
# in each window of the busy-share measurement.
STRESS_TORCH_WORKER_ROUNDS, BUSY_ROUNDS = 400, 300
# the evaluator phase: the stress phase's rounds, concurrency and leg length,
# a bare MicroBatchScorer leg and an evaluate_async leg in turn, EVAL_REPS times
EVAL_ROUNDS, EVAL_REPS = STRESS_ROUNDS, 3
FALLBACK_REASONS = ("no_scorer", "unknown_hosts", "scorer_error", "degraded")
# the scheduler phase: the port's SchedulerService at the GNN serving cell's
# cluster, each host reporting SCHED_PROBES seeded probes; a wave is
# SCHED_TASKS tasks of SCHED_PEERS peers (one scheduling round of up to 40
# candidates a registration after the first) of SCHED_PIECES 4 MiB pieces,
# from SCHED_DRIVERS concurrent drivers; the busy share over a traced torch
# wave of SCHED_TRACED_TASKS tasks
SCHED_HOSTS, SCHED_TASKS, SCHED_PEERS, SCHED_PROBES, SCHED_PIECES = NUM_HOSTS, 256, 64, 8, 16
SCHED_DRIVERS, SCHED_SEED, SCHED_TRACED_TASKS = 32, 31, 32
# the swarm phase: two of the port's scheduler processes, the CLI's defaults
# cut from 10 s to 5 s, each scheduler's round share held to the ring's
# placement of the task ids
SWARM_SCHEDULERS, SWARM_BOOT_S, SWARM_DURATION_S, SWARM_TASKS, SWARM_SHARE_TOL = 2, 60.0, 5.0, 32, 0.15
# the rollout phase: waves of ROLL_TASKS tasks (of SCHED_TASKS in the scheduler
# phase) on its cluster; the shadow gate set in the model_rollout row before
# any run, as tests/test_rollout.py sets it (two GNNs trained from the same
# records need not agree on rankings; a wave of 32 tasks gives ~2,000 rounds,
# twice the gate's min_rounds); the keepalive interval bounds the rejoin's
# jitter; the process leg's deadlines
ROLL_TASKS, ROLL_KEEPALIVE_S, ROLL_REJOIN_S, ROLL_FIXED_SEED = 32, 1.0, 30.0, 41
ROLL_GATES = {"min_rounds": 1000, "min_topk_overlap": 0.0, "min_rank_corr": -1.0, "max_mean_abs_delta": 100.0}
ROLL_BOOT_S, ROLL_ATTACH_S, ROLL_FEDERATION_S = 60.0, 60.0, 30.0
# the CLIs against the rollout phase's processes: a wave of ROLL_CLI_TASKS tasks
# of SCHED_PEERS peers on the torch scheduler over RPC (rounds on hosts the
# model knows, so scored on the card: the recorder keeps 1 in 50), each call
# under its deadline
ROLL_CLI_TASKS, ROLL_CLI_HOSTS, CLI_DEADLINE_S = 4, 128, 60.0
SWAP_RESULTS = ("ok", "missing", "digest_mismatch", "load_error", "swap_error", "rpc_error", "rejected_version",
                "rollback")
# the sim phase: tools/check.sh's sim-smoke shape (flash crowd, 10,000 peers,
# 2 federated schedulers, 3 regions, churn at a 600 s mean lifetime with 25%
# crashes, seed 0); leg (c) trains the ingest phase's GNN widths (the
# GNNTrainConfig defaults) on leg (a)'s records, 100 steps in calls of 10, and
# serves it to a second run whose evaluators record one round in 20; at most
# 1% of that run's rounds may fall back as unknown_hosts, and the rings must
# hold SIM_MIN_RECORDS records
SIM_PEERS, SIM_SEED, SIM_DEADLINE_S = 10_000, 0, 600.0
SIM_TRAIN = train_gnn.GNNTrainConfig(hidden=256, embed_dim=128, num_layers=3, batch_size=4096)
SIM_TRAIN_STEPS, SIM_DECISION_SAMPLE, SIM_MIN_RECORDS, SIM_UNKNOWN_MAX = 100, 0.05, 128, 0.01
REPO = pathlib.Path(__file__).resolve().parent
# tests/test_ops.py's own tolerances for the Pallas kernel against XLA
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
EMBED_MIN_COSINE, SCORE_MAX_ABS = 0.999, 5e-3
# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
# A device-side spin of about 50 ms at the H100's ~2 GHz clock: long enough
# for the host to queue every launch of a timed run behind it.
SPIN_CYCLES = 100_000_000


@contextlib.contextmanager
def phase(name: str):
    t0 = time.perf_counter()
    print(f"[{name}] ...", flush=True)
    yield
    print(f"[{name}] ok in {time.perf_counter() - t0:.1f} s", flush=True)


def nvidia_smi_line() -> str:
    p = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return p.stdout.strip().splitlines()[0]


def events_ms(fn, iters: int, flush: torch.Tensor | None) -> float:
    """Mean device time of fn() in ms, by CUDA events.

    With ``flush``, the buffer is rewritten before each launch so that the
    launch finds the 50 MB L2 cold, and events bracket each launch; the
    rewrite keeps the device busy while the host queues the launch. Without,
    launches run back to back behind a spin on the stream that lasts until
    the host has queued them all, so the events time the device and not the
    host's launch rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if flush is None:
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters
    pairs = []
    for _ in range(iters):
        flush.add_(1)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def host_us_per_call(fn, iters: int) -> float:
    """Host time to issue one fn() while the device is held busy, in us."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / iters * 1e6


def compare(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    torch.cuda.synchronize()
    g, w = got.float().cpu(), want.float().cpu()
    err = float((g - w).abs().max()) if g.numel() else 0.0
    tol = TOL[want.dtype]
    if got.dtype != want.dtype or got.shape != want.shape or not torch.allclose(g, w, **tol):
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version (max abs err {err:.3g}, "
            f"dtype {got.dtype} vs {want.dtype}, shape {tuple(got.shape)} vs {tuple(want.shape)})"
        )
    print(f"  {name}: max abs err {err:.3g}")
    return err


def round_inputs(cluster, seed: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """ROUNDS rounds of CANDIDATES random (child, parent) pairs over the cluster."""
    rng = np.random.default_rng(seed)
    n = cluster.graph.node_feats.shape[0]
    child = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
    parent = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
    feats = cluster.pairs.feats[rng.integers(0, len(cluster.pairs.feats), (ROUNDS, CANDIDATES))]
    return feats, child, parent


def drive_rounds(scorer, feats, child, parent) -> tuple[MicroBatchScorer, np.ndarray, np.ndarray]:
    """All rounds at once through a MicroBatchScorer: (batcher, scores, per-round ms)."""

    async def drive():
        mb = MicroBatchScorer(scorer, max_rounds_per_flush=FLUSH_ROUNDS)

        async def one(r: int):
            t = time.perf_counter()
            out = await mb.score(feats[r], child=child[r], parent=parent[r])
            return out, time.perf_counter() - t

        res = await asyncio.gather(*(one(r) for r in range(len(feats))))
        return mb, res

    mb, res = asyncio.run(drive())
    scores = np.stack([out for out, _ in res])
    if scores.shape != child.shape or not np.all(np.isfinite(scores)):
        raise AssertionError(f"round scores: shape {scores.shape}, finite {np.isfinite(scores).all()}")
    if not np.all((scores > 0) & (scores < 1)):
        raise AssertionError("round scores fall outside (0, 1)")
    if mb.rounds != len(feats) or mb.flushes != -(-len(feats) // FLUSH_ROUNDS):
        raise AssertionError(f"{mb.rounds} rounds in {mb.flushes} flushes")
    return mb, scores, np.array([dt for _, dt in res]) * 1e3


def timed_refresh(scorer, graph) -> float:
    """Host ms of a second refresh (the first warms up); refresh ends in a
    device synchronise."""
    scorer.refresh(graph)
    t0 = time.perf_counter()
    scorer.refresh(graph)
    return (time.perf_counter() - t0) * 1e3


def serving(cluster, model, sd) -> tuple[dict, torch.Tensor]:
    """The first main path. Returns its numbers and the encoder's first
    hidden state, on which it ran the neighbour aggregation."""
    g = cluster.graph
    feats, child, parent = round_inputs(cluster, 11)

    torch.cuda.reset_peak_memory_stats()
    scorer = GNNScorer(model, sd, device="cuda")
    refresh_ms = timed_refresh(scorer, g)
    print(f"  refresh: {refresh_ms:.2f} ms (host clock, graph upload included)")
    drive_rounds(scorer, feats, child, parent)  # warm-up
    mb, scores, lat_ms = drive_rounds(scorer, feats, child, parent)
    # All rounds queue before the first flush, and the flusher drains them in
    # order, FLUSH_ROUNDS at a time; direct calls with the same grouping run
    # the same shapes and must agree exactly.
    direct = np.concatenate([
        scorer.score_rounds(feats[i : i + FLUSH_ROUNDS], child=child[i : i + FLUSH_ROUNDS],
                            parent=parent[i : i + FLUSH_ROUNDS])
        for i in range(0, ROUNDS, FLUSH_ROUNDS)
    ])
    if not np.array_equal(direct, scores):
        raise AssertionError(
            f"micro-batched scores differ from direct score_rounds by {np.abs(direct - scores).max():.3g}"
        )
    whole = scorer.score_rounds(feats, child=child, parent=parent)
    print(f"  {mb.rounds} rounds in {mb.flushes} flushes; p50 {np.percentile(lat_ms, 50):.3f} ms, "
          f"p99 {np.percentile(lat_ms, 99):.3f} ms; equal to direct score_rounds; "
          f"one {ROUNDS}-round call differs by {np.abs(whole - scores).max():.3g}")

    # neighbor_aggregate through the public dispatch, on the slice's own data
    enc = copy.deepcopy(model).cuda().eval()
    enc.load_state_dict(sd)
    with torch.inference_mode():
        gd = g.to("cuda")
        h0 = enc.encoder.Dense_0(gd.node_feats)  # [N, hidden] bf16
        agg = neighbor_aggregate(h0, gd.neighbors, gd.mask)
        torch.cuda.synchronize()
    if agg.shape != h0.shape or not torch.isfinite(agg).all():
        raise AssertionError("neighbor_aggregate gave non-finite values or the wrong shape")
    numbers = {
        "refresh_ms": refresh_ms,
        "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
        "rounds": mb.rounds, "flushes": mb.flushes, "candidates": CANDIDATES,
        "round_p50_ms": float(np.percentile(lat_ms, 50)),
        "round_p99_ms": float(np.percentile(lat_ms, 99)),
    }
    print(f"  peak device memory: {numbers['max_memory_allocated_bytes'] / 2**20:.1f} MiB")
    return numbers, h0


def cpu_check(model, sd) -> dict:
    """The same weights on the card and on the CPU, on a smaller cluster."""
    small = make_cluster(num_nodes=CPU_CHECK_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
    mods = {}
    for dev in ("cuda", "cpu"):
        m = copy.deepcopy(model).to(dev).eval()
        m.load_state_dict(sd)
        mods[dev] = m
    with torch.inference_mode():
        zg = mods["cuda"].embed(small.graph.to("cuda")).cpu()
        zc = mods["cpu"].embed(small.graph.to("cpu"))
    cos = float(torch.nn.functional.cosine_similarity(zg, zc, dim=-1).min())
    rng = np.random.default_rng(12)
    child = rng.integers(0, CPU_CHECK_HOSTS, (64, CANDIDATES), dtype=np.int32)
    parent = rng.integers(0, CPU_CHECK_HOSTS, (64, CANDIDATES), dtype=np.int32)
    feats = small.pairs.feats[rng.integers(0, len(small.pairs.feats), (64, CANDIDATES))]
    out = {}
    for dev in ("cuda", "cpu"):
        s = GNNScorer(model, sd, device=dev)
        s.refresh(small.graph)
        out[dev] = s.score_rounds(feats, child=child, parent=parent)
    err = float(np.abs(out["cuda"] - out["cpu"]).max())
    print(f"  card vs CPU at {CPU_CHECK_HOSTS} hosts: embedding min cosine {cos:.6f}, "
          f"embedding max abs {float((zg - zc).abs().max()):.3g}, score max abs {err:.3g}")
    if cos < EMBED_MIN_COSINE or err > SCORE_MAX_ABS:
        raise AssertionError(f"card and CPU disagree: cosine {cos} < {EMBED_MIN_COSINE} or "
                             f"score err {err} > {SCORE_MAX_ABS}")
    return {"embed_min_cosine": cos, "score_max_abs": err}


class StepClock:
    """A telemetry stub: counts ``on_step`` calls and notes when each call's
    first step arrives, which is just after that call's one loss pull."""

    def __init__(self, steps_per_call: int):
        self.steps_per_call = steps_per_call
        self.steps: list[tuple[float, float]] = []
        self.pulled_at: list[float] = []

    def on_step(self, loss: float, grad_norm: float, *, examples: int) -> None:
        if len(self.steps) % self.steps_per_call == 0:
            self.pulled_at.append(time.perf_counter())
        self.steps.append((loss, grad_norm))


def train_run(cluster, cfg, calls: int, mesh=None) -> tuple[train_gnn.TrainState, list[float], dict]:
    """train_async through the multi-step path, on the card or on ``mesh``; its numbers."""
    clock = StepClock(STEPS_PER_CALL)
    torch.cuda.reset_peak_memory_stats()
    where = {"device": "cuda"} if mesh is None else {"mesh": mesh}
    t0 = time.perf_counter()
    state, losses = asyncio.run(train_gnn.train_async(
        cfg, cluster.graph, cluster.pairs, steps=calls * STEPS_PER_CALL, seed=WEIGHT_SEED,
        steps_per_call=STEPS_PER_CALL, log_every=STEPS_PER_CALL, log=lambda line: print(f"    train_async: {line}"),
        telemetry=clock, **where,
    ))
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if len(losses) != calls * STEPS_PER_CALL or not np.all(np.isfinite(losses)):
        raise AssertionError(f"losses: {len(losses)} of {calls * STEPS_PER_CALL}, finite {np.isfinite(losses).all()}")
    if len(clock.steps) != len(losses) or [lv for lv, _ in clock.steps] != losses:
        raise AssertionError(f"telemetry saw {len(clock.steps)} steps of {len(losses)}")
    # steps/s of each call after the first, on the host clock between pulls;
    # the first call's window opens at train_async's start, set-up included
    rates = [STEPS_PER_CALL / (b - a) for a, b in zip(clock.pulled_at, clock.pulled_at[1:])]
    first_s = clock.pulled_at[0] - t0
    numbers = {
        "steps": len(losses), "on_step_calls": len(clock.steps), "remat": cfg.remat,
        "first_loss": losses[0], "last_loss": losses[-1],
        "steps_per_s_after_first_call": rates, "first_call_s_with_setup": first_s, "wall_s": wall,
        "max_memory_allocated_bytes": peak,
    }
    rate_txt = ", ".join(f"{r:.2f}" for r in rates) or "n/a (one call)"
    print(f"  {'mesh ' if mesh is not None else ''}remat={cfg.remat}: {len(losses)} steps in {calls} calls, loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"steps/s after the first call {rate_txt}; first call {first_s:.2f} s with set-up; "
          f"peak device memory {peak / 2**30:.2f} GiB; on_step calls {len(clock.steps)}")
    return state, losses, numbers


def training(cluster) -> tuple[dict, train_gnn.TrainState]:
    """The second main path: train at full width, then the gradient of
    neighbor_aggregate on the trained encoder's first hidden state."""
    start = params_from_flax(init_flax_like(train_gnn.make_model(TRAIN), seed=WEIGHT_SEED))
    state, losses, plain = train_run(cluster, TRAIN, TRAIN_CALLS)
    trained = state.model.state_dict()
    moved = max(float((trained[k].cpu() - start[k]).abs().max()) for k in start)
    if moved == 0.0:
        raise AssertionError("training left every parameter where it started")
    _, remat_losses, remat = train_run(cluster, dataclasses.replace(TRAIN, remat=True), REMAT_CALLS)
    # the same seed draws the same batches, so remat retraces the plain run
    remat["loss_max_abs_vs_no_remat"] = float(np.abs(np.array(remat_losses) - np.array(losses)).max())
    print(f"  parameters moved by up to {moved:.3g}; remat's losses differ from the plain run's by up to "
          f"{remat['loss_max_abs_vs_no_remat']:.3g} (atomic-order noise in the backward)")

    gd = cluster.graph.to("cuda")
    with torch.no_grad():
        h0 = state.model.encoder.Dense_0(gd.node_feats)  # [N, hidden] bf16
    h0.requires_grad_()
    agg = neighbor_aggregate(h0, gd.neighbors, gd.mask)
    (gh,) = torch.autograd.grad((agg.float() ** 2).sum(), h0)
    torch.cuda.synchronize()
    if agg.grad_fn is None or gh.shape != h0.shape or not torch.isfinite(gh).all():
        raise AssertionError("neighbor_aggregate's gradient is missing, non-finite or of the wrong shape")
    return {"no_remat": plain, "remat": remat, "max_param_move": moved}, state


def cpu_train_check() -> dict:
    """3 steps on the card and 3 on the CPU from the same start and batches."""
    small = make_cluster(num_nodes=CPU_CHECK_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
    start = init_flax_like(train_gnn.make_model(CPU_TRAIN), seed=WEIGHT_SEED)
    rng = np.random.default_rng(13)
    batches = [sample_batch(small.pairs, CPU_TRAIN.batch_size, rng) for _ in range(CPU_TRAIN_STEPS)]
    out = {}
    for dev in ("cuda", "cpu"):
        state = train_gnn.init_state(CPU_TRAIN, params=start, device=dev)
        g = small.graph.to(dev)
        t0 = time.perf_counter()
        losses = [float(train_gnn.train_step(state, g, b)[1]) for b in batches]
        out[dev] = (losses, {k: v.cpu() for k, v in state.model.state_dict().items()}, time.perf_counter() - t0)
    (lg, pg, tg), (lc, pc, tc) = out["cuda"], out["cpu"]
    loss_err = float(np.abs(np.array(lg) - np.array(lc)).max())
    param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    print(f"  card vs CPU training at {CPU_CHECK_HOSTS} hosts / hidden {CPU_TRAIN.hidden}: losses "
          f"{[round(v, 6) for v in lg]} vs {[round(v, 6) for v in lc]}, max abs {loss_err:.3g}; "
          f"parameters max abs {param_err:.3g} ({tg:.1f} s on the card, {tc:.1f} s on the CPU)")
    if loss_err > TRAIN_LOSS_MAX_ABS or param_err > TRAIN_PARAM_MAX_ABS or not np.all(np.isfinite(lg)):
        raise AssertionError(f"card and CPU training disagree: loss {loss_err} > {TRAIN_LOSS_MAX_ABS} "
                             f"or parameters {param_err} > {TRAIN_PARAM_MAX_ABS}")
    return {"loss_max_abs": loss_err, "param_max_abs": param_err}


def artifact_handoff(cluster, state: train_gnn.TrainState) -> dict:
    """Save the trained model, verify it, load it back and serve from it."""
    trained = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    config = {"hidden": TRAIN.hidden, "embed_dim": TRAIN.embed_dim, "num_layers": TRAIN.num_layers}
    hosts = {f"host-{i}".encode(): i for i in range(NUM_HOSTS)}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        artifacts.save_artifact(tmp, model_type="gnn", version="smoke", params=trained, config=config)
        artifacts.save_graph(tmp, cluster.graph, hosts)
        artifacts.save_native(tmp, train_gnn.make_model(TRAIN), trained, cluster.graph, device="cuda")
        save_s = time.perf_counter() - t0
        digest = artifacts.artifact_digest(tmp)
        artifacts.verify_artifact(tmp, digest)
        model, sd = artifacts.load_gnn(tmp)
        graph, host_index = artifacts.load_graph(tmp)
    if any(not torch.equal(sd[k], trained[k]) for k in trained) or len(host_index) != NUM_HOSTS:
        raise AssertionError("the reloaded artifact's parameters or host index differ from what was saved")
    feats, child, parent = round_inputs(cluster, 14)
    loaded = GNNScorer(model, sd, device="cuda")
    refresh_ms = timed_refresh(loaded, graph)
    mb, got, lat_ms = drive_rounds(loaded, feats, child, parent)
    memory = GNNScorer(state.model, trained, device="cuda")
    memory.refresh(cluster.graph)
    _, want, _ = drive_rounds(memory, feats, child, parent)
    err = float(np.abs(got - want).max())
    print(f"  artifact saved in {save_s:.1f} s, digest {digest[:16]}… verified; reloaded scorer: refresh "
          f"{refresh_ms:.2f} ms at hidden {TRAIN.hidden}; {mb.rounds} rounds in {mb.flushes} flushes, "
          f"p50 {np.percentile(lat_ms, 50):.3f} ms; max abs vs the in-memory model {err:.3g}")
    if err > RELOAD_SCORE_MAX_ABS:
        raise AssertionError(f"reloaded scores differ from the in-memory model's by {err} > {RELOAD_SCORE_MAX_ABS}")
    return {"refresh_ms_hidden512": refresh_ms, "rounds": mb.rounds, "reload_score_max_abs": err,
            "round_p50_ms": float(np.percentile(lat_ms, 50))}


async def drive_service(cfg: TrainerConfig, downloads: np.ndarray, probes: np.ndarray) -> tuple:
    """One scheduler upload through the service's own coroutines: open, every
    download chunk, every probe chunk, close, then wait for the training run.
    Returns the run's result (``{}`` if none), the service's status, and the
    host seconds of the chunk calls (unpacking and folding) and of
    close-to-idle (the whole training run)."""
    svc = TrainerService(cfg, manager=None)
    token = (await svc.train_open({"hostname": "chip-smoke", "scheduler_id": 0}))["token"]
    packed = [(kind, pack_records(arr[s : s + INGEST_CHUNK]))
              for kind, arr in (("downloads", downloads), ("probes", probes))
              for s in range(0, len(arr), INGEST_CHUNK)]
    t0 = time.perf_counter()
    for kind, data in packed:
        await svc.train_chunk({"token": token, "kind": kind, "data": data})  # dflint: disable=DF025 the upload protocol is one train_chunk per chunk
    fold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    await svc.train_close({"token": token})
    await svc.wait_idle()
    run_s = time.perf_counter() - t0
    return svc.last_result or {}, await svc.status(), fold_s, run_s


def mlp_cpu_check(cfg: train_mlp.MLPTrainConfig, pairs, dev: torch.device) -> dict:
    """MLP_CPU_STEPS steps on ``dev`` and on the CPU from the same start and batches."""
    start = init_flax_like(train_mlp.make_model(cfg), seed=WEIGHT_SEED)
    rng = np.random.default_rng(15)
    batches = [rng.integers(0, len(pairs.child), cfg.batch_size) for _ in range(MLP_CPU_STEPS)]
    out = {}
    for d in (dev, torch.device("cpu")):
        model = train_mlp.make_model(cfg)
        model.load_state_dict(params_from_flax(start))
        model.to(d)
        opt = train_mlp.make_optimizer(cfg, model.parameters())
        losses = [float(train_mlp.train_step(model, opt, i, torch.from_numpy(pairs.feats[idx]).to(d),
                                             torch.from_numpy(pairs.label[idx]).to(d))[0])
                  for i, idx in enumerate(batches)]
        out[d.type] = (losses, {k: v.cpu() for k, v in model.state_dict().items()})
    (lg, pg), (lc, pc) = out[dev.type], out["cpu"]
    loss_err = float(np.abs(np.array(lg) - np.array(lc)).max())
    param_err = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
    print(f"  MLP card vs CPU, {MLP_CPU_STEPS} steps at batch {cfg.batch_size}: losses {[round(v, 6) for v in lg]} "
          f"vs {[round(v, 6) for v in lc]}, max abs {loss_err:.3g}; parameters max abs {param_err:.3g}")
    if loss_err > TRAIN_LOSS_MAX_ABS or param_err > TRAIN_PARAM_MAX_ABS or not np.all(np.isfinite(lg)):
        raise AssertionError(f"card and CPU MLP training disagree: loss {loss_err} > {TRAIN_LOSS_MAX_ABS} "
                             f"or parameters {param_err} > {TRAIN_PARAM_MAX_ABS}")
    return {"loss_max_abs": loss_err, "param_max_abs": param_err}


def ingest() -> dict:
    """The trainer service's main path, records to both artifacts, on the
    default device; then the artifacts checked against a one-shot build."""
    t_phase = time.perf_counter()
    dev = resolve_device()
    t0 = time.perf_counter()
    downloads, probes = synth_telemetry_records(INGEST_ROWS, INGEST_ROWS, INGEST_HOSTS, seed=INGEST_SEED)
    records_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainerConfig(model_dir=tmp, gnn_steps=INGEST_GNN_STEPS, gnn_steps_per_call=10)
        torch.cuda.reset_peak_memory_stats()
        res, status, fold_s, run_s = asyncio.run(drive_service(cfg, downloads, probes))
        peak = torch.cuda.max_memory_allocated()
        # _train turns any fault inside the run into {"error": ...}: say so loudly
        if "mlp" not in res or "gnn" not in res:
            raise AssertionError(f"the service's run did not give both models: {res}")
        mlp_dir, gnn_dir = res["mlp"]["artifact"], res["gnn"]["artifact"]
        if not (pathlib.Path(gnn_dir) / "scorer.dfsc").exists():
            raise AssertionError("save_native wrote no scorer.dfsc (its failure is only logged)")
        for m in ("mlp", "gnn"):
            artifacts.verify_artifact(res[m]["artifact"], res[m]["digest"])
        t0 = time.perf_counter()
        want = dataset.build_dataset(downloads, probes)
        build_s = time.perf_counter() - t0
        graph, hosts = artifacts.load_graph(gnn_dir)
        same = [name for name, a, b in zip(graph._fields, graph, want.graph)
                if a.dtype != b.dtype or not np.array_equal(a, b)]
        if same or hosts != {k.decode(): v for k, v in want.host_index.items()}:
            raise AssertionError(f"the artifact's graph differs from build_dataset's in {same or 'hosts.json'}")
        for d in (mlp_dir, gnn_dir):
            if not np.array_equal(artifacts.load_sketch(d).counts, want.feature_sketch.counts):
                raise AssertionError(f"{d}: sketch counts differ from build_dataset's")
        model, sd = artifacts.load_mlp(mlp_dir)
    _, ev = dataset.split_pairs(want.pairs)
    preds = {}
    for d in (dev, torch.device("cpu")):
        m = copy.deepcopy(model).to(d)
        with torch.inference_mode():
            preds[d.type] = m(torch.from_numpy(ev.feats).to(d)).cpu().numpy()
    eval_err = float(np.abs(preds[dev.type] - preds["cpu"]).max())
    print(f"  loaded MLP over the eval split ({len(ev.child)} pairs): card vs CPU max abs {eval_err:.3g}")
    if eval_err > MLP_EVAL_MAX_ABS or not np.all(np.isfinite(preds[dev.type])):
        raise AssertionError(f"the loaded MLP disagrees on the card: {eval_err} > {MLP_EVAL_MAX_ABS}")
    tr, _ = dataset.split_pairs(want.pairs)
    card_vs_cpu = mlp_cpu_check(cfg.mlp, tr, dev)
    mlp_ev, gnn_ev = res["mlp"]["evaluation"], res["gnn"]["evaluation"]
    numbers = {
        "downloads": INGEST_ROWS, "probes": INGEST_ROWS, "hosts": INGEST_HOSTS, "chunk_rows": INGEST_CHUNK,
        "records_s": records_s, "fold_s": fold_s, "finalize_s": res["build_seconds"],
        "one_shot_build_dataset_s": build_s, "close_to_idle_s": run_s,
        "pairs": res["num_pairs"], "nodes": res["num_nodes"], "edges": int(want.graph.mask.sum()),
        "pool_edges": status["pool_edges"],
        "mlp_train_s": mlp_ev["train_seconds"], "mlp_steps_per_s": res["mlp"]["telemetry"]["steps_per_sec"],
        "mlp_eval_mse": mlp_ev.get("eval_mse"),
        "gnn_train_s": gnn_ev["train_seconds"], "gnn_steps_per_s_with_setup": gnn_ev["steps_per_sec"],
        "gnn_steps_per_s": res["gnn"]["telemetry"]["steps_per_sec"],
        "max_memory_allocated_bytes": peak, "loaded_mlp_eval_max_abs": eval_err, "mlp_card_vs_cpu": card_vs_cpu,
        "telemetry": {m: {k: v for k, v in res[m]["telemetry"].items() if k != "curve"} for m in ("mlp", "gnn")},
        "wall_s": time.perf_counter() - t_phase,
    }
    print(f"  {INGEST_ROWS} downloads + {INGEST_ROWS} probes over {INGEST_HOSTS} hosts: folded in {fold_s:.2f} s, "
          f"finalize {res['build_seconds']:.2f} s (one-shot build_dataset {build_s:.2f} s); {res['num_pairs']} pairs, "
          f"{res['num_nodes']} nodes, {numbers['edges']} edges kept of {numbers['pool_edges']}; MLP "
          f"{mlp_ev['train_seconds']} s, {numbers['mlp_steps_per_s']} steps/s; GNN {gnn_ev['train_seconds']} s, "
          f"{numbers['gnn_steps_per_s']} steps/s; close to idle {run_s:.2f} s; peak device memory "
          f"{peak / 2**30:.2f} GiB; phase {numbers['wall_s']:.1f} s")
    return numbers


def sharded_training(cluster, mesh) -> dict:
    """train_async on the (1, 1) mesh against train_async on the card, from
    the same start and seed."""
    plain_state, plain_losses, plain = train_run(cluster, TRAIN, SHARDED_CALLS)
    want = {k: v.detach().cpu() for k, v in plain_state.model.state_dict().items()}
    del plain_state
    state, losses, sharded = train_run(cluster, TRAIN, SHARDED_CALLS, mesh=mesh)
    got = {k: v.cpu() for k, v in full_state_dict(state.model).items()}
    placed = {type(p).__name__ for p in (*state.optimizer.params, *state.optimizer.mu, *state.optimizer.nu)}
    del state
    loss_err = float(np.abs(np.array(losses) - np.array(plain_losses)).max())
    param_err = max(float((got[k] - want[k]).abs().max()) for k in want)
    rate = {name: n["steps_per_s_after_first_call"][-1] for name, n in (("plain", plain), ("mesh", sharded))}
    print(f"  mesh (1, 1) vs one device, {len(losses)} steps: losses max abs {loss_err:.3g}, parameters max abs "
          f"{param_err:.3g}; second call {rate['mesh']:.2f} steps/s on the mesh against {rate['plain']:.2f} "
          f"({1e3 / rate['mesh'] - 1e3 / rate['plain']:.2f} ms a step more); peak device memory "
          f"{sharded['max_memory_allocated_bytes'] / 2**30:.2f} / {plain['max_memory_allocated_bytes'] / 2**30:.2f} GiB; "
          f"parameters and moments are {placed}")
    if placed != {"DTensor"}:
        raise AssertionError(f"the mesh run's parameters and moments are {placed}, not DTensors")
    if loss_err > TRAIN_LOSS_MAX_ABS or param_err > TRAIN_PARAM_MAX_ABS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"the mesh and one device disagree: loss {loss_err} > {TRAIN_LOSS_MAX_ABS} "
                             f"or parameters {param_err} > {TRAIN_PARAM_MAX_ABS}")
    if loss_err > SHARDED_LOSS_MAX_ABS or param_err > SHARDED_PARAM_MAX_ABS:
        raise AssertionError(f"a world of one parts from one device by more than ordering: loss {loss_err} > "
                             f"{SHARDED_LOSS_MAX_ABS} or parameters {param_err} > {SHARDED_PARAM_MAX_ABS}")
    return {"plain": plain, "mesh": sharded, "loss_max_abs": loss_err, "param_max_abs": param_err}


def mp_train_subprocess() -> dict:
    """mp_train as a one-process NCCL job that joins from DF_DIST_* alone."""
    t0 = time.perf_counter()
    (done,) = dist_lib.launch_localhost(1, "dragonfly2_tpu_torch.parallel.mp_train", local_devices=0,
                                        timeout=MP_TRAIN_DEADLINE_S)
    wall = time.perf_counter() - t0
    lines = done.stdout.splitlines()
    ok = next((line for line in lines if line.startswith("mp_train ok")), "")
    payload = next((line for line in lines if line.startswith("MP_LOSSES ")), None)
    if payload is None or "device=cuda" not in ok:
        raise AssertionError(f"mp_train printed no losses on the card: {done.stdout[-500:]} {done.stderr[-1500:]}")
    losses = json.loads(payload[len("MP_LOSSES "):])
    falls = bool(np.all(np.isfinite(losses)) and np.mean(losses[-3:]) < 0.5 * np.mean(losses[:3]))
    print(f"  {ok}; losses {losses[0]:.5f} -> {losses[-1]:.5f}; {wall:.1f} s with start-up")
    if not falls:
        raise AssertionError(f"mp_train's losses are not finite or did not fall by half: {losses}")
    return {"line": ok, "losses": losses, "wall_s": wall}


def stage_source() -> dict[str, np.ndarray]:
    """The checkpoint to stage, from a seed: bf16 (as uint16 bits) and f32."""
    rng = np.random.default_rng(STAGE_SEED)
    out = {}
    for i, shape in enumerate(STAGE_BF16):
        x = rng.standard_normal(shape, dtype=np.float32) * 0.02
        out[f"layers.{i}.w"] = (x.view(np.uint32) >> 16).astype(np.uint16)
    for i, shape in enumerate(STAGE_F32):
        out[f"f32.{i}"] = rng.standard_normal(shape, dtype=np.float32)
    return out


def staged_bits(t) -> np.ndarray:
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).cpu().numpy()


def stage_on_card(mesh) -> dict:
    """About 1 GiB written as safetensors, staged whole and on the mesh."""
    src = stage_source()
    bf16 = [k for k in src if k.startswith("layers.")]
    nbytes = sum(a.nbytes for a in src.values())
    numbers = {"tensors": len(src), "bytes": nbytes}
    with tempfile.TemporaryDirectory() as tmp:
        path = stlib.write_safetensors(pathlib.Path(tmp) / "checkpoint.safetensors", src, bf16_names=bf16)
        header = stlib.read_header(path)
        placements = {k: meshlib.param_leaf_placements(header[k]["shape"], mesh) for k in src}
        for how, kw in (("whole", {"device": "cuda"}), ("mesh", {"mesh": mesh, "placements": placements})):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            staged = staging.stage_tensors(path, **kw)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            wrong = [k for k, a in src.items()
                     if staged_bits(staged[k]).tobytes() != (a.view(np.int16) if k in bf16 else a).tobytes()]
            kinds = {type(t).__name__ for t in staged.values()}
            del staged
            print(f"  staged {len(src)} tensors ({nbytes / 2**30:.3f} GiB) {how}: {dt:.3f} s, "
                  f"{nbytes / dt / 1e9:.2f} GB/s (host clock, closed by a synchronise); {kinds}; "
                  f"bit-equal to the source: {not wrong}")
            if wrong:
                raise AssertionError(f"staging {how} changed {wrong}")
            numbers[f"{how}_s"], numbers[f"{how}_gb_per_s"] = dt, nbytes / dt / 1e9
    return numbers


def sharded(cluster) -> dict:
    """The sharded trainer in a world of one under NCCL, mp_train in a
    subprocess, and staging onto the card."""
    dist_lib.initialize(dist_lib.DistributedConfig(num_processes=1, local_device_count=0))
    try:
        mesh = meshlib.make_mesh()
        if meshlib.axis_sizes(mesh) != (1, 1) or mesh.device_type != "cuda":
            raise AssertionError(f"a world of one gave the mesh {mesh}")
        numbers = {"training": sharded_training(cluster, mesh), "mp_train": mp_train_subprocess(),
                   "staging": stage_on_card(mesh)}
    finally:
        dist_lib.shutdown()
    return numbers


def host_cpu() -> str:
    """The host CPU's model and core count (the native scorer's device):
    /proc/cpuinfo's model name, else its vendor, family and model numbers
    (a sandboxed kernel may report the name as "unknown")."""
    fields: dict[str, str] = {}
    try:
        for ln in pathlib.Path("/proc/cpuinfo").read_text().splitlines():
            key, sep, value = ln.partition(":")
            if sep:
                fields.setdefault(key.strip(), value.strip())
    except OSError as e:
        print(f"  /proc/cpuinfo unreadable: {e}")
    name = fields.get("model name", "")
    if name in ("", "unknown"):
        name = " ".join(f"{k} {fields[k]}" for k in ("vendor_id", "cpu family", "model") if k in fields)
    return f"{name or platform.machine()}, {os.cpu_count()} cores"


def timed_load(path: str, digest: str, native: bool) -> tuple:
    """load_scorer_verified with DRAGONFLY_NATIVE_SCORER on or off: (scorer,
    host index, seconds)."""
    old = os.environ.get("DRAGONFLY_NATIVE_SCORER")
    os.environ["DRAGONFLY_NATIVE_SCORER"] = "1" if native else "0"
    try:
        t0 = time.perf_counter()
        scorer, hosts = manager_link.load_scorer_verified(path, digest)
        return scorer, hosts, time.perf_counter() - t0
    finally:
        if old is None:
            del os.environ["DRAGONFLY_NATIVE_SCORER"]
        else:
            os.environ["DRAGONFLY_NATIVE_SCORER"] = old


async def wiring_loop(tmp: pathlib.Path, store: TelemetryStorage, hostname: str) -> dict:
    """Records in a port TelemetryStorage → the port's announcer → the port's
    trainer server on the card (TCP) → both models published to a manager
    stub; returns the published rows and the host seconds of each step."""
    downloads, probes = len(store.downloads), len(store.probes)
    published: dict[str, dict] = {}
    both_at = []

    async def publish_model(p: dict) -> dict:
        published[p["type"]] = p
        if {"mlp", "gnn"} <= published.keys() and not both_at:
            both_at.append(time.perf_counter())
        return {"id": len(published), "state": "active", **p}

    stub = RpcServer()
    stub.register("publish_model", publish_model)
    await stub.start()
    cfg = TrainerConfig(model_dir=str(tmp / "models"), gnn_steps=INGEST_GNN_STEPS, gnn_steps_per_call=10)
    server, service = await start_trainer(cfg, port=0, manager_addr=stub.address)
    ann = TrainerAnnouncer(store, server.address, hostname=hostname, scheduler_id=0)
    try:
        t0 = time.perf_counter()
        up = await ann.upload_once()
        closed = time.perf_counter()
        upload_s = closed - t0
        # the run publishes both rows before it ends; _train turns a fault
        # inside it into last_result = {"error": ...}, so name it
        await asyncio.wait_for(service.wait_idle(), WIRING_DEADLINE_S)
        if not both_at:
            raise AssertionError(f"the run published {sorted(published)}, not both models: {service.last_result}")
        close_to_rows_s = both_at[0] - closed
        if up["downloads"] != downloads or up["probes"] != probes:
            raise AssertionError(f"the announcer uploaded {up}, not all {downloads} + {probes} records")
        if len(store.downloads) or len(store.probes):
            raise AssertionError("the uploaded telemetry was not discarded")
    finally:
        await ann.stop()
        await stop_trainer(server, service)
        await stub.stop()
    return {"rows": published, "upload_s": upload_s, "close_to_rows_s": close_to_rows_s, "uploaded": up}


def wiring() -> dict:
    """The control loop of the port on the card, at the ingest phase's widths:
    upload over TCP, train, publish, load the published artifact through the
    model loader (native C++ first, torch on the card as the fallback), and
    serve the same rounds from both; then a corrupt copy must be refused."""
    t_phase = time.perf_counter()
    downloads, probes = synth_telemetry_records(INGEST_ROWS, INGEST_ROWS, INGEST_HOSTS, seed=INGEST_SEED)
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        t0 = time.perf_counter()
        store = TelemetryStorage(tmp / "telemetry")
        store.downloads.extend(downloads)
        store.probes.extend(probes)
        store.flush()
        store_s = time.perf_counter() - t0
        loop = asyncio.run(wiring_loop(tmp, store, "chip-smoke"))
        loop["store_s"] = store_s
        row = loop["rows"]["gnn"]
        path, digest = row["artifact_path"], row["artifact_digest"]
        native, hosts, native_load_s = timed_load(path, digest, native=True)
        if native.engine != "native":
            raise AssertionError(f"the loader served engine {native.engine!r}, not the native scorer")
        torch_scorer, torch_hosts, torch_load_s = timed_load(path, digest, native=False)
        if torch_scorer.engine != "torch" or torch_scorer.device.type != "cuda":
            raise AssertionError(f"the fallback served {torch_scorer.engine!r} on {torch_scorer.device}")
        if hosts != torch_hosts or len(hosts) != native.num_nodes:
            raise AssertionError("the two loads disagree on the host index")
        rng = np.random.default_rng(WIRING_ROUND_SEED)
        n = native.num_nodes
        child = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
        parent = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
        feats = downloads["pair_features"][rng.integers(0, len(downloads), (ROUNDS, CANDIDATES))]
        _, native_scores, native_ms = drive_rounds(native, feats, child, parent)
        drive_rounds(torch_scorer, feats, child, parent)  # the first flushes on the card warm it up
        _, torch_scores, torch_ms = drive_rounds(torch_scorer, feats, child, parent)
        gap = float(np.abs(native_scores - torch_scores).max())
        if gap > SCORE_MAX_ABS:
            raise AssertionError(f"native and torch scores of one artifact differ by {gap} > {SCORE_MAX_ABS}")
        bad = shutil.copytree(path, tmp / "corrupt")
        (bad / "params.msgpack").write_bytes(b"CORRUPTED" + (bad / "params.msgpack").read_bytes()[9:])
        try:
            manager_link.load_scorer_verified(str(bad), digest)
            raise AssertionError("a corrupt artifact loaded")
        except Exception as e:
            kind = manager_link.classify_swap_error(e)
            if kind != "digest_mismatch":
                raise AssertionError(f"a corrupt artifact was classified {kind!r}: {e}") from e
        native.close()
    n_rows = len(downloads) + len(probes)
    numbers = {
        "downloads": len(downloads), "probes": len(probes), "hosts": INGEST_HOSTS, "chunk_rows": CHUNK_ROWS,
        "store_s": loop["store_s"], "upload_s": loop["upload_s"], "upload_rows_per_s": n_rows / loop["upload_s"],
        "close_to_published_s": loop["close_to_rows_s"],
        "native_load_verify_s": native_load_s, "torch_load_verify_s": torch_load_s,
        "native_round_p50_ms": float(np.percentile(native_ms, 50)),
        "native_round_p99_ms": float(np.percentile(native_ms, 99)),
        "torch_round_p50_ms": float(np.percentile(torch_ms, 50)),
        "torch_round_p99_ms": float(np.percentile(torch_ms, 99)),
        "score_max_abs": gap, "host_cpu": host_cpu(), "swap_error_of_corrupt_copy": kind,
        "gnn_evaluation": row["evaluation"], "wall_s": time.perf_counter() - t_phase,
    }
    print(f"  upload of {n_rows} records over TCP in {loop['upload_s']:.2f} s "
          f"({numbers['upload_rows_per_s']:.0f} rows/s; store written in {loop['store_s']:.2f} s); close to both "
          f"rows published {loop['close_to_rows_s']:.2f} s; load + verify native {native_load_s:.3f} s, torch "
          f"{torch_load_s:.3f} s; {ROUNDS} rounds of {CANDIDATES}: native p50/p99 "
          f"{numbers['native_round_p50_ms']:.2f}/{numbers['native_round_p99_ms']:.2f} ms ({numbers['host_cpu']}), "
          f"torch on the card {numbers['torch_round_p50_ms']:.2f}/{numbers['torch_round_p99_ms']:.2f} ms; "
          f"largest score gap {gap:.3g}; corrupt copy: {kind}; phase {numbers['wall_s']:.1f} s")
    return numbers


def device_busy_us(prof) -> float:
    """The card's busy time in a torch.profiler trace: the union of its
    kernel, copy and set spans, so that no span counts twice."""
    with tempfile.TemporaryDirectory() as tmp:
        trace = pathlib.Path(tmp) / "trace.json"
        prof.export_chrome_trace(str(trace))
        events = json.loads(trace.read_text())["traceEvents"]
    spans = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                   if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def round_costs(scorer, feats, child, parent, traced: bool) -> dict:
    """µs of host time a score() call on one fixed round, BUSY_ROUNDS calls
    a window, on the main thread, on a worker thread, and on a worker thread
    fed by STRESS_CONCURRENCY asyncio drivers. With ``traced``, each window
    is run again under torch.profiler: the card's busy time a round, and
    its share of the untraced and of the traced window."""

    def loop(n: int) -> None:
        for _ in range(n):
            scorer.score(feats, child=child, parent=parent)

    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        async def drive():
            ev_loop, done = asyncio.get_running_loop(), 0

            async def driver():
                nonlocal done
                while done < BUSY_ROUNDS:
                    done += 1
                    await ev_loop.run_in_executor(pool, loop, 1)

            await asyncio.gather(*(driver() for _ in range(STRESS_CONCURRENCY)))

        shapes = {"main": lambda: loop(BUSY_ROUNDS),
                  "worker": lambda: pool.submit(loop, BUSY_ROUNDS).result(),
                  "worker_under_loop": lambda: asyncio.run(drive())}
        out = {}
        for name, fn in shapes.items():
            fn()  # warm: the worker thread, the card
            t0 = time.perf_counter()
            fn()
            wall_us = (time.perf_counter() - t0) * 1e6
            row = {"host_us_per_round": wall_us / BUSY_ROUNDS}
            if traced:
                acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
                with torch.profiler.profile(activities=acts) as prof:
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    traced_us = (time.perf_counter() - t0) * 1e6
                busy = device_busy_us(prof)
                if busy <= 0:
                    raise AssertionError(f"the traced {name} window ran nothing on the card")
                row.update(traced_us_per_round=traced_us / BUSY_ROUNDS, device_us_per_round=busy / BUSY_ROUNDS,
                           busy_share_untraced=busy / wall_us, busy_share_traced=busy / traced_us)
            out[name] = row
    return out


def stress_run(native: bool) -> dict:
    """run_scoring_stress at the CLI's defaults, cut in rounds, with
    DRAGONFLY_NATIVE_SCORER on or off; it builds its own artifact on the card."""
    old = os.environ.get("DRAGONFLY_NATIVE_SCORER")
    os.environ["DRAGONFLY_NATIVE_SCORER"] = "1" if native else "0"
    try:
        args = argparse.Namespace(rounds=STRESS_ROUNDS, concurrency=STRESS_CONCURRENCY,
                                  candidates=STRESS_CANDIDATES, hosts=STRESS_HOSTS, device=None,
                                  worker_rounds=None if native else STRESS_TORCH_WORKER_ROUNDS)
        t0 = time.perf_counter()
        out = asyncio.run(dfstress.run_scoring_stress(args))
        out["wall_s"] = time.perf_counter() - t0
        return out
    finally:
        if old is None:
            del os.environ["DRAGONFLY_NATIVE_SCORER"]
        else:
            os.environ["DRAGONFLY_NATIVE_SCORER"] = old


def stress() -> dict:
    """The scoring stress on both engines, after the engines are held
    against each other on fixed rounds and the loader against a faultline."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path, digest, hosts, pair_feats = dfstress.build_scoring_artifact(pathlib.Path(tmp) / "gnn-stress")
        build_s = time.perf_counter() - t0
        path = str(path)
        native, _, native_load_s = timed_load(path, digest, native=True)
        if native.engine != "native":
            raise AssertionError(f"the loader served engine {native.engine!r}, not the native scorer")
        torch_scorer, _, torch_load_s = timed_load(path, digest, native=False)
        if torch_scorer.engine != "torch" or torch_scorer.device.type != "cuda":
            raise AssertionError(f"the fallback served {torch_scorer.engine!r} on {torch_scorer.device}")
        feats, child, parent = dfstress.stress_rounds(
            hosts, pair_feats, hosts=STRESS_HOSTS, concurrency=STRESS_CONCURRENCY, candidates=STRESS_CANDIDATES)
        scores = {}
        for name, scorer in (("native", native), ("torch", torch_scorer)):
            out = scorer.score_rounds(feats, child=child, parent=parent)
            if out.shape != child.shape or not np.all(np.isfinite(out)) or not np.all((out > 0) & (out < 1)):
                raise AssertionError(f"{name} scores of the fixed rounds: shape {out.shape}, "
                                     f"finite {np.isfinite(out).all()}, in (0, 1) {((out > 0) & (out < 1)).all()}")
            scores[name] = out
        gap = float(np.abs(scores["native"] - scores["torch"]).max())
        if gap > SCORE_MAX_ABS:
            raise AssertionError(f"native and torch scores of the stress artifact differ by {gap} > {SCORE_MAX_ABS}")
        costs = {name: round_costs(scorer, feats[0], child[0], parent[0], traced=name == "torch")
                 for name, scorer in (("native", native), ("torch", torch_scorer))}
        native.close()
        fl = faultline.enable("model.load:corrupt:1.0")
        try:
            manager_link.load_scorer_verified(path, digest)
            raise AssertionError("an artifact corrupted in flight loaded")
        except artifacts.ArtifactIntegrityError as e:
            kind = manager_link.classify_swap_error(e)
        finally:
            faultline.disable()
        if kind != "digest_mismatch" or fl.injected_total("model.load") == 0 or faultline.ACTIVE is not None:
            raise AssertionError(f"faultline corrupt load: {kind}, {fl.injected} injected, active {faultline.ACTIVE}")
    runs = {"native": stress_run(native=True), "torch": stress_run(native=False)}
    for name, run in runs.items():
        ex = run["extra"]
        where_ok = ex["device"] == "cpu" if name == "native" else ex["device"].startswith("cuda")
        if ex["engine"] != name or not where_ok:
            raise AssertionError(f"the {name} stress served engine {ex['engine']!r} on {ex['device']}")
        if not 0 < ex["native_flushes"] < ex["native_rounds"] or not run["value"] > 0:
            raise AssertionError(f"the {name} stress: {ex['native_flushes']} flushes for "
                                 f"{ex['native_rounds']} rounds, {run['value']} rounds/s")
    numbers = {
        "nodes": len(hosts), "hosts": STRESS_HOSTS, "candidates": STRESS_CANDIDATES,
        "concurrency": STRESS_CONCURRENCY, "rounds_microbatch": STRESS_ROUNDS,
        "rounds_worker_legs": {"native": STRESS_ROUNDS, "torch": STRESS_TORCH_WORKER_ROUNDS},
        "round_costs": costs,
        "build_s": build_s, "native_load_verify_s": native_load_s, "torch_load_verify_s": torch_load_s,
        "fixed_rounds": len(feats), "score_max_abs": gap, "swap_error_of_corrupt_load": kind,
        "host_cpu": host_cpu(), "runs": runs, "wall_s": time.perf_counter() - t_phase,
    }
    for name, run in runs.items():
        ex = run["extra"]
        print(f"  {name} ({ex['engine']} on {ex['device']}): best {ex['eval_best_config']} {run['value']} "
              f"rounds/s; microbatch {ex['rounds_per_sec_microbatch']}, workers1 {ex['rounds_per_sec_workers1']}, "
              f"workers2 {ex['rounds_per_sec_workers2']}; p50/p99 {ex['eval_p50_ms']}/{ex['eval_p99_ms']} ms; "
              f"{ex['native_flushes']} flushes for {ex['native_rounds']} rounds; score_rounds "
              f"{ex['ffi_us_per_round_amortized']} us a round; run {run['wall_s']:.1f} s")
    print(f"  artifact built on the card in {build_s:.2f} s; load + verify native {native_load_s:.3f} s, "
          f"torch {torch_load_s:.3f} s; {len(feats)} fixed rounds: largest score gap {gap:.3g}; "
          f"corrupt load: {kind}; phase {numbers['wall_s']:.1f} s")
    for name, shapes in costs.items():
        print(f"  {name} score() on one round, us of host time (main / worker / worker under the loop): "
              + " / ".join(f"{c['host_us_per_round']:.1f}" for c in shapes.values())
              + ("; card busy " + " / ".join(f"{c['device_us_per_round']:.1f} us = "
                                            f"{100 * c['busy_share_untraced']:.1f}%" for c in shapes.values())
                 + " of the untraced window" if name == "torch" else ""))
    return numbers


def _record(host_id: str):
    """A child or parent record: with the rows precomputed the evaluator
    reads only .host.id."""
    return types.SimpleNamespace(host=types.SimpleNamespace(id=host_id))


def serving_gauges() -> dict:
    return {m: sched_metrics.ML_SERVING_MODE.labels(mode=m).value for m in SERVING_MODES}


def fallbacks() -> dict:
    return {r: sched_metrics.ML_BASE_FALLBACK_TOTAL.labels(reason=r).value for r in FALLBACK_REASONS}


def evaluator_legs(ev: MLEvaluator, rounds: list, feats: np.ndarray, child: np.ndarray, parent: np.ndarray,
                   want: np.ndarray, tol: float) -> dict:
    """EVAL_REPS repetitions of two legs of EVAL_ROUNDS rounds each, in turn,
    from STRESS_CONCURRENCY drivers cycling over the fixed rounds: ``bare``
    scores the rows through the serving bundle's MicroBatchScorer itself,
    ``evaluator`` goes through ev.evaluate_async, which coalesces in that
    same MicroBatchScorer; both after one warm pass. The medians of each
    leg's rounds/s, the evaluator leg's per-round ms pooled over its
    repetitions, the µs a round the evaluator adds (the difference of the
    medians' round times, both taken in the same stretch of the run) and
    the largest gap of either leg to ``want``, which must be within ``tol``."""
    mb = ev.serving_bundle.microbatch
    legs = {
        "bare": lambda r: mb.score(feats[r], child=child[r], parent=parent[r]),
        "evaluator": lambda r: ev.evaluate_async(*rounds[r]),
    }

    async def measure(fn):
        done, lat, gap = 0, [], 0.0

        async def driver():
            nonlocal done, gap
            while done < EVAL_ROUNDS:
                r = done % len(rounds)
                done += 1
                t1 = time.perf_counter()
                out = await fn(r)
                lat.append(time.perf_counter() - t1)
                gap = max(gap, float(np.abs(out - want[r]).max()))

        t0 = time.perf_counter()
        await asyncio.gather(*(driver() for _ in range(STRESS_CONCURRENCY)))
        return EVAL_ROUNDS / (time.perf_counter() - t0), np.array(lat) * 1e3, gap

    async def drive():
        for fn in legs.values():  # warm: the flusher, the card
            await asyncio.gather(*(fn(r) for r in range(len(rounds))))
        out = {name: [] for name in legs}
        for _rep in range(EVAL_REPS):
            for name, fn in legs.items():
                out[name].append(await measure(fn))
        return out

    runs = asyncio.run(drive())
    gap = max(g for rs in runs.values() for _rps, _ms, g in rs)
    if gap > tol:
        raise AssertionError(f"rounds part from score() by {gap} > {tol}")
    med = {name: float(np.median([rps for rps, _ms, _g in rs])) for name, rs in runs.items()}
    ms = np.concatenate([m for _rps, m, _g in runs["evaluator"]])
    return {"rounds_per_s": med["evaluator"], "bare_rounds_per_s": med["bare"],
            "rates": {name: [rps for rps, _ms, _g in rs] for name, rs in runs.items()},
            "evaluator_us_per_round": 1e6 / med["evaluator"] - 1e6 / med["bare"],
            "p50_ms": float(np.percentile(ms, 50)), "p99_ms": float(np.percentile(ms, 99)),
            "max_abs_to_score": gap}


def evaluator() -> dict:
    """The port's MLEvaluator serving the native scorer, then GNNScorer on
    the card, then the native bundle again; the rows of each round are
    precomputed (see the module docstring)."""
    t_phase = time.perf_counter()
    ev = MLEvaluator()
    if serving_gauges() != {m: float(m == "base") for m in SERVING_MODES}:
        raise AssertionError(f"a new MLEvaluator serves {serving_gauges()}, not base")
    with tempfile.TemporaryDirectory() as tmp:
        path, digest, hosts, pair_feats = dfstress.build_scoring_artifact(pathlib.Path(tmp) / "gnn-stress")
        native, idx, native_load_s = timed_load(str(path), digest, native=True)
        torch_scorer, torch_idx, torch_load_s = timed_load(str(path), digest, native=False)
    if native.engine != "native" or torch_scorer.engine != "torch" or torch_scorer.device.type != "cuda":
        raise AssertionError(f"the loader served {native.engine!r} and {torch_scorer.engine!r} on "
                             f"{torch_scorer.device}, not native and torch on the card")
    feats, child, parent = dfstress.stress_rounds(
        hosts, pair_feats, hosts=STRESS_HOSTS, concurrency=STRESS_CONCURRENCY, candidates=STRESS_CANDIDATES)
    name = {v: k for k, v in idx.items()}
    rounds = [(_record(name[int(child[r, 0])]), [_record(name[int(p)]) for p in parent[r]])
              for r in range(len(feats))]
    rows = {id(kid): feats[r] for r, (kid, _ps) in enumerate(rounds)}
    ev.feature_builder = lambda kid, parents, topology, bandwidth: rows[id(kid)]
    before = fallbacks()
    legs, scores, bundles = {}, {}, {}
    for engine, scorer, index, tol in (("native", native, idx, 0.0), ("torch", torch_scorer, torch_idx, SCORE_MAX_ABS)):
        prev = ev.attach_scorer(scorer, index, microbatch=MicroBatchScorer(scorer), version=f"stress-7-{engine}")
        bundles[engine] = ev.serving_bundle
        if (prev is None) != (engine == "native") or serving_gauges() != {m: float(m == engine) for m in
                                                                           SERVING_MODES}:
            raise AssertionError(f"attaching the {engine} scorer: previous bundle {prev}, gauges {serving_gauges()}")
        want = np.stack([scorer.score(feats[r], child=child[r], parent=parent[r])  # dflint: disable=DF033 one call a round is the reference
                         for r in range(len(feats))])
        one = ev.evaluate(*rounds[0])
        if one.tobytes() != want[0].astype(np.float32).tobytes():
            raise AssertionError(f"{engine}: evaluate() is not score() bit for bit "
                                 f"(max abs {float(np.abs(one - want[0]).max())})")
        legs[engine] = evaluator_legs(ev, rounds, feats, child, parent, want, tol)
        legs[engine]["flushes"] = ev.serving_bundle.microbatch.flushes
        scores[engine] = want
    gap = float(np.abs(scores["native"] - scores["torch"]).max())
    if gap > SCORE_MAX_ABS:
        raise AssertionError(f"the engines part by {gap} > {SCORE_MAX_ABS} through the evaluator")
    if fallbacks() != before:
        raise AssertionError(f"rounds fell back to base: {before} -> {fallbacks()}")
    unknown = (_record("no-such-host"), rounds[0][1])
    rows[id(unknown[0])] = feats[0]
    out = ev.evaluate(*unknown)
    after = fallbacks()
    if (after["unknown_hosts"] != before["unknown_hosts"] + 1 or out.tobytes()
            != (feats[0] @ BASE_WEIGHTS).astype(np.float32).tobytes()):
        raise AssertionError(f"an unknown child host did not fall back to base as unknown_hosts: {after}")
    torch_bundle = ev.swap_bundle(bundles["native"])
    if (torch_bundle is not bundles["torch"] or ev.serving_version != "stress-7-native"
            or serving_gauges() != {m: float(m == "native") for m in SERVING_MODES}
            or ev.evaluate(*rounds[1]).tobytes() != scores["native"][1].astype(np.float32).tobytes()):
        raise AssertionError(f"swap_bundle back to the native bundle: {ev.serving_version}, {serving_gauges()}")
    ev.swap_bundle(None)
    native.close()
    numbers = {
        "nodes": len(hosts), "candidates": feats.shape[1], "concurrency": STRESS_CONCURRENCY,
        "rounds_a_leg": EVAL_ROUNDS, "reps": EVAL_REPS, "legs": legs, "engine_max_abs": gap,
        "native_load_verify_s": native_load_s, "torch_load_verify_s": torch_load_s,
        "host_cpu": host_cpu(), "wall_s": time.perf_counter() - t_phase,
    }
    for e, leg in legs.items():
        print(f"  {e}: {leg['rounds_per_s']:.1f} rounds/s through evaluate_async (median of {EVAL_REPS}), p50/p99 "
              f"{leg['p50_ms']:.3f}/{leg['p99_ms']:.3f} ms, max abs to score() {leg['max_abs_to_score']:.3g}; "
              f"the bare MicroBatchScorer between them {leg['bare_rounds_per_s']:.1f} rounds/s, so the evaluator "
              f"adds {leg['evaluator_us_per_round']:.1f} us a round")
    print(f"  engines part by {gap:.3g}; unknown child host -> base (unknown_hosts); swap back serves native; "
          f"host {numbers['host_cpu']}; phase {numbers['wall_s']:.1f} s")
    return numbers


def sched_hosts() -> list[HostInfo]:
    """The serving cell's SCHED_HOSTS hosts: eight idcs, nested locations, one
    host in 64 a seed host, each with a piece-server port."""
    return [HostInfo(id=f"h{i}", ip=f"10.{i >> 16}.{(i >> 8) & 255}.{i & 255}", hostname=f"host{i}",
                     port=65000, download_port=65002, type="seed" if i % 64 == 0 else "normal",
                     idc=f"idc{i % 8}", location=f"cn|r{i % 4}|z{i % 16}")
            for i in range(SCHED_HOSTS)]


def sched_probes(svc: SchedulerService, hosts: list[HostInfo]) -> int:
    """SCHED_PROBES seeded probe results from every host through
    sync_probes, RTTs from each pair's distance in idc and location; returns
    the targets handed back."""
    rng = np.random.default_rng(SCHED_SEED)
    targets = 0
    for i, h in enumerate(hosts):
        dst = rng.integers(0, len(hosts), SCHED_PROBES)
        jitter = rng.uniform(0.9, 1.1, SCHED_PROBES)
        results = [{"dst_host_id": f"h{int(d)}",
                    "rtt_ms": float(j * (0.3 + 2.0 * (int(d) % 8 != i % 8) + 8.0 * (int(d) % 4 != i % 4))),
                    "success": True} for d, j in zip(dst, jitter)]
        targets += len(svc.sync_probes(h.id, results))
    return targets


class FeatureBuildClock:
    """ns of host time in the feature build, summed over threads: the
    evaluator's _prepare (rows, index lookups) and the native round driver's
    row export (scheduling._export_pair_rows), wrapped on this service's
    evaluator and in the scheduling module until close()."""

    def __init__(self, svc: SchedulerService):
        self.ns = self.calls = 0
        self._lock = threading.Lock()
        self._ev, self._export = svc.evaluator, scheduling._export_pair_rows
        self._ev._prepare = self._timed(self._ev._prepare)
        scheduling._export_pair_rows = self._timed(self._export)

    def _timed(self, fn):
        def run(*args, **kw):
            t0 = time.perf_counter_ns()
            try:
                return fn(*args, **kw)
            finally:
                dt = time.perf_counter_ns() - t0
                with self._lock:
                    self.ns += dt
                    self.calls += 1
        return run

    def take(self) -> tuple[int, int]:
        with self._lock:
            out, self.ns, self.calls = (self.ns, self.calls), 0, 0
        return out

    def close(self) -> None:
        del self._ev._prepare
        scheduling._export_pair_rows = self._export


async def sched_wave(svc: SchedulerService, hosts: list[HostInfo], tag: str, tasks: int) -> dict:
    """One wave on fresh task ids: ``tasks`` tasks of SCHED_PEERS peers on
    seeded hosts, driven by SCHED_DRIVERS concurrent drivers, each task's
    peers in turn. The first peer of a task goes back to source; every later
    registration is one scheduling round, whose parents serve its
    SCHED_PIECES pieces, reported with its result in one report_batch.
    Returns the register-to-parents seconds (host clock) and the counts."""
    lat: list[float] = []
    counts = {"back_to_source": 0, "parentless": 0}
    length = SCHED_PIECES * (4 << 20)

    async def drive(task_ids) -> None:
        for t in task_ids:
            meta = TaskMeta(task_id=f"{tag}-{t:04d}", url=f"http://origin.example/{tag}/{t}")
            picks = np.random.default_rng([SCHED_SEED, t]).choice(len(hosts), SCHED_PEERS, replace=False)
            for j, h in enumerate(picks):
                pid = f"{tag}-{t}-{j}"
                t0 = time.perf_counter()
                r = await svc.register_peer(pid, meta, hosts[h])  # dflint: disable=DF025 one registration is one scheduling round: the wave's unit of work
                dt = time.perf_counter() - t0
                bw = {"success": True, "bandwidth_bps": 5e7 + 1e6 * (int(h) % 512)}
                if r.back_to_source:
                    counts["back_to_source"] += 1
                    svc.report_task_metadata(meta.task_id, content_length=length, piece_size=4 << 20)
                    svc.report_batch(pid, [(i, 20.0, "") for i in range(SCHED_PIECES)], bw)
                    continue
                if not r.parents:
                    counts["parentless"] += 1
                    continue
                lat.append(dt)
                ps = [p.peer_id for p in r.parents]
                svc.report_batch(pid, [(i, 2.0 + (7 * i + j) % 40, ps[i % len(ps)]) for i in range(SCHED_PIECES)], bw)

    t0 = time.perf_counter()
    await asyncio.gather(*(drive(range(d, tasks, SCHED_DRIVERS)) for d in range(SCHED_DRIVERS)))
    wall = time.perf_counter() - t0
    rounds = len(lat) + counts["parentless"] + counts["back_to_source"] - tasks
    if counts["back_to_source"] != tasks or counts["parentless"]:
        raise AssertionError(f"wave {tag}: {counts} over {tasks} tasks (one back-to-source peer a task, "
                             "and a parent for every later one)")
    ms = np.array(lat) * 1e3
    return {"tasks": tasks, "rounds": rounds, "wall_s": wall, "rounds_per_s": rounds / wall,
            "register_to_parents_p50_ms": float(np.percentile(ms, 50)),
            "register_to_parents_p99_ms": float(np.percentile(ms, 99))}


def rescored_gap(scorer, record: dict, index: dict) -> float:
    """The largest gap between a decision record's scores and ``scorer``'s
    on the record's own rows and node rows."""
    feats = np.asarray(record["feats"], np.float32)
    child = np.full(len(feats), index[record["child_host"]], np.int32)
    parent = np.array([index[q["host"]] for q in record["parents"]], np.int32)
    return float(np.abs(scorer.score(feats, child=child, parent=parent) - np.asarray(record["scores"])).max())


def attach_engine(svc: SchedulerService, scorer, index: dict, workers: int, version: str) -> None:
    """Serve ``scorer`` as a scheduler's ManagerLink installs it: a
    MicroBatchScorer always, a ScorerHandlePool under the dispatcher for a
    scorer that forks; the dispatcher set to ``workers`` (0: none)."""
    sched = svc.scheduling
    if workers:
        sched.attach_dispatcher(workers)
    else:
        sched.close()
    pool = ScorerHandlePool(scorer) if workers and hasattr(scorer, "fork") else None
    svc.evaluator.attach_scorer(scorer, index, microbatch=MicroBatchScorer(scorer), handle_pool=pool,
                                version=version)


def scheduler_phase() -> dict:
    """The port's scheduler in process on the card's host: a base wave, the
    loop from its own records to an attached model, then the ML waves (see
    the module docstring)."""
    t_phase = time.perf_counter()
    ev = MLEvaluator()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        svc = SchedulerService(evaluator=ev, telemetry=TelemetryStorage(tmp / "telemetry"))
        clock = FeatureBuildClock(svc)
        try:
            numbers = asyncio.run(scheduler_run(svc, tmp, clock))
        finally:
            clock.close()
            svc.close()
    numbers["host_cpu"] = host_cpu()
    numbers["wall_s"] = time.perf_counter() - t_phase
    return numbers


async def scheduler_run(svc: SchedulerService, tmp: pathlib.Path, clock: FeatureBuildClock) -> dict:
    hosts = sched_hosts()
    t0 = time.perf_counter()
    for h in hosts:
        svc.announce_host(h)
    targets = sched_probes(svc, hosts)
    setup_s = time.perf_counter() - t0
    waves: dict[str, dict] = {}

    def mirror_stats() -> dict:
        m = svc.scheduling._mirror
        return m.stats() if m is not None else {}

    async def wave(name: str, tasks: int = SCHED_TASKS) -> dict:
        sched = svc.scheduling
        before, native0, mirror0, stale0, m0 = (fallbacks(), sched.native_rounds_served,
                                                sched.mirror_rounds_served, sched.mirror_stale_rounds,
                                                mirror_stats())
        clock.take()
        out = await sched_wave(svc, hosts, name, tasks)
        ns, calls = clock.take()
        after, m1 = fallbacks(), mirror_stats()
        out.update(feature_build_us_per_round=ns / 1e3 / out["rounds"], feature_build_calls=calls,
                   base_fallbacks={r: after[r] - before[r] for r in FALLBACK_REASONS},
                   native_rounds=sched.native_rounds_served - native0,
                   mirror_rounds=sched.mirror_rounds_served - mirror0,
                   mirror_stale_rounds=sched.mirror_stale_rounds - stale0,
                   mirror_drives=m1.get("drives", 0) - m0.get("drives", 0),
                   dispatch_workers=sched.dispatcher.workers if sched.dispatcher else 0,
                   serving=serving_gauges())
        waves[name] = out
        print(f"  wave {name}: {out['rounds']} rounds in {out['wall_s']:.2f} s, {out['rounds_per_s']:.1f} rounds/s, "
              f"register to parents p50/p99 {out['register_to_parents_p50_ms']:.3f}/"
              f"{out['register_to_parents_p99_ms']:.3f} ms, feature build {out['feature_build_us_per_round']:.1f} us "
              f"a round, base fallbacks {out['base_fallbacks']}, native {out['native_rounds']}, mirror drives "
              f"{out['mirror_drives']} (rounds native {out['mirror_rounds']}, stale {out['mirror_stale_rounds']})")
        return out

    base = await wave("base")
    if base["base_fallbacks"]["no_scorer"] != base["rounds"]:
        raise AssertionError(f"the base wave: {base['base_fallbacks']} for {base['rounds']} rounds")
    records = {"downloads": len(svc.telemetry.downloads), "probes": len(svc.telemetry.probes)}
    loop = await wiring_loop(tmp, svc.telemetry, "chip-smoke-scheduler")
    row = loop["rows"]["gnn"]
    path, digest = row["artifact_path"], row["artifact_digest"]
    native, index, native_load_s = timed_load(path, digest, native=True)
    torch_scorer, torch_index, torch_load_s = timed_load(path, digest, native=False)
    if native.engine != "native" or torch_scorer.engine != "torch" or torch_scorer.device.type != "cuda":
        raise AssertionError(f"the loader served {native.engine!r} and {torch_scorer.engine!r} on "
                             f"{torch_scorer.device}, not native and torch on the card")
    if index != torch_index:
        raise AssertionError("the two loads disagree on the host index")
    attach = {}
    for name, scorer, workers in (("torch", torch_scorer, 0), ("torch_dispatch2", torch_scorer, 2),
                                  ("native", native, 0), ("native_dispatch2", native, 2),
                                  ("native_mirror", native, 2)):
        t0 = time.perf_counter()
        attach_engine(svc, scorer, index, workers, version=row["version"])
        if name == "native_mirror" and svc.enable_native_mirror() is None:
            raise AssertionError("the native bundle enabled no mirror")
        attach[name] = time.perf_counter() - t0
        engine = name.split("_")[0]
        if serving_gauges() != {m: float(m == engine) for m in SERVING_MODES}:
            raise AssertionError(f"attaching {name}: gauges {serving_gauges()}")
        out = await wave(name)
        fell = out["base_fallbacks"]
        if fell["no_scorer"] or fell["scorer_error"] or fell["degraded"]:
            raise AssertionError(f"wave {name}: rounds fell back to base {fell}")
        if name == "native_dispatch2" and not out["native_rounds"]:
            raise AssertionError(f"wave {name}: no round went through the native round driver")
        if name == "native_mirror" and not (out["mirror_drives"] and out["mirror_rounds"] + out["mirror_stale_rounds"]):
            raise AssertionError(f"the mirror wave: {out['mirror_drives']} mirror drives, "
                                 f"{out['mirror_rounds']} + {out['mirror_stale_rounds']} rounds sampled there")
        if name.startswith("torch"):
            # the torch rounds' decision records, rescored natively
            recs = [r for r in svc.decisions.snapshot(limit=1 << 20) if r["serving_mode"] == "torch"]
            gap = max((rescored_gap(native, r, index) for r in recs), default=0.0)
            if not recs or gap > SCORE_MAX_ABS:
                raise AssertionError(f"wave {name}: {len(recs)} decision records, torch vs native {gap}")
            out.update(decision_records=len(recs), torch_vs_native_max_abs=gap)
    # the card's busy share over a traced torch wave on fresh task ids
    attach_engine(svc, torch_scorer, index, 0, version=row["version"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        traced = await sched_wave(svc, hosts, "traced", SCHED_TRACED_TASKS)
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6
    busy = device_busy_us(prof)
    if busy <= 0:
        raise AssertionError("the traced torch wave ran nothing on the card")
    traced.update(device_us_per_round=busy / traced["rounds"], busy_share=busy / traced_us)
    svc.evaluator.swap_bundle(None)
    native.close()
    print(f"  {SCHED_HOSTS} hosts announced and {targets} probe targets handed out in {setup_s:.2f} s; "
          f"records {records}; upload {loop['upload_s']:.2f} s, close to both rows published "
          f"{loop['close_to_rows_s']:.2f} s; load + verify native {native_load_s:.3f} s, torch "
          f"{torch_load_s:.3f} s; traced torch wave: {traced['rounds']} rounds, card busy "
          f"{traced['device_us_per_round']:.1f} us a round = {100 * traced['busy_share']:.1f}% of the window")
    return {"hosts": SCHED_HOSTS, "tasks": SCHED_TASKS, "peers_per_task": SCHED_PEERS, "setup_s": setup_s,
            "probe_targets": targets, "records": records, "upload_s": loop["upload_s"],
            "close_to_published_s": loop["close_to_rows_s"], "native_load_verify_s": native_load_s,
            "torch_load_verify_s": torch_load_s, "attach_s": attach, "waves": waves, "traced_torch_wave": traced,
            "gnn_evaluation": row["evaluation"]}


def swarm() -> dict:
    """The port's run_swarm over two of the port's scheduler processes."""
    t_phase = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    procs, logs = [], []
    with tempfile.TemporaryDirectory() as tmp:
        try:
            deadline = time.monotonic() + SWARM_BOOT_S
            for i in range(SWARM_SCHEDULERS):
                logs.append(pathlib.Path(tmp) / f"scheduler-{i}.log")
                with open(logs[-1], "w") as err:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "dragonfly2_tpu_torch.scheduler.server", "--host", "127.0.0.1",
                         "--port", "0", "--evaluator", "ml"],
                        cwd=tmp, env=env, stdout=subprocess.PIPE, stderr=err, text=True))
            addrs = [proc_lib.ready_address(proc, "SCHEDULER_READY", deadline) for proc in procs]
            boot_s = time.perf_counter() - t_phase
            run = asyncio.run(dfstress.run_swarm(addrs, duration=SWARM_DURATION_S))
        finally:
            for proc in procs:
                proc.terminate()
            for proc in procs:
                try:
                    proc.wait(timeout=10)
                except subprocess.TimeoutExpired:
                    proc.kill()
                    proc.wait()
                proc.stdout.close()
        texts = [log.read_text() for log in logs]
    ex = run["extra"]
    ring = ConsistentHashRing(addrs)
    owned = [ring.pick(f"swarm-task-{j:04d}") for j in range(SWARM_TASKS)]
    predicted = {a: owned.count(a) / SWARM_TASKS for a in addrs}
    share = ex["per_scheduler_round_share"]
    line = "WARNING dragonfly2_tpu_torch.scheduler.evaluator ml evaluator serving mode: base"
    if ex["errors"] or not ex["rounds"] > 0:
        raise AssertionError(f"the swarm: {ex['errors']} errors in {ex['rounds']} rounds")
    if any(not 0 < share[a] or abs(share[a] - predicted[a]) > SWARM_SHARE_TOL for a in addrs):
        raise AssertionError(f"round shares {share} against the ring's {predicted} (tolerance {SWARM_SHARE_TOL})")
    if not all(line in text for text in texts):
        raise AssertionError("a scheduler's log lacks the port evaluator's serving-mode line: "
                             + " | ".join(text[-800:] for text in texts))
    numbers = {"schedulers": addrs, "boot_s": boot_s, "run": run, "ring_share": predicted,
               "host_cpu": host_cpu(), "wall_s": time.perf_counter() - t_phase}
    print(f"  {run['value']} rounds/s over {len(addrs)} schedulers ({ex['peers']} peers, {ex['tasks']} tasks, "
          f"{ex['pieces_per_round']} pieces, {ex['elapsed_s']} s), {ex['rounds']} rounds, {ex['errors']} errors; "
          f"p50/p99 {ex['p50_ms']}/{ex['p99_ms']} ms; round shares {share} (ring {predicted}); rpc shares "
          f"{ex['per_scheduler_rpc_share']}; both of the port's schedulers booted in {boot_s:.1f} s; host "
          f"{numbers['host_cpu']}; phase {numbers['wall_s']:.1f} s")
    return numbers


class TamperedScorer:
    """A card GNNScorer the rollout phase breaks on purpose, as
    tests/test_rollout.py's VersionScorer does: ``negate`` turns every score
    around (a broken head, for the shadow gate to reject); once ``armed``,
    every round raises (v4, for the health window to roll back)."""

    def __init__(self, inner, *, negate: bool = False):
        self.inner = inner
        self.negate = negate
        self.armed = False

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _scored(self, method: str, args, kw):
        if self.armed:
            raise RuntimeError("injected scorer failure after the swap")
        out = getattr(self.inner, method)(*args, **kw)
        return -out if self.negate else out

    def score(self, *args, **kw):
        return self._scored("score", args, kw)

    def score_rounds(self, *args, **kw):
        return self._scored("score_rounds", args, kw)


def swap_counts() -> dict:
    return {r: sched_metrics.MODEL_SWAP_TOTAL.labels(result=r).value for r in SWAP_RESULTS}


def card_mib() -> float:
    torch.cuda.synchronize()
    return torch.cuda.memory_allocated() / 2**20


async def rollout_train(store: TelemetryStorage, trainer_addr: str, service, hostname: str) -> dict:
    """The store's records through the port's announcer to the port's
    trainer, which publishes to the port's manager; the GNN run's result."""
    ann = TrainerAnnouncer(store, trainer_addr, hostname=hostname, scheduler_id=0)
    try:
        await ann.upload_once()
        await asyncio.wait_for(service.wait_idle(), WIRING_DEADLINE_S)
    finally:
        await ann.stop()
    gnn = (service.last_result or {}).get("gnn")
    if not gnn:
        raise AssertionError(f"the training run published no GNN: {service.last_result}")
    return {**gnn, "version": service.last_result["version"]}


async def rollout_inproc(tmp: pathlib.Path) -> dict:
    """Leg (a): the port's ManagerServer, SchedulerService and ManagerLink in
    one loop, the link ticked by hand (see the module docstring)."""
    from dragonfly2_tpu_torch.manager.server import ManagerServer
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
    from dragonfly2_tpu_torch.scheduler.manager_link import ManagerLink
    from dragonfly2_tpu_torch.scheduler.rollout import HealthGates

    steps: dict[str, dict] = {}
    t_step = [time.perf_counter()]

    def step(name: str, **numbers) -> None:
        now = time.perf_counter()
        numbers.update(seconds=now - t_step[0], card_mib=card_mib(), swaps=swap_counts(),
                       serving=ev.serving_version, candidate=ev.candidate_version)
        t_step[0] = now
        steps[name] = numbers
        print(f"  {name}: {numbers['seconds']:.2f} s, serving {numbers['serving']!r}, candidate "
              f"{numbers['candidate']!r}, card {numbers['card_mib']:.1f} MiB allocated, swaps "
              f"{ {k: v for k, v in numbers['swaps'].items() if v} }" + "".join(
                  f", {k} {v}" for k, v in numbers.items()
                  if k not in ("seconds", "card_mib", "swaps", "serving", "candidate")))

    db = str(tmp / "manager.db")
    manager = ManagerServer(db_path=db)
    await manager.start()
    mport = int(manager.address.rsplit(":", 1)[1])
    mc = RemoteManagerClient(manager.address)
    ev = MLEvaluator()
    svc = SchedulerService(evaluator=ev, telemetry=TelemetryStorage(tmp / "telemetry"))
    link = ManagerLink(svc, manager.address, hostname="chip-smoke-rollout", ip="127.0.0.1", port=1,
                       keepalive_interval=ROLL_KEEPALIVE_S, shadow_sample_rate=1.0, health_gates=HealthGates())
    loads: list[str] = []
    # artifact path -> the TamperedScorer options its load is wrapped with,
    # then the wrapper itself once loaded
    tampered: dict[str, dict | TamperedScorer] = {}

    def loader(path: str, digest: str = ""):
        # the link's own loader, counted; a tampered version comes back wrapped
        loads.append(path)
        scorer, index = manager_link.load_scorer_verified(path, digest)
        if path in tampered:
            tampered[path] = scorer = TamperedScorer(scorer, **tampered[path])
        return scorer, index

    link._load_scorer_verified = loader
    cfg = TrainerConfig(model_dir=str(tmp / "models"), gnn_steps=INGEST_GNN_STEPS, gnn_steps_per_call=10)
    trainer, tsvc = await start_trainer(cfg, port=0, manager_addr=manager.address)
    hosts = sched_hosts()
    waves: dict[str, dict] = {}

    async def wave(name: str) -> dict:
        before = fallbacks()
        out = await sched_wave(svc, hosts, f"roll-{name}", ROLL_TASKS)
        after = fallbacks()
        out["base_fallbacks"] = {r: after[r] - before[r] for r in FALLBACK_REASONS}
        out["serving"] = serving_gauges()
        waves[name] = out
        print(f"    wave {name}: {out['rounds']} rounds, {out['rounds_per_s']:.1f} rounds/s, register to parents "
              f"p50/p99 {out['register_to_parents_p50_ms']:.3f}/{out['register_to_parents_p99_ms']:.3f} ms, "
              f"base fallbacks {out['base_fallbacks']}")
        return out

    def fixed_round() -> np.ndarray:
        bundle = ev.serving_bundle
        rng = np.random.default_rng(ROLL_FIXED_SEED)
        n = len(bundle.node_index)
        feats = rng.random((CANDIDATES, FEATURE_DIM), dtype=np.float32)
        child = np.full(CANDIDATES, int(rng.integers(0, n)), np.int32)
        parent = rng.integers(0, n, CANDIDATES, dtype=np.int32)
        return bundle.scorer.score(feats, child=child, parent=parent)

    async def registry(version: str) -> dict:
        return (await mc.list_models(type="gnn", version=version))[0]

    try:
        t0 = time.perf_counter()
        for h in hosts:
            svc.announce_host(h)
        targets = sched_probes(svc, hosts)
        row = await link.manager.update_scheduler(link.hostname, link.ip, link.port)
        link.scheduler_id, link.cluster_id = row["id"], row["scheduler_cluster_id"]
        await link.dynconfig.load()
        step("setup", hosts=len(hosts), probe_targets=targets, card_before_models_mib=card_mib())
        base = await wave("base")
        if base["base_fallbacks"]["no_scorer"] != base["rounds"]:
            raise AssertionError(f"the base wave: {base['base_fallbacks']} for {base['rounds']} rounds")

        # 1. ungated: v1 activates at publish, one tick installs it
        v1 = await rollout_train(svc.telemetry, trainer.address, tsvc, "chip-smoke-rollout")
        swaps0 = swap_counts()
        await link._check_model()
        if ev.serving_version != v1["version"] or swap_counts()["ok"] != swaps0["ok"] + 1:
            raise AssertionError(f"v1 not installed: serving {ev.serving_version!r}, swaps {swap_counts()}")
        if serving_gauges() != {m: float(m == "torch") for m in SERVING_MODES}:
            raise AssertionError(f"v1 serves as {serving_gauges()}, not torch")
        served = await wave("v1")
        if served["base_fallbacks"]["no_scorer"] or served["base_fallbacks"]["scorer_error"]:
            raise AssertionError(f"the v1 wave fell back to base: {served['base_fallbacks']}")
        step("ungated", v1=v1["version"], loads=len(loads))

        # 2. gated: v2 from a second run is published as a candidate,
        # shadow-scored on a wave at sample rate 1.0, promoted and swapped in
        # by the fast path (no second load)
        await mc.set_config("model_rollout", {"enabled": True, "types": ["gnn"], "auto_promote": True,
                                              "gates": ROLL_GATES})
        v2 = await rollout_train(svc.telemetry, trainer.address, tsvc, "chip-smoke-rollout")
        if (await registry(v2["version"]))["state"] != "candidate":
            raise AssertionError(f"v2 registered as {(await registry(v2['version']))['state']}, not candidate")
        await link._check_model()
        if ev.candidate_version != v2["version"]:
            raise AssertionError(f"v2 not attached as the candidate: {ev.candidate_version!r}")
        loads_at_attach = len(loads)
        step("candidate attached", v2=v2["version"], loads=loads_at_attach)
        await wave("shadow v2")
        await link._check_model()
        agg = (await registry(v2["version"]))["rollout"].get("aggregate", {})
        divergence = {k: agg.get(k) for k in ("rounds", "uncovered", "errors", "topk_overlap_mean",
                                              "rank_corr_mean", "abs_delta_mean", "abs_delta_p99")}
        if ev.serving_version != v2["version"] or len(loads) != loads_at_attach:
            raise AssertionError(f"v2 not promoted by the fast path: serving {ev.serving_version!r}, "
                                 f"loads {len(loads)} (at attach {loads_at_attach}), shadow {divergence}")
        v2_scores = fixed_round()
        step("promoted", divergence=divergence, loads=len(loads))

        # 3. a corrupt copy of v2's artifact under v2's digest: refused as
        # digest_mismatch, rejected in the registry, nothing attached
        bad = shutil.copytree(v2["artifact"], tmp / "v3-corrupt")
        (bad / "params.msgpack").write_bytes(b"CORRUPTED" + (bad / "params.msgpack").read_bytes()[9:])
        before = swap_counts()
        await mc.publish_model("gnn", "v3-corrupt", artifact_path=str(bad), artifact_digest=v2["digest"])
        await link._check_model()
        state3 = (await registry("v3-corrupt"))["state"]
        if swap_counts()["digest_mismatch"] != before["digest_mismatch"] + 1 or state3 != "rejected" \
                or ev.candidate_version or ev.serving_version != v2["version"]:
            raise AssertionError(f"the corrupt candidate: swaps {swap_counts()}, registry {state3}, "
                                 f"candidate {ev.candidate_version!r}, serving {ev.serving_version!r}")
        step("corrupt refused", registry=state3)

        # 3b. the default DivergenceGates: v2's artifact copied and wrapped to
        # negate every score (a broken head) shadows a wave and the gate
        # rejects it; the slot empties and v2 serves on
        await mc.set_config("model_rollout", {"enabled": True, "types": ["gnn"], "auto_promote": True})
        inverted_path = str(shutil.copytree(v2["artifact"], tmp / "v3b-inverted"))
        tampered[inverted_path] = {"negate": True}
        await mc.publish_model("gnn", "v3b-inverted", artifact_path=inverted_path, artifact_digest=v2["digest"])
        await link._check_model()
        if ev.candidate_version != "v3b-inverted":
            raise AssertionError(f"the inverted candidate not attached: {ev.candidate_version!r}")
        await wave("shadow inverted")
        await link._check_model()
        row3b = await registry("v3b-inverted")
        agg = row3b["rollout"].get("aggregate", {})
        divergence3b = {k: agg.get(k) for k in ("rounds", "uncovered", "errors", "topk_overlap_mean",
                                                "rank_corr_mean", "abs_delta_mean", "abs_delta_p99")}
        reasons3b = row3b["rollout"].get("rejected_reason", "")
        link._drain_retired()
        if row3b["state"] != "rejected" or not reasons3b or ev.candidate_version \
                or ev.serving_version != v2["version"]:
            raise AssertionError(f"the gate kept the inverted candidate: registry {row3b['state']} "
                                 f"({reasons3b!r}), candidate {ev.candidate_version!r}, serving "
                                 f"{ev.serving_version!r}, shadow {divergence3b}")
        step("gate rejected", divergence=divergence3b, reasons=reasons3b, draining=len(link._draining))

        # 4. v4 (v2's artifact copied) shadows clean, promotes, then raises on
        # every round: the health window rolls back to the warm v2
        v4_path = str(shutil.copytree(v2["artifact"], tmp / "v4-raising"))
        tampered[v4_path] = {}
        await mc.publish_model("gnn", "v4-raising", artifact_path=v4_path, artifact_digest=v2["digest"])
        await link._check_model()
        await wave("shadow v4")
        rollbacks = sched_metrics.MODEL_ROLLBACK_TOTAL.value
        await link._check_model()
        agg = (await registry("v4-raising"))["rollout"].get("aggregate", {})
        divergence4 = {k: agg.get(k) for k in ("rounds", "uncovered", "errors", "topk_overlap_mean",
                                               "rank_corr_mean", "abs_delta_mean", "abs_delta_p99")}
        if ev.serving_version != "v4-raising" or link._warm_prev is None \
                or link._warm_prev.version != v2["version"]:
            raise AssertionError(f"v4 not swapped in over a warm v2: serving {ev.serving_version!r}")
        step("v4 promoted", divergence=divergence4, warm_previous=link._warm_prev.version)
        tampered[v4_path].armed = True
        regressed = await wave("v4 raising")
        if regressed["base_fallbacks"]["scorer_error"] != regressed["rounds"]:
            raise AssertionError(f"the raising wave: {regressed['base_fallbacks']}")
        await link._check_model()
        reg2, reg4 = (await registry(v2["version"]))["state"], (await registry("v4-raising"))["state"]
        after_scores = fixed_round()
        if ev.serving_version != v2["version"] or reg2 != "active" or reg4 != "rejected" \
                or sched_metrics.MODEL_ROLLBACK_TOTAL.value != rollbacks + 1:
            raise AssertionError(f"no rollback: serving {ev.serving_version!r}, registry v2 {reg2}, v4 {reg4}")
        if after_scores.tobytes() != v2_scores.tobytes():
            raise AssertionError("v2's scores changed across the rollback")
        link._drain_retired()
        step("rolled back", registry={"v2": reg2, "v4": reg4}, draining=len(link._draining))

        # 5. outage: the manager stops; two failed keepalives declare it, the
        # watch freezes and rounds still score on v2; it restarts on the same
        # port and database and the link rejoins
        await manager.stop()
        kept = ev.serving_bundle
        ok = [await link.keepalive_once() for _ in range(2)]
        if any(ok) or not link.manager_unreachable or sched_metrics.MANAGER_UNREACHABLE.value != 1.0:
            raise AssertionError(f"the outage was not declared: keepalives {ok}")
        try:
            await link._check_model()
            frozen = False
        except Exception:  # the registry is unreachable: the tick raises, deciding nothing
            frozen = True
        if not frozen or ev.serving_bundle is not kept:
            raise AssertionError("the serving bundle changed in the outage")
        dark = await wave("outage")
        if any(dark["base_fallbacks"][r] for r in ("no_scorer", "scorer_error", "degraded")):
            raise AssertionError(f"the outage wave fell back to base: {dark['base_fallbacks']}")
        manager = ManagerServer(db_path=db, port=mport)
        await manager.start()
        deadline = time.monotonic() + ROLL_REJOIN_S
        while not await link.keepalive_once():
            if time.monotonic() > deadline:
                raise AssertionError("the link did not rejoin the restarted manager")
            await asyncio.sleep(0.5)
        await link._check_model()
        if link.manager_unreachable or ev.serving_version != v2["version"]:
            raise AssertionError(f"after the rejoin: unreachable {link.manager_unreachable}, "
                                 f"serving {ev.serving_version!r}")
        step("outage and rejoin", rounds_scored_in_outage=dark["rounds"])

        # dfml train through the port's CLI against this leg's trainer: both
        # runs, trained on the card, listed with their GNN
        rc, text = await asyncio.to_thread(cli_call, dfml.main, ["train", "--trainer", trainer.address, "--json"])
        runs = {r["run_id"]: r for r in json.loads(text)["runs"]} if rc == 0 else {}
        listed = {v: runs.get(v, {}).get("status") for v in (v1["version"], v2["version"])}
        if rc or any(s != "ok" or "gnn" not in runs[v]["models"] for v, s in listed.items()):
            raise AssertionError(f"dfml train exited {rc}, listing {listed}")
        step("dfml train", runs=len(runs), gnn_steps={v: runs[v]["models"]["gnn"]["steps"] for v in listed})
        return {"steps": steps, "waves": waves, "loads": len(loads), "v1": v1["version"], "v2": v2["version"],
                "shadow_divergence": divergence, "artifact": v2["artifact"], "digest": v2["digest"]}
    finally:
        await stop_trainer(trainer, tsvc)
        await link.stop()
        await mc.close()
        await manager.stop()
        svc.close()


def rollout_processes(tmp: pathlib.Path, artifact: str, digest: str) -> dict:
    """Leg (b): the port's manager and two of the port's schedulers as
    processes, one serving on the card and one natively; v2's artifact
    published ungated; frames, a swarm and federation both ways."""
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient
    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

    t_leg = time.perf_counter()
    env = {**os.environ, "PYTHONPATH": str(REPO), "DRAGONFLY_TS_INTERVAL": "0.5"}
    procs: list[subprocess.Popen] = []
    logs: list[pathlib.Path] = []

    def spawn(name: str, args: list[str], extra_env: dict) -> subprocess.Popen:
        logs.append(tmp / f"{name}.log")
        with open(logs[-1], "w") as err:
            procs.append(subprocess.Popen([sys.executable, "-m", *args], cwd=tmp, env={**env, **extra_env},
                                          stdout=subprocess.PIPE, stderr=err, text=True))
        return procs[-1]

    try:
        deadline = time.monotonic() + ROLL_BOOT_S
        mgr = spawn("manager", ["dragonfly2_tpu_torch.manager.server", "--host", "127.0.0.1", "--port", "0",
                                "--db", str(tmp / "manager.db")], {})
        maddr = proc_lib.ready_address(mgr, "manager ready", deadline).removeprefix("rpc=")
        flags = ["--host", "127.0.0.1", "--port", "0", "--evaluator", "ml", "--manager", maddr,
                 "--federation-peers", "auto", "--keepalive-interval", "1", "--model-watch-interval", "1",
                 "--federation-interval", "1"]
        engines = {"sch-torch": {"DRAGONFLY_NATIVE_SCORER": "0"}, "sch-native": {"DRAGONFLY_NATIVE_SCORER": "1"}}
        scheds = {name: spawn(name, ["dragonfly2_tpu_torch.scheduler.server", *flags, "--hostname", name], e)
                  for name, e in engines.items()}
        addrs = {name: proc_lib.ready_address(p, "SCHEDULER_READY", deadline) for name, p in scheds.items()}
        boot_s = time.perf_counter() - t_leg

        async def drive() -> dict:
            mc = RemoteManagerClient(maddr)
            out: dict = {}
            try:
                t0 = time.perf_counter()
                row = await mc.publish_model("gnn", "v-proc", artifact_path=artifact, artifact_digest=digest)
                if row["state"] != "active":
                    raise AssertionError(f"the ungated publish left {row['state']}")
                want = {"sch-torch": "torch", "sch-native": "native"}
                end = time.monotonic() + ROLL_ATTACH_S
                while True:
                    view = await mc.cluster_stats()
                    modes = {m["hostname"]: m["frame"].get("serving_mode") for m in view["members"]}
                    if all(modes.get(k) == v for k, v in want.items()):
                        break
                    if time.monotonic() > end:
                        raise AssertionError(f"frames by the deadline: {modes}")
                    await asyncio.sleep(0.25)
                out["published_to_both_frames_s"] = time.perf_counter() - t0
                out["frames"] = {m["hostname"]: m["frame"] for m in view["members"]}
                out["swarm"] = await dfstress.run_swarm(list(addrs.values()), duration=SWARM_DURATION_S)
                if out["swarm"]["extra"]["errors"] or not out["swarm"]["extra"]["rounds"]:
                    raise AssertionError(f"the swarm: {out['swarm']['extra']}")
                t0 = time.perf_counter()
                end = time.monotonic() + ROLL_FEDERATION_S
                clients = {k: RemoteSchedulerClient(a) for k, a in addrs.items()}
                try:
                    while True:
                        # remote edges on both sides: deltas arrived both
                        # ways (a sync is push-pull); the frames carry each
                        # side's federation families, and the side whose book
                        # names the other syncs with it
                        states = {k: await c.federation_state() for k, c in clients.items()}
                        frames = {m["hostname"]: m["frame"] for m in (await mc.cluster_stats())["members"]}
                        fed = {k: (frames.get(k, {}).get("federation_peers"),
                                   frames.get(k, {}).get("rates", {}).get("federation_syncs_ok_per_s"))
                               for k in states}
                        if all(s["remote_edges"] > 0 for s in states.values()) \
                                and all(peers is not None for peers, _ in fed.values()) \
                                and any(peers == 1 and (ok or 0) > 0 for peers, ok in fed.values()):
                            break
                        if time.monotonic() > end:
                            raise AssertionError(f"federation by the deadline: {states}, frames {fed}")
                        await asyncio.sleep(0.25)
                finally:
                    for c in clients.values():
                        await c.close()
                out["swarm_to_federated_s"] = time.perf_counter() - t0
                out["federation"] = {k: {"remote_edges": s["remote_edges"], "local_edges": s["local_edges"],
                                         "frame_peers": fed[k][0], "frame_syncs_ok_per_s": fed[k][1]}
                                     for k, s in states.items()}
            finally:
                await mc.close()
            return out

        out = asyncio.run(drive())
        out["clis"] = rollout_clis(maddr, addrs, artifact, env)
    finally:
        for p in procs:
            p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
            p.stdout.close()
    ex = out["swarm"]["extra"]
    out.update(boot_s=boot_s, schedulers=addrs, wall_s=time.perf_counter() - t_leg)
    print(f"  processes: manager and two schedulers up in {boot_s:.1f} s; published to both frames "
          f"{out['published_to_both_frames_s']:.2f} s (serving modes "
          f"{ {k: f.get('serving_mode') for k, f in out['frames'].items()} }); swarm {out['swarm']['value']} "
          f"rounds/s, {ex['rounds']} rounds, {ex['errors']} errors, p50/p99 {ex['p50_ms']}/{ex['p99_ms']} ms; "
          f"federated {out['swarm_to_federated_s']:.2f} s after it: "
          f"{ {k: tuple(v.values()) for k, v in out['federation'].items()} } "
          f"(remote edges, local edges, peers and ok syncs/s in its frame); leg {out['wall_s']:.1f} s")
    return out


def rollout_clis(maddr: str, addrs: dict, artifact: str, env: dict) -> dict:
    """The operator CLIs as processes against leg (b)'s manager and
    schedulers: dftop's cluster screen, dfmodel's rollout status, and
    dfml's decisions and replay of a round the torch scheduler scored on
    the card (a wave on hosts the model knows, driven over RPC first)."""
    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

    t0 = time.perf_counter()
    hosts = sched_hosts()[:ROLL_CLI_HOSTS]
    length = SCHED_PIECES * (4 << 20)

    async def wave() -> list[str]:
        client = RemoteSchedulerClient(addrs["sch-torch"])
        tasks = []
        try:
            for h in hosts:
                await client.announce_host(h)  # dflint: disable=DF025 set-up, one host at a time
            for t in range(ROLL_CLI_TASKS):
                meta = TaskMeta(task_id=f"cli-{t:02d}", url=f"http://origin.example/cli/{t}")
                tasks.append(meta.task_id)
                picks = np.random.default_rng([SCHED_SEED, 100 + t]).choice(len(hosts), SCHED_PEERS, replace=False)
                for j, h in enumerate(picks):
                    pid = f"cli-{t}-{j}"
                    r = await client.register_peer(pid, meta, hosts[h])  # dflint: disable=DF025 one registration is one scheduling round
                    if r.back_to_source:
                        await client.report_task_metadata(meta.task_id, content_length=length, piece_size=4 << 20)  # dflint: disable=DF025 as above
                    ps = [p.peer_id for p in r.parents] or [""]
                    await client.report_batch(pid, [(i, 2.0 + i % 7, ps[i % len(ps)]) for i in range(SCHED_PIECES)],  # dflint: disable=DF025 as above
                                              {"success": True, "bandwidth_bps": 5e7 + 1e6 * int(h)})
        finally:
            await client.close()
        return tasks

    tasks = asyncio.run(wave())
    out: dict = {"wave_s": time.perf_counter() - t0}
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dftop", ["--manager", maddr, "--once", "--json"], env)
    modes = {m["hostname"]: (m.get("frame") or {}).get("serving_mode") for m in json.loads(text)["members"]} \
        if rc == 0 else {}
    if rc or modes != {"sch-torch": "torch", "sch-native": "native"}:
        raise AssertionError(f"dftop --once exited {rc} with members {modes}")
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dfmodel", ["status", "--manager", maddr, "--json"], env)
    active = (json.loads(text)["active"] or {}) if rc == 0 else {}
    if rc or active.get("version") != "v-proc" or active.get("artifact_path") != artifact:
        raise AssertionError(f"dfmodel status exited {rc}, active {active}")
    torch_addr = addrs["sch-torch"]
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dfml",
                           ["decisions", "--scheduler", torch_addr, "--limit", "256", "--json"], env)
    if rc:
        raise AssertionError(f"dfml decisions exited {rc}")
    records = [r for r in json.loads(text)["records"] if r["task_id"] in tasks]
    on_card = [r for r in records if r["serving_mode"] == "torch" and r["model_version"] == "v-proc"]
    if not on_card:
        raise AssertionError(f"dfml decisions: no round of the CLI wave scored on the card: {records}")
    rec = on_card[0]
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dfml",
                           ["explain", "--scheduler", torch_addr, rec["task_id"], rec["child_peer"]], env)
    if rc or "(bit-exact)" not in text:
        raise AssertionError(f"dfml explain exited {rc}: {text[-2000:]}")
    out.update(dftop_modes=modes, dfmodel_active=active["version"], decisions=len(records),
               decisions_on_card=len(on_card), explained=f"{rec['task_id']} {rec['child_peer']}",
               wall_s=time.perf_counter() - t0)
    print(f"  CLIs: dftop --once {modes}; dfmodel status active {active['version']}; dfml decisions "
          f"{len(records)} records of the CLI wave ({len(on_card)} scored on the card); dfml explain "
          f"{out['explained']} replays bit-exact; {out['wall_s']:.1f} s")
    return out


def rollout() -> dict:
    """The live-model rollout in the port alone: leg (a) in process, leg (b)
    as processes (see the module docstring)."""
    t_phase = time.perf_counter()
    old = os.environ.get("DRAGONFLY_NATIVE_SCORER")
    os.environ["DRAGONFLY_NATIVE_SCORER"] = "0"
    try:
        with tempfile.TemporaryDirectory() as tmp:
            tmp = pathlib.Path(tmp)
            (tmp / "a").mkdir()
            (tmp / "b").mkdir()
            inproc = asyncio.run(rollout_inproc(tmp / "a"))
            if old is None:
                del os.environ["DRAGONFLY_NATIVE_SCORER"]
            else:
                os.environ["DRAGONFLY_NATIVE_SCORER"] = old
            procs = rollout_processes(tmp / "b", inproc.pop("artifact"), inproc.pop("digest"))
    finally:
        if old is None:
            os.environ.pop("DRAGONFLY_NATIVE_SCORER", None)
        else:
            os.environ["DRAGONFLY_NATIVE_SCORER"] = old
    return {"in_process": inproc, "processes": procs, "host_cpu": host_cpu(),
            "wall_s": time.perf_counter() - t_phase}


def cli_call(main, argv: list[str]) -> tuple[int, str]:
    """A port CLI's ``main(argv)`` in this process: its exit code and standard
    output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


def cli_process(module: str, args: list[str], env: dict) -> tuple[int, str]:
    """``python -m <module> <args>`` under CLI_DEADLINE_S: its exit code and
    standard output (its standard error printed when it fails)."""
    p = subprocess.run([sys.executable, "-m", module, *args], cwd=REPO, env=env, capture_output=True, text=True,
                       timeout=CLI_DEADLINE_S)
    if p.returncode:
        print(f"  {module} {' '.join(args)} exited {p.returncode}: {p.stderr[-2000:]}")
    return p.returncode, p.stdout


def sim_leg(rep, content_length: int) -> dict:
    """A leg's events and rates, placement and outcomes off its SimReport."""
    return {
        "peers": rep.peers, "events": rep.events, "wall_s": rep.wall_s, "virtual_s": rep.virtual_s,
        "events_per_sec": rep.events_per_sec, "time_compression": rep.time_compression,
        "sched_rounds": rep.sched_rounds, "sched_s": rep.sched_s, "sched_rounds_per_s": rep.sched_rounds_per_s,
        "rounds_with_parents": rep.rounds_with_parents,
        "same_region_frac": rep.same_region_frac, "same_rack_frac": rep.same_rack_frac,
        "mean_parent_rtt_ms": rep.mean_parent_rtt_ms,
        "completed": rep.completed, "failed": rep.failed, "back_to_source": rep.back_to_source,
        "reschedules": rep.reschedules, "departed": rep.departed, "crashed": rep.crashed,
        "departed_parent_rounds": rep.departed_parent_rounds,
        "max_region_fetches": max(rep.origin_egress_bytes.values(), default=0) / content_length,
    }


def print_sim_leg(name: str, leg: dict) -> None:
    print(f"  {name}: {leg['events']} events in {leg['wall_s']} s ({leg['events_per_sec']} events/s, "
          f"{leg['virtual_s']} s virtual, {leg['time_compression']}x); {leg['sched_rounds']} scheduling rounds, "
          f"{leg['sched_rounds_per_s']} rounds/s inside schedule_candidate_parents; placement: "
          f"same region {leg['same_region_frac']}, same rack {leg['same_rack_frac']}, mean parent RTT "
          f"{leg['mean_parent_rtt_ms']} ms; completed {leg['completed']}, failed {leg['failed']}, "
          f"departed-parent rounds {leg['departed_parent_rounds']}")


def scenario_verdict(scenario, rep) -> str | None:
    """The scenario's own check: None when it passes, else its message."""
    try:
        scenario.check(rep)
    except AssertionError as e:
        return str(e) or "failed"
    return None


def sim_base(tmp: pathlib.Path) -> tuple[dict, object]:
    """Leg (a): the base flash crowd at check.sh's sim-smoke shape, with its
    records bridged to a dataset. Returns the leg's numbers and the dataset."""
    sc = sim_scenarios.flash_crowd(peers=SIM_PEERS, seed=SIM_SEED, telemetry_dir=str(tmp / "telemetry"))
    try:
        rep = sc.sim.run()
        verdict = scenario_verdict(sc, rep)
        t0 = time.perf_counter()
        bridged = sc.sim.build_dataset()
        bridge_s = time.perf_counter() - t0
    finally:
        sc.sim.close()
    leg = sim_leg(rep, sc.content_length)
    ds = bridged.pop("dataset")
    # what leg (c) learns from: the training pairs split by idc_match, with
    # their mean label (the child's observed rate over 1 GiB/s), and the
    # spread of the rtt column
    feats, label = np.asarray(ds.pairs.feats), np.asarray(ds.pairs.label)
    same = feats[:, FEATURE_NAMES.index("idc_match")] == 1.0
    pairs_by_idc = {name: {"pairs": int(m.sum()), "label_mean": float(label[m].mean()) if m.any() else None}
                    for name, m in (("same idc", same), ("other idc", ~same))}
    rtt_std = float(feats[:, FEATURE_NAMES.index("rtt_norm")].std())
    leg.update(check=verdict, dataset=bridged, bridge_s=bridge_s, pairs_by_idc=pairs_by_idc, rtt_norm_std=rtt_std)
    print_sim_leg("(a) base", leg)
    print(f"    scenario check: {verdict or 'passed'}; dataset {bridged} bridged in {bridge_s:.2f} s; training "
          f"pairs by idc_match {pairs_by_idc}, rtt_norm spread {rtt_std:.3g}")
    # tools/check.sh's sim-smoke assertions
    if verdict is not None:
        raise AssertionError(f"the base flash crowd failed its check: {verdict}")
    if leg["completed"] < 9_500 * SIM_PEERS // 10_000 or leg["rounds_with_parents"] <= 9_000 * SIM_PEERS // 10_000 \
            or leg["same_region_frac"] < 0.5 or not 0 < leg["max_region_fetches"] <= 8.0 \
            or leg["departed_parent_rounds"] or not (bridged["nodes"] > 0 and bridged["edges"] > 0) \
            or not (leg["events_per_sec"] > 0 and leg["time_compression"] > 1.0):
        raise AssertionError(f"the base flash crowd missed check.sh's sim-smoke bounds: {leg}")
    return leg, ds


def sim_native_start(tmp: pathlib.Path) -> tuple[subprocess.Popen, float]:
    """Leg (b) started: dfsim's ml-native flash crowd as a process of its own
    (the native C++ scorer on the host, no card), run beside legs (a) and (c)."""
    args = ["-m", "dragonfly2_tpu_torch.cli.dfsim", "flash-crowd", "--peers", str(SIM_PEERS), "--seed",
            str(SIM_SEED), "--scoring", "ml-native", "--json"]
    with open(tmp / "dfsim.log", "w") as err:
        proc = subprocess.Popen([sys.executable, *args], cwd=tmp, env={**os.environ, "PYTHONPATH": str(REPO)},
                                stdout=subprocess.PIPE, stderr=err, text=True)
    return proc, time.monotonic() + SIM_DEADLINE_S


def sim_native_finish(proc: subprocess.Popen, deadline: float, tmp: pathlib.Path) -> dict:
    """Leg (b) collected and held to the reference test's coverage contract."""
    try:
        stdout, _ = proc.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        raise AssertionError(f"dfsim --scoring ml-native ran past {SIM_DEADLINE_S} s")
    if proc.returncode:
        raise AssertionError(f"dfsim --scoring ml-native exited {proc.returncode}: "
                             f"{(tmp / 'dfsim.log').read_text()[-2000:]}")
    out = json.loads(stdout.strip().splitlines()[-1])
    s, pl, oc = out["scheduler"], out["placement"], out["outcomes"]
    leg = {"peers": out["peers"], "events": out["events"], "wall_s": out["wall_s"], "virtual_s": out["virtual_s"],
           "events_per_sec": out["events_per_sec"], "time_compression": out["time_compression"],
           "sched_rounds": s["rounds"], "sched_s": s["sched_s"], "sched_rounds_per_s": s["rounds_per_s"],
           "rounds_with_parents": pl["rounds"], "same_region_frac": pl["same_region_frac"],
           "same_rack_frac": pl["same_rack_frac"], "mean_parent_rtt_ms": pl["mean_parent_rtt_ms"],
           "completed": oc["completed"], "failed": oc["failed"],
           "departed_parent_rounds": out["violations"]["departed_parent_rounds"],
           "scoring": s["scoring"], "native_rounds": s["native_rounds"], "mirror_rounds": s["mirror_rounds"],
           "mirror_stale_rounds": s["mirror_stale_rounds"], "mirror_full_syncs": s["mirror_full_syncs"]}
    print_sim_leg("(b) ml-native (dfsim process)", leg)
    print(f"    native rounds {s['native_rounds']} of {s['rounds']}, mirror {s['mirror_rounds']} + stale "
          f"{s['mirror_stale_rounds']}, full syncs {s['mirror_full_syncs']} for {out['schedulers']} schedulers")
    # tests/test_sim.py's coverage contract, and the departed-parent invariant
    if s["scoring"] != "ml-native" or s["native_rounds"] < s["rounds"] - out["schedulers"] \
            or s["mirror_rounds"] + s["mirror_stale_rounds"] != s["native_rounds"] \
            or s["mirror_full_syncs"] != out["schedulers"] or leg["departed_parent_rounds"]:
        raise AssertionError(f"the ml-native leg missed its coverage contract: {s}, {out['violations']}")
    return leg


def sim_expected_scores(scorer, record: dict, index: dict) -> np.ndarray:
    """What the evaluator serves for a recorded round from ``scorer``: the
    base blend when the child host (or every parent host) is unknown to the
    model, else the model's scores with the base blend for unknown parents."""
    feats = np.asarray(record["feats"], np.float32)
    base = (feats @ BASE_WEIGHTS).astype(np.float32)
    c = index.get(record["child_host"])
    rows = [index.get(q["host"]) for q in record["parents"]]
    known = np.array([r is not None for r in rows])
    if c is None or not known.any():
        return base
    ml = scorer.score(feats, child=np.full(len(feats), c, np.int32),
                      parent=np.array([r if r is not None else 0 for r in rows], np.int32))
    return np.where(known, ml, base).astype(np.float32)


def sim_trained(ds, tmp: pathlib.Path, base: dict) -> dict:
    """Leg (c): a GNN trained on the card from leg (a)'s records serves a
    second run of the same swarm (see the module docstring)."""
    t0 = time.perf_counter()
    state, losses = asyncio.run(train_gnn.train_async(SIM_TRAIN, ds.graph, ds.pairs, steps=SIM_TRAIN_STEPS,
                                                      steps_per_call=STEPS_PER_CALL, device="cuda"))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    head, tail = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    print(f"  (c) trained on the card: {len(losses)} steps in {train_s:.2f} s ({len(losses) / train_s:.1f} steps/s), "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f} (means of the first and last ten {head:.5f} -> {tail:.5f})")
    if not (np.isfinite(losses).all() and tail < head):
        raise AssertionError(f"the sim-trained GNN's losses did not fall: {losses}")
    path = artifacts.save_artifact(tmp / "gnn-sim", model_type="gnn", version="sim-trained", params=state.model,
                                   config={"hidden": SIM_TRAIN.hidden, "embed_dim": SIM_TRAIN.embed_dim,
                                           "num_layers": SIM_TRAIN.num_layers})
    artifacts.save_graph(path, ds.graph, ds.host_index)
    artifacts.save_native(path, train_gnn.make_model(SIM_TRAIN), state.model.state_dict(), ds.graph, device="cuda")
    digest = artifacts.artifact_digest(path)
    del state
    old = os.environ.get("DRAGONFLY_NATIVE_SCORER")
    os.environ["DRAGONFLY_NATIVE_SCORER"] = "0"
    try:
        t0 = time.perf_counter()
        scorer, index = manager_link.load_scorer_verified(str(path), digest)
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        cpu_scorer, cpu_index = manager_link.load_scorer_verified(str(path), digest, device="cpu")
    finally:
        if old is None:
            os.environ.pop("DRAGONFLY_NATIVE_SCORER", None)
        else:
            os.environ["DRAGONFLY_NATIVE_SCORER"] = old
    if not isinstance(scorer, GNNScorer) or scorer.device.type != "cuda" or cpu_index != index:
        raise AssertionError(f"the sim-trained artifact loaded as {type(scorer).__name__} on "
                             f"{getattr(scorer, 'device', None)}, not GNNScorer on the card")
    card_after_load = card_mib()

    sc = sim_scenarios.flash_crowd(peers=SIM_PEERS, seed=SIM_SEED)
    services = list(sc.sim.services.values())
    for svc in services:
        # as a ManagerLink installs a model, through the evaluator's public
        # attach_scorer, with no micro-batcher and no dispatcher: the sim's
        # loop is a virtual clock's, on which nothing a thread resolves lands
        svc.decisions = DecisionRecorder(sample_rate=SIM_DECISION_SAMPLE,
                                         topk=svc.scheduling.config.candidate_parent_limit, clock=sc.sim.clock)
        svc.evaluator.decisions = svc.decisions
        svc.evaluator.attach_scorer(scorer, index, version="sim-trained")
    modes = [MLEvaluator._mode_of(svc.evaluator.serving_bundle.scorer) for svc in services]
    if modes != ["torch"] * len(services) or serving_gauges()["torch"] != 1.0:
        raise AssertionError(f"the sim's evaluators serve as {modes}, gauges {serving_gauges()}")
    before = fallbacks()
    try:
        rep = sc.sim.run()
        verdict = scenario_verdict(sc, rep)
        records = [r for svc in services for r in svc.decision_records(limit=1 << 20)["records"]]
    finally:
        sc.sim.close()
    after = fallbacks()
    fell = {r: after[r] - before[r] for r in FALLBACK_REASONS}
    leg = sim_leg(rep, sc.content_length)
    gaps = [float(np.abs(sim_expected_scores(cpu_scorer, r, index) - np.asarray(r["scores"])).max())
            for r in records]
    by_mode: dict[str, int] = {}
    for r in records:
        by_mode[r["serving_mode"]] = by_mode.get(r["serving_mode"], 0) + 1
    leg.update(check=verdict, base_fallbacks=fell, records=len(records), records_by_mode=by_mode,
               rescored_max_abs=max(gaps, default=float("nan")), train_s=train_s, train_steps=len(losses),
               steps_per_s=len(losses) / train_s, first_loss=losses[0], last_loss=losses[-1],
               load_verify_s=load_s, card_mib_after_load=card_after_load, card_mib_after_run=card_mib(),
               dataset=base["dataset"])
    print_sim_leg("(c) sim-trained GNN on the card", leg)
    print(f"    dataset {base['dataset']}; load + verify {load_s:.2f} s; card {card_after_load:.1f} MiB allocated "
          f"after the load, {leg['card_mib_after_run']:.1f} after the run; fallbacks {fell}; {len(records)} "
          f"decision records {by_mode}, re-scored on the CPU within {leg['rescored_max_abs']:.3g}")
    print(f"    placement, learned against base (same seed): same region {leg['same_region_frac']} vs "
          f"{base['same_region_frac']}, same rack {leg['same_rack_frac']} vs {base['same_rack_frac']}, mean parent "
          f"RTT {leg['mean_parent_rtt_ms']} vs {base['mean_parent_rtt_ms']} ms; scenario check (not gated): "
          f"{verdict or 'passed'}")
    if fell["scorer_error"] or fell["no_scorer"] or fell["degraded"]:
        raise AssertionError(f"the sim-trained leg fell back to base: {fell}")
    if fell["unknown_hosts"] > SIM_UNKNOWN_MAX * leg["sched_rounds"]:
        raise AssertionError(f"{fell['unknown_hosts']} of {leg['sched_rounds']} rounds had hosts the model "
                             "does not know")
    if leg["departed_parent_rounds"] or leg["completed"] < 9_500 * SIM_PEERS // 10_000:
        raise AssertionError(f"the sim-trained leg: {leg}")
    if by_mode.get("torch", 0) < SIM_MIN_RECORDS or not max(gaps) <= SCORE_MAX_ABS:
        raise AssertionError(f"the decision records: {len(records)} ({by_mode}), re-scored within "
                             f"{max(gaps, default=None)}")
    return leg


def sim_phase() -> dict:
    """The swarm simulator over the port's control plane: legs (a), (b) and
    (c) (see the module docstring); (b) runs as a process beside the others."""
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        tmp = pathlib.Path(tmp)
        proc, deadline = sim_native_start(tmp)
        try:
            base, ds = sim_base(tmp)
            trained = sim_trained(ds, tmp, base)
            native = sim_native_finish(proc, deadline, tmp)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            proc.stdout.close()
    return {"base": base, "ml_native": native, "trained": trained, "host_cpu": host_cpu(),
            "wall_s": time.perf_counter() - t_phase}


def edge_case_inputs() -> dict:
    """Named (h, neighbors, mask) CPU inputs that each kernel must get right."""
    rng = np.random.default_rng(0)

    def graph(n, k, h, p=0.7, lo=0):
        return (torch.from_numpy(rng.normal(size=(n, h)).astype(np.float32)),
                torch.from_numpy(rng.integers(lo, n, (n, k)).astype(np.int32)),
                torch.from_numpy((rng.random((n, k)) < p).astype(np.float32)))

    cases = {f"random {n}x{k}x{h}": graph(n, k, h) for n, k, h in [(100, 7, 33), (257, 4, 64), (1, 2, 8)]}
    h, nbr, mask = graph(64, 4, 16)
    mask[3] = 0.0
    cases["fully masked row"] = (h, nbr, mask)
    cases["duplicate neighbours"] = (torch.arange(12.0).reshape(3, 4),
                                     torch.tensor([[1, 1], [0, 2], [0, 1]], dtype=torch.int32),
                                     torch.ones(3, 2))
    h, nbr, _ = graph(128, 8, 64)
    cases["fractional mask"] = (h, nbr, torch.from_numpy(rng.random((128, 8)).astype(np.float32)))
    h, nbr, mask = graph(50, 6, 32, p=1.0)
    nbr[0, 0], mask[0, 0] = 50 + 5, 0.0  # out of range, masked out
    nbr[1, 0] = -3                       # out of range, mask 1
    nbr[2, 1] = 50                       # out of range, mask 1
    cases["out-of-range index"] = (h, nbr, mask)
    cases["unaligned h (scalar path)"] = graph(40, 5, 64)
    cases["node 0 named by no slot"] = graph(48, 6, 64, p=0.8, lo=1)
    h, nbr, mask = graph(32, 16, 64, p=1.0)
    nbr[0] = 5
    cases["one neighbour named K times"] = (h, nbr, mask)
    return cases


def on_card(h: torch.Tensor, dt: torch.dtype, unaligned: bool) -> torch.Tensor:
    hd = h.to(dt).cuda()
    if unaligned:  # contiguous, but 2 or 4 bytes off a 16-byte line
        hd = torch.empty(h.numel() + 1, dtype=dt, device="cuda")[1:].view(h.shape).copy_(hd)
        if hd.data_ptr() % 16 == 0:
            raise AssertionError("unaligned case is aligned")
    return hd


def edge_cases() -> None:
    for name, (h, nbr, mask) in edge_case_inputs().items():
        n, nbr, mask = h.shape[0], nbr.cuda(), mask.cuda()
        for dt in (torch.float32, torch.bfloat16):
            hd = on_card(h, dt, name.startswith("unaligned"))
            got = neighbor_aggregate_cuda(hd, nbr, mask)
            compare(f"fwd {name} {str(dt)[6:]}", got, neighbor_aggregate_torch(hd, nbr, mask))
            if name == "fully masked row" and not bool((got[3] == 0).all()):
                raise AssertionError("fully masked row is not exactly 0")
            if name == "duplicate neighbours" and not torch.allclose(got[0].float(), hd[1].float(), rtol=1e-5):
                raise AssertionError("duplicate neighbours: the mean of h[1], h[1] is not h[1]")
            gh = neighbor_aggregate_bwd_cuda(hd, nbr, mask, n)  # h's values serve as the incoming gradient
            compare(f"bwd {name} {str(dt)[6:]}", gh, neighbor_aggregate_bwd_torch(hd, nbr, mask, n))
            if name == "node 0 named by no slot" and not bool((gh[0] == 0).all()):
                raise AssertionError("a node that no slot names does not get exactly 0")
            if not (torch.equal(got, neighbor_aggregate_cuda(hd, nbr, mask))
                    and torch.equal(gh, neighbor_aggregate_bwd_cuda(hd, nbr, mask, n))):
                raise AssertionError(f"{name} {dt}: a second launch gave other bits")


def time_all(fns: dict) -> tuple[dict, dict]:
    """Mean ms of each fn with the L2 flushed before each launch, and back to back."""
    flush = torch.empty(256 * 2**20, dtype=torch.uint8, device="cuda")
    cold = {name: events_ms(fn, 50, flush) for name, fn in fns.items()}
    warm = {name: events_ms(fn, 50, None) for name, fn in fns.items()}
    return cold, warm


def bound(nbytes: int, flops: int) -> tuple[float, str]:
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / F32_FLOPS_PER_S * 1e3
    return max(bytes_ms, flops_ms), "bytes" if bytes_ms >= flops_ms else "operations"


def live_slots(nbr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return (mask != 0) & (nbr >= 0) & (nbr < nbr.shape[0])


def kernel_usage(info: dict, kernel: str) -> dict:
    """Registers and spill bytes of the kernel's bf16 vector instantiation,
    the one the main paths launch, from the build's -Xptxas -v output, and
    whether that output is this run's nvcc's or the log of an earlier build
    of the same source and flags."""
    found = [u for name, u in _build.ptxas_usage(info["log"]).items()
             if kernel in name and "13__nv_bfloat16Li8E" in name]
    if len(found) != 1:
        raise AssertionError(f"ptxas reported {len(found)} bf16 vector instantiations of {kernel}")
    return {"registers": found[0]["registers"], "spills": found[0]["spill_stores"] + found[0]["spill_loads"],
            "registers_from": "this run's nvcc" if info["seconds"] else "an earlier build's log"}


def twice_equal(fn) -> bool:
    """Two launches of fn on the same input give the same bits."""
    a, b = fn(), fn()
    torch.cuda.synchronize()
    return bool(torch.equal(a, b))


def kernel_row_fwd(h0: torch.Tensor, nbr: torch.Tensor, mask: torch.Tensor, launches: int, usage: dict) -> dict:
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        h = h0.to(dt).contiguous()
        errs[dt] = compare(f"fwd main case [{h.shape[0]}, {nbr.shape[1]}, {h.shape[1]}] {str(dt)[6:]}",
                           neighbor_aggregate_cuda(h, nbr, mask), neighbor_aggregate_torch(h, nbr, mask))

    h = h0.contiguous()  # bf16, as the main path gives it
    deterministic = twice_equal(lambda: neighbor_aggregate_cuda(h, nbr, mask))
    n, k = nbr.shape
    hdim, b = h.shape[1], h.element_size()
    eps = 1e-6
    w = (mask / (mask.sum(dim=1, keepdim=True) + eps)).to(h.dtype)
    nbr64 = nbr.long()
    lib_out = F.embedding_bag(nbr64, h, per_sample_weights=w, mode="sum")
    lib_err = float((lib_out.float() - neighbor_aggregate_torch(h, nbr, mask).float()).abs().max())
    cold, warm = time_all({
        "kernel": lambda: neighbor_aggregate_cuda(h, nbr, mask),
        "plain": lambda: neighbor_aggregate_torch(h, nbr, mask),
        "library": lambda: F.embedding_bag(nbr64, h, per_sample_weights=w, mode="sum"),
    })
    host_us = host_us_per_call(lambda: neighbor_aggregate_cuda(h, nbr, mask), 50)

    # The least work this run's data needs: every h row that some live slot
    # names, read once; the whole mask; the indices of live slots; the output.
    live = live_slots(nbr, mask)
    rows = int(torch.unique(nbr[live]).numel())
    n_live = int(live.sum())
    nbytes = rows * hdim * b + n * k * 4 + n_live * 4 + n * hdim * b
    bound_ms, bound_by = bound(nbytes, 2 * n_live * hdim)
    print(f"  fwd timing bf16 [{n}, {k}, {hdim}] (L2 flushed / back to back): kernel {cold['kernel']:.4f} / "
          f"{warm['kernel']:.4f} ms, plain {cold['plain']:.4f} / {warm['plain']:.4f} ms, "
          f"embedding_bag {cold['library']:.4f} / {warm['library']:.4f} ms "
          f"(its max abs err vs plain {lib_err:.3g}); the kernel's wrapper takes {host_us:.1f} us "
          f"of host time a call; two launches bit-identical: {deterministic}")
    print(f"  fwd bound: {nbytes} bytes ({rows} distinct rows, {n_live} live slots) = {bound_ms * 1e3:.2f} us "
          f"({bound_by}), {bound_ms / cold['kernel']:.1%} of it flushed, {bound_ms / warm['kernel']:.1%} warm; "
          f"the live slots gather {n_live * hdim * b} bytes from L2; {usage['registers']} registers, "
          f"{usage['spills']} bytes of spills")
    if not deterministic:
        raise AssertionError("K1 gave other bits on a second launch")
    return {
        "name": "neighbor_agg_fwd", "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/neighbor_agg.cu",
        "replaces": "dragonfly2_tpu/ops/neighbor_agg_pallas.py:33",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
        "ms": cold["kernel"], "plain_ms": cold["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cold["library"],
        "ms_l2_warm": warm["kernel"], "plain_ms_l2_warm": warm["plain"], "library_ms_l2_warm": warm["library"],
        "host_us_per_launch": host_us, "deterministic": deterministic, "index_build_ms": None, **usage,
        "dtype": "bfloat16", "shape": [n, k, hdim], "ok": True,
    }


def kernel_row_bwd(nbr: torch.Tensor, mask: torch.Tensor, hdim: int, launches: int, usage: dict) -> dict:
    n, k = nbr.shape
    g32 = torch.from_numpy(np.random.default_rng(21).normal(size=(n, hdim)).astype(np.float32)).cuda()
    errs = {}
    for dt in (torch.bfloat16, torch.float32):
        g = g32.to(dt)
        errs[dt] = compare(f"bwd main case [{n}, {k}, {hdim}] {str(dt)[6:]}",
                           neighbor_aggregate_bwd_cuda(g, nbr, mask, n), neighbor_aggregate_bwd_torch(g, nbr, mask, n))
        # the autograd path: K1 forward + K2 backward against autograd through the plain version
        grads = []
        for use_kernel in (True, False):
            h = g32.to(dt).requires_grad_()
            out = neighbor_aggregate(h, nbr, mask, impl="cuda") if use_kernel else neighbor_aggregate_torch(h, nbr, mask)
            grads.append(torch.autograd.grad((out.float() ** 2).sum(), h)[0])
        compare(f"autograd of neighbor_aggregate [{n}, {k}, {hdim}] {str(dt)[6:]}", *grads)

    g = g32.to(torch.bfloat16)  # the training path's dtype
    index = transpose_index(nbr, mask, n)
    deterministic = twice_equal(lambda: neighbor_aggregate_bwd_cuda(g, nbr, mask, n, index=index))
    scale = mask / (mask.sum(dim=1, keepdim=True) + 1e-6)
    rows = (g.float()[:, None, :] * scale[..., None]).reshape(-1, hdim)  # the library call's input
    flat = nbr.reshape(-1).long()
    cold, warm = time_all({
        "kernel": lambda: neighbor_aggregate_bwd_cuda(g, nbr, mask, n, index=index),
        "index": lambda: transpose_index(nbr, mask, n),
        "kernel with index build": lambda: neighbor_aggregate_bwd_cuda(g, nbr, mask, n),
        "plain": lambda: neighbor_aggregate_bwd_torch(g, nbr, mask, n),
        "library": lambda: torch.zeros(n, hdim, dtype=torch.float32, device="cuda").index_add_(0, flat, rows),
    })
    host_us = host_us_per_call(lambda: neighbor_aggregate_bwd_cuda(g, nbr, mask, n, index=index), 50)
    del rows

    # The least work this run's data needs: every g row with a live slot read
    # once; the whole mask; the indices of live slots; gh written once.
    live = live_slots(nbr, mask)
    src_rows = int(live.any(dim=1).sum())
    n_live = int(live.sum())
    b = g.element_size()
    nbytes = src_rows * hdim * b + n * k * 4 + n_live * 4 + n * hdim * b
    bound_ms, bound_by = bound(nbytes, 2 * n_live * hdim)
    with_build = (cold["kernel with index build"], warm["kernel with index build"])
    print(f"  bwd timing bf16 [{n}, {k}, {hdim}] (L2 flushed / back to back): kernel with its index build, "
          f"all of K2's work a gradient pays {with_build[0]:.4f} / {with_build[1]:.4f} ms; of it the index build "
          f"alone {cold['index']:.4f} / {warm['index']:.4f} ms and the kernel alone (index built beforehand) "
          f"{cold['kernel']:.4f} / {warm['kernel']:.4f} ms; plain {cold['plain']:.4f} / {warm['plain']:.4f} ms, "
          f"index_add_ {cold['library']:.4f} / {warm['library']:.4f} ms; the kernel's wrapper takes "
          f"{host_us:.1f} us of host time a call; two launches bit-identical: {deterministic}")
    print(f"  bwd bound: {nbytes} bytes ({src_rows} source rows, {n_live} live slots) = {bound_ms * 1e3:.2f} us "
          f"({bound_by}), {bound_ms / with_build[0]:.1%} / {bound_ms / with_build[1]:.1%} of K2 with its index "
          f"build, {bound_ms / cold['kernel']:.1%} / {bound_ms / warm['kernel']:.1%} of the gather alone; "
          f"the live slots gather {n_live * hdim * b} bytes from L2; {usage['registers']} registers, "
          f"{usage['spills']} bytes of spills")
    if not deterministic:
        raise AssertionError("K2 gave other bits on a second launch")
    return {
        "name": "neighbor_agg_bwd", "route": "cuda",
        "source": "dragonfly2_tpu_torch/csrc/neighbor_agg.cu",
        "replaces": "dragonfly2_tpu/ops/neighbor_agg_pallas.py:80",
        "launches": launches,
        "max_abs_err": errs[torch.bfloat16], "max_abs_err_f32": errs[torch.float32],
        "ms": cold["kernel"], "plain_ms": cold["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": cold["library"],
        "ms_l2_warm": warm["kernel"], "plain_ms_l2_warm": warm["plain"], "library_ms_l2_warm": warm["library"],
        "host_us_per_launch": host_us, "deterministic": deterministic,
        "index_build_ms": cold["index"], "index_build_ms_l2_warm": warm["index"],
        "ms_with_index_build": cold["kernel with index build"],
        "ms_with_index_build_l2_warm": warm["kernel with index build"], **usage,
        "dtype": "bfloat16", "shape": [n, k, hdim], "ok": True,
    }


def counts() -> dict:
    return {"neighbor_agg_fwd": neighbor_agg_cuda.LAUNCHES, "neighbor_agg_bwd": neighbor_agg_cuda.BWD_LAUNCHES}


def zero_counts() -> None:
    neighbor_agg_cuda.LAUNCHES = neighbor_agg_cuda.BWD_LAUNCHES = 0


def main() -> int:
    t_run = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is present", file=sys.stderr)
        return 1
    with phase("device"):
        kind, count = torch.cuda.get_device_name(0), torch.cuda.device_count()
        card = nvidia_smi_line()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"  device: {kind}, count {count}; nvidia-smi: {card}")
        print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}; allow_tf32: matmul "
              f"{torch.backends.cuda.matmul.allow_tf32}, cudnn {torch.backends.cudnn.allow_tf32}")

    with phase("build"):
        t0 = time.perf_counter()
        names = _build.sources()
        with concurrent.futures.ThreadPoolExecutor(max_workers=len(names) + 1) as pool:
            scorer_lib = pool.submit(_build.build_gxx, "scorer")
            built = dict(zip(names, pool.map(_build.build, names)))
            scorer_lib = scorer_lib.result()
        print(f"  {len(built)} kernel source(s) built in {time.perf_counter() - t0:.1f} s")
        print(f"  scorer.cc (the native scorer, host CPU): " + (
            f"g++ {scorer_lib['seconds']:.1f} s" if scorer_lib["seconds"] else "built already")
            + f", flags {scorer_lib['flags']}")
        for name, info in built.items():
            print(f"  {name}: " + (f"nvcc {info['seconds']:.1f} s; registers from this run's nvcc"
                                   if info["seconds"] else "built already; registers from an earlier build's log"))
            for kernel, u in _build.ptxas_usage(info["log"]).items():
                print(f"    ptxas: {kernel}: {u['registers']} registers, spill stores {u['spill_stores']} "
                      f"bytes, spill loads {u['spill_loads']} bytes")
        usage = {k: kernel_usage(built["neighbor_agg"], f"{k}_kernel")
                 for k in ("neighbor_agg_fwd", "neighbor_agg_bwd")}

    launches = {"neighbor_agg_fwd": 0, "neighbor_agg_bwd": 0}
    with phase("serving"):
        t0 = time.perf_counter()
        cluster = make_cluster(num_nodes=NUM_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
        print(f"  cluster: {NUM_HOSTS} hosts, K={NUM_NEIGHBORS}, built in {time.perf_counter() - t0:.1f} s")
        model = TopoScorer(**MODEL)
        sd = params_from_flax(init_flax_like(model, seed=WEIGHT_SEED))
        zero_counts()
        numbers, h0 = serving(cluster, model, sd)
        seen = counts()
        print(f"  kernel launches on the serving path: {seen}")
        if seen["neighbor_agg_fwd"] == 0:
            raise AssertionError("the serving path never launched neighbor_agg_fwd")
        launches = {k: launches[k] + v for k, v in seen.items()}
        numbers.update(cpu_check(model, sd))
        print(json.dumps({"serving": numbers, "card": card}))

    with phase("training"):
        zero_counts()
        train_numbers, state = training(cluster)
        seen = counts()
        print(f"  kernel launches on the training path: {seen}")
        if 0 in seen.values():
            raise AssertionError(f"the training path left a kernel unlaunched: {seen}")
        launches = {k: launches[k] + v for k, v in seen.items()}
        train_numbers["card_vs_cpu"] = cpu_train_check()
        print(json.dumps({"training": train_numbers, "card": card}))

    with phase("artifact"):
        print(json.dumps({"artifact": artifact_handoff(cluster, state), "card": card}))
        del state

    with phase("ingest"):
        zero_counts()
        numbers = ingest()
        # no kernel is on this path: SAGELayer and the MLP launch neither K1 nor K2
        numbers["kernel_launches"] = seen = counts()
        launches = {k: launches[k] + v for k, v in seen.items()}
        print(json.dumps({"ingest": numbers, "card": card}))

    with phase("sharded"):
        zero_counts()
        numbers = sharded(cluster)
        # no kernel is on this path: the sharded step runs SAGELayer's plain ops
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the sharded path launched a kernel it does not call: {seen}")
        print(json.dumps({"sharded": numbers, "card": card}))

    with phase("wiring"):
        zero_counts()
        numbers = wiring()
        # no kernel is on this path: the trainer runs SAGELayer's plain ops,
        # and serving runs the C++ scorer or GNNScorer's plain ops
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the wiring path launched a kernel it does not call: {seen}")
        print(json.dumps({"wiring": numbers, "card": card}))

    with phase("stress"):
        zero_counts()
        numbers = stress()
        # no kernel is on this path: the artifact's embedding runs SAGELayer's
        # plain ops, and scoring the C++ scorer or GNNScorer's plain ops
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the stress path launched a kernel it does not call: {seen}")
        print(json.dumps({"stress": numbers, "card": card}))

    with phase("evaluator"):
        zero_counts()
        numbers = evaluator()
        # no kernel is on this path: the evaluator scores through the C++
        # scorer or GNNScorer's plain ops
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the evaluator path launched a kernel it does not call: {seen}")
        print(json.dumps({"evaluator": numbers, "card": card}))

    with phase("scheduler"):
        zero_counts()
        numbers = scheduler_phase()
        # no kernel is on this path: the scheduler scores through the C++
        # scorer or GNNScorer's plain ops, and the trainer runs SAGELayer's
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the scheduler path launched a kernel it does not call: {seen}")
        print(json.dumps({"scheduler": numbers, "card": card}))

    with phase("swarm"):
        zero_counts()
        numbers = swarm()
        # no kernel is on this path: the swarm is the control plane over TCP
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the swarm path launched a kernel it does not call: {seen}")
        print(json.dumps({"swarm": numbers, "card": card}))

    with phase("rollout"):
        zero_counts()
        numbers = rollout()
        # no kernel is on this path: the scheduler scores through GNNScorer's
        # or the C++ scorer's plain ops, and the trainer runs SAGELayer's
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the rollout path launched a kernel it does not call: {seen}")
        print(json.dumps({"rollout": numbers, "card": card}))

    with phase("sim"):
        zero_counts()
        numbers = sim_phase()
        # no kernel is on this path: the simulator is host code, the learned
        # model trains with SAGELayer's plain ops and serves with GNNScorer's
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the sim path launched a kernel it does not call: {seen}")
        print(json.dumps({"sim": numbers, "card": card}))

    with phase("kernels"):
        g = cluster.graph.to("cuda")
        rows = [kernel_row_fwd(h0, g.neighbors, g.mask, launches["neighbor_agg_fwd"], usage["neighbor_agg_fwd"]),
                kernel_row_bwd(g.neighbors, g.mask, TRAIN.hidden, launches["neighbor_agg_bwd"],
                               usage["neighbor_agg_bwd"])]
        edge_cases()

    print(f"chip_smoke: every phase in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
