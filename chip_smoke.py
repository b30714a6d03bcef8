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
15. daemon   the daemon's P2P data plane in the port's processes (python -m
             ...daemon.server, the port's dfget, dfcache and dfmodel), each
             started with sys.executable and a deadline, on free ports from
             the OS, all stopped when the image phase (16) ends, whatever
             happens. The free disk under the phase's temp directory first;
             an origin process (aiohttp FileResponse, which serves Range) with
             a 1 GiB
             file of seeded bytes (numpy, seed 0), counting GETs and bytes;
             the port's manager process and one port scheduler process
             (--evaluator ml --manager, DRAGONFLY_NATIVE_SCORER=0 so that it
             serves GNNScorer, every round recorded); a seed daemon (--seed)
             and three peer daemons, each with its own storage, socket,
             127.0.0.x address, hostname and upload port chosen before boot,
             so that the trainer's telemetry (synth_telemetry_records, 200,000
             downloads and probes over 16384 hosts, the first four renamed to
             the daemons' host ids) names them: a GNN at the trainer's widths
             (hidden 256, embed 128, 3 layers, 100 steps) trained on the card
             by the port's trainer and published through the manager, until
             the scheduler's frame reads torch and its log says it serves on
             cuda. dfget through peer 1, then through peers 2 and 3 at once:
             every output's sha256 equals the file's, the origin served the
             file's bytes once, peers 2 and 3 took every piece from parents
             (each daemon's "task done" line), and every round of the task
             scored torch with ML_BASE_FALLBACK_TOTAL 0 for every reason (the
             scheduler's decision_records). Then kill -9 peer 1 and restart it
             on its storage (its log names the task's recovered pieces before
             DAEMON_READY), dfcache rm the task on peer 3 and dfget it again
             through peer 3: bit-exact, no new GET at the origin. Then the
             sharded phase's ~1 GiB of bf16 and f32 tensors in four
             safetensors files and the published GNN's weights as a fifth,
             dfmodel publish through the seed, dfmodel fetch through peer 2
             (every piece from parents), stage_checkpoint_dir(device="cuda"):
             every tensor bit-equal to its source, and a GNNScorer from the
             staged weights scoring 256 rounds of 40 within 1e-6 of one from
             the in-memory weights. Each dfget's MiB/s (host clock) and pieces
             by parent, the task's rounds, the fallbacks, the publish and
             fetch seconds, the fetch and staging GB/s.
16. image    the daemon's image-acceleration front and its object and registry
             origins, on the daemon phase's cluster, whose daemons booted with
             them: a proxy on each peer with --registry-mirror at the registry
             origin and --proxy-rule blobs/sha256.*; --hijack-ca-dir (a CA made by the port's ca.py, its
             backend printed) and --hijack-host ^localhost$ on peers 2 and 3;
             --sni-proxy-port on peer 3; --object-storage-port on the seed and
             peers 1 and 2 over one fs root (a shared bucket); every daemon
             trusting a second CA, which signs the origin's TLS leaf, through
             SSL_CERT_FILE. The registry origin, a process of the script's own
             (aiohttp), serves /v2/, a tagged OCI image manifest, its config
             blob and eight layers of seeded bytes (numpy, seed 0) of 512, 256,
             128, 64, 32, 16, 8 and 8 MiB (1 GiB) by digest with Range, on a
             plain port and behind TLS on 443, counting GETs and bytes per path.
             A docker-like client process pulls through peer 1's mirror (the
             manifest with the OCI Accept header, then every blob, 3 at once),
             then through peers 2 and 3 at once: every blob's sha256 equals its
             digest, blobs come with X-Dragonfly-Via: p2p and the manifest
             passes through, the origin served each layer's bytes once, every
             peer took each multi-piece layer's pieces from parents (a
             one-piece blob is named and counted), and every round of these
             tasks scored torch on the published version with no fallback.
             HTTPS hijack: CONNECT localhost:443 through peer 2's proxy, the
             client trusting only the hijack CA, pulls the 256 MiB layer
             bit-exact over P2P; CONNECT to this host's name is tunnelled to
             the origin's own leaf; then, to see where the pull's time goes,
             the same layer straight from the origin over TLS and again
             through peer 2's hijack (from its storage). The SNI proxy on peer 3: the 128 MiB layer
             as localhost over P2P, this host's name tunnelled. The gateway:
             dfstore make-bucket and put of a 256 MiB seeded object through the
             seed's gateway, get through peers 1 and 2 (sha256 equal, pieces
             from parents), stat, ls and rm. dfget oras://localhost/<artifact>
             through peer 3, held to its layer's bytes. Per leg: MiB/s (host
             clock, the client process to its end), pieces by parent, rounds
             and fallbacks, the origin's GETs and bytes; the CA backend and the
             forge time of a first leaf.
17. cluster  the secure, observable cluster through the port's dfcluster.Cluster
             (span files on): the manager with REST open, 2 federated
             schedulers (--evaluator ml, the manager link, --metrics-port 0,
             DRAGONFLY_NATIVE_SCORER=0, every round recorded), and a seed and
             three peer daemons spawned through the same Cluster, each with
             --data-tls-dir (one leaf for 127.0.0.1 from a port ca.py CA, its
             backend printed), --metrics-port 0 and a hostname and upload port
             chosen before boot. The daemon phase's GNN (hidden 256, embed
             128, 3 layers, 100 steps) trained on the card from
             daemon_records over 16384 hosts (the daemons' ids among them)
             and published through this manager: GET
             /api/v1/models/rollout/gnn shows it active, both schedulers'
             frames read torch and each /metrics renders
             ml_serving_mode{mode="torch"} 1. A 1 GiB file of seeded bytes
             preheated with POST /api/v1/jobs: the job reaches SUCCESS, the
             seed's conductor took the file from the origin, which served its
             bytes once. dfget --trace-file through peer 1, then peers 2 and 3
             at once, over mTLS: digest-exact, no more origin bytes, every
             piece from parents, every round torch with no fallback, each
             fetching daemon's piece_tls_handshakes_total above 0, no
             handshake failure on any, at least one resumed; the negotiated
             suite and the policy, MiB/s by the host clock. A client with no
             certificate is refused by a piece server. SIGTERM, then
             dfcluster.verify_trace (the dfget's rounds on exactly one
             scheduler, federation spans on both) and dftrace over the span
             files: peer 1's critical path and the top stages by exclusive
             time. Then python -m dragonfly2_tpu_torch.cli.dfcluster demo
             --verify-trace at its default size under a 120 s deadline.
18. kernels  each kernel against its plain PyTorch version on the card, at the
             main paths' shapes and on edge cases, and against itself over two
             launches (bit for bit), then timed with CUDA events beside its
             plain version, its bound and one PyTorch library call. K2 is
             timed with its transposed index built beforehand; the index
             build is timed on its own.
19. sage     K3 and K4, the fused SAGE message path, at the cluster's
             [16384, 16, H] for H 256 and 512: held against the plain ops
             (every element within one bf16 rounding, the bit-equal share
             printed), two launches bit for bit, then timed beside the plain
             path (forward under no_grad, backward by autograd over a kept
             graph) and their bound; their launches on one 10-step train call
             at the training phase's widths and on one refresh at the serving
             widths, once a layer each. ``--only sage`` runs the device phase
             and this one alone.

This script imports and launches nothing of the JAX package.
Launch counts are set to 0 just before each main path and read just after;
the phases that assert a path launches no kernel mean K1 and K2: on the card
every SAGE layer runs K3 and K4, whose counts the serving, training and sage
phases report.
Prints a ``{"kernels": [...]}`` line, the card line, and as its last line
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import asyncio
import collections
import concurrent.futures
import contextlib
import copy
import dataclasses
import hashlib
import io
import json
import os
import pathlib
import platform
import re
import shutil
import signal
import socket
import ssl
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
from dragonfly2_tpu_torch.ops import _build, neighbor_agg_cuda, neighbor_aggregate, sage_message
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
from dragonfly2_tpu_torch.scheduler.evaluator import (
    DECISION_RING_DEFAULT,
    FALLBACK_REASONS,
    SERVING_MODES,
    DecisionRecorder,
    MLEvaluator,
)
from dragonfly2_tpu_torch.scheduler.announcer import CHUNK_ROWS, TrainerAnnouncer
from dragonfly2_tpu_torch.scheduler.service import HostInfo, SchedulerService, TaskMeta
from dragonfly2_tpu_torch.security import CertForger, CertificateAuthority, write_issued
from dragonfly2_tpu_torch.sim import scenarios as sim_scenarios
from dragonfly2_tpu_torch.telemetry import TelemetryStorage
from dragonfly2_tpu_torch.tpuvm import safetensors as stlib
from dragonfly2_tpu_torch.tpuvm import staging
from dragonfly2_tpu_torch.trainer import artifacts, dataset, train_gnn, train_mlp
from dragonfly2_tpu_torch.trainer.server import start_trainer, stop_trainer
from dragonfly2_tpu_torch.trainer.service import TrainerConfig, TrainerService, pack_records
from dragonfly2_tpu_torch.trainer.synthetic import make_cluster, sample_batch, synth_telemetry_records
from dragonfly2_tpu_torch.utils import idgen
from dragonfly2_tpu_torch.utils import proc as proc_lib
from dragonfly2_tpu_torch.utils.pieces import compute_piece_size, piece_count

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
# identities, so the mesh run (DTensors: SAGELayer's plain ops) differs from
# one device (K3 and K4) by the order of the backward's atomic adds and of
# the fused op's f32 sums, and where msg_edge's cuBLAS product rounds its
# edge term otherwise (tests/test_torch_parallel.py holds mesh against one
# process, both plain, to the same 1e-4 / 1e-3); mp_train's own cluster (128
# hosts, 12 steps)
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
# the daemon phase: a 1 GiB file of seeded bytes (a large image layer or a
# checkpoint shard) through a seed and three peer daemons; the scheduler's
# GNN trained on the card at the trainer's widths (the ingest phase's 100
# GNN steps) from DAEMON_RECORDS download and probe records each over the
# serving cluster's hosts; the processes' deadlines; the free disk the phase
# needs (the file in the origin, four stores, the outputs and the checkpoint)
DAEMON_FILE_BYTES, DAEMON_FILE_SEED, DAEMON_RECORDS, DAEMON_RECORD_SEED = 1 << 30, 0, 200_000, 13
DAEMON_BOOT_S, DAEMON_ATTACH_S, DAEMON_DOWNLOAD_S, DAEMON_ROUND_SEED = 120.0, 120.0, 300.0, 43
DAEMON_DISK_BYTES = 24 << 30
# the image phase, on the daemon phase's cluster: an eight-layer OCI image of
# seeded bytes (numpy, seed 0), 1 GiB in all, a few large base layers and many
# small ones as real images have, pulled as docker pulls (3 blobs at once)
# through the peers' registry mirror; the layers the hijack, SNI and oras://
# legs fetch (by index); the object put through the gateway; the registry
# origin's TLS port (the SNI proxy reaches a hijacked name on 443)
IMAGE_LAYER_MIB, IMAGE_SEED, IMAGE_PULL_CONCURRENCY = (512, 256, 128, 64, 32, 16, 8, 8), 0, 3
IMAGE_REPO, IMAGE_TAG, ORAS_REPO, ORAS_TAG = "library/dragonfly-demo", "v1", "library/dragonfly-artifact", "v1"
IMAGE_HIJACK_LAYER, IMAGE_SNI_LAYER, IMAGE_ORAS_LAYER, IMAGE_TLS_PORT = 1, 2, 3, 443
GATEWAY_OBJECT_BYTES, GATEWAY_SEED = 256 << 20, 1
# the cluster phase: the daemon phase's file, records, widths and steps on a
# fresh dfcluster cluster (2 federated ml schedulers; a seed and three peers
# on the mTLS piece plane); the preheat job's and the demo's deadlines; the
# free disk it needs (the file in the origin, four stores, three outputs)
CLUSTER_SCHEDULERS, CLUSTER_PREHEAT_S, CLUSTER_DEMO_S, CLUSTER_DISK_BYTES = 2, 300.0, 120.0, 10 << 30
OCI_MANIFEST = "application/vnd.oci.image.manifest.v1+json"
REPO = pathlib.Path(__file__).resolve().parent
# tests/test_ops.py's own tolerances for the Pallas kernel against XLA
TOL = {torch.float32: dict(rtol=2e-4, atol=2e-5), torch.bfloat16: dict(rtol=3e-2, atol=3e-2)}
EMBED_MIN_COSINE, SCORE_MAX_ABS = 0.999, 5e-3
# H100 SXM data sheet: HBM rate and the f32 rate outside the tensor cores
HBM_BYTES_PER_S, F32_FLOPS_PER_S = 3.35e12, 67e12
# K3 and K4, the fused SAGE message path: the instructions a live element of
# [N, K, H] needs, for their bound beside the bytes, tallied from the ops of
# csrc/neighbor_agg.cu at 4 edge features, an f32 op rounded to bf16 counting
# 3 (the op, the narrowing, the widening) and the precise tanhf with its
# rounding 18 (libdevice's, an estimate: no tool here counts the card's
# instructions). The pre-activation x, 13: u's widening, the edge term's 4
# FMAs and rounding, two rounded adds. t = tanh(c(x + kx^3)), 33: five rounded
# ops and tanhf. The forward's rest, 13: GELU's three rounded ops, the mask's
# rounded product, the f32 sum. The VJP's own ops, given x and t, 57: 16
# rounded ops, the mask's product, g_s's sum, g_We's 4 FMAs, dx's narrowing.
# And the widths they are timed at.
SAGE_PREACT_INSTR, SAGE_TANH_INSTR, SAGE_FWD_REST_INSTR, SAGE_VJP_INSTR = 13, 33, 13, 57
SAGE_WIDTHS = (256, 512)
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
    the same start and seed: the plain message path against the fused one
    (K3 and K4), whose launches are counted on both sides."""
    def launched_since(before: dict) -> dict:
        return {k: v - before[k] for k, v in sage_counts().items()}

    before = sage_counts()
    plain_state, plain_losses, plain = train_run(cluster, TRAIN, SHARDED_CALLS)
    plain["sage_launches"] = launched_since(before)
    want = {k: v.detach().cpu() for k, v in plain_state.model.state_dict().items()}
    del plain_state
    before = sage_counts()
    state, losses, sharded = train_run(cluster, TRAIN, SHARDED_CALLS, mesh=mesh)
    sharded["sage_launches"] = launched_since(before)
    steps = SHARDED_CALLS * STEPS_PER_CALL * TRAIN.num_layers
    print(f"  K3/K4 launches: one device {plain['sage_launches']}, mesh {sharded['sage_launches']}")
    if (plain["sage_launches"] != {"sage_message_fwd": steps, "sage_message_bwd": steps}
            or any(sharded["sage_launches"].values())):
        raise AssertionError(f"want {steps} K3 and K4 launches on one device and none on the mesh: "
                             f"{plain['sage_launches']}, {sharded['sage_launches']}")
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
        raise AssertionError(f"a world of one parts from one device by more than summation order: loss {loss_err} > "
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


ORIGIN_SCRIPT = '''\
"""The daemon phase's origin: serves the files of one directory with Range
(aiohttp FileResponse) and counts GETs, HEADs and the bytes of each GET.
    python origin.py <dir>    prints ORIGIN_READY <port>; GET /_stats for counts."""
import asyncio, os, signal, sys
from aiohttp import web

ROOT, STATS = sys.argv[1], {"gets": 0, "heads": 0, "bytes": 0}


async def serve(request):
    path = os.path.join(ROOT, os.path.basename(request.match_info["name"]))
    if not os.path.isfile(path):
        raise web.HTTPNotFound()
    if request.method == "HEAD":
        STATS["heads"] += 1
    else:
        STATS["gets"] += 1
        STATS["bytes"] += len(range(os.path.getsize(path))[request.http_range])
    return web.FileResponse(path)


async def stats(request):
    return web.json_response(STATS)


async def main():
    app = web.Application()
    app.router.add_get("/_stats", stats)
    app.router.add_get("/{name}", serve)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    site = web.TCPSite(runner, "127.0.0.1", 0)
    await site.start()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        asyncio.get_running_loop().add_signal_handler(sig, stop.set)
    print("ORIGIN_READY", site._server.sockets[0].getsockname()[1], flush=True)
    await stop.wait()
    await runner.cleanup()


asyncio.run(main())
'''


class DaemonCluster:
    """The daemon phase's processes: each started with ``sys.executable``,
    its standard error in a log file under the phase's directory, and all of
    them stopped by ``close()`` (terminate, then kill what is left after
    10 s)."""

    def __init__(self, tmp: pathlib.Path, env: dict):
        self.tmp, self.env = tmp, env
        self.procs: dict[str, subprocess.Popen] = {}
        self.logs: dict[str, pathlib.Path] = {}

    def spawn(self, name: str, args: list[str], extra_env: dict | None = None) -> subprocess.Popen:
        self.logs[name] = self.tmp / f"{name}.log"
        with open(self.logs[name], "w") as err:
            p = subprocess.Popen([sys.executable, *args], cwd=self.tmp, env={**self.env, **(extra_env or {})},
                                 stdout=subprocess.PIPE, stderr=err, text=True)
        self.procs[name] = p
        return p

    def ready(self, name: str, prefix: str, deadline: float) -> str:
        """The first word after ``prefix`` on ``name``'s ready line, read by
        the deadline; the end of its log when it did not start."""
        try:
            return proc_lib.ready_address(self.procs[name], prefix, deadline)
        except RuntimeError as e:
            raise AssertionError(f"{name}: {e}: {self.logs[name].read_text()[-2000:]}") from None

    def stop(self, name: str, kill: bool = False) -> None:
        p = self.procs.pop(name)
        if kill:
            p.kill()
        else:
            p.terminate()
        try:
            p.wait(timeout=10)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        p.stdout.close()

    def close(self) -> None:
        for p in self.procs.values():
            if p.poll() is None:
                p.terminate()
        for name in list(self.procs):
            self.stop(name)


def free_port(ip: str) -> int:
    with contextlib.closing(socket.socket()) as s:
        s.bind((ip, 0))
        return s.getsockname()[1]


def write_seeded_file(path: pathlib.Path, nbytes: int, seed: int) -> str:
    """``nbytes`` of seeded bytes (numpy, in 64 MiB chunks); their sha256."""
    rng, h = np.random.default_rng(seed), hashlib.sha256()
    with open(path, "wb") as f:
        for off in range(0, nbytes, 64 << 20):
            chunk = rng.integers(0, 256, min(64 << 20, nbytes - off), dtype=np.uint8).tobytes()
            h.update(chunk)
            f.write(chunk)
    return h.hexdigest()


def file_sha256(path: pathlib.Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        while chunk := f.read(16 << 20):
            h.update(chunk)
    return h.hexdigest()


def daemon_records(host_ids: list[str]) -> tuple[np.ndarray, np.ndarray]:
    """The trainer's telemetry for the daemon phase: synthetic records over
    the serving cluster's 16384 hosts, the first of which are renamed to the
    daemons' host ids, so the trained graph holds every daemon."""
    downloads, probes = synth_telemetry_records(DAEMON_RECORDS, DAEMON_RECORDS, NUM_HOSTS, seed=DAEMON_RECORD_SEED)
    for i, hid in enumerate(host_ids):
        old, new = f"host-{i:06d}".encode(), hid.encode()
        for arr, col in ((downloads, "child_host_id"), (downloads, "parent_host_id"),
                         (probes, "src_host_id"), (probes, "dst_host_id")):
            arr[col][arr[col] == old] = new
    return downloads, probes


async def daemon_train(tmp: pathlib.Path, maddr: str, host_ids: list[str]) -> dict:
    """The records through the port's announcer to the port's trainer on the
    card, which publishes to the manager process; the GNN run's row."""
    downloads, probes = daemon_records(host_ids)
    store = TelemetryStorage(tmp / "telemetry")
    store.downloads.extend(downloads)
    store.probes.extend(probes)
    store.flush()
    cfg = TrainerConfig(model_dir=str(tmp / "models"), gnn_steps=INGEST_GNN_STEPS, gnn_steps_per_call=10)
    trainer, service = await start_trainer(cfg, port=0, manager_addr=maddr)
    try:
        return await rollout_train(store, trainer.address, service, "chip-smoke-daemon")
    finally:
        await stop_trainer(trainer, service)


async def wait_serving(maddr: str, hostname: str, deadline: float) -> dict:
    """The scheduler's stats frame at the manager, once it reads torch."""
    from dragonfly2_tpu_torch.rpc.manager import RemoteManagerClient

    mc = RemoteManagerClient(maddr)
    try:
        while True:
            frames = {m["hostname"]: m["frame"] for m in (await mc.cluster_stats())["members"]}
            if frames.get(hostname, {}).get("serving_mode") == "torch":
                return frames[hostname]
            if time.monotonic() > deadline:
                raise AssertionError(f"the scheduler's frame by the deadline: {frames.get(hostname)}")
            await asyncio.sleep(0.25)
    finally:
        await mc.close()


async def task_rounds(saddr: str, task_id: str) -> dict:
    """The scheduler's decision records of the task (every round: the
    process samples 1 in 1) and its ML_BASE_FALLBACK_TOTAL by reason."""
    from dragonfly2_tpu_torch.rpc.scheduler import RemoteSchedulerClient

    client = RemoteSchedulerClient(saddr)
    try:
        return await client.decision_records(task_id=task_id, limit=DECISION_RING_DEFAULT, with_features=False)
    finally:
        await client.close()


def done_line(log: pathlib.Path, task_id: str) -> dict:
    """The conductor's last ``task done`` line for the task in a daemon's log:
    its pieces by parent peer and its bytes from the source."""
    pat = re.compile(r"task_id=" + task_id[:16] + r".*task done: (\d+) piece\(s\) from parents (\{.*\}), "
                     r"(\d+) byte\(s\) from source")
    found = [m for m in map(pat.search, log.read_text().splitlines()) if m]
    if not found:
        raise AssertionError(f"no 'task done' line for {task_id[:16]} in {log.name}")
    m = found[-1]
    return {"pieces": int(m.group(1)), "by_parent": json.loads(m.group(2)), "source_bytes": int(m.group(3))}


def parent_names(by_parent: dict, names: dict) -> dict:
    """Pieces by parent daemon: a peer id is ``<ip>-<hostname>-<random>``."""
    out: dict[str, int] = {}
    for pid, n in by_parent.items():
        name = next((k for k, h in names.items() if f"-{h}-" in pid), pid)
        out[name] = out.get(name, 0) + n
    return out


def dfget_run(cluster: DaemonCluster, url: str, out: pathlib.Path, sock: str) -> subprocess.Popen:
    """The port's dfget as a process, through the daemon on ``sock``."""
    return subprocess.Popen([sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfget", url, "-O", str(out),
                             "--sock", sock, "--no-spawn", "--timeout", str(DAEMON_DOWNLOAD_S)],
                            cwd=cluster.tmp, env=cluster.env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def dfget_wait(p: subprocess.Popen, deadline: float) -> None:
    try:
        _, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        p.kill()
        p.communicate()
        raise AssertionError("dfget ran past the download deadline") from None
    if p.returncode:
        raise AssertionError(f"dfget exited {p.returncode}: {err[-2000:]}")


def origin_stats(port: int) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/_stats", timeout=10) as r:
        return json.loads(r.read())


def daemon_checkpoint(directory: pathlib.Path, gnn_sd: dict) -> dict[str, np.ndarray]:
    """About 1 GiB of bf16 and f32 tensors from a seed (the sharded phase's
    source) in four files, and the published GNN's weights as a fifth;
    returns every tensor by name (bf16 as uint16 bits)."""
    directory.mkdir()
    src = stage_source()
    files = {"model-00001-of-00004.safetensors": ["layers.0.w", "layers.1.w"],
             "model-00002-of-00004.safetensors": ["layers.2.w", "layers.3.w"],
             "model-00003-of-00004.safetensors": ["layers.4.w", "layers.5.w", "layers.6.w"],
             "model-00004-of-00004.safetensors": ["f32.0", "f32.1", "f32.2"]}
    for name, keys in files.items():
        stlib.write_safetensors(directory / name, {k: src[k] for k in keys},
                                bf16_names=[k for k in keys if k.startswith("layers.")])
    gnn = {}
    for k, t in gnn_sd.items():
        t = t.detach().cpu().contiguous()
        gnn[f"gnn.{k}"] = t.view(torch.int16).numpy().view(np.uint16) if t.dtype == torch.bfloat16 else t.numpy()
    stlib.write_safetensors(directory / "gnn.safetensors", gnn,
                            bf16_names=[f"gnn.{k}" for k, t in gnn_sd.items() if t.dtype == torch.bfloat16])
    return {**src, **gnn}


def daemon_scorer_check(model, sd: dict, staged: dict, graph) -> float:
    """256 rounds of 40 scored on the card from the staged GNN weights and
    from the in-memory ones: the largest score gap."""
    staged_sd = {k.removeprefix("gnn."): v for k, v in staged.items() if k.startswith("gnn.")}
    if staged_sd.keys() != sd.keys():
        raise AssertionError(f"the staged GNN holds {sorted(staged_sd)[:4]}…, not the model's parameters")
    rng = np.random.default_rng(DAEMON_ROUND_SEED)
    n = graph.node_feats.shape[0]
    child = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
    parent = rng.integers(0, n, (ROUNDS, CANDIDATES), dtype=np.int32)
    feats = rng.random((ROUNDS, CANDIDATES, FEATURE_DIM), dtype=np.float32)
    scores = []
    for weights in (staged_sd, sd):
        scorer = GNNScorer(model, weights, device="cuda")
        scorer.refresh(graph)
        scores.append(drive_rounds(scorer, feats, child, parent)[1])
    return float(np.abs(scores[0] - scores[1]).max())


def daemon_phase(stack: contextlib.ExitStack) -> tuple[dict, dict]:
    """The daemon's P2P data plane in the port's processes (see the module
    docstring): its numbers, and the cluster, left running for the image
    phase (``image_front``'s flags are on its daemons); ``stack`` stops every
    process and removes the phase's directory."""
    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-daemon-"))
    stack.callback(shutil.rmtree, tmp, ignore_errors=True)
    free = shutil.disk_usage(tmp).free
    print(f"  free disk under {tmp}: {free / 2**30:.1f} GiB")
    if free < DAEMON_DISK_BYTES:
        raise AssertionError(f"the phase needs {DAEMON_DISK_BYTES / 2**30:.0f} GiB free, {free / 2**30:.1f} there")
    env = {**os.environ, "PYTHONPATH": str(REPO), "DRAGONFLY_TS_INTERVAL": "0.5"}
    cluster = DaemonCluster(tmp, env)
    stack.callback(cluster.close)
    names = {"seed": "df-seed", "peer1": "df-peer1", "peer2": "df-peer2", "peer3": "df-peer3"}
    ips = {k: f"127.0.0.{i + 2}" for i, k in enumerate(names)}
    ports = {k: free_port(ips[k]) for k in names}
    host_ids = {k: f"{names[k]}-{ports[k]}" for k in names}
    socks = {k: str(tmp / f"{k}.sock") for k in names}
    numbers: dict = {"host_ids": host_ids, "file_bytes": DAEMON_FILE_BYTES}
    front = image_front(tmp, ips)
    deadline = time.monotonic() + DAEMON_BOOT_S
    (tmp / "origin.py").write_text(ORIGIN_SCRIPT)
    (tmp / "www").mkdir()
    cluster.spawn("origin", [str(tmp / "origin.py"), str(tmp / "www")])
    cluster.spawn("manager", ["-m", "dragonfly2_tpu_torch.manager.server", "--host", "127.0.0.1", "--port", "0",
                              "--db", str(tmp / "manager.db")])
    t0 = time.perf_counter()
    want = write_seeded_file(tmp / "www" / "blob.bin", DAEMON_FILE_BYTES, DAEMON_FILE_SEED)
    numbers["origin_file_s"] = time.perf_counter() - t0
    oport = int(cluster.ready("origin", "ORIGIN_READY", deadline))
    maddr = cluster.ready("manager", "manager ready", deadline).removeprefix("rpc=")
    cluster.spawn("scheduler", ["-m", "dragonfly2_tpu_torch.scheduler.server", "--host", "127.0.0.1",
                                "--port", "0", "--evaluator", "ml", "--manager", maddr, "--hostname", "df-sched",
                                "--keepalive-interval", "1", "--model-watch-interval", "1"],
                  {"DRAGONFLY_NATIVE_SCORER": "0", "DRAGONFLY_DECISION_SAMPLE": "1"})
    saddr = cluster.ready("scheduler", "SCHEDULER_READY", deadline)
    daemon_args = {k: ["-m", "dragonfly2_tpu_torch.daemon.server", "--scheduler", saddr, "--storage", str(tmp / k),
                       "--sock", socks[k], "--ip", ips[k], "--hostname", names[k], "--upload-port", str(ports[k]),
                       "--announce-interval", "2", *(["--seed"] if k == "seed" else []), *front["args"][k]]
                   for k in names}
    for k in names:
        cluster.spawn(k, daemon_args[k], front["env"])
    t0 = time.perf_counter()
    row = asyncio.run(daemon_train(tmp, maddr, list(host_ids.values())))
    numbers["train_to_published_s"] = time.perf_counter() - t0
    for k in names:
        if cluster.ready(k, "DAEMON_READY", deadline) != socks[k]:
            raise AssertionError(f"{k} is not ready on {socks[k]}")
    t0 = time.perf_counter()
    frame = asyncio.run(wait_serving(maddr, "df-sched", time.monotonic() + DAEMON_ATTACH_S))
    numbers["published_to_torch_frame_s"] = time.perf_counter() - t0
    if "via engine torch on cuda" not in cluster.logs["scheduler"].read_text():
        raise AssertionError("the scheduler does not serve the model on the card")
    model, gnn_sd = artifacts.load_gnn(row["artifact"])
    graph, index = artifacts.load_graph(row["artifact"])
    missing = [h for h in host_ids.values() if h not in index]
    if missing or len(index) != NUM_HOSTS:
        raise AssertionError(f"the model's graph: {len(index)} hosts, missing the daemons {missing}")
    print(f"  origin, manager, scheduler and 4 daemons up; GNN {row['version']} trained on the card from "
          f"{2 * DAEMON_RECORDS} records over {NUM_HOSTS} hosts (the daemons' ids among them) and published in "
          f"{numbers['train_to_published_s']:.1f} s; the scheduler's frame reads torch "
          f"{numbers['published_to_torch_frame_s']:.1f} s later (serving {frame.get('serving_mode')!r})")

    # downloads: peer 1, then peers 2 and 3 at once
    url = f"http://127.0.0.1:{oport}/blob.bin"
    task_id = idgen.task_id(url)
    outs = {k: tmp / f"{k}.out" for k in ("peer1", "peer2", "peer3")}
    runs: dict[str, dict] = {}
    dl_deadline = time.monotonic() + DAEMON_DOWNLOAD_S
    t0 = time.perf_counter()
    dfget_wait(dfget_run(cluster, url, outs["peer1"], socks["peer1"]), dl_deadline)
    runs["peer1"] = {"s": time.perf_counter() - t0}
    after_first = origin_stats(oport)
    t0 = time.perf_counter()
    ps = {k: dfget_run(cluster, url, outs[k], socks[k]) for k in ("peer2", "peer3")}
    for k, p in ps.items():
        dfget_wait(p, dl_deadline)
        runs[k] = {"s": time.perf_counter() - t0}
    after_all = origin_stats(oport)
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        shas = dict(zip(outs, pool.map(file_sha256, outs.values())))
    for k, run in runs.items():
        run.update(done_line(cluster.logs[k], task_id), mib_per_s=DAEMON_FILE_BYTES / run["s"] / 2**20)
        run["by_parent"] = parent_names(run["by_parent"], names)
        print(f"  dfget through {k}: {run['s']:.2f} s, {run['mib_per_s']:.1f} MiB/s (host clock, "
              f"dfget process to exit), pieces by parent {run['by_parent']}, {run['source_bytes']} bytes "
              f"from the source")
    if any(s != want for s in shas.values()):
        raise AssertionError(f"sha256 of the outputs {shas} != the origin file's {want}")
    if after_all["bytes"] != DAEMON_FILE_BYTES or after_all["gets"] != after_first["gets"]:
        raise AssertionError(f"the origin served {after_all} (after peer 1: {after_first}), "
                             f"not the file's {DAEMON_FILE_BYTES} bytes once")
    for k in ("peer2", "peer3"):
        total = runs[k]["pieces"]
        if runs[k]["source_bytes"] or sum(runs[k]["by_parent"].values()) != total or not total:
            raise AssertionError(f"{k} did not take every piece from parents: {runs[k]}")
    rounds = asyncio.run(task_rounds(saddr, task_id))
    modes = [(r["serving_mode"], r["model_version"]) for r in rounds["records"]]
    fb = rounds["fallbacks"]
    print(f"  the scheduler's rounds for the task: {len(modes)} ({dict(collections.Counter(modes))}); "
          f"ML_BASE_FALLBACK_TOTAL {fb}; origin {after_all}")
    if not modes or any(m != ("torch", row["version"]) for m in modes) or any(fb.values()):
        raise AssertionError(f"rounds {modes}, fallbacks {fb}: not every round scored torch on the card")
    for p in outs.values():
        p.unlink()
    numbers.update(downloads=runs, origin=after_all, task_rounds=len(modes), fallbacks=fb)

    # restart: kill -9 peer 1, restart it on the same storage, then drop
    # the task on peer 3 and fetch it again through peer 3
    cluster.stop("peer1", kill=True)
    pathlib.Path(socks["peer1"]).unlink(missing_ok=True)
    t0 = time.perf_counter()
    cluster.spawn("peer1-restart", daemon_args["peer1"], front["env"])
    cluster.ready("peer1-restart", "DAEMON_READY", time.monotonic() + DAEMON_BOOT_S)
    restart_s = time.perf_counter() - t0
    recovered = [ln for ln in cluster.logs["peer1-restart"].read_text().splitlines()
                 if f"task {task_id[:12]}: recovered" in ln]
    if not recovered:
        raise AssertionError("the restarted daemon's log names no recovered piece of the task")
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dfcache", ["--sock", socks["peer3"], "--no-spawn", "rm",
                                                                task_id], env)
    if rc:
        raise AssertionError(f"dfcache rm exited {rc}")
    t0 = time.perf_counter()
    dfget_wait(dfget_run(cluster, url, outs["peer3"], socks["peer3"]), dl_deadline)
    again = {"s": time.perf_counter() - t0, **done_line(cluster.logs["peer3"], task_id)}
    again["by_parent"] = parent_names(again["by_parent"], names)
    after_restart = origin_stats(oport)
    sha = file_sha256(outs["peer3"])
    outs["peer3"].unlink()
    print(f"  peer 1 killed and restarted in {restart_s:.2f} s: {recovered[-1].split('daemon.engine ')[-1]}; the task "
          f"removed from peer 3 and fetched again in {again['s']:.2f} s, pieces by parent "
          f"{again['by_parent']}; origin {after_restart}")
    if sha != want or after_restart["gets"] != after_all["gets"] or again["source_bytes"]:
        raise AssertionError(f"after the restart: sha256 {sha}, origin {after_restart}, {again}")
    rounds = asyncio.run(task_rounds(saddr, task_id))
    fb = rounds["fallbacks"]
    if any(r["serving_mode"] != "torch" for r in rounds["records"]) or any(fb.values()):
        raise AssertionError(f"the restart's rounds fell back: {fb}")
    numbers["restart"] = {"restart_s": restart_s, "refetch": again, "task_rounds": len(rounds["records"])}

    # checkpoint: published through the seed, fetched through peer 2,
    # staged onto the card
    src = daemon_checkpoint(tmp / "ckpt", gnn_sd)
    nbytes = sum(p.stat().st_size for p in (tmp / "ckpt").iterdir())
    t0 = time.perf_counter()
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dfmodel", ["--sock", socks["seed"], "--no-spawn",
                                                                "publish", str(tmp / "ckpt")], env)
    publish_s = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"dfmodel publish exited {rc}")
    manifest = tmp / "ckpt" / "dragonfly-checkpoint.json"
    t0 = time.perf_counter()
    rc, text = cli_process("dragonfly2_tpu_torch.cli.dfmodel", ["--sock", socks["peer2"], "--no-spawn",
                                                                "fetch", str(manifest), "-O",
                                                                str(tmp / "staged")], env)
    fetch_s = time.perf_counter() - t0
    if rc:
        raise AssertionError(f"dfmodel fetch exited {rc}")
    entries = json.loads(manifest.read_text())["files"]
    fetched = [done_line(cluster.logs["peer2"], e["task_id"]) for e in entries]
    if any(f["source_bytes"] or sum(f["by_parent"].values()) != f["pieces"] for f in fetched):
        raise AssertionError(f"the checkpoint did not arrive peer to peer: {fetched}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    staged = staging.stage_checkpoint_dir(tmp / "staged", device="cuda")
    torch.cuda.synchronize()
    stage_s = time.perf_counter() - t0
    wrong = [k for k, a in src.items() if staged_bits(staged[k]).tobytes()
             != (a.view(np.int16) if a.dtype == np.uint16 else a).tobytes()]
    if wrong or len(staged) != len(src):
        raise AssertionError(f"staged tensors differ from their source: {wrong[:4]} ({len(staged)} of {len(src)})")
    gap = daemon_scorer_check(model, gnn_sd, staged, graph)
    del staged
    print(f"  checkpoint: {len(entries)} files, {nbytes / 2**30:.3f} GiB; publish through the seed "
          f"{publish_s:.2f} s, fetch through peer 2 {fetch_s:.2f} s ({nbytes / fetch_s / 1e9:.2f} GB/s, host "
          f"clock, dfmodel process to exit), every piece from parents; staged onto the card in {stage_s:.3f} s "
          f"({nbytes / stage_s / 1e9:.2f} GB/s, closed by a synchronise), bit-equal; a GNNScorer from the "
          f"staged weights against one from the in-memory weights: largest score gap {gap:.3g} over "
          f"{ROUNDS} rounds")
    if gap > RELOAD_SCORE_MAX_ABS:
        raise AssertionError(f"the staged GNN scores {gap} away from the in-memory one")
    numbers["checkpoint"] = {"files": len(entries), "bytes": nbytes, "publish_s": publish_s,
                             "fetch_s": fetch_s, "fetch_gb_per_s": nbytes / fetch_s / 1e9,
                             "stage_s": stage_s, "stage_gb_per_s": nbytes / stage_s / 1e9,
                             "score_max_abs": gap}
    numbers.update(host_cpu=host_cpu(), wall_s=time.perf_counter() - t_phase)
    logs = {**{k: cluster.logs[k] for k in names}, "peer1": cluster.logs["peer1-restart"]}
    ctx = {"tmp": tmp, "cluster": cluster, "env": env, "names": names, "ips": ips, "socks": socks, "logs": logs,
           "saddr": saddr, "version": row["version"], "front": front}
    return numbers, ctx


REGISTRY_SCRIPT = '''\
"""The image phase's OCI registry origin: /v2/, manifests by tag or digest and
blobs by digest (aiohttp FileResponse, which serves Range) from one directory,
on a plain listener and on a TLS one; it counts GETs and the bytes of each GET
per listener and path.
    python registry.py <dir> <plain port> <tls port> <cert> <key>
prints REGISTRY_READY; GET /_stats on the plain listener for the counts."""
import asyncio, collections, hashlib, os, signal, ssl, sys
from aiohttp import web

ROOT = sys.argv[1]
STATS = {"plain": collections.defaultdict(lambda: {"gets": 0, "bytes": 0}),
         "tls": collections.defaultdict(lambda: {"gets": 0, "bytes": 0})}


def count(request, nbytes):
    if request.method == "GET":
        s = STATS["tls" if request.secure else "plain"][request.path]
        s["gets"] += 1
        s["bytes"] += nbytes


async def ping(request):
    return web.json_response({})


async def manifest(request):
    path = os.path.join(ROOT, "manifests", request.match_info["repo"].replace("/", "_"), request.match_info["ref"])
    if not os.path.isfile(path):
        raise web.HTTPNotFound()
    with open(path, "rb") as f:
        body = f.read()
    count(request, len(body))
    return web.Response(body=body, content_type="application/vnd.oci.image.manifest.v1+json",
                        headers={"Docker-Content-Digest": "sha256:" + hashlib.sha256(body).hexdigest()})


async def blob(request):
    path = os.path.join(ROOT, "blobs", os.path.basename(request.match_info["digest"]))
    if not os.path.isfile(path):
        raise web.HTTPNotFound()
    count(request, len(range(os.path.getsize(path))[request.http_range]))
    return web.FileResponse(path, headers={"Docker-Content-Digest": request.match_info["digest"],
                                           "Content-Type": "application/octet-stream"})


async def stats(request):
    return web.json_response(STATS)


async def main():
    app = web.Application()
    app.router.add_get("/_stats", stats)
    app.router.add_get("/v2/", ping)
    app.router.add_get("/v2/{repo:.+}/manifests/{ref}", manifest)
    app.router.add_get("/v2/{repo:.+}/blobs/{digest}", blob)
    runner = web.AppRunner(app, access_log=None)
    await runner.setup()
    ctx = ssl.create_default_context(ssl.Purpose.CLIENT_AUTH)
    ctx.load_cert_chain(sys.argv[4], sys.argv[5])
    await web.TCPSite(runner, "127.0.0.1", int(sys.argv[2])).start()
    await web.TCPSite(runner, "0.0.0.0", int(sys.argv[3]), ssl_context=ctx).start()
    stop = asyncio.Event()
    for sig in (signal.SIGINT, signal.SIGTERM):
        asyncio.get_running_loop().add_signal_handler(sig, stop.set)
    print("REGISTRY_READY", sys.argv[2], flush=True)
    await stop.wait()
    await runner.cleanup()


asyncio.run(main())
'''

CLIENT_SCRIPT = '''\
"""The image phase's clients, one run a process, each printing one JSON line:
    client.py pull <base URL> <repo> <tag> <concurrency>
        a docker-like pull through a registry mirror: /v2/, the manifest with
        the OCI Accept header, then every blob by digest (the config and the
        layers, <concurrency> at once), each hashed as it streams and held to
        its digest; the bodies are discarded.
    client.py connect <proxy host:port> <target host:port> <path> <CA file>
        CONNECT through an HTTP proxy, then TLS as the target's host name
        trusting only <CA file>, and GET <path>.
    client.py sni <host:port> <server name> <path> <CA file>
        TLS straight to an SNI proxy as <server name>, and GET <path>."""
import asyncio, hashlib, json, ssl, sys, time
import aiohttp

ACCEPT = "application/vnd.oci.image.manifest.v1+json, application/vnd.docker.distribution.manifest.v2+json"


async def fetch_blob(sess, url, digest, sem):
    async with sem:
        t0, h, n = time.perf_counter(), hashlib.sha256(), 0
        async with sess.get(url) as r:
            async for chunk in r.content.iter_chunked(1 << 20):
                h.update(chunk)
                n += len(chunk)
            return {"digest": digest, "status": r.status, "via": r.headers.get("X-Dragonfly-Via"), "bytes": n,
                    "sha_ok": "sha256:" + h.hexdigest() == digest, "s": time.perf_counter() - t0}


async def pull(base, repo, tag, concurrency):
    timeout = aiohttp.ClientTimeout(total=None, sock_read=300)
    async with aiohttp.ClientSession(timeout=timeout) as sess:
        async with sess.get(f"{base}/v2/") as r:
            ping = r.status
        async with sess.get(f"{base}/v2/{repo}/manifests/{tag}", headers={"Accept": ACCEPT}) as r:
            body = await r.read()
            man = {"status": r.status, "via": r.headers.get("X-Dragonfly-Via"),
                   "content_type": r.headers.get("Content-Type"), "bytes": len(body)}
        m = json.loads(body)
        sem = asyncio.Semaphore(concurrency)
        blobs = [m["config"]] + m["layers"]
        got = await asyncio.gather(*(fetch_blob(sess, f"{base}/v2/{repo}/blobs/{b['digest']}", b["digest"], sem)
                                     for b in blobs))
    return {"ping": ping, "manifest": man, "blobs": got}


async def tls_get(reader, writer, server_name, path, cafile):
    t0 = time.perf_counter()
    await writer.start_tls(ssl.create_default_context(cafile=cafile), server_hostname=server_name)
    handshake = time.perf_counter() - t0
    cert = writer.get_extra_info("peercert")
    der = writer.get_extra_info("ssl_object").getpeercert(binary_form=True)
    writer.write(f"GET {path} HTTP/1.1\\r\\nHost: {server_name}\\r\\nConnection: close\\r\\n\\r\\n".encode())
    await writer.drain()
    status = (await reader.readline()).decode().split()[1]
    headers = {}
    while (line := await reader.readline()) not in (b"\\r\\n", b""):
        k, _, v = line.decode().partition(":")
        headers[k.strip().lower()] = v.strip()
    h, n = hashlib.sha256(), 0
    while chunk := await reader.read(1 << 20):
        h.update(chunk)
        n += len(chunk)
    writer.close()
    return {"status": int(status), "via": headers.get("x-dragonfly-via"), "bytes": n, "sha256": "sha256:" + h.hexdigest(),
            "subject": dict(x[0] for x in cert["subject"]).get("commonName"),
            "issuer": dict(x[0] for x in cert["issuer"]).get("commonName"),
            "cert_sha256": hashlib.sha256(der).hexdigest(), "handshake_s": handshake}


async def connect(proxy, target, path, cafile):
    host, port = proxy.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    writer.write(f"CONNECT {target} HTTP/1.1\\r\\n\\r\\n".encode())
    await writer.drain()
    status = await reader.readline()
    while (await reader.readline()) not in (b"\\r\\n", b""):
        pass
    if b" 200 " not in status:
        return {"connect": status.decode().strip()}
    return await tls_get(reader, writer, target.rsplit(":", 1)[0], path, cafile)


async def sni(addr, server_name, path, cafile):
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    return await tls_get(reader, writer, server_name, path, cafile)


mode, args = sys.argv[1], sys.argv[2:]
if mode == "pull":
    out = asyncio.run(pull(args[0], args[1], args[2], int(args[3])))
else:
    out = asyncio.run({"connect": connect, "sni": sni}[mode](*args))
print(json.dumps(out))
'''


def image_front(tmp: pathlib.Path, ips: dict) -> dict:
    """The image phase's flags on the daemon phase's daemons, chosen before
    they boot: a proxy on each peer whose registry mirror is the registry
    origin's plain listener (the origin starts in the image phase, on a port
    picked now); HTTPS hijack of localhost on peers 2 and 3, with a hijack CA
    made here by the port's ca.py; the SNI proxy on peer 3; the object
    gateway on the seed and peers 1 and 2 over one fs root, standing in for a
    shared bucket. A second CA signs the origin's TLS leaf (for localhost and
    this host's name), which every daemon trusts through SSL_CERT_FILE, as a
    daemon trusts a private HTTPS origin."""
    t0 = time.perf_counter()
    hijack = CertificateAuthority(tmp / "hijack-ca", common_name="chip-smoke-hijack-ca")
    origin_ca = CertificateAuthority(tmp / "origin-ca", common_name="chip-smoke-origin-ca")
    leaf = write_issued(origin_ca.issue("localhost", sans=["localhost", "127.0.0.1", socket.gethostname()],
                                        client=False), tmp / "origin-tls")
    cas_s = time.perf_counter() - t0
    registry = free_port("127.0.0.1")
    proxy = {k: free_port(ips[k]) for k in ("peer1", "peer2", "peer3")}
    sni = free_port(ips["peer3"])
    gateway = {k: free_port(ips[k]) for k in ("seed", "peer1", "peer2")}
    args: dict[str, list[str]] = {k: [] for k in ips}
    for k, port in proxy.items():
        # the mirror takes origin-form requests; the rule sends an intercepted
        # HTTPS registry's blobs peer to peer (Dragonfly's usual proxy rule)
        args[k] += ["--proxy-port", str(port), "--registry-mirror", f"http://127.0.0.1:{registry}",
                    "--proxy-rule", "blobs/sha256.*"]
    for k in ("peer2", "peer3"):
        args[k] += ["--hijack-ca-dir", str(tmp / "hijack-ca"), "--hijack-host", "^localhost$"]
    args["peer3"] += ["--sni-proxy-port", str(sni)]
    for k, port in gateway.items():
        args[k] += ["--object-storage-port", str(port), "--object-storage-root", str(tmp / "objects")]
    return {"args": args, "env": {"SSL_CERT_FILE": leaf["ca"]}, "registry": registry, "proxy": proxy, "sni": sni,
            "gateway": gateway, "leaf": leaf, "hijack_ca": str(tmp / "hijack-ca" / "ca.pem"),
            "ca_backend": hijack.backend, "cas_s": cas_s}


def write_image(root: pathlib.Path) -> dict:
    """The image under ``root``: its layers of seeded bytes (one numpy stream,
    in IMAGE_LAYER_MIB order), its config and OCI manifest (by tag and by
    digest) and a one-layer oras artifact manifest holding IMAGE_ORAS_LAYER."""
    (root / "blobs").mkdir(parents=True)
    rng, layers = np.random.default_rng(IMAGE_SEED), []
    for mib in IMAGE_LAYER_MIB:
        h, part = hashlib.sha256(), root / "blobs" / "partial"
        with open(part, "wb") as f:
            for off in range(0, mib << 20, 64 << 20):
                chunk = rng.integers(0, 256, min(64 << 20, (mib << 20) - off), dtype=np.uint8).tobytes()
                h.update(chunk)
                f.write(chunk)
        digest = "sha256:" + h.hexdigest()
        part.rename(root / "blobs" / digest)
        layers.append({"mediaType": "application/vnd.oci.image.layer.v1.tar", "digest": digest, "size": mib << 20})

    def put(data: bytes, media: str) -> dict:
        digest = "sha256:" + hashlib.sha256(data).hexdigest()
        (root / "blobs" / digest).write_bytes(data)
        return {"mediaType": media, "digest": digest, "size": len(data)}

    config = put(json.dumps({"architecture": "amd64", "os": "linux", "rootfs": {
        "type": "layers", "diff_ids": [lay["digest"] for lay in layers]}}).encode(),
        "application/vnd.oci.image.config.v1+json")
    manifests = {}
    for repo, tag, cfg, lays in ((IMAGE_REPO, IMAGE_TAG, config, layers),
                                 (ORAS_REPO, ORAS_TAG, put(b"{}", "application/vnd.oci.empty.v1+json"),
                                  [layers[IMAGE_ORAS_LAYER]])):
        body = json.dumps({"schemaVersion": 2, "mediaType": OCI_MANIFEST, "config": cfg, "layers": lays}).encode()
        d = root / "manifests" / repo.replace("/", "_")
        d.mkdir(parents=True)
        (d / tag).write_bytes(body)
        (d / ("sha256:" + hashlib.sha256(body).hexdigest())).write_bytes(body)
        manifests[repo] = body
    return {"layers": layers, "config": config, "manifests": manifests}


def client_run(ctx: dict, args: list[str]) -> tuple[str, float]:
    """One client process of the image phase (CLIENT_SCRIPT), one of the
    cluster's processes (so that the phase's end stops it, whatever happens),
    and its start on the host clock."""
    cluster = ctx["cluster"]
    name = f"client-{sum(n.startswith('client-') for n in cluster.logs)}"
    cluster.spawn(name, [str(ctx["tmp"] / "client.py"), *args])
    return name, time.perf_counter()


def client_wait(ctx: dict, run: tuple[str, float], deadline: float) -> dict:
    """A client process's JSON line, with its seconds to exit."""
    (name, t0), cluster = run, ctx["cluster"]
    p = cluster.procs[name]
    try:
        out, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
    except subprocess.TimeoutExpired:
        raise AssertionError(f"{name} ({' '.join(p.args[2:])}) ran past its deadline") from None
    s = time.perf_counter() - t0
    cluster.stop(name)
    if p.returncode:
        raise AssertionError(f"{name} exited {p.returncode}: {cluster.logs[name].read_text()[-2000:]}")
    return {**json.loads(out.strip().splitlines()[-1]), "s": s}


def registry_stats(port: int) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/_stats", timeout=10) as r:
        return json.loads(r.read())


def served(stats: dict, listener: str, path: str) -> dict:
    return stats[listener].get(path, {"gets": 0, "bytes": 0})


def blob_tasks(ctx: dict, base: str, repo: str, blobs: list[dict], names: tuple, leg: str) -> dict:
    """Each blob's task on each named peer: its ``task done`` line (pieces by
    parent daemon, bytes from the source), its pieces by the size the
    scheduler scopes, and its scheduling rounds; raises unless every round
    scored torch on the published version with no fallback, and every
    multi-piece blob came from parents on every peer. A one-piece blob
    (the scheduler's small scope) is named and counted whatever its source."""
    out, one_piece = {}, []
    for b in blobs:
        url = f"{base}/v2/{repo}/blobs/{b['digest']}"
        task_id = idgen.task_id(url, digest=b["digest"])
        rounds = asyncio.run(task_rounds(ctx["saddr"], task_id))
        modes = [(r["serving_mode"], r["model_version"]) for r in rounds["records"]]
        if any(m != ("torch", ctx["version"]) for m in modes) or any(rounds["fallbacks"].values()):
            raise AssertionError(f"{leg}: blob {b['digest'][:19]}: rounds {modes}, fallbacks {rounds['fallbacks']}")
        pieces = piece_count(b["size"], compute_piece_size(b["size"]))
        per_peer = {}
        for k in names:
            done = done_line(ctx["logs"][k], task_id)
            done["by_parent"] = parent_names(done["by_parent"], ctx["names"])
            per_peer[k] = done
            if pieces > 1 and (done["source_bytes"] or sum(done["by_parent"].values()) != done["pieces"]):
                raise AssertionError(f"{leg}: {k} took blob {b['digest'][:19]} ({pieces} pieces) from the source: "
                                     f"{done}")
        if pieces == 1:
            one_piece.append(b["digest"])
        out[b["digest"]] = {"size": b["size"], "pieces": pieces, "rounds": len(modes), "peers": per_peer}
    return {"blobs": out, "one_piece": one_piece, "rounds": sum(v["rounds"] for v in out.values()),
            "fallbacks": rounds["fallbacks"]}


def print_leg(name: str, runs: dict, tasks: dict, origin: dict) -> None:
    for k, r in runs.items():
        print(f"  {name} through {k}: {r['s']:.2f} s, {r['bytes'] / r['s'] / 2**20:.1f} MiB/s (host clock, the "
              f"client process to its end)")
    by_parent: dict = {}
    for t in tasks["blobs"].values():
        for k, done in t["peers"].items():
            for parent, n in done["by_parent"].items():
                by_parent.setdefault(k, {}).setdefault(parent, 0)
                by_parent[k][parent] += n
    one_piece = {d[:19]: {k: (done["by_parent"], done["source_bytes"]) for k, done in tasks["blobs"][d]["peers"].items()}
                 for d in tasks["one_piece"]}
    print(f"    pieces by parent {by_parent}; rounds {tasks['rounds']}, all torch; fallbacks {tasks['fallbacks']}; "
          f"one-piece blobs (the small scope; by parent, bytes from the source) {one_piece}; origin {origin}")


def image_phase(ctx: dict) -> dict:
    """The daemon's image-acceleration front and its object and registry
    origins on the daemon phase's cluster (see the module docstring)."""
    t_phase = time.perf_counter()
    tmp, cluster, front, ips = ctx["tmp"], ctx["cluster"], ctx["front"], ctx["ips"]
    host = socket.gethostname()
    addrs = {a[4][0] for a in socket.getaddrinfo(host, IMAGE_TLS_PORT, proto=socket.IPPROTO_TCP)}
    if host == "localhost" or not addrs:
        raise AssertionError(f"this host's name {host!r} does not resolve apart from localhost: the tunnel legs "
                             "need a second name for the origin")
    numbers: dict = {"ca_backend": front["ca_backend"], "cas_s": front["cas_s"], "tunnel_name": host}
    deadline = time.monotonic() + DAEMON_DOWNLOAD_S

    # origins: the image written, the registry on its plain port and on 443
    t0 = time.perf_counter()
    image = write_image(tmp / "registry")
    numbers["image_write_s"] = time.perf_counter() - t0
    (tmp / "registry.py").write_text(REGISTRY_SCRIPT)
    (tmp / "client.py").write_text(CLIENT_SCRIPT)
    cluster.spawn("registry", [str(tmp / "registry.py"), str(tmp / "registry"), str(front["registry"]),
                               str(IMAGE_TLS_PORT), front["leaf"]["cert"], front["leaf"]["key"]])
    cluster.ready("registry", "REGISTRY_READY", time.monotonic() + DAEMON_BOOT_S)
    forger = CertForger(CertificateAuthority(tmp / "hijack-ca"))
    t0 = time.perf_counter()
    forger.context_for("localhost")
    numbers["forge_first_leaf_s"] = time.perf_counter() - t0
    forger.close()
    layers, total = image["layers"], sum(lay["size"] for lay in image["layers"])
    print(f"  image {IMAGE_REPO}:{IMAGE_TAG}: {len(layers)} layers of {list(IMAGE_LAYER_MIB)} MiB "
          f"({total / 2**30:.3f} GiB) written in {numbers['image_write_s']:.2f} s; CAs by the {front['ca_backend']} "
          f"backend in {front['cas_s']:.3f} s; first leaf forged in {numbers['forge_first_leaf_s'] * 1e3:.1f} ms "
          f"(this process, the daemons' backend); tunnel name {host} -> {sorted(addrs)}")

    # 1. the mirror pull: peer 1, then peers 2 and 3 at once
    mirror = {k: f"http://{ips[k]}:{front['proxy'][k]}" for k in ("peer1", "peer2", "peer3")}
    pull = {k: ["pull", url, IMAGE_REPO, IMAGE_TAG, str(IMAGE_PULL_CONCURRENCY)] for k, url in mirror.items()}
    runs = {"peer1": client_wait(ctx, client_run(ctx, pull["peer1"]), deadline)}
    both = {k: client_run(ctx, pull[k]) for k in ("peer2", "peer3")}
    runs.update({k: client_wait(ctx, r, deadline) for k, r in both.items()})
    stats = registry_stats(front["registry"])
    blobs = [image["config"], *layers]
    for k, r in runs.items():
        r["bytes"] = sum(b["bytes"] for b in r["blobs"])
        bad = [b for b in r["blobs"] if b["status"] != 200 or not b["sha_ok"] or b["via"] != "p2p"]
        if r["ping"] != 200 or r["manifest"]["status"] != 200 or r["manifest"]["via"] is not None or bad \
                or len(r["blobs"]) != len(blobs):
            raise AssertionError(f"the pull through {k}'s mirror: {r}")
    once = {lay["digest"]: served(stats, "plain", f"/v2/{IMAGE_REPO}/blobs/{lay['digest']}") for lay in layers}
    if any(once[lay["digest"]]["bytes"] != lay["size"] for lay in layers):
        raise AssertionError(f"the origin did not serve each layer's bytes once: {once}")
    tasks = blob_tasks(ctx, f"http://127.0.0.1:{front['registry']}", IMAGE_REPO, blobs, tuple(runs), "mirror")
    origin = {"gets": sum(v["gets"] for v in stats["plain"].values()),
              "bytes": sum(v["bytes"] for v in stats["plain"].values())}
    print_leg("mirror pull", runs, tasks, origin)
    numbers["mirror"] = {"runs": {k: {"s": r["s"], "bytes": r["bytes"], "mib_per_s": r["bytes"] / r["s"] / 2**20}
                                  for k, r in runs.items()},
                         "tasks": tasks, "origin": origin, "layer_gets": {d[:19]: v["gets"] for d, v in once.items()}}

    # 2. HTTPS hijack through peer 2's proxy, and a tunnel for another name
    hijacked = layers[IMAGE_HIJACK_LAYER]
    path = f"/v2/{IMAGE_REPO}/blobs/{hijacked['digest']}"
    proxy2 = f"{ips['peer2']}:{front['proxy']['peer2']}"
    hj = client_wait(ctx, client_run(ctx, ["connect", proxy2, f"localhost:{IMAGE_TLS_PORT}", path, front["hijack_ca"]]),
                     deadline)
    tun = client_wait(ctx, client_run(ctx, ["connect", proxy2, f"{host}:{IMAGE_TLS_PORT}", "/v2/", front["leaf"]["ca"]]),
                      deadline)
    origin_leaf = hashlib.sha256(ssl.PEM_cert_to_DER_cert(pathlib.Path(front["leaf"]["cert"]).read_text())).hexdigest()
    if (hj.get("status"), hj.get("via"), hj.get("sha256"), hj.get("issuer")) != (
            200, "p2p", hijacked["digest"], "chip-smoke-hijack-ca") or hj["subject"] != "localhost":
        raise AssertionError(f"the hijacked CONNECT: {hj}")
    if tun.get("status") != 200 or tun.get("via") is not None or tun.get("cert_sha256") != origin_leaf:
        raise AssertionError(f"the tunnelled CONNECT did not reach the origin's own certificate: {tun}")
    stats = registry_stats(front["registry"])
    tls_served = served(stats, "tls", path)
    if tls_served["bytes"] != hijacked["size"]:
        raise AssertionError(f"the TLS origin served the hijacked layer as {tls_served}")
    hj["bytes"] = hijacked["size"]
    tasks = blob_tasks(ctx, "https://localhost", IMAGE_REPO, [hijacked], ("peer2",), "hijack")
    print_leg("HTTPS hijack (CONNECT)", {"peer2": hj}, tasks, {"tls": tls_served})
    print(f"    the hijacked client saw a leaf for {hj['subject']} issued by {hj['issuer']} (handshake "
          f"{hj['handshake_s'] * 1e3:.1f} ms, the daemon's first forge included); CONNECT {host}:{IMAGE_TLS_PORT} "
          f"tunnelled to the origin's own leaf (issuer {tun['issuer']}, handshake {tun['handshake_s'] * 1e3:.1f} ms)")
    # where the hijacked pull's time goes: the layer straight from the origin
    # over TLS (no daemon), then through peer 2's hijack again (its storage)
    direct = client_wait(ctx, client_run(ctx, ["sni", f"127.0.0.1:{IMAGE_TLS_PORT}", "localhost", path,
                                           front["leaf"]["ca"]]), deadline)
    again = client_wait(ctx, client_run(ctx, ["connect", proxy2, f"localhost:{IMAGE_TLS_PORT}", path,
                                          front["hijack_ca"]]), deadline)
    if direct.get("sha256") != hijacked["digest"] or (again.get("sha256"), again.get("via")) != (
            hijacked["digest"], "p2p"):
        raise AssertionError(f"the hijacked layer straight from the origin {direct} or again through peer 2 {again}")
    print(f"    the same layer straight from the origin over TLS: {direct['s']:.2f} s, "
          f"{hijacked['size'] / direct['s'] / 2**20:.1f} MiB/s; again through peer 2's hijack (its storage): "
          f"{again['s']:.2f} s, {hijacked['size'] / again['s'] / 2**20:.1f} MiB/s")
    numbers["hijack"] = {"s": hj["s"], "mib_per_s": hj["bytes"] / hj["s"] / 2**20, "handshake_s": hj["handshake_s"],
                         "tunnel_handshake_s": tun["handshake_s"], "tasks": tasks, "origin_tls": tls_served,
                         "origin_direct_mib_per_s": hijacked["size"] / direct["s"] / 2**20,
                         "again_from_storage_mib_per_s": hijacked["size"] / again["s"] / 2**20}

    # 3. the SNI proxy on peer 3: a hijacked name over P2P, another tunnelled
    sni_layer = layers[IMAGE_SNI_LAYER]
    path = f"/v2/{IMAGE_REPO}/blobs/{sni_layer['digest']}"
    sni_addr = f"{ips['peer3']}:{front['sni']}"
    sh = client_wait(ctx, client_run(ctx, ["sni", sni_addr, "localhost", path, front["hijack_ca"]]), deadline)
    st = client_wait(ctx, client_run(ctx, ["sni", sni_addr, host, "/v2/", front["leaf"]["ca"]]), deadline)
    if (sh.get("status"), sh.get("via"), sh.get("sha256"), sh.get("issuer")) != (
            200, "p2p", sni_layer["digest"], "chip-smoke-hijack-ca"):
        raise AssertionError(f"the SNI hijack: {sh}")
    if st.get("status") != 200 or st.get("cert_sha256") != origin_leaf:
        raise AssertionError(f"the SNI tunnel did not reach the origin's own certificate: {st}")
    stats = registry_stats(front["registry"])
    sni_served = served(stats, "tls", path)
    if sni_served["bytes"] != sni_layer["size"]:
        raise AssertionError(f"the TLS origin served the SNI layer as {sni_served}")
    sh["bytes"] = sni_layer["size"]
    tasks = blob_tasks(ctx, "https://localhost", IMAGE_REPO, [sni_layer], ("peer3",), "sni")
    print_leg("SNI proxy", {"peer3": sh}, tasks, {"tls": sni_served})
    print(f"    the SNI hijack's leaf issued by {sh['issuer']} (handshake {sh['handshake_s'] * 1e3:.1f} ms); "
          f"{host} tunnelled to the origin's own leaf (issuer {st['issuer']})")
    numbers["sni"] = {"s": sh["s"], "mib_per_s": sh["bytes"] / sh["s"] / 2**20, "handshake_s": sh["handshake_s"],
                      "tasks": tasks, "origin_tls": sni_served}

    # 4. the object gateway with dfstore over the shared fs root
    obj = tmp / "object.bin"
    want = write_seeded_file(obj, GATEWAY_OBJECT_BYTES, GATEWAY_SEED)
    gw = {k: f"http://{ips[k]}:{port}" for k, port in front["gateway"].items()}
    store = "dragonfly2_tpu_torch.cli.dfstore"
    rc, _ = cli_process(store, ["--endpoint", gw["seed"], "make-bucket", "df://models"], ctx["env"])
    t0 = time.perf_counter()
    rc2, out = cli_process(store, ["--endpoint", gw["seed"], "put", str(obj), "df://models/ckpt/object.bin"],
                           ctx["env"])
    put_s = time.perf_counter() - t0
    if rc or rc2 or json.loads(out)["digest"] != "sha256:" + want:
        raise AssertionError(f"dfstore make-bucket / put through the seed: {rc}, {rc2}, {out}")
    gets, stored = {}, tmp / "objects" / "models" / "ckpt" / "object.bin"
    task_id = idgen.task_id(stored.resolve().as_uri(), digest="sha256:" + want)
    for k in ("peer1", "peer2"):
        t0 = time.perf_counter()
        rc, out = cli_process(store, ["--endpoint", gw[k], "get", "df://models/ckpt/object.bin",
                                      str(tmp / f"object-{k}.bin")], ctx["env"])
        gets[k] = {"s": time.perf_counter() - t0, "bytes": GATEWAY_OBJECT_BYTES,
                   "sha_ok": not rc and file_sha256(tmp / f"object-{k}.bin") == want}
        done = done_line(ctx["logs"][k], task_id)
        gets[k]["by_parent"] = parent_names(done["by_parent"], ctx["names"])
        if not gets[k]["sha_ok"] or done["source_bytes"] or sum(done["by_parent"].values()) != done["pieces"]:
            raise AssertionError(f"dfstore get through {k}: {gets[k]}, {done}")
        (tmp / f"object-{k}.bin").unlink()
    rounds = asyncio.run(task_rounds(ctx["saddr"], task_id))
    if any(r["serving_mode"] != "torch" for r in rounds["records"]) or any(rounds["fallbacks"].values()):
        raise AssertionError(f"the gateway object's rounds: {rounds['records']}, {rounds['fallbacks']}")
    rc_stat, stat_out = cli_process(store, ["--endpoint", gw["peer1"], "stat", "df://models/ckpt/object.bin"],
                                    ctx["env"])
    rc_ls, ls_out = cli_process(store, ["--endpoint", gw["peer2"], "ls", "df://models/ckpt/"], ctx["env"])
    rc_rm, rm_out = cli_process(store, ["--endpoint", gw["seed"], "rm", "df://models/ckpt/object.bin"], ctx["env"])
    rc_gone = subprocess.run([sys.executable, "-m", store, "--endpoint", gw["peer1"], "stat",
                              "df://models/ckpt/object.bin"], cwd=REPO, env=ctx["env"], capture_output=True,
                             timeout=CLI_DEADLINE_S).returncode  # removed: exits 1
    if rc_stat or json.loads(stat_out)["content_length"] != GATEWAY_OBJECT_BYTES or rc_ls \
            or "ckpt/object.bin" not in ls_out or rc_rm or rm_out.strip() != "deleted" or rc_gone != 1:
        raise AssertionError(f"dfstore stat/ls/rm: {rc_stat} {stat_out!r} {rc_ls} {ls_out!r} {rc_rm} {rm_out!r} "
                             f"{rc_gone}")
    print(f"  dfstore put of {GATEWAY_OBJECT_BYTES >> 20} MiB through the seed's gateway in {put_s:.2f} s "
          f"({GATEWAY_OBJECT_BYTES / put_s / 2**20:.1f} MiB/s, the dfstore process to its end)")
    for k, g in gets.items():
        print(f"  dfstore get through {k}: {g['s']:.2f} s, {g['bytes'] / g['s'] / 2**20:.1f} MiB/s, pieces by parent "
              f"{g['by_parent']}")
    print(f"    rounds {len(rounds['records'])}, all torch; fallbacks {rounds['fallbacks']}; stat, ls, rm: ok")
    numbers["gateway"] = {"put_s": put_s, "gets": gets, "rounds": len(rounds["records"])}
    obj.unlink()

    # 5. oras:// through peer 3
    art = layers[IMAGE_ORAS_LAYER]
    url = f"oras://localhost/{ORAS_REPO}:{ORAS_TAG}"
    before = registry_stats(front["registry"])
    t0 = time.perf_counter()
    dfget_wait(dfget_run(cluster, url, tmp / "oras.out", ctx["socks"]["peer3"]), deadline)
    oras = {"s": time.perf_counter() - t0, "bytes": art["size"]}
    sha = "sha256:" + file_sha256(tmp / "oras.out")
    (tmp / "oras.out").unlink()
    done = done_line(ctx["logs"]["peer3"], idgen.task_id(url))
    oras["by_parent"] = parent_names(done["by_parent"], ctx["names"])
    after = registry_stats(front["registry"])
    layer_path = f"/v2/{ORAS_REPO}/blobs/{art['digest']}"
    oras_served = {k: served(after, "tls", layer_path)[k] - served(before, "tls", layer_path)[k]
                   for k in ("gets", "bytes")}
    if sha != art["digest"] or done["source_bytes"] or sum(done["by_parent"].values()) != done["pieces"] \
            or oras_served["bytes"] != art["size"]:
        raise AssertionError(f"dfget {url}: sha {sha} (want {art['digest']}), {done}, origin {oras_served}")
    rounds = asyncio.run(task_rounds(ctx["saddr"], idgen.task_id(url)))
    if any(r["serving_mode"] != "torch" for r in rounds["records"]) or any(rounds["fallbacks"].values()):
        raise AssertionError(f"the oras task's rounds: {rounds['records']}, {rounds['fallbacks']}")
    print(f"  dfget {url} through peer3: {oras['s']:.2f} s, {oras['bytes'] / oras['s'] / 2**20:.1f} MiB/s "
          f"(the dfget process to its end), pieces by parent {oras['by_parent']}; rounds {len(rounds['records'])}, "
          f"fallbacks {rounds['fallbacks']}; origin (TLS) {oras_served}")
    numbers["oras"] = {**oras, "rounds": len(rounds["records"]), "origin_tls": oras_served}
    numbers.update(host_cpu=host_cpu(), wall_s=time.perf_counter() - t_phase)
    return numbers


# ---------------------------------------------------------------------------
# the cluster phase: the secure, observable cluster through dfcluster


def scrape(port: int) -> str:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        return r.read().decode()


def logged_port(log: pathlib.Path, what: str, deadline: float) -> int:
    """The port a process's log names for ``<what> on <ip>:<port>``."""
    pat = re.compile(re.escape(what) + r" on [\d.]+:(\d+)")
    while True:
        m = pat.search(log.read_text())
        if m:
            return int(m.group(1))
        if time.monotonic() > deadline:
            raise AssertionError(f"{log.name} names no '{what}' port: {log.read_text()[-2000:]}")
        time.sleep(0.1)


def metric_value(text: str, name: str, **labels) -> float:
    """One sample of a /metrics page (0 when the child was never set)."""
    want = name + ("{" + ",".join(f'{k}="{v}"' for k, v in labels.items()) + "}" if labels else "")
    for line in text.splitlines():
        if line.startswith(want + " "):
            return float(line.split()[-1])
    return 0.0


def rest_call(port: int, method: str, path: str, body: dict | None = None) -> tuple[int, dict]:
    import urllib.error
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", method=method,
                                 data=None if body is None else json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read() or b"{}")


def preheat(rest: int, url: str, deadline: float) -> tuple[dict, float]:
    """POST /api/v1/jobs a file preheat, then poll the job to its end."""
    t0 = time.perf_counter()
    status, job = rest_call(rest, "POST", "/api/v1/jobs", {"type": "preheat", "args": {"type": "file", "url": url}})
    if status != 201:
        raise AssertionError(f"POST /api/v1/jobs answered {status}: {job}")
    while True:
        status, st = rest_call(rest, "GET", f"/api/v1/jobs/{job['id']}")
        if status == 200 and st["state"] in ("SUCCESS", "FAILURE"):
            return st, time.perf_counter() - t0
        if time.monotonic() > deadline:
            raise AssertionError(f"the preheat job by its deadline: {st}")
        time.sleep(0.25)


async def tls_probe(port: int, certs: dict, policy: str, with_cert: bool) -> str:
    """A handshake with a daemon's piece server as a peer makes it (the
    cluster's leaf), or as a client with no certificate: the negotiated
    suite, or the refusal."""
    from dragonfly2_tpu_torch.security.transport import AsyncTlsTransport, data_client_ssl_context

    loop = asyncio.get_running_loop()
    s = socket.socket()
    s.setblocking(False)
    await loop.sock_connect(s, ("127.0.0.1", port))
    if with_cert:
        ctx = data_client_ssl_context(certs["ca"], certs["cert"], certs["key"], policy=policy)
    else:
        ctx = data_client_ssl_context(certs["ca"], policy=policy)
    try:
        t = await asyncio.wait_for(AsyncTlsTransport.connect(s, ctx), 10.0)
    except (ssl.SSLError, ConnectionError, OSError, asyncio.TimeoutError) as e:
        s.close()
        return f"refused: {type(e).__name__}: {e}"
    try:
        # TLS 1.2 settles a client certificate in the handshake itself: a
        # request that gets an answer went through
        await t.sendall(b"GET /healthz HTTP/1.1\r\nHost: x\r\n\r\n")
        got = await asyncio.wait_for(t.recv(64), 10.0)
        return f"{t.cipher()[0]} {t.cipher()[1]}" if got else "refused: closed with no answer"
    except (ssl.SSLError, ConnectionError, OSError, asyncio.TimeoutError) as e:
        return f"refused: {type(e).__name__}: {e}"
    finally:
        t.close()


def cluster_phase() -> dict:
    """The secure, observable cluster in the port's processes, through
    ``dfcluster.Cluster`` (see the module docstring); every process is
    stopped when the phase ends, whatever happens."""
    from dragonfly2_tpu_torch.cli import dfcluster

    t_phase = time.perf_counter()
    numbers: dict = {"file_bytes": DAEMON_FILE_BYTES}
    with contextlib.ExitStack() as stack:
        tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip-smoke-cluster-"))
        stack.callback(shutil.rmtree, tmp, ignore_errors=True)
        free = shutil.disk_usage(tmp).free
        print(f"  free disk under {tmp}: {free / 2**30:.1f} GiB")
        if free < CLUSTER_DISK_BYTES:
            raise AssertionError(f"the phase needs {CLUSTER_DISK_BYTES / 2**30:.0f} GiB free, {free / 2**30:.1f} there")
        ca = CertificateAuthority(tmp / "ca")
        certs = write_issued(ca.issue("chip-smoke-daemon", sans=["127.0.0.1"]), tmp / "certs")
        print(f"  the cluster's CA (backend {ca.backend}) issued one leaf for 127.0.0.1 into {tmp / 'certs'}")
        # the schedulers serve GNNScorer on the card and record every round
        cluster = dfcluster.Cluster(str(tmp / "cluster"), trace=True, env={
            "DRAGONFLY_TS_INTERVAL": "0.5", "DRAGONFLY_NATIVE_SCORER": "0", "DRAGONFLY_DECISION_SAMPLE": "1"})
        os.makedirs(cluster.root)
        stack.callback(cluster.down)
        deadline = time.monotonic() + DAEMON_BOOT_S
        procs = DaemonCluster(tmp, {**os.environ, "PYTHONPATH": str(REPO)})
        stack.callback(procs.close)
        (tmp / "origin.py").write_text(ORIGIN_SCRIPT)
        (tmp / "www").mkdir()
        procs.spawn("origin", [str(tmp / "origin.py"), str(tmp / "www")])
        t0 = time.perf_counter()
        cluster.up(schedulers=CLUSTER_SCHEDULERS, daemons=0, federation_interval=1.0,
                   extra_scheduler_args=["--evaluator", "ml", "--keepalive-interval", "1",
                                         "--model-watch-interval", "1", "--metrics-port", "0"],
                   extra_daemon_args=["--data-tls-dir", str(tmp / "certs"), "--metrics-port", "0",
                                      "--announce-interval", "2"])
        names = {"seed": "cl-seed", "peer1": "cl-peer1", "peer2": "cl-peer2", "peer3": "cl-peer3"}
        ports = {k: free_port("127.0.0.1") for k in names}
        host_ids = {k: f"{names[k]}-{ports[k]}" for k in names}
        index = {}
        for k in names:
            index[k] = cluster.spawn_daemon(
                ["--hostname", names[k], "--upload-port", str(ports[k]), *(["--seed"] if k == "seed" else [])])
        numbers["boot_s"] = time.perf_counter() - t0
        logs = {k: pathlib.Path(cluster.log_path(f"daemon-{i}")) for k, i in index.items()}
        sched_logs = [pathlib.Path(cluster.log_path(f"scheduler-{i}")) for i in range(CLUSTER_SCHEDULERS)]
        dmetrics = {k: logged_port(logs[k], "daemon metrics", deadline) for k in names}
        smetrics = [logged_port(log, "scheduler metrics", deadline) for log in sched_logs]
        policies = {k: re.search(r"data-plane mTLS on: cipher=(\S+) ktls=(.*)", logs[k].read_text()) for k in names}
        if not all(policies.values()) or any("(mTLS, raw)" not in logs[k].read_text() for k in names):
            raise AssertionError(f"a daemon is not on the mTLS piece plane: {policies}")
        policy = policies["seed"].group(1)
        numbers["cipher_policy"] = {k: m.group(1) for k, m in policies.items()}
        numbers["ktls"] = policies["seed"].group(2)
        want = write_seeded_file(tmp / "www" / "blob.bin", DAEMON_FILE_BYTES, DAEMON_FILE_SEED)
        oport = int(procs.ready("origin", "ORIGIN_READY", deadline))
        print(f"  dfcluster up in {numbers['boot_s']:.1f} s: manager {cluster.manager_addr} (REST :{cluster.rest_port}, "
              f"open), schedulers {cluster.scheduler_addrs} (metrics :{smetrics}), seed + 3 peers on mTLS "
              f"(policy {numbers['cipher_policy']}, kTLS {numbers['ktls']}; metrics {dmetrics})")

        # 1. the GNN, trained on the card and served by both schedulers
        t0 = time.perf_counter()
        row = asyncio.run(daemon_train(tmp, cluster.manager_addr, list(host_ids.values())))
        numbers["train_to_published_s"] = time.perf_counter() - t0
        status, rollout = rest_call(cluster.rest_port, "GET", "/api/v1/models/rollout/gnn")
        active = (rollout.get("active") or {})
        if status != 200 or active.get("version") != row["version"] or active.get("state") != "active":
            raise AssertionError(f"GET /api/v1/models/rollout/gnn answered {status}: {rollout}")
        t0 = time.perf_counter()
        for i in range(CLUSTER_SCHEDULERS):
            asyncio.run(wait_serving(cluster.manager_addr, f"sched-{i}", time.monotonic() + DAEMON_ATTACH_S))
            if "via engine torch on cuda" not in sched_logs[i].read_text():
                raise AssertionError(f"scheduler {i} does not serve the model on the card")
        numbers["published_to_torch_frames_s"] = time.perf_counter() - t0
        for i, port in enumerate(smetrics):
            text = scrape(port)
            if metric_value(text, "dragonfly_scheduler_ml_serving_mode", mode="torch") != 1.0:
                raise AssertionError(f"scheduler {i}'s /metrics: {[ln for ln in text.splitlines() if 'serving_mode' in ln]}")
        print(f"  GNN {row['version']} trained on the card from {2 * DAEMON_RECORDS} records over {NUM_HOSTS} hosts "
              f"(the daemons' ids among them) and published in {numbers['train_to_published_s']:.1f} s; the REST front "
              f"shows it active; both schedulers' frames read torch {numbers['published_to_torch_frames_s']:.1f} s "
              f"later and their /metrics render ml_serving_mode{{mode=\"torch\"}} 1")

        # 2. the preheat: REST -> job queue -> a scheduler's job loop -> the seed
        url = f"http://127.0.0.1:{oport}/blob.bin"
        task_id = idgen.task_id(url)
        job, numbers["preheat_s"] = preheat(cluster.rest_port, url, time.monotonic() + CLUSTER_PREHEAT_S)
        seeded = done_line(logs["seed"], task_id)
        after_preheat = origin_stats(oport)
        print(f"  preheat job {job['id']}: {job['state']} in {numbers['preheat_s']:.2f} s "
              f"({DAEMON_FILE_BYTES / numbers['preheat_s'] / 2**20:.1f} MiB/s, host clock, POST to the job's end); "
              f"the seed: {seeded['pieces']} pieces, {seeded['source_bytes']} bytes from the source; origin {after_preheat}")
        if job["state"] != "SUCCESS" or seeded["source_bytes"] != DAEMON_FILE_BYTES:
            raise AssertionError(f"the preheat: {job}, the seed's task {seeded}")
        if after_preheat["bytes"] != DAEMON_FILE_BYTES:
            raise AssertionError(f"the origin served {after_preheat}, not the file's {DAEMON_FILE_BYTES} bytes once")

        # 3. dfget over mTLS: peer 1, then peers 2 and 3 at once
        outs = {k: tmp / f"{k}.out" for k in ("peer1", "peer2", "peer3")}
        runs: dict[str, dict] = {}

        def fetch(k: str) -> dict:
            t0 = time.perf_counter()
            r = cluster.dfget(index[k], url, str(outs[k]), timeout=DAEMON_DOWNLOAD_S, trace_name=f"dfget-{k}")
            if r.returncode:
                raise AssertionError(f"dfget through {k} exited {r.returncode}: {r.stderr[-2000:]}")
            return {"s": time.perf_counter() - t0}

        runs["peer1"] = fetch("peer1")
        with concurrent.futures.ThreadPoolExecutor(2) as pool:
            both = {k: pool.submit(fetch, k) for k in ("peer2", "peer3")}
            runs.update({k: f.result() for k, f in both.items()})
        after_all = origin_stats(oport)
        with concurrent.futures.ThreadPoolExecutor(3) as pool:
            shas = dict(zip(outs, pool.map(file_sha256, outs.values())))
        for k, run in runs.items():
            run.update(done_line(logs[k], task_id), mib_per_s=DAEMON_FILE_BYTES / run["s"] / 2**20)
            run["by_parent"] = parent_names(run["by_parent"], names)
            print(f"  dfget --trace-file through {k} over mTLS: {run['s']:.2f} s, {run['mib_per_s']:.1f} MiB/s (host "
                  f"clock, dfget process to exit), pieces by parent {run['by_parent']}, {run['source_bytes']} bytes "
                  f"from the source")
        if any(s != want for s in shas.values()):
            raise AssertionError(f"sha256 of the outputs {shas} != the origin file's {want}")
        if after_all != after_preheat:
            raise AssertionError(f"the origin served more after the preheat: {after_all} (then {after_preheat})")
        for k, run in runs.items():
            if run["source_bytes"] or sum(run["by_parent"].values()) != run["pieces"] or not run["pieces"]:
                raise AssertionError(f"{k} did not take every piece from parents: {run}")
        records, fb = [], collections.Counter()
        for saddr in cluster.scheduler_addrs:
            got = asyncio.run(task_rounds(saddr, task_id))
            records += got["records"]
            fb.update(got["fallbacks"])
        modes = [(r["serving_mode"], r["model_version"]) for r in records]
        print(f"  the schedulers' rounds for the task: {len(modes)} ({dict(collections.Counter(modes))}); "
              f"ML_BASE_FALLBACK_TOTAL {dict(fb)}")
        if not modes or any(m != ("torch", row["version"]) for m in modes) or any(fb.values()):
            raise AssertionError(f"rounds {modes}, fallbacks {dict(fb)}: not every round scored torch on the card")
        handshakes = {}
        for k in names:
            text = scrape(dmetrics[k])
            handshakes[k] = {
                "full": metric_value(text, "dragonfly_dfdaemon_piece_tls_handshakes_total", resumed="false"),
                "resumed": metric_value(text, "dragonfly_dfdaemon_piece_tls_handshakes_total", resumed="true"),
                "failures": metric_value(text, "dragonfly_dfdaemon_piece_tls_handshake_failures_total"),
                "upload_bytes": metric_value(text, "dragonfly_dfdaemon_upload_bytes_total"),
            }
        print(f"  piece TLS handshakes by daemon (each counts those it made as a client): {handshakes}")
        if any(handshakes[k]["full"] + handshakes[k]["resumed"] <= 0 for k in runs) \
                or any(h["failures"] for h in handshakes.values()) \
                or not sum(h["resumed"] for h in handshakes.values()):
            raise AssertionError(f"handshakes: {handshakes}")
        suite = asyncio.run(tls_probe(ports["seed"], certs, policy, with_cert=True))
        print(f"  negotiated on the seed's piece server: {suite} (policy {policy})")
        if suite.startswith("refused"):
            raise AssertionError(f"the cluster's own leaf was refused: {suite}")
        for p in outs.values():
            p.unlink()
        numbers.update(downloads=runs, origin=after_all, task_rounds=len(modes), fallbacks=dict(fb),
                       handshakes=handshakes, suite=suite, preheat=job["result"])

        # 4. a client with no certificate
        refused = asyncio.run(tls_probe(ports["peer1"], certs, policy, with_cert=False))
        print(f"  a client with no certificate on peer 1's piece server: {refused}")
        if not refused.startswith("refused"):
            raise AssertionError(f"a client with no certificate was served: {refused}")
        numbers["no_cert"] = refused

        # 5. the trace: SIGTERM flushes every span file
        cluster.down()
        dfcluster.verify_trace(cluster, "dfget-peer1")
        spans = [json.loads(ln) for ln in pathlib.Path(cluster.trace_dir, "dfget-peer1.jsonl").read_text().splitlines()]
        trace_id = next(s["trace_id"] for s in spans if s["name"] == "dfget.download")
        files = sorted(str(p) for p in pathlib.Path(cluster.trace_dir).glob("*.jsonl"))
        dftrace = [sys.executable, "-m", "dragonfly2_tpu_torch.cli.dftrace", "--trace", trace_id]
        env = {**os.environ, "PYTHONPATH": str(REPO)}
        text = subprocess.run([*dftrace, *files], env=env, capture_output=True, text=True, timeout=CLI_DEADLINE_S)
        if text.returncode or "critical path" not in text.stdout:
            raise AssertionError(f"dftrace exited {text.returncode}: {text.stderr[-2000:]}")
        print("  dftrace over the span files, peer 1's dfget trace:")
        for line in text.stdout.splitlines()[2:]:
            if line.startswith("stage table"):
                break
            print(f"    {line}")
        js = subprocess.run([*dftrace, "--json", *files], env=env, capture_output=True, text=True,
                            timeout=CLI_DEADLINE_S)
        (trace,) = json.loads(js.stdout)["traces"]
        exclusive: collections.Counter = collections.Counter()
        for hop in trace["critical_path"]:
            exclusive[hop["name"]] += hop["exclusive_ms"]
        numbers["trace"] = {"trace_id": trace_id, "spans": trace["spans"], "wall_ms": trace["wall_ms"],
                            "top_exclusive_ms": dict(exclusive.most_common(5))}
        print(f"  top stages by exclusive time on that critical path: {numbers['trace']['top_exclusive_ms']} "
              f"(wall {trace['wall_ms']:.1f} ms, {trace['spans']} spans)")

    # 6. the user's own command, interrupted past its deadline (SIGINT lets
    # it stop the processes it started) and killed 30 s later
    t0 = time.perf_counter()
    demo = subprocess.Popen([sys.executable, "-m", "dragonfly2_tpu_torch.cli.dfcluster", "demo", "--verify-trace"],
                            env={**os.environ, "PYTHONPATH": str(REPO)}, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = demo.communicate(timeout=CLUSTER_DEMO_S)
    except subprocess.TimeoutExpired:
        demo.send_signal(signal.SIGINT)
        try:
            demo.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            demo.kill()
            demo.communicate()
        raise AssertionError(f"dfcluster demo --verify-trace ran past its {CLUSTER_DEMO_S:.0f} s") from None
    numbers["demo_s"] = time.perf_counter() - t0
    for line in out.splitlines():
        print(f"    {line}")
    if demo.returncode:
        raise AssertionError(f"dfcluster demo --verify-trace exited {demo.returncode}: {err[-2000:]}")
    numbers.update(host_cpu=host_cpu(), wall_s=time.perf_counter() - t_phase)
    return numbers


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


def kernel_usage(info: dict, kernel: str, vector: bool = True) -> dict:
    """Registers and spill bytes of the kernel's bf16 vector instantiation
    (``vector``; K3 and K4 have only the one), the one the main paths
    launch, from the build's -Xptxas -v output, and whether that output is
    this run's nvcc's or the log of an earlier build of the same source and
    flags."""
    found = [u for name, u in _build.ptxas_usage(info["log"]).items()
             if f"{len(kernel)}{kernel}" in name
             and (not vector or ("13__nv_bfloat16Li8E" in name and "Lb1E" not in name))]  # not K2's unit twin
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


def sage_inputs(cluster, hdim: int, seed: int) -> dict:
    """K3's inputs at a main path's shape: the cluster's neighbour table,
    mask and edge features on the card, u, s and the incoming gradient
    [N, hdim] in bf16 and msg_edge's weight [hdim, 4] in bf16, from a seed."""
    g = cluster.graph.to("cuda")
    n = g.neighbors.shape[0]
    rng = np.random.default_rng(seed)
    bf = lambda a: torch.from_numpy(a.astype(np.float32)).cuda().bfloat16()  # noqa: E731
    return {"u": bf(rng.normal(size=(n, hdim))), "s": bf(rng.normal(size=(n, hdim))),
            "weight": bf(rng.normal(size=(hdim, g.edge_feats.shape[2])) * 0.5),
            "edge_feats": g.edge_feats, "neighbors": g.neighbors, "mask": g.mask,
            "g": bf(rng.normal(size=(n, hdim)))}


def sage_grads(fn, x: dict) -> tuple[torch.Tensor, tuple]:
    """agg = fn(u, s, w) and its gradients (g_u, g_s, g_We) for x["g"]."""
    u, s, w = (x[k].clone().requires_grad_() for k in ("u", "s", "weight"))
    agg = fn(u, s, w)
    return agg.detach(), torch.autograd.grad(agg, (u, s, w), x["g"])


def sage_check(x: dict) -> dict:
    """K3 and K4 against the plain ops with the edge term summed in the
    kernels' order: every element within one bf16 rounding (only an f32
    sum's order differs); the share that is bit-equal, by output."""
    graph = (x["edge_feats"], x["neighbors"], x["mask"])

    def fused(u, s, w):
        return sage_message.sage_message(u, s, graph[0], w, *graph[1:])

    def plain(u, s, w):  # msg_edge's product as the kernels sum it, then the plain path
        e, wf = graph[0].bfloat16().float(), w.float()
        v = e[..., 0:1] * wf[:, 0]
        for d in range(1, e.shape[-1]):
            v = v + e[..., d:d + 1] * wf[:, d]
        return sage_message.message_path(u, s, v.bfloat16(), *graph[1:])

    got, want = sage_grads(fused, x), sage_grads(plain, x)
    torch.cuda.synchronize()
    equal = {}
    for name, a, b in zip(("agg", "g_u", "g_s", "g_We"), (got[0], *got[1]), (want[0], *want[1])):
        af, bf = a.float(), b.float()
        _, ex = torch.frexp(torch.maximum(af.abs(), bf.abs()))
        ulp = torch.where(torch.maximum(af.abs(), bf.abs()) > 0, torch.ldexp(torch.ones_like(af), ex - 8),
                          torch.full_like(af, 2.0**-133))
        over = int(((af - bf).abs() > ulp).sum())
        equal[name] = float((a == b).float().mean())
        if over or a.dtype != b.dtype:
            raise AssertionError(f"K3/K4 {name}: {over} elements more than one bf16 rounding off the plain ops")
    return equal


def sage_row(cluster, hdim: int, usage: dict) -> dict:
    """K3 and K4 at [N, K, hdim]: the check, then timed beside the plain
    path (forward under no_grad; backward by autograd over a kept graph, K4's
    index built beforehand as the encoder builds it once a forward)."""
    x = sage_inputs(cluster, hdim, seed=31 + hdim)
    equal = sage_check(x)
    u, s, w, gin = x["u"], x["s"], x["weight"], x["g"]
    e, nbr, mask = x["edge_feats"], x["neighbors"], x["mask"]
    n, k = nbr.shape
    deterministic = twice_equal(lambda: sage_message.sage_message(u, s, e, w, nbr, mask))
    graph = sage_message.Graph(e, nbr, mask)
    graph.index()
    ur, sr, wr = (t.clone().requires_grad_() for t in (u, s, w))
    fused = sage_message.fused(ur, sr, wr, graph)
    plain = sage_message.sage_message_torch(ur, sr, e, wr, nbr, mask)
    grads_twice = [torch.autograd.grad(fused, (ur, sr, wr), gin, retain_graph=True) for _ in range(2)]
    deterministic = deterministic and all(torch.equal(a, b) for a, b in zip(*grads_twice))

    def no_grad(fn):
        def run():
            with torch.no_grad():
                return fn()
        return run

    cold, warm = time_all({
        "fwd": no_grad(lambda: sage_message.sage_message(u, s, e, w, nbr, mask)),
        "fwd plain": no_grad(lambda: sage_message.sage_message_torch(u, s, e, w, nbr, mask)),
        "bwd": lambda: torch.autograd.grad(fused, (ur, sr, wr), gin, retain_graph=True),
        "bwd plain": lambda: torch.autograd.grad(plain, (ur, sr, wr), gin, retain_graph=True),
        "index": lambda: sage_message.slot_index(nbr, mask, n),
    })
    del fused, plain, grads_twice
    # what a layer's call pays on the host: its check and K3's launch
    host_us = host_us_per_call(no_grad(lambda: graph.takes(u, s, w) and sage_message.fused(u, s, w, graph)), 50)

    # The least work these inputs need: each input read once, each output
    # written once (the per-edge gradient K4 writes and gathers back is its
    # design's, not the function's), and the elementwise work of the live
    # slots at one instruction a lane a clock (half the f32 FMA rate, which
    # counts two). K4's gradient needs x and t besides the VJP's own ops, at
    # the least of three costs: recomputed, x read back (t recomputed), or
    # both read back in bf16 (the forward's writes of them are its own cost)
    live = int(((mask.bfloat16() != 0) & (nbr >= 0) & (nbr < n)).sum())
    elems, edim = live * hdim, e.shape[2]
    graph_bytes = n * k * (edim * 4 + 8)
    fwd_bytes = 3 * n * hdim * 2 + graph_bytes + hdim * edim * 2
    bwd_bytes = 5 * n * hdim * 2 + graph_bytes + 2 * hdim * edim * 2
    floors = {"fwd": {"": (fwd_bytes, SAGE_PREACT_INSTR + SAGE_TANH_INSTR + SAGE_FWD_REST_INSTR)},
              "bwd": {"x and t recomputed": (bwd_bytes, SAGE_VJP_INSTR + SAGE_PREACT_INSTR + SAGE_TANH_INSTR),
                      "x read back": (bwd_bytes + 2 * elems, SAGE_VJP_INSTR + SAGE_TANH_INSTR),
                      "x and t read back": (bwd_bytes + 4 * elems, SAGE_VJP_INSTR)}}
    rows = []
    for name in ("fwd", "bwd"):
        (bound_ms, bound_by), way = min((bound(nbytes, 2 * elems * instr), way)
                                        for way, (nbytes, instr) in floors[name].items())
        nbytes, instr = floors[name][way]
        bound_by = ("instructions" if bound_by == "operations" else bound_by) + (f", {way}" if way else "")
        print(f"  K3/K4 {name} bf16 [{n}, {k}, {hdim}] (L2 flushed / back to back): kernel "
              f"{cold[name]:.4f} / {warm[name]:.4f} ms, plain {cold[name + ' plain']:.4f} / "
              f"{warm[name + ' plain']:.4f} ms; bound {bound_ms * 1e3:.1f} us ({bound_by}: {nbytes} bytes, "
              f"{live} live slots x {hdim} x {instr} instructions), {bound_ms / cold[name]:.1%} of it flushed; "
              f"{usage[name]['registers']} registers, {usage[name]['spills']} bytes of spills")
        rows.append({
            "name": f"sage_message_{name}", "route": "cuda", "source": "dragonfly2_tpu_torch/csrc/neighbor_agg.cu",
            "replaces": None, "ms": cold[name], "plain_ms": cold[name + " plain"], "bound_ms": bound_ms,
            "bound_by": bound_by, "ms_l2_warm": warm[name], "plain_ms_l2_warm": warm[name + " plain"],
            "deterministic": deterministic, "bit_equal_share": equal, **usage[name],
            "host_us_per_launch": host_us if name == "fwd" else None,
            "index_build_ms": cold["index"] if name == "bwd" else None,
            "index_build_ms_l2_warm": warm["index"] if name == "bwd" else None,
            "dtype": "bfloat16", "shape": [n, k, hdim], "ok": True,
        })
    print(f"  K3/K4 at hidden {hdim}: bit-equal shares against the plain ops {equal}; K4's index build "
          f"{cold['index']:.4f} / {warm['index']:.4f} ms once a forward; a layer's check and K3's launch take "
          f"{host_us:.1f} us of host time; two launches bit-identical: {deterministic}")
    if not deterministic:
        raise AssertionError("K3 or K4 gave other bits on a second launch")
    return rows


def sage_paths(cluster) -> dict:
    """K3 and K4's launches on the train path (one make_multi_step call at
    the full-cluster widths, after a warm-up call: the call that captures
    the CUDA graph, whose launches the graph's replays repeat) and on the
    refresh path (one GNNScorer.refresh at the serving widths, after a
    warm-up one)."""
    state = train_gnn.init_state(TRAIN, rng_seed=WEIGHT_SEED, device="cuda")
    multi = train_gnn.make_multi_step(state, cluster.graph, cluster.pairs, batch_size=TRAIN.batch_size,
                                      steps_per_call=STEPS_PER_CALL)
    state, losses = multi(state)
    losses.cpu()
    zero_counts()
    state, losses = multi(state)
    losses.cpu()
    train = sage_counts()
    del state, multi
    model = TopoScorer(**MODEL)
    scorer = GNNScorer(model, params_from_flax(init_flax_like(model, seed=WEIGHT_SEED)), device="cuda")
    scorer.refresh(cluster.graph)
    zero_counts()
    scorer.refresh(cluster.graph)
    refresh = sage_counts()
    want_train = {"sage_message_fwd": TRAIN.num_layers * STEPS_PER_CALL,
                  "sage_message_bwd": TRAIN.num_layers * STEPS_PER_CALL}
    want_refresh = {"sage_message_fwd": MODEL["num_layers"], "sage_message_bwd": 0}
    print(f"  launches: a {STEPS_PER_CALL}-step train call {train} (want {want_train}); a refresh {refresh} "
          f"(want {want_refresh})")
    if train != want_train or refresh != want_refresh:
        raise AssertionError("K3/K4 launched other than once a layer on the train or refresh path")
    return {"train_call": train, "refresh": refresh}


def sage_phase(card: str, cluster=None) -> list[dict]:
    """K3 and K4: checked and timed at both widths, and their launch counts
    on the train and refresh paths."""
    with phase("sage"):
        if cluster is None:
            cluster = make_cluster(num_nodes=NUM_HOSTS, num_neighbors=NUM_NEIGHBORS, seed=GRAPH_SEED)
        info = _build.build("neighbor_agg")
        usage = {"fwd": kernel_usage(info, "sage_message_fwd_kernel", vector=False),
                 "bwd": kernel_usage(info, "sage_message_bwd_kernel", vector=False)}
        rows = [r for hdim in SAGE_WIDTHS for r in sage_row(cluster, hdim, usage)]
        launches = sage_paths(cluster)
        for r in rows:
            r["launches"] = launches
        print(json.dumps({"sage": rows, "card": card}))
    return rows


def daemon_and_image(card: str) -> None:
    """The daemon phase, then the image phase on its cluster, each with the
    launch counts set to 0 just before it and read just after; every process
    of both is stopped when the image phase ends, whatever happens."""
    with contextlib.ExitStack() as daemons:
        with phase("daemon"):
            zero_counts()
            numbers, daemon_cluster = daemon_phase(daemons)
            # neither K1 nor K2 is on this path: the daemons are host code, the
            # scheduler scores with GNNScorer and the trainer runs SAGELayer (K3
            # and K4 on the card, counted apart)
            numbers["kernel_launches"] = seen = counts()
            if any(seen.values()):
                raise AssertionError(f"the daemon path launched a kernel it does not call: {seen}")
            print(json.dumps({"daemon": numbers, "card": card}))

        with phase("image"):
            zero_counts()
            numbers = image_phase(daemon_cluster)
            # neither K1 nor K2 is on this path: the proxy, the gateway and the
            # sources are host code, and the scheduler scores with GNNScorer
            numbers["kernel_launches"] = seen = counts()
            if any(seen.values()):
                raise AssertionError(f"the image path launched a kernel it does not call: {seen}")
            print(json.dumps({"image": numbers, "card": card}))


def cluster_and_check(card: str) -> None:
    """The cluster phase, with the launch counts set to 0 just before it and
    read just after."""
    with phase("cluster"):
        zero_counts()
        numbers = cluster_phase()
        # neither K1 nor K2 is on this path: the daemons, the manager and the
        # REST front are host code, the trainer runs SAGELayer (K3 and K4 on
        # the card, counted apart) and the schedulers score with GNNScorer
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the cluster path launched a kernel it does not call: {seen}")
        print(json.dumps({"cluster": numbers, "card": card}))


def counts() -> dict:
    return {"neighbor_agg_fwd": neighbor_agg_cuda.LAUNCHES, "neighbor_agg_bwd": neighbor_agg_cuda.BWD_LAUNCHES}


def sage_counts() -> dict:
    return {"sage_message_fwd": sage_message.LAUNCHES, "sage_message_bwd": sage_message.BWD_LAUNCHES}


def zero_counts() -> None:
    neighbor_agg_cuda.LAUNCHES = neighbor_agg_cuda.BWD_LAUNCHES = 0
    sage_message.LAUNCHES = sage_message.BWD_LAUNCHES = 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description="Smoke run of the port on one NVIDIA card (see the module docstring).")
    ap.add_argument("--only", choices=["image", "cluster", "sage"], default=None,
                    help="image: run the device phase, then only the daemon and image phases (the image phase "
                         "runs on the daemon phase's cluster); cluster: the device phase, then the cluster "
                         "phase; sage: the device phase, then the sage phase (K3 and K4 checked, timed and "
                         "counted on the train and refresh paths); without it, every phase")
    args = ap.parse_args(argv)
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

    if args.only == "cluster":
        cluster_and_check(card)
        print(f"chip_smoke: the device and cluster phases in {time.perf_counter() - t_run:.1f} s")
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count},
                          "phases": ["device", "cluster"]}))
        return 0

    if args.only == "sage":
        rows = sage_phase(card)
        print(f"chip_smoke: the device and sage phases in {time.perf_counter() - t_run:.1f} s")
        print(json.dumps({"kernels": rows}))
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count},
                          "phases": ["device", "sage"]}))
        return 0

    if args.only == "image":
        daemon_and_image(card)
        print(f"chip_smoke: the device, daemon and image phases in {time.perf_counter() - t_run:.1f} s")
        print(f"card: {card}")
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count},
                          "phases": ["device", "daemon", "image"]}))
        return 0

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
        numbers["sage_launches"] = sage_counts()
        print(f"  kernel launches on the serving path: {seen}, {numbers['sage_launches']}")
        if seen["neighbor_agg_fwd"] == 0:
            raise AssertionError("the serving path never launched neighbor_agg_fwd")
        launches = {k: launches[k] + v for k, v in seen.items()}
        numbers.update(cpu_check(model, sd))
        print(json.dumps({"serving": numbers, "card": card}))

    with phase("training"):
        zero_counts()
        train_numbers, state = training(cluster)
        seen = counts()
        train_numbers["sage_launches"] = sage_counts()
        print(f"  kernel launches on the training path: {seen}, {train_numbers['sage_launches']}")
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
        # neither K1 nor K2 is on this path: SAGELayer (K3 and K4, counted
        # apart) and the MLP launch neither
        numbers["kernel_launches"] = seen = counts()
        launches = {k: launches[k] + v for k, v in seen.items()}
        print(json.dumps({"ingest": numbers, "card": card}))

    with phase("sharded"):
        zero_counts()
        numbers = sharded(cluster)
        # neither K1 nor K2 is on this path; the one-device side runs K3 and
        # K4 and the mesh's DTensors SAGELayer's plain ops, counted apart
        # (sharded_training)
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the sharded path launched a kernel it does not call: {seen}")
        print(json.dumps({"sharded": numbers, "card": card}))

    with phase("wiring"):
        zero_counts()
        numbers = wiring()
        # neither K1 nor K2 is on this path: the trainer runs SAGELayer (K3
        # and K4 on the card, counted apart), and serving the C++ scorer or
        # GNNScorer
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the wiring path launched a kernel it does not call: {seen}")
        print(json.dumps({"wiring": numbers, "card": card}))

    with phase("stress"):
        zero_counts()
        numbers = stress()
        # neither K1 nor K2 is on this path: the artifact's embedding runs
        # SAGELayer (K3 on the card, counted apart), and scoring the C++
        # scorer or GNNScorer
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the stress path launched a kernel it does not call: {seen}")
        print(json.dumps({"stress": numbers, "card": card}))

    with phase("evaluator"):
        zero_counts()
        numbers = evaluator()
        # neither K1 nor K2 is on this path: the evaluator scores through the
        # C++ scorer or GNNScorer
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the evaluator path launched a kernel it does not call: {seen}")
        print(json.dumps({"evaluator": numbers, "card": card}))

    with phase("scheduler"):
        zero_counts()
        numbers = scheduler_phase()
        # neither K1 nor K2 is on this path: the scheduler scores through the
        # C++ scorer or GNNScorer, and the trainer runs SAGELayer (K3 and K4
        # on the card, counted apart)
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the scheduler path launched a kernel it does not call: {seen}")
        print(json.dumps({"scheduler": numbers, "card": card}))

    with phase("swarm"):
        zero_counts()
        numbers = swarm()
        # neither K1 nor K2 is on this path: the swarm is the control plane
        # over TCP
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the swarm path launched a kernel it does not call: {seen}")
        print(json.dumps({"swarm": numbers, "card": card}))

    with phase("rollout"):
        zero_counts()
        numbers = rollout()
        # neither K1 nor K2 is on this path: the scheduler scores through
        # GNNScorer or the C++ scorer, and the trainer runs SAGELayer (K3 and
        # K4 on the card, counted apart)
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the rollout path launched a kernel it does not call: {seen}")
        print(json.dumps({"rollout": numbers, "card": card}))

    with phase("sim"):
        zero_counts()
        numbers = sim_phase()
        # neither K1 nor K2 is on this path: the simulator is host code, the
        # learned model trains with SAGELayer (K3 and K4 on the card, counted
        # apart) and serves with GNNScorer
        numbers["kernel_launches"] = seen = counts()
        if any(seen.values()):
            raise AssertionError(f"the sim path launched a kernel it does not call: {seen}")
        print(json.dumps({"sim": numbers, "card": card}))

    daemon_and_image(card)
    cluster_and_check(card)

    with phase("kernels"):
        g = cluster.graph.to("cuda")
        rows = [kernel_row_fwd(h0, g.neighbors, g.mask, launches["neighbor_agg_fwd"], usage["neighbor_agg_fwd"]),
                kernel_row_bwd(g.neighbors, g.mask, TRAIN.hidden, launches["neighbor_agg_bwd"],
                               usage["neighbor_agg_bwd"])]
        edge_cases()
    rows += sage_phase(card, cluster)

    print(f"chip_smoke: every phase in {time.perf_counter() - t_run:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
