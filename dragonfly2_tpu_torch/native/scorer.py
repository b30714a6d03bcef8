"""The native C++ scorer: its artifact format and its ctypes binding.

The port's own copy of dragonfly2_tpu/native/scorer.py:
``export_scorer_artifact`` flattens the TopoScorer head weights and the
cached node embeddings into ``scorer.dfsc``; ``NativeScorer`` loads that
file into the C++ batched scorer (``csrc/scorer.cc``, a copy of the JAX
package's ``native/scorer.cc``, built with g++ by ``ops/_build.build_gxx``
at first use) and serves ``score``/``score_rounds``/``drive_rounds`` with
the batch signature of ``models.scorer.GNNScorer``; ``NativeMirror`` binds
the mirrored peer table and ``ScorerHandlePool`` hands each thread its own
forked handle. No torch op runs on this path: a scheduler serving it needs
only the host's CPU.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path
from typing import Any

import numpy as np

from dragonfly2_tpu_torch.ops import _build

_bind_lock = threading.Lock()

_MAGIC = 0x44465343
_VERSION = 1


def export_scorer_artifact(params: Any, z: np.ndarray, path: str | Path) -> Path:
    """Write the binary scoring artifact: cached embeddings + head weights.

    params: the TopoScorer parameters as a flax tree ({'params': {'head':
    {'layers_0': ...}}}, ``models.weights.params_to_flax`` gives it);
    z: [N, D] float32 node embeddings from TopoScorer.embed.
    """
    head = params["params"]["head"]
    w1 = np.asarray(head["layers_0"]["kernel"], np.float32)
    b1 = np.asarray(head["layers_0"]["bias"], np.float32)
    w2 = np.asarray(head["layers_2"]["kernel"], np.float32)
    b2 = np.asarray(head["layers_2"]["bias"], np.float32)
    w3 = np.asarray(head["layers_4"]["kernel"], np.float32)
    b3 = np.asarray(head["layers_4"]["bias"], np.float32)
    z = np.ascontiguousarray(np.asarray(z, np.float32))

    n, d = z.shape
    in_dim, h1 = w1.shape
    fp = in_dim - 3 * d
    if fp < 0:
        raise ValueError(f"head input {in_dim} < 3*embed_dim {3*d}: wrong params/z pairing")
    if w2.shape != (h1, w2.shape[1]) or w3.shape[0] != w2.shape[1] or w3.shape[1] != 1:
        raise ValueError(f"unexpected head shapes: {w1.shape}, {w2.shape}, {w3.shape}")
    h2 = w2.shape[1]

    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(path.name + ".tmp")
    with open(tmp, "wb") as f:
        f.write(struct.pack("<7I", _MAGIC, _VERSION, n, d, fp, h1, h2))
        for arr in (z, w1, b1, w2, b2, w3, b3):
            f.write(np.ascontiguousarray(arr, np.float32).tobytes())
    tmp.replace(path)
    return path


_pi32 = ctypes.POINTER(ctypes.c_int32)
_pf32 = ctypes.POINTER(ctypes.c_float)


def _library() -> ctypes.CDLL:
    """The scorer library (``csrc/scorer.cc``, built with g++ on first use),
    its scoring entry points typed once."""
    dll = _build.load_gxx("scorer")
    with _bind_lock:
        if getattr(dll, "_df_scorer_bound", False):
            return dll
        vp, i32 = ctypes.c_void_p, ctypes.c_int32
        dll.df_scorer_load.restype = vp
        dll.df_scorer_load.argtypes = [ctypes.c_char_p]
        dll.df_scorer_free.argtypes = [vp]
        for fn in ("df_scorer_num_nodes", "df_scorer_embed_dim", "df_scorer_feature_dim"):
            getattr(dll, fn).restype = i32
            getattr(dll, fn).argtypes = [vp]
        dll.df_scorer_score.restype = i32
        dll.df_scorer_score.argtypes = [vp, _pi32, _pi32, _pf32, i32, _pf32]
        dll.df_scorer_score_rounds.restype = i32
        dll.df_scorer_score_rounds.argtypes = [vp, _pi32, _pi32, _pf32, i32, i32, _pf32]
        dll.df_scorer_set_thread_parallelism.argtypes = [i32]
        dll.df_scorer_set_thread_parallelism.restype = None
        dll.df_scorer_fork.restype = vp
        dll.df_scorer_fork.argtypes = [vp]
        dll.df_round_drive.restype = i32
        dll.df_round_drive.argtypes = [
            vp,  # handle
            _pi32,  # offsets [M+1]
            _pi32,  # child_idx [M]
            _pi32,  # parent_idx [T]
            _pf32,  # feats [T, FP]
            _pf32,  # round_cols [M, 3]
            _pi32,  # filt [T, 4]
            i32,  # rounds
            i32,  # k
            i32,  # max_depth
            _pf32,  # out_scores [T]
            _pi32,  # sel [M, k]
            _pi32,  # n_sel [M]
            _pi32,  # status [M]
        ]
        dll._df_scorer_bound = True
    return dll


class NativeScorer:
    """ctypes binding with GNNScorer's batch-score interface.

    `score(pair_feats, child=, parent=)` → [B] float32 in (0, 1). `ready` is
    always True once constructed (embeddings ship inside the artifact).
    """

    engine = "native"  # serving-mode metric label

    def __init__(self, artifact_path: str | Path):
        self._dll = _library()
        # bound-method + pointer-type lookups cached off the hot path: at the
        # 10k-calls/s target every getattr/py-object allocation per call counts
        self._score_fn = self._dll.df_scorer_score
        self._score_rounds_fn = self._dll.df_scorer_score_rounds
        self._drive_fn = self._dll.df_round_drive
        self._pi32 = _pi32
        self._pf32 = _pf32
        self.drive_calls = 0  # FFI-call observability
        self._handle = self._dll.df_scorer_load(str(artifact_path).encode())
        if not self._handle:
            raise IOError(f"failed to load scorer artifact {artifact_path}")
        self.num_nodes = self._dll.df_scorer_num_nodes(self._handle)
        self.embed_dim = self._dll.df_scorer_embed_dim(self._handle)
        self.feature_dim = self._dll.df_scorer_feature_dim(self._handle)

    @property
    def ready(self) -> bool:
        return True

    def score(
        self, pair_feats: np.ndarray, *, child: np.ndarray, parent: np.ndarray
    ) -> np.ndarray:
        feats = np.ascontiguousarray(pair_feats, np.float32)
        c = np.ascontiguousarray(child, np.int32)
        p = np.ascontiguousarray(parent, np.int32)
        batch = len(c)
        if len(p) != batch:
            raise ValueError(f"child/parent length mismatch: {batch} != {len(p)}")
        if feats.shape != (batch, self.feature_dim):
            raise ValueError(
                f"pair_feats shape {feats.shape} != ({batch}, {self.feature_dim})"
            )
        out = np.empty(batch, np.float32)
        rc = self._score_fn(
            self._handle,
            c.ctypes.data_as(self._pi32),
            p.ctypes.data_as(self._pi32),
            feats.ctypes.data_as(self._pf32),
            batch,
            out.ctypes.data_as(self._pf32),
        )
        if rc != 0:
            raise ValueError(f"native scorer rejected batch (rc={rc}): bad node index")
        return out

    def score_rounds(
        self, pair_feats: np.ndarray, *, child: np.ndarray, parent: np.ndarray
    ) -> np.ndarray:
        """Score M queued scheduling rounds in ONE FFI call (amortized path).

        pair_feats: [M, B, FP]; child/parent: [M, B] int32. Returns [M, B]
        float32. Rounds are independent, so the native side runs one flat
        (M·B)-row batch through the GEMMs — FFI, validation, and dispatch
        overhead is paid once per M rounds instead of per round.
        """
        feats = np.ascontiguousarray(pair_feats, np.float32)
        c = np.ascontiguousarray(child, np.int32)
        p = np.ascontiguousarray(parent, np.int32)
        if feats.ndim != 3 or c.shape != feats.shape[:2] or p.shape != c.shape:
            raise ValueError(
                f"shape mismatch: feats {feats.shape}, child {c.shape}, parent {p.shape}"
            )
        rounds, batch, fp = feats.shape
        if fp != self.feature_dim:
            raise ValueError(f"pair_feats last dim {fp} != {self.feature_dim}")
        out = np.empty((rounds, batch), np.float32)
        rc = self._score_rounds_fn(
            self._handle,
            c.ctypes.data_as(self._pi32),
            p.ctypes.data_as(self._pi32),
            feats.ctypes.data_as(self._pf32),
            rounds,
            batch,
            out.ctypes.data_as(self._pf32),
        )
        if rc == -2:
            raise ValueError(
                f"native scorer rejected batch: {rounds}x{batch} rows exceeds the "
                "2^24-row per-call cap"
            )
        if rc != 0:
            raise ValueError(f"native scorer rejected batch (rc={rc}): bad node index")
        return out

    def drive_rounds(
        self,
        offsets: np.ndarray,
        child_idx: np.ndarray,
        parent_idx: np.ndarray,
        feats: np.ndarray,
        round_cols: np.ndarray,
        filt: np.ndarray,
        *,
        rounds: int,
        k: int,
        max_depth: int,
        out_scores: np.ndarray,
        sel: np.ndarray,
        n_sel: np.ndarray,
        status: np.ndarray,
    ) -> None:
        """Drive `rounds` whole scheduling rounds in ONE FFI call (GIL released).

        The caller owns every buffer (a reusable per-thread arena — see
        the scheduler's _RoundArena) and guarantees dtype/contiguity: offsets,
        child_idx, parent_idx, n_sel, status and the [T,4] filt / [M,k] sel
        blocks are int32; feats ([T,FP]), round_cols ([M,3]) and out_scores
        ([T]) are float32. No per-call allocation or dtype coercion happens
        here — this wrapper is on the 10k-rounds/s hot path. The driver
        fills feats' round-constant columns, scores the survivor rows with
        the exact score_rounds pipeline, and writes stable top-k selections;
        per-round `status` distinguishes natively-scored rounds (0) from
        rounds the caller must re-run on the Python serial leg (1).
        """
        self.drive_rounds_bound(
            self.bind_drive(
                offsets, child_idx, parent_idx, feats, round_cols, filt,
                out_scores, sel, n_sel, status,
            ),
            rounds=rounds, k=k, max_depth=max_depth,
        )

    def bind_drive(
        self,
        offsets: np.ndarray,
        child_idx: np.ndarray,
        parent_idx: np.ndarray,
        feats: np.ndarray,
        round_cols: np.ndarray,
        filt: np.ndarray,
        out_scores: np.ndarray,
        sel: np.ndarray,
        n_sel: np.ndarray,
        status: np.ndarray,
    ) -> tuple:
        """Precompute drive_rounds' ctypes pointer arguments for a reusable
        buffer set. The 13 per-call `.ctypes.data_as` conversions cost ~40 µs
        per drive — a real tax on one-round batches — and the arena's buffers
        only move when it grows, so the binding is cached on the arena and
        invalidated by `_RoundArena.ensure` on reallocation. Pointer-only:
        a binding made through one forked handle is valid on any fork of the
        same model (ctypes pointer types are process-global)."""
        return (
            offsets.ctypes.data_as(self._pi32),
            child_idx.ctypes.data_as(self._pi32),
            parent_idx.ctypes.data_as(self._pi32),
            feats.ctypes.data_as(self._pf32),
            round_cols.ctypes.data_as(self._pf32),
            filt.ctypes.data_as(self._pi32),
            out_scores.ctypes.data_as(self._pf32),
            sel.ctypes.data_as(self._pi32),
            n_sel.ctypes.data_as(self._pi32),
            status.ctypes.data_as(self._pi32),
        )

    def drive_rounds_bound(
        self, binding: tuple, *, rounds: int, k: int, max_depth: int
    ) -> None:
        """drive_rounds over a prebuilt `bind_drive` binding (hot path)."""
        rc = self._drive_fn(
            self._handle,
            binding[0], binding[1], binding[2], binding[3], binding[4],
            binding[5], rounds, k, max_depth,
            binding[6], binding[7], binding[8], binding[9],
        )
        self.drive_calls += 1
        if rc != 0:
            raise ValueError(f"native round driver rejected batch (rc={rc})")

    def fork(self) -> "NativeScorer":
        """A second handle onto the SAME loaded model (df_scorer_fork).

        scorer.cc serializes concurrent calls on ONE handle behind an
        internal mutex (the scratch buffers live in the handle), so a scorer
        shared across the round dispatcher's worker threads would serialize
        exactly the leg the dispatcher exists to overlap. Each worker thread
        scores through its own forked handle instead (ScorerHandlePool).
        Forked handles share the immutable model data natively (refcounted)
        — no artifact re-read, and crucially no duplicated weight/embedding
        cache footprint: per-handle model copies capped 2-worker scaling at
        ~1.2x on a host whose compute scales 1.93x (LLC thrash)."""
        clone = object.__new__(NativeScorer)
        clone.__dict__.update(self.__dict__)
        handle = self._dll.df_scorer_fork(self._handle)
        if not handle:
            raise IOError("df_scorer_fork failed (closed handle?)")
        clone._handle = handle
        clone.drive_calls = 0  # each handle counts its own FFI calls
        return clone

    def limit_thread_parallelism(self, n: int = 1) -> None:
        """Cap intra-call OpenMP fan-out for the CALLING thread (per-thread
        ICV). Dispatcher worker threads call this once: sharding rounds
        across workers AND letting each call's GEMM spawn its own OMP team
        oversubscribes the host (libgomp spin-waiters starve the other
        workers' Python — measured negative scaling on the 2-core box)."""
        self._dll.df_scorer_set_thread_parallelism(n)

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._dll.df_scorer_free(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:  # dflint: disable=DF031 interpreter teardown can raise anything; __del__ must not
            pass


class NativeMirror:
    """ctypes binding for the `df_mirror_*` surface: the C-side
    mirror of the scheduler's per-task candidate state.

    This class is the thin FFI layer only — slot allocation, the mutation
    hooks, and the full-sync protocol live in the scheduler's MirrorClient
    (scheduler/mirror.py).
    Delta methods are cached bound functions because they sit on mutation
    hot paths (every feat bump crosses here once); `drive` marshals the
    caller's arena pointers the same way NativeScorer.bind_drive does.
    """

    _pi32 = ctypes.POINTER(ctypes.c_int32)
    _pi64 = ctypes.POINTER(ctypes.c_int64)
    _pf32 = ctypes.POINTER(ctypes.c_float)
    _pu32 = ctypes.POINTER(ctypes.c_uint32)

    def __init__(self, scorer: "NativeScorer", *, feature_dim: int | None = None):
        dll = scorer._dll
        self._dll = dll
        if not getattr(dll, "_df_mirror_bound", False):
            i32, i64 = ctypes.c_int32, ctypes.c_int64
            vp = ctypes.c_void_p
            dll.df_mirror_new.restype = vp
            dll.df_mirror_new.argtypes = [i32]
            dll.df_mirror_free.restype = None
            dll.df_mirror_free.argtypes = [vp]
            dll.df_mirror_host_upsert.restype = i32
            dll.df_mirror_host_upsert.argtypes = [vp, i32, i64, i32, i32]
            dll.df_mirror_host_remove.restype = i32
            dll.df_mirror_host_remove.argtypes = [vp, i32]
            dll.df_mirror_task_upsert.restype = i32
            dll.df_mirror_task_upsert.argtypes = [vp, i32]
            dll.df_mirror_task_remove.restype = i32
            dll.df_mirror_task_remove.argtypes = [vp, i32]
            dll.df_mirror_peer_add.restype = i32
            dll.df_mirror_peer_add.argtypes = [vp, i32, i32, i32, i32, i32, i64]
            dll.df_mirror_peer_remove.restype = i32
            dll.df_mirror_peer_remove.argtypes = [vp, i32]
            dll.df_mirror_peer_feat.restype = i32
            dll.df_mirror_peer_feat.argtypes = [vp, i32, i64, i32]
            dll.df_mirror_peer_state.restype = i32
            dll.df_mirror_peer_state.argtypes = [vp, i32, i32]
            dll.df_mirror_set_parents.restype = i32
            dll.df_mirror_set_parents.argtypes = [vp, i32, self._pi32, i32]
            dll.df_mirror_topo_bump.restype = i32
            dll.df_mirror_topo_bump.argtypes = [vp, i32, i32, i64]
            dll.df_mirror_bw_bump.restype = i32
            dll.df_mirror_bw_bump.argtypes = [vp, i32, i64]
            dll.df_mirror_set_node_indices.restype = i32
            dll.df_mirror_set_node_indices.argtypes = [vp, self._pi32, self._pi32, i32]
            dll.df_mirror_push_rows.restype = i32
            dll.df_mirror_push_rows.argtypes = [
                vp, i32, i32, self._pi32, self._pi64, self._pf32,
            ]
            dll.df_mirror_note_sync.restype = None
            dll.df_mirror_note_sync.argtypes = [vp]
            dll.df_mirror_stats.restype = None
            dll.df_mirror_stats.argtypes = [vp, self._pi64]
            dll.df_mirror_drive.restype = i32
            dll.df_mirror_drive.argtypes = [
                vp, vp, i32,                       # scorer, mirror, rounds
                self._pi32, self._pi32, self._pi32,  # task/child/child_host
                self._pi32, self._pi32,            # blocked_off, blocked
                self._pf32,                        # round_cols [M,3]
                i32, i32, i32,                     # sample_n, k, max_depth
                self._pu32,                        # rng_state [625] in/out
                self._pi32, self._pi32,            # offsets, cand_slots
                self._pf32, self._pf32,            # feats, out_scores
                self._pi32, self._pi32, self._pi32,  # sel, n_sel, status
                i32,                               # row_cap
            ]
            dll._df_mirror_bound = True
        self.feature_dim = int(feature_dim or scorer.feature_dim)
        self._handle = dll.df_mirror_new(self.feature_dim)
        if not self._handle:
            raise ValueError(f"df_mirror_new rejected feature_dim={self.feature_dim}")
        # cached bound fns: the delta methods ride mutation hot paths
        self.host_upsert_fn = dll.df_mirror_host_upsert
        self.host_remove_fn = dll.df_mirror_host_remove
        self.task_upsert_fn = dll.df_mirror_task_upsert
        self.task_remove_fn = dll.df_mirror_task_remove
        self.peer_add_fn = dll.df_mirror_peer_add
        self.peer_remove_fn = dll.df_mirror_peer_remove
        self.peer_feat_fn = dll.df_mirror_peer_feat
        self.peer_state_fn = dll.df_mirror_peer_state
        self._set_parents_fn = dll.df_mirror_set_parents
        self.topo_bump_fn = dll.df_mirror_topo_bump
        self.bw_bump_fn = dll.df_mirror_bw_bump
        self._drive_fn = dll.df_mirror_drive
        self.drive_calls = 0

    @property
    def handle(self):
        return self._handle

    def set_parents(self, child_slot: int, parent_slots) -> int:
        n = len(parent_slots)
        arr = (ctypes.c_int32 * n)(*parent_slots)
        return self._set_parents_fn(self._handle, child_slot, arr, n)

    def set_node_indices(self, slots: np.ndarray, idx: np.ndarray) -> int:
        s = np.ascontiguousarray(slots, np.int32)
        i = np.ascontiguousarray(idx, np.int32)
        return self._dll.df_mirror_set_node_indices(
            self._handle, s.ctypes.data_as(self._pi32),
            i.ctypes.data_as(self._pi32), len(s),
        )

    def push_rows(
        self, child_host_slot: int, peer_slots: np.ndarray, keys: np.ndarray,
        rows: np.ndarray,
    ) -> int:
        ps = np.ascontiguousarray(peer_slots, np.int32)
        ky = np.ascontiguousarray(keys, np.int64)
        rw = np.ascontiguousarray(rows, np.float32)
        return self._dll.df_mirror_push_rows(
            self._handle, child_host_slot, len(ps),
            ps.ctypes.data_as(self._pi32), ky.ctypes.data_as(self._pi64),
            rw.ctypes.data_as(self._pf32),
        )

    def note_sync(self) -> None:
        self._dll.df_mirror_note_sync(self._handle)

    _STAT_KEYS = (
        "deltas", "rows_pushed", "native_rounds", "stale_rounds",
        "fallback_rounds", "empty_rounds", "full_syncs", "drives",
        "peers", "hosts", "tasks", "rows_cached",
    )

    def stats(self) -> dict:
        out = (ctypes.c_int64 * 16)()
        self._dll.df_mirror_stats(self._handle, out)
        return dict(zip(self._STAT_KEYS, out[: len(self._STAT_KEYS)]))

    def bind_drive(
        self, task_slot, child_slot, child_host, blocked_off, blocked,
        round_cols, rng_state, offsets, cand_slots, feats, out_scores,
        sel, n_sel, status,
    ) -> tuple:
        """Precompute the drive's ctypes pointer arguments for a reusable
        arena (same caching contract as NativeScorer.bind_drive: the binding
        is invalidated by the arena whenever a buffer moves)."""
        return (
            task_slot.ctypes.data_as(self._pi32),
            child_slot.ctypes.data_as(self._pi32),
            child_host.ctypes.data_as(self._pi32),
            blocked_off.ctypes.data_as(self._pi32),
            blocked.ctypes.data_as(self._pi32),
            round_cols.ctypes.data_as(self._pf32),
            ctypes.cast(rng_state, self._pu32),
            offsets.ctypes.data_as(self._pi32),
            cand_slots.ctypes.data_as(self._pi32),
            feats.ctypes.data_as(self._pf32),
            out_scores.ctypes.data_as(self._pf32),
            sel.ctypes.data_as(self._pi32),
            n_sel.ctypes.data_as(self._pi32),
            status.ctypes.data_as(self._pi32),
        )

    def drive_bound(
        self, scorer: "NativeScorer", binding: tuple, *, rounds: int,
        sample_n: int, k: int, max_depth: int, row_cap: int,
    ) -> None:
        """One mirror-backed drive over a prebuilt binding (hot path). The
        GIL is released for the whole call; arg errors raise BEFORE any rng
        consumption (the C side validates first), so the caller can re-run
        the batch serially on the untouched rng stream."""
        rc = self._drive_fn(
            scorer._handle, self._handle, rounds,
            binding[0], binding[1], binding[2], binding[3], binding[4],
            binding[5], sample_n, k, max_depth, binding[6],
            binding[7], binding[8], binding[9], binding[10], binding[11],
            binding[12], binding[13], row_cap,
        )
        self.drive_calls += 1
        if rc != 0:
            raise ValueError(f"native mirror drive rejected batch (rc={rc})")

    def close(self) -> None:
        if getattr(self, "_handle", None):
            self._dll.df_mirror_free(self._handle)
            self._handle = None

    def __del__(self):  # best-effort; close() is the real API
        try:
            self.close()
        except Exception:  # dflint: disable=DF031 interpreter teardown can raise anything; __del__ must not
            pass


class ScorerHandlePool:
    """Per-thread native scorer handles behind one artifact.

    The pattern scorer.cc documents: concurrent scoring calls on one handle
    serialize on an internal mutex, so every thread that scores needs its own
    handle. `get()` returns the calling thread's handle, forking one from the
    primary on a thread's first call; the constructing thread (the scheduler
    event loop) is pre-bound to the PRIMARY scorer so single-threaded callers
    see zero behavior change. Forked handles are tracked and freed by
    `close()`; the pool never closes the primary (its owner does).

    Worker threads are long-lived (the dispatcher's ThreadPoolExecutor), so
    the handle count is bounded by the worker count, not the call count.
    """

    def __init__(self, scorer: "NativeScorer"):
        self._primary = scorer
        self._local = threading.local()
        self._local.scorer = scorer  # creator thread scores on the primary
        self._forks: list[NativeScorer] = []
        self._lock = threading.Lock()
        self._closed = False

    @property
    def ready(self) -> bool:
        return getattr(self._primary, "ready", False)

    def get(self) -> "NativeScorer":
        if self._closed:
            # the cached thread-local fork may already be freed — a closed
            # pool degrades every thread to the (caller-owned) primary
            # rather than handing back a handle whose native side is gone
            return self._primary
        s = getattr(self._local, "scorer", None)
        if s is None:
            s = self._primary.fork()
            # this NEW worker thread's GEMMs stay single-threaded: the
            # dispatcher parallelizes across workers, and nested OMP teams
            # oversubscribe the host (see limit_thread_parallelism)
            s.limit_thread_parallelism(1)
            with self._lock:
                if self._closed:  # raced a close(): don't leak the handle
                    s.close()
                    return self._primary
                self._forks.append(s)
            self._local.scorer = s
        return s

    def handles(self) -> int:
        """Live handle count (primary + forks) — observability/tests."""
        with self._lock:
            return 1 + len(self._forks)

    def close(self) -> None:
        with self._lock:
            self._closed = True
            forks, self._forks = self._forks, []
        for s in forks:
            s.close()
