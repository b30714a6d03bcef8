"""Build training inputs from telemetry records — vectorized and incremental.

The port's own copy of dragonfly2_tpu/trainer/dataset.py. It is numpy from
end to end, as the original is; what differs is that ``Dataset.graph`` is the
port's ``TopoGraph`` (numpy leaves, so ``train_gnn.train_async``,
``artifacts.save_graph`` and ``GNNScorer`` take it as it is) and that the
training-reference sketch is the port's ``FeatureSketch``. The tests hold it
to the JAX package's ``build_dataset`` and ``DatasetAccumulator`` bit for
bit: node numbering, neighbour tables, edge and node features, pairs and
sketch counts.

Reference context: the scheduler streams its Download and NetworkTopology CSVs
to the trainer (scheduler/announcer/announcer.go:193-259); the reference
trainer dropped them (never implemented). Here the records are columnar numpy
(telemetry/records.py) and convert straight into the GNN's dense padded
TopoGraph + the PairBatch pool both trainers consume — no CSV unflattening.

Host identity: record host-id strings index into a contiguous node table
(insertion-ordered). Node features are aggregated from the download records
(upload success rate per parent host); probe records supply the edge list and
RTT statistics.

Two construction paths share one vectorized core:

  build_dataset(downloads, probes)   one-shot over full record arrays
  DatasetAccumulator                 incremental — fold announcer chunks in as
                                     they arrive, finalize() in O(nodes+edges
                                     +pairs) at train_close

Both are columnar numpy end-to-end: host-id interning via a sort of the
structured-array id columns (first-occurrence order), per-(src,dst) probe
aggregation via bincount on packed 64-bit edge keys, neighbor tables via one
lexsort on (src, rtt, arrival) with a vectorized top-max_neighbors cut, and
node features via bincount weights. The JAX package keeps a per-row
reference walk of the same semantics for its own tests; the port is held
against the JAX ``build_dataset`` itself.

Threading model: DatasetAccumulator folds run on the trainer's event loop
(sub-ms per announcer chunk); freeze() takes a cheap consistent snapshot so
finalize() can run on a worker thread while new chunks keep folding.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from dragonfly2_tpu_torch.models.features import FEATURE_DIM, FEATURE_NAMES, NODE_FEATURE_DIM
from dragonfly2_tpu_torch.models.graphsage import TopoGraph
from dragonfly2_tpu_torch.observability.sketches import FeatureSketch
from dragonfly2_tpu_torch.trainer.synthetic import EDGE_FEATURE_DIM, PairBatch

GIB = float(1 << 30)


@dataclass
class Dataset:
    graph: TopoGraph
    pairs: PairBatch
    host_index: dict[bytes, int]  # host_id -> node row
    # Training-reference feature sketch: the per-feature histogram of the
    # pair rows this dataset trains on, frozen HERE at finalize so it
    # describes exactly the distribution the model saw. Ships
    # digest-covered inside the artifact (trainer/artifacts.py) and becomes
    # the serving scheduler's drift baseline.
    feature_sketch: FeatureSketch | None = None

    @property
    def num_nodes(self) -> int:
        return self.graph.node_feats.shape[0]

    @property
    def num_pairs(self) -> int:
        return len(self.pairs.child)


def _sorted_unique(ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(sorted unique values, per-element inverse) — np.sort + one searchsorted,
    ~2.5x cheaper than np.unique(return_index/return_inverse) on S-dtype ids
    (measured: the stable argsort unique uses dominates build time)."""
    s = np.sort(ids)
    uniq = s[np.r_[True, s[1:] != s[:-1]]]
    return uniq, np.searchsorted(uniq, ids)


def _first_occurrence_rank(inv: np.ndarray, n_uniq: int) -> np.ndarray:
    """rank[u] = arrival order of unique u within the element sequence —
    rank 0 for whichever unique appears first, matching a row-walk's
    insertion order without the stable-argsort unique."""
    first = np.full(n_uniq, len(inv), np.int64)
    np.minimum.at(first, inv, np.arange(len(inv), dtype=np.int64))
    rank = np.empty(n_uniq, np.int64)
    rank[np.argsort(first, kind="stable")] = np.arange(n_uniq)
    return rank


class _Interner:
    """Vectorized insertion-ordered id interning.

    codes() assigns contiguous indices by order of FIRST OCCURRENCE across
    all calls — identical to walking the rows one by one through a dict.
    A sorted (ids, codes) cache resolves already-known ids with one binary
    search, so steady-state incremental folds never re-sort the id universe;
    only ids new to a batch touch the dict.
    """

    __slots__ = ("index", "_sorted_ids", "_sorted_codes")

    def __init__(self) -> None:
        self.index: dict[bytes, int] = {}
        self._sorted_ids: np.ndarray | None = None
        self._sorted_codes: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.index)

    def _probe(self, ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(known mask, codes — valid where known) against the sorted cache."""
        table, codes = self._sorted_ids, self._sorted_codes
        if table is None or not len(table):
            return np.zeros(len(ids), bool), np.zeros(len(ids), np.int64)
        pos = np.minimum(np.searchsorted(table, ids), len(table) - 1)
        return table[pos] == ids, codes[pos]

    def _admit(self, new_ids: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Intern unseen ids (given in arrival order, duplicates allowed);
        returns (their sorted uniques, per-element codes)."""
        uniq, inv = _sorted_unique(new_ids)
        rank = _first_occurrence_rank(inv, len(uniq))
        base = len(self.index)
        lut = base + rank
        index = self.index
        order = np.empty(len(uniq), np.int64)
        order[rank] = np.arange(len(uniq))
        for key in uniq[order].tolist():
            index[key] = len(index)
        if self._sorted_ids is None or not len(self._sorted_ids):
            self._sorted_ids, self._sorted_codes = uniq, lut
        else:
            merged = np.concatenate([self._sorted_ids, uniq])
            mcodes = np.concatenate([self._sorted_codes, lut])
            o = np.argsort(merged, kind="stable")
            self._sorted_ids, self._sorted_codes = merged[o], mcodes[o]
        return uniq, lut[inv]

    # Unknown ids are admitted a segment at a time: sorting S-ids is the
    # dominant cost, and after one segment most later "unknowns" are really
    # repeats — a binary-search probe against the refreshed cache is ~3x
    # cheaper than sorting them (one-shot 100k-row builds hit the same
    # amortization the chunked fold path gets for free).
    _ADMIT_SEGMENT = 32768

    def codes(self, ids: np.ndarray) -> np.ndarray:
        """Get-or-add: int64 code per element, first-occurrence ordered."""
        if len(ids) == 0:
            return np.zeros(0, np.int64)
        known, out = self._probe(ids)
        pending = np.flatnonzero(~known)
        while len(pending):
            seg, pending = pending[: self._ADMIT_SEGMENT], pending[self._ADMIT_SEGMENT :]
            _, out[seg] = self._admit(ids[seg])
            if len(pending):
                k2, o2 = self._probe(ids[pending])
                out[pending[k2]] = o2[k2]
                pending = pending[~k2]
        return out


class _Grow:
    """Amortized-doubling growable array (rows on axis 0)."""

    __slots__ = ("a", "n")

    def __init__(self, dtype, cols: int | None = None):
        shape = (0,) if cols is None else (0, cols)
        self.a = np.zeros(shape, dtype)
        self.n = 0

    def ensure(self, rows: int) -> None:
        """Grow (zero-filled) so that `rows` total rows are addressable."""
        if rows > len(self.a):
            cap = max(rows, 2 * len(self.a), 256)
            grown = np.zeros((cap,) + self.a.shape[1:], self.a.dtype)
            grown[: self.n] = self.a[: self.n]
            self.a = grown
        self.n = max(self.n, rows)

    def view(self) -> np.ndarray:
        return self.a[: self.n]


def _interleave(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """[a0, b0, a1, b1, ...] — the id sequence a per-row (a, b) walk interns."""
    out = np.empty(2 * len(a), dtype=a.dtype)
    out[0::2] = a
    out[1::2] = b
    return out


class FrozenIngest:
    """Immutable snapshot of accumulator state; finalize() is pure and safe
    to run on a worker thread while the live accumulator keeps folding."""

    def __init__(
        self,
        host_index: dict[bytes, int],
        edge_src: np.ndarray,
        edge_dst: np.ndarray,
        edge_sum: np.ndarray,
        edge_cnt: np.ndarray,
        stat_ids: list[bytes],
        stat_tot: np.ndarray,
        stat_succ: np.ndarray,
        stat_bw: np.ndarray,
        pair_chunks: tuple[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray], ...],
    ):
        self.host_index = host_index
        self._edge_src = edge_src
        self._edge_dst = edge_dst
        self._edge_sum = edge_sum
        self._edge_cnt = edge_cnt
        self._stat_ids = stat_ids
        self._stat_tot = stat_tot
        self._stat_succ = stat_succ
        self._stat_bw = stat_bw
        self._pair_chunks = pair_chunks

    def finalize(self, *, max_neighbors: int = 16, min_nodes: int = 8) -> Dataset:
        n = max(len(self.host_index), min_nodes)
        k = max_neighbors
        neighbors = np.zeros((n, k), np.int32)
        mask = np.zeros((n, k), np.float32)
        edge_feats = np.zeros((n, k, EDGE_FEATURE_DIM), np.float32)

        m = len(self._edge_src)
        if m:
            agg = self._edge_sum / self._edge_cnt[:, None]
            src = self._edge_src
            # stable (src, rtt_mean, arrival) order == the row-walk's
            # per-source stable sort by RTT with insertion-order tie-break;
            # keep the lowest-RTT max_neighbors per source (they matter most)
            order = np.lexsort((np.arange(m), agg[:, 0], src))
            s_sorted = src[order]
            starts = np.flatnonzero(np.r_[True, s_sorted[1:] != s_sorted[:-1]])
            seg_len = np.diff(np.r_[starts, m])
            pos_in_src = np.arange(m) - np.repeat(starts, seg_len)
            keep = pos_in_src < k
            sel = order[keep]
            rows = s_sorted[keep]
            cols = pos_in_src[keep]
            a = agg[sel]
            neighbors[rows, cols] = self._edge_dst[sel].astype(np.int32)
            mask[rows, cols] = 1.0
            edge_feats[rows, cols, 0] = a[:, 0] / 100.0  # ms -> per-100ms
            edge_feats[rows, cols, 1] = a[:, 1] / 100.0
            edge_feats[rows, cols, 2] = a[:, 2] / 100.0
            edge_feats[rows, cols, 3] = np.minimum(1.0, a[:, 3] / 30.0)

        # --- node features aggregated from download history ---
        node_feats = np.zeros((n, NODE_FEATURE_DIM), np.float32)
        if self._stat_ids:
            index = self.host_index
            main = np.fromiter(
                (index.get(h, -1) for h in self._stat_ids),
                np.int64,
                count=len(self._stat_ids),
            )
            present = main >= 0  # parents only ever seen in failed rows w/o probes drop out
            rows = main[present]
            total_cnt = np.zeros(n)
            success_cnt = np.zeros(n)
            bw_sum = np.zeros(n)
            total_cnt[rows] = self._stat_tot[present]
            success_cnt[rows] = self._stat_succ[present]
            bw_sum[rows] = self._stat_bw[present]
            served = total_cnt > 0
            node_feats[served, 1] = success_cnt[served] / total_cnt[served]
            node_feats[served, 5] = bw_sum[served] / total_cnt[served]
        # pair features carry the rest of the observable signal; idc/location
        # hash slots stay zero until host announces flow into telemetry

        if self._pair_chunks:
            cols4 = list(zip(*self._pair_chunks))
            pairs = PairBatch(
                np.concatenate(cols4[0]),
                np.concatenate(cols4[1]),
                np.concatenate(cols4[2]),
                np.concatenate(cols4[3]),
            )
        else:
            pairs = PairBatch(
                np.asarray([0], np.int32),
                np.asarray([0], np.int32),
                np.zeros((1, FEATURE_DIM), np.float32),
                np.asarray([0.0], np.float32),
            )
        graph = TopoGraph(node_feats, neighbors, mask, edge_feats)
        # freeze the training-reference sketch from the pair rows the model
        # will actually fit; one vectorized pass, O(pairs x F)
        sketch = FeatureSketch(FEATURE_DIM, names=FEATURE_NAMES)
        sketch.update(pairs.feats)
        return Dataset(
            graph=graph, pairs=pairs, host_index=dict(self.host_index),
            feature_sketch=sketch,
        )


class DatasetAccumulator:
    """Incremental telemetry→dataset ingest.

    Fold each announcer chunk in as it arrives (add_downloads/add_probes);
    finalize() materializes the Dataset from the aggregated state in
    O(nodes + edges + retained pairs) — no re-walk of raw telemetry rows, no
    retained raw record arrays. State kept:

      - host table        id -> node row, first-occurrence ordered
      - pair pool         columnar (child, parent, feats, label) chunks; when
                          max_pair_rows > 0, oldest whole chunks are evicted
                          once the newer ones alone reach the cap (the rolling
                          pool the per-upload row arrays used to provide, at
                          ~76 B/pair instead of ~376 B/raw row)
      - edge stats        per-(src,dst) float64 stat sums + probe-row counts,
                          keyed by packed 64-bit (src<<32|dst)
      - node counters     per-parent-id totals/successes/bandwidth sums, in a
                          side table so a parent first seen in a failed row
                          still counts once (and only once) it enters the host
                          table via a later ok-row or probe — matching the
                          one-shot walk, which counts after full interning

    Fold order defines node numbering: per upload the announcer streams all
    download chunks then all probe chunks, which reproduces build_dataset's
    interning order exactly (the chunked≡one-shot equivalence tests pin this).
    """

    def __init__(self, *, max_pair_rows: int = 0):
        self.hosts = _Interner()
        self.max_pair_rows = max_pair_rows
        self._pair_chunks: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        self.pair_rows = 0
        self._edge_pos: dict[int, int] = {}
        self._edge_src = _Grow(np.int64)
        self._edge_dst = _Grow(np.int64)
        self._edge_sum = _Grow(np.float64, cols=EDGE_FEATURE_DIM)
        self._edge_cnt = _Grow(np.int64)
        self._stats = _Interner()
        self._stat_tot = _Grow(np.float64)
        self._stat_succ = _Grow(np.float64)
        self._stat_bw = _Grow(np.float64)
        self.download_rows = 0
        self.probe_rows = 0

    @property
    def num_hosts(self) -> int:
        return len(self.hosts)

    @property
    def num_edges(self) -> int:
        return self._edge_src.n

    def add_downloads(self, arr: np.ndarray) -> int:
        """Fold one DOWNLOAD_DTYPE chunk; returns rows folded."""
        rows = len(arr)
        if rows == 0:
            return 0
        self.download_rows += rows

        # field-wise extraction: indexing a single column copies only that
        # column; fancy-indexing the structured array would copy every field
        success = arr["success"]
        parent = arr["parent_host_id"]
        has_parent = parent != b""
        ok = success & has_parent  # back-to-source trains nothing pairwise
        if ok.any():
            ids = _interleave(arr["child_host_id"][ok], parent[ok])
            codes = self.hosts.codes(ids)
            labels = np.minimum(
                1.0, arr["bandwidth_bps"][ok].astype(np.float64) / GIB
            ).astype(np.float32)
            self._pair_chunks.append(
                (
                    codes[0::2].astype(np.int32),
                    codes[1::2].astype(np.int32),
                    arr["pair_features"][ok].astype(np.float32),
                    labels,
                )
            )
            self.pair_rows += int(ok.sum())
            self._evict_pairs()

        # --- per-parent upload counters (all rows, success or not) ---
        if has_parent.any():
            codes = self._stats.codes(parent[has_parent])
            nstat = len(self._stats)
            for g in (self._stat_tot, self._stat_succ, self._stat_bw):
                g.ensure(nstat)
            self._stat_tot.view()[:] += np.bincount(codes, minlength=nstat)
            su = success[has_parent]
            if su.any():
                okc = codes[su]
                self._stat_succ.view()[:] += np.bincount(okc, minlength=nstat)
                bw = np.minimum(
                    1.0, arr["bandwidth_bps"][has_parent][su].astype(np.float64) / GIB
                )
                self._stat_bw.view()[:] += np.bincount(
                    okc, weights=bw, minlength=nstat
                )
        return rows

    def _edge_rows(self, keys: np.ndarray) -> np.ndarray:
        """Get-or-add edge-table rows for packed (src<<32|dst) keys given in
        arrival order (duplicates allowed); new edges are appended in
        first-occurrence order. Returns the edge row per key position."""
        uniq, inv = _sorted_unique(keys)
        rank = _first_occurrence_rank(inv, len(uniq))
        order = np.empty(len(uniq), np.int64)
        order[rank] = np.arange(len(uniq))
        edge_pos = self._edge_pos
        base = self._edge_src.n
        rows_for = np.empty(len(uniq), np.int64)
        new_keys: list[int] = []
        for pos, key in zip(order.tolist(), uniq[order].tolist()):
            r = edge_pos.get(key)
            if r is None:
                r = edge_pos[key] = base + len(new_keys)
                new_keys.append(key)
            rows_for[pos] = r
        if new_keys:
            nk = np.asarray(new_keys, np.int64)
            total = base + len(new_keys)
            for g in (self._edge_src, self._edge_dst, self._edge_sum, self._edge_cnt):
                g.ensure(total)
            self._edge_src.view()[base:] = nk >> 32
            self._edge_dst.view()[base:] = nk & 0xFFFFFFFF
        return rows_for[inv]

    def add_probes(self, arr: np.ndarray) -> int:
        """Fold one PROBE_DTYPE chunk; returns rows folded."""
        rows = len(arr)
        if rows == 0:
            return 0
        self.probe_rows += rows

        ids = _interleave(arr["src_host_id"], arr["dst_host_id"])
        codes = self.hosts.codes(ids)
        s, d = codes[0::2], codes[1::2]
        erows = self._edge_rows((s << 32) | d)
        uniq_rows, inv = _sorted_unique(erows)

        stats = np.empty((rows, EDGE_FEATURE_DIM), np.float64)
        stats[:, 0] = arr["rtt_mean_ms"]
        stats[:, 1] = arr["rtt_std_ms"]
        stats[:, 2] = arr["rtt_min_ms"]
        stats[:, 3] = arr["probe_count"]
        esum = self._edge_sum.view()
        for c in range(EDGE_FEATURE_DIM):
            esum[uniq_rows, c] += np.bincount(
                inv, weights=stats[:, c], minlength=len(uniq_rows)
            )
        self._edge_cnt.view()[uniq_rows] += np.bincount(inv, minlength=len(uniq_rows))
        return rows

    def merge_from(self, other: "DatasetAccumulator") -> None:
        """Fold another accumulator's aggregated state in — O(other's
        nodes + edges + pair chunks), never touching raw rows. The service
        commits a session's accumulator into the shared pool at train_close
        this way: a session that dies mid-upload (RPC failure, TTL eviction)
        contributes NOTHING, so an announcer retry of the same snapshot can
        never double-count. Host/edge arrival order follows other's internal
        first-occurrence order, exactly as if its rows had been folded here
        directly."""
        if other.download_rows == 0 and other.probe_rows == 0:
            return
        # hosts: other's code i sits at position i of its insertion-ordered
        # key list; get-or-add yields the remap other-code -> self-code
        remap = np.zeros(0, np.int64)
        if len(other.hosts):
            ids = np.array(list(other.hosts.index), dtype="S64")
            remap = self.hosts.codes(ids)

        for child, parent, feats, labels in other._pair_chunks:
            self._pair_chunks.append(
                (
                    remap[child].astype(np.int32),
                    remap[parent].astype(np.int32),
                    feats,
                    labels,
                )
            )
            self.pair_rows += len(child)
        self._evict_pairs()

        m = other._edge_src.n
        if m:
            s = remap[other._edge_src.view()]
            d = remap[other._edge_dst.view()]
            erows = self._edge_rows((s << 32) | d)  # other's edges are unique keys
            self._edge_sum.view()[erows] += other._edge_sum.view()
            self._edge_cnt.view()[erows] += other._edge_cnt.view()

        if len(other._stats):
            sids = np.array(list(other._stats.index), dtype="S64")
            scodes = self._stats.codes(sids)
            nstat = len(self._stats)
            for g in (self._stat_tot, self._stat_succ, self._stat_bw):
                g.ensure(nstat)
            self._stat_tot.view()[scodes] += other._stat_tot.view()
            self._stat_succ.view()[scodes] += other._stat_succ.view()
            self._stat_bw.view()[scodes] += other._stat_bw.view()

        self.download_rows += other.download_rows
        self.probe_rows += other.probe_rows

    def _evict_pairs(self) -> None:
        """Rolling-pool semantics of the old per-session row arrays: evict
        oldest whole chunks while the remainder alone still covers the cap."""
        cap = self.max_pair_rows
        if cap <= 0:
            return
        chunks = self._pair_chunks
        while len(chunks) > 1 and self.pair_rows - len(chunks[0][0]) >= cap:
            self.pair_rows -= len(chunks.pop(0)[0])

    def freeze(self) -> FrozenIngest:
        """Cheap consistent snapshot (copies only the aggregate arrays; pair
        chunks are append-only so a shallow tuple copy suffices)."""
        return FrozenIngest(
            host_index=dict(self.hosts.index),
            edge_src=self._edge_src.view().copy(),
            edge_dst=self._edge_dst.view().copy(),
            edge_sum=self._edge_sum.view().copy(),
            edge_cnt=self._edge_cnt.view().copy(),
            stat_ids=list(self._stats.index),
            stat_tot=self._stat_tot.view().copy(),
            stat_succ=self._stat_succ.view().copy(),
            stat_bw=self._stat_bw.view().copy(),
            pair_chunks=tuple(self._pair_chunks),
        )

    def finalize(self, *, max_neighbors: int = 16, min_nodes: int = 8) -> Dataset:
        """Materialize the Dataset from aggregated state (non-destructive —
        keep folding and finalize again later)."""
        return self.freeze().finalize(max_neighbors=max_neighbors, min_nodes=min_nodes)


def build_dataset(
    downloads: np.ndarray,
    probes: np.ndarray,
    *,
    max_neighbors: int = 16,
    min_nodes: int = 8,
) -> Dataset:
    """downloads: DOWNLOAD_DTYPE rows; probes: PROBE_DTYPE rows.

    One-shot wrapper over the vectorized accumulator.
    """
    acc = DatasetAccumulator()
    if len(downloads):  # 0-row placeholders may be plain (non-structured) zeros
        acc.add_downloads(downloads)
    if len(probes):
        acc.add_probes(probes)
    return acc.finalize(max_neighbors=max_neighbors, min_nodes=min_nodes)


def split_pairs(pairs: PairBatch, holdout: float = 0.1, seed: int = 0) -> tuple[PairBatch, PairBatch]:
    """Random train/eval split of the pair pool."""
    n = len(pairs.child)
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_eval = max(1, int(n * holdout)) if n > 1 else 0
    ev, tr = perm[:n_eval], perm[n_eval:]
    take = lambda idx: PairBatch(*(np.asarray(a)[idx] for a in pairs))
    return take(tr if len(tr) else perm), take(ev if len(ev) else perm)
