// Native batched parent scorer: the XLA-AOT-style serving artifact.
//
// Serving equivalent of the reference's intended TensorFlow-Serving Predict
// hop (pkg/rpc/tfserving/client/client_v1.go:82-102), replaced per SURVEY.md
// §2.1 by a compiled CPU artifact linked into the scheduler process — no RPC,
// no Python, no JAX runtime on the hot path. The trainer exports cached
// GraphSAGE node embeddings plus the pairwise MLP head (models/graphsage.py
// TopoScorer.head: Dense→gelu→Dense→gelu→Dense→sigmoid) into a flat binary;
// this library mmap-loads it and scores batches of (child, parent, features)
// candidates.
//
// Serving math. The head's first layer sees x = [z_c, z_p, z_c∘z_p, feats].
// Because z is a FIXED node table at serving time, the z_c and z_p
// contributions to layer 1 are linear in a per-node vector and are
// precomputed at load time:
//     uc[n] = W1[0:D]ᵀ z[n]        up[n] = W1[D:2D]ᵀ z[n]       ([N, H1] each)
// so a scoring round only contracts the (z_c∘z_p, feats) tail — (D+FP) input
// dims instead of (3D+FP), a ~2.8× FLOP cut at the shipped shapes
// (D=128, FP=16, H1=256).
//
// Entry points:
//   df_scorer_score        — one scheduling round (B candidate pairs)
//   df_scorer_score_rounds — M queued rounds in ONE FFI call (the 10k-calls/s
//                            amortized path; rounds are independent, so this
//                            is a flat (M·B)-row batch through the same GEMMs)
//   df_round_drive         — M whole scheduling rounds in ONE call: re-validate
//                            the Python-snapshotted filter fields, fill the
//                            round-constant feature columns, score every
//                            survivor row through the same per-row pipeline as
//                            score_rounds (bit-identical math), then stable
//                            top-k per round. Python keeps only the snapshot
//                            (under the scheduler state lock) and the commit.
//
// Thread safety: scratch buffers live in the handle, so concurrent scoring
// calls on ONE handle are serialized by an internal mutex (ctypes releases
// the GIL during the call — without the lock two Python threads sharing a
// scorer would race on the scratch vectors). For parallel serving use one
// handle per thread — df_scorer_fork hands out extra handles that SHARE the
// immutable model data (weights/embeddings/precompute, refcounted), so N
// worker threads cost one model's cache footprint, not N. OpenMP (when
// compiled in) parallelizes INSIDE a call across row blocks;
// df_scorer_set_thread_parallelism caps that per calling thread.
//
// Build: g++ -O3 -shared -fPIC -o libdfscorer.so scorer.cc  (see scorer.py)
//
// Artifact layout (little-endian):
//   u32 magic 0x44465343 ("DFSC")  u32 version=1
//   u32 N (nodes)  u32 D (embed dim)  u32 FP (pair-feature dim)
//   u32 H1  u32 H2 (head hidden dims)
//   f32 z[N*D]                      cached node embeddings (row-major)
//   f32 W1[(3D+FP)*H1]  f32 b1[H1]  head layer 0 (kernel = flax [in, out]
//   f32 W2[H1*H2]       f32 b2[H2]    row-major)
//   f32 W3[H2*1]        f32 b3[1]

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <mutex>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr uint32_t kMagic = 0x44465343u;
constexpr uint32_t kVersion = 1u;

struct Header {
  uint32_t magic, version, n, d, fp, h1, h2;
};

// Rational tanh (Eigen's float coefficients): 7 FMAs + one divide, fully
// vectorizable — std::tanh would cost a libm call per element and the gelu
// pass touches H1+H2 = 384 activations per candidate. Max abs error vs
// libm tanhf is ~1e-6, far inside the bf16 tolerance the JAX-parity test
// allows.
inline float fast_tanh(float x) {
  x = std::min(std::max(x, -7.90531110763549805f), 7.90531110763549805f);
  const float x2 = x * x;
  float p = -2.76076847742355e-16f;
  p = p * x2 + 2.00018790482477e-13f;
  p = p * x2 + -8.60467152213735e-11f;
  p = p * x2 + 5.12229709037114e-08f;
  p = p * x2 + 1.48572235717979e-05f;
  p = p * x2 + 6.37261928875436e-04f;
  p = p * x2 + 4.89352455891786e-03f;
  p = p * x;
  float q = 1.19825839466702e-06f;
  q = q * x2 + 1.18534705686654e-04f;
  q = q * x2 + 2.26843463243900e-03f;
  q = q * x2 + 4.89352518554385e-03f;
  return p / q;
}

inline float gelu(float x) {
  // tanh approximation — matches jax.nn.gelu(approximate=True), the flax
  // default used by TopoScorer.head
  const float kC = 0.7978845608028654f;  // sqrt(2/pi)
  return 0.5f * x * (1.0f + fast_tanh(kC * (x + 0.044715f * x * x * x)));
}

inline float sigmoidf(float x) { return 1.0f / (1.0f + std::exp(-x)); }

// 16-lane float vector via GNU vector extensions (gcc/clang): one AVX-512
// zmm or a ymm pair. Local float[16] accumulator arrays looked equivalent but
// gcc 12 spilled them to the stack inside the FMA loop; typed vector
// variables stay in registers.
typedef float v16 __attribute__((vector_size(64)));
typedef float v16u __attribute__((vector_size(64), aligned(4), may_alias));

inline v16 loadu16(const float* p) { return *reinterpret_cast<const v16u*>(p); }
inline void storeu16(float* p, v16 v) { *reinterpret_cast<v16u*>(p) = v; }

// Y[R, out] += X[R, in] · W[in, out]   (W row-major [in][out], flax layout;
// Y PRE-INITIALIZED by the caller with bias / per-node partials).
//
// Register-blocked micro-kernel: 8 rows × 16 cols of Y live in 8 vector
// registers across the whole contraction — Y is read and written exactly
// once, and each streamed W vector feeds 8 FMAs.
//
// Loop order is column-panel OUTER, row-block inner: the W panel
// (in × 16 floats, ~9 KB at serving shapes) stays L1-resident across every
// row block, so W streams from cache once per call. The row-outer order
// re-streamed the whole W (147 KB at H1=256) per 8-row block — R/8 × 147 KB
// of LLC/DRAM traffic per call, which is what capped two dispatcher
// workers' concurrent GEMMs at ~1.3x on a host whose ALU-bound work scales
// 1.93x (X re-reads cost in/out = ~0.5 the W traffic saved, and X rows are
// hot in L2 anyway).
void gemm_acc(const float* __restrict__ X, const float* __restrict__ W,
              float* __restrict__ Y, int R, int in, int out) {
  constexpr int RB = 8, CB = 16;
  int o = 0;
  for (; o + CB <= out; o += CB) {
    const float* Wp = W + o;
    int r = 0;
    for (; r + RB <= R; r += RB) {
      const float* x[RB];
      float* y[RB];
      for (int k = 0; k < RB; ++k) {
        x[k] = X + static_cast<size_t>(r + k) * in;
        y[k] = Y + static_cast<size_t>(r + k) * out;
      }
      v16 a0 = loadu16(y[0] + o), a1 = loadu16(y[1] + o);
      v16 a2 = loadu16(y[2] + o), a3 = loadu16(y[3] + o);
      v16 a4 = loadu16(y[4] + o), a5 = loadu16(y[5] + o);
      v16 a6 = loadu16(y[6] + o), a7 = loadu16(y[7] + o);
      const float* w = Wp;
      for (int i = 0; i < in; ++i, w += out) {
        const v16 wv = loadu16(w);
        a0 += x[0][i] * wv;
        a1 += x[1][i] * wv;
        a2 += x[2][i] * wv;
        a3 += x[3][i] * wv;
        a4 += x[4][i] * wv;
        a5 += x[5][i] * wv;
        a6 += x[6][i] * wv;
        a7 += x[7][i] * wv;
      }
      storeu16(y[0] + o, a0);
      storeu16(y[1] + o, a1);
      storeu16(y[2] + o, a2);
      storeu16(y[3] + o, a3);
      storeu16(y[4] + o, a4);
      storeu16(y[5] + o, a5);
      storeu16(y[6] + o, a6);
      storeu16(y[7] + o, a7);
    }
    for (; r < R; ++r) {
      const float* xr = X + static_cast<size_t>(r) * in;
      float* yr = Y + static_cast<size_t>(r) * out;
      v16 a = loadu16(yr + o);
      const float* w = Wp;
      for (int i = 0; i < in; ++i, w += out) a += xr[i] * loadu16(w);
      storeu16(yr + o, a);
    }
  }
  for (; o < out; ++o) {
    const float* w0 = W + o;
    for (int r = 0; r < R; ++r) {
      const float* xr = X + static_cast<size_t>(r) * in;
      float a = Y[static_cast<size_t>(r) * out + o];
      const float* w = w0;
      for (int i = 0; i < in; ++i, w += out) a += xr[i] * *w;
      Y[static_cast<size_t>(r) * out + o] = a;
    }
  }
}

}  // namespace

extern "C" {

// Cap THIS THREAD's intra-call OpenMP parallelism (nthreads ICV is
// per-thread). The scheduler's round dispatcher pins its worker threads to
// 1: it shards rounds ACROSS workers, and letting every worker's GEMM also
// fan out OMP threads oversubscribes the host — libgomp's spin-waiting
// helpers burn the very cores the other workers' Python needs (measured
// NEGATIVE scaling, 0.74x at 2 workers on a 2-core host). Single-threaded
// callers (the micro-batch serving path, the bench headline) never call
// this and keep whole-host intra-call parallelism. No-op without OpenMP.
void df_scorer_set_thread_parallelism(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#endif
  (void)n;
}

// Immutable model data, SHARED across handles (refcounted): the weights,
// embeddings, and uc/up precompute total ~1-2 MB at serving shapes, and the
// GEMM streams them every call — per-handle copies would double the cache
// working set per added worker thread and thrash the shared LLC (measured:
// duplicating the model capped 2-worker scaling at ~1.2x on a host whose
// compute scales 1.93x; sharing restores the headroom). Handles only own
// scratch + a mutex.
struct DfModel {
  Header hdr;
  std::vector<float> z, w1, b1, w2, b2, w3, b3;
  // load-time precompute: first-layer contributions of each node's embedding
  // in child position (uc) and parent position (up), [N, H1] each
  std::vector<float> uc, up;
  std::atomic<int32_t> refs{1};
};

struct DfScorer {
  DfModel* model;
  // per-handle scratch reused across calls (no per-call malloc on the hot
  // path); sliced disjointly by OpenMP row blocks inside one call, guarded
  // across calls by `mu` — which is why concurrent threads need one handle
  // each (df_scorer_fork)
  std::vector<float> sx, sy1, sy2;
  std::mutex mu;
};

DfScorer* df_scorer_load(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  DfModel* m = new DfModel();
  bool ok = std::fread(&m->hdr, sizeof(Header), 1, f) == 1 &&
            m->hdr.magic == kMagic && m->hdr.version == kVersion;
  if (ok) {
    const Header& h = m->hdr;
    const uint32_t in = 3 * h.d + h.fp;
    auto rd = [&](std::vector<float>& v, size_t count) {
      v.resize(count);
      return std::fread(v.data(), sizeof(float), count, f) == count;
    };
    ok = rd(m->z, (size_t)h.n * h.d) && rd(m->w1, (size_t)in * h.h1) &&
         rd(m->b1, h.h1) && rd(m->w2, (size_t)h.h1 * h.h2) && rd(m->b2, h.h2) &&
         rd(m->w3, h.h2) && rd(m->b3, 1);
  }
  std::fclose(f);
  if (!ok) {
    delete m;
    return nullptr;
  }
  // Precompute uc = z · W1[0:D], up = z · W1[D:2D]  (one-time ~2·N·D·H1 MACs)
  const Header& h = m->hdr;
  m->uc.assign((size_t)h.n * h.h1, 0.0f);
  m->up.assign((size_t)h.n * h.h1, 0.0f);
  gemm_acc(m->z.data(), m->w1.data(), m->uc.data(), (int)h.n, (int)h.d,
           (int)h.h1);
  gemm_acc(m->z.data(), m->w1.data() + (size_t)h.d * h.h1, m->up.data(),
           (int)h.n, (int)h.d, (int)h.h1);
  DfScorer* s = new DfScorer();
  s->model = m;
  return s;
}

// A new handle onto the SAME model (refs++): fresh scratch + mutex, zero
// copies — the per-worker-thread handle the scheduler's round dispatcher
// uses (scorer.cc rule: one handle per thread).
DfScorer* df_scorer_fork(DfScorer* s) {
  if (!s) return nullptr;
  s->model->refs.fetch_add(1, std::memory_order_relaxed);
  DfScorer* t = new DfScorer();
  t->model = s->model;
  return t;
}

void df_scorer_free(DfScorer* s) {
  if (!s) return;
  if (s->model->refs.fetch_sub(1, std::memory_order_acq_rel) == 1) {
    delete s->model;
  }
  delete s;
}

int32_t df_scorer_num_nodes(const DfScorer* s) { return (int32_t)s->model->hdr.n; }
int32_t df_scorer_embed_dim(const DfScorer* s) { return (int32_t)s->model->hdr.d; }
int32_t df_scorer_feature_dim(const DfScorer* s) { return (int32_t)s->model->hdr.fp; }

// The full three-stage per-row pipeline over R pre-validated rows: child/
// parent are PER-ROW node indices, feats row for row b is feats[row_map[b]]
// (row_map == nullptr ⇒ identity). Both public entries funnel here, so the
// multi-round batch path and the round driver are bit-identical by
// construction — per-row math never depends on the batch shape.
static void score_rows(DfScorer* s, const int32_t* child, const int32_t* parent,
                       const float* feats, const int32_t* row_map, int32_t R,
                       float* out) {
  const DfModel* m = s->model;
  const Header& h = m->hdr;
  const int D = (int)h.d, FP = (int)h.fp, H1 = (int)h.h1, H2 = (int)h.h2;
  const int in1 = D + FP;  // contraction after the uc/up precompute
  // Row-TILE the whole three-stage pipeline (128 rows ≈ 72 KB X + 128 KB Y1
  // scratch): running each stage over the full R first meant ~550 KB of
  // scratch churn per call — two dispatcher workers' concurrent calls then
  // fought over the shared cache (measured 1.33x scaling where ALU-bound
  // work scales 1.93x on this host). Tiled, each worker's hot set stays
  // private-cache-sized; the extra W1t re-streams per tile are L2 reads.
  constexpr int32_t kRowTile = 128;
  std::lock_guard<std::mutex> lock(s->mu);
  const int32_t tile = std::min<int32_t>(R, kRowTile);
  s->sx.resize((size_t)tile * in1);
  s->sy1.resize((size_t)tile * H1);
  s->sy2.resize((size_t)tile * H2);
  // W1 tail = rows [2D, 3D+FP) — the z_c∘z_p and pair-feature blocks, which
  // are contiguous in the artifact's row-major kernel
  const float* W1t = m->w1.data() + (size_t)2 * D * h.h1;

  int nblk = 1;
#ifdef _OPENMP
  nblk = std::min<int>(omp_get_max_threads(), std::max<int32_t>(1, R / kRowTile));
  if (nblk > 1) {
    // per-OMP-thread scratch tiles, disjoint slices of the handle's buffers
    s->sx.resize((size_t)nblk * tile * in1);
    s->sy1.resize((size_t)nblk * tile * H1);
    s->sy2.resize((size_t)nblk * tile * H2);
  }
#endif
  const int32_t chunk = (R + nblk - 1) / nblk;
#ifdef _OPENMP
#pragma omp parallel for schedule(static) num_threads(nblk) if (nblk > 1)
#endif
  for (int blk = 0; blk < nblk; ++blk) {
    const int32_t c0 = blk * chunk;
    const int32_t cn = std::min<int32_t>(R - c0, chunk);
    if (cn <= 0) continue;
    float* X = s->sx.data() + (size_t)blk * tile * in1;
    float* Y1 = s->sy1.data() + (size_t)blk * tile * H1;
    float* Y2 = s->sy2.data() + (size_t)blk * tile * H2;
    for (int32_t t0 = c0; t0 < c0 + cn; t0 += tile) {
      const int32_t b0 = t0;
      const int32_t bn = std::min<int32_t>(c0 + cn - t0, tile);
      // stage 1: build the reduced input rows + preload Y1 with
      // b1 + uc[child] + up[parent] — scratch rows are tile-local
      for (int32_t b = b0; b < b0 + bn; ++b) {
        float* xb = X + (size_t)(b - b0) * in1;
        const float* zc = m->z.data() + (size_t)child[b] * D;
        const float* zp = m->z.data() + (size_t)parent[b] * D;
        for (int i = 0; i < D; ++i) xb[i] = zc[i] * zp[i];
        const size_t frow = row_map ? (size_t)row_map[b] : (size_t)b;
        std::memcpy(xb + D, feats + frow * FP, FP * sizeof(float));
        float* yb = Y1 + (size_t)(b - b0) * H1;
        const float* ucr = m->uc.data() + (size_t)child[b] * H1;
        const float* upr = m->up.data() + (size_t)parent[b] * H1;
        for (int i = 0; i < H1; ++i) yb[i] = m->b1[i] + ucr[i] + upr[i];
      }
      gemm_acc(X, W1t, Y1, bn, in1, H1);
      for (size_t i = 0; i < (size_t)bn * H1; ++i) Y1[i] = gelu(Y1[i]);
      for (int32_t b = 0; b < bn; ++b)
        std::memcpy(Y2 + (size_t)b * H2, m->b2.data(), H2 * sizeof(float));
      gemm_acc(Y1, m->w2.data(), Y2, bn, H1, H2);
      for (size_t i = 0; i < (size_t)bn * H2; ++i) Y2[i] = gelu(Y2[i]);
      for (int32_t b = 0; b < bn; ++b) {
        const float* yb = Y2 + (size_t)b * H2;
        float o = m->b3[0];
        for (int i = 0; i < H2; ++i) o += yb[i] * m->w3[i];
        out[b0 + b] = sigmoidf(o);
      }
    }
  }
}

// Score `rounds` independent scheduling rounds of `batch` (child, parent)
// pairs each in ONE call: child/parent are [rounds*batch] i32, feats is
// [rounds*batch, FP] row-major, out is [rounds*batch] f32. The multi-round
// entry amortizes FFI + dispatch overhead across rounds (north-star config 5's
// 10k-calls/s path). Returns 0 on success, -1 on an out-of-range node index.
int32_t df_scorer_score_rounds(DfScorer* s, const int32_t* child,
                               const int32_t* parent, const float* feats,
                               int32_t rounds, int32_t batch, float* out) {
  const Header& h = s->model->hdr;
  const int64_t total64 = (int64_t)rounds * batch;
  if (total64 <= 0 || total64 > (int64_t)1 << 24) return total64 == 0 ? 0 : -2;
  const int32_t R = (int32_t)total64;
  for (int32_t b = 0; b < R; ++b) {
    const int32_t c = child[b], p = parent[b];
    if (c < 0 || p < 0 || (uint32_t)c >= h.n || (uint32_t)p >= h.n) return -1;
  }
  score_rows(s, child, parent, feats, nullptr, R, out);
  return 0;
}

// Single-round entry (kept for API compatibility; one round of `batch` pairs).
int32_t df_scorer_score(DfScorer* s, const int32_t* child,
                        const int32_t* parent, const float* feats,
                        int32_t batch, float* out) {
  return df_scorer_score_rounds(s, child, parent, feats, 1, batch, out);
}

// ── The native round driver ────────────────────────────────────────────────
//
// One FFI call drives a BATCH of whole scheduling rounds: re-validate →
// fill round-constant feature columns → score → stable top-k, all with the
// GIL released. Arena contract (all buffers owned and reused by the caller):
//
//   offsets    [M+1] i32 — survivor rows of round r are [offsets[r], offsets[r+1])
//   child_idx  [M]   i32 — embedding-table index of the round's child (-1 unknown)
//   parent_idx [T]   i32 — per survivor row (-1 unknown), T = offsets[M]
//   feats      [T,FP]f32 — validated pair rows; round-constant columns
//                          (10 = finished-piece ratio, 11 = log-scaled
//                          content length, 13 = scaled schedule rounds) are
//                          broadcast HERE from round_cols
//   round_cols [M,3] f32 — the three round-constant values, computed in
//                          Python with the same float32 ops as
//                          _fill_round_columns
//   filt       [T,4] i32 — (flags, state_code, free_upload_slots, depth)
//                          snapshotted under the scheduler state lock
//
// Outputs: out_scores [T] f32 (NaN for rows the driver did not score),
// sel [M,k] i32 local survivor indices (-1 pad), n_sel [M] i32, and
// status [M] i32: 0 = natively scored, 1 = round must re-run on the Python
// serial leg (unknown node index, stale embedding table, or a filter field
// that disagrees with the snapshot predicate) — the caller routes those
// through the bit-identical evaluate_many path, preserving serial semantics
// for every fallback taxonomy case.
//
// Returns 0 on success; -2 row-cap overflow, -3 feature schema too narrow
// for the round-constant columns, -4 malformed offsets.
int32_t df_round_drive(DfScorer* s, const int32_t* offsets,
                       const int32_t* child_idx, const int32_t* parent_idx,
                       float* feats, const float* round_cols,
                       const int32_t* filt, int32_t rounds, int32_t k,
                       int32_t max_depth, float* out_scores, int32_t* sel,
                       int32_t* n_sel, int32_t* status) {
  const Header& h = s->model->hdr;
  if (rounds <= 0) return 0;
  const int FP = (int)h.fp;
  if (FP <= 13) return -3;
  const int64_t total64 = (int64_t)offsets[rounds];
  if (total64 < 0 || total64 > (int64_t)1 << 24) return -2;
  const int32_t T = (int32_t)total64;

  // Pass 1 (per round): native-or-fallback decision, round-column broadcast,
  // and compaction of the scorable rows (fallback rounds' rows are skipped).
  std::vector<int32_t> crow, prow, rmap;
  crow.reserve(T);
  prow.reserve(T);
  rmap.reserve(T);
  for (int32_t r = 0; r < rounds; ++r) {
    const int32_t t0 = offsets[r], t1 = offsets[r + 1];
    n_sel[r] = 0;
    for (int32_t j = 0; j < k; ++j) sel[(size_t)r * k + j] = -1;
    if (t1 < t0 || t0 < 0) return -4;
    if (t1 == t0) {  // no survivors: an empty round, natively resolved
      status[r] = 0;
      continue;
    }
    const int32_t c = child_idx[r];
    bool native = c >= 0 && (uint32_t)c < h.n;
    for (int32_t t = t0; native && t < t1; ++t) {
      const int32_t p = parent_idx[t];
      const int32_t* f = filt + (size_t)t * 4;
      if (p < 0 || (uint32_t)p >= h.n ||
          f[0] != 0 || f[1] < 0 || f[2] <= 0 || f[3] >= max_depth) {
        native = false;
      }
    }
    if (!native) {
      status[r] = 1;
      continue;
    }
    status[r] = 0;
    const float* rc = round_cols + (size_t)r * 3;
    for (int32_t t = t0; t < t1; ++t) {
      float* fr = feats + (size_t)t * FP;
      fr[10] = rc[0];
      fr[11] = rc[1];
      fr[13] = rc[2];
      crow.push_back(c);
      prow.push_back(parent_idx[t]);
      rmap.push_back(t);
    }
  }

  // Pass 2: one shared-pipeline scoring sweep over the compacted rows.
  const int32_t RC = (int32_t)rmap.size();
  std::vector<float> cs((size_t)RC);
  if (RC > 0) score_rows(s, crow.data(), prow.data(), feats, rmap.data(), RC, cs.data());
  for (int32_t t = 0; t < T; ++t) out_scores[t] = std::nanf("");
  for (int32_t i = 0; i < RC; ++i) out_scores[rmap[i]] = cs[i];

  // Pass 3: stable top-k per native round. Matches
  // np.argsort(-scores, kind="stable")[:k] exactly: descending score, ties
  // broken by survivor index, NaN ranked last (numpy sorts NaN to the end).
  std::vector<int32_t> order;
  for (int32_t r = 0; r < rounds; ++r) {
    if (status[r] != 0 || k <= 0) continue;
    const int32_t t0 = offsets[r];
    const int32_t nr = offsets[r + 1] - t0;
    if (nr <= 0) continue;
    order.resize(nr);
    for (int32_t j = 0; j < nr; ++j) order[j] = j;
    const float* sc = out_scores + t0;
    std::stable_sort(order.begin(), order.end(), [sc](int32_t a, int32_t b) {
      const float xa = sc[a], xb = sc[b];
      const bool na = std::isnan(xa), nb = std::isnan(xb);
      if (na || nb) return nb && !na;  // non-NaN sorts before NaN
      return xa > xb;
    });
    const int32_t kk = std::min<int32_t>(k, nr);
    for (int32_t j = 0; j < kk; ++j) sel[(size_t)r * k + j] = order[j];
    n_sel[r] = kk;
  }
  return 0;
}

// ── Native mirrored peer table ─────────────────────────────────────────────
//
// A C-side mirror of the scheduler's per-task candidate state, so
// df_mirror_drive can sample, filter, and score rounds without Python ever
// walking the peer pool. Python pushes incremental deltas at exactly the
// mutation sites that already bump a version counter (peer/host feat bumps,
// FSM transitions, DAG edge commits, topology/bandwidth bumps, peer
// lifecycle); the drive consumes the mirror under one mutex acquisition per
// batch and the deltas are tiny synchronous calls, so mutators overlap
// driving except for the sample/filter/gather window itself.
//
// Entities are SLOT-indexed (Python's MirrorClient owns slot allocation and
// keeps the slot→object maps); versions are the same counters Python's
// feature caches key on, so a mirrored pair row is fresh exactly when
// Python's own `_pair_rows` hit would be. A stale or missing row does NOT
// force a full re-export: the round reports status 2 (stale) with its
// survivors, Python scores it on the bit-identical serial leg and pushes the
// freshly cached rows back — steady state is pure native rounds with zero
// full re-exports (counter-asserted by tools/check.sh's mirror-smoke).
//
// RNG: the candidate draw is a bit-exact reproduction of CPython's
// random.sample over the mirrored (insertion-ordered) peer list — MT19937
// genrand_uint32 + getrandbits(k)/_randbelow rejection + the dual
// pool-shuffle/selection-set strategy with the same setsize switch — with
// the Mersenne state marshalled in/out per drive, so Python's
// Scheduling._rng remains THE owner and serial/native draws interleave on
// one stream (decision records and `dfml explain` replay stay bit-identical
// to the serial evaluator).

struct MirrorRow {
  int64_t key[5];  // (peer_feat, host_feat, child_host_feat, topo_pair, bw_parent)
  std::vector<float> row;  // [fp], round-constant columns left zero
};

struct MirrorPeer {
  int32_t alive = 0;
  int32_t task_slot = -1;
  int32_t host_slot = -1;
  int32_t state_code = -1;
  int32_t bad = 0;
  int64_t feat_version = -1;
  std::vector<int32_t> parents;   // DAG parent slots, Python set-iteration order
  std::vector<int32_t> children;  // DAG child slots (membership only)
  std::unordered_map<int32_t, MirrorRow> rows;  // child_host_slot → cached pair row
};

struct MirrorHost {
  int32_t alive = 0;
  int32_t free_slots = 0;
  int32_t node_idx = -1;  // embedding-table row for the CURRENT bundle
  int64_t feat_version = -1;
  // bandwidth parent version; INT64_MIN = never pushed → adopted from the
  // first row push (lazily consistent: any later bump overwrites it)
  int64_t bw_version = INT64_MIN;
};

struct MirrorTask {
  int32_t alive = 0;
  std::vector<int32_t> vlist;  // peer slots, DAG insertion order (= dag._vlist)
};

// Mirrors resource._PAIR_ROW_CACHE_MAX: past this many distinct child hosts
// a peer's row map is cleared whole, exactly like Python's `_pair_rows`.
constexpr size_t kMirrorRowCacheMax = 4096;

struct DfMirror {
  int32_t fp;
  std::mutex mu;
  std::vector<MirrorPeer> peers;
  std::vector<MirrorHost> hosts;
  std::vector<MirrorTask> tasks;
  // topology pair version keyed by canonical (min,max) host-slot pair;
  // absent = never pushed → adopted from the first row push (see bw_version)
  std::unordered_map<uint64_t, int64_t> topo;
  // epoch-stamped scratch (no per-round set allocations): excl = blocked ∪
  // lineage ∪ child for the active round, tmp = sample rejection set, then
  // per-candidate depth-walk seen sets (epoch bumped per use)
  std::vector<uint32_t> excl_mark, tmp_mark;
  uint32_t excl_epoch = 0, tmp_epoch = 0;
  std::vector<int32_t> pool_scratch;  // random.sample's pool-copy strategy
  // counters (df_mirror_stats layout)
  int64_t deltas = 0, rows_pushed = 0, native_rounds = 0, stale_rounds = 0,
          fallback_rounds = 0, empty_rounds = 0, full_syncs = 0, drives = 0,
          rows_cached = 0;
};

static inline uint64_t topo_key(int32_t a, int32_t b) {
  const uint32_t lo = (uint32_t)std::min(a, b), hi = (uint32_t)std::max(a, b);
  return ((uint64_t)lo << 32) | hi;
}

static inline MirrorPeer& peer_slot_at(std::vector<MirrorPeer>& v, int32_t slot) {
  if ((size_t)slot >= v.size()) v.resize((size_t)slot + 1);
  return v[(size_t)slot];
}
static inline MirrorHost& host_slot_at(std::vector<MirrorHost>& v, int32_t slot) {
  if ((size_t)slot >= v.size()) v.resize((size_t)slot + 1);
  return v[(size_t)slot];
}
static inline MirrorTask& task_slot_at(std::vector<MirrorTask>& v, int32_t slot) {
  if ((size_t)slot >= v.size()) v.resize((size_t)slot + 1);
  return v[(size_t)slot];
}

static inline bool valid_slot(size_t n, int32_t slot) {
  return slot >= 0 && (size_t)slot < n;
}

static void mirror_marks_ensure(DfMirror* m) {
  const size_t n = m->peers.size();
  if (m->excl_mark.size() < n) {
    m->excl_mark.resize(n, 0);
    m->tmp_mark.resize(n, 0);
  }
}

// ---- CPython MT19937 (_randommodule.c genrand_uint32), state-injected ----

struct MtState {
  uint32_t mt[624];
  int32_t mti;
};

static inline uint32_t mt_genrand(MtState* s) {
  if (s->mti >= 624) {
    uint32_t* mt = s->mt;
    for (int kk = 0; kk < 624; ++kk) {
      const uint32_t y = (mt[kk] & 0x80000000u) | (mt[(kk + 1) % 624] & 0x7fffffffu);
      mt[kk] = mt[(kk + 397) % 624] ^ (y >> 1) ^ ((y & 1u) ? 0x9908b0dfu : 0u);
    }
    s->mti = 0;
  }
  uint32_t y = s->mt[s->mti++];
  y ^= y >> 11;
  y ^= (y << 7) & 0x9d2c5680u;
  y ^= (y << 15) & 0xefc60000u;
  y ^= y >> 18;
  return y;
}

// random.getrandbits(k) for 0 < k <= 32: one word, top k bits
static inline uint32_t mt_getrandbits(MtState* s, int k) {
  return mt_genrand(s) >> (32 - k);
}

// random._randbelow_with_getrandbits(n), n > 0
static inline uint32_t mt_randbelow(MtState* s, uint32_t n) {
  int k = 32 - __builtin_clz(n);  // n.bit_length()
  uint32_t r = mt_getrandbits(s, k);
  while (r >= n) r = mt_getrandbits(s, k);
  return r;
}

// random.Random.sample(population, k) over `pop[0:n]`, k < n (the k >= n
// case never reaches here: DAG.random_vertices returns the whole list
// WITHOUT consuming the rng). Result preserves CPython's draw order — it
// determines stable-argsort tie-breaks downstream.
static void mt_sample(MtState* s, DfMirror* m, const int32_t* pop, int32_t n,
                      int32_t k, std::vector<int32_t>& out) {
  out.clear();
  int setsize = 21;
  if (k > 5)
    setsize += (int)std::pow(4.0, std::ceil(std::log((double)k * 3) / std::log(4.0)));
  if (n <= setsize) {
    // pool-copy partial shuffle
    std::vector<int32_t>& pool = m->pool_scratch;
    pool.assign(pop, pop + n);
    for (int32_t i = 0; i < k; ++i) {
      const uint32_t j = mt_randbelow(s, (uint32_t)(n - i));
      out.push_back(pool[j]);
      pool[j] = pool[n - i - 1];
    }
  } else {
    // selection-set rejection (epoch-stamped marks instead of a Python set;
    // stamps are keyed by POSITION in the population, not peer slot, so the
    // scratch only needs n entries)
    std::vector<uint32_t>& mark = m->tmp_mark;
    if (mark.size() < (size_t)n) mark.resize((size_t)n, 0);
    const uint32_t epoch = ++m->tmp_epoch;
    for (int32_t i = 0; i < k; ++i) {
      uint32_t j = mt_randbelow(s, (uint32_t)n);
      while (mark[j] == epoch) j = mt_randbelow(s, (uint32_t)n);
      mark[j] = epoch;
      out.push_back(pop[j]);
    }
  }
}

// resource.Peer.depth() without the TTL memo: first-parent chain walk with a
// seen set, capped at 10 hops. The mirror computes depth FRESH each drive;
// the serial leg's ≤1 s-stale memo is the one documented tolerance
// (equivalence tests pin the memo TTL to 0).
static int32_t mirror_depth(DfMirror* m, int32_t slot) {
  std::vector<uint32_t>& mark = m->tmp_mark;
  const uint32_t epoch = ++m->tmp_epoch;
  int32_t depth = 1, cur = slot;
  mark[cur] = epoch;
  for (;;) {
    const std::vector<int32_t>& ps = m->peers[(size_t)cur].parents;
    if (ps.empty()) break;
    const int32_t nxt = ps[0];
    if (mark[nxt] == epoch || depth > 10) break;
    depth += 1;
    cur = nxt;
    mark[cur] = epoch;
  }
  return depth;
}

// dag.lineage(child): ancestors ∪ descendants, stamped into excl_mark under
// the CURRENT excl epoch (on top of the round's blocked slots + child).
static void mirror_stamp_lineage(DfMirror* m, int32_t child_slot) {
  std::vector<uint32_t>& mark = m->excl_mark;
  const uint32_t epoch = m->excl_epoch;
  std::vector<int32_t> stack;
  stack.push_back(child_slot);
  while (!stack.empty()) {  // ancestors
    const int32_t cur = stack.back();
    stack.pop_back();
    for (int32_t p : m->peers[(size_t)cur].parents) {
      if (mark[p] != epoch) {
        mark[p] = epoch;
        stack.push_back(p);
      }
    }
  }
  stack.push_back(child_slot);
  while (!stack.empty()) {  // descendants
    const int32_t cur = stack.back();
    stack.pop_back();
    for (int32_t c : m->peers[(size_t)cur].children) {
      if (mark[c] != epoch) {
        mark[c] = epoch;
        stack.push_back(c);
      }
    }
  }
}

static void vec_remove(std::vector<int32_t>& v, int32_t x) {
  for (size_t i = 0; i < v.size(); ++i) {
    if (v[i] == x) {
      v.erase(v.begin() + i);
      return;
    }
  }
}

DfMirror* df_mirror_new(int32_t fp) {
  if (fp <= 13) return nullptr;  // round-constant columns must exist
  DfMirror* m = new DfMirror();
  m->fp = fp;
  return m;
}

void df_mirror_free(DfMirror* m) { delete m; }

int32_t df_mirror_host_upsert(DfMirror* m, int32_t slot, int64_t feat_version,
                              int32_t free_slots, int32_t node_idx) {
  if (slot < 0) return -1;
  std::lock_guard<std::mutex> lock(m->mu);
  MirrorHost& h = host_slot_at(m->hosts, slot);
  h.alive = 1;
  h.feat_version = feat_version;
  h.free_slots = free_slots;
  h.node_idx = node_idx;
  m->deltas++;
  return 0;
}

int32_t df_mirror_host_remove(DfMirror* m, int32_t slot) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->hosts.size(), slot)) return -1;
  m->hosts[(size_t)slot] = MirrorHost{};
  m->deltas++;
  return 0;
}

int32_t df_mirror_task_upsert(DfMirror* m, int32_t slot) {
  if (slot < 0) return -1;
  std::lock_guard<std::mutex> lock(m->mu);
  task_slot_at(m->tasks, slot).alive = 1;
  m->deltas++;
  return 0;
}

int32_t df_mirror_task_remove(DfMirror* m, int32_t slot) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->tasks.size(), slot)) return -1;
  m->tasks[(size_t)slot] = MirrorTask{};
  m->deltas++;
  return 0;
}

int32_t df_mirror_peer_add(DfMirror* m, int32_t slot, int32_t task_slot,
                           int32_t host_slot, int32_t state_code, int32_t bad,
                           int64_t feat_version) {
  if (slot < 0 || task_slot < 0 || host_slot < 0) return -1;
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->tasks.size(), task_slot) || !m->tasks[(size_t)task_slot].alive)
    return -2;
  MirrorPeer& p = peer_slot_at(m->peers, slot);
  if (p.alive) return -3;  // client never reuses a live slot
  p.alive = 1;
  p.task_slot = task_slot;
  p.host_slot = host_slot;
  p.state_code = state_code;
  p.bad = bad;
  p.feat_version = feat_version;
  p.parents.clear();
  p.children.clear();
  m->tasks[(size_t)task_slot].vlist.push_back(slot);
  mirror_marks_ensure(m);
  m->deltas++;
  return 0;
}

int32_t df_mirror_peer_remove(DfMirror* m, int32_t slot) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->peers.size(), slot) || !m->peers[(size_t)slot].alive) return -1;
  MirrorPeer& p = m->peers[(size_t)slot];
  // detach from adjacency: children lose a parent IN PLACE (matches Python's
  // set.discard preserving remaining relative order), parents lose a child
  for (int32_t c : p.children) vec_remove(m->peers[(size_t)c].parents, slot);
  for (int32_t pa : p.parents) vec_remove(m->peers[(size_t)pa].children, slot);
  if (valid_slot(m->tasks.size(), p.task_slot))
    vec_remove(m->tasks[(size_t)p.task_slot].vlist, slot);
  m->rows_cached -= (int64_t)p.rows.size();
  p = MirrorPeer{};
  m->deltas++;
  return 0;
}

int32_t df_mirror_peer_feat(DfMirror* m, int32_t slot, int64_t feat_version,
                            int32_t bad) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->peers.size(), slot) || !m->peers[(size_t)slot].alive) return -1;
  m->peers[(size_t)slot].feat_version = feat_version;
  m->peers[(size_t)slot].bad = bad;
  m->deltas++;
  return 0;
}

int32_t df_mirror_peer_state(DfMirror* m, int32_t slot, int32_t state_code) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->peers.size(), slot) || !m->peers[(size_t)slot].alive) return -1;
  m->peers[(size_t)slot].state_code = state_code;
  m->deltas++;
  return 0;
}

// Replace `child`'s FULL parent list (Python pushes list(vertex.parents) in
// current set-iteration order after every edge mutation — the order the
// depth walk's parents[0] depends on cannot be derived from deltas alone).
int32_t df_mirror_set_parents(DfMirror* m, int32_t child_slot,
                              const int32_t* parents, int32_t n) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->peers.size(), child_slot) || !m->peers[(size_t)child_slot].alive)
    return -1;
  MirrorPeer& c = m->peers[(size_t)child_slot];
  for (int32_t old : c.parents) vec_remove(m->peers[(size_t)old].children, child_slot);
  c.parents.clear();
  for (int32_t i = 0; i < n; ++i) {
    const int32_t pa = parents[i];
    if (!valid_slot(m->peers.size(), pa) || !m->peers[(size_t)pa].alive) continue;
    c.parents.push_back(pa);
    m->peers[(size_t)pa].children.push_back(child_slot);
  }
  m->deltas++;
  return 0;
}

int32_t df_mirror_topo_bump(DfMirror* m, int32_t a_slot, int32_t b_slot,
                            int64_t version) {
  if (a_slot < 0 || b_slot < 0) return -1;
  std::lock_guard<std::mutex> lock(m->mu);
  m->topo[topo_key(a_slot, b_slot)] = version;
  m->deltas++;
  return 0;
}

int32_t df_mirror_bw_bump(DfMirror* m, int32_t host_slot, int64_t version) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->hosts.size(), host_slot)) return -1;
  m->hosts[(size_t)host_slot].bw_version = version;
  m->deltas++;
  return 0;
}

// Bulk node-index refresh for a model hot-swap: the client re-pushes every
// mirrored host's embedding row for the NEW bundle before the next drive, so
// a drive can never mix node indices across bundles (zero torn rounds).
int32_t df_mirror_set_node_indices(DfMirror* m, const int32_t* slots,
                                   const int32_t* idx, int32_t n) {
  std::lock_guard<std::mutex> lock(m->mu);
  for (int32_t i = 0; i < n; ++i) {
    if (!valid_slot(m->hosts.size(), slots[i])) return -1;
    m->hosts[(size_t)slots[i]].node_idx = idx[i];
  }
  m->deltas++;
  return 0;
}

// Push freshly revalidated pair rows after a stale round's serial re-score:
// keys are the SAME 5-tuple Python's `_export_pair_rows` caches under, rows
// have the round-constant columns zero. Rows enter the mirror ONLY through
// this leg — the mirror never recomputes features itself.
int32_t df_mirror_push_rows(DfMirror* m, int32_t child_host_slot, int32_t n,
                            const int32_t* peer_slots, const int64_t* keys,
                            const float* rows) {
  std::lock_guard<std::mutex> lock(m->mu);
  if (!valid_slot(m->hosts.size(), child_host_slot)) return -1;
  for (int32_t i = 0; i < n; ++i) {
    const int32_t ps = peer_slots[i];
    if (!valid_slot(m->peers.size(), ps) || !m->peers[(size_t)ps].alive) continue;
    MirrorPeer& p = m->peers[(size_t)ps];
    if (p.rows.size() >= kMirrorRowCacheMax && !p.rows.count(child_host_slot)) {
      m->rows_cached -= (int64_t)p.rows.size();
      p.rows.clear();  // clear-whole, mirroring _PAIR_ROW_CACHE_MAX
    }
    auto ins = p.rows.try_emplace(child_host_slot);
    MirrorRow& row = ins.first->second;
    if (ins.second) m->rows_cached++;
    std::memcpy(row.key, keys + (size_t)i * 5, 5 * sizeof(int64_t));
    row.row.assign(rows + (size_t)i * m->fp, rows + (size_t)(i + 1) * m->fp);
    // adopt topology/bandwidth versions the mirror has never seen a bump
    // for (pre-attach probe history, federation merges before host
    // registration): any later bump overwrites, so this is lazily exact
    m->topo.try_emplace(topo_key(ps >= 0 ? p.host_slot : 0, child_host_slot),
                        row.key[3]);
    MirrorHost& h = m->hosts[(size_t)p.host_slot];
    if (h.bw_version == INT64_MIN) h.bw_version = row.key[4];
    m->rows_pushed++;
  }
  return 0;
}

void df_mirror_note_sync(DfMirror* m) {
  std::lock_guard<std::mutex> lock(m->mu);
  m->full_syncs++;
}

void df_mirror_stats(DfMirror* m, int64_t* out) {
  std::lock_guard<std::mutex> lock(m->mu);
  int64_t peers = 0, hosts = 0, tasks = 0;
  for (const MirrorPeer& p : m->peers) peers += p.alive;
  for (const MirrorHost& h : m->hosts) hosts += h.alive;
  for (const MirrorTask& t : m->tasks) tasks += t.alive;
  out[0] = m->deltas;
  out[1] = m->rows_pushed;
  out[2] = m->native_rounds;
  out[3] = m->stale_rounds;
  out[4] = m->fallback_rounds;
  out[5] = m->empty_rounds;
  out[6] = m->full_syncs;
  out[7] = m->drives;
  out[8] = peers;
  out[9] = hosts;
  out[10] = tasks;
  out[11] = m->rows_cached;
}

// Drive a batch of whole scheduling rounds off the mirror: per round, draw
// the candidate sample (bit-exact rng.sample over the mirrored peer list),
// run the 8-condition filter natively, gather version-checked cached pair
// rows into the caller's arena, then score + stable top-k through the exact
// df_round_drive pipeline. Python's jobs shrink to the round descriptors
// (O(1) per round: slots, blocked list, round-constant scalars) and the
// commit.
//
// Inputs per round r: task_slot/child_slot/child_host[r], blocked slots
// [blocked_off[r], blocked_off[r+1]) — blocklist ∪ child.block_parents
// mapped to slots — and round_cols[r*3] (the _round_col_values scalars).
// rng_state: [625] u32 in/out — CPython getstate()[1] verbatim (624 words +
// index). Outputs: offsets [M+1], cand_slots [row_cap] survivor peer slots
// in draw order, feats [row_cap, fp] gathered rows (round-constant columns
// broadcast), out_scores [row_cap] (NaN unscored), sel [M,k] (-1 pad),
// n_sel [M], status [M]: 0 = natively resolved, 1 = fallback (node index
// unknown/out of range — Python re-scores the survivors on the serial leg),
// 2 = stale (a cached row missed or failed its version check — serial
// re-score + df_mirror_push_rows revalidation), 3 = mirror miss (task or
// child not mirrored; the round consumed NO rng draws).
//
// Returns 0, or a negative arg error BEFORE any rng consumption:
// -2 row-cap overflow possible (row_cap < rounds * sample_n), -3 feature
// dim mismatch with the scorer, -5 bad args.
int32_t df_mirror_drive(DfScorer* s, DfMirror* m, int32_t rounds,
                        const int32_t* task_slot, const int32_t* child_slot,
                        const int32_t* child_host, const int32_t* blocked_off,
                        const int32_t* blocked, const float* round_cols,
                        int32_t sample_n, int32_t k, int32_t max_depth,
                        uint32_t* rng_state, int32_t* offsets,
                        int32_t* cand_slots, float* feats, float* out_scores,
                        int32_t* sel, int32_t* n_sel, int32_t* status,
                        int32_t row_cap) {
  if (!s || !m || rounds < 0 || sample_n <= 0 || k < 0) return -5;
  const Header& h = s->model->hdr;
  const int FP = (int)h.fp;
  if (FP != m->fp) return -3;
  if ((int64_t)rounds * sample_n > (int64_t)row_cap ||
      (int64_t)row_cap > (int64_t)1 << 24)
    return -2;
  if (rounds == 0) return 0;

  MtState rng;
  std::memcpy(rng.mt, rng_state, 624 * sizeof(uint32_t));
  rng.mti = (int32_t)rng_state[624];

  std::vector<int32_t> sample, crow, prow, rmap;
  sample.reserve(sample_n);

  {
    std::lock_guard<std::mutex> lock(m->mu);
    m->drives++;
    mirror_marks_ensure(m);
    int32_t t = 0;
    offsets[0] = 0;
    for (int32_t r = 0; r < rounds; ++r) {
      n_sel[r] = 0;
      for (int32_t j = 0; j < k; ++j) sel[(size_t)r * k + j] = -1;
      const int32_t ts = task_slot[r], cs = child_slot[r], ch = child_host[r];
      if (!valid_slot(m->tasks.size(), ts) || !m->tasks[(size_t)ts].alive ||
          !valid_slot(m->peers.size(), cs) || !m->peers[(size_t)cs].alive ||
          !valid_slot(m->hosts.size(), ch) || !m->hosts[(size_t)ch].alive) {
        status[r] = 3;  // mirror miss: no rng consumed, Python runs serial
        m->fallback_rounds++;
        offsets[r + 1] = t;
        continue;
      }
      const std::vector<int32_t>& vlist = m->tasks[(size_t)ts].vlist;
      const int32_t n = (int32_t)vlist.size();
      // DAG.random_vertices: whole-list copy consumes NO rng when the
      // sample covers the population
      if (sample_n >= n) {
        sample.assign(vlist.begin(), vlist.end());
      } else {
        mt_sample(&rng, m, vlist.data(), n, sample_n, sample);
      }
      // exclusion stamps: child ∪ blocked ∪ lineage under one epoch
      const uint32_t epoch = ++m->excl_epoch;
      std::vector<uint32_t>& excl = m->excl_mark;
      excl[cs] = epoch;
      for (int32_t b = blocked_off[r]; b < blocked_off[r + 1]; ++b) {
        const int32_t bs = blocked[b];
        if (valid_slot(m->peers.size(), bs)) excl[bs] = epoch;
      }
      mirror_stamp_lineage(m, cs);
      // the 8 filter conditions over the sample, survivors in draw order
      const int32_t t0 = t;
      int32_t round_status = 0;
      const int64_t child_feat = m->hosts[(size_t)ch].feat_version;
      const int32_t cidx = m->hosts[(size_t)ch].node_idx;
      if (cidx < 0 || (uint32_t)cidx >= h.n) round_status = 1;
      for (int32_t i = 0; i < (int32_t)sample.size(); ++i) {
        const int32_t ps = sample[i];
        if (excl[ps] == epoch) continue;
        const MirrorPeer& p = m->peers[(size_t)ps];
        if (p.host_slot == ch) continue;
        if (p.state_code < 0) continue;
        const MirrorHost& ph = m->hosts[(size_t)p.host_slot];
        if (ph.free_slots <= 0) continue;
        if (mirror_depth(m, ps) >= max_depth) continue;
        if (p.bad) continue;
        // survivor: gather its cached pair row if this round still scores
        cand_slots[t] = ps;
        if (round_status == 0) {
          const int32_t pidx = ph.node_idx;
          if (pidx < 0 || (uint32_t)pidx >= h.n) {
            round_status = 1;
          } else {
            auto it = p.rows.find(ch);
            if (it == p.rows.end()) {
              round_status = 2;
            } else {
              const MirrorRow& row = it->second;
              int64_t topo_cur = row.key[3];  // adopt when never bumped
              auto tit = m->topo.find(topo_key(p.host_slot, ch));
              if (tit != m->topo.end()) topo_cur = tit->second;
              const int64_t bw_cur =
                  ph.bw_version == INT64_MIN ? row.key[4] : ph.bw_version;
              if (row.key[0] != p.feat_version || row.key[1] != ph.feat_version ||
                  row.key[2] != child_feat || row.key[3] != topo_cur ||
                  row.key[4] != bw_cur) {
                round_status = 2;
              } else {
                float* fr = feats + (size_t)t * FP;
                std::memcpy(fr, row.row.data(), (size_t)FP * sizeof(float));
                const float* rc = round_cols + (size_t)r * 3;
                fr[10] = rc[0];
                fr[11] = rc[1];
                fr[13] = rc[2];
                crow.push_back(cidx);
                prow.push_back(pidx);
                rmap.push_back(t);
              }
            }
          }
        }
        ++t;
      }
      if (round_status != 0) {
        // drop any rows gathered before the round went stale/fallback
        while (!rmap.empty() && rmap.back() >= t0) {
          rmap.pop_back();
          crow.pop_back();
          prow.pop_back();
        }
        if (round_status == 1) m->fallback_rounds++;
        else m->stale_rounds++;
      } else if (t == t0) {
        m->empty_rounds++;
      } else {
        m->native_rounds++;
      }
      status[r] = round_status;
      offsets[r + 1] = t;
    }
  }  // mirror mutex released: scoring runs on the gathered copies

  const int32_t T = offsets[rounds];
  const int32_t RC = (int32_t)rmap.size();
  std::vector<float> cs_out((size_t)RC);
  if (RC > 0)
    score_rows(s, crow.data(), prow.data(), feats, rmap.data(), RC, cs_out.data());
  for (int32_t t = 0; t < T; ++t) out_scores[t] = std::nanf("");
  for (int32_t i = 0; i < RC; ++i) out_scores[rmap[i]] = cs_out[i];

  // stable top-k per natively-scored round — identical to df_round_drive's
  std::vector<int32_t> order;
  for (int32_t r = 0; r < rounds; ++r) {
    if (status[r] != 0 || k <= 0) continue;
    const int32_t t0 = offsets[r];
    const int32_t nr = offsets[r + 1] - t0;
    if (nr <= 0) continue;
    order.resize(nr);
    for (int32_t j = 0; j < nr; ++j) order[j] = j;
    const float* sc = out_scores + t0;
    std::stable_sort(order.begin(), order.end(), [sc](int32_t a, int32_t b) {
      const float xa = sc[a], xb = sc[b];
      const bool na = std::isnan(xa), nb = std::isnan(xb);
      if (na || nb) return nb && !na;
      return xa > xb;
    });
    const int32_t kk = std::min<int32_t>(k, nr);
    for (int32_t j = 0; j < kk; ++j) sel[(size_t)r * k + j] = order[j];
    n_sel[r] = kk;
  }

  std::memcpy(rng_state, rng.mt, 624 * sizeof(uint32_t));
  rng_state[624] = (uint32_t)rng.mti;
  return 0;
}

}  // extern "C"
