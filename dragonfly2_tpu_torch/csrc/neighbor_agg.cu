// K1 and K2 on Hopper: fused neighbour gather + masked mean, and its backward.
//
// K1 replaces the TPU kernel dragonfly2_tpu/ops/neighbor_agg_pallas.py::_agg_kernel
// (launched through pl.pallas_call at :56). It computes
//
//     out[i] = sum_k mask[i,k] * h[nbr[i,k]] / (sum_k mask[i,k] + eps)
//
// for h[N, H] in f32 or bf16, nbr[N, K] int32 and mask[N, K] f32, accumulating
// in f32 and writing h's dtype. mask is a float weight, not a boolean, and the
// count runs over all K slots. A slot whose index lies outside [0, N)
// contributes nothing (the Pallas one-hot compare matches no column), and it is
// never read; neither is a slot whose mask is 0. A fully masked row gives 0.
//
// What bounds K1 on an H100: bytes. It must read h once (N*H*b), nbr and mask
// (N*K*8) and write out (N*H*b); its 2*N*K*H FLOPs are negligible. At N=16384,
// K=16, H=256 in bf16 that is about 18.9 MB, about 5.6 us at 3.35 TB/s. h is
// 8 MiB there and fits the 50 MB L2, so a row gathered by several neighbours
// need not come from device memory more than once; but every live slot still
// gathers its row from L2, about 100 MB at that shape, and the L2's rate for
// such a random gather (5-6.5 TB/s measured) is the wall K1 meets first.
//
// K1's design: the Pallas kernel builds a one-hot A[128, N] per row tile and
// runs A @ h on the MXU, a Mosaic workaround that costs 128*N*H FLOPs a tile.
// This kernel gathers directly instead. One warp owns one output row and one
// chunk of 32 vectors of H (blockIdx.y), a few rows a block. The lanes span
// the chunk with 16-byte vector loads where H*sizeof(T) is a multiple of 16 and
// the pointers are 16-byte aligned, and one element a lane otherwise. The warp
// reads its row's K indices and weights once, one slot a lane, marks the dead
// slots (mask 0 or index out of range), and walks the live ones, found by
// ballot, in slot order: it issues the gathered loads of kBatch of them
// before it accumulates them, and never reads a dead slot. More loads in
// flight need more registers, which cost occupancy; on the H100 a batch of 2
// with registers capped at 32 was the fastest variant, and batches of 4-16
// were slower (PERF.md §6): the L2's rate, not one load's latency, binds.

// K2 is K1's backward, the custom VJP _agg_bwd (neighbor_agg_pallas.py:80-90),
// which the JAX package computes with XLA's segment_sum:
//
//     gh[j] = sum_{(i,k): nbr[i,k] = j} mask[i,k] * g[i] / (sum_k mask[i,k] + eps)
//
// for g[N, H] in f32 or bf16, written in g's dtype. A slot whose index lies
// outside [0, n), or whose mask is 0, adds nothing (segment_sum drops
// out-of-range ids); a node that no slot names gets exactly 0. K2 accumulates
// in f32, where the JAX VJP accumulates in g's dtype.
//
// What bounds K2 on an H100: bytes. The least it must move is g (N*H*b), the
// transposed index (n+1 offsets and 8 bytes a live slot) and gh (n*H*b): at
// N=16384, K=16, H=512 in bf16 about 35 MB, about 10.4 us at 3.35 TB/s; its
// 2*E*H FLOPs do not matter. As in K1, each live slot gathers a g row from L2:
// about 200 MB at that shape.
//
// K2's design: a scatter over the slots needs atomics (blocks run in no order),
// and those set its pace: about 1e8 f32 atomicAdds at the shape above. So K2
// gathers instead, over a transposed (CSR) copy of the neighbour table that the
// wrapper builds once per forward (ops/neighbor_agg_cuda.py, transpose_index):
// indptr[n+1] and, for each live slot in (destination, slot) order, its source
// row and its weight mask[i,k] / (sum_k mask[i,k] + eps). One warp owns one
// destination row j and one chunk of H; the lanes span the chunk as in K1. The
// warp reads j's entries 32 at a time, one a lane, broadcasts them by shuffle,
// issues the loads of kBatch gathered g rows before it accumulates them in
// entry order in f32 registers, and writes gh[j] once in g's dtype. A node with no entries
// writes 0. There are no atomics, no workspace and no cast pass, and every gh
// element is summed in the same order on every launch: K2 is deterministic.

// K3 and K4 are the SAGE message path of models/graphsage.SAGELayer, fused,
// forward and backward (ops/sage_message.py). They replace no TPU kernel: the
// JAX package's SAGELayer leaves the path to XLA, which fuses it on the TPU,
// while the port's plain path runs it as a gather, a dozen elementwise passes
// and a reduction over [N, K, H] tensors in device memory. K3 computes
//
//     agg[n] = bf16(bf16(sum_k bf16(gelu(x[n,k]) * m[n,k])) / bf16(bf16(sum_k m[n,k]) + eps)),
//     x[n,k] = bf16(bf16(u[nbr[n,k]] + s[n]) + bf16(sum_d e[n,k,d] * We[:,d]))
//
// with u, s and We in bf16, e and the mask rounded to bf16 as the plain path
// casts them, and every op of the tanh-GELU (ops/gelu.py) rounded to bf16 where
// torch rounds it on the card: the same result as the plain path, but for the
// order of the f32 sums (over k, and the E products of the edge term). K4
// gives the gradients with respect to u, s and We, every op as the plain
// path's autograd rounds it: the mean's divide, the mask's product, the GELU's
// VJP op for op, g_s = sum over k, g_We = sum over slots of dx * e, g_u = the
// f32 sum of dx over the slots that name each row.
//
// What bounds them on an H100: instructions. K3 must read u, s and the graph
// and write agg, about 57 MB at N=16384, K=16, H=512 (17 us at 3.35 TB/s),
// and gather a u row from L2 for each live slot; but each element of
// [N, K, H] costs some 30 instructions (the rounded ops as packed bf16x2 ones,
// two channels an instruction; the precise tanhf, some 16, in f32), about
// 0.09 ms for 10^8 live elements at one instruction a lane a clock. K4
// recomputes the forward's elements and adds the VJP's, some 40 instructions
// an element. The design keeps the elements out of device
// memory: one warp owns one row and 256 channels (8 a lane, one 16-byte load),
// finds the row's live slots by ballot and walks them with two gathered u rows
// in flight, as K1 does, and computes the edge term from e[n,k,:E] and a
// shared-memory copy of We instead of reading a [N, K, H] product. K3 writes
// agg alone. K4's first pass walks the rows with a fixed set of blocks, writes
// g_s, keeps g_We's sums in registers (one f32 partial a block, summed in a
// second small pass in block order) and writes the per-edge gradient dx once
// in bf16; K2's gather then sums dx over a transposed index of the live slots
// into g_u, in f32, in entry order. dx's round trip (N*K*H*2 bytes each way,
// about 0.08 ms a way at the shape above) was chosen over computing dx twice,
// in row order for g_s and g_We and in destination order for g_u, which would
// pay the VJP's instructions again (about 0.33 ms); both are estimates, not
// measured side by side. No atomics: every launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One warp a row, four rows a block: small blocks free a multiprocessor's slots
// sooner than large ones, whose rows finish at different times.
constexpr int kWarpsPerBlock = 4;
// Blocks a multiprocessor must hold at once (__launch_bounds__'s second
// argument): 16 blocks of 4 warps cap a thread's registers at 32, so both loads
// of a batch are in flight at full occupancy (64 warps a multiprocessor).
constexpr int kMinBlocksPerSM = 16;
constexpr unsigned kFullMask = 0xffffffffu;
// Gathered rows a warp has in flight before it accumulates them, in K1 and K2.
constexpr int kBatch = 2;
static_assert(32 % kBatch == 0, "a batch must divide the warp");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// VEC elements of T as one load: 16 bytes for the vector paths, one element
// for the scalar path. load() reads them, fma() adds w times them to acc, and
// store() writes acc divided by `denom` in T.
template <typename T, int VEC>
struct Vec {
  T x[VEC];
  static __device__ __forceinline__ Vec load(const T* __restrict__ src) {
    Vec v;
#pragma unroll
    for (int j = 0; j < VEC; ++j) v.x[j] = src[j];
    return v;
  }
  __device__ __forceinline__ void fma(float w, float (&acc)[VEC]) const {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, to_float(x[j]), acc[j]);
  }
  static __device__ __forceinline__ void store(T* __restrict__ dst, const float (&acc)[VEC], float denom) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = from_float<T>(acc[j] / denom);
  }
};

template <>
struct Vec<float, 4> {
  float4 x;
  static __device__ __forceinline__ Vec load(const float* __restrict__ src) {
    return {__ldg(reinterpret_cast<const float4*>(src))};
  }
  __device__ __forceinline__ void fma(float w, float (&acc)[4]) const {
    acc[0] = fmaf(w, x.x, acc[0]);
    acc[1] = fmaf(w, x.y, acc[1]);
    acc[2] = fmaf(w, x.z, acc[2]);
    acc[3] = fmaf(w, x.w, acc[3]);
  }
  static __device__ __forceinline__ void store(float* __restrict__ dst, const float (&acc)[4], float denom) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0] / denom, acc[1] / denom, acc[2] / denom, acc[3] / denom);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  uint4 x;
  static __device__ __forceinline__ Vec load(const __nv_bfloat16* __restrict__ src) {
    return {__ldg(reinterpret_cast<const uint4*>(src))};
  }
  __device__ __forceinline__ void fma(float w, float (&acc)[8]) const {
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      acc[2 * j] = fmaf(w, f.x, acc[2 * j]);
      acc[2 * j + 1] = fmaf(w, f.y, acc[2 * j + 1]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ dst, const float (&acc)[8],
                                               float denom) {
    uint4 x;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(acc[2 * j] / denom, acc[2 * j + 1] / denom);
    *reinterpret_cast<uint4*>(dst) = x;
  }
};

// The warp's shared walk: `count` entries of which lane t holds the t-th's row
// index (negative: dead, never read) and weight. Every lane gathers its vector
// of each live row in batches of kBatch, all loads of a batch before any FMA,
// and accumulates in entry order. The walk visits only the live entries, found
// by ballot. `active`: this lane's vector lies inside H.
template <typename T, int VEC>
__device__ __forceinline__ void gather_batches(const T* __restrict__ base, size_t row_stride, int my_idx,
                                               float my_w, int count, bool active, float (&acc)[VEC]) {
  const int lane = threadIdx.x & 31;
  unsigned live = __ballot_sync(kFullMask, lane < count && my_idx >= 0);
  while (live) {  // warp-uniform: shuffles need every lane
    Vec<T, VEC> buf[kBatch];
    int from[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      from[b] = __ffs(live) - 1;  // the next live entry's lane, -1 once none is left
      live &= live - 1;
      const int idx = __shfl_sync(kFullMask, my_idx, from[b] & 31);
      if (active && from[b] >= 0) buf[b] = Vec<T, VEC>::load(base + static_cast<size_t>(idx) * row_stride);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const float w = __shfl_sync(kFullMask, my_w, from[b] & 31);
      if (active && from[b] >= 0) buf[b].fma(w, acc);
    }
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSM)
neighbor_agg_fwd_kernel(const T* __restrict__ h, const int* __restrict__ nbr,
                        const float* __restrict__ mask, T* __restrict__ out, int n, int k,
                        int hdim, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps only: the ragged last block
  const int* __restrict__ nrow = nbr + row * k;
  const float* __restrict__ mrow = mask + row * k;

  // The count runs over every slot, in range or not, as in the Pallas kernel.
  float count = 0.f;
  for (int s = lane; s < k; s += 32) count += mrow[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFullMask, count, off);
  const float denom = count + eps;

  const int v = blockIdx.y * 32 + lane;
  const bool active = v < hdim / VEC;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const T* __restrict__ base = h + static_cast<size_t>(v) * VEC;
  for (int s0 = 0; s0 < k; s0 += 32) {
    const int s = s0 + lane;
    int my_idx = s < k ? nrow[s] : -1;
    const float my_w = s < k ? mrow[s] : 0.f;
    if (my_w == 0.f || my_idx >= n) my_idx = -1;  // dead: masked out or out of range
    gather_batches<T, VEC>(base, hdim, my_idx, my_w, min(32, k - s0), active, acc);
  }
  if (active) Vec<T, VEC>::store(out + static_cast<size_t>(row) * hdim + static_cast<size_t>(v) * VEC, acc, denom);
}

// kUnit: every entry weighs 1 and `weight` is not read (K4's gather of the
// per-edge gradient, whose entries name rows of that gradient, not nodes).
template <typename T, int VEC, bool kUnit = false>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kMinBlocksPerSM)
neighbor_agg_bwd_kernel(const T* __restrict__ g, const int* __restrict__ indptr,
                        const int* __restrict__ src, const float* __restrict__ weight,
                        T* __restrict__ gh, int n, int hdim) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps only: the ragged last block
  const int begin = indptr[row], end = indptr[row + 1];

  const int v = blockIdx.y * 32 + lane;
  const bool active = v < hdim / VEC;
  float acc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
  const T* __restrict__ base = g + static_cast<size_t>(v) * VEC;
  for (int e0 = begin; e0 < end; e0 += 32) {
    const int e = e0 + lane;
    const int my_src = e < end ? src[e] : -1;
    const float my_w = e < end ? (kUnit ? 1.f : weight[e]) : 0.f;
    gather_batches<T, VEC>(base, hdim, my_src, my_w, min(32, end - e0), active, acc);
  }
  // Divided by 1, which leaves every sum as it is.
  if (active) Vec<T, VEC>::store(gh + static_cast<size_t>(row) * hdim + static_cast<size_t>(v) * VEC, acc, 1.f);
}

// One block of kWarpsPerBlock warps per kWarpsPerBlock rows (x) and per chunk of
// 32 vectors of H (y).
template <int VEC>
dim3 grid_for(int n, int hdim) {
  const int chunks = (hdim / VEC + 31) / 32;
  return dim3(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock), static_cast<unsigned>(chunks));
}

template <typename T>
bool vector_ok(int hdim, const void* a, const void* b) {
  return (static_cast<size_t>(hdim) * sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
         reinterpret_cast<uintptr_t>(b) % 16 == 0;
}

template <typename T>
cudaError_t launch_fwd(const void* h, const int* nbr, const float* mask, void* out, int n, int k,
                       int hdim, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarpsPerBlock * 32);
  if (vector_ok<T>(hdim, h, out))
    neighbor_agg_fwd_kernel<T, kVec><<<grid_for<kVec>(n, hdim), block, 0, stream>>>(
        static_cast<const T*>(h), nbr, mask, static_cast<T*>(out), n, k, hdim, eps);
  else
    neighbor_agg_fwd_kernel<T, 1><<<grid_for<1>(n, hdim), block, 0, stream>>>(
        static_cast<const T*>(h), nbr, mask, static_cast<T*>(out), n, k, hdim, eps);
  return cudaGetLastError();
}

template <typename T, bool kUnit = false>
cudaError_t launch_bwd(const void* g, const int* indptr, const int* src, const float* weight, void* gh, int n,
                       int hdim, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarpsPerBlock * 32);
  if (vector_ok<T>(hdim, g, gh))
    neighbor_agg_bwd_kernel<T, kVec, kUnit><<<grid_for<kVec>(n, hdim), block, 0, stream>>>(
        static_cast<const T*>(g), indptr, src, weight, static_cast<T*>(gh), n, hdim);
  else
    neighbor_agg_bwd_kernel<T, 1, kUnit><<<grid_for<1>(n, hdim), block, 0, stream>>>(
        static_cast<const T*>(g), indptr, src, weight, static_cast<T*>(gh), n, hdim);
  return cudaGetLastError();
}


// ---------------------------------------------------------------------------
// K3 and K4: the SAGE message path of models/graphsage.SAGELayer, fused.

constexpr int kSageVec = 8;                   // bf16 channels a lane owns: one 16-byte load
constexpr int kSageChunk = 32 * kSageVec;     // channels a warp covers: 256
constexpr int kMaxEdge = 4;                   // edge features a slot may carry
constexpr float kGeluC = 0.796875f;           // sqrt(2/pi) rounded to bf16, as ops/gelu.py's _constants gives it
constexpr float kGeluK = 0.044677734375f;     // 0.044715 rounded to bf16
constexpr float kMeanEps = 1e-6f;             // masked_mean's eps, as the plain path's f32 op sees it
// Blocks of 4 warps a multiprocessor must hold (__launch_bounds__): K3 at 6
// keeps a thread's registers at 80 or fewer, K4's first pass at 4, 128 (it
// holds g_We's sums, E x 8 of them, beside the forward's state).
constexpr int kSageFwdBlocksPerSM = 6;
constexpr int kSageBwdBlocksPerSM = 4;

// A lane's 8 channels as 4 bf16 pairs: one 16-byte load or store.
using bf2 = __nv_bfloat162;
constexpr int kSagePairs = kSageVec / 2;
struct __align__(16) Lane8 {
  bf2 p[kSagePairs];
};

__device__ __forceinline__ Lane8 as_pairs(const uint4& q) { return *reinterpret_cast<const Lane8*>(&q); }
__device__ __forceinline__ Lane8 load8(const __nv_bfloat16* __restrict__ at) {
  return as_pairs(__ldg(reinterpret_cast<const uint4*>(at)));
}
__device__ __forceinline__ void store8(__nv_bfloat16* __restrict__ at, const Lane8& v) {
  *reinterpret_cast<uint4*>(at) = *reinterpret_cast<const uint4*>(&v);
}

// x rounded to bf16 and back: the f32 ops of the plain path end in this rounding.
__device__ __forceinline__ float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

// Every bf16 op of the plain path is an f32 op on two bf16 values, rounded to
// bf16. Hopper's packed bf16x2 add, sub and mul give that result for two
// channels in one instruction, correctly rounded: f32 holds 24 bits, at least
// 2*8 + 2, so rounding the f32 result to bf16 gives the exact result rounded
// to bf16 (in the subnormal range too, where a sum of two bf16 values is exact
// and a product has at most 16 significant bits), overflow to inf included.
// The _rn forms are never contracted into an FMA. Every constant below is
// exact in bf16, so a pair of it is exact too.
__device__ __forceinline__ bf2 both(float v) { return __float2bfloat162_rn(v); }

// tanh(c * (x + k * x^3)), ops/gelu.py's _gelu_tanh: x**3 as torch computes it
// on the card for bf16 (x * x, rounded, times x, rounded), then each op
// rounded, tanh with the precise tanhf in f32, both channels rounded at once.
__device__ __forceinline__ bf2 gelu_tanh(bf2 x) {
  const bf2 x3 = __hmul2_rn(__hmul2_rn(x, x), x);
  const float2 a = __bfloat1622float2(__hmul2_rn(__hadd2_rn(__hmul2_rn(x3, both(kGeluK)), x), both(kGeluC)));
  return __floats2bfloat162_rn(tanhf(a.x), tanhf(a.y));
}

// _Gelu.forward: (t + 1) * 0.5 * x.
__device__ __forceinline__ bf2 gelu_value(bf2 x) {
  return __hmul2_rn(__hmul2_rn(__hadd2_rn(gelu_tanh(x), both(1.f)), both(0.5f)), x);
}

// _Gelu.backward at x with incoming gradient g, op for op:
// p = 0.5·x·g·(1 - t), s = c·(p + p·t), dx = (g·cdf + s) + k·s·3x².
__device__ __forceinline__ bf2 gelu_grad(bf2 x, bf2 g) {
  const bf2 t = gelu_tanh(x);
  const bf2 p = __hmul2_rn(__hmul2_rn(__hmul2_rn(x, g), both(0.5f)), __hsub2_rn(both(1.f), t));
  const bf2 s = __hmul2_rn(__hadd2_rn(__hmul2_rn(p, t), p), both(kGeluC));
  const bf2 dx = __hadd2_rn(__hmul2_rn(g, __hmul2_rn(__hadd2_rn(t, both(1.f)), both(0.5f))), s);
  return __hadd2_rn(dx, __hmul2_rn(__hmul2_rn(s, both(kGeluK)), __hmul2_rn(__hmul2_rn(x, x), both(3.f))));
}

// The block's chunk of We [H, E] in f32, laid out so that lane l reads the
// weights of its 8 channels c0 = chunk*256 + 8l .. c0+7 for edge feature d as
// two conflict-free float4 loads: w[d][half][l] holds channels c0+4*half .. +3.
struct EdgeWeights {
  float4 w[kMaxEdge][2][32];
};

__device__ __forceinline__ void load_edge_weights(EdgeWeights& sm, const __nv_bfloat16* __restrict__ we, int hdim,
                                                  int edim) {
  float* flat = reinterpret_cast<float*>(sm.w);
  for (int i = threadIdx.x; i < kMaxEdge * kSageChunk; i += blockDim.x) {
    const int d = i / kSageChunk, r = i % kSageChunk;  // r: the channel within the chunk
    const int c = blockIdx.y * kSageChunk + r;
    const int l = r / kSageVec, half = (r % kSageVec) / 4;
    flat[((d * 2 + half) * 32 + l) * 4 + r % 4] =
        d < edim && c < hdim ? __bfloat162float(we[static_cast<size_t>(c) * edim + d]) : 0.f;
  }
  __syncthreads();
}

// The edge term of this lane's channels for one slot, msg_edge's product:
// sum_d e[d] * We[c, d] in f32 (each product of two bf16 values is exact),
// rounded once to bf16.
__device__ __forceinline__ Lane8 edge_term(const EdgeWeights& sm, const float (&e)[kMaxEdge], int edim) {
  const int lane = threadIdx.x & 31;
  float v[kSageVec];
#pragma unroll
  for (int j = 0; j < kSageVec; ++j) v[j] = 0.f;
#pragma unroll
  for (int d = 0; d < kMaxEdge; ++d) {
    if (d < edim) {
      const float4 lo = sm.w[d][0][lane], hi = sm.w[d][1][lane];
      v[0] = fmaf(e[d], lo.x, v[0]);
      v[1] = fmaf(e[d], lo.y, v[1]);
      v[2] = fmaf(e[d], lo.z, v[2]);
      v[3] = fmaf(e[d], lo.w, v[3]);
      v[4] = fmaf(e[d], hi.x, v[4]);
      v[5] = fmaf(e[d], hi.y, v[5]);
      v[6] = fmaf(e[d], hi.z, v[6]);
      v[7] = fmaf(e[d], hi.w, v[7]);
    }
  }
  Lane8 r;
#pragma unroll
  for (int j = 0; j < kSagePairs; ++j) r.p[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  return r;
}

// One row's slots, one a lane (K <= 32): the neighbour row (-1 when the slot
// is dead: its bf16 mask is 0 or its index lies outside [0, n)), the mask and
// the edge features rounded to bf16 as the plain path casts them, the live
// slots by ballot, and masked_mean's divisor bf16(bf16(sum_k m) + eps).
struct RowSlots {
  int idx;
  float m;
  float e[kMaxEdge];
  unsigned live;
  float denom;
};

__device__ __forceinline__ RowSlots load_row(const int* __restrict__ nbr, const float* __restrict__ mask,
                                             const float* __restrict__ edge, long long row, int n, int k,
                                             int edim) {
  const int lane = threadIdx.x & 31;
  const bool in = lane < k;
  const long long slot = row * k + lane;
  RowSlots r;
  r.m = in ? rb(mask[slot]) : 0.f;
  int idx = in ? nbr[slot] : -1;
  if (r.m == 0.f || idx < 0 || idx >= n) idx = -1;
  r.idx = idx;
#pragma unroll
  for (int d = 0; d < kMaxEdge; ++d) r.e[d] = in && d < edim ? rb(edge[slot * edim + d]) : 0.f;
  float count = r.m;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFullMask, count, off);
  r.denom = rb(__fadd_rn(rb(count), kMeanEps));
  r.live = __ballot_sync(kFullMask, idx >= 0);
  return r;
}

// The pre-activation of one live slot for this lane's channels:
// bf16(bf16(u[nbr] + s) + v), v the slot's edge term.
__device__ __forceinline__ Lane8 preact(const EdgeWeights& sm, const uint4& urow, const Lane8& sv,
                                        const float (&e)[kMaxEdge], int edim) {
  const Lane8 uv = as_pairs(urow), v = edge_term(sm, e, edim);
  Lane8 x;
#pragma unroll
  for (int j = 0; j < kSagePairs; ++j) x.p[j] = __hadd2_rn(__hadd2_rn(uv.p[j], sv.p[j]), v.p[j]);
  return x;
}

// K3: agg[n] = bf16(bf16(sum_k bf16(gelu(x[n,k]) * m[n,k])) / denom[n]), with
// the sum over the live slots in slot order in f32. One warp a row and a chunk
// of 256 channels (blockIdx.y), four rows a block; the live slots are walked
// by ballot with kBatch gathered u rows in flight, as in K1.
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kSageFwdBlocksPerSM)
sage_message_fwd_kernel(const __nv_bfloat16* __restrict__ u, const __nv_bfloat16* __restrict__ s,
                        const __nv_bfloat16* __restrict__ we, const float* __restrict__ edge,
                        const int* __restrict__ nbr, const float* __restrict__ mask,
                        __nv_bfloat16* __restrict__ out, int n, int k, int hdim, int edim) {
  __shared__ EdgeWeights wsm;
  load_edge_weights(wsm, we, hdim, edim);
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps only, after the block's last barrier
  const RowSlots r = load_row(nbr, mask, edge, row, n, k, edim);
  const int c0 = blockIdx.y * kSageChunk + lane * kSageVec;
  const bool active = c0 < hdim;  // hdim is a multiple of 8: all of the lane's channels or none
  float acc[kSageVec];
#pragma unroll
  for (int j = 0; j < kSageVec; ++j) acc[j] = 0.f;
  const Lane8 sv = active ? load8(s + row * hdim + c0) : Lane8{};

  unsigned live = r.live;
  while (live) {  // warp-uniform: shuffles need every lane
    uint4 buf[kBatch];
    int from[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      from[b] = __ffs(live) - 1;  // the next live slot, -1 once none is left
      live &= live - 1;
      const int idx = __shfl_sync(kFullMask, r.idx, from[b] & 31);
      if (active && from[b] >= 0)
        buf[b] = __ldg(reinterpret_cast<const uint4*>(u + static_cast<size_t>(idx) * hdim + c0));
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      if (from[b] < 0) break;
      const bf2 m = both(__shfl_sync(kFullMask, r.m, from[b]));
      float e[kMaxEdge];
#pragma unroll
      for (int d = 0; d < kMaxEdge; ++d) e[d] = __shfl_sync(kFullMask, r.e[d], from[b]);
      if (active) {
        const Lane8 x = preact(wsm, buf[b], sv, e, edim);
#pragma unroll
        for (int j = 0; j < kSagePairs; ++j) {
          const float2 y = __bfloat1622float2(__hmul2_rn(gelu_value(x.p[j]), m));
          acc[2 * j] = __fadd_rn(acc[2 * j], y.x);
          acc[2 * j + 1] = __fadd_rn(acc[2 * j + 1], y.y);
        }
      }
    }
  }
  if (active) {
    Lane8 y;
#pragma unroll
    for (int j = 0; j < kSagePairs; ++j) {
      const float2 a = __bfloat1622float2(__floats2bfloat162_rn(acc[2 * j], acc[2 * j + 1]));
      y.p[j] = __floats2bfloat162_rn(__fdiv_rn(a.x, r.denom), __fdiv_rn(a.y, r.denom));
    }
    store8(out + row * hdim + c0, y);
  }
}

// K4, first pass, in row order: for each live slot the gradient of its
// pre-activation, dx = gelu'(x; bf16(bf16(G[n] / denom) * m)), recomputed from
// the forward's inputs and written once in bf16 to dx[n*K + k]; g_s[n] =
// bf16(sum_k dx); and this block's f32 partial of g_We[c, d] = sum dx[c]·e[d].
// A fixed set of blocks walks the rows (row += gridDim.x * 4 for each warp),
// so the partials are few; each warp keeps its sums over its rows in
// registers, and the block adds its four warps' in a fixed order.
__global__ void __launch_bounds__(kWarpsPerBlock * 32, kSageBwdBlocksPerSM)
sage_message_bwd_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ u,
                        const __nv_bfloat16* __restrict__ s, const __nv_bfloat16* __restrict__ we,
                        const float* __restrict__ edge, const int* __restrict__ nbr,
                        const float* __restrict__ mask, __nv_bfloat16* __restrict__ dx,
                        __nv_bfloat16* __restrict__ gs, float* __restrict__ partial, int n, int k, int hdim,
                        int edim) {
  __shared__ EdgeWeights wsm;
  __shared__ float red[kWarpsPerBlock][kMaxEdge][kSageChunk];
  load_edge_weights(wsm, we, hdim, edim);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c0 = blockIdx.y * kSageChunk + lane * kSageVec;
  const bool active = c0 < hdim;
  float gw[kMaxEdge][kSageVec];
#pragma unroll
  for (int d = 0; d < kMaxEdge; ++d)
#pragma unroll
    for (int j = 0; j < kSageVec; ++j) gw[d][j] = 0.f;

  for (long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp; row < n;
       row += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const RowSlots r = load_row(nbr, mask, edge, row, n, k, edim);
    float gsum[kSageVec];
#pragma unroll
    for (int j = 0; j < kSageVec; ++j) gsum[j] = 0.f;
    Lane8 gt{}, sv{};
    if (active) {
      gt = load8(g + row * hdim + c0);
      sv = load8(s + row * hdim + c0);
#pragma unroll
      for (int j = 0; j < kSagePairs; ++j) {  // the mean's divide
        const float2 a = __bfloat1622float2(gt.p[j]);
        gt.p[j] = __floats2bfloat162_rn(__fdiv_rn(a.x, r.denom), __fdiv_rn(a.y, r.denom));
      }
    }
    unsigned live = r.live;
    while (live) {
      uint4 buf[kBatch];
      int from[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        from[b] = __ffs(live) - 1;
        live &= live - 1;
        const int idx = __shfl_sync(kFullMask, r.idx, from[b] & 31);
        if (active && from[b] >= 0)
          buf[b] = __ldg(reinterpret_cast<const uint4*>(u + static_cast<size_t>(idx) * hdim + c0));
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (from[b] < 0) break;
        const bf2 m = both(__shfl_sync(kFullMask, r.m, from[b]));
        float e[kMaxEdge];
#pragma unroll
        for (int d = 0; d < kMaxEdge; ++d) e[d] = __shfl_sync(kFullMask, r.e[d], from[b]);
        if (active) {
          Lane8 x = preact(wsm, buf[b], sv, e, edim);
#pragma unroll
          for (int j = 0; j < kSagePairs; ++j) {
            x.p[j] = gelu_grad(x.p[j], __hmul2_rn(gt.p[j], m));  // the mask's product, then GELU's VJP
            const float2 y = __bfloat1622float2(x.p[j]);
            gsum[2 * j] = __fadd_rn(gsum[2 * j], y.x);
            gsum[2 * j + 1] = __fadd_rn(gsum[2 * j + 1], y.y);
#pragma unroll
            for (int d = 0; d < kMaxEdge; ++d)
              if (d < edim) {
                gw[d][2 * j] = fmaf(y.x, e[d], gw[d][2 * j]);
                gw[d][2 * j + 1] = fmaf(y.y, e[d], gw[d][2 * j + 1]);
              }
          }
          store8(dx + (static_cast<size_t>(row) * k + from[b]) * hdim + c0, x);
        }
      }
    }
    if (active) {
      Lane8 y;
#pragma unroll
      for (int j = 0; j < kSagePairs; ++j) y.p[j] = __floats2bfloat162_rn(gsum[2 * j], gsum[2 * j + 1]);
      store8(gs + row * hdim + c0, y);
    }
  }

#pragma unroll
  for (int d = 0; d < kMaxEdge; ++d)
#pragma unroll
    for (int j = 0; j < kSageVec; ++j) red[warp][d][lane * kSageVec + j] = gw[d][j];
  __syncthreads();
  for (int i = threadIdx.x; i < kMaxEdge * kSageChunk; i += blockDim.x) {
    const int d = i / kSageChunk, r = i % kSageChunk, c = blockIdx.y * kSageChunk + r;
    if (d < edim && c < hdim) {
      float t = red[0][d][r];
#pragma unroll
      for (int w = 1; w < kWarpsPerBlock; ++w) t += red[w][d][r];
      partial[(static_cast<size_t>(blockIdx.x) * hdim + c) * edim + d] = t;
    }
  }
}

// K4, second pass: g_We[i] = bf16(sum over the first pass's blocks of their
// partials), in block order, one thread an entry of [H, E].
__global__ void sage_weight_grad_kernel(const float* __restrict__ partial, __nv_bfloat16* __restrict__ gw,
                                        int blocks, int count) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float t = 0.f;
  for (int b = 0; b < blocks; ++b) t += partial[static_cast<size_t>(b) * count + i];
  gw[i] = __float2bfloat16_rn(t);
}

// Rows of blocks K4's first pass runs: as many as the card holds at once
// across its chunks of H, and no more than its rows of four warps.
int sage_bwd_blocks(int n, int hdim, int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sage_message_bwd_kernel, kWarpsPerBlock * 32, 0) !=
          cudaSuccess)
    return -1;
  const int chunks = (hdim + kSageChunk - 1) / kSageChunk;
  const int rows = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int fit = sms * per_sm / chunks;
  return fit < 1 ? 1 : (fit < rows ? fit : rows);
}

// Makes `device` the calling thread's device for the launches in its scope
// and puts the caller's back after them; where `device` is current already,
// as it is on one card, it costs one cudaGetDevice.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    int cur = 0;
    err_ = cudaGetDevice(&cur);
    if (err_ == cudaSuccess && cur != device) {
      err_ = cudaSetDevice(device);
      if (err_ == cudaSuccess) prev_ = cur;
    }
  }
  ~DeviceScope() {
    if (prev_ >= 0) cudaSetDevice(prev_);
  }
  cudaError_t error() const { return err_; }

 private:
  int prev_ = -1;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace

extern "C" {

// K1. dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
int df_neighbor_agg_fwd(const void* h, const int* nbr, const float* mask, void* out, int n, int k,
                        int hdim, int dtype, float eps, void* stream) {
  if (n < 0 || k < 0 || hdim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || hdim == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_fwd<float>(h, nbr, mask, out, n, k, hdim, eps, s));
    case 1:
      return static_cast<int>(launch_fwd<__nv_bfloat16>(h, nbr, mask, out, n, k, hdim, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2. g is [N, hdim] and gh [n, hdim], both in dtype (0 = float32,
// 1 = bfloat16); indptr [n+1], src and weight are the transposed index (row j's
// entries are [indptr[j], indptr[j+1])). Every gh row is written. Returns
// cudaGetLastError() after the launch (0 on success).
int df_neighbor_agg_bwd(const void* g, const int* indptr, const int* src, const float* weight, void* gh, int n,
                        int hdim, int dtype, void* stream) {
  if (n < 0 || hdim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || hdim == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch_bwd<float>(g, indptr, src, weight, gh, n, hdim, s));
    case 1:
      return static_cast<int>(launch_bwd<__nv_bfloat16>(g, indptr, src, weight, gh, n, hdim, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K3. u and s are [n, hdim], we [hdim, edim], all bfloat16; edge is [n, k, edim]
// and mask [n, k] float32, nbr [n, k] int32; out [n, hdim] bfloat16. hdim must be
// a multiple of 8 and u, s and out 16-byte aligned; 1 <= k <= 32 and
// 1 <= edim <= 4. `device` is the tensors' card and `stream` one of its
// streams. Returns cudaGetLastError() after the launch (0 on success).
int df_sage_message_fwd(const void* u, const void* s, const void* we, const float* edge, const int* nbr,
                        const float* mask, void* out, int n, int k, int hdim, int edim, int device, void* stream) {
  if (n < 0 || k < 1 || k > 32 || hdim < 0 || hdim % kSageVec != 0 || edim < 1 || edim > kMaxEdge)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || hdim == 0) return static_cast<int>(cudaSuccess);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const dim3 grid((n + kWarpsPerBlock - 1) / kWarpsPerBlock, (hdim + kSageChunk - 1) / kSageChunk);
  sage_message_fwd_kernel<<<grid, kWarpsPerBlock * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(s),
      static_cast<const __nv_bfloat16*>(we), edge, nbr, mask, static_cast<__nv_bfloat16*>(out), n, k, hdim, edim);
  return static_cast<int>(cudaGetLastError());
}

// Rows of blocks K4's first pass runs at (n, hdim) on `device`: the first
// dimension of its f32 partials [blocks, hdim, edim]. -1 on an error.
int df_sage_message_bwd_blocks(int n, int hdim, int device) {
  const DeviceScope scope(device);
  return scope.error() == cudaSuccess ? sage_bwd_blocks(n, hdim, device) : -1;
}

// K4, three launches on `stream`: the first pass (g_s, dx and the partials),
// g_We from the partials, then g_u[j] = bf16(sum of dx over j's entries of
// the transposed index) by K2's gather with unit weights. g is the gradient
// of K3's output; the inputs are K3's. indptr [n+1] and slot [n*k] are the
// index (row j's entries [indptr[j], indptr[j+1]) name the live slots i*k+kk
// with nbr = j); dx [n*k, hdim] bfloat16 is scratch, only its live rows are
// written; partial is [blocks, hdim, edim] float32, blocks as
// df_sage_message_bwd_blocks gives it. gu and gs are [n, hdim], gw [hdim, edim],
// all bfloat16; `device` and `stream` as for K3. Returns the first launch
// error (0 on success).
int df_sage_message_bwd(const void* g, const void* u, const void* s, const void* we, const float* edge,
                        const int* nbr, const float* mask, const int* indptr, const int* slot, void* dx,
                        float* partial, int blocks, void* gu, void* gs, void* gw, int n, int k, int hdim,
                        int edim, int device, void* stream) {
  if (n < 0 || k < 1 || k > 32 || hdim < 0 || hdim % kSageVec != 0 || edim < 1 || edim > kMaxEdge || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || hdim == 0) return static_cast<int>(cudaSuccess);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(blocks, (hdim + kSageChunk - 1) / kSageChunk);
  sage_message_bwd_kernel<<<grid, kWarpsPerBlock * 32, 0, st>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const __nv_bfloat16*>(u),
      static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(we), edge, nbr, mask,
      static_cast<__nv_bfloat16*>(dx), static_cast<__nv_bfloat16*>(gs), partial, n, k, hdim, edim);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int count = hdim * edim;
  sage_weight_grad_kernel<<<(count + 255) / 256, 256, 0, st>>>(partial, static_cast<__nv_bfloat16*>(gw), blocks,
                                                                count);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_bwd<__nv_bfloat16, true>(dx, indptr, slot, nullptr, gu, n, hdim, st));
}

const char* df_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
