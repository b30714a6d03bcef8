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

template <typename T, int VEC>
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
    const float my_w = e < end ? weight[e] : 0.f;
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

template <typename T>
cudaError_t launch_bwd(const void* g, const int* indptr, const int* src, const float* weight, void* gh, int n,
                       int hdim, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 block(kWarpsPerBlock * 32);
  if (vector_ok<T>(hdim, g, gh))
    neighbor_agg_bwd_kernel<T, kVec><<<grid_for<kVec>(n, hdim), block, 0, stream>>>(
        static_cast<const T*>(g), indptr, src, weight, static_cast<T*>(gh), n, hdim);
  else
    neighbor_agg_bwd_kernel<T, 1><<<grid_for<1>(n, hdim), block, 0, stream>>>(
        static_cast<const T*>(g), indptr, src, weight, static_cast<T*>(gh), n, hdim);
  return cudaGetLastError();
}

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

const char* df_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
