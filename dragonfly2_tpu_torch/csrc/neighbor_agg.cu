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
// need not come from device memory more than once.
//
// K1's design: the Pallas kernel builds a one-hot A[128, N] per row tile and
// runs A @ h on the MXU, a Mosaic workaround that costs 128*N*H FLOPs a tile.
// This kernel gathers directly instead. One warp owns one output row, several
// rows a block. The lanes span H with 16-byte vector loads where H*sizeof(T) is
// a multiple of 16 and the pointers are 16-byte aligned, and one element a lane
// otherwise. The warp reads its row's K indices and weights once, one slot a
// lane, and broadcasts them with shuffles while it walks the slots in order.
// The last block's rows past N return at once. cp.async/TMA staging of the
// gathered rows is left for a later change.
//
// K2 is K1's backward, the custom VJP _agg_bwd (neighbor_agg_pallas.py:80-90),
// which the JAX package computes with XLA's segment_sum:
//
//     gh[j] = sum_{(i,k): nbr[i,k] = j} mask[i,k] * g[i] / (sum_k mask[i,k] + eps)
//
// for g[N, H] in f32 or bf16, written in g's dtype. A slot whose index lies
// outside [0, N), or whose mask is 0, is never written (segment_sum drops
// out-of-range ids); a node that no slot names gets exactly 0. K2 accumulates
// in f32, where the JAX VJP accumulates in g's dtype.
//
// What bounds K2 on an H100: bytes. The least it must move is g (N*H*b), nbr
// and mask (N*K*8) and gh (N*H*b): at N=16384, K=16, H=512 in bf16 about 35 MB,
// about 10.4 us at 3.35 TB/s; its 2*N*K*H FLOPs do not matter. The atomic
// design below adds an f32 workspace of N*H*4 bytes: zeroing it, the
// read-modify-write of every atomic, and reading it back for the cast to bf16
// (for f32 g the workspace is gh itself and the cast pass is skipped).
//
// K2's design, simple first: one warp per source row i, as in K1. The warp sums
// its row's mask once, reads g[i] once into registers (16-byte vector loads
// where H*sizeof(T) is a multiple of 16 and the pointers are aligned, scalar
// loads otherwise), broadcasts each slot's index and weight by shuffle, and
// scatters mask*g[i]/count into the f32 workspace with atomicAdd, one lane per
// element run. The order of the atomics is not deterministic, so the f32 sums
// may differ in their last bits from run to run; a deterministic gather over a
// transposed (CSR) copy of nbr is later work. A second pass casts the workspace
// to bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr unsigned kFullMask = 0xffffffffu;

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

// acc[0..VEC) += w * src[0..VEC)
template <typename T, int VEC>
struct Row {
  static __device__ __forceinline__ void accumulate(const T* __restrict__ src, float w,
                                                    float (&acc)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = fmaf(w, to_float(src[j]), acc[j]);
  }
  static __device__ __forceinline__ void store(T* __restrict__ dst, const float (&acc)[VEC],
                                               float denom) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) dst[j] = from_float<T>(acc[j] / denom);
  }
};

template <>
struct Row<float, 4> {
  static __device__ __forceinline__ void accumulate(const float* __restrict__ src, float w,
                                                    float (&acc)[4]) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(src));
    acc[0] = fmaf(w, x.x, acc[0]);
    acc[1] = fmaf(w, x.y, acc[1]);
    acc[2] = fmaf(w, x.z, acc[2]);
    acc[3] = fmaf(w, x.w, acc[3]);
  }
  static __device__ __forceinline__ void store(float* __restrict__ dst, const float (&acc)[4],
                                               float denom) {
    *reinterpret_cast<float4*>(dst) =
        make_float4(acc[0] / denom, acc[1] / denom, acc[2] / denom, acc[3] / denom);
  }
};

template <>
struct Row<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void accumulate(const __nv_bfloat16* __restrict__ src,
                                                    float w, float (&acc)[8]) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      acc[2 * j] = fmaf(w, f.x, acc[2 * j]);
      acc[2 * j + 1] = fmaf(w, f.y, acc[2 * j + 1]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* __restrict__ dst,
                                               const float (&acc)[8], float denom) {
    uint4 x;
    __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&x);
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(acc[2 * j] / denom, acc[2 * j + 1] / denom);
    *reinterpret_cast<uint4*>(dst) = x;
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
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

  const int nvec = hdim / VEC;
  for (int v0 = 0; v0 < nvec; v0 += 32) {  // warp-uniform: shuffles below need every lane
    const int v = v0 + lane;
    const bool active = v < nvec;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int s = s0 + lane;
      const int my_idx = s < k ? nrow[s] : -1;
      const float my_w = s < k ? mrow[s] : 0.f;
      const int slots = min(32, k - s0);
#pragma unroll 8
      for (int t = 0; t < slots; ++t) {
        const int idx = __shfl_sync(kFullMask, my_idx, t);
        const float w = __shfl_sync(kFullMask, my_w, t);
        if (active && w != 0.f && idx >= 0 && idx < n)
          Row<T, VEC>::accumulate(h + static_cast<size_t>(idx) * hdim + static_cast<size_t>(v) * VEC,
                                  w, acc);
      }
    }
    if (active)
      Row<T, VEC>::store(out + static_cast<size_t>(row) * hdim + static_cast<size_t>(v) * VEC, acc,
                         denom);
  }
}

template <typename T>
cudaError_t launch(const void* h, const int* nbr, const float* mask, void* out, int n, int k,
                   int hdim, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  const bool vector_ok = (static_cast<size_t>(hdim) * sizeof(T)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(h) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vector_ok)
    neighbor_agg_fwd_kernel<T, kVec><<<grid, block, 0, stream>>>(
        static_cast<const T*>(h), nbr, mask, static_cast<T*>(out), n, k, hdim, eps);
  else
    neighbor_agg_fwd_kernel<T, 1><<<grid, block, 0, stream>>>(
        static_cast<const T*>(h), nbr, mask, static_cast<T*>(out), n, k, hdim, eps);
  return cudaGetLastError();
}

// ---- K2: the backward ------------------------------------------------------

template <typename T, int VEC>
struct Load {
  static __device__ __forceinline__ void row(const T* __restrict__ src, float (&x)[VEC]) {
#pragma unroll
    for (int j = 0; j < VEC; ++j) x[j] = to_float(src[j]);
  }
};

template <>
struct Load<float, 4> {
  static __device__ __forceinline__ void row(const float* __restrict__ src, float (&x)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(src));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  }
};

template <>
struct Load<__nv_bfloat16, 8> {
  static __device__ __forceinline__ void row(const __nv_bfloat16* __restrict__ src, float (&x)[8]) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(src));
    const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(p[j]);
      x[2 * j] = f.x;
      x[2 * j + 1] = f.y;
    }
  }
};

template <typename T, int VEC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
neighbor_agg_bwd_kernel(const T* __restrict__ g, const int* __restrict__ nbr,
                        const float* __restrict__ mask, float* __restrict__ ws, int n, int k,
                        int hdim, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps only: the ragged last block
  const int* __restrict__ nrow = nbr + row * k;
  const float* __restrict__ mrow = mask + row * k;

  float count = 0.f;
  for (int s = lane; s < k; s += 32) count += mrow[s];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) count += __shfl_xor_sync(kFullMask, count, off);
  const float denom = count + eps;

  const int nvec = hdim / VEC;
  for (int v0 = 0; v0 < nvec; v0 += 32) {  // warp-uniform: shuffles below need every lane
    const int v = v0 + lane;
    const bool active = v < nvec;
    float x[VEC] = {};
    if (active)
      Load<T, VEC>::row(g + static_cast<size_t>(row) * hdim + static_cast<size_t>(v) * VEC, x);
    for (int s0 = 0; s0 < k; s0 += 32) {
      const int s = s0 + lane;
      const int my_idx = s < k ? nrow[s] : -1;
      const float my_w = s < k ? mrow[s] : 0.f;
      const int slots = min(32, k - s0);
      for (int t = 0; t < slots; ++t) {
        const int idx = __shfl_sync(kFullMask, my_idx, t);
        const float w = __shfl_sync(kFullMask, my_w, t);
        if (active && w != 0.f && idx >= 0 && idx < n) {
          const float scale = w / denom;
          float* __restrict__ dst = ws + static_cast<size_t>(idx) * hdim + static_cast<size_t>(v) * VEC;
#pragma unroll
          for (int j = 0; j < VEC; ++j) atomicAdd(dst + j, scale * x[j]);
        }
      }
    }
  }
}

__global__ void cast_f32_to_bf16_kernel(const float* __restrict__ src, __nv_bfloat16* __restrict__ dst,
                                        size_t count) {
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x; i < count; i += stride)
    dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T>
cudaError_t launch_bwd(const void* g, const int* nbr, const float* mask, float* ws, int n, int k,
                       int hdim, float eps, cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const dim3 grid(static_cast<unsigned>((n + kWarpsPerBlock - 1) / kWarpsPerBlock));
  const dim3 block(kWarpsPerBlock * 32);
  const bool vector_ok = (static_cast<size_t>(hdim) * sizeof(T)) % 16 == 0 &&
                         reinterpret_cast<uintptr_t>(g) % 16 == 0;
  if (vector_ok)
    neighbor_agg_bwd_kernel<T, kVec><<<grid, block, 0, stream>>>(static_cast<const T*>(g), nbr, mask,
                                                                 ws, n, k, hdim, eps);
  else
    neighbor_agg_bwd_kernel<T, 1><<<grid, block, 0, stream>>>(static_cast<const T*>(g), nbr, mask, ws,
                                                              n, k, hdim, eps);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 on success); the launch is asynchronous on `stream`.
int df_neighbor_agg_fwd(const void* h, const int* nbr, const float* mask, void* out, int n, int k,
                        int hdim, int dtype, float eps, void* stream) {
  if (n < 0 || k < 0 || hdim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || hdim == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return static_cast<int>(launch<float>(h, nbr, mask, out, n, k, hdim, eps, s));
    case 1:
      return static_cast<int>(launch<__nv_bfloat16>(h, nbr, mask, out, n, k, hdim, eps, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K2. g and gh are [n, hdim] in dtype (0 = float32, 1 = bfloat16); workspace is
// an f32 [n, hdim] buffer, which for float32 may be gh itself. The workspace is
// zeroed on `stream`, the scatter runs, and for bfloat16 a second pass writes
// gh from it. Returns cudaGetLastError() after the launches (0 on success).
int df_neighbor_agg_bwd(const void* g, const int* nbr, const float* mask, void* gh, void* workspace,
                        int n, int k, int hdim, int dtype, float eps, void* stream) {
  if (n < 0 || k < 0 || hdim < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (dtype == 1 && workspace == gh) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || hdim == 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(workspace);
  const size_t count = static_cast<size_t>(n) * hdim;
  cudaError_t err = cudaMemsetAsync(ws, 0, count * sizeof(float), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = dtype == 0 ? launch_bwd<float>(g, nbr, mask, ws, n, k, hdim, eps, s)
                   : launch_bwd<__nv_bfloat16>(g, nbr, mask, ws, n, k, hdim, eps, s);
  if (err != cudaSuccess || dtype == 0) return static_cast<int>(err);
  const size_t blocks = (count + 255) / 256;
  cast_f32_to_bf16_kernel<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), 256, 0, s>>>(
      ws, static_cast<__nv_bfloat16*>(gh), count);
  return static_cast<int>(cudaGetLastError());
}

const char* df_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
