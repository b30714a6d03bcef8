// K5 and K6: the node update of models/graphsage.SAGELayer, fused, forward and
// backward (ops/sage_update.py).
//
// A SAGE layer ends in LayerNorm_0(gelu(Dense_0(h) + agg)). With y = Dense_0's
// product without its bias (a GEMM, left to cuBLAS), b0 its bias in bf16, agg
// the message path's output (K3) and the LayerNorm's f32 scale and bias g and
// be, K5 computes
//
//     x   = bf16(bf16(y + b0) + agg)
//     a   = gelu(x)                                   every op rounded to bf16
//     mu  = mean(a), var = max(mean(a*a) - mu*mu, 0)  in f32
//     out = bf16((a - mu) * (rsqrt(var + eps) * g) + be)
//
// each op rounded where the plain path's op rounds it on the card: the two
// bf16 adds, ops/gelu.py's tanh-GELU op for op, and LayerNorm.forward's f32
// ops one at a time (never contracted into an FMA). Only the order of the two
// f32 row sums differs from torch's reduction, which can move an output by
// one bf16 rounding. K6 gives the gradients with respect to y and agg (one
// g_x, the same for both), b0, g and be: LayerNorm's gradient of the formula
// as written, in f32, the clamp's gradient 0 where it binds; g_a rounded to
// bf16 where the backward of a.float() rounds it; the GELU's VJP op for op.
//
// These kernels replace no TPU kernel: the JAX package leaves this epilogue to
// XLA, which fuses it on the TPU. On the H100 the plain ops run it as some 30
// elementwise passes forward and backward over [N, H] tensors, the LayerNorm's
// in f32: about 2.4 ms of a 9.5 ms train step at N 16384, H 512 (PERF.md §5).
//
// What bounds them on an H100: bytes, and the GELU's instructions, about
// alike. K5 must read y and agg and write out, and x when a gradient will be
// taken (the mean and rstd beside it are 8 bytes a row): 64 MiB at N 16384,
// H 512, 20 us at 3.35 TB/s; its ~57 instructions an element (the rounded
// ops, the precise tanhf) take about as long. K6 reads the output's gradient
// and x and writes g_x (48 MiB, 15 us) and needs about twice K5's
// instructions: it recomputes a from x and runs the VJP.
//
// The design keeps every intermediate in registers: one warp owns one row,
// each lane H/32 channels in 16-byte loads (one at H 256, two at H 512; up to
// four, H <= 1024), and the row sums are warp shuffles in f32. K5 writes out,
// and x, the mean and rstd when a gradient is to be taken. K6 walks the rows
// with a fixed set of blocks (row += gridDim.x * 4 for each warp), keeps the
// three column sums over its rows in registers (g's, be's and b0's
// gradients), adds the block's four warps' in a fixed order into one f32
// partial a block, and a second small pass sums the partials in block order.
// No atomics: every launch gives the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 4;  // one warp a row, four rows a block, as K3 and K4
constexpr int kVec = 8;            // bf16 channels a lane loads at once: 16 bytes
constexpr int kMaxVecs = 4;        // 16-byte vectors a lane owns at most
constexpr int kMaxWidth = 32 * kVec * kMaxVecs;  // 1024 channels
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kGeluC = 0.796875f;        // sqrt(2/pi) rounded to bf16, as ops/gelu.py's _constants gives it
constexpr float kGeluK = 0.044677734375f;  // 0.044715 rounded to bf16

// x rounded to bf16 and back: every bf16 op of the plain path ends in it.
__device__ __forceinline__ float rb(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
// One f32 op, then the rounding. The _rn intrinsics are never contracted into
// an FMA, so each product and sum rounds where the plain path's op does.
__device__ __forceinline__ float mul_r(float a, float b) { return rb(__fmul_rn(a, b)); }
__device__ __forceinline__ float add_r(float a, float b) { return rb(__fadd_rn(a, b)); }

// tanh(c * (x + k * x^3)), ops/gelu.py's _gelu_tanh: x**3 as torch computes it
// on the card for bf16 (x * x, rounded, times x, rounded), then each op
// rounded, tanh with the precise tanhf. The same ops as K3's.
__device__ __forceinline__ float gelu_tanh(float x) {
  const float x3 = mul_r(mul_r(x, x), x);
  return rb(tanhf(mul_r(add_r(mul_r(x3, kGeluK), x), kGeluC)));
}

// _Gelu.forward given t = gelu_tanh(x): (t + 1) * 0.5 * x.
__device__ __forceinline__ float gelu_value(float x, float t) { return mul_r(mul_r(add_r(t, 1.f), 0.5f), x); }

// _Gelu.backward at x, t = gelu_tanh(x), incoming gradient g, op for op:
// p = 0.5·x·g·(1 - t), s = c·(p + p·t), dx = (g·cdf + s) + k·s·3x².
__device__ __forceinline__ float gelu_grad(float x, float t, float g) {
  const float p = mul_r(mul_r(mul_r(x, g), 0.5f), rb(__fsub_rn(1.f, t)));
  const float s = mul_r(add_r(mul_r(p, t), p), kGeluC);
  const float dx = add_r(mul_r(g, mul_r(add_r(t, 1.f), 0.5f)), s);
  return add_r(dx, mul_r(mul_r(s, kGeluK), mul_r(mul_r(x, x), 3.f)));
}

__device__ __forceinline__ void unpack8(const uint4& q, float (&f)[kVec]) {
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float2 t = __bfloat1622float2(p[j]);
    f[2 * j] = t.x;
    f[2 * j + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack8(const float (&f)[kVec]) {
  uint4 q;
  __nv_bfloat162* p = reinterpret_cast<__nv_bfloat162*>(&q);
#pragma unroll
  for (int j = 0; j < 4; ++j) p[j] = __floats2bfloat162_rn(f[2 * j], f[2 * j + 1]);
  return q;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* __restrict__ src, float (&f)[kVec]) {
  unpack8(__ldg(reinterpret_cast<const uint4*>(src)), f);
}

__device__ __forceinline__ void load8(const float* __restrict__ src, float (&f)[kVec]) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(src)), hi = __ldg(reinterpret_cast<const float4*>(src) + 1);
  f[0] = lo.x, f[1] = lo.y, f[2] = lo.z, f[3] = lo.w, f[4] = hi.x, f[5] = hi.y, f[6] = hi.z, f[7] = hi.w;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_xor_sync(kFullMask, v, off));
  return v;
}

// The first channel of this lane's i-th vector: the lanes span the row with
// 16-byte loads, vector i of lane l at channel 8 * (l + 32 * i). hdim is a
// multiple of 8, so a lane has all eight channels of a vector or none.
__device__ __forceinline__ int first_channel(int i) { return ((threadIdx.x & 31) + 32 * i) * kVec; }

// K5, one warp a row. `factor` is the mean's 1/H as torch's mean computes it
// (float(N) / float(N * H)). xs, mu and rstd are written only where xs is
// not null (a gradient will be taken); rstd carries the clamp's state in its
// sign, negative where mean(a*a) - mu*mu < 0 and var was clamped to 0.
template <int VECS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sage_update_fwd_kernel(const __nv_bfloat16* __restrict__ y, const __nv_bfloat16* __restrict__ b0,
                       const __nv_bfloat16* __restrict__ agg, const float* __restrict__ gamma,
                       const float* __restrict__ beta, __nv_bfloat16* __restrict__ out, __nv_bfloat16* __restrict__ xs,
                       float* __restrict__ mu_out, float* __restrict__ rstd_out, int n, int hdim, float factor,
                       float eps) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n) return;  // whole warps only
  const size_t base = static_cast<size_t>(row) * hdim;
  float a[VECS][kVec];
  float s1 = 0.f, s2 = 0.f;
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c0 = first_channel(i);
#pragma unroll
    for (int j = 0; j < kVec; ++j) a[i][j] = 0.f;
    if (c0 < hdim) {
      float yv[kVec], bv[kVec], gv[kVec], x[kVec];
      load8(y + base + c0, yv);
      load8(b0 + c0, bv);
      load8(agg + base + c0, gv);
#pragma unroll
      for (int j = 0; j < kVec; ++j) x[j] = add_r(add_r(yv[j], bv[j]), gv[j]);
      if (xs != nullptr) *reinterpret_cast<uint4*>(xs + base + c0) = pack8(x);
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        a[i][j] = gelu_value(x[j], gelu_tanh(x[j]));
        s1 = __fadd_rn(s1, a[i][j]);
        s2 = __fadd_rn(s2, __fmul_rn(a[i][j], a[i][j]));
      }
    }
  }
  const float mu = __fmul_rn(warp_sum(s1), factor);
  const float t = __fsub_rn(__fmul_rn(warp_sum(s2), factor), __fmul_rn(mu, mu));
  const float r = rsqrtf(__fadd_rn(t < 0.f ? 0.f : t, eps));
  if (xs != nullptr && (threadIdx.x & 31) == 0) {
    mu_out[row] = mu;
    rstd_out[row] = t < 0.f ? -r : r;
  }
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c0 = first_channel(i);
    if (c0 < hdim) {
      float gm[kVec], be[kVec], o[kVec];
      load8(gamma + c0, gm);
      load8(beta + c0, be);
#pragma unroll
      for (int j = 0; j < kVec; ++j)
        o[j] = __fadd_rn(__fmul_rn(__fsub_rn(a[i][j], mu), __fmul_rn(r, gm[j])), be[j]);
      *reinterpret_cast<uint4*>(out + base + c0) = pack8(o);
    }
  }
}

// One of K6's column sums into the block's partial: each warp's sums of its
// lanes' channels, added in warp order.
template <int VECS>
__device__ __forceinline__ void block_partial(float (&red)[kWarpsPerBlock][kMaxWidth], const float (&sum)[VECS][kVec],
                                              float* __restrict__ dst, int hdim) {
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < VECS; ++i) {
    const int c0 = first_channel(i);
    if (c0 < hdim)
#pragma unroll
      for (int j = 0; j < kVec; ++j) red[warp][c0 + j] = sum[i][j];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < hdim; c += blockDim.x) {
    float v = red[0][c];
#pragma unroll
    for (int w = 1; w < kWarpsPerBlock; ++w) v = __fadd_rn(v, red[w][c]);
    dst[c] = v;
  }
  __syncthreads();
}

// K6, first pass. For each row, given the output's gradient G and K5's x, mu
// and rstd (r), with c = a - mu and m = r·g (LayerNorm's product of rsqrt and
// scale):
//
//     g_c = G·m, g_m = G·c                          (the product's and m's gradients)
//     g_r = sum_h g_m·g                             (rsqrt's output)
//     g_t = -0.5·g_r·r³, 0 where the clamp bound   (var's input t = mean(a*a) - mu*mu)
//     g_mu = -sum_h g_c - g_t·mu - g_t·mu           (mean, the subtraction and mu*mu)
//     g_a = bf16(g_c + g_mu / H + 2·(g_t / H)·a)   (the three uses of a.float(), rounded by its backward)
//     g_x = gelu'(x; g_a), written once in bf16
//
// and this block's f32 partials of three column sums: g's gradient sum_n g_m·r,
// be's sum_n G and b0's sum_n g_x. Each lane keeps them for its channels over
// the warp's rows; the block adds its four warps' in warp order.
template <int VECS>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sage_update_bwd_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ xs,
                       const float* __restrict__ mu_in, const float* __restrict__ rstd_in,
                       const float* __restrict__ gamma, __nv_bfloat16* __restrict__ gx, float* __restrict__ partial,
                       int n, int hdim) {
  __shared__ float red[kWarpsPerBlock][kMaxWidth];
  const int warp = threadIdx.x >> 5;
  const float width = static_cast<float>(hdim);  // the means' backward divides by H
  float sum_g[VECS][kVec], sum_be[VECS][kVec], sum_b0[VECS][kVec];
#pragma unroll
  for (int i = 0; i < VECS; ++i)
#pragma unroll
    for (int j = 0; j < kVec; ++j) sum_g[i][j] = sum_be[i][j] = sum_b0[i][j] = 0.f;

  for (long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp; row < n;
       row += static_cast<long long>(gridDim.x) * kWarpsPerBlock) {
    const size_t base = static_cast<size_t>(row) * hdim;
    const float mu = mu_in[row], rs = rstd_in[row];
    const float r = fabsf(rs);
    float gv[VECS][kVec], xv[VECS][kVec], tv[VECS][kVec];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int c0 = first_channel(i);
#pragma unroll
      for (int j = 0; j < kVec; ++j) gv[i][j] = xv[i][j] = tv[i][j] = 0.f;
      if (c0 < hdim) {
        float gm[kVec];
        load8(g + base + c0, gv[i]);
        load8(xs + base + c0, xv[i]);
        load8(gamma + c0, gm);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          tv[i][j] = gelu_tanh(xv[i][j]);
          const float c = __fsub_rn(gelu_value(xv[i][j], tv[i][j]), mu);
          const float gmul = __fmul_rn(gv[i][j], c);
          s1 = __fadd_rn(s1, __fmul_rn(gv[i][j], __fmul_rn(r, gm[j])));
          s2 = __fadd_rn(s2, __fmul_rn(gmul, gm[j]));
          sum_g[i][j] = __fadd_rn(sum_g[i][j], __fmul_rn(gmul, r));
          sum_be[i][j] = __fadd_rn(sum_be[i][j], gv[i][j]);
        }
      }
    }
    const float g_r = warp_sum(s2);
    const float g_t = rs < 0.f ? 0.f : __fmul_rn(__fmul_rn(-0.5f, g_r), __fmul_rn(__fmul_rn(r, r), r));
    const float g_tmu = __fmul_rn(g_t, mu);
    const float g_mu_h = __fdiv_rn(__fsub_rn(__fsub_rn(-warp_sum(s1), g_tmu), g_tmu), width);
    const float g_sq = __fdiv_rn(g_t, width);
#pragma unroll
    for (int i = 0; i < VECS; ++i) {
      const int c0 = first_channel(i);
      if (c0 < hdim) {
        float gm[kVec], d[kVec];
        load8(gamma + c0, gm);
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          const float a = gelu_value(xv[i][j], tv[i][j]);
          const float g_c = __fmul_rn(gv[i][j], __fmul_rn(r, gm[j]));
          const float sq = __fmul_rn(g_sq, a);
          const float g_a = rb(__fadd_rn(__fadd_rn(g_c, g_mu_h), __fadd_rn(sq, sq)));
          d[j] = gelu_grad(xv[i][j], tv[i][j], g_a);
          sum_b0[i][j] = __fadd_rn(sum_b0[i][j], d[j]);
        }
        *reinterpret_cast<uint4*>(gx + base + c0) = pack8(d);
      }
    }
  }

  float* dst = partial + static_cast<size_t>(blockIdx.x) * 3 * hdim;
  block_partial<VECS>(red, sum_g, dst, hdim);
  block_partial<VECS>(red, sum_be, dst + hdim, hdim);
  block_partial<VECS>(red, sum_b0, dst + 2 * hdim, hdim);
}

// K6, second pass: each of the 3 * hdim column sums over the first pass's
// blocks, in a fixed order: 8 groups of 32 threads take every 8th block, then
// the groups' sums are added in group order. g's and be's gradients are
// written in f32, b0's rounded to bf16 (its plain path sums a bf16 tensor).
constexpr int kSumGroups = 8;

__global__ void __launch_bounds__(kSumGroups * 32)
sage_update_colsum_kernel(const float* __restrict__ partial, int blocks, int hdim, float* __restrict__ g_gamma,
                          float* __restrict__ g_beta, __nv_bfloat16* __restrict__ g_b0) {
  __shared__ float red[kSumGroups][32];
  const int lane = threadIdx.x & 31, grp = threadIdx.x >> 5;
  const int cols = 3 * hdim, col = blockIdx.x * 32 + lane;
  float v = 0.f;
  if (col < cols)
    for (int b = grp; b < blocks; b += kSumGroups) v = __fadd_rn(v, partial[static_cast<size_t>(b) * cols + col]);
  red[grp][lane] = v;
  __syncthreads();
  if (grp != 0 || col >= cols) return;
  for (int w = 1; w < kSumGroups; ++w) v = __fadd_rn(v, red[w][lane]);
  const int s = col / hdim, c = col % hdim;
  if (s == 0)
    g_gamma[c] = v;
  else if (s == 1)
    g_beta[c] = v;
  else
    g_b0[c] = __float2bfloat16_rn(v);
}

template <int VECS>
int bwd_blocks_for(int n, int device) {
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, sage_update_bwd_kernel<VECS>, kWarpsPerBlock * 32,
                                                    0) != cudaSuccess)
    return -1;
  const int rows = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const int fit = sms * (per_sm < 1 ? 1 : per_sm);
  return rows < 1 ? 1 : (fit < rows ? fit : rows);
}

// Makes `device` the calling thread's device for the launches in its scope
// and puts the caller's back after them (as csrc/neighbor_agg.cu's does).
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

bool width_ok(int hdim) { return hdim > 0 && hdim % kVec == 0 && hdim <= kMaxWidth; }

}  // namespace

extern "C" {

// K5. y, agg and out are [n, hdim] bfloat16, b0 [hdim] bfloat16, gamma and
// beta [hdim] float32, every pointer 16-byte aligned; hdim a multiple of 8 and
// at most 1024. xs [n, hdim] bfloat16, mu and rstd [n] float32 are all null
// (nothing saved) or all given. `device` is the tensors' card and `stream` one
// of its streams. Returns cudaGetLastError() after the launch (0 on success).
int df_sage_update_fwd(const void* y, const void* b0, const void* agg, const float* gamma, const float* beta,
                       void* out, void* xs, float* mu, float* rstd, int n, int hdim, float eps, int device,
                       void* stream) {
  const bool save = xs != nullptr;
  if (n < 0 || !width_ok(hdim) || (mu != nullptr) != save || (rstd != nullptr) != save)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return static_cast<int>(cudaSuccess);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const float factor = static_cast<float>(n) / static_cast<float>(static_cast<long long>(n) * hdim);
  const int grid = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yb = static_cast<const __nv_bfloat16*>(y);
  const auto* bb = static_cast<const __nv_bfloat16*>(b0);
  const auto* ab = static_cast<const __nv_bfloat16*>(agg);
  auto* ob = static_cast<__nv_bfloat16*>(out);
  auto* xb = static_cast<__nv_bfloat16*>(xs);
  switch ((hdim + 32 * kVec - 1) / (32 * kVec)) {
    case 1:
      sage_update_fwd_kernel<1><<<grid, kWarpsPerBlock * 32, 0, st>>>(yb, bb, ab, gamma, beta, ob, xb, mu, rstd, n,
                                                                      hdim, factor, eps);
      break;
    case 2:
      sage_update_fwd_kernel<2><<<grid, kWarpsPerBlock * 32, 0, st>>>(yb, bb, ab, gamma, beta, ob, xb, mu, rstd, n,
                                                                      hdim, factor, eps);
      break;
    case 3:
      sage_update_fwd_kernel<3><<<grid, kWarpsPerBlock * 32, 0, st>>>(yb, bb, ab, gamma, beta, ob, xb, mu, rstd, n,
                                                                      hdim, factor, eps);
      break;
    default:
      sage_update_fwd_kernel<4><<<grid, kWarpsPerBlock * 32, 0, st>>>(yb, bb, ab, gamma, beta, ob, xb, mu, rstd, n,
                                                                      hdim, factor, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// Blocks K6's first pass runs at (n, hdim) on `device`: as many as the card
// holds at once, and no more than its rows of four warps; the first dimension
// of its f32 partials [blocks, 3, hdim]. -1 on an error.
int df_sage_update_bwd_blocks(int n, int hdim, int device) {
  if (n < 0 || !width_ok(hdim)) return -1;
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return -1;
  switch ((hdim + 32 * kVec - 1) / (32 * kVec)) {
    case 1:
      return bwd_blocks_for<1>(n, device);
    case 2:
      return bwd_blocks_for<2>(n, device);
    case 3:
      return bwd_blocks_for<3>(n, device);
    default:
      return bwd_blocks_for<4>(n, device);
  }
}

// K6, two launches on `stream`: the first pass (g_x and the partials), then
// the column sums. g and gx are [n, hdim] bfloat16; xs, mu and rstd K5's
// saved tensors; gamma [hdim] float32; partial [blocks, 3, hdim] float32 with
// blocks as df_sage_update_bwd_blocks gives it; g_gamma and g_beta [hdim]
// float32, g_b0 [hdim] bfloat16. Alignment and hdim as for K5. Returns the
// first launch error (0 on success).
int df_sage_update_bwd(const void* g, const void* xs, const float* mu, const float* rstd, const float* gamma,
                       void* gx, float* partial, int blocks, float* g_gamma, float* g_beta, void* g_b0, int n,
                       int hdim, int device, void* stream) {
  if (n < 1 || !width_ok(hdim) || blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gb = static_cast<const __nv_bfloat16*>(g);
  const auto* xb = static_cast<const __nv_bfloat16*>(xs);
  auto* db = static_cast<__nv_bfloat16*>(gx);
  switch ((hdim + 32 * kVec - 1) / (32 * kVec)) {
    case 1:
      sage_update_bwd_kernel<1><<<blocks, kWarpsPerBlock * 32, 0, st>>>(gb, xb, mu, rstd, gamma, db, partial, n, hdim);
      break;
    case 2:
      sage_update_bwd_kernel<2><<<blocks, kWarpsPerBlock * 32, 0, st>>>(gb, xb, mu, rstd, gamma, db, partial, n, hdim);
      break;
    case 3:
      sage_update_bwd_kernel<3><<<blocks, kWarpsPerBlock * 32, 0, st>>>(gb, xb, mu, rstd, gamma, db, partial, n, hdim);
      break;
    default:
      sage_update_bwd_kernel<4><<<blocks, kWarpsPerBlock * 32, 0, st>>>(gb, xb, mu, rstd, gamma, db, partial, n, hdim);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sage_update_colsum_kernel<<<(3 * hdim + 31) / 32, kSumGroups * 32, 0, st>>>(partial, blocks, hdim, g_gamma, g_beta,
                                                                              static_cast<__nv_bfloat16*>(g_b0));
  return static_cast<int>(cudaGetLastError());
}

const char* df_cuda_error_string(int code) { return cudaGetErrorString(static_cast<cudaError_t>(code)); }

}  // extern "C"
