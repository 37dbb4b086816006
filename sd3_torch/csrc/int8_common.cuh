// Device code of the int8 (w8a8) kernels (fused_mlp.cu: K2, K3, K9;
// fused_dense.cu: K10a, K10b): reductions, the rounding of JAX's
// `_quantize_rows`, and the per-row activation prologue launch of K2, K3
// and K9 (K10a and K10b run theirs inside their one launch).
//
// Each kernel is a template on V, the number of the TPU kernel whose launch
// it is part of (V_K2 ... V_K10B), so that a profile tells K2's, K3's and
// K9's launches apart although they run the same device code.
#pragma once

#include "mma.cuh"

namespace {

enum : int { V_K2 = 2, V_K3 = 3, V_K9 = 9, V_K10A = 10, V_K10B = 11 };

constexpr float LN_EPS = 1e-5f;
constexpr float Q_EPS = 1e-8f;
constexpr int ROW_THREADS = 256;   // xquant: 8 warps, one row each

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// round half to even, as jnp.round; a true division, as JAX divides
__device__ __forceinline__ int quant8(float v, float s) {
  return (int)fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

// The per-row prologue: xf = AdaLN(x_r) = LN(x_r) * (1 + scale[b]) +
// shift[b] when adaln (b = r / n_tok; LN two-pass, eps 1e-5), else x_r, in
// fp32; then xq = round(xf / s_x), s_x = max(|xf|, 1e-8) / 127 -> xq (M, K)
// int8, sx (M) fp32. Row r of x starts at x + (r / n_tok) * sample_stride +
// (r % n_tok) * K, so a per-sample slice of a longer sequence is read in
// place. x is of T: bf16, or fp32 (the fp32 instances of K2, K3, K9).
// grid ceil(M / 8), ROW_THREADS threads.
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_float(float v) { return v; }

template <int V, typename T = bf16>
__global__ void __launch_bounds__(ROW_THREADS)
xquant_kernel(const T* __restrict__ x, long long sample_stride,
              const float* __restrict__ shift, const float* __restrict__ scale,
              int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K,
              int n_tok, int adaln) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp leaves together
  const size_t b = row / n_tok;
  const T* xr = x + b * sample_stride + (size_t)(row % n_tok) * K;
  float mean = 0.f, rstd = 1.f;
  const float* sh = shift;
  const float* sc = scale;
  if (adaln) {
    float s = 0.f;
    for (int j = lane; j < K; j += 32) s += to_float(xr[j]);
    mean = warp_sum(s) / K;
    float v = 0.f;
    for (int j = lane; j < K; j += 32) {
      const float d = to_float(xr[j]) - mean;
      v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / K + LN_EPS);
    sh += b * K;
    sc += b * K;
  }
  auto val = [&](int j) {
    float f = to_float(xr[j]);
    if (adaln) f = (f - mean) * rstd * (1.f + sc[j]) + sh[j];
    return f;
  };
  float amax = 0.f;
  for (int j = lane; j < K; j += 32) amax = fmaxf(amax, fabsf(val(j)));
  const float s = fmaxf(warp_max(amax), Q_EPS) / 127.f;
  int8_t* qr = xq + (size_t)row * K;
  for (int j = lane; j < K; j += 32) qr[j] = (int8_t)quant8(val(j), s);
  if (lane == 0) sx[row] = s;
}

template <int V, typename T = bf16>
int launch_xquant(const void* x, long long sample_stride, const void* shift,
                  const void* scale, void* xq, void* sx, int M, int K,
                  int n_tok, int adaln, cudaStream_t st) {
  xquant_kernel<V, T><<<(M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32),
                        ROW_THREADS, 0, st>>>(
      static_cast<const T*>(x), sample_stride,
      static_cast<const float*>(shift), static_cast<const float*>(scale),
      static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, n_tok, adaln);
  return (int)cudaGetLastError();
}

}  // namespace
