// Device code of the int8 (w8a8) kernels (fused_mlp.cu: K2, K3, K9;
// fused_dense.cu: K10a, K10b): reductions, the rounding of JAX's
// `_quantize_rows`, the per-row activation prologue every one of them
// starts with, and the int8 ldmatrix fragments of K-contiguous
// shared-memory tiles of the mma.sync ones (K10a, K10b).
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
constexpr int BK = 64;             // K bytes per shared-memory tile
constexpr int SK = BK + 16;        // padded row stride: conflict-free ldmatrix

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

// Four 8x16-byte matrices; lane l gives the address of row (l & 7) of
// matrix (l >> 3); each lane receives 4 consecutive bytes of one row per
// matrix: exactly the s8 fragment layout of m16n8k32.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const int8_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// A fragment (16 rows x 32 bytes at k offset kb) of a row-major tile with
// stride SK: matrices (rows 0-7, k 0-15), (8-15, 0-15), (0-7, 16-31),
// (8-15, 16-31) are registers a0..a3.
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const int8_t* tile,
                                       int row0, int kb, int lane) {
  ldsm_x4(a, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * SK + kb +
                 (lane >> 4) * 16);
}

// B fragments of two n8 tiles (rows n0..n0+15 of a K-contiguous tile):
// b[0], b[1] for rows n0..n0+7, b[2], b[3] for rows n0+8..n0+15.
__device__ __forceinline__ void load_b2(uint32_t (&b)[4], const int8_t* tile,
                                        int n0, int kb, int lane) {
  ldsm_x4(b, tile + (n0 + (lane >> 4) * 8 + (lane & 7)) * SK + kb +
                 ((lane >> 3) & 1) * 16);
}

// The per-row prologue: xf = AdaLN(x_r) = LN(x_r) * (1 + scale[b]) +
// shift[b] when adaln (b = r / n_tok; LN two-pass, eps 1e-5), else x_r, in
// fp32; then xq = round(xf / s_x), s_x = max(|xf|, 1e-8) / 127 -> xq (M, K)
// int8, sx (M) fp32. Row r of x starts at x + (r / n_tok) * sample_stride +
// (r % n_tok) * K, so a per-sample slice of a longer sequence (K10b's
// attention output) is read in place. grid ceil(M / 8), ROW_THREADS threads.
template <int V>
__global__ void __launch_bounds__(ROW_THREADS)
xquant_kernel(const bf16* __restrict__ x, long long sample_stride,
              const float* __restrict__ shift, const float* __restrict__ scale,
              int8_t* __restrict__ xq, float* __restrict__ sx, int M, int K,
              int n_tok, int adaln) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (ROW_THREADS / 32) + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp leaves together
  const size_t b = row / n_tok;
  const bf16* xr = x + b * sample_stride + (size_t)(row % n_tok) * K;
  float mean = 0.f, rstd = 1.f;
  const float* sh = shift;
  const float* sc = scale;
  if (adaln) {
    float s = 0.f;
    for (int j = lane; j < K; j += 32) s += __bfloat162float(xr[j]);
    mean = warp_sum(s) / K;
    float v = 0.f;
    for (int j = lane; j < K; j += 32) {
      const float d = __bfloat162float(xr[j]) - mean;
      v += d * d;
    }
    rstd = rsqrtf(warp_sum(v) / K + LN_EPS);
    sh += b * K;
    sc += b * K;
  }
  auto val = [&](int j) {
    float f = __bfloat162float(xr[j]);
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

template <int V>
int launch_xquant(const void* x, long long sample_stride, const void* shift,
                  const void* scale, void* xq, void* sx, int M, int K,
                  int n_tok, int adaln, cudaStream_t st) {
  xquant_kernel<V><<<(M + ROW_THREADS / 32 - 1) / (ROW_THREADS / 32),
                     ROW_THREADS, 0, st>>>(
      static_cast<const bf16*>(x), sample_stride,
      static_cast<const float*>(shift), static_cast<const float*>(scale),
      static_cast<int8_t*>(xq), static_cast<float*>(sx), M, K, n_tok, adaln);
  return (int)cudaGetLastError();
}

}  // namespace
