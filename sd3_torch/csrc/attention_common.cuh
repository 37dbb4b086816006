// What the fused-attention kernels share (attention_sm90.cu: K1, K7;
// attention_int8_sm90.cu: K4, K8b; stream_attention.cu: K7q, K8a): the q /
// k prep (per-head RMSNorm and the folded-weight interleaved-pair rotation),
// int8 rounding, the prep launches of q (bf16, or int8 per row), of K (bf16
// with its statistics, int8 per (b, h) or per row) and of V (int8 per
// column, V^T in the key order of an s8 A fragment), and the tiling of the
// mma.sync kernels (K7q, K8a; INT8_KEY_TILE in ops/fused_attention.py is
// BK).
#pragma once

#include "mma.cuh"

namespace {

constexpr int BQ = 64;          // query rows per mma.sync attention block
constexpr int BK = 64;          // key rows per shared-memory tile
constexpr int WARPS = 4;        // 16 query rows per warp
constexpr int THREADS = WARPS * 32;
constexpr int PREP_THREADS = 256;
constexpr int PREP_ROWS = 64;   // K rows per k_prep block

// Row geometry of the prep: TPR threads share one row of D values, each
// owning PPT adjacent (even, odd) pairs; a warp covers RPW rows at a time.
template <int D>
struct Geom {
  static constexpr int PAIRS = D / 2;
  static constexpr int TPR = PAIRS < 32 ? PAIRS : 32;
  static constexpr int PPT = PAIRS / TPR;
  static constexpr int RPW = 32 / TPR;
};

template <int TPR>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// RMSNorm + folded rotation of one row. All 32 lanes of the warp must call
// it (it shuffles); lanes of an invalid row load nothing and return zeros.
// out[2i], out[2i+1] is pair (sub + i*TPR); returns ||out||^2 of the row.
template <int D>
__device__ __forceinline__ float prep_row(const bf16* __restrict__ x,
                                          const float* __restrict__ c,
                                          const float* __restrict__ s,
                                          float eps, int sub, bool valid,
                                          float (&out)[2 * Geom<D>::PPT]) {
  using G = Geom<D>;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < G::PPT; ++i) {
    float2 f = make_float2(0.f, 0.f);
    if (valid)
      f = __bfloat1622float2(
          reinterpret_cast<const __nv_bfloat162*>(x)[sub + i * G::TPR]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
    ss += f.x * f.x + f.y * f.y;
  }
  ss = group_sum<G::TPR>(ss);
  const float r = rsqrtf(ss / D + eps);
  float nn = 0.f;
#pragma unroll
  for (int i = 0; i < G::PPT; ++i) {
    const int j = 2 * (sub + i * G::TPR);
    float c0 = 0.f, c1 = 0.f, s0 = 0.f, s1 = 0.f;
    if (valid) {
      c0 = c[j]; c1 = c[j + 1]; s0 = s[j]; s1 = s[j + 1];
    }
    const float a = out[2 * i] * r, b = out[2 * i + 1] * r;
    out[2 * i] = a * c0 - b * s0;
    out[2 * i + 1] = b * c1 + a * s1;
    nn += out[2 * i] * out[2 * i] + out[2 * i + 1] * out[2 * i + 1];
  }
  return group_sum<G::TPR>(nn);
}

template <int TPR>
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int o = TPR / 2; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// round half to even, as jnp.round; a true division, as JAX divides
__device__ __forceinline__ int quant8(float v, float s) {
  return (int)fminf(fmaxf(rintf(v / s), -127.f), 127.f);
}

// grid (ceil(N / PREP_ROWS), B*H), PREP_THREADS threads. k_max2 receives
// max ||k^||^2 per (b, h) (K1), or with AMAX max |bf16(k^)| (K4).
template <int D, bool AMAX>
__global__ void __launch_bounds__(PREP_THREADS)
k_prep_kernel(const bf16* __restrict__ k, const float* __restrict__ ck,
              const float* __restrict__ sk, bf16* __restrict__ k_out,
              float* __restrict__ k_max2, int N, int H, float eps) {
  using G = Geom<D>;
  constexpr int ROWS_PER_ITER = (PREP_THREADS / 32) * G::RPW;
  static_assert(PREP_ROWS % ROWS_PER_ITER == 0, "prep rows");
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % G::TPR;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
  float mx = 0.f;
#pragma unroll
  for (int r0 = 0; r0 < PREP_ROWS; r0 += ROWS_PER_ITER) {
    const int n = blockIdx.x * PREP_ROWS + r0 + warp * G::RPW + lane / G::TPR;
    const bool valid = n < N;
    const size_t nn = valid ? (size_t)n : 0;
    float out[2 * G::PPT];
    const float ss = prep_row<D>(k + base + nn * rs, ck + nn * D, sk + nn * D,
                                 eps, sub, valid, out);
    if (valid) {
      __nv_bfloat162* dst = reinterpret_cast<__nv_bfloat162*>(k_out + base + nn * rs);
#pragma unroll
      for (int i = 0; i < G::PPT; ++i) {
        const __nv_bfloat162 kb = __floats2bfloat162_rn(out[2 * i], out[2 * i + 1]);
        dst[sub + i * G::TPR] = kb;
        if constexpr (AMAX) {
          const float2 r = __bfloat1622float2(kb);
          mx = fmaxf(mx, fmaxf(fabsf(r.x), fabsf(r.y)));
        }
      }
      if constexpr (!AMAX) mx = fmaxf(mx, ss);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  __shared__ float wmax[PREP_THREADS / 32];
  if (lane == 0) wmax[warp] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = 0.f;
    for (int w = 0; w < PREP_THREADS / 32; ++w) m = fmaxf(m, wmax[w]);
    atomicMax(reinterpret_cast<int*>(k_max2 + bh), __float_as_int(m));
  }
}

// ---- K4 prep, also K8a's over K4 scores ------------------------------

constexpr int QUANT_THREADS = 256;

// int8 k^ from the bf16 k^, 8 values per thread (D is a multiple of 8, so
// they share a head). grid ceil(B*N*H*D / (8 * QUANT_THREADS)).
__global__ void __launch_bounds__(QUANT_THREADS)
k_quant_kernel(const bf16* __restrict__ kp, const float* __restrict__ k_amax,
               int8_t* __restrict__ kq, size_t total, int N, int H, int D) {
  const size_t e0 = ((size_t)blockIdx.x * QUANT_THREADS + threadIdx.x) * 8;
  if (e0 >= total) return;
  const size_t hd = (size_t)H * D;
  const size_t b = e0 / (hd * N);
  const int h = (int)((e0 % hd) / D);
  const float s = fmaxf(k_amax[b * H + h], 1e-12f) / 127.f;
  const uint4 raw = *reinterpret_cast<const uint4*>(kp + e0);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint32_t packed[2];
#pragma unroll
  for (int w = 0; w < 2; ++w) {
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const float2 f = __bfloat1622float2(v2[w * 2 + i]);
      word |= (uint32_t)(quant8(f.x, s) & 0xff) << (16 * i);
      word |= (uint32_t)(quant8(f.y, s) & 0xff) << (16 * i + 8);
    }
    packed[w] = word;
  }
  *reinterpret_cast<uint2*>(kq + e0) = make_uint2(packed[0], packed[1]);
}

// ---- the q prep of K1, K7 and K8b over K7's scores ----------------------

// grid (ceil(N / PREP_ROWS), B*H), PREP_THREADS threads: q^ in bf16 in the
// input layout (k_prep_kernel's work on q) and, with NORMS, ||q^|| of every
// row from the fp32 prep, (B*H, N).
template <int D, bool NORMS>
__global__ void __launch_bounds__(PREP_THREADS)
q_prep_kernel(const bf16* __restrict__ q, const float* __restrict__ cq,
              const float* __restrict__ sq, bf16* __restrict__ q_out,
              float* __restrict__ q_norm, int N, int H, float eps) {
  using G = Geom<D>;
  constexpr int ROWS_PER_ITER = (PREP_THREADS / 32) * G::RPW;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % G::TPR;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
#pragma unroll
  for (int r0 = 0; r0 < PREP_ROWS; r0 += ROWS_PER_ITER) {
    const int n = blockIdx.x * PREP_ROWS + r0 + warp * G::RPW + lane / G::TPR;
    const bool valid = n < N;
    const size_t nn = valid ? (size_t)n : 0;
    float out[2 * G::PPT];
    const float ss = prep_row<D>(q + base + nn * rs, cq + nn * D, sq + nn * D,
                                 eps, sub, valid, out);
    if (valid) {
      __nv_bfloat162* dst =
          reinterpret_cast<__nv_bfloat162*>(q_out + base + nn * rs);
#pragma unroll
      for (int i = 0; i < G::PPT; ++i)
        dst[sub + i * G::TPR] = __floats2bfloat162_rn(out[2 * i], out[2 * i + 1]);
      if (NORMS && sub == 0) q_norm[(size_t)bh * N + n] = sqrtf(ss);
    }
  }
}

// ---- per-row int8 prep: K4's q^, K7q's k^, K8b's q^ and k^ over K7q -----

// grid (ceil(N / PREP_ROWS), B*H), PREP_THREADS threads: the fp32 prep of
// every row of x (q or k, with its tables), quantized per row (per head):
// x_q (B, N, H*D) int8 and x_scale (B*H, ss) fp32 (ss >= N: a row stride
// that a tensor map of the scales may need), max(|x^_row|, 1e-12) / 127.
// TAG is the number of the TPU kernel the launch serves (4: K4, 7:
// K7q, 8: K8b), so that a profile tells its launches apart.
template <int D, int TAG>
__global__ void __launch_bounds__(PREP_THREADS)
prep_q8rows_kernel(const bf16* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ s, int8_t* __restrict__ x_q,
                   float* __restrict__ x_scale, int N, int H, int ss,
                   float eps) {
  using G = Geom<D>;
  constexpr int ROWS_PER_ITER = (PREP_THREADS / 32) * G::RPW;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % G::TPR;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
#pragma unroll
  for (int r0 = 0; r0 < PREP_ROWS; r0 += ROWS_PER_ITER) {
    const int n = blockIdx.x * PREP_ROWS + r0 + warp * G::RPW + lane / G::TPR;
    const bool valid = n < N;
    const size_t nn = valid ? (size_t)n : 0;
    float out[2 * G::PPT];
    prep_row<D>(x + base + nn * rs, c + nn * D, s + nn * D, eps, sub, valid,
                out);
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < 2 * G::PPT; ++i) amax = fmaxf(amax, fabsf(out[i]));
    const float sc = fmaxf(group_max<G::TPR>(amax), 1e-12f) / 127.f;
    if (valid) {
      char2* dst = reinterpret_cast<char2*>(x_q + base + nn * rs);
#pragma unroll
      for (int i = 0; i < G::PPT; ++i)
        dst[sub + i * G::TPR] = make_char2((signed char)quant8(out[2 * i], sc),
                                           (signed char)quant8(out[2 * i + 1], sc));
      if (sub == 0) x_scale[(size_t)bh * ss + n] = sc;
    }
  }
}

// ---- V prep of int8 P.V (K8a, K8b) ------------------------------------

constexpr float LOG2_127 = 6.988684686772166f;
constexpr int V_ROWS = 64;  // rows per v_amax block, keys per v_quant block

// Key order of V^T within a 32-key chunk: position kappa holds key
// v_perm(kappa). The A fragment of an s8 product over 32 keys, per warp of
// 16 rows (mma.sync m16n8k32, and wgmma m64nNk32 with A from registers,
// whose per-warp fragment is the same), gives thread (g, t) bytes kappa =
// 4t..4t+3 (and 16 + 4t..) of rows g, g + 8; the score accumulators (of
// either instruction) hold keys 8j + 2t, 8j + 2t + 1 of 8-key groups j.
// With kappa = 16 h + 4 t + i  <->  key 16 h + 8 (i >> 1) + 2 t + (i & 1),
// the A register of rows g (g + 8) for half h packs groups 2h and 2h + 1 of
// the chunk as they are, and the V^T rows of a tile stay contiguous (for
// ldmatrix, or as the K-major B of a wgmma).
__host__ __device__ __forceinline__ int v_perm(int kappa) {
  const int h = kappa >> 4, t = (kappa >> 2) & 3, i = kappa & 3;
  return 16 * h + 8 * (i >> 1) + 2 * t + (i & 1);
}

// max |v| per (b, column) of (B, N, H*D) v over all rows into v_amax
// (B, H*D), zero on entry. grid (ceil(N / V_ROWS), B), 256 threads, each a
// bf16 pair of columns at a time.
__global__ void __launch_bounds__(256)
v_amax_kernel(const bf16* __restrict__ v, float* __restrict__ v_amax, int N,
              int HD) {
  const int b = blockIdx.y, n0 = blockIdx.x * V_ROWS;
  const int n1 = min(n0 + V_ROWS, N);
  for (int p = threadIdx.x; p < HD / 2; p += blockDim.x) {
    float m0 = 0.f, m1 = 0.f;
    for (int n = n0; n < n1; ++n) {
      const float2 f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
          v + ((size_t)b * N + n) * HD)[p]);
      m0 = fmaxf(m0, fabsf(f.x));
      m1 = fmaxf(m1, fabsf(f.y));
    }
    int* dst = reinterpret_cast<int*>(v_amax + (size_t)b * HD + 2 * p);
    atomicMax(dst, __float_as_int(m0));
    atomicMax(dst + 1, __float_as_int(m1));
  }
}

// V^T in int8: v_q[bh][d][np keys], kappa-ordered within each 32-key chunk,
// keys past N zero; np (a multiple of V_ROWS) is the attention's padded
// length. grid (np / V_ROWS, B*H), 256 threads; each writes 4 bytes.
template <int D>
__global__ void __launch_bounds__(256)
v_quant_kernel(const bf16* __restrict__ v, const float* __restrict__ v_amax,
               int8_t* __restrict__ v_q, int N, int H, int np) {
  __shared__ float sv[V_ROWS][D + 1];
  __shared__ float sc[D];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, t = blockIdx.x;
  const size_t rs = (size_t)H * D;
  for (int i = threadIdx.x; i < V_ROWS * D / 2; i += blockDim.x) {
    const int r = i / (D / 2), p = i % (D / 2), n = t * V_ROWS + r;
    float2 f = make_float2(0.f, 0.f);
    if (n < N)
      f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(
          v + (size_t)b * N * rs + (size_t)n * rs + (size_t)h * D)[p]);
    sv[r][2 * p] = f.x;
    sv[r][2 * p + 1] = f.y;
  }
  if (threadIdx.x < D)
    sc[threadIdx.x] = fmaxf(v_amax[(size_t)bh * D + threadIdx.x], 1e-12f) / 127.f;
  __syncthreads();
  for (int w = threadIdx.x; w < D * V_ROWS / 4; w += blockDim.x) {
    const int d = w / (V_ROWS / 4), kap = (w % (V_ROWS / 4)) * 4;  // 4 bytes
    const int chunk = kap & ~31;
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = chunk + v_perm((kap & 31) + i);
      word |= (uint32_t)(quant8(sv[r][d], sc[d]) & 0xff) << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(v_q + ((size_t)bh * D + d) * np +
                                 t * V_ROWS + kap) = word;
  }
}

// The V prep of int8 P.V: v_amax (B*H, D) fp32, zero on entry; v_q (B*H,
// D, np) int8. The CUDA error code.
template <int D>
int launch_v_prep(const void* v, void* v_amax, void* v_q, int B, int N,
                  int H, int np, cudaStream_t st) {
  dim3 g1((N + V_ROWS - 1) / V_ROWS, B);
  v_amax_kernel<<<g1, 256, 0, st>>>(static_cast<const bf16*>(v),
                                    static_cast<float*>(v_amax), N, H * D);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  dim3 g2(np / V_ROWS, B * H);
  v_quant_kernel<D><<<g2, 256, 0, st>>>(static_cast<const bf16*>(v),
                                        static_cast<const float*>(v_amax),
                                        static_cast<int8_t*>(v_q), N, H, np);
  return (int)cudaGetLastError();
}

// ---- host side ----------------------------------------------------------

// k_prep_kernel over every K row of (B, N, H*D) k; the CUDA error code.
template <int D, bool AMAX>
int launch_k_prep(const void* k, const void* ck, const void* sk, void* k_out,
                  void* k_stat, int B, int N, int H, float eps,
                  cudaStream_t st) {
  dim3 g((N + PREP_ROWS - 1) / PREP_ROWS, B * H);
  k_prep_kernel<D, AMAX><<<g, PREP_THREADS, 0, st>>>(
      static_cast<const bf16*>(k), static_cast<const float*>(ck),
      static_cast<const float*>(sk), static_cast<bf16*>(k_out),
      static_cast<float*>(k_stat), N, H, eps);
  return (int)cudaGetLastError();
}

// K4's int8 k^: the bf16 prep with max |bf16(k^)| per (b, h) into k_amax
// (zero on entry), then the int8 values with one scale per (b, h).
template <int D>
int launch_k_prep_q8bh(const void* k, const void* ck, const void* sk,
                       void* k_prep, void* k_q, void* k_amax, int B, int N,
                       int H, float eps, cudaStream_t st) {
  const int e = launch_k_prep<D, true>(k, ck, sk, k_prep, k_amax, B, N, H,
                                       eps, st);
  if (e != 0) return e;
  const size_t total = (size_t)B * N * H * D;
  const size_t blocks = (total / 8 + QUANT_THREADS - 1) / QUANT_THREADS;
  k_quant_kernel<<<(unsigned)blocks, QUANT_THREADS, 0, st>>>(
      static_cast<const bf16*>(k_prep), static_cast<const float*>(k_amax),
      static_cast<int8_t*>(k_q), total, N, H, D);
  return (int)cudaGetLastError();
}

}  // namespace
