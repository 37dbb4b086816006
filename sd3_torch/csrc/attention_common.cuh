// What the fused-attention kernels share (attention_sm90.cu: K1, K7;
// attention_int8_sm90.cu: K4, K7q, K8a, K8b; attention_fp32.cu: the fp32
// K1, K7): the q / k prep (per-head RMSNorm and the folded-weight
// interleaved-pair rotation, in fp32 from bf16 or fp32 rows), int8
// rounding, the prep launches of q (bf16 or fp32, or int8 per row), of K
// (bf16 or fp32 with its statistics, int8 per (b, h) or per row) and of V
// (int8 per column, V^T in the key order of an s8 A fragment). Every prep
// is a template on the element type T of the rows it reads (bf16 by
// default; fp32 for the fp32 instances of attention_fp32.cu).
//
// Every prep takes the head dim D of its instance and dn, the head dim of
// the model: a head of dn < D values (2, 4 or 8, run at D = 16) arrives
// zero-padded to D, with its tables zero-padded too, and the RMSNorm
// divides its sum of squares by dn, so the mean is the true head's; the
// padded lanes stay zero through the rotation (their tables are zero).
#pragma once

#include <type_traits>

#include "mma.cuh"

namespace {

constexpr int PREP_THREADS = 256;
constexpr int PREP_ROWS = 64;   // K rows per k_prep block

// Rows a prep block takes at head dim D: PREP_ROWS, but from D = 256 on,
// where a warp takes one row at a time, one row a warp. A model of heads
// of 256 has few of them (five at width 1280): 64-row blocks gave 190
// blocks at B 2, N 1178, each looping over 8 rows in turn, too few to hide
// the loads' latency (q_prep 12 us, k_prep 21 us for 6 MB each way).
template <int D>
__host__ __device__ constexpr int prep_rows() {
  return D >= 256 ? PREP_THREADS / 32 : PREP_ROWS;
}

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

// pair i of a row of bf16 or fp32 values, in fp32; and its store
__device__ __forceinline__ float2 load_pair(const bf16* x, int i) {
  return __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(x)[i]);
}
__device__ __forceinline__ float2 load_pair(const float* x, int i) {
  return reinterpret_cast<const float2*>(x)[i];
}
__device__ __forceinline__ void store_pair(bf16* x, int i, float a, float b) {
  reinterpret_cast<__nv_bfloat162*>(x)[i] = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store_pair(float* x, int i, float a, float b) {
  reinterpret_cast<float2*>(x)[i] = make_float2(a, b);
}

// 8 values of bf16 or fp32 from a 16-byte aligned address, in fp32
__device__ __forceinline__ void load8(const bf16* p, float (&f)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(v2[i]);
    f[2 * i] = x.x;
    f[2 * i + 1] = x.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float (&f)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  f[0] = a.x; f[1] = a.y; f[2] = a.z; f[3] = a.w;
  f[4] = b.x; f[5] = b.y; f[6] = b.z; f[7] = b.w;
}

// RMSNorm (the mean over dn values: the sum of squares times inv_dn = 1 /
// dn, exact for the powers of two head dims are) + folded rotation of one
// row of bf16 or fp32 values. All 32 lanes of the warp must call it (it
// shuffles); lanes of an invalid row load nothing and return zeros.
// out[2i], out[2i+1] is pair (sub + i*TPR); returns ||out||^2 of the row.
template <int D, typename T>
__device__ __forceinline__ float prep_row(const T* __restrict__ x,
                                          const float* __restrict__ c,
                                          const float* __restrict__ s,
                                          float eps, float inv_dn, int sub,
                                          bool valid,
                                          float (&out)[2 * Geom<D>::PPT]) {
  using G = Geom<D>;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < G::PPT; ++i) {
    float2 f = make_float2(0.f, 0.f);
    if (valid) f = load_pair(x, sub + i * G::TPR);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
    ss += f.x * f.x + f.y * f.y;
  }
  ss = group_sum<G::TPR>(ss);
  const float r = rsqrtf(ss * inv_dn + eps);
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

// grid (ceil(N / prep_rows<D>()), B*H), PREP_THREADS threads: k^ in k's type
// (bf16 or fp32). k_max2 receives max ||k^||^2 per (b, h) (K1), or with
// AMAX max |k^| of k^ rounded to T (K4).
template <int D, bool AMAX, typename T = bf16>
__global__ void __launch_bounds__(PREP_THREADS)
k_prep_kernel(const T* __restrict__ k, const float* __restrict__ ck,
              const float* __restrict__ sk, T* __restrict__ k_out,
              float* __restrict__ k_max2, int N, int H, float eps, int dn) {
  using G = Geom<D>;
  const float inv_dn = 1.f / dn;
  constexpr int ROWS_PER_ITER = (PREP_THREADS / 32) * G::RPW;
  static_assert(prep_rows<D>() % ROWS_PER_ITER == 0, "prep rows");
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % G::TPR;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
  float mx = 0.f;
#pragma unroll
  for (int r0 = 0; r0 < prep_rows<D>(); r0 += ROWS_PER_ITER) {
    const int n = blockIdx.x * prep_rows<D>() + r0 + warp * G::RPW + lane / G::TPR;
    const bool valid = n < N;
    const size_t nn = valid ? (size_t)n : 0;
    float out[2 * G::PPT];
    const float ss = prep_row<D>(k + base + nn * rs, ck + nn * D, sk + nn * D,
                                 eps, inv_dn, sub, valid, out);
    if (valid) {
      T* dst = k_out + base + nn * rs;
#pragma unroll
      for (int i = 0; i < G::PPT; ++i) {
        store_pair(dst, sub + i * G::TPR, out[2 * i], out[2 * i + 1]);
        if constexpr (AMAX) {
          const float2 r = load_pair(dst, sub + i * G::TPR);
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

// ---- K4's K prep, also K8a's over K4's scores ------------------------

constexpr int QUANT_THREADS = 256;

// int8 k^ from the k^ of T (bf16 or fp32), 8 values per thread (D is a
// multiple of 8, so they share a head). grid ceil(B*N*H*D / (8 *
// QUANT_THREADS)).
template <typename T = bf16>
__global__ void __launch_bounds__(QUANT_THREADS)
k_quant_kernel(const T* __restrict__ kp, const float* __restrict__ k_amax,
               int8_t* __restrict__ kq, size_t total, int N, int H, int D) {
  const size_t e0 = ((size_t)blockIdx.x * QUANT_THREADS + threadIdx.x) * 8;
  if (e0 >= total) return;
  const size_t hd = (size_t)H * D;
  const size_t b = e0 / (hd * N);
  const int h = (int)((e0 % hd) / D);
  const float s = fmaxf(k_amax[b * H + h], 1e-12f) / 127.f;
  float f[8];
  load8(kp + e0, f);
  uint32_t packed[2] = {0u, 0u};
#pragma unroll
  for (int e = 0; e < 8; ++e)
    packed[e / 4] |= (uint32_t)(quant8(f[e], s) & 0xff) << (8 * (e % 4));
  *reinterpret_cast<uint2*>(kq + e0) = make_uint2(packed[0], packed[1]);
}

// ---- the q prep of K1, K7, K8a and K8b over bf16 scores -----------------

// grid (ceil(N / prep_rows<D>()), B*H), PREP_THREADS threads: q^ in q's type
// (bf16 or fp32) in the input layout (k_prep_kernel's work on q) and, with
// NORMS, ||q^|| of every row from the fp32 prep, (B*H, N).
template <int D, bool NORMS, typename T = bf16>
__global__ void __launch_bounds__(PREP_THREADS)
q_prep_kernel(const T* __restrict__ q, const float* __restrict__ cq,
              const float* __restrict__ sq, T* __restrict__ q_out,
              float* __restrict__ q_norm, int N, int H, float eps, int dn) {
  using G = Geom<D>;
  const float inv_dn = 1.f / dn;
  constexpr int ROWS_PER_ITER = (PREP_THREADS / 32) * G::RPW;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % G::TPR;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
#pragma unroll
  for (int r0 = 0; r0 < prep_rows<D>(); r0 += ROWS_PER_ITER) {
    const int n = blockIdx.x * prep_rows<D>() + r0 + warp * G::RPW + lane / G::TPR;
    const bool valid = n < N;
    const size_t nn = valid ? (size_t)n : 0;
    float out[2 * G::PPT];
    const float ss = prep_row<D>(q + base + nn * rs, cq + nn * D, sq + nn * D,
                                 eps, inv_dn, sub, valid, out);
    if (valid) {
      T* dst = q_out + base + nn * rs;
#pragma unroll
      for (int i = 0; i < G::PPT; ++i)
        store_pair(dst, sub + i * G::TPR, out[2 * i], out[2 * i + 1]);
      if (NORMS && sub == 0) q_norm[(size_t)bh * N + n] = sqrtf(ss);
    }
  }
}

// ---- per-row int8 prep: K4's (and K8a's over it) q^, K7q's and K8b's q^
// and k^ ------------------------------------------------------------------

// grid (ceil(N / prep_rows<D>()), B*H), PREP_THREADS threads: the fp32 prep of
// every row of x (q or k, with its tables), quantized per row (per head):
// x_q (B, N, H*D) int8 and x_scale (B*H, ss) fp32 (ss >= N: a row stride
// that a tensor map of the scales may need), max(|x^_row|, 1e-12) / 127.
// TAG is the number of the TPU kernel the launch serves (4: K4 and K8a
// over its scores, 7: K7q, 8: K8b), so that a profile tells its launches
// apart.
template <int D, int TAG, typename T = bf16>
__global__ void __launch_bounds__(PREP_THREADS)
prep_q8rows_kernel(const T* __restrict__ x, const float* __restrict__ c,
                   const float* __restrict__ s, int8_t* __restrict__ x_q,
                   float* __restrict__ x_scale, int N, int H, int ss,
                   float eps, int dn) {
  using G = Geom<D>;
  const float inv_dn = 1.f / dn;
  constexpr int ROWS_PER_ITER = (PREP_THREADS / 32) * G::RPW;
  const int bh = blockIdx.y, b = bh / H, h = bh % H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int sub = lane % G::TPR;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
#pragma unroll
  for (int r0 = 0; r0 < prep_rows<D>(); r0 += ROWS_PER_ITER) {
    const int n = blockIdx.x * prep_rows<D>() + r0 + warp * G::RPW + lane / G::TPR;
    const bool valid = n < N;
    const size_t nn = valid ? (size_t)n : 0;
    float out[2 * G::PPT];
    prep_row<D>(x + base + nn * rs, c + nn * D, s + nn * D, eps, inv_dn, sub,
                valid, out);
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

// ---- V prep of int8 P.V (K8a, K8b) -------------------------------------

constexpr float LOG2_127 = 6.988684686772166f;
constexpr int V_ROWS = 64;  // keys per v_quant block

// Key order of V^T within a 32-key chunk: position kappa holds key
// v_perm(kappa). The A fragment of an s8 product over 32 keys, per warp of
// 16 rows (wgmma m64nNk32 with A from registers, whose per-warp fragment is
// mma.sync m16n8k32's), gives thread (g, t) bytes kappa =
// 4t..4t+3 (and 16 + 4t..) of rows g, g + 8; the score accumulators (of
// either instruction) hold keys 8j + 2t, 8j + 2t + 1 of 8-key groups j.
// With kappa = 16 h + 4 t + i  <->  key 16 h + 8 (i >> 1) + 2 t + (i & 1),
// the A register of rows g (g + 8) for half h packs groups 2h and 2h + 1 of
// the chunk as they are, and the V^T rows of a tile stay contiguous (the
// K-major B of a wgmma).
__host__ __device__ __forceinline__ int v_perm(int kappa) {
  const int h = kappa >> 4, t = (kappa >> 2) & 3, i = kappa & 3;
  return 16 * h + 8 * (i >> 1) + 2 * t + (i & 1);
}

// max |v| per (b, column) of (B, N, H*D) v over all rows into v_amax
// (B, H*D), zero on entry. grid (ceil(N / rows), B), v_amax_threads
// threads, each 8 columns (one 16-byte load a row) of `rows` rows, loads of
// neighbouring threads neighbouring; v 16-byte aligned, H*D a multiple of
// 8. v_amax_rows: at least V_AMAX_ROWS rows a block, and no more than
// ~V_AMAX_BLOCKS blocks, so that each column's atomics stay few (blocks of
// 32 rows at 1024px gave 133 atomics an address, and the kernel ran at a
// third of the memory rate).
constexpr int V_AMAX_ROWS = 32;
constexpr int V_AMAX_BLOCKS = 264;  // two a streaming multiprocessor
inline int v_amax_threads(int HD) {
  const int t = (HD / 8 + 31) / 32 * 32;
  return t < 1024 ? t : 1024;
}
inline int v_amax_rows(int B, int N) {
  const int per_sample = V_AMAX_BLOCKS / B > 1 ? V_AMAX_BLOCKS / B : 1;
  const int rows = (N + per_sample - 1) / per_sample;
  return rows > V_AMAX_ROWS ? rows : V_AMAX_ROWS;
}
template <typename T = bf16>
__global__ void __launch_bounds__(1024)
v_amax_kernel(const T* __restrict__ v, float* __restrict__ v_amax, int N,
              int HD, int rows) {
  const int b = blockIdx.y, n0 = blockIdx.x * rows;
  const int n1 = min(n0 + rows, N);
  for (int c = threadIdx.x; c < HD / 8; c += blockDim.x) {
    float m[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    const T* col = v + (size_t)b * N * HD + c * 8;
#pragma unroll 4
    for (int n = n0; n < n1; ++n) {
      float f[8];
      load8(col + (size_t)n * HD, f);
#pragma unroll
      for (int i = 0; i < 8; ++i) m[i] = fmaxf(m[i], fabsf(f[i]));
    }
    int* dst = reinterpret_cast<int*>(v_amax + (size_t)b * HD + c * 8);
#pragma unroll
    for (int i = 0; i < 8; ++i) atomicMax(dst + i, __float_as_int(m[i]));
  }
}

// Columns of V a v_quant_kernel block takes: the head, or 128-column slices
// of a wider one (its staged rows must fit the 48 KB of static shared
// memory: 64 rows of 256 fp32 values would not).
template <int D>
__host__ __device__ constexpr int v_quant_cols() { return D < 128 ? D : 128; }

// V^T in int8: v_q[bh][d][np keys], kappa-ordered within each 32-key chunk,
// keys past N zero; np (a multiple of V_ROWS) is the attention's padded
// length. grid (np / V_ROWS, B*H, D / v_quant_cols<D>()), 256 threads; each
// writes 4 bytes; block z takes columns z * v_quant_cols<D>() onwards.
template <int D, typename T = bf16>
__global__ void __launch_bounds__(256)
v_quant_kernel(const T* __restrict__ v, const float* __restrict__ v_amax,
               int8_t* __restrict__ v_q, int N, int H, int np) {
  constexpr int DC = v_quant_cols<D>();
  __shared__ float sv[V_ROWS][DC + 1];
  __shared__ float sc[DC];
  const int bh = blockIdx.y, b = bh / H, h = bh % H, t = blockIdx.x;
  const int d0 = blockIdx.z * DC;
  const size_t rs = (size_t)H * D;
  for (int i = threadIdx.x; i < V_ROWS * DC / 2; i += blockDim.x) {
    const int r = i / (DC / 2), p = i % (DC / 2), n = t * V_ROWS + r;
    float2 f = make_float2(0.f, 0.f);
    if (n < N)
      f = load_pair(v + (size_t)b * N * rs + (size_t)n * rs + (size_t)h * D + d0, p);
    sv[r][2 * p] = f.x;
    sv[r][2 * p + 1] = f.y;
  }
  if (threadIdx.x < DC)
    sc[threadIdx.x] =
        fmaxf(v_amax[(size_t)bh * D + d0 + threadIdx.x], 1e-12f) / 127.f;
  __syncthreads();
  for (int w = threadIdx.x; w < DC * V_ROWS / 4; w += blockDim.x) {
    const int d = w / (V_ROWS / 4), kap = (w % (V_ROWS / 4)) * 4;  // 4 bytes
    const int chunk = kap & ~31;
    uint32_t word = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = chunk + v_perm((kap & 31) + i);
      word |= (uint32_t)(quant8(sv[r][d], sc[d]) & 0xff) << (8 * i);
    }
    *reinterpret_cast<uint32_t*>(v_q + ((size_t)bh * D + d0 + d) * np +
                                 t * V_ROWS + kap) = word;
  }
}

// The V prep of int8 P.V: v_amax (B*H, D) fp32, zero on entry; v_q (B*H,
// D, np) int8. The CUDA error code.
template <int D, typename T = bf16>
int launch_v_prep(const void* v, void* v_amax, void* v_q, int B, int N,
                  int H, int np, cudaStream_t st) {
  const int rows = v_amax_rows(B, N);
  dim3 g1((N + rows - 1) / rows, B);
  v_amax_kernel<T><<<g1, v_amax_threads(H * D), 0, st>>>(
      static_cast<const T*>(v), static_cast<float*>(v_amax), N, H * D,
      rows);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  dim3 g2(np / V_ROWS, B * H, D / v_quant_cols<D>());
  v_quant_kernel<D, T><<<g2, 256, 0, st>>>(static_cast<const T*>(v),
                                        static_cast<const float*>(v_amax),
                                        static_cast<int8_t*>(v_q), N, H, np);
  return (int)cudaGetLastError();
}

// ---- host side ----------------------------------------------------------

// k_prep_kernel over every K row of (B, N, H*D) k of T (bf16 or fp32); the
// CUDA error code.
template <int D, bool AMAX, typename T = bf16>
int launch_k_prep(const void* k, const void* ck, const void* sk, void* k_out,
                  void* k_stat, int B, int N, int H, float eps, int dn,
                  cudaStream_t st) {
  dim3 g((N + prep_rows<D>() - 1) / prep_rows<D>(), B * H);
  k_prep_kernel<D, AMAX, T><<<g, PREP_THREADS, 0, st>>>(
      static_cast<const T*>(k), static_cast<const float*>(ck),
      static_cast<const float*>(sk), static_cast<T*>(k_out),
      static_cast<float*>(k_stat), N, H, eps, dn);
  return (int)cudaGetLastError();
}

// q_prep_kernel over every q row of (B, N, H*D) q of T; the CUDA error code.
template <int D, bool NORMS, typename T = bf16>
int launch_q_prep(const void* q, const void* cq, const void* sq, void* q_out,
                  void* q_norm, int B, int N, int H, float eps, int dn,
                  cudaStream_t st) {
  dim3 g((N + prep_rows<D>() - 1) / prep_rows<D>(), B * H);
  q_prep_kernel<D, NORMS, T><<<g, PREP_THREADS, 0, st>>>(
      static_cast<const T*>(q), static_cast<const float*>(cq),
      static_cast<const float*>(sq), static_cast<T*>(q_out),
      static_cast<float*>(q_norm), N, H, eps, dn);
  return (int)cudaGetLastError();
}

// prep_q8rows_kernel<D, TAG> over every row of (B, N, H*D) x; the scales'
// row stride ss; the CUDA error code.
template <int D, int TAG, typename T = bf16>
int launch_q8rows(const void* x, const void* c, const void* s, void* x_q,
                  void* x_scale, int B, int N, int H, int ss, float eps,
                  int dn, cudaStream_t st) {
  dim3 g((N + prep_rows<D>() - 1) / prep_rows<D>(), B * H);
  prep_q8rows_kernel<D, TAG, T><<<g, PREP_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(s), static_cast<int8_t*>(x_q),
      static_cast<float*>(x_scale), N, H, ss, eps, dn);
  return (int)cudaGetLastError();
}

// K4's int8 k^: the prep in T (bf16 or fp32) with max |k^| per (b, h) into
// k_amax (zero on entry), then the int8 values with one scale per (b, h).
template <int D, typename T = bf16>
int launch_k_prep_q8bh(const void* k, const void* ck, const void* sk,
                       void* k_prep, void* k_q, void* k_amax, int B, int N,
                       int H, float eps, int dn, cudaStream_t st) {
  const int e = launch_k_prep<D, true, T>(k, ck, sk, k_prep, k_amax, B, N, H,
                                          eps, dn, st);
  if (e != 0) return e;
  const size_t total = (size_t)B * N * H * D;
  const size_t blocks = (total / 8 + QUANT_THREADS - 1) / QUANT_THREADS;
  k_quant_kernel<T><<<(unsigned)blocks, QUANT_THREADS, 0, st>>>(
      static_cast<const T*>(k_prep), static_cast<const float*>(k_amax),
      static_cast<int8_t*>(k_q), total, N, H, D);
  return (int)cudaGetLastError();
}

}  // namespace
