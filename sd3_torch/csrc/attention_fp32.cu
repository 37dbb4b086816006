// The fp32 instances of the attention kernels for NVIDIA Hopper (sm_90a):
// the joint-attention forwards K1 and K7 (with their q / k prep) and the
// flash-attention forward K5 and backward K6a, K6b, on fp32 q, k, v, o, dO.
//
// Replaces, for fp32 operands (the JAX package's `--dtype float32`, "the
// bit-match gate configuration", and fp32 training), in
// sd3_tpu/ops/fused_attention.py:
//   K1  `_fused_fwd_kernel` (:135), the float branch (fp32 q^, k^, p):
//       attn_fp32_kernel on the fp32 prep;
//   K7  `_stream_fwd_kernel` (:312), the float branch: the same;
// and in sd3_tpu/ops/flash_attention.py:
//   K5  `_fwd_kernel` (:103): attn_fp32_kernel with lse;
//   K6a `_dq_kernel` (:191): dq_fp32_kernel;
//   K6b `_dkv_kernel` (:222): dkv_fp32_kernel.
// The JAX kernels run their fp32 products at Precision.HIGHEST
// (flash_attention.py:87-95, :242; fused_attention.py:95-110), so every
// product here is fp32-accurate: 3xTF32 on the tensor cores. Each operand
// x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a product
// is a_lo b_hi + a_hi b_lo + a_hi b_hi, each an mma.sync m16n8k8 tf32 with
// fp32 accumulation (the a_lo b_lo term, ~2^-22 relative, is left out), one
// k-step of 8 at a time, its sum added to the running one outside the
// tensor cores (mma3): the sums keep ~21 bits against a single TF32 pass's
// ~10.
//
// Numerics: in fp32 the plain versions' roundings to the input dtype (q^,
// k^, p, ds) are the identity, so every kernel computes its plain version's
// function up to the order of its sums. The forward is one online softmax
// over 32-key tiles for all three: K1's bounded shift ||q^|| max ||k^|| is
// a bf16 kernel's device for skipping the rescale; in fp32 it can push p of
// a loosely bounded row into the subnormals, where the running row max
// keeps it exact, and the plain version (torch.softmax, the true row max)
// is what both meet. exp2 is exp2f's (2 ulp); l sums the fp32 p; o = acc /
// l. lse (K5) is (m + log2 l) ln 2 in natural-log units. The backward
// recomputes p = exp2(s scale log2(e) - lse log2(e)) and ds = p (dp -
// delta), delta = rowsum(dO o) computed by K6a and written for K6b, as the
// bf16 kernels do. No atomics: the same bits every run.
//
// Design: a simple kernel that is right. A block of four warps takes 64
// rows (16 a warp) of one head of one sample; tiles of 32 keys (K1, K7, K5,
// K6a) or queries (K6b) are loaded by all its threads into shared memory in
// 16-byte loads, padded rows (a stride of D + 4 or D + 8 floats) keeping
// the mma fragments' loads free of bank conflicts; p and ds go through a
// warp's own 16 x 32 tile of shared memory to become A fragments. No TMA,
// no wgmma, no overlap of loads and products (wgmma's tf32 form reads both
// shared-memory operands K-major only, so P.V and the backward's p^T dO,
// ds^T q would need transposed copies: left for a later redesign).
//
// What bounds them on this card: 3xTF32 is three tf32 products, so the
// tensor cores take 3 * 4 B H N^2 D FLOP (forward) at 495 TFLOP/s; at the
// 512px slice shape (B 8, H 19, N 1178, D 64) that is 162 G FLOP, 0.327
// ms, against 92 MB x 2 of fp32 q, k, v, o (0.055 ms at 3.35 TB/s): the
// products bound it. PERF.md has the measured times.

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int FROWS = 64;            // rows of a block (16 per warp)
constexpr int FTILE = 32;            // keys (queries for K6b) per tile
constexpr int FTHREADS = 128;
constexpr float FLOG2E = 1.4426950408889634f;
constexpr float FLN2 = 0.6931471805599453f;

// mma.sync m16n8k8 tf32: D(16x8, fp32) += A(16x8, row) B(8x8, col). A:
// a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4); B: b0 (k t,
// n g), b1 (k t + 4, n g); D: d0 (g, 2t), d1 (g, 2t + 1), d2 (g + 8, 2t),
// d3 (g + 8, 2t + 1); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo, hi = tf32(x), lo = tf32(x - hi), round to nearest
struct Split {
  uint32_t hi, lo;
};
__device__ __forceinline__ Split split(float x) {
  uint32_t h, l;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(h) : "f"(x));
  const float r = x - __uint_as_float(h);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(l) : "f"(r));
  return Split{h, l};
}

// d += a b in 3xTF32, from the split fragments. The three products of one
// k-step sum in a fresh accumulator, added to d by an FADD: the tensor
// cores round their fp32 accumulation toward zero, which over the N / 8
// k-steps of P.V or of the backward's sums over keys and queries would add
// up to a bias of ~N / 8 ulps (1.5e-5 relative at 2100 keys, measured);
// rounded to nearest outside, the error of a sum grows like its square
// root instead.
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     Split b0, Split b1) {
  const uint32_t ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  const uint32_t al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, b0.hi, b1.hi);
  mma_tf32(t, ah, b0.lo, b1.lo);
  mma_tf32(t, ah, b0.hi, b1.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// The A fragment of k-step ks of a warp's 16 rows at `rows` (row stride
// ld floats)
__device__ __forceinline__ void a_frag(Split (&a)[4], const float* rows,
                                       int ld, int ks, int g, int t) {
  a[0] = split(rows[g * ld + ks * 8 + t]);
  a[1] = split(rows[(g + 8) * ld + ks * 8 + t]);
  a[2] = split(rows[g * ld + ks * 8 + t + 4]);
  a[3] = split(rows[(g + 8) * ld + ks * 8 + t + 4]);
}

// R rows (r0..) of D floats of one head of a (B, H, N, D)-strided tensor
// into shared memory (row stride ld), all threads of the block, zeros for
// rows past N
template <int D, int R>
__device__ __forceinline__ void load_rows_f32(float* dst, int ld,
                                              const float* src, long long sn,
                                              int r0, int N) {
  constexpr int V4 = D / 4;
  for (int i = threadIdx.x; i < R * V4; i += FTHREADS) {
    const int r = i / V4, c = (i % V4) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < N)
      v = *reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * sn + c);
    *reinterpret_cast<float4*>(dst + r * ld + c) = v;
  }
}

// Shared memory of the kernels, in floats
template <int D>
struct F32Smem {
  static constexpr int LDA = D + 4;  // rows read as A or as "n g" B
  static constexpr int LDB = D + 8;  // rows read as "k t" B
  static constexpr int LDP = FTILE + 4;
};

// ---- forward: K1, K7 (fp32) and K5 (fp32) ---------------------------------

// grid (ceil(N / 64), H, B), FTHREADS threads, dynamic shared memory:
// q (64 x LDA), k (32 x LDA), v (32 x LDB), p (4 x 16 x LDP). o = softmax(
// q k^T scale_log2 in exp2) v; scores are s * scale_log2 in exp2 units
// (K1 / K7: q^ carries scale log2(e), scale_log2 = 1). lse (B*H, N) written
// when not null.
template <int D>
__global__ void __launch_bounds__(FTHREADS)
attn_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, View vq,
                 View vk, View vv, View vo, float* __restrict__ lse,
                 float scale_log2, int N, int H) {
  using S = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* ks = qs + FROWS * S::LDA;
  float* vs = ks + FTILE * S::LDA;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* ps = vs + FTILE * S::LDB + warp * 16 * S::LDP;
  const float* qh = q + b * vq.b + h * vq.h;
  const float* kh = k + b * vk.b + h * vk.h;
  const float* vh = v + b * vv.b + h * vv.h;

  load_rows_f32<D, FROWS>(qs, S::LDA, qh, vq.n, q0, N);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* qw = qs + warp * 16 * S::LDA;

  for (int k0 = 0; k0 < N; k0 += FTILE) {
    __syncthreads();  // the last tile's k and v are read
    load_rows_f32<D, FTILE>(ks, S::LDA, kh, vk.n, k0, N);
    load_rows_f32<D, FTILE>(vs, S::LDB, vh, vv.n, k0, N);
    __syncthreads();
    float sc[FTILE / 8][4];
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      Split a[4];
      a_frag(a, qw, S::LDA, kk, g, t);
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j)
        mma3(sc[j], a, split(ks[(j * 8 + g) * S::LDA + kk * 8 + t]),
             split(ks[(j * 8 + g) * S::LDA + kk * 8 + t + 4]));
    }
    // scores in exp2 units, keys past N to -inf; the running max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        sc[j][e] = key < N ? sc[j][e] * scale_log2 : -INFINITY;
        if (e < 2) mx0 = fmaxf(mx0, sc[j][e]);
        else mx1 = fmaxf(mx1, sc[j][e]);
      }
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    // p into this warp's tile, then its A fragments times the V tile
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      const float p0 = exp2f(sc[j][0] - m0), p1 = exp2f(sc[j][1] - m0);
      const float p2 = exp2f(sc[j][2] - m1), p3 = exp2f(sc[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      *reinterpret_cast<float2*>(ps + g * S::LDP + j * 8 + 2 * t) = make_float2(p0, p1);
      *reinterpret_cast<float2*>(ps + (g + 8) * S::LDP + j * 8 + 2 * t) = make_float2(p2, p3);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < FTILE / 8; ++kk) {
      Split a[4];
      a_frag(a, ps, S::LDP, kk, g, t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma3(acc[j], a, split(vs[(kk * 8 + t) * S::LDB + j * 8 + g]),
             split(vs[(kk * 8 + t + 4) * S::LDB + j * 8 + g]));
    }
    __syncwarp();  // p read before the next tile writes it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  float* oh = o + b * vo.b + h * vo.h;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N)
      *reinterpret_cast<float2*>(oh + (size_t)n0 * vo.n + col) =
          make_float2(acc[j][0] * i0, acc[j][1] * i0);
    if (n1 < N)
      *reinterpret_cast<float2*>(oh + (size_t)n1 * vo.n + col) =
          make_float2(acc[j][2] * i1, acc[j][3] * i1);
  }
  if (lse != nullptr && t == 0) {
    float* lh = lse + ((size_t)b * H + h) * N;
    if (n0 < N) lh[n0] = (m0 + log2f(l0)) * FLN2;
    if (n1 < N) lh[n1] = (m1 + log2f(l1)) * FLN2;
  }
}

template <int D>
constexpr int fwd_smem_bytes() {
  using S = F32Smem<D>;
  return (FROWS * S::LDA + FTILE * S::LDA + FTILE * S::LDB + 4 * 16 * S::LDP) * 4;
}

// ---- K6a (fp32): dq, delta -------------------------------------------------

// grid (ceil(N / 64), H, B), FTHREADS threads, dynamic shared memory: q, dO
// (64 x LDA each), k, v (32 x LDA each), ds (4 x 16 x LDP).
template <int D>
__global__ void __launch_bounds__(FTHREADS)
dq_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const float* __restrict__ o,
               const float* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, float* __restrict__ dq, View vq,
               View vk, View vv, View vo, View vdo, View vdq, int N, int H,
               float scale_log2, float scale) {
  using S = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* dos = qs + FROWS * S::LDA;
  float* ks = dos + FROWS * S::LDA;
  float* vs = ks + FTILE * S::LDA;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* ps = vs + FTILE * S::LDA + warp * 16 * S::LDP;
  const float* kh = k + b * vk.b + h * vk.h;
  const float* vh = v + b * vv.b + h * vv.h;
  const size_t bhn = ((size_t)b * H + h) * N;

  load_rows_f32<D, FROWS>(qs, S::LDA, q + b * vq.b + h * vq.h, vq.n, q0, N);
  load_rows_f32<D, FROWS>(dos, S::LDA, dout + b * vdo.b + h * vdo.h, vdo.n,
                          q0, N);
  // delta = rowsum(dO o) of this warp's rows, a row at a time over its
  // lanes; written for K6b
  const float* oh = o + b * vo.b + h * vo.h;
  const float* dh = dout + b * vdo.b + h * vdo.h;
  for (int r = 0; r < 16; ++r) {
    const int n = q0 + warp * 16 + r;
    float sum = 0.f;
    if (n < N)
      for (int c = lane; c < D; c += 32)
        sum += dh[(size_t)n * vdo.n + c] * oh[(size_t)n * vo.n + c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && n < N) delta[bhn + n] = sum;
  }
  __syncthreads();  // delta written, q and dO loaded
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  const float d0 = n0 < N ? delta[bhn + n0] : 0.f;
  const float d1 = n1 < N ? delta[bhn + n1] : 0.f;
  const float L0 = n0 < N ? lse[bhn + n0] * FLOG2E : 0.f;
  const float L1 = n1 < N ? lse[bhn + n1] * FLOG2E : 0.f;
  const float* qw = qs + warp * 16 * S::LDA;
  const float* dw = dos + warp * 16 * S::LDA;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += FTILE) {
    __syncthreads();
    load_rows_f32<D, FTILE>(ks, S::LDA, kh, vk.n, k0, N);
    load_rows_f32<D, FTILE>(vs, S::LDA, vh, vv.n, k0, N);
    __syncthreads();
    float sc[FTILE / 8][4], dp[FTILE / 8][4];
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      Split a[4], ad[4];
      a_frag(a, qw, S::LDA, kk, g, t);
      a_frag(ad, dw, S::LDA, kk, g, t);
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) {
        const int r = (j * 8 + g) * S::LDA + kk * 8 + t;
        mma3(sc[j], a, split(ks[r]), split(ks[r + 4]));
        mma3(dp[j], ad, split(vs[r]), split(vs[r + 4]));
      }
    }
    // ds = p (dp - delta), keys past N with p = 0, into this warp's tile
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p = key < N ? exp2f(sc[j][e] * scale_log2 - (e < 2 ? L0 : L1))
                                : 0.f;
        ds[e] = p * (dp[j][e] - (e < 2 ? d0 : d1));
      }
      *reinterpret_cast<float2*>(ps + g * S::LDP + j * 8 + 2 * t) = make_float2(ds[0], ds[1]);
      *reinterpret_cast<float2*>(ps + (g + 8) * S::LDP + j * 8 + 2 * t) = make_float2(ds[2], ds[3]);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < FTILE / 8; ++kk) {
      Split a[4];
      a_frag(a, ps, S::LDP, kk, g, t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma3(acc[j], a, split(ks[(kk * 8 + t) * S::LDA + j * 8 + g]),
             split(ks[(kk * 8 + t + 4) * S::LDA + j * 8 + g]));
    }
    __syncwarp();
  }

  float* qh = dq + b * vdq.b + h * vdq.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N)
      *reinterpret_cast<float2*>(qh + (size_t)n0 * vdq.n + col) =
          make_float2(acc[j][0] * scale, acc[j][1] * scale);
    if (n1 < N)
      *reinterpret_cast<float2*>(qh + (size_t)n1 * vdq.n + col) =
          make_float2(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  using S = F32Smem<D>;
  return (2 * FROWS * S::LDA + 2 * FTILE * S::LDA + 4 * 16 * S::LDP) * 4;
}

// ---- K6b (fp32): dk, dv ----------------------------------------------------

// grid (ceil(N / 64), H, B): 64 key rows a block, 16 a warp; FTHREADS
// threads, dynamic shared memory: k, v (64 x LDA each), q, dO (32 x LDA
// each), lse, delta of the query tile (32 each), p^T and ds^T (4 x 16 x LDP
// each).
template <int D>
__global__ void __launch_bounds__(FTHREADS)
dkv_fp32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                float* __restrict__ dk, float* __restrict__ dv, View vq,
                View vk, View vv, View vdo, View vdk, View vdv, int N, int H,
                float scale_log2, float scale) {
  using S = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  float* kts = reinterpret_cast<float*>(smem_f4);
  float* vts = kts + FROWS * S::LDA;
  float* qs = vts + FROWS * S::LDA;
  float* dos = qs + FTILE * S::LDA;
  float* ls = dos + FTILE * S::LDA;
  float* dls = ls + FTILE;
  const int h = blockIdx.y, b = blockIdx.z, r0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* pts = dls + FTILE + warp * 2 * 16 * S::LDP;
  float* dss = pts + 16 * S::LDP;
  const float* qh = q + b * vq.b + h * vq.h;
  const float* dh = dout + b * vdo.b + h * vdo.h;
  const size_t bhn = ((size_t)b * H + h) * N;

  load_rows_f32<D, FROWS>(kts, S::LDA, k + b * vk.b + h * vk.h, vk.n, r0, N);
  load_rows_f32<D, FROWS>(vts, S::LDA, v + b * vv.b + h * vv.h, vv.n, r0, N);
  const float* kw = kts + warp * 16 * S::LDA;
  const float* vw = vts + warp * 16 * S::LDA;
  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int c0 = 0; c0 < N; c0 += FTILE) {
    __syncthreads();
    load_rows_f32<D, FTILE>(qs, S::LDA, qh, vq.n, c0, N);
    load_rows_f32<D, FTILE>(dos, S::LDA, dh, vdo.n, c0, N);
    if (threadIdx.x < FTILE) {
      const int n = c0 + threadIdx.x;
      // lse in log2 units, +inf past N so that p = 0 there
      ls[threadIdx.x] = n < N ? lse[bhn + n] * FLOG2E : INFINITY;
      dls[threadIdx.x] = n < N ? delta[bhn + n] : 0.f;
    }
    __syncthreads();
    float sc[FTILE / 8][4], dp[FTILE / 8][4];
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      Split a[4], av[4];
      a_frag(a, kw, S::LDA, kk, g, t);
      a_frag(av, vw, S::LDA, kk, g, t);
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) {
        const int r = (j * 8 + g) * S::LDA + kk * 8 + t;
        mma3(sc[j], a, split(qs[r]), split(qs[r + 4]));
        mma3(dp[j], av, split(dos[r]), split(dos[r + 4]));
      }
    }
    // p^T = exp2(s^T scale log2(e) - lse), ds^T = p^T (dp^T - delta): query
    // column j * 8 + 2t (+1) of key rows g, g + 8
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float la = ls[c], lb = ls[c + 1], da = dls[c], db = dls[c + 1];
      const float p0 = exp2f(sc[j][0] * scale_log2 - la);
      const float p1 = exp2f(sc[j][1] * scale_log2 - lb);
      const float p2 = exp2f(sc[j][2] * scale_log2 - la);
      const float p3 = exp2f(sc[j][3] * scale_log2 - lb);
      *reinterpret_cast<float2*>(pts + g * S::LDP + c) = make_float2(p0, p1);
      *reinterpret_cast<float2*>(pts + (g + 8) * S::LDP + c) = make_float2(p2, p3);
      *reinterpret_cast<float2*>(dss + g * S::LDP + c) =
          make_float2(p0 * (dp[j][0] - da), p1 * (dp[j][1] - db));
      *reinterpret_cast<float2*>(dss + (g + 8) * S::LDP + c) =
          make_float2(p2 * (dp[j][2] - da), p3 * (dp[j][3] - db));
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < FTILE / 8; ++kk) {
      Split ap[4], as[4];
      a_frag(ap, pts, S::LDP, kk, g, t);
      a_frag(as, dss, S::LDP, kk, g, t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int r = (kk * 8 + t) * S::LDA + j * 8 + g;
        mma3(adv[j], ap, split(dos[r]), split(dos[r + 4 * S::LDA]));
        mma3(adk[j], as, split(qs[r]), split(qs[r + 4 * S::LDA]));
      }
    }
    __syncwarp();
  }

  const int n0 = r0 + warp * 16 + g, n1 = n0 + 8;
  float* kh = dk + b * vdk.b + h * vdk.h;
  float* vh = dv + b * vdv.b + h * vdv.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N) {
      *reinterpret_cast<float2*>(kh + (size_t)n0 * vdk.n + col) =
          make_float2(adk[j][0] * scale, adk[j][1] * scale);
      *reinterpret_cast<float2*>(vh + (size_t)n0 * vdv.n + col) =
          make_float2(adv[j][0], adv[j][1]);
    }
    if (n1 < N) {
      *reinterpret_cast<float2*>(kh + (size_t)n1 * vdk.n + col) =
          make_float2(adk[j][2] * scale, adk[j][3] * scale);
      *reinterpret_cast<float2*>(vh + (size_t)n1 * vdv.n + col) =
          make_float2(adv[j][2], adv[j][3]);
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  using S = F32Smem<D>;
  return (2 * FROWS * S::LDA + 2 * FTILE * S::LDA + 2 * FTILE +
          4 * 2 * 16 * S::LDP) * 4;
}

// ---- host side ------------------------------------------------------------

template <typename Kernel>
int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v, float* o,
               View vq, View vk, View vv, View vo, float* lse,
               float scale_log2, int B, int H, int N, cudaStream_t st) {
  auto kernel = attn_fp32_kernel<D>;
  const int e = opt_in(kernel, fwd_smem_bytes<D>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, fwd_smem_bytes<D>(), st>>>(
      q, k, v, o, vq, vk, vv, vo, lse, scale_log2, N, H);
  return (int)cudaGetLastError();
}

// K1 / K7 (fp32): the fp32 q and K preps into q_prep, k_prep, then the
// forward on them (q^ carries scale log2(e)); the first error
template <int D>
int launch_fused_fp32(const void* q, const void* k, const void* v,
                      const void* cq, const void* sq, const void* ck,
                      const void* sk, void* q_prep, void* k_prep,
                      void* k_max2, void* out, int B, int N, int H, int dn,
                      float eps_q, float eps_k, cudaStream_t st) {
  int e = launch_q_prep<D, false, float>(q, cq, sq, q_prep, nullptr, B, N, H,
                                         eps_q, dn, st);
  if (e == 0)
    e = launch_k_prep<D, false, float>(k, ck, sk, k_prep, k_max2, B, N, H,
                                       eps_k, dn, st);  // k_max2: unread
  if (e != 0) return e;
  const View vh{(long long)N * H * D, D, (long long)H * D};
  return launch_fwd<D>(static_cast<const float*>(q_prep),
                       static_cast<const float*>(k_prep),
                       static_cast<const float*>(v), static_cast<float*>(out),
                       vh, vh, vh, vh, nullptr, 1.f, B, H, N, st);
}

int fused_fp32(const void* q, const void* k, const void* v, const void* cq,
               const void* sq, const void* ck, const void* sk, void* q_prep,
               void* k_prep, void* k_max2, void* out, int B, int N, int H,
               int D, int dn, float eps_q, float eps_k, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SD3_FUSED_FP32(DD)                                                   \
  case DD:                                                                   \
    return launch_fused_fp32<DD>(q, k, v, cq, sq, ck, sk, q_prep, k_prep,    \
                                 k_max2, out, B, N, H, dn, eps_q, eps_k, st);
  switch (D) {
    SD3_FUSED_FP32(16)
    SD3_FUSED_FP32(32)
    SD3_FUSED_FP32(64)
    SD3_FUSED_FP32(128)
    default: return (int)cudaErrorInvalidValue;
  }
#undef SD3_FUSED_FP32
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              const long long* st, int B, int H, int N, float scale,
              cudaStream_t stream) {
  auto kernel = dq_fp32_kernel<D>;
  const int e = opt_in(kernel, dq_smem_bytes<D>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, dq_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(o),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<float*>(dq), view_at(st, 0),
      view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
      view_at(st, 5), N, H, scale * FLOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int N, float scale,
               cudaStream_t stream) {
  auto kernel = dkv_fp32_kernel<D>;
  const int e = opt_in(kernel, dkv_smem_bytes<D>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, dkv_smem_bytes<D>(), stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), view_at(st, 0),
      view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
      view_at(st, 5), N, H, scale * FLOG2E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// K1 and K7 in fp32: the signature of attention_sm90.cu's entry points, on
// fp32 q, k, v, out (B, N, H*D) and fp32 scratch q_prep, k_prep; q_norm
// unused, k_max2 (B*H) fp32 zero on entry (written by the K prep, unread).
// D the instance (16, 32, 64, 128), dn <= D the model's head dim
// (attention_common.cuh). Returns 0, or the first cudaError_t.
#define SD3_FP32_PARAMS                                                     \
  const void *q, const void *k, const void *v, const void *cq,              \
      const void *sq, const void *ck, const void *sk, void *q_prep,         \
      void *q_norm, void *k_prep, void *k_max2, void *out, int B, int N,    \
      int H, int D, int dn, float eps_q, float eps_k, void *stream

extern "C" int sd3_fused_attention_fp32(SD3_FP32_PARAMS) {
  (void)q_norm;
  return fused_fp32(q, k, v, cq, sq, ck, sk, q_prep, k_prep, k_max2, out, B,
                    N, H, D, dn, eps_q, eps_k, stream);
}

extern "C" int sd3_fused_attention_stream_fp32(SD3_FP32_PARAMS) {
  (void)q_norm;
  return fused_fp32(q, k, v, cq, sq, ck, sk, q_prep, k_prep, k_max2, out, B,
                    N, H, D, dn, eps_q, eps_k, stream);
}

// K5, K6a, K6b in fp32: the signatures of the bf16 entry points
// (attention_sm90.cu, flash_bwd_sm90.cu), every tensor fp32; views with 16-
// byte aligned starts and (b, h, n) strides.
extern "C" int sd3_flash_attention_fwd_fp32(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            const long long* strides, int B,
                                            int H, int N, int D, float scale,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float *fq = static_cast<const float*>(q), *fk = static_cast<const float*>(k),
              *fv = static_cast<const float*>(v);
  float* fo = static_cast<float*>(o);
  float* fl = static_cast<float*>(lse);
  const View a = view_at(strides, 0), bk = view_at(strides, 1),
             c = view_at(strides, 2), d = view_at(strides, 3);
  const float sl = scale * FLOG2E;
  switch (D) {
    case 16: return launch_fwd<16>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
    case 32: return launch_fwd<32>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
    case 64: return launch_fwd<64>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
    case 128: return launch_fwd<128>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sd3_flash_attention_dq_fp32(const void* q, const void* k,
                                           const void* v, const void* o,
                                           const void* dout, const void* lse,
                                           void* delta, void* dq,
                                           const long long* strides, int B,
                                           int H, int N, int D, float scale,
                                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
    case 32: return launch_dq<32>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
    case 64: return launch_dq<64>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
    case 128: return launch_dq<128>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int sd3_flash_attention_dkv_fp32(const void* q, const void* k,
                                            const void* v, const void* dout,
                                            const void* lse, const void* delta,
                                            void* dk, void* dv,
                                            const long long* strides, int B,
                                            int H, int N, int D, float scale,
                                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
