// The shared-memory mma.sync instances of the attention kernels for NVIDIA
// Hopper (sm_90a):
//   - the fp32 instances of the joint-attention forwards K1 and K7 (with
//     their q / k prep) and of the flash-attention forward K5 and backward
//     K6a, K6b, on fp32 q, k, v, o, dO, at head dims 16-128;
//   - the fp32 instances of the int8 joint attentions K4, K7q, K8a and K8b
//     (fp32 rows under `--dtype float32 --quant int8`);
//   - past head dim 128 the wide instances, one set for every multiple of
//     128 (wide_attn_kernel, wide_dq_kernel, wide_dkv_kernel, with the
//     fused kernels' wide_prep_kernel): every one of these kernels in fp32;
//     in bf16 the flash backward K6a, K6b (flash_bwd_sm90.cu stops at 128)
//     and the forwards past 256 (the wgmma kernels of attention_sm90.cu and
//     attention_int8_sm90.cu take bf16 heads up to 256: K1, K7, K5, K4,
//     K7q, K8a, K8b at D = 256).
//
// Replaces, in sd3_tpu/ops/fused_attention.py:
//   K1  `_fused_fwd_kernel` (:135), the float branch (fp32 q^, k^, p):
//       attn_fp32_kernel on the fp32 prep;
//   K7  `_stream_fwd_kernel` (:312), the float branch: the same;
//   K4  `_fused_fwd_kernel`'s int8_qk branch (:193) on fp32 rows, K8a its
//       int8_pv branch (:181-188, 228-245, 282-309), K7q and K8b the
//       streaming kernel's (:352, :406): attn_q8_fp32_kernel;
// and in sd3_tpu/ops/flash_attention.py:
//   K5  `_fwd_kernel` (:103): attn_fp32_kernel with lse;
//   K6a `_dq_kernel` (:191): dq_fp32_kernel;
//   K6b `_dkv_kernel` (:222): dkv_fp32_kernel;
// past head dim 128 (bf16: the forwards past 512, the backward past 256):
// wide_attn_kernel (the forwards, on wide_prep_kernel's q^ / k^ for K1 ..
// K8b), wide_dq_kernel, wide_dkv_kernel.
// The JAX kernels run their fp32 products at Precision.HIGHEST
// (flash_attention.py:87-95, :242; fused_attention.py:95-110), so every
// fp32 product here is fp32-accurate: 3xTF32 on the tensor cores. Each
// operand x is split into x_hi = tf32(x) and x_lo = tf32(x - x_hi), and a
// product is a_lo b_hi + a_hi b_lo + a_hi b_hi, each an mma.sync m16n8k8
// tf32 with fp32 accumulation (the a_lo b_lo term, ~2^-22 relative, is left
// out), one k-step of 8 at a time, its sum added to the running one outside
// the tensor cores (mma3): the sums keep ~21 bits against a single TF32
// pass's ~10. A bf16 value (8 bits of significand) is exact in tf32 (11),
// so the bf16 instances run one tf32 product a k-step on the bf16 values,
// the exact products of the bf16 kernels' fp32-accumulating ones; p and ds
// are rounded to bf16 before their products, as the plain versions do.
// The int8 products (the int8 QK^T of K4 / K7q, the int8 P.V of K8a / K8b)
// are mma.sync m16n8k32 s8 x s8 -> s32, exact.
//
// Numerics: in fp32 the plain versions' roundings to the input dtype (q^,
// k^, p, ds) are the identity, so every fp32 kernel computes its plain
// version's function up to the order of its sums. The float forward is one
// online softmax over 32-key tiles: K1's bounded shift ||q^|| max ||k^|| is
// a bf16 kernel's device for skipping the rescale; in fp32 it can push p of
// a loosely bounded row into the subnormals, where the running row max
// keeps it exact, and the plain version (torch.softmax, the true row max)
// is what both meet. exp2 is exp2f's (2 ulp); l sums the unrounded p; o =
// acc / l. lse (K5) is (m + log2 l) ln 2 in natural-log units. The backward
// recomputes p = exp2(s scale log2(e) - lse log2(e)) and ds = p (dp -
// delta), delta = rowsum(dO o) computed by K6a and written for K6b, as the
// bf16 kernels do. Int8 P.V quantizes p against a fixed shift, so it cannot
// run online: K8a (the true row max) and K8b (the running max of 128-key
// blocks, K8B_KEY_TILE, which the bf16 kernel and the plain version take)
// run each block twice, its max first, then p = exp2(s - (max - log2 127))
// rounded to [0, 127], summed in s32 over the block and added in fp32. No
// atomics: the same bits every run.
//
// Design: a simple kernel that is right. A block of four warps takes 64
// rows (16 a warp) of one head of one sample; tiles of 32 keys (K1, K7, K5,
// K6a, the int8 kernels) or queries (K6b) are loaded by all its threads into
// shared memory in 16-byte loads, padded rows (a stride of D + 4 or D + 8
// floats, D + 16 bytes of int8) keeping the mma fragments' loads free of
// bank conflicts; p and ds go through a warp's own 16 x 32 tile of shared
// memory to become A fragments (the int8 p of K8a / K8b stays in registers:
// its score accumulators are an A fragment in the key order of V^T's prep,
// attention_common.cuh v_perm). Head dims past 128 (bf16: the forwards
// past 512, the backward past 256) take the wide instances: the scores
// summed over 128-wide chunks of the head, staged through shared memory a
// chunk at a time, and the output's columns split
// into slices of 128, one block each (section "head dims past 128" below),
// so that neither a block's shared memory nor a thread's accumulators grow
// with the head dim. No TMA, no wgmma, no overlap of loads
// and products (wgmma's tf32 form reads both shared-memory operands K-major
// only, so P.V and the backward's p^T dO, ds^T q would need transposed
// copies: left for a later redesign).
//
// What bounds them on this card: 3xTF32 is three tf32 products, so the
// tensor cores take 3 * 4 B H N^2 D FLOP (forward) at 495 TFLOP/s; at the
// 512px slice shape (B 8, H 19, N 1178, D 64) that is 162 G FLOP, 0.327
// ms, against 92 MB x 2 of fp32 q, k, v, o (0.055 ms at 3.35 TB/s): the
// products bound it. The bf16 wide instances: one tf32 pass, 4 B H N^2 D
// at 495 TFLOP/s. The int8 instances: the int8 product at 1,979 TOP/s and
// the fp32 one in 3xTF32. The wide instances re-read q's (and dO's)
// chunks for every key tile: their loads from L2, not overlapped with the
// products, hold them back. PERF.md has the measured times.

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int FROWS = 64;            // rows of a block (16 per warp)
constexpr int FTILE = 32;            // keys (queries for K6b) per tile
constexpr int FTHREADS = 128;
constexpr int PV8_BLOCK = 128;       // K8b's blocks (K8B_KEY_TILE)
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

// mma.sync m16n8k32 s8: D(16x8, s32) += A(16x32, row) B(32x8, col). A: a0
// bytes (g, 4t..4t+3), a1 (g + 8, 4t..), a2 (g, 16 + 4t..), a3 (g + 8,
// 16 + 4t..); B: b0 (k 4t..4t+3, n g), b1 (k 16 + 4t.., n g); D as above.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
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

// d += a b, from the split fragments: in 3xTF32 for fp32 operands (T =
// float), one tf32 product for bf16 ones (their lo parts are zero). The
// products of one k-step sum in a fresh accumulator, added to d by an FADD:
// the tensor cores round their fp32 accumulation toward zero, which over the
// N / 8 k-steps of P.V or of the backward's sums over keys and queries
// would add up to a bias of ~N / 8 ulps (1.5e-5 relative at 2100 keys,
// measured); rounded to nearest outside, the error of a sum grows like its
// square root instead.
template <typename T>
__device__ __forceinline__ void mma3(float (&d)[4], const Split (&a)[4],
                                     Split b0, Split b1) {
  const uint32_t ah[4] = {a[0].hi, a[1].hi, a[2].hi, a[3].hi};
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t al[4] = {a[0].lo, a[1].lo, a[2].lo, a[3].lo};
    mma_tf32(t, al, b0.hi, b1.hi);
    mma_tf32(t, ah, b0.lo, b1.lo);
  }
  mma_tf32(t, ah, b0.hi, b1.hi);
#pragma unroll
  for (int i = 0; i < 4; ++i) d[i] += t[i];
}

// the plain versions' rounding to the input dtype (p, ds): none in fp32
template <typename T>
__device__ __forceinline__ float rnd(float x) {
  if constexpr (std::is_same<T, float>::value) return x;
  else return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
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

// R rows (r0..) of D values of T of one head of a (B, H, N, D)-strided
// tensor into fp32 shared memory (row stride ld floats), all threads of the
// block, zeros for rows past N
template <typename T, int D, int R>
__device__ __forceinline__ void load_rows(float* dst, int ld, const T* src,
                                          long long sn, int r0, int N) {
  constexpr int PER = 16 / (int)sizeof(T);  // values of one 16-byte load
  constexpr int VC = D / PER;
  for (int i = threadIdx.x; i < R * VC; i += FTHREADS) {
    const int r = i / VC, c = (i % VC) * PER;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * sn + c);
    if constexpr (std::is_same<T, float>::value) {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = u;
    } else {  // 8 bf16: the bits moved up
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          make_float4(__uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
                      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
      *reinterpret_cast<float4*>(dst + r * ld + c + 4) =
          make_float4(__uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
                      __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
    }
  }
}

// Shared memory of the kernels, in floats
template <int D>
struct F32Smem {
  static constexpr int LDA = D + 4;   // rows read as A or as "n g" B
  static constexpr int LDB = D + 8;   // rows read as "k t" B
  static constexpr int LDP = FTILE + 4;
};

// ---- forward: K1, K7 and K5 (fp32) -----------------------------------------

// grid (ceil(N / 64), H, B), FTHREADS threads, dynamic shared memory: q (64
// x LDA), k (32 x LDA), v (32 x LDB), p (4 x 16 x LDP). o = softmax(q k^T
// scale_log2 in exp2) v over the M keys (K1 / K7: M = N); scores are s *
// scale_log2 in exp2 units (K1 / K7: q^ carries scale log2(e), scale_log2 =
// 1). lse (B*H, N) written when not null.
template <typename T, int D>
__global__ void __launch_bounds__(FTHREADS)
attn_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, View vq,
                 View vk, View vv, View vo, float* __restrict__ lse,
                 float scale_log2, int N, int M, int H) {
  using S = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* ks = qs + FROWS * S::LDA;
  float* vs = ks + FTILE * S::LDA;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* ps = vs + FTILE * S::LDB + warp * 16 * S::LDP;
  const T* qh = q + b * vq.b + h * vq.h;
  const T* kh = k + b * vk.b + h * vk.h;
  const T* vh = v + b * vv.b + h * vv.h;

  load_rows<T, D, FROWS>(qs, S::LDA, qh, vq.n, q0, N);
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* qw = qs + warp * 16 * S::LDA;

  for (int k0 = 0; k0 < M; k0 += FTILE) {
    __syncthreads();  // the last tile's k and v are read
    load_rows<T, D, FTILE>(ks, S::LDA, kh, vk.n, k0, M);
    load_rows<T, D, FTILE>(vs, S::LDB, vh, vv.n, k0, M);
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
        mma3<T>(sc[j], a, split(ks[(j * 8 + g) * S::LDA + kk * 8 + t]),
                split(ks[(j * 8 + g) * S::LDA + kk * 8 + t + 4]));
    }
    // scores in exp2 units, keys past M to -inf; the running max
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        sc[j][e] = key < M ? sc[j][e] * scale_log2 : -INFINITY;
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
    // p (rounded to T) into this warp's tile, then its A fragments times
    // the V tile; l sums the unrounded p
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      const float p0 = exp2f(sc[j][0] - m0), p1 = exp2f(sc[j][1] - m0);
      const float p2 = exp2f(sc[j][2] - m1), p3 = exp2f(sc[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      *reinterpret_cast<float2*>(ps + g * S::LDP + j * 8 + 2 * t) =
          make_float2(rnd<T>(p0), rnd<T>(p1));
      *reinterpret_cast<float2*>(ps + (g + 8) * S::LDP + j * 8 + 2 * t) =
          make_float2(rnd<T>(p2), rnd<T>(p3));
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < FTILE / 8; ++kk) {
      Split a[4];
      a_frag(a, ps, S::LDP, kk, g, t);
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        mma3<T>(acc[j], a, split(vs[(kk * 8 + t) * S::LDB + j * 8 + g]),
                split(vs[(kk * 8 + t + 4) * S::LDB + j * 8 + g]));
    }
    __syncwarp();  // p read before the next tile writes it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  T* oh = o + b * vo.b + h * vo.h;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N) store2(oh + (size_t)n0 * vo.n + col, acc[j][0] * i0, acc[j][1] * i0);
    if (n1 < N) store2(oh + (size_t)n1 * vo.n + col, acc[j][2] * i1, acc[j][3] * i1);
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

// ---- K6a (fp32): dq, delta ------------------------------------------------

// grid (ceil(N / 64), H, B), FTHREADS threads, dynamic shared memory: q, dO
// (64 x LDA each), k, v (32 x LDA each), ds (4 x 16 x LDP), delta of the
// block's rows (64).
template <typename T, int D>
__global__ void __launch_bounds__(FTHREADS)
dq_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, T* __restrict__ dq, View vq,
               View vk, View vv, View vo, View vdo, View vdq, int N, int M,
               int H, float scale_log2, float scale) {
  using S = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* dos = qs + FROWS * S::LDA;
  float* ks = dos + FROWS * S::LDA;
  float* vs = ks + FTILE * S::LDA;
  float* dls = vs + FTILE * S::LDA;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* ps = dls + FROWS + warp * 16 * S::LDP;
  const T* kh = k + b * vk.b + h * vk.h;
  const T* vh = v + b * vv.b + h * vv.h;
  const size_t bhn = ((size_t)b * H + h) * N;

  load_rows<T, D, FROWS>(qs, S::LDA, q + b * vq.b + h * vq.h, vq.n, q0, N);
  load_rows<T, D, FROWS>(dos, S::LDA, dout + b * vdo.b + h * vdo.h, vdo.n,
                         q0, N);
  // delta = rowsum(dO o) of this warp's rows, a row at a time over its
  // lanes; kept for this block and written for K6b
  const T* oh = o + b * vo.b + h * vo.h;
  const T* dh = dout + b * vdo.b + h * vdo.h;
  for (int r = 0; r < 16; ++r) {
    const int n = q0 + warp * 16 + r;
    float sum = 0.f;
    if (n < N)
      for (int c = lane; c < D; c += 32)
        sum += to_f(dh[(size_t)n * vdo.n + c]) * to_f(oh[(size_t)n * vo.n + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dls[warp * 16 + r] = sum;
      if (n < N) delta[bhn + n] = sum;
    }
  }
  __syncthreads();  // delta kept, q and dO loaded
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  const float d0 = dls[warp * 16 + g], d1 = dls[warp * 16 + g + 8];
  const float L0 = n0 < N ? lse[bhn + n0] * FLOG2E : 0.f;
  const float L1 = n1 < N ? lse[bhn + n1] * FLOG2E : 0.f;
  const float* qw = qs + warp * 16 * S::LDA;
  const float* dw = dos + warp * 16 * S::LDA;
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < M; k0 += FTILE) {
    __syncthreads();
    load_rows<T, D, FTILE>(ks, S::LDA, kh, vk.n, k0, M);
    load_rows<T, D, FTILE>(vs, S::LDA, vh, vv.n, k0, M);
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
        mma3<T>(sc[j], a, split(ks[r]), split(ks[r + 4]));
        mma3<T>(dp[j], ad, split(vs[r]), split(vs[r + 4]));
      }
    }
    // ds = p (dp - delta), rounded to T, keys past M with p = 0, into this
    // warp's tile
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p = key < M ? exp2f(sc[j][e] * scale_log2 - (e < 2 ? L0 : L1))
                                : 0.f;
        ds[e] = rnd<T>(p * (dp[j][e] - (e < 2 ? d0 : d1)));
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
        mma3<T>(acc[j], a, split(ks[(kk * 8 + t) * S::LDA + j * 8 + g]),
                split(ks[(kk * 8 + t + 4) * S::LDA + j * 8 + g]));
    }
    __syncwarp();
  }

  T* qh = dq + b * vdq.b + h * vdq.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N)
      store2(qh + (size_t)n0 * vdq.n + col, acc[j][0] * scale, acc[j][1] * scale);
    if (n1 < N)
      store2(qh + (size_t)n1 * vdq.n + col, acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D>
constexpr int dq_smem_bytes() {
  using S = F32Smem<D>;
  return (2 * FROWS * S::LDA + 2 * FTILE * S::LDA + FROWS + 4 * 16 * S::LDP) * 4;
}

// ---- K6b (fp32): dk, dv ---------------------------------------------------

// grid (ceil(M / 64), H, B): 64 of the M key rows a block, 16 a warp; FTHREADS
// threads, dynamic shared memory: k, v (64 x LDA each), q, dO (32 x LDA
// each), lse, delta of the query tile (32 each), p^T and ds^T (4 x 16 x LDP
// each).
template <typename T, int D>
__global__ void __launch_bounds__(FTHREADS)
dkv_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, View vq,
                View vk, View vv, View vdo, View vdk, View vdv, int N, int M,
                int H, float scale_log2, float scale) {
  using S = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  float* kts = reinterpret_cast<float*>(smem_f4);
  float* vts = kts + FROWS * S::LDA;
  float* qs = vts + FROWS * S::LDA;
  float* dos = qs + FTILE * S::LDA;
  float* ls = dos + FTILE * S::LDA;
  float* dls = ls + FTILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* pts = dls + FTILE + warp * 2 * 16 * S::LDP;
  float* dss = pts + 16 * S::LDP;
  const T* qh = q + b * vq.b + h * vq.h;
  const T* dh = dout + b * vdo.b + h * vdo.h;
  const size_t bhn = ((size_t)b * H + h) * N;

  load_rows<T, D, FROWS>(kts, S::LDA, k + b * vk.b + h * vk.h, vk.n, r0, M);
  load_rows<T, D, FROWS>(vts, S::LDA, v + b * vv.b + h * vv.h, vv.n, r0, M);
  const float* kw = kts + warp * 16 * S::LDA;
  const float* vw = vts + warp * 16 * S::LDA;
  float adk[D / 8][4], adv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += FTILE) {
    __syncthreads();
    load_rows<T, D, FTILE>(qs, S::LDA, qh, vq.n, q0, N);
    load_rows<T, D, FTILE>(dos, S::LDA, dh, vdo.n, q0, N);
    if (threadIdx.x < FTILE) {
      const int n = q0 + threadIdx.x;
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
        mma3<T>(sc[j], a, split(qs[r]), split(qs[r + 4]));
        mma3<T>(dp[j], av, split(dos[r]), split(dos[r + 4]));
      }
    }
    // p^T = exp2(s^T scale log2(e) - lse), ds^T = p^T (dp^T - delta), each
    // rounded to T: query column j * 8 + 2t (+1) of key rows g, g + 8
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float la = ls[c], lb = ls[c + 1], da = dls[c], db = dls[c + 1];
      const float p0 = exp2f(sc[j][0] * scale_log2 - la);
      const float p1 = exp2f(sc[j][1] * scale_log2 - lb);
      const float p2 = exp2f(sc[j][2] * scale_log2 - la);
      const float p3 = exp2f(sc[j][3] * scale_log2 - lb);
      *reinterpret_cast<float2*>(pts + g * S::LDP + c) = make_float2(rnd<T>(p0), rnd<T>(p1));
      *reinterpret_cast<float2*>(pts + (g + 8) * S::LDP + c) = make_float2(rnd<T>(p2), rnd<T>(p3));
      *reinterpret_cast<float2*>(dss + g * S::LDP + c) =
          make_float2(rnd<T>(p0 * (dp[j][0] - da)), rnd<T>(p1 * (dp[j][1] - db)));
      *reinterpret_cast<float2*>(dss + (g + 8) * S::LDP + c) =
          make_float2(rnd<T>(p2 * (dp[j][2] - da)), rnd<T>(p3 * (dp[j][3] - db)));
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
        mma3<T>(adv[j], ap, split(dos[r]), split(dos[r + 4 * S::LDA]));
        mma3<T>(adk[j], as, split(qs[r]), split(qs[r + 4 * S::LDA]));
      }
    }
    __syncwarp();
  }

  const int n0 = r0 + warp * 16 + g, n1 = n0 + 8;
  T* kh = dk + b * vdk.b + h * vdk.h;
  T* vh = dv + b * vdv.b + h * vdv.h;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < M) {
      store2(kh + (size_t)n0 * vdk.n + col, adk[j][0] * scale, adk[j][1] * scale);
      store2(vh + (size_t)n0 * vdv.n + col, adv[j][0], adv[j][1]);
    }
    if (n1 < M) {
      store2(kh + (size_t)n1 * vdk.n + col, adk[j][2] * scale, adk[j][3] * scale);
      store2(vh + (size_t)n1 * vdv.n + col, adv[j][2], adv[j][3]);
    }
  }
}

template <int D>
constexpr int dkv_smem_bytes() {
  using S = F32Smem<D>;
  return (2 * FROWS * S::LDA + 2 * FTILE * S::LDA + 2 * FTILE +
          4 * 2 * 16 * S::LDP) * 4;
}

// ---- K4, K7q, K8a, K8b (fp32 rows) ----------------------------------------

// Shared memory of the int8 instances, in bytes: int8 rows of q^ / k^ (DK
// bytes, DK = max(D, 32): one s8 k-step is 32 deep, D 16 zero-padded), or
// fp32 ones; V fp32 (32 x LDB floats), or V^T int8 (D rows of the tile's 32
// keys, LVT bytes apart); p tiles (fp32, the float P.V).
template <int D, bool QK8, bool PV8>
struct Q8Smem {
  using F = F32Smem<D>;
  static constexpr int DK = D < 32 ? 32 : D;
  static constexpr int LQ8 = DK + 16;
  static constexpr int LVT = 48;
  static constexpr int QB = QK8 ? FROWS * LQ8 : FROWS * F::LDA * 4;
  static constexpr int KB = QK8 ? FTILE * LQ8 : FTILE * F::LDA * 4;
  static constexpr int VB = PV8 ? D * LVT : FTILE * F::LDB * 4;
  static constexpr int PB = PV8 ? 0 : 4 * 16 * F::LDP * 4;
  static constexpr int BYTES = QB + KB + VB + PB;
};

// R int8 rows (r0..) of D bytes of one head, row stride rs bytes, into
// shared memory rows of LQ8 bytes; zeros past N and past D
template <int D, int R, int DK, int LQ8>
__device__ __forceinline__ void load_rows_s8(unsigned char* dst,
                                             const int8_t* src, size_t rs,
                                             int r0, int N) {
  constexpr int VC = DK / 16;
  for (int i = threadIdx.x; i < R * VC; i += FTHREADS) {
    const int r = i / VC, c = (i % VC) * 16;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N && c < D)
      u = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * rs + c);
    *reinterpret_cast<uint4*>(dst + r * LQ8 + c) = u;
  }
}

__device__ __forceinline__ uint32_t ld32(const unsigned char* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// grid (ceil(N / 64), H, B), FTHREADS threads, Q8Smem<D, QK8, PV8>::BYTES
// of dynamic shared memory. q_prep: (B, N, H*D) q^, int8 under QK8 (its
// per-row scales q_scale (B*H, N)) else fp32 with scale log2(e) folded in;
// k_prep: k^, int8 under QK8 else fp32; k_stat: under QK8 one k amax per
// (b, h) (K4, per_key 0) or a k scale per key ((B*H, np), K7q); v: (B, N, H*D) fp32
// (float P.V); v_q (B*H, D, np) int8 V^T with v_amax (B*H, D) (PV8); out
// (B, N, H*D) fp32. K4's k_stat holds max |k^| of (b, h); its scale is
// max(amax, 1e-12) / 127, as the K quantizer took it. PV8 quantizes p per block of qblock keys (N: K8a's true
// row max; PV8_BLOCK: K8b's).
template <int D, bool QK8, bool PV8>
__global__ void __launch_bounds__(FTHREADS)
attn_q8_fp32_kernel(const void* __restrict__ q_prep,
                    const void* __restrict__ k_prep,
                    const float* __restrict__ v,
                    const int8_t* __restrict__ v_q,
                    const float* __restrict__ q_scale,
                    const float* __restrict__ k_stat,
                    const float* __restrict__ v_amax, float* __restrict__ out,
                    int N, int H, int np, int qblock, int per_key) {
  using S = Q8Smem<D, QK8, PV8>;
  using F = F32Smem<D>;
  extern __shared__ float4 smem_f4[];
  unsigned char* sm = reinterpret_cast<unsigned char*>(smem_f4);
  unsigned char* qsm = sm;
  unsigned char* ksm = sm + S::QB;
  unsigned char* vsm = ksm + S::KB;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int q0 = blockIdx.x * FROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;

  if constexpr (QK8)
    load_rows_s8<D, FROWS, S::DK, S::LQ8>(
        qsm, static_cast<const int8_t*>(q_prep) + base, rs, q0, N);
  else
    load_rows<float, D, FROWS>(reinterpret_cast<float*>(qsm), F::LDA,
                               static_cast<const float*>(q_prep) + base,
                               (long long)rs, q0, N);
  // int8 scores: the rows' q scales, and K4's one k scale
  float sq0 = 0.f, sq1 = 0.f, skh = 0.f;
  if constexpr (QK8) {
    sq0 = n0 < N ? q_scale[(size_t)bh * N + n0] : 0.f;
    sq1 = n1 < N ? q_scale[(size_t)bh * N + n1] : 0.f;
    if (!per_key) skh = fmaxf(k_stat[bh], 1e-12f) / 127.f;  // K4: amax
  }
  const float comb0 = sq0 * skh, comb1 = sq1 * skh;

  auto load_k = [&](int k0) {
    if constexpr (QK8)
      load_rows_s8<D, FTILE, S::DK, S::LQ8>(
          ksm, static_cast<const int8_t*>(k_prep) + base, rs, k0, N);
    else
      load_rows<float, D, FTILE>(reinterpret_cast<float*>(ksm), F::LDA,
                                 static_cast<const float*>(k_prep) + base,
                                 (long long)rs, k0, N);
  };
  // the scores of keys k0 .. k0 + 31 in exp2 units (q^ carries scale
  // log2(e)), keys past N at -inf
  auto scores = [&](int k0, float (&sc)[FTILE / 8][4]) {
    if constexpr (QK8) {
      int si[FTILE / 8][4];
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
      const unsigned char* qw = qsm + warp * 16 * S::LQ8;
#pragma unroll
      for (int ks = 0; ks < S::DK / 32; ++ks) {
        const uint32_t a[4] = {ld32(qw + g * S::LQ8 + ks * 32 + 4 * t),
                               ld32(qw + (g + 8) * S::LQ8 + ks * 32 + 4 * t),
                               ld32(qw + g * S::LQ8 + ks * 32 + 16 + 4 * t),
                               ld32(qw + (g + 8) * S::LQ8 + ks * 32 + 16 + 4 * t)};
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j) {
          const unsigned char* kr = ksm + (j * 8 + g) * S::LQ8 + ks * 32 + 4 * t;
          mma_s8(si[j], a, ld32(kr), ld32(kr + 16));
        }
      }
      // K4: s32 * (s_q s_k); K7q: (s32 * s_q) * s_k[key]
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const float f = (float)si[j][e];
          sc[j][e] = key >= N ? -INFINITY
                     : per_key ? f * (e < 2 ? sq0 : sq1) * k_stat[(size_t)bh * np + key]
                               : f * (e < 2 ? comb0 : comb1);
        }
    } else {
      const float* qw = reinterpret_cast<const float*>(qsm) + warp * 16 * F::LDA;
      const float* kf = reinterpret_cast<const float*>(ksm);
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        Split a[4];
        a_frag(a, qw, F::LDA, kk, g, t);
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j)
          mma3<float>(sc[j], a, split(kf[(j * 8 + g) * F::LDA + kk * 8 + t]),
                      split(kf[(j * 8 + g) * F::LDA + kk * 8 + t + 4]));
      }
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= N) sc[j][e] = -INFINITY;
    }
  };
  auto tile_max = [&](const float (&sc)[FTILE / 8][4], float& mx0, float& mx1) {
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
  };

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  if constexpr (!PV8) {
    // K4, K7q: an online softmax over 32-key tiles, fp32 P.V (p rounded to
    // v's dtype, fp32: exact)
    float* vs = reinterpret_cast<float*>(vsm);
    float* ps = reinterpret_cast<float*>(vsm + S::VB) + warp * 16 * F::LDP;
    for (int k0 = 0; k0 < N; k0 += FTILE) {
      __syncthreads();
      load_k(k0);
      load_rows<float, D, FTILE>(vs, F::LDB, v + base, (long long)rs, k0, N);
      __syncthreads();
      float sc[FTILE / 8][4];
      scores(k0, sc);
      float mx0 = -INFINITY, mx1 = -INFINITY;
      tile_max(sc, mx0, mx1);
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
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) {
        const float p0 = exp2f(sc[j][0] - m0), p1 = exp2f(sc[j][1] - m0);
        const float p2 = exp2f(sc[j][2] - m1), p3 = exp2f(sc[j][3] - m1);
        l0 += p0 + p1;
        l1 += p2 + p3;
        *reinterpret_cast<float2*>(ps + g * F::LDP + j * 8 + 2 * t) = make_float2(p0, p1);
        *reinterpret_cast<float2*>(ps + (g + 8) * F::LDP + j * 8 + 2 * t) = make_float2(p2, p3);
      }
      __syncwarp();
#pragma unroll
      for (int kk = 0; kk < FTILE / 8; ++kk) {
        Split a[4];
        a_frag(a, ps, F::LDP, kk, g, t);
#pragma unroll
        for (int j = 0; j < D / 8; ++j)
          mma3<float>(acc[j], a, split(vs[(kk * 8 + t) * F::LDB + j * 8 + g]),
                      split(vs[(kk * 8 + t + 4) * F::LDB + j * 8 + g]));
      }
      __syncwarp();
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      if (n0 < N) store2(out + base + (size_t)n0 * rs + col, acc[j][0] * i0, acc[j][1] * i0);
      if (n1 < N) store2(out + base + (size_t)n1 * rs + col, acc[j][2] * i1, acc[j][3] * i1);
    }
  } else {
    // K8a, K8b: per block of qblock keys, its max (a first pass over its
    // tiles), then p = exp2(s - (m - log2 127)) in [0, 127] rounded to int8
    // (half to even) times V^T's levels, summed in s32 over the block; l
    // sums the unrounded p; both rescaled by alpha between blocks
    for (int b0 = 0; b0 < N; b0 += qblock) {
      const int b1 = min(b0 + qblock, N);
      float mx0 = -INFINITY, mx1 = -INFINITY;
      for (int k0 = b0; k0 < b1; k0 += FTILE) {
        __syncthreads();
        load_k(k0);
        __syncthreads();
        float sc[FTILE / 8][4];
        scores(k0, sc);
        tile_max(sc, mx0, mx1);
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
      const float sh0 = m0 - LOG2_127, sh1 = m1 - LOG2_127;
      int acci[D / 8][4];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) acci[j][0] = acci[j][1] = acci[j][2] = acci[j][3] = 0;
      for (int k0 = b0; k0 < b1; k0 += FTILE) {
        __syncthreads();
        load_k(k0);
        // V^T's 32 keys of the tile, D rows of 32 bytes (np keys a row)
        for (int i = threadIdx.x; i < D * 2; i += FTHREADS) {
          const int d = i >> 1, c = (i & 1) * 16;
          *reinterpret_cast<uint4*>(vsm + d * S::LVT + c) = *reinterpret_cast<const uint4*>(
              v_q + ((size_t)bh * D + d) * np + k0 + c);
        }
        __syncthreads();
        float sc[FTILE / 8][4];
        scores(k0, sc);
        int lv[FTILE / 8][4];
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pb = exp2f(sc[j][e] - (e < 2 ? sh0 : sh1));
            if (e < 2) l0 += pb;
            else l1 += pb;
            lv[j][e] = (int)fminf(fmaxf(rintf(pb), 0.f), 127.f);
          }
        // the A fragment in V^T's key order (v_perm): bytes 4t..4t+3 of a
        // row are keys 2t, 2t + 1, 8 + 2t, 9 + 2t; bytes 16 + 4t.. the same
        // 16 keys on
        auto pack = [](int x0, int x1, int x2, int x3) {
          return (uint32_t)x0 | ((uint32_t)x1 << 8) | ((uint32_t)x2 << 16) |
                 ((uint32_t)x3 << 24);
        };
        const uint32_t a[4] = {pack(lv[0][0], lv[0][1], lv[1][0], lv[1][1]),
                               pack(lv[0][2], lv[0][3], lv[1][2], lv[1][3]),
                               pack(lv[2][0], lv[2][1], lv[3][0], lv[3][1]),
                               pack(lv[2][2], lv[2][3], lv[3][2], lv[3][3])};
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const unsigned char* vr = vsm + (j * 8 + g) * S::LVT + 4 * t;
          mma_s8(acci[j], a, ld32(vr), ld32(vr + 16));
        }
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += (float)acci[j][e];
    }
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    // o = acc / l * V's column scales
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + 2 * t;
      const float s0 = fmaxf(v_amax[(size_t)bh * D + col], 1e-12f) / 127.f;
      const float s1 = fmaxf(v_amax[(size_t)bh * D + col + 1], 1e-12f) / 127.f;
      if (n0 < N)
        store2(out + base + (size_t)n0 * rs + col, acc[j][0] / l0 * s0, acc[j][1] / l0 * s1);
      if (n1 < N)
        store2(out + base + (size_t)n1 * rs + col, acc[j][2] / l1 * s0, acc[j][3] / l1 * s1);
    }
  }
}

// ---- head dims past 128: every multiple of 128, one set of instances -------

// A head of D > 128 values (a multiple of 128; the wrappers zero-pad the
// others) is taken in chunks of WC: the scores sum over the chunks, each
// staged through shared memory in its turn (q, k; for the backward dO, v
// too), and a block writes one WC-wide column slice of its output, so that
// neither a block's shared memory nor a thread's accumulators grow with D.
// Every slice recomputes the scores over the whole head. The backward takes
// its slice's chunk last, so that the chunk its products need (k in K6a, q
// and dO in K6b) is still in shared memory. p and ds go through each warp's
// own rows of the q tile (K6b: of the k tile), free once the scores are
// summed.
constexpr int WC = 128;               // chunk of the head; output columns a block
constexpr int WLDA = WC + 4;          // fp32 rows read as A or as "n g" B
constexpr int WLDB = WC + 8;          // fp32 rows read as "k t" B
constexpr int WLQ8 = WC + 16;         // int8 rows (bytes)
constexpr int WLVT = 48;              // int8 V^T rows of a 32-key tile (bytes)
constexpr int WPREP_ROWS = 8;         // rows of a prep block, a warp each

// the softmax of the forward: ONLINE, the running max per 32-key tile (the
// fp32 instances; K5); BOUNDED, the shift ||q^|| max ||k^|| (K1 in bf16);
// BLOCKED, per block of `sblock` keys its max from a first pass over the
// block, then p (K4, K8a: sblock N; K7, K7q, K8b: 128, the bf16 kernels'
// tiles that their plain versions' block_k takes)
enum WideSoftmax { W_ONLINE = 0, W_BOUNDED = 1, W_BLOCKED = 2 };

struct WideFwd {
  const void* q;        // q^ (T, or int8 under QK8), (b, h, n) view vq
  const void* k;        // k^ (T, or int8 under QK8)
  const void* v;        // v (T; float P.V)
  void* o;              // out (T)
  View vq, vk, vv, vo;  // element strides
  const int8_t* v_q;    // PV8: V^T (B*H, D, np), v_perm order
  const float* v_amax;  // PV8: (B*H, D)
  const float* q_stat;  // QK8: q row scales (B*H, N); BOUNDED: ||q^|| (B*H, N)
  const float* k_stat;  // QK8: k amax (B*H), per_key: scales (B*H, np);
                        // BOUNDED: max ||k^||^2 (B*H)
  float* lse;           // (B*H, N) or null
  float scale_log2;
  int N, M, H, D, np, mode, sblock, per_key;  // M: keys (N but for K5)
};

template <bool QK8, bool PV8>
struct WideSmem {
  static constexpr int QB = QK8 ? FROWS * WLQ8 : FROWS * WLDA * 4;
  static constexpr int KB = QK8 ? FTILE * WLQ8 : FTILE * WLDA * 4;
  static constexpr int VB = PV8 ? WC * WLVT : FTILE * WLDB * 4;
  static constexpr int BYTES = QB + KB + VB;
  // a warp's p tile (16 x LDP floats) in its own 16 rows of q
  static_assert(16 * F32Smem<WC>::LDP * 4 <= QB / 4, "p tile in q rows");
};

// grid (ceil(N / 64) * D / WC, H, B), FTHREADS threads,
// WideSmem<QK8, PV8>::BYTES of dynamic shared memory. Block x takes rows
// (x / (D / WC)) * 64 and columns (x % (D / WC)) * WC of o; lse written by
// the first column slice.
template <typename T, bool QK8, bool PV8>
__global__ void __launch_bounds__(FTHREADS) wide_attn_kernel(const WideFwd a) {
  using S = WideSmem<QK8, PV8>;
  using QT = typename std::conditional<QK8, int8_t, T>::type;
  extern __shared__ float4 smem_f4[];
  unsigned char* qsm = reinterpret_cast<unsigned char*>(smem_f4);
  unsigned char* ksm = qsm + S::QB;
  unsigned char* vsm = ksm + S::KB;
  const int N = a.N, M = a.M, NS = a.D / WC;
  const int h = blockIdx.y, b = blockIdx.z, bh = b * a.H + h;
  const int q0 = blockIdx.x / NS * FROWS, c0 = blockIdx.x % NS * WC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  float* ps = reinterpret_cast<float*>(qsm + warp * (S::QB / 4));
  constexpr int LDP = F32Smem<WC>::LDP;
  const QT* qh = static_cast<const QT*>(a.q) + b * a.vq.b + h * a.vq.h;
  const QT* kh = static_cast<const QT*>(a.k) + b * a.vk.b + h * a.vk.h;

  // int8 scores: the rows' q scales, and K4's one k scale
  float sq0 = 0.f, sq1 = 0.f, skh = 0.f;
  if constexpr (QK8) {
    sq0 = n0 < N ? a.q_stat[(size_t)bh * N + n0] : 0.f;
    sq1 = n1 < N ? a.q_stat[(size_t)bh * N + n1] : 0.f;
    if (!a.per_key) skh = fmaxf(a.k_stat[bh], 1e-12f) / 127.f;
  }
  // the scores of keys k0 .. k0 + 31 in exp2 units, summed over the head's
  // chunks; keys past M at -inf
  auto scores = [&](int k0, float (&sc)[FTILE / 8][4]) {
    if constexpr (QK8) {
      int si[FTILE / 8][4];
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) si[j][0] = si[j][1] = si[j][2] = si[j][3] = 0;
      for (int ch = 0; ch < NS; ++ch) {
        __syncthreads();  // the last chunk (and p) read
        load_rows_s8<WC, FROWS, WC, WLQ8>(qsm, qh + ch * WC, a.vq.n, q0, N);
        load_rows_s8<WC, FTILE, WC, WLQ8>(ksm, kh + ch * WC, a.vk.n, k0, M);
        __syncthreads();
        const unsigned char* qw = qsm + warp * 16 * WLQ8;
#pragma unroll
        for (int ks = 0; ks < WC / 32; ++ks) {
          const uint32_t af[4] = {ld32(qw + g * WLQ8 + ks * 32 + 4 * t),
                                  ld32(qw + (g + 8) * WLQ8 + ks * 32 + 4 * t),
                                  ld32(qw + g * WLQ8 + ks * 32 + 16 + 4 * t),
                                  ld32(qw + (g + 8) * WLQ8 + ks * 32 + 16 + 4 * t)};
#pragma unroll
          for (int j = 0; j < FTILE / 8; ++j) {
            const unsigned char* kr = ksm + (j * 8 + g) * WLQ8 + ks * 32 + 4 * t;
            mma_s8(si[j], af, ld32(kr), ld32(kr + 16));
          }
        }
      }
      // K4: s32 * (s_q s_k); K7q: (s32 * s_q) * s_k[key]
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          const float f = (float)si[j][e], sq = e < 2 ? sq0 : sq1;
          sc[j][e] = key >= M ? -INFINITY
                     : a.per_key ? f * sq * a.k_stat[(size_t)bh * a.np + key]
                                 : f * (sq * skh);
        }
    } else {
      float* qf = reinterpret_cast<float*>(qsm);
      float* kf = reinterpret_cast<float*>(ksm);
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      for (int ch = 0; ch < NS; ++ch) {
        __syncthreads();
        load_rows<T, WC, FROWS>(qf, WLDA, qh + ch * WC, a.vq.n, q0, N);
        load_rows<T, WC, FTILE>(kf, WLDA, kh + ch * WC, a.vk.n, k0, M);
        __syncthreads();
        const float* qw = qf + warp * 16 * WLDA;
#pragma unroll
        for (int kk = 0; kk < WC / 8; ++kk) {
          Split af[4];
          a_frag(af, qw, WLDA, kk, g, t);
#pragma unroll
          for (int j = 0; j < FTILE / 8; ++j)
            mma3<T>(sc[j], af, split(kf[(j * 8 + g) * WLDA + kk * 8 + t]),
                    split(kf[(j * 8 + g) * WLDA + kk * 8 + t + 4]));
        }
      }
#pragma unroll
      for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + j * 8 + 2 * t + (e & 1);
          sc[j][e] = key < M ? sc[j][e] * a.scale_log2 : -INFINITY;
        }
    }
  };

  float acc[WC / 8][4];
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if (a.mode == W_BOUNDED) {  // rows past N: q^ = 0, any shift
    const float kmax = sqrtf(a.k_stat[bh]);
    m0 = n0 < N ? a.q_stat[(size_t)bh * N + n0] * kmax : 0.f;
    m1 = n1 < N ? a.q_stat[(size_t)bh * N + n1] * kmax : 0.f;
  }
  // a new running max: l and the accumulator rescaled
  auto rescale = [&](float mx0, float mx1) {
    const float mn0 = fmaxf(m0, quad_max(mx0)), mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = exp2f(m0 - mn0), a1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < WC / 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
  };
  auto tile_max = [&](const float (&sc)[FTILE / 8][4], float& mx0, float& mx1) {
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[j][0], sc[j][1]));
      mx1 = fmaxf(mx1, fmaxf(sc[j][2], sc[j][3]));
    }
  };

  const int blk = a.mode == W_BLOCKED ? a.sblock : M;
  for (int b0 = 0; b0 < M; b0 += blk) {
    const int b1 = min(b0 + blk, M);
    if (a.mode == W_BLOCKED) {  // the block's max: a first pass
      float mx0 = -INFINITY, mx1 = -INFINITY;
      for (int k0 = b0; k0 < b1; k0 += FTILE) {
        float sc[FTILE / 8][4];
        scores(k0, sc);
        tile_max(sc, mx0, mx1);
      }
      rescale(mx0, mx1);
    }
    int acci[PV8 ? WC / 8 : 1][4];
#pragma unroll
    for (int j = 0; j < (PV8 ? WC / 8 : 1); ++j) acci[j][0] = acci[j][1] = acci[j][2] = acci[j][3] = 0;
    for (int k0 = b0; k0 < b1; k0 += FTILE) {
      float sc[FTILE / 8][4];
      scores(k0, sc);
      if (a.mode == W_ONLINE) {
        float mx0 = -INFINITY, mx1 = -INFINITY;
        tile_max(sc, mx0, mx1);
        rescale(mx0, mx1);
      }
      if constexpr (PV8) {
        // V^T's 32 keys of the tile for the block's WC columns
        for (int i = threadIdx.x; i < WC * 2; i += FTHREADS) {
          const int d = i >> 1, c = (i & 1) * 16;
          *reinterpret_cast<uint4*>(vsm + d * WLVT + c) = *reinterpret_cast<const uint4*>(
              a.v_q + ((size_t)bh * a.D + c0 + d) * a.np + k0 + c);
        }
        __syncthreads();
        // p = exp2(s - (m - log2 127)) in [0, 127], rounded half to even;
        // l sums the unrounded p; the A fragment in V^T's key order
        const float sh0 = m0 - LOG2_127, sh1 = m1 - LOG2_127;
        int lv[FTILE / 8][4];
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float pb = exp2f(sc[j][e] - (e < 2 ? sh0 : sh1));
            if (e < 2) l0 += pb;
            else l1 += pb;
            lv[j][e] = (int)fminf(fmaxf(rintf(pb), 0.f), 127.f);
          }
        auto pack = [](int x0, int x1, int x2, int x3) {
          return (uint32_t)x0 | ((uint32_t)x1 << 8) | ((uint32_t)x2 << 16) |
                 ((uint32_t)x3 << 24);
        };
        const uint32_t af[4] = {pack(lv[0][0], lv[0][1], lv[1][0], lv[1][1]),
                                pack(lv[0][2], lv[0][3], lv[1][2], lv[1][3]),
                                pack(lv[2][0], lv[2][1], lv[3][0], lv[3][1]),
                                pack(lv[2][2], lv[2][3], lv[3][2], lv[3][3])};
#pragma unroll
        for (int j = 0; j < WC / 8; ++j) {
          const unsigned char* vr = vsm + (j * 8 + g) * WLVT + 4 * t;
          mma_s8(acci[j], af, ld32(vr), ld32(vr + 16));
        }
      } else {
        float* vs = reinterpret_cast<float*>(vsm);
        const T* vh = static_cast<const T*>(a.v) + b * a.vv.b + h * a.vv.h + c0;
        load_rows<T, WC, FTILE>(vs, WLDB, vh, a.vv.n, k0, M);
        __syncthreads();
        // p (rounded to T) into this warp's tile; l sums the unrounded p
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j) {
          const float p0 = exp2f(sc[j][0] - m0), p1 = exp2f(sc[j][1] - m0);
          const float p2 = exp2f(sc[j][2] - m1), p3 = exp2f(sc[j][3] - m1);
          l0 += p0 + p1;
          l1 += p2 + p3;
          *reinterpret_cast<float2*>(ps + g * LDP + j * 8 + 2 * t) =
              make_float2(rnd<T>(p0), rnd<T>(p1));
          *reinterpret_cast<float2*>(ps + (g + 8) * LDP + j * 8 + 2 * t) =
              make_float2(rnd<T>(p2), rnd<T>(p3));
        }
        __syncwarp();
#pragma unroll
        for (int kk = 0; kk < FTILE / 8; ++kk) {
          Split af[4];
          a_frag(af, ps, LDP, kk, g, t);
#pragma unroll
          for (int j = 0; j < WC / 8; ++j)
            mma3<T>(acc[j], af, split(vs[(kk * 8 + t) * WLDB + j * 8 + g]),
                    split(vs[(kk * 8 + t + 4) * WLDB + j * 8 + g]));
        }
        __syncwarp();
      }
    }
    if constexpr (PV8) {
#pragma unroll
      for (int j = 0; j < WC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[j][e] += (float)acci[j][e];
    }
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  T* oh = static_cast<T*>(a.o) + b * a.vo.b + h * a.vo.h + c0;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) {
    const int col = j * 8 + 2 * t;
    float s0 = 1.f, s1 = 1.f;  // int8 P.V: V's column scales
    if constexpr (PV8) {
      s0 = fmaxf(a.v_amax[(size_t)bh * a.D + c0 + col], 1e-12f) / 127.f;
      s1 = fmaxf(a.v_amax[(size_t)bh * a.D + c0 + col + 1], 1e-12f) / 127.f;
    }
    if (n0 < N)
      store2(oh + (size_t)n0 * a.vo.n + col, acc[j][0] * i0 * s0, acc[j][1] * i0 * s1);
    if (n1 < N)
      store2(oh + (size_t)n1 * a.vo.n + col, acc[j][2] * i1 * s0, acc[j][3] * i1 * s1);
  }
  if (a.lse != nullptr && c0 == 0 && t == 0) {
    float* lh = a.lse + (size_t)bh * N;
    if (n0 < N) lh[n0] = (m0 + log2f(l0)) * FLN2;
    if (n1 < N) lh[n1] = (m1 + log2f(l1)) * FLN2;
  }
}

// K6a past 128: grid (ceil(N / 64) * D / WC, H, B), FTHREADS threads, dynamic
// shared memory: q, dO chunks (64 x WLDA each), k, v chunks (32 x WLDA
// each), delta of the block's rows (64); ds in the warps' q rows. Block x:
// rows and dq columns as in the forward; delta written by the first slice.
template <typename T>
__global__ void __launch_bounds__(FTHREADS)
wide_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, T* __restrict__ dq, View vq,
               View vk, View vv, View vo, View vdo, View vdq, int N, int M,
               int H, int D, float scale_log2, float scale) {
  constexpr int LDP = F32Smem<WC>::LDP;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* dos = qs + FROWS * WLDA;
  float* ks = dos + FROWS * WLDA;
  float* vs = ks + FTILE * WLDA;
  float* dls = vs + FTILE * WLDA;
  const int NS = D / WC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x / NS * FROWS, cs = blockIdx.x % NS, c0 = cs * WC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* ps = qs + warp * 16 * WLDA;
  const T* qh = q + b * vq.b + h * vq.h;
  const T* dh = dout + b * vdo.b + h * vdo.h;
  const T* kh = k + b * vk.b + h * vk.h;
  const T* vh = v + b * vv.b + h * vv.h;
  const size_t bhn = ((size_t)b * H + h) * N;

  // delta = rowsum(dO o) over the whole head, a row at a time over a warp
  const T* oh = o + b * vo.b + h * vo.h;
  for (int r = 0; r < 16; ++r) {
    const int n = q0 + warp * 16 + r;
    float sum = 0.f;
    if (n < N)
      for (int c = lane; c < D; c += 32)
        sum += to_f(dh[(size_t)n * vdo.n + c]) * to_f(oh[(size_t)n * vo.n + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      dls[warp * 16 + r] = sum;
      if (n < N && cs == 0) delta[bhn + n] = sum;
    }
  }
  __syncthreads();
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  const float d0 = dls[warp * 16 + g], d1 = dls[warp * 16 + g + 8];
  const float L0 = n0 < N ? lse[bhn + n0] * FLOG2E : 0.f;
  const float L1 = n1 < N ? lse[bhn + n1] * FLOG2E : 0.f;
  const float* qw = qs + warp * 16 * WLDA;
  const float* dw = dos + warp * 16 * WLDA;
  float acc[WC / 8][4];
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < M; k0 += FTILE) {
    float sc[FTILE / 8][4], dp[FTILE / 8][4];
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    for (int i = 1; i <= NS; ++i) {  // the slice's chunk last
      const int ch = (cs + i) % NS;
      __syncthreads();
      load_rows<T, WC, FROWS>(qs, WLDA, qh + ch * WC, vq.n, q0, N);
      load_rows<T, WC, FROWS>(dos, WLDA, dh + ch * WC, vdo.n, q0, N);
      load_rows<T, WC, FTILE>(ks, WLDA, kh + ch * WC, vk.n, k0, M);
      load_rows<T, WC, FTILE>(vs, WLDA, vh + ch * WC, vv.n, k0, M);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WC / 8; ++kk) {
        Split af[4], ad[4];
        a_frag(af, qw, WLDA, kk, g, t);
        a_frag(ad, dw, WLDA, kk, g, t);
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j) {
          const int r = (j * 8 + g) * WLDA + kk * 8 + t;
          mma3<T>(sc[j], af, split(ks[r]), split(ks[r + 4]));
          mma3<T>(dp[j], ad, split(vs[r]), split(vs[r + 4]));
        }
      }
    }
    __syncwarp();  // this warp's q rows read: ds goes there
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p = key < M ? exp2f(sc[j][e] * scale_log2 - (e < 2 ? L0 : L1))
                                : 0.f;
        ds[e] = rnd<T>(p * (dp[j][e] - (e < 2 ? d0 : d1)));
      }
      *reinterpret_cast<float2*>(ps + g * LDP + j * 8 + 2 * t) = make_float2(ds[0], ds[1]);
      *reinterpret_cast<float2*>(ps + (g + 8) * LDP + j * 8 + 2 * t) = make_float2(ds[2], ds[3]);
    }
    __syncwarp();
    // dq of the slice += ds k[:, slice]: the slice's k chunk is in ks
#pragma unroll
    for (int kk = 0; kk < FTILE / 8; ++kk) {
      Split af[4];
      a_frag(af, ps, LDP, kk, g, t);
#pragma unroll
      for (int j = 0; j < WC / 8; ++j)
        mma3<T>(acc[j], af, split(ks[(kk * 8 + t) * WLDA + j * 8 + g]),
                split(ks[(kk * 8 + t + 4) * WLDA + j * 8 + g]));
    }
  }

  T* qo = dq + b * vdq.b + h * vdq.h + c0;
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N)
      store2(qo + (size_t)n0 * vdq.n + col, acc[j][0] * scale, acc[j][1] * scale);
    if (n1 < N)
      store2(qo + (size_t)n1 * vdq.n + col, acc[j][2] * scale, acc[j][3] * scale);
  }
}

// K6b past 128: grid (ceil(M / 64) * D / WC, H, B): 64 key rows a block and
// WC columns of dk and dv; FTHREADS threads, dynamic shared memory: k, v
// chunks (64 x WLDA each), q, dO chunks (32 x WLDA each), lse, delta of the
// query tile (32 each); p^T and ds^T in the warps' k rows.
template <typename T>
__global__ void __launch_bounds__(FTHREADS)
wide_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, View vq, View vk,
                View vv, View vdo, View vdk, View vdv, int N, int M, int H,
                int D, float scale_log2, float scale) {
  constexpr int LDP = F32Smem<WC>::LDP;
  extern __shared__ float4 smem_f4[];
  float* kts = reinterpret_cast<float*>(smem_f4);
  float* vts = kts + FROWS * WLDA;
  float* qs = vts + FROWS * WLDA;
  float* dos = qs + FTILE * WLDA;
  float* ls = dos + FTILE * WLDA;
  float* dls = ls + FTILE;
  const int NS = D / WC;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x / NS * FROWS, cs = blockIdx.x % NS, c0 = cs * WC;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* pts = kts + warp * 16 * WLDA;
  float* dss = pts + 16 * LDP;
  static_assert(2 * 16 * LDP <= 16 * WLDA, "p^T and ds^T in k rows");
  const T* qh = q + b * vq.b + h * vq.h;
  const T* dh = dout + b * vdo.b + h * vdo.h;
  const T* kh = k + b * vk.b + h * vk.h;
  const T* vh = v + b * vv.b + h * vv.h;
  const size_t bhn = ((size_t)b * H + h) * N;
  const float* kw = kts + warp * 16 * WLDA;
  const float* vw = vts + warp * 16 * WLDA;
  float adk[WC / 8][4], adv[WC / 8][4];
#pragma unroll
  for (int j = 0; j < WC / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) adk[j][e] = adv[j][e] = 0.f;

  for (int q0 = 0; q0 < N; q0 += FTILE) {
    float sc[FTILE / 8][4], dp[FTILE / 8][4];
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
    for (int i = 1; i <= NS; ++i) {  // the slice's chunk last
      const int ch = (cs + i) % NS;
      __syncthreads();
      load_rows<T, WC, FROWS>(kts, WLDA, kh + ch * WC, vk.n, r0, M);
      load_rows<T, WC, FROWS>(vts, WLDA, vh + ch * WC, vv.n, r0, M);
      load_rows<T, WC, FTILE>(qs, WLDA, qh + ch * WC, vq.n, q0, N);
      load_rows<T, WC, FTILE>(dos, WLDA, dh + ch * WC, vdo.n, q0, N);
      if (i == 1 && threadIdx.x < FTILE) {
        const int n = q0 + threadIdx.x;
        // lse in log2 units, +inf past N so that p = 0 there
        ls[threadIdx.x] = n < N ? lse[bhn + n] * FLOG2E : INFINITY;
        dls[threadIdx.x] = n < N ? delta[bhn + n] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < WC / 8; ++kk) {
        Split af[4], av[4];
        a_frag(af, kw, WLDA, kk, g, t);
        a_frag(av, vw, WLDA, kk, g, t);
#pragma unroll
        for (int j = 0; j < FTILE / 8; ++j) {
          const int r = (j * 8 + g) * WLDA + kk * 8 + t;
          mma3<T>(sc[j], af, split(qs[r]), split(qs[r + 4]));
          mma3<T>(dp[j], av, split(dos[r]), split(dos[r + 4]));
        }
      }
    }
    __syncwarp();  // this warp's k rows read: p^T, ds^T go there
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      const int c = j * 8 + 2 * t;
      const float la = ls[c], lb = ls[c + 1], da = dls[c], db = dls[c + 1];
      const float p0 = exp2f(sc[j][0] * scale_log2 - la);
      const float p1 = exp2f(sc[j][1] * scale_log2 - lb);
      const float p2 = exp2f(sc[j][2] * scale_log2 - la);
      const float p3 = exp2f(sc[j][3] * scale_log2 - lb);
      *reinterpret_cast<float2*>(pts + g * LDP + c) = make_float2(rnd<T>(p0), rnd<T>(p1));
      *reinterpret_cast<float2*>(pts + (g + 8) * LDP + c) = make_float2(rnd<T>(p2), rnd<T>(p3));
      *reinterpret_cast<float2*>(dss + g * LDP + c) =
          make_float2(rnd<T>(p0 * (dp[j][0] - da)), rnd<T>(p1 * (dp[j][1] - db)));
      *reinterpret_cast<float2*>(dss + (g + 8) * LDP + c) =
          make_float2(rnd<T>(p2 * (dp[j][2] - da)), rnd<T>(p3 * (dp[j][3] - db)));
    }
    __syncwarp();
    // the slice's q and dO chunks are in qs, dos
#pragma unroll
    for (int kk = 0; kk < FTILE / 8; ++kk) {
      Split ap[4], as[4];
      a_frag(ap, pts, LDP, kk, g, t);
      a_frag(as, dss, LDP, kk, g, t);
#pragma unroll
      for (int j = 0; j < WC / 8; ++j) {
        const int r = (kk * 8 + t) * WLDA + j * 8 + g;
        mma3<T>(adv[j], ap, split(dos[r]), split(dos[r + 4 * WLDA]));
        mma3<T>(adk[j], as, split(qs[r]), split(qs[r + 4 * WLDA]));
      }
    }
  }

  const int n0 = r0 + warp * 16 + g, n1 = n0 + 8;
  T* ko = dk + b * vdk.b + h * vdk.h + c0;
  T* vo = dv + b * vdv.b + h * vdv.h + c0;
#pragma unroll
  for (int j = 0; j < WC / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < M) {
      store2(ko + (size_t)n0 * vdk.n + col, adk[j][0] * scale, adk[j][1] * scale);
      store2(vo + (size_t)n0 * vdv.n + col, adv[j][0], adv[j][1]);
    }
    if (n1 < M) {
      store2(ko + (size_t)n1 * vdk.n + col, adk[j][2] * scale, adk[j][3] * scale);
      store2(vo + (size_t)n1 * vdv.n + col, adv[j][2], adv[j][3]);
    }
  }
}

constexpr int WIDE_DQ_SMEM = (2 * FROWS * WLDA + 2 * FTILE * WLDA + FROWS) * 4;
constexpr int WIDE_DKV_SMEM = (2 * FROWS * WLDA + 2 * FTILE * WLDA + 2 * FTILE) * 4;

// The fused kernels' prep past 128, one warp a row of (B, N, H*D) x of T
// (rows in memory order); grid ceil(B*N*H / WPREP_ROWS), 32 * WPREP_ROWS
// threads. The RMSNorm over dn values (the true head dim; the padded lanes
// and their tables are zero), then the rotation with the folded tables.
// Q8: int8 levels per row into out, the row's scale max(|x^|, 1e-12) / 127
// into stat[bh * ss + n]. Else x^ in T into out and, by stat_kind, 1: ||x^||
// into stat[bh * N + n] (K1's q); 2: max ||x^||^2 into stat[bh] (K1's k); 3:
// max |x^| of x^ rounded to T into stat[bh] (K4's k); stat zero on entry
// for 2 and 3.
template <typename T, bool Q8>
__global__ void __launch_bounds__(32 * WPREP_ROWS)
wide_prep_kernel(const T* __restrict__ x, const float* __restrict__ c,
                 const float* __restrict__ s, void* __restrict__ out,
                 float* __restrict__ stat, int B, int N, int H, int D, int dn,
                 int ss, int stat_kind, float eps) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * WPREP_ROWS + warp;
  if (row >= (long long)B * N * H) return;  // the whole warp
  const int h = (int)(row % H), n = (int)(row / H % N), b = (int)(row / H / N);
  const int bh = b * H + h, pairs = D / 2;
  const T* xr = x + row * D;
  const float* cr = c + (size_t)n * D;
  const float* sr = s + (size_t)n * D;
  float ssq = 0.f;
  for (int i = lane; i < pairs; i += 32) {
    const float2 f = load_pair(xr, i);
    ssq += f.x * f.x + f.y * f.y;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ssq += __shfl_xor_sync(0xffffffffu, ssq, o);
  const float r = rsqrtf(ssq * (1.f / dn) + eps);
  auto rot = [&](int i, float& o0, float& o1) {
    const float2 f = load_pair(xr, i);
    const float a0 = f.x * r, a1 = f.y * r;
    o0 = a0 * cr[2 * i] - a1 * sr[2 * i];
    o1 = a1 * cr[2 * i + 1] + a0 * sr[2 * i + 1];
  };
  if constexpr (Q8) {
    float amax = 0.f, o0, o1;
    for (int i = lane; i < pairs; i += 32) {
      rot(i, o0, o1);
      amax = fmaxf(amax, fmaxf(fabsf(o0), fabsf(o1)));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
    const float sc = fmaxf(amax, 1e-12f) / 127.f;
    char2* dst = reinterpret_cast<char2*>(static_cast<int8_t*>(out) + row * D);
    for (int i = lane; i < pairs; i += 32) {
      rot(i, o0, o1);
      dst[i] = make_char2((signed char)quant8(o0, sc), (signed char)quant8(o1, sc));
    }
    if (lane == 0) stat[(size_t)bh * ss + n] = sc;
  } else {
    T* dst = static_cast<T*>(out) + row * D;
    float nn = 0.f, mx = 0.f, o0, o1;
    for (int i = lane; i < pairs; i += 32) {
      rot(i, o0, o1);
      store_pair(dst, i, o0, o1);
      nn += o0 * o0 + o1 * o1;
      mx = fmaxf(mx, fmaxf(fabsf(rnd<T>(o0)), fabsf(rnd<T>(o1))));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      nn += __shfl_xor_sync(0xffffffffu, nn, o);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
    }
    if (lane == 0 && stat_kind == 1) stat[(size_t)bh * N + n] = sqrtf(nn);
    if (lane == 0 && stat_kind == 2)
      atomicMax(reinterpret_cast<int*>(stat + bh), __float_as_int(nn));
    if (lane == 0 && stat_kind == 3)
      atomicMax(reinterpret_cast<int*>(stat + bh), __float_as_int(mx));
  }
}

// V^T in int8 past 128 (K8a, K8b): v_q[bh][d][np keys], v_perm-ordered in
// each 32-key chunk, keys past N zero, from v_amax (B*H, D); one thread a
// 4-byte word, grid ceil(B*H*D*np / 4 / 256).
template <typename T>
__global__ void __launch_bounds__(256)
wide_v_quant_kernel(const T* __restrict__ v, const float* __restrict__ v_amax,
                    int8_t* __restrict__ v_q, int B, int N, int H, int D,
                    int np) {
  const long long w = (long long)blockIdx.x * 256 + threadIdx.x;
  const long long words = (long long)B * H * D * (np / 4);
  if (w >= words) return;
  const int kap = (int)(w % (np / 4)) * 4;
  const long long bhd = w / (np / 4);
  const int d = (int)(bhd % D), bh = (int)(bhd / D), b = bh / H, h = bh % H;
  const float sc = fmaxf(v_amax[bhd], 1e-12f) / 127.f;
  const int chunk = kap & ~31;
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = chunk + v_perm((kap & 31) + i);
    const float x = key < N ? to_f(v[((size_t)b * N + key) * H * D + (size_t)h * D + d]) : 0.f;
    word |= (uint32_t)(quant8(x, sc) & 0xff) << (8 * i);
  }
  *reinterpret_cast<uint32_t*>(v_q + w * 4) = word;
}

// ---- host side ------------------------------------------------------------

template <typename Kernel>
int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// a head dim the wide kernels take: a multiple of WC past it
inline bool wide_dim(int D) { return D > WC && D % WC == 0; }

template <typename T, int D>
int launch_fwd(const T* q, const T* k, const T* v, T* o, View vq, View vk,
               View vv, View vo, float* lse, float scale_log2, int B, int H,
               int N, int M, cudaStream_t st) {
  auto kernel = attn_fp32_kernel<T, D>;
  const int e = opt_in(kernel, fwd_smem_bytes<D>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, fwd_smem_bytes<D>(), st>>>(
      q, k, v, o, vq, vk, vv, vo, lse, scale_log2, N, M, H);
  return (int)cudaGetLastError();
}

// the wide forward on `a` (its N, H, D), instance <T, QK8, PV8>
template <typename T, bool QK8, bool PV8>
int launch_wide_fwd(const WideFwd& a, int B, cudaStream_t st) {
  auto kernel = wide_attn_kernel<T, QK8, PV8>;
  constexpr int bytes = WideSmem<QK8, PV8>::BYTES;
  const int e = opt_in(kernel, bytes);
  if (e != 0) return e;
  dim3 grid((a.N + FROWS - 1) / FROWS * (a.D / WC), a.H, B);
  kernel<<<grid, FTHREADS, bytes, st>>>(a);
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
  return launch_fwd<float, D>(static_cast<const float*>(q_prep),
                              static_cast<const float*>(k_prep),
                              static_cast<const float*>(v),
                              static_cast<float*>(out), vh, vh, vh, vh,
                              nullptr, 1.f, B, H, N, N, st);
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

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              const long long* st, int B, int H, int N, int M, float scale,
              cudaStream_t stream) {
  auto kernel = dq_fp32_kernel<T, D>;
  const int e = opt_in(kernel, dq_smem_bytes<D>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, dq_smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), view_at(st, 0),
      view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
      view_at(st, 5), N, M, H, scale * FLOG2E, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int N, int M, float scale,
               cudaStream_t stream) {
  auto kernel = dkv_fp32_kernel<T, D>;
  const int e = opt_in(kernel, dkv_smem_bytes<D>());
  if (e != 0) return e;
  dim3 grid((M + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, dkv_smem_bytes<D>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), view_at(st, 0),
      view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
      view_at(st, 5), N, M, H, scale * FLOG2E, scale);
  return (int)cudaGetLastError();
}

// K5 past 128: the wide forward on raw q, k, v, online, lse out
template <typename T>
int launch_wide_flash(const void* q, const void* k, const void* v, void* o,
                      void* lse, const long long* strides, int B, int H,
                      int N, int M, int D, float scale, cudaStream_t st) {
  WideFwd a{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.vq = view_at(strides, 0);
  a.vk = view_at(strides, 1);
  a.vv = view_at(strides, 2);
  a.vo = view_at(strides, 3);
  a.lse = static_cast<float*>(lse);
  a.scale_log2 = scale * FLOG2E;
  a.N = N;
  a.M = M;
  a.H = H;
  a.D = D;
  a.mode = W_ONLINE;
  return launch_wide_fwd<T, false, false>(a, B, st);
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, const long long* strides, int B, int H, int N,
              int M, int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_dim(D))
    return launch_wide_flash<T>(q, k, v, o, lse, strides, B, H, N, M, D, scale, st);
  if constexpr (std::is_same<T, float>::value) {
    const T *fq = static_cast<const T*>(q), *fk = static_cast<const T*>(k),
            *fv = static_cast<const T*>(v);
    T* fo = static_cast<T*>(o);
    float* fl = static_cast<float*>(lse);
    const View a = view_at(strides, 0), bk = view_at(strides, 1),
               c = view_at(strides, 2), d = view_at(strides, 3);
    const float sl = scale * FLOG2E;
    switch (D) {
      case 16: return launch_fwd<T, 16>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, M, st);
      case 32: return launch_fwd<T, 32>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, M, st);
      case 64: return launch_fwd<T, 64>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, M, st);
      case 128: return launch_fwd<T, 128>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, M, st);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int flash_dq(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             const long long* strides, int B, int H, int N, int M, int D,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_dim(D)) {
    auto kernel = wide_dq_kernel<T>;
    const int e = opt_in(kernel, WIDE_DQ_SMEM);
    if (e != 0) return e;
    dim3 grid((N + FROWS - 1) / FROWS * (D / WC), H, B);
    kernel<<<grid, FTHREADS, WIDE_DQ_SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(o),
        static_cast<const T*>(dout), static_cast<const float*>(lse),
        static_cast<float*>(delta), static_cast<T*>(dq), view_at(strides, 0),
        view_at(strides, 1), view_at(strides, 2), view_at(strides, 3),
        view_at(strides, 4), view_at(strides, 5), N, M, H, D, scale * FLOG2E,
        scale);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 16: return launch_dq<T, 16>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
      case 32: return launch_dq<T, 32>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
      case 64: return launch_dq<T, 64>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
      case 128: return launch_dq<T, 128>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              const long long* strides, int B, int H, int N, int M, int D,
              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (wide_dim(D)) {
    auto kernel = wide_dkv_kernel<T>;
    const int e = opt_in(kernel, WIDE_DKV_SMEM);
    if (e != 0) return e;
    dim3 grid((M + FROWS - 1) / FROWS * (D / WC), H, B);
    kernel<<<grid, FTHREADS, WIDE_DKV_SMEM, st>>>(
        static_cast<const T*>(q), static_cast<const T*>(k),
        static_cast<const T*>(v), static_cast<const T*>(dout),
        static_cast<const float*>(lse), static_cast<const float*>(delta),
        static_cast<T*>(dk), static_cast<T*>(dv), view_at(strides, 0),
        view_at(strides, 1), view_at(strides, 2), view_at(strides, 3),
        view_at(strides, 4), view_at(strides, 5), N, M, H, D, scale * FLOG2E,
        scale);
    return (int)cudaGetLastError();
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
      case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
      case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
      case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}

// The scratch of the int8 entry points, as attention_int8_sm90.cu's Args
// with fp32 rows: q_prep (B, N, H*D) int8 under int8 scores, else fp32;
// q_scale (B*H, N) fp32 (int8 scores); k_prep (B, N, H*D) fp32 (K4, K8a,
// K8b over fp32 scores); k_q (B, N, H*D) int8 (int8 scores); k_stat (B*H)
// fp32, zero on entry, or (B*H, np) per-key scales (K7q, K8b over K7q);
// v_amax (B*H, D) fp32, zero on entry, v_q (B*H, D, np) int8 (int8 P.V); np
// = N rounded up to PV8_BLOCK. The wide entry points take the same, in the
// element type T of their rows, with q_scale also K1's ||q^|| per row and
// k_stat K1's max ||k^||^2 per (b, h).
struct Q8Args {
  const void *q, *k, *v, *cq, *sq, *ck, *sk;
  void *q_prep, *q_scale, *k_prep, *k_q, *k_stat, *v_amax, *v_q, *out;
  int B, N, H, dn;
  float eps_q, eps_k;
  cudaStream_t st;
};

// The q, K (and V) preps on fp32 rows, then the attention; the first error.
// TWO_PASS: the single-KV kernels (K4, K8a: one k scale per (b, h), the
// true row max); else the streaming ones (K7q, K8b: per-row k scales, K8b's
// 128-key blocks).
template <int D, bool QK8, bool PV8, bool TWO_PASS>
int launch_q8_fp32(const Q8Args& a) {
  using S = Q8Smem<D, QK8, PV8>;
  constexpr int TAG = TWO_PASS ? (PV8 ? 81 : 4) : PV8 ? 8 : 7;
  const int B = a.B, N = a.N, H = a.H;
  const int np = (N + PV8_BLOCK - 1) / PV8_BLOCK * PV8_BLOCK;
  int e;
  if constexpr (QK8)
    e = launch_q8rows<D, TAG, float>(a.q, a.cq, a.sq, a.q_prep, a.q_scale, B,
                                     N, H, N, a.eps_q, a.dn, a.st);
  else
    e = launch_q_prep<D, false, float>(a.q, a.cq, a.sq, a.q_prep, nullptr, B,
                                       N, H, a.eps_q, a.dn, a.st);
  if (e != 0) return e;
  if constexpr (QK8 && TWO_PASS)
    e = launch_k_prep_q8bh<D, float>(a.k, a.ck, a.sk, a.k_prep, a.k_q,
                                     a.k_stat, B, N, H, a.eps_k, a.dn, a.st);
  else if constexpr (QK8)
    e = launch_q8rows<D, TAG, float>(a.k, a.ck, a.sk, a.k_q, a.k_stat, B, N,
                                     H, np, a.eps_k, a.dn, a.st);
  else
    e = launch_k_prep<D, false, float>(a.k, a.ck, a.sk, a.k_prep, a.k_stat,
                                       B, N, H, a.eps_k, a.dn, a.st);
  if (e != 0) return e;
  if constexpr (PV8) {
    e = launch_v_prep<D, float>(a.v, a.v_amax, a.v_q, B, N, H, np, a.st);
    if (e != 0) return e;
  }
  auto kernel = attn_q8_fp32_kernel<D, QK8, PV8>;
  e = opt_in(kernel, S::BYTES);
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS, H, B);
  kernel<<<grid, FTHREADS, S::BYTES, a.st>>>(
      a.q_prep, QK8 ? a.k_q : a.k_prep,
      static_cast<const float*>(a.v), static_cast<const int8_t*>(a.v_q),
      static_cast<const float*>(a.q_scale), static_cast<const float*>(a.k_stat),
      static_cast<const float*>(a.v_amax), static_cast<float*>(a.out), N, H,
      np, TWO_PASS ? N : PV8_BLOCK, QK8 && !TWO_PASS);
  return (int)cudaGetLastError();
}

template <bool QK8, bool PV8, bool TWO_PASS>
int dispatch_q8(const Q8Args& a, int D) {
  switch (D) {
    case 16: return launch_q8_fp32<16, QK8, PV8, TWO_PASS>(a);
    case 32: return launch_q8_fp32<32, QK8, PV8, TWO_PASS>(a);
    case 64: return launch_q8_fp32<64, QK8, PV8, TWO_PASS>(a);
    case 128: return launch_q8_fp32<128, QK8, PV8, TWO_PASS>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

// wide_prep_kernel<T, Q8> over every row of (B, N, H*D) x; the CUDA error
template <typename T, bool Q8>
int launch_wide_prep(const void* x, const void* c, const void* s, void* out,
                     void* stat, int B, int N, int H, int D, int dn, int ss,
                     int stat_kind, float eps, cudaStream_t st) {
  const long long rows = (long long)B * N * H;
  wide_prep_kernel<T, Q8><<<(unsigned)((rows + WPREP_ROWS - 1) / WPREP_ROWS),
                            32 * WPREP_ROWS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const float*>(c),
      static_cast<const float*>(s), out, static_cast<float*>(stat), B, N, H,
      D, dn, ss, stat_kind, eps);
  return (int)cudaGetLastError();
}

// The fused kernels past head dim 128 (D a multiple of 128), T their rows'
// type: the preps in their own launches (q^ with the fold; k^; V's levels
// under int8 P.V), then the wide forward on them. kind: the TPU kernel (1
// K1, 7 K7, 4 K4, 71 K7q, 81 K8a, 82 K8b); int8_qk picks K8a / K8b's scores.
// The softmax: K1 in bf16 its bound; the fp32 instances online, as K1F ..
// K7qF; the bf16 ones and int8 P.V blocked (the true row max for K4, K8a;
// blocks of PV8_BLOCK keys for K7, K7q, K8b), as their bf16 kernels and
// plain versions take it. The first error.
template <typename T>
int fused_wide(const Q8Args& a, int D, int kind, int int8_qk) {
  constexpr bool F32 = std::is_same<T, float>::value;
  const int B = a.B, N = a.N, H = a.H;
  const int np = (N + PV8_BLOCK - 1) / PV8_BLOCK * PV8_BLOCK;
  const bool pv8 = kind == 81 || kind == 82;
  const bool qk8 = kind == 4 || kind == 71 || (pv8 && int8_qk);
  const bool per_key = qk8 && (kind == 71 || kind == 82);
  const bool bounded = kind == 1 && !F32;
  if (!wide_dim(D)) return (int)cudaErrorInvalidValue;
  int e = qk8 ? launch_wide_prep<T, true>(a.q, a.cq, a.sq, a.q_prep, a.q_scale,
                                         B, N, H, D, a.dn, N, 0, a.eps_q, a.st)
              : launch_wide_prep<T, false>(a.q, a.cq, a.sq, a.q_prep,
                                          a.q_scale, B, N, H, D, a.dn, N,
                                          bounded ? 1 : 0, a.eps_q, a.st);
  if (e != 0) return e;
  if (per_key) {
    e = launch_wide_prep<T, true>(a.k, a.ck, a.sk, a.k_q, a.k_stat, B, N, H,
                                  D, a.dn, np, 0, a.eps_k, a.st);
  } else if (qk8) {  // K4's k: k^ in T with its amax per (b, h), then int8
    e = launch_wide_prep<T, false>(a.k, a.ck, a.sk, a.k_prep, a.k_stat, B, N,
                                   H, D, a.dn, N, 3, a.eps_k, a.st);
    if (e == 0) {
      const size_t total = (size_t)B * N * H * D;
      const size_t blocks = (total / 8 + QUANT_THREADS - 1) / QUANT_THREADS;
      k_quant_kernel<T><<<(unsigned)blocks, QUANT_THREADS, 0, a.st>>>(
          static_cast<const T*>(a.k_prep), static_cast<const float*>(a.k_stat),
          static_cast<int8_t*>(a.k_q), total, N, H, D);
      e = (int)cudaGetLastError();
    }
  } else {
    e = launch_wide_prep<T, false>(a.k, a.ck, a.sk, a.k_prep, a.k_stat, B, N,
                                   H, D, a.dn, N, bounded ? 2 : 0, a.eps_k,
                                   a.st);
  }
  if (e != 0) return e;
  if (pv8) {
    const int rows = v_amax_rows(B, N);
    dim3 g1((N + rows - 1) / rows, B);
    v_amax_kernel<T><<<g1, v_amax_threads(H * D), 0, a.st>>>(
        static_cast<const T*>(a.v), static_cast<float*>(a.v_amax), N, H * D,
        rows);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
    const long long words = (long long)B * H * D * (np / 4);
    wide_v_quant_kernel<T><<<(unsigned)((words + 255) / 256), 256, 0, a.st>>>(
        static_cast<const T*>(a.v), static_cast<const float*>(a.v_amax),
        static_cast<int8_t*>(a.v_q), B, N, H, D, np);
    e = (int)cudaGetLastError();
    if (e != 0) return e;
  }
  WideFwd f{};
  const View vh{(long long)N * H * D, D, (long long)H * D};
  f.q = a.q_prep;
  f.k = qk8 ? a.k_q : a.k_prep;
  f.v = a.v;
  f.o = a.out;
  f.vq = f.vk = f.vv = f.vo = vh;
  f.v_q = static_cast<const int8_t*>(a.v_q);
  f.v_amax = static_cast<const float*>(a.v_amax);
  f.q_stat = static_cast<const float*>(a.q_scale);
  f.k_stat = static_cast<const float*>(a.k_stat);
  f.scale_log2 = 1.f;  // q^ carries scale log2(e)
  f.N = f.M = N;
  f.H = H;
  f.D = D;
  f.np = np;
  f.mode = bounded ? W_BOUNDED : (F32 && !pv8) ? W_ONLINE : W_BLOCKED;
  f.sblock = (kind == 4 || kind == 81) ? N : PV8_BLOCK;
  f.per_key = per_key;
  if (pv8)
    return qk8 ? launch_wide_fwd<T, true, true>(f, B, a.st)
               : launch_wide_fwd<T, false, true>(f, B, a.st);
  return qk8 ? launch_wide_fwd<T, true, false>(f, B, a.st)
             : launch_wide_fwd<T, false, false>(f, B, a.st);
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

// K4, K7q, K8a and K8b on fp32 rows: the signature of
// attention_int8_sm90.cu's entry points, q, k, v, out fp32 and the scratch
// of Q8Args; D the instance (16, 32, 64, 128), dn <= D the model's head dim.
#define SD3_Q8_FP32_PARAMS                                                    \
  const void *q, const void *k, const void *v, const void *cq,               \
      const void *sq, const void *ck, const void *sk, void *q_prep,          \
      void *q_scale, void *k_prep, void *k_q, void *k_stat, void *v_amax,    \
      void *v_q, void *out, int B, int N, int H, int D, int dn, int int8_qk, \
      float eps_q, float eps_k, void *stream
#define SD3_Q8_FP32_ARGS                                                      \
  Q8Args{q,      k,      v,   cq,    sq,    ck, sk, q_prep, q_scale, k_prep,  \
         k_q,    k_stat, v_amax, v_q, out, B, N, H, dn, eps_q, eps_k,        \
         static_cast<cudaStream_t>(stream)}

// K4: int8 QK^T with one k scale per (b, h), fp32 P.V.
extern "C" int sd3_fused_attention_int8qk_fp32(SD3_Q8_FP32_PARAMS) {
  (void)int8_qk;
  return dispatch_q8<true, false, true>(SD3_Q8_FP32_ARGS, D);
}

// K7q: int8 QK^T with per-row k scales, fp32 P.V.
extern "C" int sd3_fused_attention_stream_int8qk_fp32(SD3_Q8_FP32_PARAMS) {
  (void)int8_qk;
  return dispatch_q8<true, false, false>(SD3_Q8_FP32_ARGS, D);
}

// K8a: int8 P.V against the true row max, over fp32 scores or (int8_qk)
// K4's.
extern "C" int sd3_fused_attention_int8pv_fp32(SD3_Q8_FP32_PARAMS) {
  return int8_qk ? dispatch_q8<true, true, true>(SD3_Q8_FP32_ARGS, D)
                 : dispatch_q8<false, true, true>(SD3_Q8_FP32_ARGS, D);
}

// K8b: int8 P.V per 128-key block, over fp32 scores or (int8_qk) K7q's.
extern "C" int sd3_fused_attention_stream_int8pv_fp32(SD3_Q8_FP32_PARAMS) {
  return int8_qk ? dispatch_q8<true, true, false>(SD3_Q8_FP32_ARGS, D)
                 : dispatch_q8<false, true, false>(SD3_Q8_FP32_ARGS, D);
}

// K1, K7, K4, K7q, K8a and K8b past head dim 128, on bf16 (`_wide`) or fp32
// (`_wide_fp32`) q, k, v, out: the scratch of Q8Args in the rows' type;
// D a multiple of 128 past it (the instance), dn <= D the model's head dim;
// kind the TPU kernel (1, 7, 4, 71: K7q, 81: K8a, 82: K8b), int8_qk the
// scores of K8a / K8b.
#define SD3_WIDE_PARAMS                                                       \
  const void *q, const void *k, const void *v, const void *cq,               \
      const void *sq, const void *ck, const void *sk, void *q_prep,          \
      void *q_scale, void *k_prep, void *k_q, void *k_stat, void *v_amax,    \
      void *v_q, void *out, int B, int N, int H, int D, int dn, int kind,    \
      int int8_qk, float eps_q, float eps_k, void *stream

extern "C" int sd3_fused_attention_wide(SD3_WIDE_PARAMS) {
  return fused_wide<bf16>(SD3_Q8_FP32_ARGS, D, kind, int8_qk);
}

extern "C" int sd3_fused_attention_wide_fp32(SD3_WIDE_PARAMS) {
  return fused_wide<float>(SD3_Q8_FP32_ARGS, D, kind, int8_qk);
}

// K5, K6a, K6b: the signatures of the bf16 entry points (attention_sm90.cu,
// flash_bwd_sm90.cu: q, o, dO, dq with N rows, k, v, dk, dv with M); views
// with 16-byte aligned starts and (b, h, n)
// strides. The fp32 entry points take head dims 16, 32, 64, 128 and every
// multiple of 128 past it, every tensor fp32; the `_wide` ones bf16 tensors
// (lse, delta fp32) at the multiples of 128 past it.
extern "C" int sd3_flash_attention_fwd_fp32(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            const long long* strides, int B,
                                            int H, int N, int M, int D,
                                            float scale, void* stream) {
  return flash_fwd<float>(q, k, v, o, lse, strides, B, H, N, M, D, scale, stream);
}

extern "C" int sd3_flash_attention_fwd_wide(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            const long long* strides, int B,
                                            int H, int N, int M, int D,
                                            float scale, void* stream) {
  return flash_fwd<bf16>(q, k, v, o, lse, strides, B, H, N, M, D, scale, stream);
}

#define SD3_DQ_PARAMS                                                         \
  const void *q, const void *k, const void *v, const void *o,                \
      const void *dout, const void *lse, void *delta, void *dq,              \
      const long long *strides, int B, int H, int N, int M, int D,           \
      float scale, void *stream
#define SD3_DQ_PASS q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, D, scale, stream

extern "C" int sd3_flash_attention_dq_fp32(SD3_DQ_PARAMS) {
  return flash_dq<float>(SD3_DQ_PASS);
}

extern "C" int sd3_flash_attention_dq_wide(SD3_DQ_PARAMS) {
  return flash_dq<bf16>(SD3_DQ_PASS);
}

#define SD3_DKV_PARAMS                                                        \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta, void *dk, void *dv,                \
      const long long *strides, int B, int H, int N, int M, int D,           \
      float scale, void *stream
#define SD3_DKV_PASS q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, D, scale, stream

extern "C" int sd3_flash_attention_dkv_fp32(SD3_DKV_PARAMS) {
  return flash_dkv<float>(SD3_DKV_PASS);
}

extern "C" int sd3_flash_attention_dkv_wide(SD3_DKV_PARAMS) {
  return flash_dkv<bf16>(SD3_DKV_PASS);
}
