// The shared-memory mma.sync instances of the attention kernels for NVIDIA
// Hopper (sm_90a):
//   - the fp32 instances of the joint-attention forwards K1 and K7 (with
//     their q / k prep) and of the flash-attention forward K5 and backward
//     K6a, K6b, on fp32 q, k, v, o, dO, at head dims 16-256;
//   - the head-dim-256 instances of K5, K6a and K6b on bf16 (the wgmma
//     kernels of attention_sm90.cu and flash_bwd_sm90.cu stop at 128);
//   - the fp32 instances of the int8 joint attentions K4, K7q, K8a and K8b
//     (fp32 rows under `--dtype float32 --quant int8`).
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
//   K6b `_dkv_kernel` (:222): dkv_fp32_kernel.
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
// attention_common.cuh v_perm). Head dims past 128 (the flash kernels at
// 256) split the output's columns into slices of 128, one block each, each
// recomputing the scores over the whole head dim, so a thread holds the
// accumulators of 128 columns at most. No TMA, no wgmma, no overlap of loads
// and products (wgmma's tf32 form reads both shared-memory operands K-major
// only, so P.V and the backward's p^T dO, ds^T q would need transposed
// copies: left for a later redesign).
//
// What bounds them on this card: 3xTF32 is three tf32 products, so the
// tensor cores take 3 * 4 B H N^2 D FLOP (forward) at 495 TFLOP/s; at the
// 512px slice shape (B 8, H 19, N 1178, D 64) that is 162 G FLOP, 0.327
// ms, against 92 MB x 2 of fp32 q, k, v, o (0.055 ms at 3.35 TB/s): the
// products bound it. The bf16 D 256 instances: one tf32 pass, 4 B H N^2 D
// at 495 TFLOP/s. The int8 instances: the int8 product at 1,979 TOP/s and
// the fp32 one in 3xTF32. PERF.md has the measured times.

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int FROWS = 64;            // rows of a block (16 per warp)
constexpr int FTILE = 32;            // keys (queries for K6b) per tile
constexpr int FTHREADS = 128;
constexpr int MAX_DO = 128;          // output columns a block takes
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

// Shared memory of the kernels, in floats; DO the output columns of a block
template <int D, int DO = D>
struct F32Smem {
  static constexpr int LDA = D + 4;   // rows read as A or as "n g" B
  static constexpr int LDB = DO + 8;  // rows read as "k t" B
  static constexpr int LDP = FTILE + 4;
};

// ---- forward: K1, K7 (fp32) and K5 (fp32; bf16 at D 256) -------------------

// grid (ceil(N / 64) * D / DO, H, B), FTHREADS threads, dynamic shared
// memory: q (64 x LDA), k (32 x LDA), v (32 x LDB: the block's DO columns),
// p (4 x 16 x LDP). o = softmax(q k^T scale_log2 in exp2) v; scores are s *
// scale_log2 in exp2 units (K1 / K7: q^ carries scale log2(e), scale_log2 =
// 1). Block x takes rows (x / (D / DO)) * 64 and columns (x % (D / DO)) *
// DO of o. lse (B*H, N) written (by the first column slice) when not null.
template <typename T, int D, int DO>
__global__ void __launch_bounds__(FTHREADS)
attn_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o, View vq,
                 View vk, View vv, View vo, float* __restrict__ lse,
                 float scale_log2, int N, int H) {
  using S = F32Smem<D, DO>;
  constexpr int NS = D / DO;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* ks = qs + FROWS * S::LDA;
  float* vs = ks + FTILE * S::LDA;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x / NS * FROWS, c0 = blockIdx.x % NS * DO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* ps = vs + FTILE * S::LDB + warp * 16 * S::LDP;
  const T* qh = q + b * vq.b + h * vq.h;
  const T* kh = k + b * vk.b + h * vk.h;
  const T* vh = v + b * vv.b + h * vv.h + c0;

  load_rows<T, D, FROWS>(qs, S::LDA, qh, vq.n, q0, N);
  float acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  const float* qw = qs + warp * 16 * S::LDA;

  for (int k0 = 0; k0 < N; k0 += FTILE) {
    __syncthreads();  // the last tile's k and v are read
    load_rows<T, D, FTILE>(ks, S::LDA, kh, vk.n, k0, N);
    load_rows<T, DO, FTILE>(vs, S::LDB, vh, vv.n, k0, N);
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
    for (int j = 0; j < DO / 8; ++j) {
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
      for (int j = 0; j < DO / 8; ++j)
        mma3<T>(acc[j], a, split(vs[(kk * 8 + t) * S::LDB + j * 8 + g]),
                split(vs[(kk * 8 + t + 4) * S::LDB + j * 8 + g]));
    }
    __syncwarp();  // p read before the next tile writes it
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  T* oh = o + b * vo.b + h * vo.h + c0;
  const float i0 = 1.f / l0, i1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N) store2(oh + (size_t)n0 * vo.n + col, acc[j][0] * i0, acc[j][1] * i0);
    if (n1 < N) store2(oh + (size_t)n1 * vo.n + col, acc[j][2] * i1, acc[j][3] * i1);
  }
  if (lse != nullptr && c0 == 0 && t == 0) {
    float* lh = lse + ((size_t)b * H + h) * N;
    if (n0 < N) lh[n0] = (m0 + log2f(l0)) * FLN2;
    if (n1 < N) lh[n1] = (m1 + log2f(l1)) * FLN2;
  }
}

template <int D, int DO>
constexpr int fwd_smem_bytes() {
  using S = F32Smem<D, DO>;
  return (FROWS * S::LDA + FTILE * S::LDA + FTILE * S::LDB + 4 * 16 * S::LDP) * 4;
}

// ---- K6a (fp32; bf16 at D 256): dq, delta ---------------------------------

// grid (ceil(N / 64) * D / DO, H, B), FTHREADS threads, dynamic shared
// memory: q, dO (64 x LDA each), k, v (32 x LDA each), ds (4 x 16 x LDP),
// delta of the block's rows (64). Block x: rows and dq columns as in the
// forward; delta written by the first column slice.
template <typename T, int D, int DO>
__global__ void __launch_bounds__(FTHREADS)
dq_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, const T* __restrict__ o,
               const T* __restrict__ dout, const float* __restrict__ lse,
               float* __restrict__ delta, T* __restrict__ dq, View vq,
               View vk, View vv, View vo, View vdo, View vdq, int N, int H,
               float scale_log2, float scale) {
  using S = F32Smem<D, DO>;
  constexpr int NS = D / DO;
  extern __shared__ float4 smem_f4[];
  float* qs = reinterpret_cast<float*>(smem_f4);
  float* dos = qs + FROWS * S::LDA;
  float* ks = dos + FROWS * S::LDA;
  float* vs = ks + FTILE * S::LDA;
  float* dls = vs + FTILE * S::LDA;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x / NS * FROWS, c0 = blockIdx.x % NS * DO;
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
      if (n < N && c0 == 0) delta[bhn + n] = sum;
    }
  }
  __syncthreads();  // delta kept, q and dO loaded
  const int n0 = q0 + warp * 16 + g, n1 = n0 + 8;
  const float d0 = dls[warp * 16 + g], d1 = dls[warp * 16 + g + 8];
  const float L0 = n0 < N ? lse[bhn + n0] * FLOG2E : 0.f;
  const float L1 = n1 < N ? lse[bhn + n1] * FLOG2E : 0.f;
  const float* qw = qs + warp * 16 * S::LDA;
  const float* dw = dos + warp * 16 * S::LDA;
  float acc[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  for (int k0 = 0; k0 < N; k0 += FTILE) {
    __syncthreads();
    load_rows<T, D, FTILE>(ks, S::LDA, kh, vk.n, k0, N);
    load_rows<T, D, FTILE>(vs, S::LDA, vh, vv.n, k0, N);
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
    // ds = p (dp - delta), rounded to T, keys past N with p = 0, into this
    // warp's tile
#pragma unroll
    for (int j = 0; j < FTILE / 8; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * t + (e & 1);
        const float p = key < N ? exp2f(sc[j][e] * scale_log2 - (e < 2 ? L0 : L1))
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
      for (int j = 0; j < DO / 8; ++j)
        mma3<T>(acc[j], a, split(ks[(kk * 8 + t) * S::LDA + c0 + j * 8 + g]),
                split(ks[(kk * 8 + t + 4) * S::LDA + c0 + j * 8 + g]));
    }
    __syncwarp();
  }

  T* qh = dq + b * vdq.b + h * vdq.h + c0;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N)
      store2(qh + (size_t)n0 * vdq.n + col, acc[j][0] * scale, acc[j][1] * scale);
    if (n1 < N)
      store2(qh + (size_t)n1 * vdq.n + col, acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int D, int DO>
constexpr int dq_smem_bytes() {
  using S = F32Smem<D, DO>;
  return (2 * FROWS * S::LDA + 2 * FTILE * S::LDA + FROWS + 4 * 16 * S::LDP) * 4;
}

// ---- K6b (fp32; bf16 at D 256): dk, dv ------------------------------------

// grid (ceil(N / 64) * D / DO, H, B): 64 key rows a block, 16 a warp, and
// DO columns of dk and dv; FTHREADS threads, dynamic shared memory: k, v
// (64 x LDA each), q, dO (32 x LDA each), lse, delta of the query tile (32
// each), p^T and ds^T (4 x 16 x LDP each).
template <typename T, int D, int DO>
__global__ void __launch_bounds__(FTHREADS)
dkv_fp32_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                T* __restrict__ dk, T* __restrict__ dv, View vq,
                View vk, View vv, View vdo, View vdk, View vdv, int N, int H,
                float scale_log2, float scale) {
  using S = F32Smem<D, DO>;
  constexpr int NS = D / DO;
  extern __shared__ float4 smem_f4[];
  float* kts = reinterpret_cast<float*>(smem_f4);
  float* vts = kts + FROWS * S::LDA;
  float* qs = vts + FROWS * S::LDA;
  float* dos = qs + FTILE * S::LDA;
  float* ls = dos + FTILE * S::LDA;
  float* dls = ls + FTILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const int r0 = blockIdx.x / NS * FROWS, c0 = blockIdx.x % NS * DO;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float* pts = dls + FTILE + warp * 2 * 16 * S::LDP;
  float* dss = pts + 16 * S::LDP;
  const T* qh = q + b * vq.b + h * vq.h;
  const T* dh = dout + b * vdo.b + h * vdo.h;
  const size_t bhn = ((size_t)b * H + h) * N;

  load_rows<T, D, FROWS>(kts, S::LDA, k + b * vk.b + h * vk.h, vk.n, r0, N);
  load_rows<T, D, FROWS>(vts, S::LDA, v + b * vv.b + h * vv.h, vv.n, r0, N);
  const float* kw = kts + warp * 16 * S::LDA;
  const float* vw = vts + warp * 16 * S::LDA;
  float adk[DO / 8][4], adv[DO / 8][4];
#pragma unroll
  for (int j = 0; j < DO / 8; ++j)
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
      for (int j = 0; j < DO / 8; ++j) {
        const int r = (kk * 8 + t) * S::LDA + c0 + j * 8 + g;
        mma3<T>(adv[j], ap, split(dos[r]), split(dos[r + 4 * S::LDA]));
        mma3<T>(adk[j], as, split(qs[r]), split(qs[r + 4 * S::LDA]));
      }
    }
    __syncwarp();
  }

  const int n0 = r0 + warp * 16 + g, n1 = n0 + 8;
  T* kh = dk + b * vdk.b + h * vdk.h + c0;
  T* vh = dv + b * vdv.b + h * vdv.h + c0;
#pragma unroll
  for (int j = 0; j < DO / 8; ++j) {
    const int col = j * 8 + 2 * t;
    if (n0 < N) {
      store2(kh + (size_t)n0 * vdk.n + col, adk[j][0] * scale, adk[j][1] * scale);
      store2(vh + (size_t)n0 * vdv.n + col, adv[j][0], adv[j][1]);
    }
    if (n1 < N) {
      store2(kh + (size_t)n1 * vdk.n + col, adk[j][2] * scale, adk[j][3] * scale);
      store2(vh + (size_t)n1 * vdv.n + col, adv[j][2], adv[j][3]);
    }
  }
}

template <int D, int DO>
constexpr int dkv_smem_bytes() {
  using S = F32Smem<D, DO>;
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

// ---- host side ------------------------------------------------------------

template <typename Kernel>
int opt_in(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the output columns of a block at head dim D
template <int D>
constexpr int out_cols() {
  return D > MAX_DO ? MAX_DO : D;
}

template <typename T, int D>
int launch_fwd(const T* q, const T* k, const T* v, T* o, View vq, View vk,
               View vv, View vo, float* lse, float scale_log2, int B, int H,
               int N, cudaStream_t st) {
  constexpr int DO = out_cols<D>();
  auto kernel = attn_fp32_kernel<T, D, DO>;
  const int e = opt_in(kernel, fwd_smem_bytes<D, DO>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS * (D / DO), H, B);
  kernel<<<grid, FTHREADS, fwd_smem_bytes<D, DO>(), st>>>(
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
  return launch_fwd<float, D>(static_cast<const float*>(q_prep),
                              static_cast<const float*>(k_prep),
                              static_cast<const float*>(v),
                              static_cast<float*>(out), vh, vh, vh, vh,
                              nullptr, 1.f, B, H, N, st);
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
              const long long* st, int B, int H, int N, float scale,
              cudaStream_t stream) {
  constexpr int DO = out_cols<D>();
  auto kernel = dq_fp32_kernel<T, D, DO>;
  const int e = opt_in(kernel, dq_smem_bytes<D, DO>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS * (D / DO), H, B);
  kernel<<<grid, FTHREADS, dq_smem_bytes<D, DO>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(o),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<T*>(dq), view_at(st, 0),
      view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
      view_at(st, 5), N, H, scale * FLOG2E, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int N, float scale,
               cudaStream_t stream) {
  constexpr int DO = out_cols<D>();
  auto kernel = dkv_fp32_kernel<T, D, DO>;
  const int e = opt_in(kernel, dkv_smem_bytes<D, DO>());
  if (e != 0) return e;
  dim3 grid((N + FROWS - 1) / FROWS * (D / DO), H, B);
  kernel<<<grid, FTHREADS, dkv_smem_bytes<D, DO>(), stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), view_at(st, 0),
      view_at(st, 1), view_at(st, 2), view_at(st, 3), view_at(st, 4),
      view_at(st, 5), N, H, scale * FLOG2E, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, void* o,
              void* lse, const long long* strides, int B, int H, int N,
              int D, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const T *fq = static_cast<const T*>(q), *fk = static_cast<const T*>(k),
          *fv = static_cast<const T*>(v);
  T* fo = static_cast<T*>(o);
  float* fl = static_cast<float*>(lse);
  const View a = view_at(strides, 0), bk = view_at(strides, 1),
             c = view_at(strides, 2), d = view_at(strides, 3);
  const float sl = scale * FLOG2E;
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 16: return launch_fwd<T, 16>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
      case 32: return launch_fwd<T, 32>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
      case 64: return launch_fwd<T, 64>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
      case 128: return launch_fwd<T, 128>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
      default: break;
    }
  }
  if (D == 256) return launch_fwd<T, 256>(fq, fk, fv, fo, a, bk, c, d, fl, sl, B, H, N, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int flash_dq(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* delta, void* dq,
             const long long* strides, int B, int H, int N, int D,
             float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 16: return launch_dq<T, 16>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
      case 32: return launch_dq<T, 32>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
      case 64: return launch_dq<T, 64>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
      case 128: return launch_dq<T, 128>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
      default: break;
    }
  }
  if (D == 256) return launch_dq<T, 256>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, scale, st);
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dk, void* dv,
              const long long* strides, int B, int H, int N, int D,
              float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if constexpr (std::is_same<T, float>::value) {
    switch (D) {
      case 16: return launch_dkv<T, 16>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
      case 32: return launch_dkv<T, 32>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
      case 64: return launch_dkv<T, 64>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
      case 128: return launch_dkv<T, 128>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
      default: break;
    }
  }
  if (D == 256) return launch_dkv<T, 256>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, scale, st);
  return (int)cudaErrorInvalidValue;
}

// The scratch of the int8 entry points, as attention_int8_sm90.cu's Args
// with fp32 rows: q_prep (B, N, H*D) int8 under int8 scores, else fp32;
// q_scale (B*H, N) fp32 (int8 scores); k_prep (B, N, H*D) fp32 (K4, K8a,
// K8b over fp32 scores); k_q (B, N, H*D) int8 (int8 scores); k_stat (B*H)
// fp32, zero on entry, or (B*H, np) per-key scales (K7q, K8b over K7q);
// v_amax (B*H, D) fp32, zero on entry, v_q (B*H, D, np) int8 (int8 P.V); np
// = N rounded up to PV8_BLOCK.
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

// K5, K6a, K6b: the signatures of the bf16 entry points (attention_sm90.cu,
// flash_bwd_sm90.cu); views with 16-byte aligned starts and (b, h, n)
// strides. The fp32 entry points take head dims 16, 32, 64, 128 and 256,
// every tensor fp32; the `_d256` ones bf16 tensors (lse, delta fp32) at
// head dim 256.
extern "C" int sd3_flash_attention_fwd_fp32(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            const long long* strides, int B,
                                            int H, int N, int D, float scale,
                                            void* stream) {
  return flash_fwd<float>(q, k, v, o, lse, strides, B, H, N, D, scale, stream);
}

extern "C" int sd3_flash_attention_fwd_d256(const void* q, const void* k,
                                            const void* v, void* o, void* lse,
                                            const long long* strides, int B,
                                            int H, int N, int D, float scale,
                                            void* stream) {
  return flash_fwd<bf16>(q, k, v, o, lse, strides, B, H, N, D, scale, stream);
}

#define SD3_DQ_PARAMS                                                         \
  const void *q, const void *k, const void *v, const void *o,                \
      const void *dout, const void *lse, void *delta, void *dq,              \
      const long long *strides, int B, int H, int N, int D, float scale,     \
      void *stream
#define SD3_DQ_PASS q, k, v, o, dout, lse, delta, dq, strides, B, H, N, D, scale, stream

extern "C" int sd3_flash_attention_dq_fp32(SD3_DQ_PARAMS) {
  return flash_dq<float>(SD3_DQ_PASS);
}

extern "C" int sd3_flash_attention_dq_d256(SD3_DQ_PARAMS) {
  return flash_dq<bf16>(SD3_DQ_PASS);
}

#define SD3_DKV_PARAMS                                                        \
  const void *q, const void *k, const void *v, const void *dout,             \
      const void *lse, const void *delta, void *dk, void *dv,                \
      const long long *strides, int B, int H, int N, int D, float scale,     \
      void *stream
#define SD3_DKV_PASS q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, D, scale, stream

extern "C" int sd3_flash_attention_dkv_fp32(SD3_DKV_PARAMS) {
  return flash_dkv<float>(SD3_DKV_PASS);
}

extern "C" int sd3_flash_attention_dkv_d256(SD3_DKV_PARAMS) {
  return flash_dkv<bf16>(SD3_DKV_PASS);
}
