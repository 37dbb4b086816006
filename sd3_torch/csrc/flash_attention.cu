// K5, the flash-attention forward of training, non-causal, bf16, for NVIDIA
// Hopper (sm_90a). Its backward, K6a and K6b, is flash_bwd_sm90.cu.
//
// Replaces the TPU kernel `_fwd_kernel` of sd3_tpu/ops/flash_attention.py,
// reached through flash_attention / _flash_padded:
//   o = softmax(q k^T * scale) v,  lse = m + log(l)
// on q, k, v of shape (B, H, N, D), with lse in fp32 for the backward.
//
// Numerics of the TPU kernel, kept: logits in fp32 from bf16 operands
// (tensor-core products, fp32 accumulate), softmax statistics in fp32, p
// rounded to bf16 before P.V, o written in bf16. Padded keys are masked
// (p = 0), padded query rows are not written.
//
// One difference: the kernel runs the ONLINE softmax (running row max,
// rescaling l and the accumulator per key tile, as the TPU kernel does above
// 2048 keys), so below 2048 keys, where the TPU kernel takes one block with
// the true row max, p is rounded to bf16 against the running max instead.
// bf16 rounding is relative, so this moves the output by the same ~1e-3 as
// the rounding itself; the wrapper's tests state the tolerance.
//
// Layout: each tensor is a (B, H, N, D) view with the head dim contiguous
// and any (b, h, n) element strides that keep 16-byte aligned rows. The
// port's attention hands over q, k, v as cat((image, text)) results and
// reads o back as (B, N, H*D): both are views, no copy is made.
//
// fwd_kernel: one block of 4 warps (16 rows per warp) per (64 query rows,
// head, batch); streams 64-row K/V tiles, double-buffered in shared memory
// by cp.async. Every product is mma.sync m16n8k16 (bf16 in, fp32
// accumulate); the A operand of P.V comes straight from the score
// accumulators (FlashAttention-2's register reuse), B operands by ldmatrix
// (.trans for the row-major V tile).
//
// What bounds it on this card: at the 512px training shape (B*H = 76,
// N = 1178, D = 64) its two products are 4*B*H*N^2*D = 27.0 GFLOP against
// ~46 MB of traffic, so the bf16 tensor-core rate bounds it (0.027 ms at
// 989 TFLOP/s). This version is the simple, right one: mma.sync from a
// two-stage cp.async ring rather than wgmma with TMA and warp
// specialisation, so it runs well below that bound.

#include "mma.cuh"

namespace {

constexpr int TR = 64;              // rows of every tile (query and key)
constexpr int WARPS = 4;            // 16 rows of a tile per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// element strides of a (B, H, N, D) view; the head dim is contiguous
struct View {
  long long b, h, n;
};

template <int D>
struct Tile {
  static constexpr int DP = D + 8;         // padded rows: conflict-free
                                           // fragment loads
  static constexpr int ELEMS = TR * DP;    // one tile, bf16 elements
  static constexpr int BYTES = ELEMS * 2;
};

// Start the cp.async copy of rows [row0, row0 + TR) of one (N, D) head
// (row stride sn elements) into a shared tile; rows >= N are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          long long sn, int row0, int N,
                                          int tid) {
  constexpr int DP = Tile<D>::DP, CPR = D / 8;  // 16-byte chunks per row
  for (int c = tid; c < TR * CPR; c += THREADS) {
    const int r = c / CPR, cc = c % CPR;
    const int n = row0 + r;
    cp_async16(dst + r * DP + cc * 8, src + (long long)(n < N ? n : 0) * sn + cc * 8,
               n < N);
  }
}

// A fragments (m16n8k16, row) of this warp's 16 rows of a shared tile.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&f)[D / 16][4],
                                      const bf16* tile, int wr, int lane) {
  constexpr int DP = Tile<D>::DP;
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* r0 = tile + (wr + g) * DP + kk * 16 + t4 * 2;
    const bf16* r1 = r0 + 8 * DP;
    f[kk][0] = ld32(r0);
    f[kk][1] = ld32(r1);
    f[kk][2] = ld32(r0 + 8);
    f[kk][3] = ld32(r1 + 8);
  }
}

// s (16 x 64, fp32) = A (this warp's 16 rows x D) * T^T for a 64-row tile T:
// the tile's rows are the n dimension, read by ldmatrix as col-major B.
template <int D>
__device__ __forceinline__ void rows_by_tile(float (&s)[TR / 8][4],
                                             const uint32_t (&a)[D / 16][4],
                                             const bf16* tile, int lane) {
  constexpr int DP = Tile<D>::DP;
  static_assert(D % 32 == 0, "two k-steps per ldmatrix.x4");
#pragma unroll
  for (int j = 0; j < TR / 8; ++j) {
    s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    const bf16* kr = tile + (j * 8 + (lane & 7)) * DP + (lane >> 3) * 8;
#pragma unroll
    for (int kk = 0; kk < D / 16; kk += 2) {
      uint32_t b[4];
      ldsm_x4(b, kr + kk * 16);
      mma_bf16(s[j], a[kk], b[0], b[1]);
      mma_bf16(s[j], a[kk + 1], b[2], b[3]);
    }
  }
}

// acc (16 x D) += bf16(P) (16 x 64, in accumulator layout) * T for a 64-row
// tile T (row-major, k x n): the accumulators of column tiles 2kk, 2kk+1 are
// the A fragment of columns [16kk, 16kk+16); T's B fragments come transposed
// out of the row-major tile, two d-tiles per ldmatrix.x4.trans.
template <int D>
__device__ __forceinline__ void accumulate_pt(float (&acc)[D / 8][4],
                                              const float (&p)[TR / 8][4],
                                              const bf16* tile, int lane) {
  constexpr int DP = Tile<D>::DP;
  const int t_row = (lane >> 3 & 1) * 8 + (lane & 7);
  const int t_col = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < TR / 16; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
    for (int jd2 = 0; jd2 < D / 16; ++jd2) {
      uint32_t b[4];
      ldsm_x4_trans(b, tile + (kk * 16 + t_row) * DP + jd2 * 16 + t_col);
      mma_bf16(acc[2 * jd2], a, b[0], b[1]);
      mma_bf16(acc[2 * jd2 + 1], a, b[2], b[3]);
    }
  }
}

// Write this warp's 16 rows of acc * mul as bf16 into rows r0 + [0, 16) of
// one head (row stride sn); rows >= N are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long sn,
                                           const float (&acc)[D / 8][4],
                                           float mul0, float mul1, int r0,
                                           int N, int lane) {
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = r0 + g, n1 = n0 + 8;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int col = jd * 8 + t4 * 2;
    if (n0 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)n0 * sn + col) =
          __floats2bfloat162_rn(acc[jd][0] * mul0, acc[jd][1] * mul0);
    if (n1 < N)
      *reinterpret_cast<__nv_bfloat162*>(dst + (long long)n1 * sn + col) =
          __floats2bfloat162_rn(acc[jd][2] * mul1, acc[jd][3] * mul1);
  }
}

// ---- K5 ---------------------------------------------------------------

// grid (ceil(N / TR), H, B), THREADS threads, 5 tiles of dynamic smem.
template <int D>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
           const bf16* __restrict__ v, bf16* __restrict__ o,
           float* __restrict__ lse, View vq, View vk, View vv, View vo, int N,
           int H, float scale_log2) {
  constexpr int TE = Tile<D>::ELEMS;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + TE;       // [2][TR][DP]
  bf16* sV = sK + 2 * TE;   // [2][TR][DP]

  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * TR;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int t4 = lane & 3, wr = warp * 16;
  const bf16* qh = q + b * vq.b + h * vq.h;
  const bf16* kh = k + b * vk.b + h * vk.h;
  const bf16* vh = v + b * vv.b + h * vv.h;
  const int ntiles = (N + TR - 1) / TR;

  load_tile<D>(sQ, qh, vq.n, q0, N, tid);
  load_tile<D>(sK, kh, vk.n, 0, N, tid);
  load_tile<D>(sV, vh, vv.n, 0, N, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  uint32_t qf[D / 16][4];
  load_a<D>(qf, sQ, wr, lane);

  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  // running max (log2 units) and partial sums of rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {  // into the stage tile t-1 used
      load_tile<D>(sK + ((t + 1) & 1) * TE, kh, vk.n, (t + 1) * TR, N, tid);
      load_tile<D>(sV + ((t + 1) & 1) * TE, vh, vv.n, (t + 1) * TR, N, tid);
      cp_async_commit();
      cp_async_wait<1>();  // tile t has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();       // ... and every thread's copies
    const bf16* cK = sK + (t & 1) * TE;
    const bf16* cV = sV + (t & 1) * TE;
    const int k0 = t * TR;

    float s[TR / 8][4];
    rows_by_tile<D>(s, qf, cK, lane);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < TR / 8; ++j) {
      const int col = k0 + j * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] *= scale_log2;
      if (col >= N) s[j][0] = s[j][2] = -INFINITY;      // padded keys
      if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
    // every row sees key 0 in tile 0, so the running max is finite from
    // there on and exp2(-inf - finite) = 0 clears the empty start
    const float mn0 = fmaxf(m0, quad_max(mx0));
    const float mn1 = fmaxf(m1, quad_max(mx1));
    const float a0 = fast_exp2(m0 - mn0), a1 = fast_exp2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd) {
      acc[jd][0] *= a0;
      acc[jd][1] *= a0;
      acc[jd][2] *= a1;
      acc[jd][3] *= a1;
    }
#pragma unroll
    for (int j = 0; j < TR / 8; ++j) {
      s[j][0] = fast_exp2(s[j][0] - m0);
      s[j][1] = fast_exp2(s[j][1] - m0);
      s[j][2] = fast_exp2(s[j][2] - m1);
      s[j][3] = fast_exp2(s[j][3] - m1);
      l0 += s[j][0] + s[j][1];   // sums of the fp32 p, as the TPU kernel
      l1 += s[j][2] + s[j][3];
    }
    accumulate_pt<D>(acc, s, cV, lane);
    __syncthreads();  // tile t consumed: its stage may be refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  store_rows<D>(o + b * vo.b + h * vo.h, vo.n, acc, 1.f / l0, 1.f / l1,
                q0 + wr, N, lane);
  if (t4 == 0) {
    const int n0 = q0 + wr + (lane >> 2), n1 = n0 + 8;
    float* lh = lse + ((long long)b * H + h) * N;
    if (n0 < N) lh[n0] = (m0 + log2f(l0)) * LN2;
    if (n1 < N) lh[n1] = (m1 + log2f(l1)) * LN2;
  }
}

View view_at(const long long* strides, int i) {
  return View{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
}

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
               const long long* st, int B, int H, int N, float scale,
               cudaStream_t stream) {
  const int smem = 5 * Tile<D>::BYTES;
  int e = allow_smem(fwd_kernel<D>, smem);
  if (e) return e;
  dim3 grid((N + TR - 1) / TR, H, B);
  fwd_kernel<D><<<grid, THREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), view_at(st, 0), view_at(st, 1),
      view_at(st, 2), view_at(st, 3), N, H, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor argument but lse is a (B, H, N, D) bf16 view with the head
// dim contiguous, 16-byte aligned rows, and its (b, h, n) element strides in
// `strides`, three per tensor in argument order. lse: (B, H, N) fp32,
// contiguous. Returns the CUDA error code of the launch (0 = success).

// K5: o, lse from q, k, v (strides of q, k, v, o).
extern "C" int sd3_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const long long* strides, int B, int H,
                                       int N, int D, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 32: return launch_fwd<32>(q, k, v, o, lse, strides, B, H, N, scale, st);
    case 64: return launch_fwd<64>(q, k, v, o, lse, strides, B, H, N, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
