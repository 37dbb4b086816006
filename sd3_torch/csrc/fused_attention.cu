// K4: fused joint [image || text] attention with per-head q/k RMSNorm,
// image-only RoPE and int8 QK^T, for NVIDIA Hopper (sm_90a).
//
// Replaces the int8_qk branch of the TPU kernel
// sd3_tpu/ops/fused_attention.py::_fused_fwd_kernel (:193; the serving path
// for 1024 to 2048 padded tokens), reached through _pallas_fused /
// fused_dual_flash_attention. Its bf16 branch, K1, is attention_sm90.cu.
//
// What it computes, per (batch b, head h), on raw projections q, k, v laid
// out (B, N, H*D): K1's prep (attention_common.cuh: q^ = rms(q) (x) (cq,
// sq), k^ = rms(k) (x) (ck, sk), RMSNorm over the head dim with the input
// dtype's eps and the interleaved-pair rotation, the per-stream norm
// weights folded into the (N, D) tables, and the softmax scale and log2(e)
// into the q tables, so the softmax runs in exp2), then scores as
// s8 x s8 -> s32 products:
//   q^ quantized per row (per head) from its fp32 value, scale
//      max(|q^|, 1e-12) / 127;
//   k^ rounded to bf16, then ONE scale per (b, h) over all of K,
//      max(|bf16(k^)|, 1e-12) / 127;
//   s  = s32 * (s_q * s_k), masked, and the TRUE row max as the shift (a
//      dequantized score can exceed the Cauchy-Schwarz bound by its
//      quantization error, so K1's bounded shift does not carry over);
//   p  = exp2(s - max) rounded to bf16, P.V in bf16 with fp32 sums, l the
//      sum of the unrounded p; padded keys masked (p = 0).
// Three launches: k_prep_kernel<D, true> writes bf16 k^ and max |bf16(k^)|
// per (b, h) (atomicMax on the float bits); k_quant_kernel writes int8 k^
// with that scale, once, rather than in every query block; attn_int8_kernel
// (one block of 4 warps per 64 query rows, 16 rows a warp) quantizes its q
// tile into shared memory and makes TWO passes over the int8 K tiles, 64-row
// tiles double-buffered by cp.async, the first for the exact row max (as
// the TPU kernel's max pass), the second for exp2 and P.V on mma.sync
// (m16n8k32 s8, m16n8k16 bf16, V's fragments by ldmatrix.trans). Scores are
// computed twice, at the int8 rate (twice bf16's), so the QK^T work costs
// what one bf16 pass costs. At the 512px shape one call is 2*B*H*N^2*D int8
// operations for QK^T plus as many bf16 FLOP for P.V: 27.0 G + 27.0 G,
// bound by the tensor-core rate (~41 us). int8 m16n8k32 contracts 32 at a
// time, so a head dim of 16 is zero-padded to 32 in shared memory.

#include "attention_common.cuh"

namespace {

template <int D>
struct Smem8 {
  static constexpr int DQ = D < 32 ? 32 : D;  // int8 depth, zero-padded
  static constexpr int SQ = DQ + 16;          // int8 row stride (bytes):
                                              // conflict-free ldmatrix
  static constexpr int DP = D + 8;            // bf16 V rows (elements):
                                              // conflict-free ldmatrix
  static constexpr int Q = 0;                           // [BQ][SQ] int8
  static constexpr int K = Q + BQ * SQ;                 // [2][BK][SQ] int8
  static constexpr int V = K + 2 * BK * SQ;             // [2][BK][DP] bf16
  static constexpr int QS = V + 2 * BK * DP * 2;        // [BQ] fp32 s_q
  static constexpr int BYTES = QS + BQ * 4;
};

// grid (ceil(N / BQ), H, B), THREADS threads, Smem8<D>::BYTES dynamic smem.
template <int D>
__global__ void __launch_bounds__(THREADS)
attn_int8_kernel(const bf16* __restrict__ q, const float* __restrict__ cq,
                 const float* __restrict__ sq, const int8_t* __restrict__ kq,
                 const float* __restrict__ k_amax, const bf16* __restrict__ v,
                 bf16* __restrict__ o, int N, int H, float eps_q) {
  using G = Geom<D>;
  using S = Smem8<D>;
  constexpr int SQ = S::SQ, DP = S::DP, DQ = S::DQ;
  constexpr int KCH = DQ / 16;   // 16-byte chunks of an int8 row
  constexpr int VCH = D / 8;     // 16-byte chunks of a bf16 row
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* sQ = reinterpret_cast<int8_t*>(smem + S::Q);
  int8_t* sK = reinterpret_cast<int8_t*>(smem + S::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + S::V);
  float* sQs = reinterpret_cast<float*>(smem + S::QS);

  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
  const int ntiles = (N + BK - 1) / BK;

  auto load_tile = [&](int t, bool with_v) {
    int8_t* dk = sK + (t & 1) * BK * SQ;
    for (int c = tid; c < BK * KCH; c += THREADS) {
      const int r = c / KCH, cc = c % KCH;
      const int n = t * BK + r;
      const bool valid = n < N && cc * 16 < D;
      cp_async16(dk + r * SQ + cc * 16,
                 kq + (valid ? base + (size_t)n * rs + cc * 16 : 0), valid);
    }
    if (with_v) {
      bf16* dv = sV + (t & 1) * BK * DP;
      for (int c = tid; c < BK * VCH; c += THREADS) {
        const int r = c / VCH, cc = c % VCH;
        const int n = t * BK + r;
        cp_async16(dv + r * DP + cc * 8,
                   v + base + (size_t)(n < N ? n : 0) * rs + cc * 8, n < N);
      }
    }
    cp_async_commit();
  };
  load_tile(0, false);  // in flight during the q prep

  // ---- q tile: RMSNorm + rotation in fp32, then per-row int8
  {
    constexpr int ROWS_PER_ITER = WARPS * G::RPW;
    const int sub = lane % G::TPR;
#pragma unroll
    for (int r0 = 0; r0 < BQ; r0 += ROWS_PER_ITER) {
      const int r = r0 + warp * G::RPW + lane / G::TPR;
      const int n = q0 + r;
      const bool valid = n < N;
      const size_t nn = valid ? (size_t)n : 0;
      float out[2 * G::PPT];
      prep_row<D>(q + base + nn * rs, cq + nn * D, sq + nn * D, eps_q, sub,
                  valid, out);
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < 2 * G::PPT; ++i) amax = fmaxf(amax, fabsf(out[i]));
      const float s = fmaxf(group_max<G::TPR>(amax), 1e-12f) / 127.f;
      char2* dst = reinterpret_cast<char2*>(sQ + r * SQ);
#pragma unroll
      for (int i = 0; i < G::PPT; ++i) {
        char2 c;
        c.x = (signed char)quant8(out[2 * i], s);
        c.y = (signed char)quant8(out[2 * i + 1], s);
        dst[sub + i * G::TPR] = c;
      }
      if constexpr (DQ > D) {
        for (int j = D / 2 + sub; j < DQ / 2; j += G::TPR) dst[j] = make_char2(0, 0);
      }
      if (sub == 0) sQs[r] = s;
    }
  }
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;
  const int wr = warp * 16;
  uint32_t qa[DQ / 32][4];
#pragma unroll
  for (int kk = 0; kk < DQ / 32; ++kk)
    ldsm_x4(qa[kk], reinterpret_cast<const bf16*>(
                        sQ + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * SQ +
                        kk * 32 + (lane >> 4) * 16));
  const float ks = fmaxf(k_amax[b * H + h], 1e-12f) / 127.f;
  const float comb0 = sQs[wr + g] * ks, comb1 = sQs[wr + g + 8] * ks;

  // dequantized scores of this warp's 16 rows against key tile cK
  auto scores = [&](float (&s)[BK / 8][4], const int8_t* cK) {
#pragma unroll
    for (int j = 0; j < BK / 8; j += 2) {
      int a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < DQ / 32; ++kk) {
        uint32_t bk[4];
        ldsm_x4(bk, reinterpret_cast<const bf16*>(
                        cK + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * SQ +
                        kk * 32 + ((lane >> 3) & 1) * 16));
        mma_s8(a0, qa[kk], bk[0], bk[1]);
        mma_s8(a1, qa[kk], bk[2], bk[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = (float)a0[e] * (e < 2 ? comb0 : comb1);
        s[j + 1][e] = (float)a1[e] * (e < 2 ? comb0 : comb1);
      }
    }
  };

  // pass 1: the true row max
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[BK / 8][4];
    scores(s, sK + (t & 1) * BK * SQ);
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = k0 + j * 8 + t4 * 2;
      if (col < N) {
        m0 = fmaxf(m0, s[j][0]);
        m1 = fmaxf(m1, s[j][2]);
      }
      if (col + 1 < N) {
        m0 = fmaxf(m0, s[j][1]);
        m1 = fmaxf(m1, s[j][3]);
      }
    }
    __syncthreads();
  }
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 1));
  m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, 2));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 1));
  m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, 2));

  // pass 2: p = exp2(s - max), row sums, bf16(p) V
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float l0 = 0.f, l1 = 0.f;
  const int v_row = (lane >> 3 & 1) * 8 + (lane & 7);
  const int v_col = (lane >> 4) * 8;
  load_tile(0, true);
  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    float s[BK / 8][4];
    scores(s, sK + (t & 1) * BK * SQ);
    const bf16* cV = sV + (t & 1) * BK * DP;
    const int k0 = t * BK;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const int col = k0 + j * 8 + t4 * 2;
      s[j][0] = col < N ? fast_exp2(s[j][0] - m0) : 0.f;
      s[j][1] = col + 1 < N ? fast_exp2(s[j][1] - m0) : 0.f;
      s[j][2] = col < N ? fast_exp2(s[j][2] - m1) : 0.f;
      s[j][3] = col + 1 < N ? fast_exp2(s[j][3] - m1) : 0.f;
      l0 += s[j][0] + s[j][1];
      l1 += s[j][2] + s[j][3];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int jd2 = 0; jd2 < D / 16; ++jd2) {
        uint32_t bv[4];
        ldsm_x4_trans(bv, cV + (kk * 16 + v_row) * DP + jd2 * 16 + v_col);
        mma_bf16(acc[2 * jd2], a, bv[0], bv[1]);
        mma_bf16(acc[2 * jd2 + 1], a, bv[2], bv[3]);
      }
    }
    __syncthreads();
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int n0 = q0 + wr + g, n1 = n0 + 8;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int col = jd * 8 + t4 * 2;
    if (n0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)n0 * rs + col) =
          __floats2bfloat162_rn(acc[jd][0] * inv0, acc[jd][1] * inv0);
    if (n1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)n1 * rs + col) =
          __floats2bfloat162_rn(acc[jd][2] * inv1, acc[jd][3] * inv1);
  }
}

template <int D>
int launch_int8(const void* q, const void* k, const void* v, const void* cq,
                const void* sq, const void* ck, const void* sk, void* k_prep,
                void* k_q, void* k_amax, void* out, int B, int N, int H,
                float eps_q, float eps_k, cudaStream_t st) {
  int e = launch_k_prep_q8bh<D>(k, ck, sk, k_prep, k_q, k_amax, B, N, H,
                                eps_k, st);
  if (e != 0) return e;
  const int smem = Smem8<D>::BYTES;
  e = allow_smem(attn_int8_kernel<D>, smem);
  if (e != 0) return e;
  dim3 g2((N + BQ - 1) / BQ, H, B);
  attn_int8_kernel<D><<<g2, THREADS, smem, st>>>(
      static_cast<const bf16*>(q), static_cast<const float*>(cq),
      static_cast<const float*>(sq), static_cast<const int8_t*>(k_q),
      static_cast<const float*>(k_amax), static_cast<const bf16*>(v),
      static_cast<bf16*>(out), N, H, eps_q);
  return (int)cudaGetLastError();
}

}  // namespace

// K4. q, k, v, out: (B, N, H*D) bf16, contiguous, 16-byte aligned. cq, sq,
// ck, sk: (N, D) fp32 tables (norm weights folded in; cq, sq also carry
// scale*log2(e)). k_prep: (B, N, H*D) bf16 scratch; k_q: (B, N, H*D) int8
// scratch; k_amax: (B*H) fp32, zero on entry. Returns the CUDA error code
// of the launches (0 = success).
extern "C" int sd3_fused_attention_int8qk(const void* q, const void* k,
                                          const void* v, const void* cq,
                                          const void* sq, const void* ck,
                                          const void* sk, void* k_prep,
                                          void* k_q, void* k_amax, void* out,
                                          int B, int N, int H, int D,
                                          float eps_q, float eps_k,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_int8<16>(q, k, v, cq, sq, ck, sk, k_prep, k_q, k_amax, out, B, N, H, eps_q, eps_k, st);
    case 32: return launch_int8<32>(q, k, v, cq, sq, ck, sk, k_prep, k_q, k_amax, out, B, N, H, eps_q, eps_k, st);
    case 64: return launch_int8<64>(q, k, v, cq, sq, ck, sk, k_prep, k_q, k_amax, out, B, N, H, eps_q, eps_k, st);
    case 128: return launch_int8<128>(q, k, v, cq, sq, ck, sk, k_prep, k_q, k_amax, out, B, N, H, eps_q, eps_k, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
