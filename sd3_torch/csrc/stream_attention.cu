// K7q, the int8-QK^T branch of the streaming fused joint attention, and
// K8a, the single-KV int8-P.V attention, for NVIDIA Hopper (sm_90a): the
// mma.sync kernels of the port that no path of the model takes (the JAX
// package gates them off as well; the attention API reaches them). K7 (the
// bf16 streaming branch) is attention_sm90.cu, K4 and K8b
// attention_int8_sm90.cu.
//
// Replaces, in sd3_tpu/ops/fused_attention.py:
//   K7q  the `int8_qk` branch of `_stream_fwd_kernel` (the 1024px stage,
//        > 2048 padded tokens): K prepped in fp32 and quantized per row
//        (per head) outside the attention loop (`_prep_xla`,
//        `_q8_rows_xla`), q^ quantized per row from fp32, s = s32 * s_q *
//        s_k[key], an ONLINE softmax (true running max) over K blocks in
//        exp2;
//   K8a  the `int8_pv` branch of `_fused_fwd_kernel` (single KV block, at
//        most 2048 padded tokens), alone or over K4's int8 scores.
// The inputs are K1's (attention_sm90.cu): raw projections q, k, v of
// (B, N, H*D) bf16 and (N, D) fp32 tables with the norm weights folded in
// (q tables also carry scale*log2(e)); RMSNorm eps is the input dtype's.
//
// The numerics kept from the TPU kernels:
//   - k^ is rounded to bf16 once (K8a over bf16 scores); q^ is rounded to
//     bf16 for a bf16 QK^T; with int8 QK^T both are quantized from fp32
//     (K7q: K per row, scale max(|k^|, 1e-12) / 127, round half to even, a
//     true division; K8a over K4: k^ rounded to bf16 and one scale per
//     (b, h), as K4);
//   - K7q runs an online softmax: m the running row max, p = exp2(s - m),
//     alpha = exp2(m_old - m) rescaling l and the accumulator, l the sum of
//     the unrounded fp32 p; p rounded to bf16 for P.V. The TPU kernel's K
//     block is ~2176 rows, this kernel's tile 64 (INT8_KEY_TILE in
//     ops/fused_attention.py), so p is rounded against another running
//     max: a different rounding of the same relative size (2^-9 for bf16),
//     which the tolerances state;
//   - int8 P.V (K8a): V quantized per (b, h, column) over all rows, pb =
//     exp2(s - (m - log2 127)) in [0, 127] against the TRUE row max (two
//     score passes, as K4, never K1's bound), pq = clip(round(pb), 0, 127),
//     P.V as s8 x s8 -> s32 on mma.sync m16n8k32 summed over every key in
//     s32, o = acc / l * v_scale with l the sum of the unrounded pb;
//   - padded keys get p = 0.
//
// Launches (all on the caller's stream, in order):
//   K prep: k_prep_kernel (bf16 k^; K8a over bf16 scores), or
//     prep_q8rows_kernel<D, 7> (fp32 prep, per-row int8 and scales; K7q),
//     or K4's k_prep_kernel<D, true> + k_quant_kernel (K8a over K4 scores);
//   V prep (K8a): v_amax_kernel and v_quant_kernel (attention_common.cuh),
//     V^T as int8, (B*H, D, NP) with NP = N rounded up to 64, its keys in
//     the order of v_perm so that one ldmatrix gives the B fragments of
//     m16n8k32 while the A fragment (pq) comes straight out of the score
//     accumulators;
//   attn_stream_kernel<D, QK8, PV8, TWO_PASS>: one block of 4 warps per (64
//     query rows, h, b), each warp owning 16 rows; q tile prepped in the
//     kernel (bf16, or int8 with per-row scales), K / V tiles of 64 keys
//     double-buffered by cp.async; QK^T on mma.sync m16n8k16 (bf16) or
//     m16n8k32 (int8, head dim zero-padded to 32), P.V likewise. TWO_PASS
//     (K8a) runs the scores once for the true row max, then again for P.V.
//     Its instances: K7q <D, true, false, false>, K8a <D, *, true, true>.
//
// What bounds them on this card: at the 1024px shape (B 8 with CFG, H 19,
// N 4250, D 64; K7q) QK^T and P.V are 2*B*H*N^2*D = 351.4 G operations
// each, 0.533 ms at the tensor-core rates (the int8 product at 1979 TOPS,
// bf16's at 989 TFLOP/s), but the softmax's B*H*N^2 = 2.75 G exp2s take
// 0.7107 ms on the SFU (16 a clock an SM, 1/256 of the bf16 FLOP rate), the
// larger term; at the 512px shape (K8a) the exp2s bound it too, 0.0546 ms.
// q, k, v and o are 4 x 83 MB at 1024px (~0.1 ms at 3.35 TB/s). These are
// the simple, right versions (mma.sync, a two-stage cp.async ring), so they
// run well below those bounds; K4 and K8b moved to wgmma + TMA
// (attention_int8_sm90.cu).

#include <type_traits>

#include "attention_common.cuh"

namespace {

// Geometry of the attention block's shared memory.
template <int D, bool QK8, bool PV8>
struct SmemS {
  static constexpr int DQ = D < 32 ? 32 : D;  // int8 depth, zero-padded
  static constexpr int SQ8 = DQ + 16;         // int8 q / k rows (bytes):
                                              // conflict-free ldmatrix
  static constexpr int DP = D + 8;            // bf16 rows (elements)
  static constexpr int SVT = BK + 16;         // int8 V^T rows (bytes)
  static constexpr int QT = QK8 ? BQ * SQ8 : BQ * DP * 2;   // q tile
  static constexpr int KT = QK8 ? BK * SQ8 : BK * DP * 2;   // one K tile
  static constexpr int VT = PV8 ? D * SVT : BK * DP * 2;    // one V tile
  static constexpr int Q = 0;
  static constexpr int K = Q + QT;          // [2] K tiles
  static constexpr int V = K + 2 * KT;      // [2] V tiles
  static constexpr int QS = V + 2 * VT;     // [BQ] fp32 q scales (QK8)
  static constexpr int KS = QS + BQ * 4;    // [2][BK] fp32 k scales (QK8)
  static constexpr int BYTES = KS + 2 * BK * 4;
};

// clip(round(x), 0, 127) of four non-negative values, packed low byte first
__device__ __forceinline__ uint32_t pack_p8(float a, float b, float c,
                                            float d) {
  auto q = [](float x) { return (uint32_t)fminf(rintf(x), 127.f); };
  return q(a) | q(b) << 8 | q(c) << 16 | q(d) << 24;
}

// ---- the attention ----------------------------------------------------

// grid (ceil(N / BQ), H, B), THREADS threads, SmemS<D, QK8, PV8>::BYTES of
// dynamic shared memory.
//   kp: bf16 k^ (B, N, H*D), or with QK8 int8 k^ (B, N, H*D);
//   k_scale (QK8): per-row scales (B*H, N) (streaming), or with TWO_PASS
//     K4's max |bf16(k^)| per (b, h);
//   vp: bf16 v (B, N, H*D), or with PV8 int8 V^T (B*H, D, NP);
//   v_amax (PV8): (B*H, D).
template <int D, bool QK8, bool PV8, bool TWO_PASS>
__global__ void __launch_bounds__(THREADS)
attn_stream_kernel(const bf16* __restrict__ q, const float* __restrict__ cq,
                   const float* __restrict__ sq, const void* __restrict__ kp,
                   const float* __restrict__ k_scale,
                   const void* __restrict__ vp,
                   const float* __restrict__ v_amax, bf16* __restrict__ o,
                   int N, int H, float eps_q) {
  static_assert(TWO_PASS == PV8, "int8 P.V runs two score passes (K8a)");
  using G = Geom<D>;
  using S = SmemS<D, QK8, PV8>;
  constexpr int DQ = S::DQ, SQ8 = S::SQ8, DP = S::DP, SVT = S::SVT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* sQs = reinterpret_cast<float*>(smem + S::QS);
  float* sKs = reinterpret_cast<float*>(smem + S::KS);

  const int h = blockIdx.y, b = blockIdx.z, bh = b * H + h;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t rs = (size_t)H * D;
  const size_t base = (size_t)b * N * rs + (size_t)h * D;
  const int ntiles = (N + BK - 1) / BK;
  const int NP = ntiles * BK;

  auto k_tile = [&](int t) { return smem + S::K + (t & 1) * S::KT; };
  auto v_tile = [&](int t) { return smem + S::V + (t & 1) * S::VT; };

  // start the copies of K tile t (and its per-key scales) and, with_v, of
  // V tile t, into stage t & 1
  auto load_tile = [&](int t, bool with_v) {
    unsigned char* dk = k_tile(t);
    if constexpr (QK8) {
      constexpr int KCH = DQ / 16;
      const int8_t* kq = static_cast<const int8_t*>(kp);
      for (int c = tid; c < BK * KCH; c += THREADS) {
        const int r = c / KCH, cc = c % KCH;
        const int n = t * BK + r;
        const bool valid = n < N && cc * 16 < D;
        cp_async16(dk + r * SQ8 + cc * 16,
                   kq + (valid ? base + (size_t)n * rs + cc * 16 : 0), valid);
      }
      if constexpr (!TWO_PASS) {
        if (tid < BK) {
          const int n = t * BK + tid;
          sKs[(t & 1) * BK + tid] = n < N ? k_scale[(size_t)bh * N + n] : 0.f;
        }
      }
    } else {
      constexpr int CPR = D / 8;
      const bf16* kb = static_cast<const bf16*>(kp);
      bf16* dkb = reinterpret_cast<bf16*>(dk);
      for (int c = tid; c < BK * CPR; c += THREADS) {
        const int r = c / CPR, cc = c % CPR;
        const int n = t * BK + r;
        cp_async16(dkb + r * DP + cc * 8,
                   kb + base + (size_t)(n < N ? n : 0) * rs + cc * 8, n < N);
      }
    }
    if (with_v) {
      unsigned char* dv = v_tile(t);
      if constexpr (PV8) {
        constexpr int VCH = BK / 16;
        const int8_t* vt = static_cast<const int8_t*>(vp) +
                           (size_t)bh * D * NP + (size_t)t * BK;
        for (int c = tid; c < D * VCH; c += THREADS) {
          const int r = c / VCH, cc = c % VCH;
          cp_async16(dv + r * SVT + cc * 16, vt + (size_t)r * NP + cc * 16, true);
        }
      } else {
        constexpr int CPR = D / 8;
        const bf16* vb = static_cast<const bf16*>(vp);
        bf16* dvb = reinterpret_cast<bf16*>(dv);
        for (int c = tid; c < BK * CPR; c += THREADS) {
          const int r = c / CPR, cc = c % CPR;
          const int n = t * BK + r;
          cp_async16(dvb + r * DP + cc * 8,
                     vb + base + (size_t)(n < N ? n : 0) * rs + cc * 8, n < N);
        }
      }
    }
    cp_async_commit();
  };
  load_tile(0, !TWO_PASS);  // in flight during the q prep

  // ---- q tile: RMSNorm + rotation (scale*log2e in the tables), then bf16,
  // or int8 per row from fp32
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
      if constexpr (QK8) {
        float amax = 0.f;
#pragma unroll
        for (int i = 0; i < 2 * G::PPT; ++i) amax = fmaxf(amax, fabsf(out[i]));
        const float s = fmaxf(group_max<G::TPR>(amax), 1e-12f) / 127.f;
        char2* dst = reinterpret_cast<char2*>(smem + S::Q + r * SQ8);
#pragma unroll
        for (int i = 0; i < G::PPT; ++i)
          dst[sub + i * G::TPR] = make_char2((signed char)quant8(out[2 * i], s),
                                             (signed char)quant8(out[2 * i + 1], s));
        if constexpr (DQ > D) {
          for (int j = D / 2 + sub; j < DQ / 2; j += G::TPR) dst[j] = make_char2(0, 0);
        }
        if (sub == 0) sQs[r] = s;
      } else {
        __nv_bfloat162* dst =
            reinterpret_cast<__nv_bfloat162*>(smem + S::Q) + r * (DP / 2);
#pragma unroll
        for (int i = 0; i < G::PPT; ++i)
          dst[sub + i * G::TPR] = __floats2bfloat162_rn(out[2 * i], out[2 * i + 1]);
      }
    }
  }
  __syncthreads();

  const int g = lane >> 2, t4 = lane & 3;   // mma fragment coordinates
  const int wr = warp * 16;                 // this warp's first query row
  constexpr int QF = QK8 ? DQ / 32 : D / 16;
  uint32_t qf[QF][4];
  if constexpr (QK8) {
    const int8_t* sQ = reinterpret_cast<const int8_t*>(smem + S::Q);
#pragma unroll
    for (int kk = 0; kk < QF; ++kk)
      ldsm_x4(qf[kk], reinterpret_cast<const bf16*>(
                          sQ + (wr + (lane & 7) + ((lane >> 3) & 1) * 8) * SQ8 +
                          kk * 32 + (lane >> 4) * 16));
  } else {
    const bf16* sQ = reinterpret_cast<const bf16*>(smem + S::Q);
#pragma unroll
    for (int kk = 0; kk < QF; ++kk) {
      const bf16* r0 = sQ + (wr + g) * DP + kk * 16 + t4 * 2;
      const bf16* r1 = r0 + 8 * DP;
      qf[kk][0] = ld32(r0);
      qf[kk][1] = ld32(r1);
      qf[kk][2] = ld32(r0 + 8);
      qf[kk][3] = ld32(r1 + 8);
    }
  }
  // int8 dequantization: s_q per row; with TWO_PASS (K8a over K4) one k
  // scale for the head, folded in as K4 does: s32 * (s_q * s_k)
  float qs0 = 1.f, qs1 = 1.f;
  if constexpr (QK8) {
    qs0 = sQs[wr + g];
    qs1 = sQs[wr + g + 8];
    if constexpr (TWO_PASS) {
      const float ks = fmaxf(k_scale[bh], 1e-12f) / 127.f;
      qs0 *= ks;
      qs1 *= ks;
    }
  }

  // scores of this warp's 16 rows against K tile t, padded keys at -inf
  auto scores = [&](float (&s)[BK / 8][4], int t) {
    if constexpr (QK8) {
      const int8_t* cK = reinterpret_cast<const int8_t*>(k_tile(t));
      const float* ks = sKs + (t & 1) * BK;  // per-key scales (streaming)
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        int a0[4] = {0, 0, 0, 0}, a1[4] = {0, 0, 0, 0};
#pragma unroll
        for (int kk = 0; kk < DQ / 32; ++kk) {
          uint32_t bk[4];
          ldsm_x4(bk, reinterpret_cast<const bf16*>(
                          cK + (j * 8 + (lane >> 4) * 8 + (lane & 7)) * SQ8 +
                          kk * 32 + ((lane >> 3) & 1) * 16));
          mma_s8(a0, qf[kk], bk[0], bk[1]);
          mma_s8(a1, qf[kk], bk[2], bk[3]);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float qs = e < 2 ? qs0 : qs1;
          if constexpr (TWO_PASS) {
            s[j][e] = (float)a0[e] * qs;
            s[j + 1][e] = (float)a1[e] * qs;
          } else {  // s32 * s_q * s_k[key], the TPU kernel's order
            const int key = j * 8 + t4 * 2 + (e & 1);
            s[j][e] = (float)a0[e] * qs * ks[key];
            s[j + 1][e] = (float)a1[e] * qs * ks[key + 8];
          }
        }
      }
    } else {
      const bf16* cK = reinterpret_cast<const bf16*>(k_tile(t));
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const bf16* kr = cK + (j * 8 + (lane & 7)) * DP + (lane >> 3) * 8;
        if constexpr (D % 32 == 0) {
#pragma unroll
          for (int kk = 0; kk < D / 16; kk += 2) {
            uint32_t bk[4];
            ldsm_x4(bk, kr + kk * 16);
            mma_bf16(s[j], qf[kk], bk[0], bk[1]);
            mma_bf16(s[j], qf[kk + 1], bk[2], bk[3]);
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            uint32_t bk[2];
            ldsm_x2(bk, kr + kk * 16);
            mma_bf16(s[j], qf[kk], bk[0], bk[1]);
          }
        }
      }
    }
    const int k0 = t * BK;
    if (k0 + BK > N) {
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        const int col = k0 + j * 8 + t4 * 2;
        if (col >= N) s[j][0] = s[j][2] = -INFINITY;
        if (col + 1 >= N) s[j][1] = s[j][3] = -INFINITY;
      }
    }
  };

  // acc: fp32, or with TWO_PASS exact s32 sums of pq * vq over every key
  using Acc = typename std::conditional<TWO_PASS, int, float>::type;
  Acc acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;

  // acc += P V for tile t, p (exp2 values) in accumulator layout
  auto accumulate_pv = [&](const float (&p)[BK / 8][4], int t) {
    if constexpr (PV8) {
      const int8_t* cV = reinterpret_cast<const int8_t*>(v_tile(t));
#pragma unroll
      for (int kc = 0; kc < BK / 32; ++kc) {
        const int j0 = kc * 4;
        uint32_t a[4];
        a[0] = pack_p8(p[j0][0], p[j0][1], p[j0 + 1][0], p[j0 + 1][1]);
        a[1] = pack_p8(p[j0][2], p[j0][3], p[j0 + 1][2], p[j0 + 1][3]);
        a[2] = pack_p8(p[j0 + 2][0], p[j0 + 2][1], p[j0 + 3][0], p[j0 + 3][1]);
        a[3] = pack_p8(p[j0 + 2][2], p[j0 + 2][3], p[j0 + 3][2], p[j0 + 3][3]);
#pragma unroll
        for (int jd2 = 0; jd2 < D / 16; ++jd2) {
          uint32_t bv[4];
          ldsm_x4(bv, reinterpret_cast<const bf16*>(
                          cV + (jd2 * 16 + (lane >> 4) * 8 + (lane & 7)) * SVT +
                          kc * 32 + ((lane >> 3) & 1) * 16));
          mma_s8(acc[2 * jd2], a, bv[0], bv[1]);
          mma_s8(acc[2 * jd2 + 1], a, bv[2], bv[3]);
        }
      }
    } else {
      const bf16* cV = reinterpret_cast<const bf16*>(v_tile(t));
      const int v_row = (lane >> 3 & 1) * 8 + (lane & 7);
      const int v_col = (lane >> 4) * 8;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
        a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
        a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
        a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
#pragma unroll
        for (int jd2 = 0; jd2 < D / 16; ++jd2) {
          uint32_t bv[4];
          ldsm_x4_trans(bv, cV + (kk * 16 + v_row) * DP + jd2 * 16 + v_col);
          mma_bf16(acc[2 * jd2], a, bv[0], bv[1]);
          mma_bf16(acc[2 * jd2 + 1], a, bv[2], bv[3]);
        }
      }
    }
  };

  // running max (log2 units) and partial sums of rows g and g + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  if constexpr (TWO_PASS) {
    // pass 1: the true row max over every key tile (K only)
    for (int t = 0; t < ntiles; ++t) {
      if (t + 1 < ntiles) {
        load_tile(t + 1, false);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      float s[BK / 8][4];
      scores(s, t);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        m0 = fmaxf(m0, fmaxf(s[j][0], s[j][1]));
        m1 = fmaxf(m1, fmaxf(s[j][2], s[j][3]));
      }
      __syncthreads();
    }
    m0 = quad_max(m0);
    m1 = quad_max(m1);
    load_tile(0, true);
  }
  // the shift of the exponent: the max, less log2(127) for int8 P
  constexpr float P_SHIFT = PV8 ? LOG2_127 : 0.f;

  for (int t = 0; t < ntiles; ++t) {
    if (t + 1 < ntiles) {
      load_tile(t + 1, true);  // into the stage tile t-1 used
      cp_async_wait<1>();      // tile t has landed (this thread's copies)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();           // ... and every thread's copies
    float s[BK / 8][4];
    scores(s, t);
    if constexpr (!TWO_PASS) {
      // online softmax: every row sees key 0 in tile 0, so the running max
      // is finite from there on and exp2(-inf - finite) = 0 clears the
      // empty start
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
        mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
      }
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
    }
    const float sh0 = m0 - P_SHIFT, sh1 = m1 - P_SHIFT;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = fast_exp2(s[j][0] - sh0);   // padded keys: exp2(-inf) = 0
      s[j][1] = fast_exp2(s[j][1] - sh0);
      s[j][2] = fast_exp2(s[j][2] - sh1);
      s[j][3] = fast_exp2(s[j][3] - sh1);
      l0 += s[j][0] + s[j][1];   // sums of the unrounded p
      l1 += s[j][2] + s[j][3];
    }
    accumulate_pv(s, t);
    __syncthreads();  // tile t consumed: its stage may be refilled
  }

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int n0 = q0 + wr + g, n1 = n0 + 8;
#pragma unroll
  for (int jd = 0; jd < D / 8; ++jd) {
    const int col = jd * 8 + t4 * 2;
    float v0 = 1.f, v1 = 1.f;  // V's column scales (int8 P.V)
    if constexpr (PV8) {
      v0 = fmaxf(v_amax[(size_t)bh * D + col], 1e-12f) / 127.f;
      v1 = fmaxf(v_amax[(size_t)bh * D + col + 1], 1e-12f) / 127.f;
    }
    if (n0 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)n0 * rs + col) =
          __floats2bfloat162_rn((float)acc[jd][0] * inv0 * v0,
                                (float)acc[jd][1] * inv0 * v1);
    if (n1 < N)
      *reinterpret_cast<__nv_bfloat162*>(o + base + (size_t)n1 * rs + col) =
          __floats2bfloat162_rn((float)acc[jd][2] * inv1 * v0,
                                (float)acc[jd][3] * inv1 * v1);
  }
}

// ---- host side ----------------------------------------------------------

// The scratch of every entry point (unused ones may be null):
//   k_prep: (B, N, H*D) bf16 k^;  k_q: (B, N, H*D) int8 k^;
//   k_stat: (B*H) fp32, zero on entry (the bf16 prep's ||k^||^2 maxima,
//     unused, or K4's max |k^|), or (B*H, N) fp32 per-row k scales (K7q);
//   v_amax: (B*H, D) fp32, zero on entry;  v_q: (B*H, D, NP) int8.
struct Args {
  const void *q, *k, *v, *cq, *sq, *ck, *sk;
  void *k_prep, *k_q, *k_stat, *v_amax, *v_q, *out;
  int B, N, H;
  float eps_q, eps_k;
  cudaStream_t st;
};

// The K prep of the scores under the attention (QK8: int8 k^ per row, or
// with TWO_PASS K4's per-head scale; else bf16 k^).
template <int D, bool QK8, bool TWO_PASS>
int launch_k(const Args& a) {
  if constexpr (QK8 && TWO_PASS)
    return launch_k_prep_q8bh<D>(a.k, a.ck, a.sk, a.k_prep, a.k_q, a.k_stat,
                                 a.B, a.N, a.H, a.eps_k, a.st);
  if constexpr (QK8 && !TWO_PASS) {
    dim3 g((a.N + PREP_ROWS - 1) / PREP_ROWS, a.B * a.H);
    prep_q8rows_kernel<D, 7><<<g, PREP_THREADS, 0, a.st>>>(
        static_cast<const bf16*>(a.k), static_cast<const float*>(a.ck),
        static_cast<const float*>(a.sk), static_cast<int8_t*>(a.k_q),
        static_cast<float*>(a.k_stat), a.N, a.H, a.N, a.eps_k);
    return (int)cudaGetLastError();
  }
  return launch_k_prep<D, false>(a.k, a.ck, a.sk, a.k_prep, a.k_stat, a.B,
                                 a.N, a.H, a.eps_k, a.st);
}

template <int D, bool QK8, bool PV8, bool TWO_PASS>
int launch_attn(const Args& a) {
  int e = launch_k<D, QK8, TWO_PASS>(a);
  if (e != 0) return e;
  if constexpr (PV8) {
    e = launch_v_prep<D>(a.v, a.v_amax, a.v_q, a.B, a.N, a.H,
                         (a.N + BK - 1) / BK * BK, a.st);
    if (e != 0) return e;
  }
  using S = SmemS<D, QK8, PV8>;
  auto kernel = attn_stream_kernel<D, QK8, PV8, TWO_PASS>;
  e = allow_smem(kernel, S::BYTES);
  if (e != 0) return e;
  dim3 g((a.N + BQ - 1) / BQ, a.H, a.B);
  kernel<<<g, THREADS, S::BYTES, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const float*>(a.cq),
      static_cast<const float*>(a.sq), QK8 ? a.k_q : a.k_prep,
      static_cast<const float*>(a.k_stat), PV8 ? a.v_q : a.v,
      static_cast<const float*>(a.v_amax), static_cast<bf16*>(a.out), a.N,
      a.H, a.eps_q);
  return (int)cudaGetLastError();
}

template <bool QK8, bool PV8, bool TWO_PASS>
int dispatch(const Args& a, int D) {
  switch (D) {
    case 16: return launch_attn<16, QK8, PV8, TWO_PASS>(a);
    case 32: return launch_attn<32, QK8, PV8, TWO_PASS>(a);
    case 64: return launch_attn<64, QK8, PV8, TWO_PASS>(a);
    case 128: return launch_attn<128, QK8, PV8, TWO_PASS>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry point: q, k, v, out (B, N, H*D) bf16, contiguous, 16-byte
// aligned; cq, sq, ck, sk (N, D) fp32 tables (norm weights folded in; cq, sq
// also carry scale*log2(e)); the scratch of `Args`; int8_qk selects the
// scores under K8a's int8 P.V (K4's). Each returns the CUDA error code of
// its launches (0 = success).
#define SD3_STREAM_PARAMS                                                    \
  const void *q, const void *k, const void *v, const void *cq,               \
      const void *sq, const void *ck, const void *sk, void *k_prep,          \
      void *k_q, void *k_stat, void *v_amax, void *v_q, void *out, int B,    \
      int N, int H, int D, int int8_qk, float eps_q, float eps_k,            \
      void *stream
#define SD3_STREAM_ARGS                                                      \
  Args{q,     k,   v,      cq,     sq,  ck, sk, k_prep, k_q, k_stat, v_amax, \
       v_q,   out, B,      N,      H,   eps_q, eps_k,                        \
       static_cast<cudaStream_t>(stream)}

// K7q: int8 scores with per-row k scales, online softmax, bf16 P.V. k_q,
// k_stat (B*H, N).
extern "C" int sd3_fused_attention_stream_int8qk(SD3_STREAM_PARAMS) {
  (void)int8_qk;
  return dispatch<true, false, false>(SD3_STREAM_ARGS, D);
}

// K8a: the true row max (two score passes), int8 P.V; bf16 scores (k_prep,
// k_stat (B*H)) or with int8_qk K4's (k_prep, k_q, k_stat (B*H)); v_amax,
// v_q.
extern "C" int sd3_fused_attention_int8pv(SD3_STREAM_PARAMS) {
  return int8_qk ? dispatch<true, true, true>(SD3_STREAM_ARGS, D)
                 : dispatch<false, true, true>(SD3_STREAM_ARGS, D);
}
