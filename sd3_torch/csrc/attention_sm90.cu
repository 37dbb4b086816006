// K1 and K7, the bf16 joint-attention forwards, for NVIDIA Hopper (sm_90a):
// one kernel, attn_sm90_kernel<D, Softmax>, on wgmma and TMA with a
// warp-specialised ring of K / V tiles.
//
// Replaces, in sd3_tpu/ops/fused_attention.py (both reached through
// _pallas_fused, at :642 and :660):
//   K1  `_fused_fwd_kernel` (:135), bf16 branch: the single-KV kernel (at
//       most 2048 padded tokens), softmax against the BOUNDED shift
//       ||q^|| * max ||k^|| (Softmax::Bounded);
//   K7  `_stream_fwd_kernel` (:312), bf16 branch: the streaming kernel
//       (more than 2048 padded tokens), an ONLINE softmax with the true
//       running max (Softmax::Online).
// What both compute, per (batch b, head h), from raw projections q, k, v of
// (B, N, H*D) bf16 and (N, D) fp32 tables with the per-stream norm weights
// folded in (the q tables also carry scale*log2(e), so the softmax runs in
// exp2):
//   q^ = rms(q) (x) (cq, sq)    k^ = rms(k) (x) (ck, sk)
//   o  = softmax_2(q^ k^T) v
// (RMSNorm over the head dim and the interleaved-pair rotation of
// attention_common.cuh). q^, k^ and p are rounded to bf16 before each
// product, l is the sum of the unrounded fp32 p and padded keys get p = 0,
// as in the TPU kernels and the plain versions (ops/fused_attention.py).
// Bounded: p = exp2(s - ||q^_row|| * max_rows ||k^||), both norms from the
// fp32 prep; the bound holds by Cauchy-Schwarz, so there is no rescale.
// Online: per 128-key tile, m the running row max, p = exp2(s - m), alpha =
// exp2(m_old - m) rescaling l and the accumulator; p is rounded against the
// running max of the card's 128-key tile (JAX's block is ~2176 keys), which
// the plain version reproduces with block_k = K7_KEY_TILE.
//
// Three launches:
//   1. q_prep_kernel<D, NORMS>: q^ in bf16 in the input layout and, for
//      Bounded, ||q^|| of every row from the fp32 prep.
//   2. k_prep_kernel<D, false> (attention_common.cuh): k^ in bf16 and max
//      ||k^||^2 per (b, h), which Bounded needs before its first key tile.
//      Prepping K again in each of the 34 query blocks of a (b, h) at
//      1024px would cost more than the one pass (83 MB read, 83 MB written)
//      it saves. q is prepped apart for another reason: the attention runs
//      one block per SM, so nothing hides a block's own prologue, and a q
//      prep inside it (the loads of 128 rows of q and of both q tables,
//      every thread waiting on its own) was close to half of a K1 block's
//      time in an earlier version of this kernel: more than the separate
//      pass costs, which writes q^ and reads it back (23 MB at 512px).
//   3. attn_sm90_kernel: three warpgroups per block of (128 query rows, h,
//      b), one block per SM (the consumers' registers).
//      - Warpgroup 0, the producer, gives its registers away (setmaxnreg);
//        one thread of it issues the TMA loads of the block's two 64-row q^
//        tiles, then of 128-key k^ and v tiles into a ring of STAGES
//        stages, with full and empty mbarriers kept apart for K and V: a K
//        stage frees once its scores are computed, a V stage once its P.V
//        has run. The tensor maps are 4-D views (D, H, N, B) of the
//        (B, N, H*D) tensors with boxes (D, 1, rows, 1), swizzled 32, 64 or
//        128 bytes for D = 16, 32, 64 and as two 128-byte atom columns for
//        D = 128; TMA zero-fills the rows past N, and the softmax masks the
//        padded keys of the ragged last tile (a zero key scores 0, not
//        -inf).
//      - Warpgroups 1 and 2, the consumers, own 64 query rows each. Per key
//        tile: S = q^ k^T by wgmma m64n128k16 with A (q^) and B (the K
//        tile) from shared memory, K-major; the softmax on the fp32 score
//        registers; O += P V by wgmma m64nDk16 with A = bf16(p) packed
//        straight from the score accumulators (their layout is the register
//        A fragment) and B the V tile, MN-major (the transpose bit).
//      - The softmax overlaps the products, twice over. Within a consumer,
//        S of tile t is issued together with P.V of tile t-1, and the
//        exp2s of tile t run while the tensor cores do that P.V. Between
//        the consumers, a ping-pong on two named barriers makes them take
//        turns to issue their products, so that one's softmax runs while
//        the other's products do. Two things keep ptxas from undoing this
//        (both read off the SASS): the wait for the P.V sits behind a
//        branch on the softmax's sums, since ptxas hoists a wait to the top
//        of its basic block; and the ragged tile's mask is one branch ahead
//        of the softmax, not one per column group inside it.
//
// What bounds them on this card, at the slice shapes (K1: B 8, N 1178, H
// 19, D 64; K7: B 8, N 4250, H 19, D 64): the two products are 4*B*H*N^2*D
// = 54.0 / 702.9 G FLOP, 0.0546 / 0.7107 ms at 989 TFLOP/s; the softmax is
// B*H*N^2 = 0.211 / 2.75 G exp2s, 0.0546 / 0.710 ms on the SFU (16 ex2 per
// SM per clock against 4096 FLOP: 1/256 of the FLOP rate, and one score is
// 4D = 256 FLOP at D = 64, so the two bounds are equal); q, k, v and o are
// 92 / 331 MB, 0.027 / 0.099 ms at 3.35 TB/s. A design that runs a tile's
// softmax and its products one after the other cannot pass half the bound;
// the overlap above is what this one does about the SFU. wgmma (the full
// tensor-core rate, each operand tile read from shared memory once per
// warpgroup rather than once per warp) and TMA (no thread spends an
// instruction on a copy) are what it does about the products.

#include <type_traits>

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int KEY_TILE = 128;               // keys per K / V tile
constexpr int QROWS = 64;                   // query rows per consumer
constexpr int CONSUMERS = 2;                // consumer warpgroups per block
constexpr int BLOCK_Q = QROWS * CONSUMERS;  // query rows per block
constexpr int WG = 128;                     // threads per warpgroup
constexpr int SM90_THREADS = WG * (1 + CONSUMERS);
// named barriers (0 is __syncthreads): TURN + c, consumer c's turn to issue
// its products
constexpr int TURN = 1;
// 384 threads x 168 registers at launch; the producer keeps 24, so each
// consumer thread can have 240
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

namespace Softmax {
struct Bounded {};  // K1: shift ||q^|| * max ||k^||, no rescale
struct Online {};   // K7: the running row max
}  // namespace Softmax

// Shared memory of attn_sm90_kernel<D, *>, from a 1024-byte aligned base;
// every tile in the swizzled layout of SwizzledRows<D> (sm90.cuh).
template <int D>
struct Sm90 : SwizzledRows<D> {
  static constexpr int STAGES = D == 128 ? 3 : 4;
  static constexpr int Q_TILE = QROWS * D * 2;      // one consumer's q^
  static constexpr int KV_TILE = KEY_TILE * D * 2;  // one K or V tile
  static constexpr int Q = 0;                       // [CONSUMERS] q^ tiles
  static constexpr int K = Q + CONSUMERS * Q_TILE;  // [STAGES] K tiles
  static constexpr int V = K + STAGES * KV_TILE;    // [STAGES] V tiles
  // mbarriers: full / empty of each K and V stage, full of each q^ tile
  static constexpr int BAR = V + STAGES * KV_TILE;
  static constexpr int BYTES = BAR + (4 * STAGES + CONSUMERS) * 8 + 1024;
};

// TMA of ROWS rows (n0.., head h, sample b) of a (B, N, H*D) tensor into a
// tile at `dst`, one box per atom column.
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int h, int n0, int b) {
  using S = Sm90<D>;
#pragma unroll
  for (int c = 0; c < S::COLS; ++c)
    tma_load_4d(dst + c * ROWS * S::W, m, bar, c * S::W / 2, h, n0, b);
}

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

// grid (ceil(N / BLOCK_Q), H, B), SM90_THREADS threads, Sm90<D>::BYTES of
// dynamic shared memory. tm_q, tm_k, tm_v: tensor maps of bf16 q^, k^ and v
// (see encode); q_norm (B*H, N) ||q^|| and k_max2 (B*H) max ||k^||^2
// (Bounded only); o (B, N, H*D) bf16.
template <int D, class SM>
__global__ void __launch_bounds__(SM90_THREADS, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ q_norm,
                 const float* __restrict__ k_max2, bf16* __restrict__ o,
                 int N, int H) {
  using S = Sm90<D>;
  constexpr bool BOUNDED = std::is_same<SM, Softmax::Bounded>::value;
  constexpr int STAGES = S::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_k = sb + S::BAR, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;
  const uint32_t full_q = empty_v + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z;
  const int ntiles = (N + KEY_TILE - 1) / KEY_TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
      mbar_init(empty_v + 8 * s, CONSUMERS * 4);
    }
    for (int c = 0; c < CONSUMERS; ++c) mbar_init(full_q + 8 * c, 1);
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // ---- producer: one thread loads the q^ tiles, then keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      for (int c = 0; c < CONSUMERS; ++c) {
        mbar_arrive_expect_tx(full_q + 8 * c, S::Q_TILE);
        load_tile<D, QROWS>(sb + S::Q + c * S::Q_TILE, &tm_q, full_q + 8 * c,
                            h, blockIdx.x * BLOCK_Q + c * QROWS, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, free_parity);
        mbar_arrive_expect_tx(full_k + 8 * s, S::KV_TILE);
        load_tile<D, KEY_TILE>(sb + S::K + s * S::KV_TILE, &tm_k,
                               full_k + 8 * s, h, t * KEY_TILE, b);
        mbar_wait(empty_v + 8 * s, free_parity);
        mbar_arrive_expect_tx(full_v + 8 * s, S::KV_TILE);
        load_tile<D, KEY_TILE>(sb + S::V + s * S::KV_TILE, &tm_v,
                               full_v + 8 * s, h, t * KEY_TILE, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const int n0 = blockIdx.x * BLOCK_Q + c * QROWS + warp * 16 + g;
    const int n1 = n0 + 8;                   // this thread's two rows

    // Bounded: the shift of rows n0, n1 (rows past N: q^ = 0, any shift)
    float shift0 = 0.f, shift1 = 0.f;
    if constexpr (BOUNDED) {
      const float kmax = sqrtf(k_max2[b * H + h]);
      const float* qn = q_norm + (size_t)(b * H + h) * N;
      if (n0 < N) shift0 = qn[n0] * kmax;
      if (n1 < N) shift1 = qn[n1] * kmax;
    }
    const uint32_t q_base = sb + S::Q + c * S::Q_TILE;
    float s[KEY_TILE / 2];     // scores, then p, of one tile
    uint32_t p[KEY_TILE / 4];  // bf16 p: the A fragments of the 8 P.V steps
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < KEY_TILE / 2; ++i) s[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    mbar_wait(full_q + 8 * c, 0);  // this consumer's q^ tile has landed
    // issue S = q^ k^T of key tile t
    auto issue_scores = [&](int t) {
      const int st = t % STAGES;
      mbar_wait(full_k + 8 * st, (t / STAGES) & 1);
      const uint32_t kb = sb + S::K + st * S::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KEY_TILE>(s, desc_k_major<D>(q_base, QROWS, kk),
                           desc_k_major<D>(kb, KEY_TILE, kk), kk > 0);
      wgmma_commit();
    };
    // issue acc += bf16(p) v of key tile t
    auto issue_pv = [&](int t) {
      const int st = t % STAGES;
      mbar_wait(full_v + 8 * st, (t / STAGES) & 1);
      const uint32_t vb = sb + S::V + st * S::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEY_TILE / 16; ++kk) {
        const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                               p[4 * kk + 3]};
        wgmma_rs<D>(acc, a, desc_mn_major<D>(vb, KEY_TILE, kk), 1);
      }
      wgmma_commit();
    };
    // this warp is done with stage t % STAGES of K or V
    auto release = [&](uint32_t empty, int t) {
      if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
    };
    // s -> p = exp2(s - shift) in place, l updated; Online: the running
    // max too, and alpha of rows g, g + 8 returned in a0, a1. Padded keys
    // of the ragged last tile (zero rows of the TMA box, which score 0) go
    // to -inf first, so exp2 gives them p = 0: one branch a tile, ahead of
    // the unrolled arithmetic, which it would otherwise cut into blocks.
    auto softmax = [&](int t, float& a0, float& a1) {
      const int k0 = t * KEY_TILE;
      if (k0 + KEY_TILE > N) {
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
          const int col = k0 + j * 8 + t4 * 2;
          if (col >= N) s[4 * j] = s[4 * j + 2] = -INFINITY;
          if (col + 1 >= N) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        }
      }
      float sh0 = shift0, sh1 = shift1;
      if constexpr (!BOUNDED) {
        // the row max over PARTS partial maxima: shorter chains for the
        // exp2s to wait on, where the registers allow
        constexpr int PARTS = D <= 64 ? 4 : 1;
        float x0[PARTS], x1[PARTS];
#pragma unroll
        for (int i = 0; i < PARTS; ++i) {
          x0[i] = fmaxf(s[4 * i], s[4 * i + 1]);
          x1[i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
        }
#pragma unroll
        for (int j = PARTS; j < KEY_TILE / 8; ++j) {
          x0[j % PARTS] = fmaxf(x0[j % PARTS], fmaxf(s[4 * j], s[4 * j + 1]));
          x1[j % PARTS] =
              fmaxf(x1[j % PARTS], fmaxf(s[4 * j + 2], s[4 * j + 3]));
        }
        float mx0 = x0[0], mx1 = x1[0];
#pragma unroll
        for (int i = 1; i < PARTS; ++i) {
          mx0 = fmaxf(mx0, x0[i]);
          mx1 = fmaxf(mx1, x1[i]);
        }
        // every row sees key 0 in tile 0, so the running max is finite
        // from there on and exp2(-inf - finite) = 0 clears the empty start
        sh0 = fmaxf(m0, quad_max(mx0));
        sh1 = fmaxf(m1, quad_max(mx1));
        a0 = fast_exp2(m0 - sh0);
        a1 = fast_exp2(m1 - sh1);
        m0 = sh0;
        m1 = sh1;
        l0 *= a0;
        l1 *= a1;
      }
#pragma unroll
      for (int j = 0; j < KEY_TILE / 8; ++j) {
        s[4 * j] = fast_exp2(s[4 * j] - sh0);
        s[4 * j + 1] = fast_exp2(s[4 * j + 1] - sh0);
        s[4 * j + 2] = fast_exp2(s[4 * j + 2] - sh1);
        s[4 * j + 3] = fast_exp2(s[4 * j + 3] - sh1);
        l0 += s[4 * j] + s[4 * j + 1];  // sums of the unrounded p
        l1 += s[4 * j + 2] + s[4 * j + 3];
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < KEY_TILE / 4; ++i)
        p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
    };

    // Ping-pong: the consumers take turns to issue their products (named
    // barriers TURN + c, each met by this consumer's sync and the other's
    // arrive), so that one's softmax runs while the other's products do.
    // Consumer 0 goes first; consumer 1 does not hand over after its last
    // turn, which balances every barrier's arrivals (ntiles + 1 turns each).
    const int my_turn = TURN + c, other_turn = TURN + 1 - c;
    if (c == 1) named_bar_arrive(other_turn, 2 * WG);
    auto take_turn = [&]() { named_bar_sync(my_turn, 2 * WG); };
    auto hand_over = [&]() { named_bar_arrive(other_turn, 2 * WG); };

    float a0 = 1.f, a1 = 1.f;
    take_turn();
    issue_scores(0);
    hand_over();
    wgmma_wait<0>();
    reg_fence(s);
    release(empty_k, 0);
    softmax(0, a0, a1);
    pack_p();
    for (int t = 1; t < ntiles; ++t) {
      take_turn();
      issue_scores(t);   // S of tile t ...
      issue_pv(t - 1);   // ... and P.V of tile t-1 on the tensor cores
      hand_over();
      wgmma_wait<1>();   // S of tile t done
      reg_fence(s);
      release(empty_k, t);
      softmax(t, a0, a1);  // while P.V of tile t-1 and the other's run
      // The wait for that P.V, behind a branch on the softmax's sums that
      // always takes the first arm: ptxas hoists a wait to the top of its
      // basic block, which put this one, and the whole softmax after it,
      // behind the P.V it should overlap (seen in the SASS). The branch
      // ends the block after the softmax.
      if (__shfl_sync(0xffffffffu, __float_as_uint(l0 + l1), 0) !=
          0xffffffffu) {
        wgmma_wait<0>();
      } else {
        wgmma_wait<0>();
        __trap();
      }
      reg_fence(acc);
      reg_fence(p);
      release(empty_v, t - 1);
      if constexpr (!BOUNDED) {
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          acc[4 * j] *= a0;
          acc[4 * j + 1] *= a0;
          acc[4 * j + 2] *= a1;
          acc[4 * j + 3] *= a1;
        }
      }
      pack_p();
    }
    take_turn();
    issue_pv(ntiles - 1);
    if (c == 0) hand_over();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(p);
    release(empty_v, ntiles - 1);

    // o = acc / l, bf16, rows past N not stored
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const size_t rs = (size_t)H * D;
    const size_t base = (size_t)b * N * rs + (size_t)h * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const int col = j * 8 + t4 * 2;
      if (n0 < N)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)n0 * rs + col) =
            pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (n1 < N)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)n1 * rs + col) =
            pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

// ---- host side ----------------------------------------------------------

// The tensor map of a (B, N, H*D) bf16 tensor as the 4-D view (D, H, N, B),
// with boxes of one atom column of a head (W / 2 values), one head, ROWS
// rows and one sample, in the swizzle of Sm90<D>; rows past N read as
// zeros. Returns the CUresult of the encode (0 = success).
template <int D, int ROWS>
int encode(CUtensorMap* m, const void* x, int B, int N, int H) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)N,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)N * H * D * 2};
  const cuuint32_t box[4] = {(cuuint32_t)(Sm90<D>::W / 2), 1, ROWS, 1};
  return encode_bf16_4d<D>(m, x, dims, strides, box);
}

struct Args {
  const void *q, *k, *v, *cq, *sq, *ck, *sk;
  void *q_prep, *q_norm, *k_prep, *k_max2, *out;
  int B, N, H;
  float eps_q, eps_k;
  cudaStream_t st;
};

// The q and K preps, the three tensor maps, the attention; the first error.
template <int D, class SM>
int launch_sm90(const Args& a) {
  constexpr bool BOUNDED = std::is_same<SM, Softmax::Bounded>::value;
  dim3 g((a.N + PREP_ROWS - 1) / PREP_ROWS, a.B * a.H);
  q_prep_kernel<D, BOUNDED><<<g, PREP_THREADS, 0, a.st>>>(
      static_cast<const bf16*>(a.q), static_cast<const float*>(a.cq),
      static_cast<const float*>(a.sq), static_cast<bf16*>(a.q_prep),
      static_cast<float*>(a.q_norm), a.N, a.H, a.eps_q);
  int e = (int)cudaGetLastError();
  if (e != 0) return e;
  e = launch_k_prep<D, false>(a.k, a.ck, a.sk, a.k_prep, a.k_max2, a.B, a.N,
                              a.H, a.eps_k, a.st);
  if (e != 0) return e;
  CUtensorMap tm_q, tm_k, tm_v;
  e = encode<D, QROWS>(&tm_q, a.q_prep, a.B, a.N, a.H);
  if (e != 0) return e;
  e = encode<D, KEY_TILE>(&tm_k, a.k_prep, a.B, a.N, a.H);
  if (e != 0) return e;
  e = encode<D, KEY_TILE>(&tm_v, a.v, a.B, a.N, a.H);
  if (e != 0) return e;
  auto kernel = attn_sm90_kernel<D, SM>;
  e = allow_smem(kernel, Sm90<D>::BYTES);
  if (e != 0) return e;
  dim3 grid((a.N + BLOCK_Q - 1) / BLOCK_Q, a.H, a.B);
  kernel<<<grid, SM90_THREADS, Sm90<D>::BYTES, a.st>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(a.q_norm),
      static_cast<const float*>(a.k_max2), static_cast<bf16*>(a.out), a.N,
      a.H);
  return (int)cudaGetLastError();
}

template <class SM>
int dispatch(const Args& a, int D) {
  switch (D) {
    case 16: return launch_sm90<16, SM>(a);
    case 32: return launch_sm90<32, SM>(a);
    case 64: return launch_sm90<64, SM>(a);
    case 128: return launch_sm90<128, SM>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points: q, k, v, out (B, N, H*D) bf16, contiguous, 16-byte
// aligned; cq, sq, ck, sk (N, D) fp32 tables (norm weights folded in; cq, sq
// also carry scale*log2(e)); q_prep, k_prep (B, N, H*D) bf16 scratch;
// q_norm (B*H, N) fp32 scratch (K1; K7 takes none); k_max2 (B*H) fp32, zero
// on entry. Each returns 0, or the first error: a cudaError_t of a launch or
// the CUresult of a tensor-map encode.
#define SD3_SM90_PARAMS                                                     \
  const void *q, const void *k, const void *v, const void *cq,              \
      const void *sq, const void *ck, const void *sk, void *q_prep,         \
      void *q_norm, void *k_prep, void *k_max2, void *out, int B, int N,    \
      int H, int D, float eps_q, float eps_k, void *stream
#define SD3_SM90_ARGS                                                       \
  Args{q,      k,      v,      cq,  sq, ck, sk,    q_prep, q_norm, k_prep,  \
       k_max2, out,    B,      N,   H,  eps_q, eps_k,                       \
       static_cast<cudaStream_t>(stream)}

// K1: the bounded softmax.
extern "C" int sd3_fused_attention_bf16(SD3_SM90_PARAMS) {
  return dispatch<Softmax::Bounded>(SD3_SM90_ARGS, D);
}

// K7: the online softmax over 128-key tiles.
extern "C" int sd3_fused_attention_stream(SD3_SM90_PARAMS) {
  return dispatch<Softmax::Online>(SD3_SM90_ARGS, D);
}
