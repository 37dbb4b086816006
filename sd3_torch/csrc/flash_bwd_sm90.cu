// K6a and K6b, the flash-attention backward, for NVIDIA Hopper (sm_90a):
// flash_dq_sm90_kernel<D> (dq and delta) and flash_dkv_sm90_kernel<D> (dk,
// dv), on wgmma and TMA with a warp-specialised ring, after the design of
// attention_sm90.cu (K1, K7).
//
// Replaces, in sd3_tpu/ops/flash_attention.py (the custom VJP of
// flash_attention, pallas_calls at :274 and :291):
//   K6a `_dq_kernel` (:191):  dq = (ds k) * scale
//   K6b `_dkv_kernel` (:222): dv = bf16(p)^T dO,  dk = (ds^T q) * scale
// with p = exp(q k^T * scale - lse) and ds = bf16(p * (dO v^T - delta)),
// delta = rowsum(dO * o), on (B, H, N, D) views of q, k, v, o, dO.
//
// Numerics of the TPU kernels and of the plain versions
// (ops/flash_attention.py), kept: logits in fp32 from bf16 operands; p in
// fp32, unrounded in ds and rounded to bf16 before p^T dO; ds rounded to
// bf16 before both of its products; dq and dk scaled after the sums; bf16
// outputs, fp32 lse and delta. The scale is folded with log2(e) into one
// exp2: K6a takes p = exp2(s * scale * log2(e) - lse * log2(e)); K6b's
// score products accumulate onto -lse / scale and its dP^T onto -delta, so
// that p = exp2(s * scale * log2(e)) and ds = p dp (the same fp32 terms
// summed in another order). delta, which the JAX package computes in XLA
// between the two kernels, is computed in fp32 by K6a's consumers and
// written out for K6b. No atomics: every output element is summed by one
// thread in one order, so results are bitwise the same from run to run.
//
// Both kernels: three warpgroups per block, one block per SM (the
// consumers' registers), each block on items of 128 rows of one head of
// one sample. K6a launches a block per item, grid (ceil(N / 128), H, B).
// K6b runs one persistent block per SM over the items, x fastest; its ring
// and barriers run on across items, so its producer loads the next item's
// first tiles while the consumers finish the last one, and a block's start
// and end are no longer exposed (about a quarter of the time at the 512px
// training shape with a block per item: PERF.md). The same made K6a
// slower, with its lse and delta loads moved to the producer or not.
// - Warpgroup 0, the producer, gives its registers away (setmaxnreg). Its
//   first warp issues TMA loads: an item's resident tiles, then a ring of
//   STAGES stages of streamed tiles. The tensor maps are 4-D views
//   (D, N, H, B) built from the (b, h, n) element strides of each tensor,
//   so the (B, N, H, D)-strided views of the training path are read in
//   place, with boxes (W / 2, rows, 1, 1), swizzled 32, 64 or 128 bytes
//   for D = 16, 32, 64 and as two 128-byte atom columns for D = 128
//   (SwizzledRows, sm90.cuh). TMA zero-fills rows past N.
// - Warpgroups 1 and 2, the consumers, own 64 rows each. Their products
//   are wgmma m64n64k16 with B a shared-memory tile: the score products
//   with A = q, dO (K6a, SS) or k, v (K6b, RS: the A fragments loaded once
//   an item from the resident tiles; a little faster than SS there, and
//   slower in K6a, where ptxas then gave up its overlap), the gradient
//   products RS with A = bf16(p) or bf16(ds) packed straight from the
//   score accumulators (their layout is the register A fragment, as K7
//   packs p) and B read MN-major (the transpose bit).
// - The exp2s overlap the products. Between the consumers, a ping-pong on
//   two named barriers makes them take turns to issue, so that one's
//   arithmetic runs while the other's products do. Within a K6a consumer,
//   the score products of tile t are issued together with dQ of tile t-1,
//   and the p / ds arithmetic of tile t runs while the tensor cores do dQ;
//   the wait for dQ sits behind a branch on the arithmetic's results, since
//   ptxas hoists a wait to the top of its basic block (as K7's SASS
//   showed). K6b waits for all its products before its arithmetic (see its
//   loop).
//
// K6a, flash_dq_sm90_kernel: a block is 128 query rows. Resident: each
// consumer's 64 rows of q and dO (TMA), lse of its rows and the delta it
// computes from o and dO (fp32 dot products of bf16 rows, four lanes a
// row). Streamed: 64-key tiles of k and v (32-key at D = 128), with full
// / empty barriers kept apart for K and V (a V stage frees once dP is
// done, a K stage once dQ is). Per key tile: S = q k^T and dP = dO v^T,
// ds = p (dp - delta), dQ += bf16(ds) k (N = D, k MN-major). Padded keys
// of the ragged last tile go to -inf before the exp2 (a zero key scores 0,
// not -inf), so their p is 0. The key tile is 64, not K7's 128: at 128, S,
// dP, dQ and the packed ds of the tile before take 192 of a consumer's
// registers, and ptxas spilled 724 bytes of them.
// K6b, flash_dkv_sm90_kernel: an item is 128 key rows. Resident: each
// consumer's 64 rows of k and v, in registers (D <= 64). Streamed: 64-row
// tiles of q
// and dO with the matching slices of lse (over the scale) and delta, which
// the producer warp's lanes load into the stage before they arrive on its
// full barrier. Per query tile: S^T = k q^T and dP^T = v dO^T (N = 64),
// p^T and ds^T in fp32, dV += bf16(p^T) dO and dK += bf16(ds^T) q (N = D,
// dO and q MN-major). Query rows past N get lse = +inf in the stage, so
// p = exp2(-inf) = 0 there: the zero-filled q rows score 0, and a zero lse
// would give them p = 1. Key rows past N are not written. The query tile
// is 64 rows, not 128: S^T, dP^T, dK and dV take 128 of a consumer's
// registers at 64, and would not fit beside the packed operands at 128.
// At D = 128 dK and dV alone take 128 registers, and k and v as register
// fragments 64 more: there the score products read k and v from the
// resident tiles in shared memory (SS; the tiles are freed for the next
// item once the item's last score products are done), and the query tile
// is 32 rows (S^T, dP^T 32 registers, their packed operands 16), which
// keeps a consumer within its 232 registers. K6a at D = 128 holds dQ (64),
// S, dP (32) and the packed ds (8) with a key tile of 32 (at 64 keys ptxas
// spilled 40 bytes); its rings (4 stages of 32-key k and v tiles, 8 KB
// each, beside the 64 KB of q and dO) take 130 KB of shared memory.
//
// What bounds them on this card, at the 512px training shape (B 4, H 19,
// N 1178, D 64): K6a's three products are 6*B*H*N^2*D = 40.5 G FLOP,
// 0.041 ms at 989 TFLOP/s; K6b's four 54.0 G FLOP, 0.055 ms; each takes
// B*H*N^2 = 0.105 G exp2s, 0.027 ms on the SFU (1/256 of the FLOP rate);
// each reads ~6 bf16 tensors of 11.5 MB, ~0.02 ms at 3.35 TB/s. The tensor
// cores bound both; the overlap above keeps the exp2s off their path,
// wgmma and TMA are what the design does about the products, and the
// persistent blocks of K6b about the fixed cost of each block.

#include "mma.cuh"
#include "sm90.cuh"

namespace {

constexpr int ROWS = 64;                   // rows per consumer
constexpr int CONSUMERS = 2;               // consumer warpgroups per block
constexpr int BLOCK = ROWS * CONSUMERS;    // rows per block
constexpr int STAGES = 4;                  // ring stages of both kernels
constexpr int WG = 128;                    // threads per warpgroup
constexpr int THREADS = WG * (1 + CONSUMERS);
// named barriers (0 is __syncthreads): TURN + c, consumer c's turn to issue
// its products
constexpr int TURN = 1;
// 384 threads x 168 registers at launch; the producer keeps 40 (K6b's
// producer warp loads lse and delta as well as issuing TMA), so each
// consumer thread can have 232
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of flash_dq_sm90_kernel<D>, from a 1024-byte aligned base.
// K6a's key tile: 64 keys; 32 at D = 128, where dQ's 64 accumulators beside
// S, dP and the packed ds of 64 keys spilled (40 bytes)
template <int D>
struct DqSmem {
  static constexpr int KEY_TILE = D == 128 ? 32 : 64;  // keys per k / v tile
  static constexpr int ROW_TILE = ROWS * D * 2;     // 64 rows of q or dO
  static constexpr int KV_TILE = KEY_TILE * D * 2;  // one k or v tile
  static constexpr int Q = 0;                       // [CONSUMERS] q tiles
  static constexpr int DO = Q + CONSUMERS * ROW_TILE;   // [CONSUMERS] dO
  static constexpr int K = DO + CONSUMERS * ROW_TILE;   // [STAGES] k tiles
  static constexpr int V = K + STAGES * KV_TILE;        // [STAGES] v tiles
  // mbarriers: full / empty of each K and V stage, full of each consumer's
  // q and dO
  static constexpr int BAR = V + STAGES * KV_TILE;
  static constexpr int BYTES = BAR + (4 * STAGES + CONSUMERS) * 8 + 1024;
};

// K6b's query tile, and whether its score products read k and v from
// shared memory (SS) rather than as register fragments (D <= 64)
template <int D>
struct DkvCfg {
  static constexpr bool SS = D == 128;
  static constexpr int Q_TILE = SS ? 32 : 64;  // queries per q / dO tile
};

// Shared memory of flash_dkv_sm90_kernel<D>, from a 1024-byte aligned base.
template <int D>
struct DkvSmem {
  static constexpr int Q_TILE = DkvCfg<D>::Q_TILE;
  static constexpr int ROW_TILE = ROWS * D * 2;     // 64 rows of k or v
  static constexpr int QT_TILE = Q_TILE * D * 2;    // one q or dO tile
  static constexpr int K = 0;                       // [CONSUMERS] k tiles
  static constexpr int V = K + CONSUMERS * ROW_TILE;    // [CONSUMERS] v
  static constexpr int Q = V + CONSUMERS * ROW_TILE;    // [STAGES] q tiles
  static constexpr int DO = Q + STAGES * QT_TILE;       // [STAGES] dO tiles
  static constexpr int LSE = DO + STAGES * QT_TILE;     // [STAGES][Q_TILE]
  static constexpr int DELTA = LSE + STAGES * Q_TILE * 4;  // [STAGES][Q_TILE]
  // mbarriers: full / empty of each stage, full of each consumer's k and v,
  // empty of both
  static constexpr int BAR = DELTA + STAGES * Q_TILE * 4;
  static constexpr int BYTES = BAR + (2 * STAGES + CONSUMERS + 1) * 8 + 1024;
};

// TMA of R rows (n0.., head h, sample b) of a (D, N, H, B) view into a tile
// at `dst`, one box per atom column.
template <int D, int R>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int n0, int h, int b) {
  using S = SwizzledRows<D>;
#pragma unroll
  for (int c = 0; c < S::COLS; ++c)
    tma_load_4d(dst + c * R * S::W, m, bar, c * S::W / 2, n0, h, b);
}

// The dynamic shared memory, moved up to a 1024-byte boundary (the 128-byte
// swizzle's pattern repeats every 1024 bytes).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  return raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
}

// Consumer c's turns (named barriers TURN + c, each met by this consumer's
// sync and the other's arrive). Consumer 0 goes first; consumer 1 does not
// hand over after its last turn, which balances every barrier's arrivals.
struct PingPong {
  int mine, other;
  __device__ explicit PingPong(int c) : mine(TURN + c), other(TURN + 1 - c) {
    if (c == 1) named_bar_arrive(other, 2 * WG);
  }
  __device__ void take() const { named_bar_sync(mine, 2 * WG); }
  __device__ void hand_over() const { named_bar_arrive(other, 2 * WG); }
};

// Wait for every wgmma group, behind a branch on `x` that always takes the
// first arm: ptxas hoists a wait to the top of its basic block, so a plain
// wait here would rise above the arithmetic that computes x, the work it
// should overlap. The branch ends the block after it.
__device__ __forceinline__ void wait_all_after(float x) {
  if (__shfl_sync(0xffffffffu, __float_as_uint(x), 0) != 0xffffffffu) {
    wgmma_wait<0>();
  } else {
    wgmma_wait<0>();
    __trap();
  }
}

// sum over a quarter of a row (lane t4 of its quad) of a * b in fp32, from
// bf16 rows a, b of D values: 8 per 16-byte load, or at D = 16 the 4 of one
// 8-byte load
template <int D>
__device__ __forceinline__ float quarter_dot(const bf16* a, const bf16* b,
                                             int t4) {
  constexpr int E = D / 4;  // values per lane
  float sum = 0.f;
  if constexpr (E < 8) {
    static_assert(E == 4, "D = 16");
    const uint2 x = *reinterpret_cast<const uint2*>(a + t4 * E);
    const uint2 y = *reinterpret_cast<const uint2*>(b + t4 * E);
    const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
    const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const float2 fx = __bfloat1622float2(xs[j]);
      const float2 fy = __bfloat1622float2(ys[j]);
      sum += fx.x * fy.x + fx.y * fy.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < E / 8; ++i) {
      const uint4 x = *reinterpret_cast<const uint4*>(a + t4 * E + 8 * i);
      const uint4 y = *reinterpret_cast<const uint4*>(b + t4 * E + 8 * i);
      const __nv_bfloat162* xs = reinterpret_cast<const __nv_bfloat162*>(&x);
      const __nv_bfloat162* ys = reinterpret_cast<const __nv_bfloat162*>(&y);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(xs[j]);
        const float2 fy = __bfloat1622float2(ys[j]);
        sum += fx.x * fy.x + fx.y * fy.y;
      }
    }
  }
  return sum;
}

// Write rows r0 (acc[4j], acc[4j+1]) and r0 + 8 (acc[4j+2], acc[4j+3]) of a
// consumer's D / 2 accumulators times `mul` as bf16 into one head of a
// (B, H, N, D) view (row stride sn); rows >= N are skipped.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long sn,
                                           const float (&acc)[D / 2],
                                           float mul, int r0, int N, int t4) {
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dst + r0 * sn + col) =
          pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
    if (r0 + 8 < N)
      *reinterpret_cast<uint32_t*>(dst + (r0 + 8) * sn + col) =
          pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
  }
}

// The register A fragments (wgmma_rs) of this warp's 16 rows of a 64-row
// tile of D <= 64 values in the swizzled layout at `tile`: k-step kk holds
// (row g, values 16kk + 2t4, +1), (row g + 8, the same), (row g, 16kk + 8 +
// 2t4, +1), (row g + 8, the same), g = lane / 4, t4 = lane % 4.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&f)[D / 16][4],
                                            const unsigned char* tile,
                                            int warp, int lane) {
  using S = SwizzledRows<D>;
  static_assert(S::COLS == 1, "one atom column");
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = warp * 16 + g + (i & 1) * 8;
      const int byte = kk * 32 + (i >> 1) * 16 + t4 * 4;  // within the row
      const int chunk = (byte >> 4) ^ ((row * S::W >> 7) & (S::W / 16 - 1));
      f[kk][i] = *reinterpret_cast<const uint32_t*>(
          tile + row * S::W + chunk * 16 + (byte & 15));
    }
}

// ---- K6a ----------------------------------------------------------------

// grid (ceil(N / BLOCK), H, B), THREADS threads, DqSmem<D>::BYTES of dynamic
// shared memory. tm_q, tm_k, tm_v, tm_do: tensor maps of q, k, v, dO (see
// encode_view, sm90.cuh); o and dout with their views for delta; lse (B*H, N) fp32;
// delta (B*H, N) fp32, written; dq (B, H, N, D) bf16 view.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const bf16* __restrict__ o, const bf16* __restrict__ dout,
                     const float* __restrict__ lse, float* __restrict__ delta,
                     bf16* __restrict__ dq, View vo, View vdo, View vdq,
                     int N, int H, float scale_log2, float scale) {
  using S = DqSmem<D>;
  constexpr int KEY_TILE = S::KEY_TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_k = sb + S::BAR, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * STAGES;
  const uint32_t full_q = empty_v + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * BLOCK;
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
    // ---- producer: one thread loads q and dO, then keeps the ring full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      tma_prefetch(&tm_do);
      for (int c = 0; c < CONSUMERS; ++c) {
        mbar_arrive_expect_tx(full_q + 8 * c, 2 * S::ROW_TILE);
        load_rows<D, ROWS>(sb + S::Q + c * S::ROW_TILE, &tm_q, full_q + 8 * c,
                           q0 + c * ROWS, h, b);
        load_rows<D, ROWS>(sb + S::DO + c * S::ROW_TILE, &tm_do,
                           full_q + 8 * c, q0 + c * ROWS, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        const uint32_t free_parity = ((t / STAGES) & 1) ^ 1;
        mbar_wait(empty_k + 8 * s, free_parity);
        mbar_arrive_expect_tx(full_k + 8 * s, S::KV_TILE);
        load_rows<D, KEY_TILE>(sb + S::K + s * S::KV_TILE, &tm_k,
                               full_k + 8 * s, t * KEY_TILE, h, b);
        mbar_wait(empty_v + 8 * s, free_parity);
        mbar_arrive_expect_tx(full_v + 8 * s, S::KV_TILE);
        load_rows<D, KEY_TILE>(sb + S::V + s * S::KV_TILE, &tm_v,
                               full_v + 8 * s, t * KEY_TILE, h, b);
      }
    }
  } else {
    // ---- consumers: 64 query rows each
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const int n0 = q0 + c * ROWS + warp * 16 + g;
    const int n1 = n0 + 8;                   // this thread's two rows
    const size_t bhn = ((size_t)b * H + h) * N;

    // delta of rows n0, n1 = rowsum(dO * o) in fp32, each lane of the quad
    // a quarter of the row; written for K6b. lse in log2 units. Rows past N
    // take 0 for both: their q and dO are zero, and they are not written.
    const bf16* oh = o + b * vo.b + h * vo.h;
    const bf16* dh = dout + b * vdo.b + h * vdo.h;
    float d0 = 0.f, d1 = 0.f, L0 = 0.f, L1 = 0.f;
    if (n0 < N) {
      d0 = quarter_dot<D>(oh + n0 * vo.n, dh + n0 * vdo.n, t4);
      L0 = lse[bhn + n0] * LOG2E;
    }
    if (n1 < N) {
      d1 = quarter_dot<D>(oh + n1 * vo.n, dh + n1 * vdo.n, t4);
      L1 = lse[bhn + n1] * LOG2E;
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t4 == 0) {
      if (n0 < N) delta[bhn + n0] = d0;
      if (n1 < N) delta[bhn + n1] = d1;
    }

    const uint32_t q_base = sb + S::Q + c * S::ROW_TILE;
    const uint32_t do_base = sb + S::DO + c * S::ROW_TILE;
    float s[KEY_TILE / 2];       // scores, then p, of one key tile
    float dp[KEY_TILE / 2];      // dO v^T, then ds
    uint32_t ds[KEY_TILE / 4];   // bf16 ds: the A fragments of dQ's steps
    float acc[D / 2];            // dq
#pragma unroll
    for (int i = 0; i < KEY_TILE / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    mbar_wait(full_q + 8 * c, 0);  // this consumer's q and dO have landed

    // issue S = q k^T and dP = dO v^T of key tile t
    auto issue_scores = [&](int t) {
      const int st = t % STAGES;
      mbar_wait(full_k + 8 * st, (t / STAGES) & 1);
      mbar_wait(full_v + 8 * st, (t / STAGES) & 1);
      const uint32_t kb = sb + S::K + st * S::KV_TILE;
      const uint32_t vb = sb + S::V + st * S::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KEY_TILE>(s, desc_k_major<D>(q_base, ROWS, kk),
                           desc_k_major<D>(kb, KEY_TILE, kk), kk > 0);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KEY_TILE>(dp, desc_k_major<D>(do_base, ROWS, kk),
                           desc_k_major<D>(vb, KEY_TILE, kk), kk > 0);
      wgmma_commit();
    };
    // issue acc += bf16(ds) k of key tile t
    auto issue_dq = [&](int t) {
      const uint32_t kb = sb + S::K + (t % STAGES) * S::KV_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEY_TILE / 16; ++kk) {
        const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                               ds[4 * kk + 3]};
        wgmma_rs<D>(acc, a, desc_mn_major<D>(kb, KEY_TILE, kk), 1);
      }
      wgmma_commit();
    };
    // this warp is done with stage t % STAGES of K or V
    auto release = [&](uint32_t empty, int t) {
      if (lane == 0) mbar_arrive(empty + 8 * (t % STAGES));
    };
    // s, dp -> p, ds = p (dp - delta) in place. Padded keys of the ragged
    // last tile (zero rows of the TMA box, which score 0) go to -inf first,
    // so exp2 gives them p = 0: one branch a tile, ahead of the unrolled
    // arithmetic, which it would otherwise cut into blocks.
    auto grads = [&](int t) {
      const int k0 = t * KEY_TILE;
      if (k0 + KEY_TILE > N) {
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
          const int col = k0 + j * 8 + t4 * 2;
          if (col >= N) s[4 * j] = s[4 * j + 2] = -INFINITY;
          if (col + 1 >= N) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
        }
      }
#pragma unroll
      for (int j = 0; j < KEY_TILE / 8; ++j) {
        const float p0 = fast_exp2(s[4 * j] * scale_log2 - L0);
        const float p1 = fast_exp2(s[4 * j + 1] * scale_log2 - L0);
        const float p2 = fast_exp2(s[4 * j + 2] * scale_log2 - L1);
        const float p3 = fast_exp2(s[4 * j + 3] * scale_log2 - L1);
        dp[4 * j] = p0 * (dp[4 * j] - d0);
        dp[4 * j + 1] = p1 * (dp[4 * j + 1] - d0);
        dp[4 * j + 2] = p2 * (dp[4 * j + 2] - d1);
        dp[4 * j + 3] = p3 * (dp[4 * j + 3] - d1);
      }
    };
    auto pack_ds = [&]() {
#pragma unroll
      for (int i = 0; i < KEY_TILE / 4; ++i)
        ds[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
    };

    const PingPong turn(c);
    turn.take();
    issue_scores(0);
    turn.hand_over();
    wgmma_wait<0>();
    reg_fence(s);
    reg_fence(dp);
    release(empty_v, 0);
    grads(0);
    pack_ds();
    for (int t = 1; t < ntiles; ++t) {
      turn.take();
      issue_scores(t);  // S, dP of tile t ...
      issue_dq(t - 1);  // ... and dQ of tile t-1 on the tensor cores
      turn.hand_over();
      wgmma_wait<1>();  // S, dP of tile t done
      reg_fence(s);
      reg_fence(dp);
      release(empty_v, t);
      grads(t);  // while dQ of tile t-1 and the other's products run
      wait_all_after(dp[KEY_TILE / 2 - 1]);
      reg_fence(acc);
      reg_fence(ds);
      release(empty_k, t - 1);
      pack_ds();
    }
    turn.take();
    issue_dq(ntiles - 1);
    if (c == 0) turn.hand_over();
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(ds);
    release(empty_k, ntiles - 1);

    store_rows<D>(dq + b * vdq.b + h * vdq.h, vdq.n, acc, scale,
                  n0, N, t4);
  }
}

// ---- K6b ----------------------------------------------------------------

// Work item `item` of a persistent block: (row block x, head h, sample b),
// x fastest, so that the blocks in flight share their streamed tiles in L2.
struct Item {
  int x, h, b;
  __device__ Item(int item, int nx, int H)
      : x(item % nx), h(item / nx % H), b(item / nx / H) {}
};

// grid min(SMs, ceil(N / BLOCK) * H * B) persistent blocks, THREADS threads,
// DkvSmem<D>::BYTES of dynamic shared memory. tm_q, tm_k, tm_v, tm_do:
// tensor maps of q, k, v, dO (see encode_view); lse, delta (B*H, N) fp32;
// dk, dv (B, H, N, D) bf16 views.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, View vdk, View vdv, int B, int N,
                      int H, float scale_log2, float scale) {
  using S = DkvSmem<D>;
  constexpr int Q_TILE = S::Q_TILE;
  constexpr bool SS = DkvCfg<D>::SS;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full = sb + S::BAR, empty = full + 8 * STAGES;
  const uint32_t full_kv = empty + 8 * STAGES;
  const uint32_t empty_kv = full_kv + 8 * CONSUMERS;
  const int nx = (N + BLOCK - 1) / BLOCK, items = nx * H * B;
  const int ntiles = (N + Q_TILE - 1) / Q_TILE;
  float2* const stage_lse = reinterpret_cast<float2*>(smem + S::LSE);
  float2* const stage_delta = reinterpret_cast<float2*>(smem + S::DELTA);

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 32);               // the producer warp's lanes
      mbar_init(empty + 8 * s, CONSUMERS * 4);   // lane 0 of each warp
    }
    for (int c = 0; c < CONSUMERS; ++c) mbar_init(full_kv + 8 * c, 1);
    mbar_init(empty_kv, CONSUMERS * WG);         // every consumer thread
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // ---- producer: its first warp loads each item's k and v once the
    // consumers are done with the last item's (in registers, or with SS
    // once its last score products are done), and keeps the ring full
    // across items; lane 0 issues the TMA loads, the first Q_TILE / 2 lanes
    // store lse and delta of two query rows of each stage
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        tma_prefetch(&tm_q);
        tma_prefetch(&tm_k);
        tma_prefetch(&tm_v);
        tma_prefetch(&tm_do);
      }
      int u = 0;  // query tiles loaded so far: the ring's position
      for (int item = blockIdx.x, it = 0; item < items;
           item += gridDim.x, ++it) {
        const Item w(item, nx, H);
        const size_t bhn = ((size_t)w.b * H + w.h) * N;
        if (lane == 0) {
          mbar_wait(empty_kv, (it & 1) ^ 1);
          for (int c = 0; c < CONSUMERS; ++c) {
            const int k0 = w.x * BLOCK + c * ROWS;
            mbar_arrive_expect_tx(full_kv + 8 * c, 2 * S::ROW_TILE);
            load_rows<D, ROWS>(sb + S::K + c * S::ROW_TILE, &tm_k,
                               full_kv + 8 * c, k0, w.h, w.b);
            load_rows<D, ROWS>(sb + S::V + c * S::ROW_TILE, &tm_v,
                               full_kv + 8 * c, k0, w.h, w.b);
          }
        }
        for (int t = 0; t < ntiles; ++t, ++u) {
          const int s = u % STAGES;
          const int n = t * Q_TILE + 2 * lane;
          // lse / scale, +inf past N so that p = 0 there
          const float la = n < N ? lse[bhn + n] / scale : INFINITY;
          const float lb = n + 1 < N ? lse[bhn + n + 1] / scale : INFINITY;
          const float da = n < N ? delta[bhn + n] : 0.f;
          const float db = n + 1 < N ? delta[bhn + n + 1] : 0.f;
          mbar_wait(empty + 8 * s, ((u / STAGES) & 1) ^ 1);
          if (lane < Q_TILE / 2) {
            stage_lse[s * Q_TILE / 2 + lane] = make_float2(la, lb);
            stage_delta[s * Q_TILE / 2 + lane] = make_float2(da, db);
          }
          if (lane == 0) {
            mbar_arrive_expect_tx(full + 8 * s, 2 * S::QT_TILE);
            load_rows<D, Q_TILE>(sb + S::Q + s * S::QT_TILE, &tm_q,
                                 full + 8 * s, t * Q_TILE, w.h, w.b);
            load_rows<D, Q_TILE>(sb + S::DO + s * S::QT_TILE, &tm_do,
                                 full + 8 * s, t * Q_TILE, w.h, w.b);
          } else {
            mbar_arrive(full + 8 * s);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 key rows each of every item
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    float s[Q_TILE / 2];        // S^T (keys x queries), then p^T
    float dp[Q_TILE / 2];       // dP^T, then ds^T
    uint32_t pk[Q_TILE / 4];    // bf16 p^T: the A fragments of dV's steps
    uint32_t dsk[Q_TILE / 4];   // bf16 ds^T: the A fragments of dK's steps
    // k and v: S^T's, dP^T's A fragments (D <= 64; SS reads the tiles)
    uint32_t kf[SS ? 1 : D / 16][4], vf[SS ? 1 : D / 16][4];
    float adk[D / 2], adv[D / 2];
    int u = 0;                  // query tiles consumed before this item

    // issue S^T = k q^T - lse / scale and dP^T = v dO^T - delta of query
    // tile t: the products accumulate onto their columns' lse and delta,
    // which this thread's columns 8j + 2t4, 8j + 2t4 + 1 take from float2
    // 4j + t4 of the stage. So the exp2 needs no lse, and no register holds
    // them beside the accumulators.
    auto issue_scores = [&](int t) {
      const int st = (u + t) % STAGES;
      mbar_wait(full + 8 * st, ((u + t) / STAGES) & 1);
      const float2* sl = stage_lse + st * Q_TILE / 2;
      const float2* sd = stage_delta + st * Q_TILE / 2;
#pragma unroll
      for (int j = 0; j < Q_TILE / 8; ++j) {
        const float2 l = sl[4 * j + t4], d = sd[4 * j + t4];
        s[4 * j] = s[4 * j + 2] = -l.x;
        s[4 * j + 1] = s[4 * j + 3] = -l.y;
        dp[4 * j] = dp[4 * j + 2] = -d.x;
        dp[4 * j + 1] = dp[4 * j + 3] = -d.y;
      }
      const uint32_t qb = sb + S::Q + st * S::QT_TILE;
      const uint32_t db = sb + S::DO + st * S::QT_TILE;
      wgmma_fence();
      if constexpr (SS) {
        const uint32_t kb = sb + S::K + c * S::ROW_TILE;
        const uint32_t vb = sb + S::V + c * S::ROW_TILE;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<Q_TILE>(s, desc_k_major<D>(kb, ROWS, kk),
                           desc_k_major<D>(qb, Q_TILE, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<Q_TILE>(dp, desc_k_major<D>(vb, ROWS, kk),
                           desc_k_major<D>(db, Q_TILE, kk), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_rs_kmajor<Q_TILE>(s, kf[kk], desc_k_major<D>(qb, Q_TILE, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_rs_kmajor<Q_TILE>(dp, vf[kk], desc_k_major<D>(db, Q_TILE, kk), 1);
      }
      wgmma_commit();
    };
    // issue adv += bf16(p^T) dO and adk += bf16(ds^T) q of query tile t
    auto issue_dkv = [&](int t) {
      const int st = (u + t) % STAGES;
      const uint32_t qb = sb + S::Q + st * S::QT_TILE;
      const uint32_t db = sb + S::DO + st * S::QT_TILE;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q_TILE / 16; ++kk) {
        const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                               pk[4 * kk + 3]};
        wgmma_rs<D>(adv, a, desc_mn_major<D>(db, Q_TILE, kk), 1);
      }
#pragma unroll
      for (int kk = 0; kk < Q_TILE / 16; ++kk) {
        const uint32_t a[4] = {dsk[4 * kk], dsk[4 * kk + 1], dsk[4 * kk + 2],
                               dsk[4 * kk + 3]};
        wgmma_rs<D>(adk, a, desc_mn_major<D>(qb, Q_TILE, kk), 1);
      }
      wgmma_commit();
    };
    // this warp is done with query tile t's stage
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(empty + 8 * ((u + t) % STAGES));
    };
    // s, dp -> p^T = exp2(s * scale * log2(e)), ds^T = p^T dp in place
    auto grads = [&]() {
#pragma unroll
      for (int i = 0; i < Q_TILE / 2; ++i) {
        s[i] = fast_exp2(s[i] * scale_log2);
        dp[i] *= s[i];
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < Q_TILE / 4; ++i) {
        pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
        dsk[i] = pack_bf16(dp[2 * i], dp[2 * i + 1]);
      }
    };

    // Within a consumer, a tile's gradient products are issued with the
    // next tile's score products and all are waited for together: with the
    // arithmetic of one tile run beside the gradient products of the one
    // before (as K6a does), S^T, dP^T, dK, dV and both packed operands are
    // live at once, and ptxas spilled 200 bytes of them at D = 64, which
    // made it half as slow again as this loop (PERF.md). The ping-pong
    // still runs one consumer's arithmetic beside the other's products.
    const PingPong turn(c);
    for (int item = blockIdx.x, it = 0; item < items;
         item += gridDim.x, ++it) {
      const Item w(item, nx, H);
      mbar_wait(full_kv + 8 * c, it & 1);  // this item's k and v
      if constexpr (!SS) {
        load_a_rows<D>(kf, smem + S::K + c * S::ROW_TILE, warp, lane);
        load_a_rows<D>(vf, smem + S::V + c * S::ROW_TILE, warp, lane);
        mbar_arrive(empty_kv);  // in registers: the next item's may land
      }
#pragma unroll
      for (int i = 0; i < D / 2; ++i) adk[i] = adv[i] = 0.f;

      turn.take();
      issue_scores(0);
      turn.hand_over();
      wgmma_wait<0>();
      reg_fence(s);
      reg_fence(dp);
      // SS: the item's last score products have read k and v
      if (SS && ntiles == 1) mbar_arrive(empty_kv);
      grads();
      pack();
      for (int t = 1; t < ntiles; ++t) {
        turn.take();
        issue_scores(t);   // S^T, dP^T of tile t ...
        issue_dkv(t - 1);  // ... and dV, dK of tile t-1 on the tensor cores
        turn.hand_over();
        wgmma_wait<0>();
        reg_fence(s);
        reg_fence(dp);
        reg_fence(adk);
        reg_fence(adv);
        reg_fence(pk);
        reg_fence(dsk);
        release(t - 1);
        if (SS && t == ntiles - 1) mbar_arrive(empty_kv);
        grads();  // while the other consumer's products run
        pack();
      }
      turn.take();
      issue_dkv(ntiles - 1);
      // consumer 1 does not hand over after the block's very last turn
      if (c == 0 || item + (int)gridDim.x < items) turn.hand_over();
      wgmma_wait<0>();
      reg_fence(adk);
      reg_fence(adv);
      reg_fence(pk);
      reg_fence(dsk);
      release(ntiles - 1);

      const int r0 = w.x * BLOCK + c * ROWS + warp * 16 + g;
      store_rows<D>(dk + w.b * vdk.b + w.h * vdk.h, vdk.n, adk, scale, r0, N,
                    t4);
      store_rows<D>(dv + w.b * vdv.b + w.h * vdv.h, vdv.n, adv, 1.f, r0, N,
                    t4);
      u += ntiles;
    }
  }
}

// ---- host side ----------------------------------------------------------

// The kernel's dynamic shared memory, opted into before anything else: a
// runtime call, it makes the device's primary context current on this
// thread, which the tensor maps' encode (a driver call) needs. Autograd
// runs the backward on a thread of its own, where this may be the first
// CUDA call (the encode then failed with CUDA_ERROR_INVALID_CONTEXT, 201).
template <typename Kernel>
int opt_in_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// One persistent block per SM of the current device, or one per work item
// where there are fewer; a cudaError_t.
int persistent_blocks(int* blocks, int B, int H, int N) {
  int dev = 0, sms = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)((N + BLOCK - 1) / BLOCK) * H * B;
  *blocks = (int)(items < sms ? items : sms);
  return e;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              const long long* st, int B, int H, int N, float scale,
              cudaStream_t stream) {
  auto kernel = flash_dq_sm90_kernel<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = opt_in_smem(kernel, DqSmem<D>::BYTES);
  if (e == 0) e = encode_view<D, ROWS>(&tm_q, q, view_at(st, 0), B, H, N);
  constexpr int KT = DqSmem<D>::KEY_TILE;
  if (e == 0) e = encode_view<D, KT>(&tm_k, k, view_at(st, 1), B, H, N);
  if (e == 0) e = encode_view<D, KT>(&tm_v, v, view_at(st, 2), B, H, N);
  if (e == 0) e = encode_view<D, ROWS>(&tm_do, dout, view_at(st, 4), B, H, N);
  if (e != 0) return e;
  dim3 grid((N + BLOCK - 1) / BLOCK, H, B);
  kernel<<<grid, THREADS, DqSmem<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), view_at(st, 3),
      view_at(st, 4), view_at(st, 5), N, H, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int N, float scale,
               cudaStream_t stream) {
  auto kernel = flash_dkv_sm90_kernel<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int blocks = 0;
  int e = opt_in_smem(kernel, DkvSmem<D>::BYTES);
  constexpr int QT = DkvCfg<D>::Q_TILE;
  if (e == 0) e = encode_view<D, QT>(&tm_q, q, view_at(st, 0), B, H, N);
  if (e == 0) e = encode_view<D, ROWS>(&tm_k, k, view_at(st, 1), B, H, N);
  if (e == 0) e = encode_view<D, ROWS>(&tm_v, v, view_at(st, 2), B, H, N);
  if (e == 0) e = encode_view<D, QT>(&tm_do, dout, view_at(st, 3), B, H, N);
  if (e == 0) e = persistent_blocks(&blocks, B, H, N);
  if (e != 0) return e;
  kernel<<<blocks, THREADS, DkvSmem<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), view_at(st, 4), view_at(st, 5), B, N, H,
      scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor argument but lse and delta is a (B, H, N, D) bf16 view with
// the head dim contiguous, 16-byte aligned start and (b, h, n) strides, the
// element strides in `strides`, three per tensor in argument order. lse,
// delta: (B, H, N) fp32, contiguous. Each function returns 0, or the first
// error: a cudaError_t of a launch or the CUresult of a tensor-map encode.

// K6a: dq and delta = rowsum(dO * o) (strides of q, k, v, o, dout, dq).
extern "C" int sd3_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq,
                                      const long long* strides, int B, int H,
                                      int N, int D, float scale,
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

// K6b: dk, dv, after K6a wrote delta (strides of q, k, v, dout, dk, dv).
extern "C" int sd3_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B, int H,
                                       int N, int D, float scale,
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
