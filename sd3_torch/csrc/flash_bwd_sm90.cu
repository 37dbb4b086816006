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
// one sample (K6b at D = 256: 64 rows, see "D = 256" below; past 256 both
// 64 rows, see "D = 384 and 512"). K6a launches a block per item, grid
// (ceil(N / 128), H, B).
// q, o, dO, dq, lse and delta have N query rows, k, v, dk and dv M key rows
// of their own (kv_merge_attn halves them): K6a's key tiles run to M and its
// ragged last one is masked at M; K6b's items are 128 of the M key rows,
// its query tiles run to N.
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
//   for D = 16, 32, 64 and as two or four 128-byte atom columns for D =
//   128, 256 (SwizzledRows, sm90.cuh). TMA zero-fills rows past N.
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
//   arithmetic runs while the other's products do. Within a K6a consumer
//   (up to D = 128), the score products of tile t are issued together with
//   dQ of tile t-1, and the p / ds arithmetic of tile t runs while the
//   tensor cores do dQ; the wait for dQ sits behind a branch on the
//   arithmetic's results, since ptxas hoists a wait to the top of its
//   basic block (as K7's SASS showed). K6b waits for all its products
//   before its arithmetic (see its loop).
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
// D = 256 (bf16 heads of 129-256, padded): a 64 x 256 fp32 accumulator is
// 128 registers of a consumer thread, one wgmma m64n256k16 a k-step.
// - K6a keeps its layout with 32-key tiles: q and dO of the block's 128
//   rows take 128 KB, three stages of 16 KB k and v tiles 96 KB. dQ (128),
//   S, dP (16 each) and the packed ds (8) fit, but not beside dQ of the
//   tile before in flight: with K6a's overlap ptxas spilled 128 bytes,
//   0.275 ms at (B 4, H 5, N 1178); so each tile's scores and the dQ of the
//   tile before are issued together and waited for together, the
//   arithmetic beside the other consumer's products alone: no spill, 0.130
//   ms (times of copies of this source with one change each, on one H100
//   80GB HBM3 at 700 W; PERF.md). The descriptors of q's and dO's 32
//   k-steps are one each plus constant offsets made opaque to the loop
//   (k_step_offset).
// - K6b splits by gradient: dK and dV of 64 key rows take 256 registers, so
//   both consumers take the same 64 key rows (an item; 4 x 5 x 19 = 380 at
//   the shape above, 2.9 a persistent block). Consumer 0 holds k, takes
//   S^T = k q^T and p^T, and sums dV += bf16(p^T) dO; consumer 1 holds v,
//   takes dP^T = v dO^T, reads consumer 0's unrounded fp32 p^T from shared
//   memory into ds^T = p^T (dP^T - delta), and sums dK += bf16(ds^T) q: the
//   four products once each, the least there is. Each consumer holds 128 +
//   32 + 16 registers at 64-query tiles. The hand-over is a 64 x 64 fp32
//   tile (16 KB) in two buffers under full / empty mbarriers, laid out by
//   thread (both warpgroups share the accumulator layout, so each thread
//   reads what its counterpart wrote: float4s, a warp's 512 bytes
//   contiguous); consumer 0 can run two tiles ahead. Shared memory: k and v
//   64 KB, two stages of 64-row q and dO 128 KB, the hand-over 32 KB: 226
//   KB of 227. Each consumer issues a tile's score product with the
//   gradient product of the tile before and waits for both (the loop of D
//   <= 128): with the arithmetic beside the gradient product, ptxas spilled
//   468 bytes, 0.319 against 0.154 ms; 32-query tiles in four stages took
//   0.176 ms, and 24 / 240 registers for the producer / each consumer
//   0.159 ms with a 52-byte spill in K6b (the same copies; K6a 0.130 with
//   them). Splitting by columns instead (each consumer 128 columns of dK
//   and dV) would take S^T and dP^T in both, six products for four.
// Bound at (B 4, H 5, N 1178, D 256): K6a 42.6 G FLOP, 0.0431 ms; K6b 56.8
// G FLOP, 0.0575 ms. K6a's score products are SS m64n32k16, whose A and B
// (3 KB a k-step) take 24 cycles of shared-memory bandwidth against 16 of
// tensor work: 1.17x over the tensor bound before anything else; 200
// blocks on 132 SMs run in two waves, the second 52% full, and take 2.1x
// the time of 100 (one wave): equal items leave the second wave's idle
// SMs to any schedule, persistent or not.
//
// D = 384 and 512 (bf16 heads of 257-512, padded; SLICED): a 64 x D fp32
// accumulator would be 192 / 256 registers of a consumer thread, past its
// 232, so neither dQ nor dK nor dV of 64 rows fits in one consumer. Each
// is cut into two column slices of DV = D / 2 (96 / 128 registers, one
// wgmma m64n192k16 / m64n256k16 a k-step), as the forwards past 256 cut
// their output (attention_sm90.cu), and the score products, which need
// the whole head, are shared as D = 256's K6b shares p^T:
// - K6a: a block is 64 query rows, which both consumers take. Consumer 0
//   takes S = q k^T and p, consumer 1 dP = dO v^T; each writes its fp32
//   tile for the other (laid out by thread as K6b's hand-over), and both
//   take ds = p (dP - delta) from the same bits in the same fp32
//   operations, so their bf16 ds are the same; consumer c sums dQ[:, c DV
//   ..) += bf16(ds) k[:, the same columns]. The three products once each,
//   the least there is (S and dP in both would be five). delta is computed
//   by both from o and dO (the same bits), written by consumer 0. The
//   exchange is written into the key tile's v stage, free once both
//   consumers' scores are done (a named barrier before the writes, one
//   after), so it takes no buffer of its own, and the v stage is released
//   after the reads; that leaves room for three k stages beside two of v,
//   so the loop of D <= 128 runs: tile t's scores with dQ of tile t-1, the
//   exchange beside that dQ, tile t-1's k stage released once it is done.
//   Shared memory: q and dO of the 64 rows (96 / 128 KB), 32-key k and v
//   tiles at 384 (24 KB; 16-key at 512, 16 KB: 32 would leave room for
//   one v stage), 217 / 209 KB.
// - K6b: D = 256's split by gradient, each work item also one of two
//   column slices (a grid dimension: items (slice, 64 key rows, h, b),
//   slice fastest, so the two slices of a row block run side by side on
//   the same q / dO stream in L2). Each item recomputes S^T and dP^T over
//   the whole head: six products for the least four, 1.5x the bound's
//   FLOP. Shared memory: k and v (96 / 128 KB), two stages of 32-query
//   (384) or 16-query (512) q and dO tiles, the p^T hand-over: 209 / 201
//   KB. With two stages, a stage released after the next tile's scores
//   (D = 256's loop) leaves that tile's TMA load in the open, so past 256
//   the gradient product of tile t-1 is issued ahead of the scores of t
//   and waited for first (EARLY), and its stage released while the scores
//   run.
// Bound at (B 4, H 3, N 1178, D 384): K6a 38.4 G FLOP, 0.0388 ms; K6b
// 51.2 G FLOP, 0.0517 ms (the design's six products 0.0776). At (B 4, H 2,
// N 1178, D 512): 34.1 / 45.5 G FLOP, 0.0345 / 0.0460 ms (0.0690). Waves:
// K6a's 228 blocks of 64 rows at 384 fill 1.73 waves of 132 SMs, its 152
// at 512 1.15 (the second 15% full); K6b's 456 / 304 items are 3.45 / 2.30
// a persistent block. ptxas: 168 registers at launch (232 a consumer
// after setmaxnreg), no spill in any of the four instances. On one H100
// 80GB HBM3 at 700 W (utils/flash_bwd_diag.py, PERF.md): K6a 0.134 /
// 0.228 ms and K6b 0.271 / 0.426 at the shapes above, 27x / 21x and 9x /
// 7x the K6AW / K6BW of attention_fp32.cu they replace. Where a tile's
// time goes (an instrumented copy of this source, clock64() around each
// step of the loops; not kept): the score products' small SS wgmmas (each
// reads its 2 KB A tile from shared memory a k-step: 16-key or 16-query
// tiles took about as long a tile as 32, so 32 where it fits), in K6a the
// exchange (~700 cycles of ~2300 a tile at 384, beside dQ of the tile
// before), in K6b the wait for its q / dO stage (~1000 of ~3000: its
// items stream q and dO of a head through L2 once a slice). Tried and
// not kept (copies of this source with one change each, timed in turns
// with it): K6a's exchange after dQ of the tile before, not beside it
// (0.1451 against 0.1377 ms at 384); the score k-steps in two or four
// independent accumulators (2-6% faster in K6a's first loop, no faster or
// spilling in the kept one, slower in K6b); the two slice blocks of a K6b
// item as a cluster of two loading each tile once, TMA multicast to both
// (0.327 against 0.266 ms at 384, 24-byte spills).

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
constexpr int WG = 128;                    // threads per warpgroup
constexpr int THREADS = WG * (1 + CONSUMERS);
// named barriers (0 is __syncthreads): TURN + c, consumer c's turn to issue
// its products; EXCH, K6a's exchange of p and dP past D = 256
constexpr int TURN = 1;
constexpr int EXCH = TURN + CONSUMERS;
// 384 threads x 168 registers at launch; the producer keeps 40 (K6b's
// producer warp loads lse and delta as well as issuing TMA), so each
// consumer thread can have 232
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr float LOG2E = 1.4426950408889634f;

// Shared memory of flash_dq_sm90_kernel<D>, from a 1024-byte aligned base.
// K6a's key tile: 64 keys; 32 at D = 128, where dQ's 64 accumulators beside
// S, dP and the packed ds of 64 keys spilled (40 bytes), at D = 256 and at
// 384; 16 at 512. Four ring stages; three at D = 256, where q and dO take
// 128 KB. SLICED (D = 384, 512): an item is 64 query rows, which both
// consumers take, each summing one of two column slices of dQ, with one q
// and one dO tile; three k stages, two v stages, and the fp32 tiles the
// consumers exchange written into the v stage of their key tile once its
// dP is done (see "D = 384 and 512" above).
template <int D>
struct DqSmem {
  static constexpr bool SLICED = D > 256;
  static constexpr int KEY_TILE = D == 512 ? 16 : D >= 128 ? 32 : 64;
  static constexpr int STAGES = SLICED ? 2 : D == 256 ? 3 : 4;  // of v
  static constexpr int K_STAGES = SLICED ? 3 : STAGES;           // of k
  // the arithmetic of key tile t beside dQ of tile t-1 (see the loop); not
  // at D = 256, where dQ's 128 accumulators beside it spilled
  static constexpr bool OVERLAP = D != 256;
  static constexpr int ITEM = SLICED ? ROWS : BLOCK;  // query rows per block
  static constexpr int DV = SLICED ? D / 2 : D;     // dQ columns a consumer sums
  static constexpr int ROW_TILE = ROWS * D * 2;     // 64 rows of q or dO
  static constexpr int KV_TILE = KEY_TILE * D * 2;  // one k or v tile
  static constexpr int Q_TILES = SLICED ? 1 : CONSUMERS;  // q, dO tiles held
  static constexpr int Q = 0;                       // [Q_TILES] q tiles
  static constexpr int DO = Q + Q_TILES * ROW_TILE;     // [Q_TILES] dO
  static constexpr int K = DO + Q_TILES * ROW_TILE;     // [K_STAGES] k
  static constexpr int V = K + K_STAGES * KV_TILE;      // [STAGES] v tiles
  // SLICED: a consumer's fp32 p (0) or dP (1) of a key tile, for the
  // other, at c X_TILE in the tile's v stage
  static constexpr int X_TILE = SLICED ? ROWS * KEY_TILE * 4 : 0;
  static_assert(CONSUMERS * X_TILE <= KV_TILE, "the exchange in a v stage");
  // mbarriers: full of each K and V stage, empty of each, full of each
  // consumer's q and dO (SLICED: of the one q and dO)
  static constexpr int BAR = V + STAGES * KV_TILE;
  static constexpr int BYTES =
      BAR + (2 * K_STAGES + 2 * STAGES + CONSUMERS) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// K6b's layout. SPLIT (D >= 256): an item is 64 key rows, which both
// consumers take, split by gradient (see "D = 256" above); else 128,
// 64 a consumer. Its query tile, its ring stages, and whether its score
// products read k and v from shared memory (SS) rather than as register
// fragments (D <= 64). Past D = 256 an item is also one of SLICES column
// slices of DV columns of dK and dV (see "D = 384 and 512" above).
template <int D>
struct DkvCfg {
  static constexpr bool SPLIT = D >= 256;
  static constexpr bool SS = D >= 128;
  // queries per q / dO tile
  static constexpr int Q_TILE = D == 512 ? 16 : D == 128 || D == 384 ? 32 : 64;
  static constexpr int STAGES = SPLIT ? 2 : 4;
  static constexpr int ITEM = SPLIT ? ROWS : BLOCK;  // key rows per item
  static constexpr int DV = D > 256 ? D / 2 : D;     // columns per item
  static constexpr int SLICES = D / DV;
  // past D = 256: a tile's gradient products issued ahead of the next
  // tile's scores and waited for first, so that its stage is released
  // while the scores run (see the loop)
  static constexpr bool EARLY = SLICES > 1;
};

// Shared memory of flash_dkv_sm90_kernel<D>, from a 1024-byte aligned base.
template <int D>
struct DkvSmem {
  static constexpr bool SPLIT = DkvCfg<D>::SPLIT;
  static constexpr int Q_TILE = DkvCfg<D>::Q_TILE;
  static constexpr int STAGES = DkvCfg<D>::STAGES;
  static constexpr int ROW_TILE = ROWS * D * 2;     // 64 rows of k or v
  static constexpr int QT_TILE = Q_TILE * D * 2;    // one q or dO tile
  static constexpr int KV_TILES = SPLIT ? 1 : CONSUMERS;  // k, v tiles held
  static constexpr int K = 0;                       // [KV_TILES] k tiles
  static constexpr int V = K + KV_TILES * ROW_TILE;     // [KV_TILES] v
  static constexpr int Q = V + KV_TILES * ROW_TILE;     // [STAGES] q tiles
  static constexpr int DO = Q + STAGES * QT_TILE;       // [STAGES] dO tiles
  // SPLIT: consumer 0's fp32 p^T of a query tile, handed to consumer 1,
  // in two buffers
  static constexpr int P_TILE = SPLIT ? ROWS * Q_TILE * 4 : 0;
  static constexpr int P = DO + STAGES * QT_TILE;       // [2] p^T tiles
  static constexpr int LSE = P + 2 * P_TILE;            // [STAGES][Q_TILE]
  static constexpr int DELTA = LSE + STAGES * Q_TILE * 4;  // [STAGES][Q_TILE]
  // mbarriers: full / empty of each stage, full of each consumer's k and v
  // (SPLIT: of k, of v), empty of both; SPLIT: full / empty of each p^T
  // buffer
  static constexpr int BAR = DELTA + STAGES * Q_TILE * 4;
  static constexpr int BYTES =
      BAR + (2 * STAGES + CONSUMERS + 1 + (SPLIT ? 4 : 0)) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
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
                     int N, int M, int H, float scale_log2, float scale) {
  using S = DqSmem<D>;
  constexpr int KEY_TILE = S::KEY_TILE;
  constexpr int STAGES = S::STAGES;
  constexpr int KST = S::K_STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_k = sb + S::BAR, full_v = full_k + 8 * KST;
  const uint32_t empty_k = full_v + 8 * STAGES, empty_v = empty_k + 8 * KST;
  const uint32_t full_q = empty_v + 8 * STAGES;
  const int h = blockIdx.y, b = blockIdx.z, q0 = blockIdx.x * S::ITEM;
  const int ntiles = (M + KEY_TILE - 1) / KEY_TILE;

  if (threadIdx.x == 0) {
    for (int s = 0; s < KST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
    }
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_v + 8 * s, 1);
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
      for (int c = 0; c < S::Q_TILES; ++c) {
        mbar_arrive_expect_tx(full_q + 8 * c, 2 * S::ROW_TILE);
        load_rows<D, ROWS>(sb + S::Q + c * S::ROW_TILE, &tm_q, full_q + 8 * c,
                           q0 + c * ROWS, h, b);
        load_rows<D, ROWS>(sb + S::DO + c * S::ROW_TILE, &tm_do,
                           full_q + 8 * c, q0 + c * ROWS, h, b);
      }
      for (int t = 0; t < ntiles; ++t) {
        const int sk = t % KST, s = t % STAGES;
        mbar_wait(empty_k + 8 * sk, ((t / KST) & 1) ^ 1);
        mbar_arrive_expect_tx(full_k + 8 * sk, S::KV_TILE);
        load_rows<D, KEY_TILE>(sb + S::K + sk * S::KV_TILE, &tm_k,
                               full_k + 8 * sk, t * KEY_TILE, h, b);
        mbar_wait(empty_v + 8 * s, ((t / STAGES) & 1) ^ 1);
        mbar_arrive_expect_tx(full_v + 8 * s, S::KV_TILE);
        load_rows<D, KEY_TILE>(sb + S::V + s * S::KV_TILE, &tm_v,
                               full_v + 8 * s, t * KEY_TILE, h, b);
      }
    }
  } else if constexpr (S::SLICED) {
    // ---- consumers past D = 256: both on the block's 64 query rows.
    // Consumer 0 takes S = q k^T and p, consumer 1 dP = dO v^T; each hands
    // its fp32 tile to the other, both take ds = p (dP - delta) from the
    // same bits, and consumer c sums dQ[:, c DV .. (c + 1) DV) += bf16(ds)
    // k[:, the same columns]. The same code, on q / K for consumer 0 and
    // dO / V for consumer 1.
    constexpr int DV = S::DV;
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const int n0 = q0 + warp * 16 + g;
    const int n1 = n0 + 8;                   // this thread's two rows
    const size_t bhn = ((size_t)b * H + h) * N;

    // delta and lse of rows n0, n1, as below; both consumers take the same
    // bits, consumer 0 writes them
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
    if (t4 == 0 && c == 0) {
      if (n0 < N) delta[bhn + n0] = d0;
      if (n1 < N) delta[bhn + n1] = d1;
    }

    const uint32_t a_base = sb + (c == 0 ? S::Q : S::DO);  // A of S / dP
    float sc[KEY_TILE / 2];     // S then p (0), dP (1); then ds
    uint32_t ds[KEY_TILE / 4];  // bf16 ds: the A fragments of dQ's steps
    float acc[DV / 2];          // this consumer's columns of dq
#pragma unroll
    for (int i = 0; i < KEY_TILE / 2; ++i) sc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
    mbar_wait(full_q, 0);  // q and dO have landed

    // issue S = q k^T (0) or dP = dO v^T (1) of key tile t; q's / dO's
    // descriptor made opaque to the loop (k_step_offset)
    auto issue_scores = [&](int t) {
      const int sk = t % KST, sv = t % STAGES;
      mbar_wait(full_k + 8 * sk, (t / KST) & 1);
      mbar_wait(full_v + 8 * sv, (t / STAGES) & 1);
      uint64_t da = desc_k_major<D>(a_base, ROWS, 0);
      asm volatile("" : "+l"(da));
      const uint64_t db = desc_k_major<D>(
          c == 0 ? sb + S::K + sk * S::KV_TILE : sb + S::V + sv * S::KV_TILE,
          KEY_TILE, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<KEY_TILE>(sc, da + k_step_offset<D>(ROWS, kk),
                           db + k_step_offset<D>(KEY_TILE, kk), kk > 0);
      wgmma_commit();
    };
    // issue acc += bf16(ds) k[:, this consumer's columns] of key tile t
    // (c DV / 64 atom columns into the k tile)
    auto issue_dq = [&](int t) {
      const uint32_t kb = sb + S::K + (t % KST) * S::KV_TILE +
                          c * (DV / 64) * KEY_TILE * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KEY_TILE / 16; ++kk) {
        const uint32_t a[4] = {ds[4 * kk], ds[4 * kk + 1], ds[4 * kk + 2],
                               ds[4 * kk + 3]};
        wgmma_rs<DV>(acc, a, desc_mn_major<DV>(kb, KEY_TILE, kk), 1);
      }
      wgmma_commit();
    };
    // this warp is done with tile t's k or v stage
    auto release_k = [&](int t) {
      if (lane == 0) mbar_arrive(empty_k + 8 * (t % KST));
    };
    auto release_v = [&](int t) {
      if (lane == 0) mbar_arrive(empty_v + 8 * (t % STAGES));
    };
    // key tile t's ds in sc: consumer 0 takes p = exp2(s * scale * log2(e)
    // - lse * log2(e)) (padded keys to -inf first, as below); once both
    // consumers' scores are done (the first barrier) the tile's v stage is
    // free, and each writes its fp32 tile there at c X_TILE (thread tid's
    // float4 i, accumulators 4i .. 4i + 3, at i * WG + tid, as K6b's
    // hand-over lays out p^T); after the second each reads the other's and
    // takes ds = p (dp - delta), the same fp32 operations on the same
    // values in both. The v stage is released after the reads.
    auto exchange = [&](int t) {
      if (c == 0) {
        const int k0 = t * KEY_TILE;
        if (k0 + KEY_TILE > M) {
#pragma unroll
          for (int j = 0; j < KEY_TILE / 8; ++j) {
            const int col = k0 + j * 8 + t4 * 2;
            if (col >= M) sc[4 * j] = sc[4 * j + 2] = -INFINITY;
            if (col + 1 >= M) sc[4 * j + 1] = sc[4 * j + 3] = -INFINITY;
          }
        }
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
          sc[4 * j] = fast_exp2(sc[4 * j] * scale_log2 - L0);
          sc[4 * j + 1] = fast_exp2(sc[4 * j + 1] * scale_log2 - L0);
          sc[4 * j + 2] = fast_exp2(sc[4 * j + 2] * scale_log2 - L1);
          sc[4 * j + 3] = fast_exp2(sc[4 * j + 3] * scale_log2 - L1);
        }
      }
      unsigned char* const xb = smem + S::V + (t % STAGES) * S::KV_TILE;
      float4* const mine = reinterpret_cast<float4*>(xb + c * S::X_TILE) + tid;
      const float4* const theirs =
          reinterpret_cast<const float4*>(xb + (1 - c) * S::X_TILE) + tid;
      named_bar_sync(EXCH, 2 * WG);  // both consumers' scores of tile t done
#pragma unroll
      for (int i = 0; i < KEY_TILE / 8; ++i)
        mine[i * WG] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                   sc[4 * i + 3]);
      // the stage goes back to TMA (the async proxy) after the reads: order
      // these generic-proxy writes before its next load into the same bytes
      fence_proxy_async_shared();
      named_bar_sync(EXCH, 2 * WG);
#pragma unroll
      for (int i = 0; i < KEY_TILE / 8; ++i) {
        const float4 x = theirs[i * WG];
        const float o4[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = c == 0 ? sc[4 * i + e] : o4[e];
          const float dp = c == 0 ? o4[e] : sc[4 * i + e];
          sc[4 * i + e] = p * (dp - (e < 2 ? d0 : d1));
        }
      }
      release_v(t);
    };
    auto pack_ds = [&]() {
#pragma unroll
      for (int i = 0; i < KEY_TILE / 4; ++i)
        ds[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };

    // Both consumers arrive on K's and V's empty barriers (consumer 0 reads
    // no V, but both write the exchange there).
    issue_scores(0);
    wgmma_wait<0>();
    reg_fence(sc);
    exchange(0);
    pack_ds();
    for (int t = 1; t < ntiles; ++t) {
      // the loop of D <= 128: the exchange of tile t beside dQ of tile t-1
      // on the tensor cores; the k stage of tile t-1 is free once that dQ
      // is done, so with three k stages the producer loads tile t+2's k
      // beside the next tile
      issue_scores(t);  // S or dP of tile t ...
      issue_dq(t - 1);  // ... and dQ of tile t-1
      wgmma_wait<1>();  // S or dP of tile t done
      reg_fence(sc);
      exchange(t);      // while dQ of tile t-1 runs
      wait_all_after(sc[KEY_TILE / 2 - 1]);
      reg_fence(acc);
      reg_fence(ds);
      release_k(t - 1);
      pack_ds();
    }
    issue_dq(ntiles - 1);
    wgmma_wait<0>();
    reg_fence(acc);
    reg_fence(ds);
    release_k(ntiles - 1);

    store_rows<DV>(dq + b * vdq.b + h * vdq.h + c * DV, vdq.n, acc, scale,
                   n0, N, t4);
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
      if constexpr (D == 256) {
        // k-step 0's descriptors plus each k-step's offset, q's and dO's
        // made opaque to the loop (k_step_offset, sm90.cuh): their 32
        // descriptors would otherwise stay in registers across it. D <= 128
        // keeps a descriptor a k-step: there the opaque form spills
        // nothing either, but it changes the SASS of all four instances,
        // whose times PERF.md holds for this code
        uint64_t dq0 = desc_k_major<D>(q_base, ROWS, 0);
        uint64_t do0 = desc_k_major<D>(do_base, ROWS, 0);
        asm volatile("" : "+l"(dq0), "+l"(do0));
        const uint64_t dk0 = desc_k_major<D>(kb, KEY_TILE, 0);
        const uint64_t dv0 = desc_k_major<D>(vb, KEY_TILE, 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<KEY_TILE>(s, dq0 + k_step_offset<D>(ROWS, kk),
                             dk0 + k_step_offset<D>(KEY_TILE, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<KEY_TILE>(dp, do0 + k_step_offset<D>(ROWS, kk),
                             dv0 + k_step_offset<D>(KEY_TILE, kk), kk > 0);
      } else {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<KEY_TILE>(s, desc_k_major<D>(q_base, ROWS, kk),
                             desc_k_major<D>(kb, KEY_TILE, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss<KEY_TILE>(dp, desc_k_major<D>(do_base, ROWS, kk),
                             desc_k_major<D>(vb, KEY_TILE, kk), kk > 0);
      }
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
      if (k0 + KEY_TILE > M) {
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
          const int col = k0 + j * 8 + t4 * 2;
          if (col >= M) s[4 * j] = s[4 * j + 2] = -INFINITY;
          if (col + 1 >= M) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
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
      if constexpr (S::OVERLAP) {
        wgmma_wait<1>();  // S, dP of tile t done
        reg_fence(s);
        reg_fence(dp);
        release(empty_v, t);
        grads(t);  // while dQ of tile t-1 and the other's products run
        wait_all_after(dp[KEY_TILE / 2 - 1]);
        reg_fence(acc);
        reg_fence(ds);
        release(empty_k, t - 1);
      } else {
        wgmma_wait<0>();  // S, dP of tile t and dQ of tile t-1 done
        reg_fence(s);
        reg_fence(dp);
        reg_fence(acc);
        reg_fence(ds);
        release(empty_v, t);
        release(empty_k, t - 1);
        grads(t);  // while the other's products run
      }
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

// grid min(SMs, ceil(M / ITEM) * H * B) persistent blocks, THREADS threads,
// DkvSmem<D>::BYTES of dynamic shared memory. tm_q, tm_k, tm_v, tm_do:
// tensor maps of q, k, v, dO (see encode_view); lse, delta (B*H, N) fp32;
// dk, dv (B, H, M, D) bf16 views.
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, bf16* __restrict__ dk,
                      bf16* __restrict__ dv, View vdk, View vdv, int B, int N,
                      int M, int H, float scale_log2, float scale) {
  using S = DkvSmem<D>;
  constexpr int Q_TILE = S::Q_TILE;
  constexpr int STAGES = S::STAGES;
  constexpr int ITEM = DkvCfg<D>::ITEM;
  constexpr bool SS = DkvCfg<D>::SS;
  constexpr bool SPLIT = DkvCfg<D>::SPLIT;
  constexpr int SLICES = DkvCfg<D>::SLICES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full = sb + S::BAR, empty = full + 8 * STAGES;
  const uint32_t full_kv = empty + 8 * STAGES;
  const uint32_t empty_kv = full_kv + 8 * CONSUMERS;
  const uint32_t full_p = empty_kv + 8, empty_p = full_p + 16;  // SPLIT
  // items: (column slice, row block x, head h, sample b), slice fastest
  const int nx = (M + ITEM - 1) / ITEM, items = nx * H * B * SLICES;
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
    if constexpr (SPLIT) {
      for (int i = 0; i < 2; ++i) {
        mbar_init(full_p + 8 * i, WG);           // consumer 0's threads
        mbar_init(empty_p + 8 * i, WG);          // consumer 1's threads
      }
    }
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
        const Item w(item / SLICES, nx, H);
        const size_t bhn = ((size_t)w.b * H + w.h) * N;
        if (lane == 0) {
          mbar_wait(empty_kv, (it & 1) ^ 1);
          if constexpr (SPLIT) {
            // the item's 64 rows: k for consumer 0, v for consumer 1
            mbar_arrive_expect_tx(full_kv, S::ROW_TILE);
            load_rows<D, ROWS>(sb + S::K, &tm_k, full_kv, w.x * ITEM, w.h,
                               w.b);
            mbar_arrive_expect_tx(full_kv + 8, S::ROW_TILE);
            load_rows<D, ROWS>(sb + S::V, &tm_v, full_kv + 8, w.x * ITEM,
                               w.h, w.b);
          } else {
            for (int c = 0; c < CONSUMERS; ++c) {
              const int k0 = w.x * BLOCK + c * ROWS;
              mbar_arrive_expect_tx(full_kv + 8 * c, 2 * S::ROW_TILE);
              load_rows<D, ROWS>(sb + S::K + c * S::ROW_TILE, &tm_k,
                                 full_kv + 8 * c, k0, w.h, w.b);
              load_rows<D, ROWS>(sb + S::V + c * S::ROW_TILE, &tm_v,
                                 full_kv + 8 * c, k0, w.h, w.b);
            }
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
  } else if constexpr (SPLIT) {
    // ---- consumers, split by gradient: both on the item's 64 key rows.
    // Consumer 0 takes S^T = k q^T, p^T and dV += bf16(p^T) dO; consumer 1
    // dP^T = v dO^T, ds^T = p^T dP^T from consumer 0's fp32 p^T, and dK +=
    // bf16(ds^T) q. The same code, on k / q / dO / lse for consumer 0 and
    // v / dO / q / delta for consumer 1. Past D = 256 the gradient
    // products and the stores take the item's slice of DV columns.
    constexpr int DV = DkvCfg<D>::DV;
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const uint32_t held = sb + (c == 0 ? S::K : S::V);  // the A of S^T / dP^T
    const int a_off = c == 0 ? S::Q : S::DO;   // B of S^T / dP^T, per stage
    const int g_off = c == 0 ? S::DO : S::Q;   // B of dV / dK, per stage
    const float2* const stats = c == 0 ? stage_lse : stage_delta;
    float4* const hand = reinterpret_cast<float4*>(smem + S::P) + tid;
    float sc[Q_TILE / 2];       // S^T then p^T (0); dP^T then ds^T (1)
    uint32_t pk[Q_TILE / 4];    // bf16 p^T / ds^T: the A fragments of dV / dK
    float acc[DV / 2];          // dV (0) or dK (1)
    int u = 0;                  // query tiles consumed before this item
    int slice = 0;              // the item's column slice

    // issue S^T = k q^T - lse / scale or dP^T = v dO^T - delta of query
    // tile t (the stage's statistics read as in the issue_scores of D <=
    // 128 below); k's / v's descriptor made opaque to the loop
    // (k_step_offset)
    auto issue_scores = [&](int t) {
      const int st = (u + t) % STAGES;
      mbar_wait(full + 8 * st, ((u + t) / STAGES) & 1);
      const float2* sl = stats + st * Q_TILE / 2;
#pragma unroll
      for (int j = 0; j < Q_TILE / 8; ++j) {
        const float2 l = sl[4 * j + t4];
        sc[4 * j] = sc[4 * j + 2] = -l.x;
        sc[4 * j + 1] = sc[4 * j + 3] = -l.y;
      }
      uint64_t da = desc_k_major<D>(held, ROWS, 0);
      asm volatile("" : "+l"(da));
      const uint64_t db =
          desc_k_major<D>(sb + a_off + st * S::QT_TILE, Q_TILE, 0);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss<Q_TILE>(sc, da + k_step_offset<D>(ROWS, kk),
                         db + k_step_offset<D>(Q_TILE, kk), 1);
      wgmma_commit();
    };
    // issue acc += bf16(p^T) dO or bf16(ds^T) q of query tile t (past D =
    // 256 the slice's DV / 64 atom columns of dO or q)
    auto issue_grad = [&](int t) {
      const uint32_t bb = sb + g_off + ((u + t) % STAGES) * S::QT_TILE +
                          slice * (DV / 64) * Q_TILE * 128;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < Q_TILE / 16; ++kk) {
        const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                               pk[4 * kk + 3]};
        wgmma_rs<DV>(acc, a, desc_mn_major<DV>(bb, Q_TILE, kk), 1);
      }
      wgmma_commit();
    };
    // this warp is done with query tile t's stage
    auto release = [&](int t) {
      if (lane == 0) mbar_arrive(empty + 8 * ((u + t) % STAGES));
    };
    // query tile t's p^T, through buffer (u + t) % 2: consumer 0 takes p^T
    // = exp2(s * scale * log2(e)) in place and writes it there, consumer 1
    // reads it into ds^T = p^T dP^T. Both warpgroups hold their tiles in
    // the same accumulator layout, so a thread reads what the same thread
    // of the other wrote: its float4 i (accumulators 4i .. 4i + 3) at
    // i * WG + tid, a warp's 32 float4s contiguous, no bank conflict.
    auto hand_over = [&](int t) {
      const int n = u + t, buf = n & 1;
      const uint32_t parity = (n >> 1) & 1;
      float4* hp = hand + buf * (S::P_TILE / 16);
      if (c == 0) {
#pragma unroll
        for (int i = 0; i < Q_TILE / 2; ++i)
          sc[i] = fast_exp2(sc[i] * scale_log2);
        mbar_wait(empty_p + 8 * buf, parity ^ 1);  // read two tiles ago
#pragma unroll
        for (int i = 0; i < Q_TILE / 8; ++i)
          hp[i * WG] = make_float4(sc[4 * i], sc[4 * i + 1], sc[4 * i + 2],
                                   sc[4 * i + 3]);
        mbar_arrive(full_p + 8 * buf);
      } else {
        mbar_wait(full_p + 8 * buf, parity);
#pragma unroll
        for (int i = 0; i < Q_TILE / 8; ++i) {
          const float4 p = hp[i * WG];
          sc[4 * i] *= p.x;
          sc[4 * i + 1] *= p.y;
          sc[4 * i + 2] *= p.z;
          sc[4 * i + 3] *= p.w;
        }
        mbar_arrive(empty_p + 8 * buf);
      }
    };
    auto pack = [&]() {
#pragma unroll
      for (int i = 0; i < Q_TILE / 4; ++i)
        pk[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
    };

    // A tile's gradient product is issued with the next tile's scores and
    // both are waited for together, as in the loop of D <= 128 below: with
    // the arithmetic of one tile beside the gradient product of the tile
    // before (K6a's loop up to D = 128), ptxas spilled 468 bytes, 0.319
    // against 0.154 ms (see "D = 256" above). No ping-pong: the hand-over
    // already sets one consumer's arithmetic beside the other's products.
    for (int item = blockIdx.x, it = 0; item < items;
         item += gridDim.x, ++it) {
      const Item w(item / SLICES, nx, H);
      if constexpr (SLICES > 1) slice = item % SLICES;
      mbar_wait(full_kv + 8 * c, it & 1);  // this item's k (0) or v (1)
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;

      issue_scores(0);
      wgmma_wait<0>();
      reg_fence(sc);
      if (ntiles == 1) mbar_arrive(empty_kv);
      hand_over(0);
      pack();
      for (int t = 1; t < ntiles; ++t) {
        if constexpr (DkvCfg<D>::EARLY) {
          issue_grad(t - 1); // dV / dK of tile t-1 ...
          issue_scores(t);   // ... and S^T / dP^T of tile t
          wgmma_wait<1>();   // the gradient product done: its stage is free
          reg_fence(acc);
          reg_fence(pk);
          release(t - 1);
          wgmma_wait<0>();
          reg_fence(sc);
          if (t == ntiles - 1) mbar_arrive(empty_kv);  // k / v read
        } else {
          issue_scores(t);   // S^T / dP^T of tile t ...
          issue_grad(t - 1); // ... and dV / dK of tile t-1
          wgmma_wait<0>();
          reg_fence(sc);
          reg_fence(acc);
          reg_fence(pk);
          if (t == ntiles - 1) mbar_arrive(empty_kv);  // k / v read
          release(t - 1);
        }
        hand_over(t);      // while the other consumer's products run
        pack();
      }
      issue_grad(ntiles - 1);
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(pk);
      release(ntiles - 1);

      const int r0 = w.x * ITEM + warp * 16 + g;
      if (c == 0)
        store_rows<DV>(dv + w.b * vdv.b + w.h * vdv.h + slice * DV, vdv.n,
                       acc, 1.f, r0, M, t4);
      else
        store_rows<DV>(dk + w.b * vdk.b + w.h * vdk.h + slice * DV, vdk.n,
                       acc, scale, r0, M, t4);
      u += ntiles;
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
      store_rows<D>(dk + w.b * vdk.b + w.h * vdk.h, vdk.n, adk, scale, r0, M,
                    t4);
      store_rows<D>(dv + w.b * vdv.b + w.h * vdv.h, vdv.n, adv, 1.f, r0, M,
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
// (`item` of `rows` key rows of a head) where there are fewer; a
// cudaError_t.
int persistent_blocks(int* blocks, int B, int H, int rows, int item) {
  int dev = 0, sms = 0;
  int e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long items = (long long)((rows + item - 1) / item) * H * B;
  *blocks = (int)(items < sms ? items : sms);
  return e;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const void* lse, void* delta, void* dq,
              const long long* st, int B, int H, int N, int M, float scale,
              cudaStream_t stream) {
  auto kernel = flash_dq_sm90_kernel<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int e = opt_in_smem(kernel, DqSmem<D>::BYTES);
  if (e == 0) e = encode_view<D, ROWS>(&tm_q, q, view_at(st, 0), B, H, N);
  constexpr int KT = DqSmem<D>::KEY_TILE;
  if (e == 0) e = encode_view<D, KT>(&tm_k, k, view_at(st, 1), B, H, M);
  if (e == 0) e = encode_view<D, KT>(&tm_v, v, view_at(st, 2), B, H, M);
  if (e == 0) e = encode_view<D, ROWS>(&tm_do, dout, view_at(st, 4), B, H, N);
  if (e != 0) return e;
  dim3 grid((N + DqSmem<D>::ITEM - 1) / DqSmem<D>::ITEM, H, B);
  kernel<<<grid, THREADS, DqSmem<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const bf16*>(o),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<float*>(delta), static_cast<bf16*>(dq), view_at(st, 3),
      view_at(st, 4), view_at(st, 5), N, M, H, scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const long long* st, int B, int H, int N, int M, float scale,
               cudaStream_t stream) {
  auto kernel = flash_dkv_sm90_kernel<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  int blocks = 0;
  int e = opt_in_smem(kernel, DkvSmem<D>::BYTES);
  constexpr int QT = DkvCfg<D>::Q_TILE;
  if (e == 0) e = encode_view<D, QT>(&tm_q, q, view_at(st, 0), B, H, N);
  if (e == 0) e = encode_view<D, ROWS>(&tm_k, k, view_at(st, 1), B, H, M);
  if (e == 0) e = encode_view<D, ROWS>(&tm_v, v, view_at(st, 2), B, H, M);
  if (e == 0) e = encode_view<D, QT>(&tm_do, dout, view_at(st, 3), B, H, N);
  if (e == 0)
    e = persistent_blocks(&blocks, B, H * DkvCfg<D>::SLICES, M,
                          DkvCfg<D>::ITEM);
  if (e != 0) return e;
  kernel<<<blocks, THREADS, DkvSmem<D>::BYTES, stream>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), view_at(st, 4), view_at(st, 5), B, N, M, H,
      scale * LOG2E, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Every tensor argument but lse and delta is a (B, H, N, D) bf16 view (k, v,
// dk, dv: (B, H, M, D)) with the head dim contiguous, 16-byte aligned start
// and (b, h, n) strides, the element strides in `strides`, three per tensor
// in argument order. lse,
// delta: (B, H, N) fp32, contiguous. Each function returns 0, or the first
// error: a cudaError_t of a launch or the CUresult of a tensor-map encode.

// K6a: dq and delta = rowsum(dO * o) (strides of q, k, v, o, dout, dq).
extern "C" int sd3_flash_attention_dq(const void* q, const void* k,
                                      const void* v, const void* o,
                                      const void* dout, const void* lse,
                                      void* delta, void* dq,
                                      const long long* strides, int B, int H,
                                      int N, int M, int D, float scale,
                                      void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dq<16>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    case 32: return launch_dq<32>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    case 64: return launch_dq<64>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    case 128: return launch_dq<128>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    case 256: return launch_dq<256>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    case 384: return launch_dq<384>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    case 512: return launch_dq<512>(q, k, v, o, dout, lse, delta, dq, strides, B, H, N, M, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6b: dk, dv, after K6a wrote delta (strides of q, k, v, dout, dk, dv).
extern "C" int sd3_flash_attention_dkv(const void* q, const void* k,
                                       const void* v, const void* dout,
                                       const void* lse, const void* delta,
                                       void* dk, void* dv,
                                       const long long* strides, int B, int H,
                                       int N, int M, int D, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_dkv<16>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    case 32: return launch_dkv<32>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    case 64: return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    case 128: return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    case 256: return launch_dkv<256>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    case 384: return launch_dkv<384>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    case 512: return launch_dkv<512>(q, k, v, dout, lse, delta, dk, dv, strides, B, H, N, M, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
