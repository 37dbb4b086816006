// K1 and K7, the bf16 joint-attention forwards, and K5, the flash-attention
// forward of training, for NVIDIA Hopper (sm_90a): one kernel,
// attn_sm90_kernel<D, Softmax>, on wgmma and TMA with a warp-specialised
// ring of K / V tiles, at head dims D = 16, 32, 64, 128, 256, 384, 512, 768
// and 1024 (bf16 heads of 129 to 1024 values run zero-padded at 256, 384,
// 512, 768 or 1024; past 1024, and fp32 at every head dim,
// attention_fp32.cu's mma.sync instances take them).
//
// Replaces, in sd3_tpu/ops/fused_attention.py (both reached through
// _pallas_fused, at :642 and :660):
//   K1  `_fused_fwd_kernel` (:135), bf16 branch: the single-KV kernel (at
//       most 2048 padded tokens), softmax against the BOUNDED shift
//       ||q^|| * max ||k^|| (Softmax::Bounded);
//   K7  `_stream_fwd_kernel` (:312), bf16 branch: the streaming kernel
//       (more than 2048 padded tokens), an ONLINE softmax with the true
//       running max (Softmax::Online);
// and in sd3_tpu/ops/flash_attention.py (pallas_call at :166):
//   K5  `_fwd_kernel` (:103): o = softmax(q k^T * scale) v and the fp32
//       lse = m + log(l) that K6a and K6b read (Softmax::Flash), on raw q, k,
//       v: no prep (see "K5" below).
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
//        128 bytes for D = 16, 32, 64 and as two (four) 128-byte atom
//        columns for D = 128 (256); TMA zero-fills the rows past N, and the
//        softmax masks the padded keys of the ragged last tile (a zero key
//        scores 0, not -inf).
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
// K5 (Softmax::Flash) is the same block on what training hands over: one
// launch, no prep. q, k and v are read raw through 4-D tensor maps (D, N, H,
// B) built from the (b, h, n) strides of the caller's (B, H, N, D) views
// (encode_view, sm90.cuh), so the (B, N, H, D) buffers of the training path
// are read in place; o is written through its view's strides. k and v have
// a key length M of their own (kv_merge_attn halves it): their maps hold M
// rows, the key tiles run to M and the ragged last one is masked at M. The scale is
// not folded into q: the running max m is of the raw scores, and each p is
// exp2(s * scale*log2(e) - m * scale*log2(e)), one FFMA ahead of the exp2;
// alpha = exp2((m_old - m) * scale*log2(e)). lse is written in natural-log
// units, (m * scale*log2(e) + log2(l)) * ln(2), fp32 (B, H, N), as the plain
// version (ops/flash_attention.py) returns it; rows past N write neither o
// nor lse. At D = 128 K5 runs 64-key tiles (key_tile: the registers).
// Numerics against the TPU kernel and the plain version: p is rounded to
// bf16 against the running max of its key tile, where the
// plain version (and JAX below 2048 keys) takes the true row max; the p of
// a tile whose running max later grows is rescaled by alpha in fp32 after
// its rounding, which moves o by bf16's relative rounding (2^-9) at most,
// the size of p's rounding itself (FLASH_OUT_ATOL in chip_smoke.py). l and
// lse come from the unrounded fp32 p. No atomics: two runs give the same
// bits. K5 runs persistent CTAs (see the kernel): with a CTA per 128 rows,
// as K1 and K7 run, a CTA's start and end (the q load, the ring's fill, the
// epilogue) and the last partial wave of 760 CTAs held it at 1.10x / 1.05x
// SDPA's forward at the training shapes (PERF.md). At the 512px training
// shape (B 4, H 19, N 1178, D 64) the products are 27.0 G FLOP, 0.0273 ms
// at 989 TFLOP/s, and the exp2s 0.105 G, 0.0273 ms on the SFU.
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
//
// D = 256 (K1W, K7W, K5W: heads of 129 to 256 values in bf16). A consumer's
// accumulator, 64 rows x 256 fp32 over its 128 threads, is 128 of its 240
// registers. Beside it the loop above holds a tile's scores, their bf16 p
// and the p that the in-flight P.V reads: ptxas spilled 472-868 bytes and
// serialized the wgmmas (advisory C7512) at 64-key tiles, and a K1 call
// took 0.130 ms against 0.080 with this design and the same preps (B 2, N
// 1178, H 5, H100; PERF.md). So at
// D = 256 each consumer lets its P.V of tile t-1 land before it issues S
// of tile t: scores and p are never in flight together, nothing spills,
// and the softmax overlaps the other consumer's products alone (the
// ping-pong). Tiles of 64 keys (WIDE_KEY_TILE) for all three softmaxes in
// two stages of 32 KB K and V tiles beside the 64 KB of q^: 128-key tiles
// would leave room for one stage, which the ring could not refill under the
// products. K7 rounds p against the running max of these 64 keys
// (K7_KEY_TILE_256 in ops/fused_attention.py, its plain version's
// block_k). P.V is one wgmma m64n256k16 a k-step. What bounds it: at B 2,
// N 1178, H 5 the products are 14.2 G FLOP, 0.0144 ms at 989 TFLOP/s, the
// exp2s 0.0036 ms on the SFU (a quarter: one exp2 against a score's 4D =
// 1024 FLOP); and 100 CTAs of 128 rows fill 100 of the 132 SMs, one
// partial wave.
//
// D = 384 and 512 (K1_384 .. K5_512: heads of 257 to 512 values in bf16).
// A consumer's 64-row fp32 accumulator of the whole head would be D / 2 =
// 192 / 256 of its 240 registers, and one wgmma takes at most 256 columns.
// So the output is cut into two column slices of DV = D / 2 (192 / 256),
// each consumer computes the scores over the whole head (D / 16 k-steps)
// and P.V runs over its DV columns of V (wgmma m64n192k16 / m64n256k16).
// The QK^T is computed once per slice, so the products are 1.5x the
// minimal 4*B*H*N^2*D. Both slices run the same S in the same order, so
// m, p and l are bit for bit the same in each, and each writes its own
// columns with no reduction between them; K5's lse is written by slice 0.
// A CTA takes 64 query rows; its two consumers work on the same rows,
// consumer c on slice c, and share the q^ tile (48 / 64 KB) and the K and
// V stages (V of the whole head). This layout was measured in turns
// against another, the slice a grid dimension (items of 128 rows, 64 a
// consumer, and one slice: q^ of 96 / 128 KB, V tiles of the slice), on
// the same inputs with bit-for-bit the same outputs (B 2, N 1178, H 5; K5
// at B 4 and 3 / 2 heads; H100 at 700 W, utils/wide_attention_diag.py,
// PERF.md): K1 / K7 / K5 0.1060 / 0.1160 / 0.1037 ms at D = 384 and
// 0.1488 / 0.1536 / 0.1246 at 512, against 0.1058 / 0.1185 / 0.1109 and
// 0.1467 / 0.1551 / 0.1525 with the grid dimension. It ties on K1 / K7
// and takes 18% off K5 at D = 512, so the grid layout was dropped. ptxas:
// no spill in either.
// Shared memory: K / V tiles take 32 keys (SLICE_KEY_TILE), a 64-key K
// tile of the whole head (48 / 64 KB) not fitting twice beside q^ and V:
// three stages of 24 + 24 KB at D = 384, two of 32 + 32 KB at 512 (192
// KB). K7 rounds p against the running max of these 32 keys
// (K7_KEY_TILE_512, its plain version's block_k, held to JAX at 32-key
// blocks on the CPU). Registers: at D = 384 the D <= 128 loop (S of tile t
// with P.V of t-1) holds 96 + 16 + 8 and spills nothing; at D = 512 it
// spilled 128-136 bytes and serialized the wgmmas (C7512), 0.32-0.34 ms a
// K1 / K7 / K5 call, so D = 512 runs the D = 256 loop (P.V landed before
// the next S): no spill, 0.146-0.159 ms. The q^ descriptors of the D / 16
// k-steps are one descriptor plus constant offsets (k_step_offset,
// sm90.cuh), made opaque to the loop: ptxas otherwise kept all of them in
// registers (48 / 64) and spilled 216-236 bytes in K5 at D = 384, 0.21
// against 0.107 ms. The preps stay attention_common.cuh's (one row a
// warp): q + k 24.9 us at K1's D = 384 call against 2 x 15.9 us of
// attention_fp32.cu's wide_prep_kernel. What bounds them at B 2, N 1178, H
// 5: the products with QK^T twice, 0.0324 / 0.0432 ms at 989 TFLOP/s (the
// minimal 0.0216 / 0.0288); 190 CTAs of 64 rows on 132 SMs, two waves.
//
// D = 768 and 1024 (K1_768 .. K5_1024: heads of 513 to 1024 values in
// bf16). Two slices of D / 2 would be 384 / 512 columns, past one wgmma's
// 256 and a consumer's registers, so the output is cut into four slices of
// DV = D / 4 (192 / 256 columns) and an item is 64 query rows and one PAIR
// of slices (a grid dimension, PAIRS = 2): its two consumers share the q^
// tile (96 / 128 KB), consumer c writes slice 2 * pair + c, and the V
// stages hold the pair's 2 * DV columns only. A K tile of the whole head
// would take 1.5 / 2 KB a key, so beside q^ only tiles of 16 keys fit
// twice; and a score wgmma m64n16k16 reads its 2 KB of q^ from shared
// memory for 16 keys, which at 128 bytes a clock takes 2.5x its tensor
// time (an earlier version of these instances, 16-key tiles of the whole
// head: 199 us for K1_768's attention at B 2, N 1178, H 2, against 0.0431
// ms of products; PERF.md). So the tiles are KT = 64 keys
// (PAST_512_KEY_TILE) and the K ring holds CHUNKS of them: 64 keys by
// K_CHUNK = 128 values of the head (16 KB), the S of a tile issued a chunk
// at a time (8 wgmma m64n64k16 into the same 32 score registers, each chunk
// waited for and released once the next one's products are in flight), and
// the V ring 32-key sub-tiles of the pair's columns (24 / 32 KB, two
// stages), P.V of a tile issued a sub-tile at a time, one in flight behind
// the next one's issue. Two ways to compute the scores were measured in
// turns on the same inputs, with bit-for-bit the same outputs (B 2, N
// 1178, H 2, H100 at 700 W, PERF.md): (a) each consumer computes S over
// the whole head, the consumers taking turns a chunk at a time and each
// one's P.V of tile t-1 landing in its first chunk's turn (the D = 256
// loop), so that QK^T runs once per slice, four times (the products 2.5x
// the minimal 4*B*H*N^2*D); (b, SHARED_S) consumer 0 alone computes S and
// its softmax and hands p, alpha and l to consumer 1 through a 10 KB
// exchange (named barriers XFULL / XFREE), each then running its own P.V,
// so QK^T runs twice (1.5x the minimal). At D = 768 (b) takes K1 / K7 /
// K5's attention from 113 / 119 / 132 us to 81 / 84 / 90. At 1024 q^ of
// 128 KB leaves (b) room for 16-key V sub-tiles only, one m64n256k16 each
// behind a ring of two, and (a) is ahead: 161 / 166 / 190 us against 179 /
// 186 / 194. So D = 768 runs (b) and 1024 (a). In both every slice sees
// the same S in the same order: m, p and l agree bit for bit across the
// four. K7 rounds p against the running max of these 64 keys
// (K7_KEY_TILE_1024 in ops/fused_attention.py). What bounds them at B 2,
// N 1178, H 2: the products of the design, 0.0259 ms at D = 768 and 0.0575
// at 1024 at 989 TFLOP/s (the minimal 0.0172 / 0.0230); 152 CTAs of 64
// rows and a pair on 132 SMs, two waves.

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
// at D = 768 (SHARED_S), XFULL: consumer 0 has written a tile's p into
// the exchange; XFREE: consumer 1 has read it
constexpr int XFULL = 3;
constexpr int XFREE = 4;
// 384 threads x 168 registers at launch; the producer keeps 24, so each
// consumer thread can have 240
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

namespace Softmax {
struct Bounded {};  // K1: shift ||q^|| * max ||k^||, no rescale
struct Online {};   // K7: the running row max
struct Flash {};    // K5: the running row max of raw scores, lse out
}  // namespace Softmax

// keys per K / V tile of every instance at D = 256, and past it (see
// key_tile)
constexpr int WIDE_KEY_TILE = 64;
constexpr int SLICE_KEY_TILE = 32;
constexpr int PAST_512_KEY_TILE = 64;
// past 512: values of the head in a K stage (a chunk of a tile)
constexpr int K_CHUNK = 128;

// Keys per K / V tile of attn_sm90_kernel<D, SM>: KEY_TILE, but 64 for K5 at
// D = 128 and for all three at D = 256, 32 past it. A consumer thread holds
// a tile's scores (KT / 2 registers), their bf16 p (KT / 4) and the
// accumulator (DV / 2, DV its columns of the output): K5 at D = 128 with
// 128 keys held 160, which with the addresses, row statistics and the
// softmax's temporaries spilled 208 bytes of the 240 registers (ptxas); 64
// keys hold 112. At D = 256 see "D = 256" above, past it "D = 384 and
// 512". K1 and K7 keep 128 keys up to D = 128. K7 rounds p against the
// running max of its tile, which its plain version reproduces with block_k
// = K7_KEY_TILE (128), at D = 256 K7_KEY_TILE_256 (WIDE_KEY_TILE, 64),
// at 384 and 512 K7_KEY_TILE_512 (SLICE_KEY_TILE, 32), past 512
// K7_KEY_TILE_1024 (PAST_512_KEY_TILE, 64); K1's bounded shift and K5's
// true lse do not depend on the tile.
template <int D, class SM>
__host__ __device__ constexpr int key_tile() {
  return D == 256 ? WIDE_KEY_TILE
         : D > 512 ? PAST_512_KEY_TILE
         : D > 256 ? SLICE_KEY_TILE
         : D == 128 && std::is_same<SM, Softmax::Flash>::value ? 64
                                                               : KEY_TILE;
}

// Shared memory of attn_sm90_kernel<D, *> with KT-key tiles, from a
// 1024-byte aligned base; every tile in the swizzled layout of
// SwizzledRows<D> (sm90.cuh). Four stages of tiles up to 16 KB, three of
// larger ones (K1 / K7 at D = 128: 32 KB), two at D = 256 (32 KB tiles
// beside 64 KB of q^: 192 KB of the 227 KB a block may take). Past 256
// (SLICED) the two consumers share one q^ tile: three stages of 24 + 24 KB
// beside 48 KB of q^ at D = 384, two of 32 + 32 KB beside 64 KB at D = 512
// (192 KB). Past 512 (CHUNKED) stages of 16 KB K chunks and two of
// 32-key V sub-tiles of the pair's columns beside q^: at D = 768 four K
// stages, 24 KB V stages and the 10 KB exchange beside 96 KB (219 KB); at
// 1024 two K stages and 32 KB V stages beside 128 KB (225 KB).
template <int D, int KT = KEY_TILE>
struct Sm90 : SwizzledRows<D> {
  // past D = 256 an item is 64 query rows, each consumer writing one of
  // two column slices of them (see "D = 384 and 512" above); past 512 one
  // of PAIRS pairs of slices of D / 4 columns, K in chunks of K_CHUNK
  // values and V in sub-tiles of VSUB keys (see "D = 768 and 1024")
  static constexpr bool SLICED = D > 256;
  static constexpr bool CHUNKED = D > 512;
  static constexpr int PAIRS = CHUNKED ? 2 : 1;
  static constexpr int ROWS = SLICED ? QROWS : BLOCK_Q;  // an item's rows
  // a consumer's columns, and those of an item (of its V stages)
  static constexpr int DV = SLICED ? D / (2 * PAIRS) : D;
  static constexpr int VCOLS = SLICED ? 2 * DV : D;
  // values of the head in a K stage, keys in a V stage
  static constexpr int KCOLS = CHUNKED ? K_CHUNK : D;
  static constexpr int VSUB = CHUNKED ? 32 : KT;
  static constexpr int KV_TILE = KT * KCOLS * 2;    // one K stage
  static constexpr int V_TILE = VSUB * VCOLS * 2;   // one V stage
  // at D = 768 (SHARED_S) consumer 0 alone computes S and hands p, its
  // alpha and l to consumer 1 through the exchange X, KT / 4 + 4 words a
  // thread; at 1024 both compute S (see "D = 768 and 1024")
  static constexpr bool SHARED_S = D == 768;
  static constexpr int X_TILE = SHARED_S ? (KT / 4 + 4) * WG * 4 : 0;
  static constexpr int STAGES = D == 256 || D == 512 || D == 1024 ? 2
                                : D == 384 ? 3 : KV_TILE > 16384 ? 3 : 4;
  static constexpr int V_STAGES = CHUNKED ? 2 : STAGES;
  static constexpr int Q_TILE = QROWS * D * 2;      // one consumer's q^
  static constexpr int Q_TILES = SLICED ? 1 : CONSUMERS;
  static constexpr int Q = 0;                       // [Q_TILES] q^ tiles
  static constexpr int K = Q + Q_TILES * Q_TILE;    // [STAGES] K stages
  static constexpr int V = K + STAGES * KV_TILE;    // [V_STAGES] V stages
  static constexpr int X = V + V_STAGES * V_TILE;   // the exchange
  // mbarriers: full / empty of each K and V stage, full / empty of each q^
  // tile
  static constexpr int BAR = X + X_TILE;
  static constexpr int BYTES =
      BAR + (2 * STAGES + 2 * V_STAGES + 2 * CONSUMERS) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// TMA of ROWS rows (n0.., head h, sample b) into a tile at `dst`, one box
// per atom column, NC of them from atom column c0 on (every column of the
// head by default): of a (B, N, H*D) tensor mapped (D, H, N, B) (K1, K7),
// or of a (B, H, N, D) view mapped (D, N, H, B) (FLASH: K5).
template <int D, int ROWS, bool FLASH, int NC = SwizzledRows<D>::COLS>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int h, int n0, int b,
                                          int c0 = 0) {
  using S = SwizzledRows<D>;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int x = (c0 + c) * S::W / 2;
    if constexpr (FLASH)
      tma_load_4d(dst + c * ROWS * S::W, m, bar, x, n0, h, b);
    else
      tma_load_4d(dst + c * ROWS * S::W, m, bar, x, h, n0, b);
  }
}

// grid (ceil(N / ROWS) * PAIRS, H, B), a CTA per item (ROWS = Sm90::ROWS
// query rows, pair of slices, head, sample); for Flash min(SMs, items)
// persistent CTAs, CTA i on items i, i + grid, ... (pairs, then q tiles
// fastest), its ring, barriers and turns
// running on across items, so that its producer loads the next item's q
// and first K / V tiles under the last one's final P.V and epilogue.
// SM90_THREADS threads, Sm90<D, key_tile<D, SM>()>::BYTES of dynamic shared
// memory.
// tm_q, tm_k, tm_v: tensor maps of bf16 q^, k^ and v (encode_heads), or for
// Flash of raw q, k, v (encode_view); q_norm (B*H, N) ||q^|| and k_max2 (B*H) max ||k^||^2
// (Bounded only); o bf16 with element strides vo; lse (B*H, N) fp32 and
// scale_log2 = scale * log2(e) (Flash only).
template <int D, class SM>
__global__ void __launch_bounds__(SM90_THREADS, 1)
attn_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 const float* __restrict__ q_norm,
                 const float* __restrict__ k_max2, bf16* __restrict__ o,
                 View vo, float* __restrict__ lse, float scale_log2, int N,
                 int M, int H, int B) {
  constexpr int KT = key_tile<D, SM>();
  using S = Sm90<D, KT>;
  constexpr bool BOUNDED = std::is_same<SM, Softmax::Bounded>::value;
  constexpr bool FLASH = std::is_same<SM, Softmax::Flash>::value;
  constexpr int STAGES = S::STAGES, V_STAGES = S::V_STAGES;
  constexpr int ROWS = S::ROWS, DV = S::DV, PAIRS = S::PAIRS;
  // K stages (chunks) and V stages (sub-tiles) of a key tile: one each up
  // to D = 512
  constexpr int KCH = D / S::KCOLS, VSUBS = KT / S::VSUB;
  // a consumer issues a tile's V sub-tiles in one turn, so they must all
  // fit the ring unless the other consumer takes no turns (SHARED_S)
  static_assert(S::SHARED_S || VSUBS <= V_STAGES,
                "V sub-tiles of a tile");
  // D = 256 and 512: each consumer's P.V lands before its next S is issued
  // (see the key-tile loop; past 512 too, in the CHUNKED loop)
  constexpr bool SERIAL = D == 256 || D == 512;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_k = sb + S::BAR, full_v = full_k + 8 * STAGES;
  const uint32_t empty_k = full_v + 8 * V_STAGES;
  const uint32_t empty_v = empty_k + 8 * STAGES;
  const uint32_t full_q = empty_v + 8 * V_STAGES;
  const uint32_t empty_q = full_q + 8 * CONSUMERS;
  const int ntiles = (M + KT - 1) / KT;
  const int nqt = (N + ROWS - 1) / ROWS;  // q tiles
  const int n_items = nqt * PAIRS * H * B;
  const int n_local =
      !FLASH ? 1
      : (int)blockIdx.x < n_items
          ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
          : 0;
  // (q tile, pair, head, sample) of this CTA's local item j
  auto item_of = [&](int j, int& qt, int& pr, int& h, int& b) {
    if constexpr (FLASH) {
      const int it = blockIdx.x + j * gridDim.x;
      qt = it % (nqt * PAIRS) / PAIRS;
      pr = it % PAIRS;
      h = it / (nqt * PAIRS) % H;
      b = it / (nqt * PAIRS * H);
    } else {
      qt = blockIdx.x / PAIRS;
      pr = blockIdx.x % PAIRS;
      h = blockIdx.y;
      b = blockIdx.z;
    }
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      // lane 0 of each warp (SHARED_S: of consumer 0, which alone reads K)
      mbar_init(empty_k + 8 * s, S::SHARED_S ? 4 : CONSUMERS * 4);
    }
    for (int s = 0; s < V_STAGES; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, CONSUMERS * 4);
    }
    for (int c = 0; c < CONSUMERS; ++c) {
      mbar_init(full_q + 8 * c, 1);
      // lane 0 of each warp of consumer c (SLICED: of both, tile 0)
      mbar_init(empty_q + 8 * c,
                S::SLICED && !S::SHARED_S ? 4 * CONSUMERS : 4);
    }
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
      for (int ji = 0; ji < n_local; ++ji) {
        int qt, pr, h, b;
        item_of(ji, qt, pr, h, b);
        for (int c = 0; c < S::Q_TILES; ++c) {
          // once the last item's is done
          mbar_wait(empty_q + 8 * c, (ji & 1) ^ 1);
          mbar_arrive_expect_tx(full_q + 8 * c, S::Q_TILE);
          load_tile<D, QROWS, FLASH>(sb + S::Q + c * S::Q_TILE, &tm_q,
                                     full_q + 8 * c, h,
                                     qt * ROWS + c * QROWS, b);
        }
        // the ring's K and V stages of key tile t: its KCH chunks of KCOLS
        // values, then its VSUBS sub-tiles of VSUB keys of the item's VCOLS
        // columns of V (up to D = 512 one of each, the whole tile)
        constexpr int KNC = S::KCOLS * 2 / S::W, VNC = S::VCOLS * 2 / S::W;
        for (int t = 0; t < ntiles; ++t) {
          for (int ch = 0; ch < KCH; ++ch) {
            const int kc = (ji * ntiles + t) * KCH + ch, s = kc % STAGES;
            mbar_wait(empty_k + 8 * s, ((kc / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(full_k + 8 * s, S::KV_TILE);
            load_tile<D, KT, FLASH, KNC>(sb + S::K + s * S::KV_TILE, &tm_k,
                                         full_k + 8 * s, h, t * KT, b,
                                         ch * KNC);
          }
          for (int u = 0; u < VSUBS; ++u) {
            const int vc = (ji * ntiles + t) * VSUBS + u, s = vc % V_STAGES;
            mbar_wait(empty_v + 8 * s, ((vc / V_STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(full_v + 8 * s, S::V_TILE);
            load_tile<D, S::VSUB, FLASH, VNC>(
                sb + S::V + s * S::V_TILE, &tm_v, full_v + 8 * s, h,
                t * KT + u * S::VSUB, b, pr * VNC);
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each (SLICED: the same rows, and DV
    // columns each, vcol on in the item's V tile)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int qc = S::SLICED ? 0 : c;  // this consumer's q^ tile
    const int vcol = S::SLICED ? c * DV : 0;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const uint32_t q_base = sb + S::Q + qc * S::Q_TILE;
    float s[KT / 2];     // scores, then p, of one tile
    uint32_t p[KT / 4];  // bf16 p: the A fragments of the KT / 16 P.V steps
    float acc[DV / 2];
#pragma unroll
    for (int i = 0; i < KT / 2; ++i) s[i] = 0.f;

    // Ping-pong: the consumers take turns to issue their products (named
    // barriers TURN + c, each met by this consumer's sync and the other's
    // arrive), so that one's softmax runs while the other's products do.
    // Consumer 0 goes first; consumer 1 does not hand over after its last
    // turn of its last item, which balances every barrier's arrivals
    // (ntiles + 1 turns an item each).
    const int my_turn = TURN + c, other_turn = TURN + 1 - c;
    if (c == 1) named_bar_arrive(S::SHARED_S ? XFREE : other_turn, 2 * WG);
    auto take_turn = [&]() { named_bar_sync(my_turn, 2 * WG); };
    auto hand_over = [&]() { named_bar_arrive(other_turn, 2 * WG); };

    for (int ji = 0; ji < n_local; ++ji) {
      int qt, pr, h, b;
      item_of(ji, qt, pr, h, b);
      const int col0 = pr * S::VCOLS + vcol;  // this consumer's output columns
      const int t0 = ji * ntiles;  // the ring's tile of this item's key tile 0
      const int n0 = qt * ROWS + qc * QROWS + warp * 16 + g;
      const int n1 = n0 + 8;                   // this thread's two rows

      // Bounded: the shift of rows n0, n1 (rows past N: q^ = 0, any shift)
      float shift0 = 0.f, shift1 = 0.f;
      if constexpr (BOUNDED) {
        const float kmax = sqrtf(k_max2[b * H + h]);
        const float* qn = q_norm + (size_t)(b * H + h) * N;
        if (n0 < N) shift0 = qn[n0] * kmax;
        if (n1 < N) shift1 = qn[n1] * kmax;
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      // this consumer's q^ has landed (SHARED_S: consumer 1 reads none)
      if (!S::SHARED_S || c == 0) mbar_wait(full_q + 8 * qc, ji & 1);
      // issue S = q^ k^T of key tile t
      auto issue_scores = [&](int t) {
        const int st = (t0 + t) % STAGES;
        mbar_wait(full_k + 8 * st, ((t0 + t) / STAGES) & 1);
        const uint32_t kb = sb + S::K + st * S::KV_TILE;
        wgmma_fence();
        if constexpr (D > 256) {
          // k-step 0's descriptors plus each k-step's offset, q^'s made
          // opaque to the loop (k_step_offset, sm90.cuh)
          uint64_t dq = desc_k_major<D>(q_base, QROWS, 0);
          const uint64_t dk = desc_k_major<D>(kb, KT, 0);
          asm volatile("" : "+l"(dq));
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<KT>(s, dq + k_step_offset<D>(QROWS, kk),
                         dk + k_step_offset<D>(KT, kk), kk > 0);
        } else {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk)
            wgmma_ss<KT>(s, desc_k_major<D>(q_base, QROWS, kk),
                         desc_k_major<D>(kb, KT, kk), kk > 0);
        }
        wgmma_commit();
      };
      // issue acc += bf16(p) v of key tile t (this consumer's DV columns:
      // past D = 256 vcol / 64 atom columns into the V tile)
      auto issue_pv = [&](int t) {
        const int st = (t0 + t) % STAGES;
        mbar_wait(full_v + 8 * st, ((t0 + t) / STAGES) & 1);
        const uint32_t vb =
            sb + S::V + st * S::V_TILE + vcol / 64 * KT * 128;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          const uint32_t a[4] = {p[4 * kk], p[4 * kk + 1], p[4 * kk + 2],
                                 p[4 * kk + 3]};
          wgmma_rs<DV>(acc, a, desc_mn_major<DV>(vb, KT, kk), 1);
        }
        wgmma_commit();
      };
      // this warp is done with key tile t's stage of K or V (up to D =
      // 512, STAGES = V_STAGES), or (empty_q) with its q^ tile
      auto release = [&](uint32_t empty, int t) {
        if (lane == 0) mbar_arrive(empty + 8 * ((t0 + t) % STAGES));
      };
      auto release_q = [&]() {
        if (lane == 0) mbar_arrive(empty_q + 8 * qc);
      };
      // s -> p = exp2(s - shift) in place, l updated; Online: the running
      // max too, and alpha of rows g, g + 8 returned in a0, a1; Flash: as
      // Online on raw scores, scaled in the exp2's argument (the max and the
      // shift of raw scores, p = exp2(s * scale_log2 - m * scale_log2)). Padded keys
      // of the ragged last tile (zero rows of the TMA box, which score 0) go
      // to -inf first, so exp2 gives them p = 0: one branch a tile, ahead of
      // the unrolled arithmetic, which it would otherwise cut into blocks.
      auto softmax = [&](int t, float& a0, float& a1) {
        const int k0 = t * KT;
        if (k0 + KT > M) {
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            const int col = k0 + j * 8 + t4 * 2;
            if (col >= M) s[4 * j] = s[4 * j + 2] = -INFINITY;
            if (col + 1 >= M) s[4 * j + 1] = s[4 * j + 3] = -INFINITY;
          }
        }
        float sh0 = shift0, sh1 = shift1;
        if constexpr (!BOUNDED) {
          // the row max over PARTS partial maxima: shorter chains for the
          // exp2s to wait on, where the registers allow (scores and
          // accumulator in at most 96 of them) and a tile has four column
          // groups of 8 keys
          constexpr int PARTS = KT / 2 + DV / 2 <= 96 && KT >= 32 ? 4 : 1;
          float x0[PARTS], x1[PARTS];
#pragma unroll
          for (int i = 0; i < PARTS; ++i) {
            x0[i] = fmaxf(s[4 * i], s[4 * i + 1]);
            x1[i] = fmaxf(s[4 * i + 2], s[4 * i + 3]);
          }
#pragma unroll
          for (int j = PARTS; j < KT / 8; ++j) {
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
          if constexpr (FLASH) {
            a0 = fast_exp2((m0 - sh0) * scale_log2);
            a1 = fast_exp2((m1 - sh1) * scale_log2);
          } else {
            a0 = fast_exp2(m0 - sh0);
            a1 = fast_exp2(m1 - sh1);
          }
          m0 = sh0;
          m1 = sh1;
          l0 *= a0;
          l1 *= a1;
          if constexpr (FLASH) {  // the shift in the exp2's units
            sh0 *= scale_log2;
            sh1 *= scale_log2;
          }
        }
        // p = exp2(s - shift), or for Flash exp2(s * scale_log2 - shift): one
        // FFMA ahead of each exp2 either way
        auto p_of = [&](float x, float sh) {
          if constexpr (FLASH) return fast_exp2(fmaf(x, scale_log2, -sh));
          else return fast_exp2(x - sh);
        };
#pragma unroll
        for (int j = 0; j < KT / 8; ++j) {
          s[4 * j] = p_of(s[4 * j], sh0);
          s[4 * j + 1] = p_of(s[4 * j + 1], sh0);
          s[4 * j + 2] = p_of(s[4 * j + 2], sh1);
          s[4 * j + 3] = p_of(s[4 * j + 3], sh1);
          l0 += s[4 * j] + s[4 * j + 1];  // sums of the unrounded p
          l1 += s[4 * j + 2] + s[4 * j + 3];
        }
      };
      auto pack_p = [&]() {
#pragma unroll
        for (int i = 0; i < KT / 4; ++i)
          p[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      };

      float a0 = 1.f, a1 = 1.f;
      if constexpr (S::CHUNKED) {
        // Past D = 512 (see the file's head): the S of key tile t a K chunk
        // a turn, each chunk waited for and released before the next turn,
        // P.V of tile t-1 issued and landed in the first chunk's turn
        // (run_pv); then the softmax of tile t while the other consumer's
        // products run.
        // P.V of key tile t over its VSUBS V sub-tiles, each issued once it
        // has landed and released once its product has run, one in flight
        // behind the next one's issue; the turn handed over after the last
        // issue where `hand`.
        auto run_pv = [&](int t, bool hand) {
          constexpr int KV = S::VSUB / 16;  // k-steps of a sub-tile
#pragma unroll
          for (int u = 0; u < VSUBS; ++u) {
            const int vc = (t0 + t) * VSUBS + u, st = vc % V_STAGES;
            mbar_wait(full_v + 8 * st, (vc / V_STAGES) & 1);
            const uint32_t vb =
                sb + S::V + st * S::V_TILE + vcol / 64 * S::VSUB * 128;
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KV; ++kk) {
              const int k = u * KV + kk;
              const uint32_t a[4] = {p[4 * k], p[4 * k + 1], p[4 * k + 2],
                                     p[4 * k + 3]};
              wgmma_rs<DV>(acc, a, desc_mn_major<DV>(vb, S::VSUB, kk), 1);
            }
            wgmma_commit();
            if (u == VSUBS - 1 && hand) hand_over();
            if (u > 0) {
              wgmma_wait<1>();
              if (lane == 0)
                mbar_arrive(empty_v + 8 * ((vc - 1) % V_STAGES));
            }
          }
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(p);
          if (lane == 0)
            mbar_arrive(empty_v +
                        8 * (((t0 + t) * VSUBS + VSUBS - 1) % V_STAGES));
        };
        // the acc of rows g, g + 8 to the running max of the tile whose
        // softmax has just run (alpha in a0, a1)
        auto rescale = [&]() {
          if constexpr (!BOUNDED) {
#pragma unroll
            for (int j = 0; j < DV / 8; ++j) {
              acc[4 * j] *= a0;
              acc[4 * j + 1] *= a0;
              acc[4 * j + 2] *= a1;
              acc[4 * j + 3] *= a1;
            }
          }
        };
        // the exchange: word i of this thread at x[i * WG]
        uint32_t* x = reinterpret_cast<uint32_t*>(smem + S::X) + tid;
        if constexpr (S::SHARED_S) {
          if (c == 0) {
            // S of each tile, its chunks issued one after the other, a
            // chunk released once the next one's products are in flight;
            // the softmax; p, alpha and l handed to consumer 1 once it has
            // read the last ones; then this consumer's P.V
            for (int t = 0; t < ntiles; ++t) {
#pragma unroll
              for (int ch = 0; ch < KCH; ++ch) {
                const int kc = (t0 + t) * KCH + ch, st = kc % STAGES;
                mbar_wait(full_k + 8 * st, (kc / STAGES) & 1);
                const uint32_t kb = sb + S::K + st * S::KV_TILE;
                wgmma_fence();
                uint64_t dq = desc_k_major<D>(q_base, QROWS, 0);
                const uint64_t dk = desc_k_major<S::KCOLS>(kb, KT, 0);
                asm volatile("" : "+l"(dq));
#pragma unroll
                for (int kk = 0; kk < S::KCOLS / 16; ++kk)
                  wgmma_ss<KT>(
                      s,
                      dq + k_step_offset<D>(QROWS,
                                            ch * (S::KCOLS / 16) + kk),
                      dk + k_step_offset<S::KCOLS>(KT, kk),
                      ch > 0 || kk > 0);
                wgmma_commit();
                if (ch > 0) {
                  wgmma_wait<1>();
                  if (lane == 0)
                    mbar_arrive(empty_k + 8 * ((kc - 1) % STAGES));
                }
              }
              wgmma_wait<0>();
              reg_fence(s);
              if (lane == 0)
                mbar_arrive(empty_k +
                            8 * (((t0 + t) * KCH + KCH - 1) % STAGES));
              if (t == ntiles - 1) release_q();  // the item's last S
              softmax(t, a0, a1);
              pack_p();
              named_bar_sync(XFREE, 2 * WG);
#pragma unroll
              for (int i = 0; i < KT / 4; ++i) x[i * WG] = p[i];
              x[KT / 4 * WG] = __float_as_uint(a0);
              x[(KT / 4 + 1) * WG] = __float_as_uint(a1);
              x[(KT / 4 + 2) * WG] = __float_as_uint(l0);
              x[(KT / 4 + 3) * WG] = __float_as_uint(l1);
              __threadfence_block();  // the writes before the arrive
              named_bar_arrive(XFULL, 2 * WG);
              rescale();
              run_pv(t, false);
            }
          } else {
            // each tile's p, alpha and l from consumer 0 (freeing the
            // exchange but after the CTA's last tile, which balances the
            // barrier), then this consumer's P.V
            for (int t = 0; t < ntiles; ++t) {
              named_bar_sync(XFULL, 2 * WG);
#pragma unroll
              for (int i = 0; i < KT / 4; ++i) p[i] = x[i * WG];
              a0 = __uint_as_float(x[KT / 4 * WG]);
              a1 = __uint_as_float(x[(KT / 4 + 1) * WG]);
              l0 = __uint_as_float(x[(KT / 4 + 2) * WG]);
              l1 = __uint_as_float(x[(KT / 4 + 3) * WG]);
              if (ji + 1 < n_local || t + 1 < ntiles) {
                __threadfence_block();  // the reads before the arrive
                named_bar_arrive(XFREE, 2 * WG);
              }
              rescale();
              run_pv(t, false);
            }
          }
        } else {
          for (int t = 0; t < ntiles; ++t) {
#pragma unroll
            for (int ch = 0; ch < KCH; ++ch) {
              take_turn();
              if (ch == 0 && t > 0) run_pv(t - 1, false);
              const int kc = (t0 + t) * KCH + ch, st = kc % STAGES;
              mbar_wait(full_k + 8 * st, (kc / STAGES) & 1);
              const uint32_t kb = sb + S::K + st * S::KV_TILE;
              wgmma_fence();
              // q^'s descriptor opaque to the loop (k_step_offset, sm90.cuh)
              uint64_t dq = desc_k_major<D>(q_base, QROWS, 0);
              const uint64_t dk = desc_k_major<S::KCOLS>(kb, KT, 0);
              asm volatile("" : "+l"(dq));
#pragma unroll
              for (int kk = 0; kk < S::KCOLS / 16; ++kk)
                wgmma_ss<KT>(
                    s, dq + k_step_offset<D>(QROWS, ch * (S::KCOLS / 16) + kk),
                    dk + k_step_offset<S::KCOLS>(KT, kk), ch > 0 || kk > 0);
              wgmma_commit();
              hand_over();
              wgmma_wait<0>();
              reg_fence(s);
              if (lane == 0) mbar_arrive(empty_k + 8 * st);
            }
            if (t == ntiles - 1) release_q();  // the item's last S is done
            softmax(t, a0, a1);
            rescale();  // acc (tiles up to t-1) to this max
            pack_p();
          }
          take_turn();
          run_pv(ntiles - 1, c == 0 || ji + 1 < n_local);
        }
      } else {
        take_turn();
        issue_scores(0);
        hand_over();
        wgmma_wait<0>();
        reg_fence(s);
        release(empty_k, 0);
        if (ntiles == 1) release_q();  // the item's last S = q^ k^T is done
        softmax(0, a0, a1);
        pack_p();
        if constexpr (SERIAL) {
          for (int t = 1; t < ntiles; ++t) {
            // D = 256 and 512 (see the file's head): P.V of tile t-1 lands
            // before S of tile t is issued
            take_turn();
            issue_pv(t - 1);
            wgmma_wait<0>();
            reg_fence(acc);
            reg_fence(p);
            release(empty_v, t - 1);
            issue_scores(t);
            hand_over();
            wgmma_wait<0>();
            reg_fence(s);
            release(empty_k, t);
            if (t == ntiles - 1) release_q();
            softmax(t, a0, a1);
            if constexpr (!BOUNDED) {
#pragma unroll
              for (int j = 0; j < DV / 8; ++j) {
                acc[4 * j] *= a0;
                acc[4 * j + 1] *= a0;
                acc[4 * j + 2] *= a1;
                acc[4 * j + 3] *= a1;
              }
            }
            pack_p();
          }
        } else {
          for (int t = 1; t < ntiles; ++t) {
            take_turn();
            issue_scores(t);   // S of tile t ...
            issue_pv(t - 1);   // ... and P.V of tile t-1 on the tensor cores
            hand_over();
            wgmma_wait<1>();   // S of tile t done
            reg_fence(s);
            release(empty_k, t);
            if (t == ntiles - 1) release_q();
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
              for (int j = 0; j < DV / 8; ++j) {
                acc[4 * j] *= a0;
                acc[4 * j + 1] *= a0;
                acc[4 * j + 2] *= a1;
                acc[4 * j + 3] *= a1;
              }
            }
            pack_p();
          }
        }
        take_turn();
        issue_pv(ntiles - 1);
        if (c == 0 || ji + 1 < n_local) hand_over();
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(p);
        release(empty_v, ntiles - 1);
      }

      // o = acc / l, bf16, rows past N not stored; Flash: lse too
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      bf16* oh = o + b * vo.b + h * vo.h;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = col0 + j * 8 + t4 * 2;
        if (n0 < N)
          *reinterpret_cast<uint32_t*>(oh + n0 * vo.n + col) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (n1 < N)
          *reinterpret_cast<uint32_t*>(oh + n1 * vo.n + col) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
      if constexpr (FLASH) {
        if (t4 == 0 && col0 == 0) {  // one slice writes the lse
          float* lh = lse + ((size_t)b * H + h) * N;
          if (n0 < N) lh[n0] = (m0 * scale_log2 + log2f(l0)) * LN2;
          if (n1 < N) lh[n1] = (m1 * scale_log2 + log2f(l1)) * LN2;
        }
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

struct Args {
  const void *q, *k, *v, *cq, *sq, *ck, *sk;
  void *q_prep, *q_norm, *k_prep, *k_max2, *out;
  int B, N, H, dn;
  float eps_q, eps_k;
  cudaStream_t st;
};

// The q and K preps, the three tensor maps, the attention; the first error.
template <int D, class SM>
int launch_sm90(const Args& a) {
  constexpr bool BOUNDED = std::is_same<SM, Softmax::Bounded>::value;
  int e = launch_q_prep<D, BOUNDED>(a.q, a.cq, a.sq, a.q_prep, a.q_norm, a.B,
                                    a.N, a.H, a.eps_q, a.dn, a.st);
  if (e != 0) return e;
  e = launch_k_prep<D, false>(a.k, a.ck, a.sk, a.k_prep, a.k_max2, a.B, a.N,
                              a.H, a.eps_k, a.dn, a.st);
  if (e != 0) return e;
  constexpr int KT = key_tile<D, SM>();
  using S = Sm90<D, KT>;
  constexpr int BYTES = S::BYTES;
  CUtensorMap tm_q, tm_k, tm_v;
  e = encode_heads(&tm_q, a.q_prep, 2, SwizzledRows<D>::W, a.B, a.N, a.H, D, QROWS);
  if (e != 0) return e;
  e = encode_heads(&tm_k, a.k_prep, 2, SwizzledRows<D>::W, a.B, a.N, a.H, D, KT);
  if (e != 0) return e;
  e = encode_heads(&tm_v, a.v, 2, SwizzledRows<D>::W, a.B, a.N, a.H, D,
                   S::VSUB);
  if (e != 0) return e;
  auto kernel = attn_sm90_kernel<D, SM>;
  e = allow_smem(kernel, BYTES);
  if (e != 0) return e;
  dim3 grid((a.N + S::ROWS - 1) / S::ROWS * S::PAIRS, a.H, a.B);
  const View vo{(long long)a.N * a.H * D, D, (long long)a.H * D};
  kernel<<<grid, SM90_THREADS, BYTES, a.st>>>(
      tm_q, tm_k, tm_v, static_cast<const float*>(a.q_norm),
      static_cast<const float*>(a.k_max2), static_cast<bf16*>(a.out), vo,
      nullptr, 0.f, a.N, a.N, a.H, a.B);
  return (int)cudaGetLastError();
}

// K5: the three tensor maps of the raw q, k, v views, the attention; the
// first error. The shared-memory opt-in comes first: a runtime call, it
// makes the device's primary context current on this thread, which the
// maps' encode (a driver call) needs; K1's backward runs K5 on autograd's
// thread, where this may be the first CUDA call (see flash_bwd_sm90.cu).
template <int D>
int launch_flash(const void* q, const void* k, const void* v, void* o,
                 void* lse, const long long* st, int B, int H, int N,
                 int M, float scale, cudaStream_t stream) {
  auto kernel = attn_sm90_kernel<D, Softmax::Flash>;
  constexpr int KT = key_tile<D, Softmax::Flash>();
  using S = Sm90<D, KT>;
  constexpr int BYTES = S::BYTES;
  CUtensorMap tm_q, tm_k, tm_v;
  int e = (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, BYTES);
  if (e == 0) e = encode_view<D, QROWS>(&tm_q, q, view_at(st, 0), B, H, N);
  if (e == 0) e = encode_view<D, KT>(&tm_k, k, view_at(st, 1), B, H, M);
  if (e == 0) e = encode_view<D, S::VSUB>(&tm_v, v, view_at(st, 2), B, H, M);
  int dev = 0, sms = 0;
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != 0) return e;
  const int items = (N + S::ROWS - 1) / S::ROWS * S::PAIRS * H * B;
  kernel<<<items < sms ? items : sms, SM90_THREADS, BYTES, stream>>>(
      tm_q, tm_k, tm_v, nullptr, nullptr, static_cast<bf16*>(o),
      view_at(st, 3), static_cast<float*>(lse), scale * LOG2E, N, M, H, B);
  return (int)cudaGetLastError();
}

template <class SM>
int dispatch(const Args& a, int D) {
  switch (D) {
    case 16: return launch_sm90<16, SM>(a);
    case 32: return launch_sm90<32, SM>(a);
    case 64: return launch_sm90<64, SM>(a);
    case 128: return launch_sm90<128, SM>(a);
    case 256: return launch_sm90<256, SM>(a);
    case 384: return launch_sm90<384, SM>(a);
    case 512: return launch_sm90<512, SM>(a);
    case 768: return launch_sm90<768, SM>(a);
    case 1024: return launch_sm90<1024, SM>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both entry points: q, k, v, out (B, N, H*D) bf16, contiguous, 16-byte
// aligned; cq, sq, ck, sk (N, D) fp32 tables (norm weights folded in; cq, sq
// also carry scale*log2(e)); q_prep, k_prep (B, N, H*D) bf16 scratch;
// q_norm (B*H, N) fp32 scratch (K1; K7 takes none); k_max2 (B*H) fp32, zero
// on entry. D is the instance's head dim (16, 32, 64, 128, 256, 384, 512,
// 768, 1024) and dn <= D
// the model's: heads of dn < D values arrive zero-padded to D, tables too (see
// attention_common.cuh). Each returns 0, or the first error: a cudaError_t
// of a launch or the CUresult of a tensor-map encode.
#define SD3_SM90_PARAMS                                                     \
  const void *q, const void *k, const void *v, const void *cq,              \
      const void *sq, const void *ck, const void *sk, void *q_prep,         \
      void *q_norm, void *k_prep, void *k_max2, void *out, int B, int N,    \
      int H, int D, int dn, float eps_q, float eps_k, void *stream
#define SD3_SM90_ARGS                                                       \
  Args{q,      k,      v,      cq,  sq, ck, sk,    q_prep, q_norm, k_prep,  \
       k_max2, out,    B,      N,   H,  dn, eps_q, eps_k,                   \
       static_cast<cudaStream_t>(stream)}

// K1: the bounded softmax.
extern "C" int sd3_fused_attention_bf16(SD3_SM90_PARAMS) {
  return dispatch<Softmax::Bounded>(SD3_SM90_ARGS, D);
}

// K7: the online softmax over 128-key tiles.
extern "C" int sd3_fused_attention_stream(SD3_SM90_PARAMS) {
  return dispatch<Softmax::Online>(SD3_SM90_ARGS, D);
}

// K5: o, lse = m + log(l) (B, H, N) fp32, contiguous, from q, k, v, D 16,
// 32, 64, 128, 256, 384, 512, 768 or 1024. q and o are (B, H, N, D), k and v (B, H, M, D) bf16 views
// with the head dim contiguous, 16-byte aligned start and (b, h, n)
// strides, the element strides in `strides`, three per tensor (q, k, v,
// o). Returns 0, or the first error: a cudaError_t of the launch or the
// CUresult of a tensor-map encode.
extern "C" int sd3_flash_attention_fwd(const void* q, const void* k,
                                       const void* v, void* o, void* lse,
                                       const long long* strides, int B, int H,
                                       int N, int M, int D, float scale,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_flash<16>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 32: return launch_flash<32>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 64: return launch_flash<64>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 128: return launch_flash<128>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 256: return launch_flash<256>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 384: return launch_flash<384>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 512: return launch_flash<512>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 768: return launch_flash<768>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    case 1024: return launch_flash<1024>(q, k, v, o, lse, strides, B, H, N, M, scale, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
