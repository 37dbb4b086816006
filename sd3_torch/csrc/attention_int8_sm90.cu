// The int8 joint attentions for NVIDIA Hopper (sm_90a): K4 (int8 QK^T,
// single KV), K8a (int8 P.V, single KV), K7q (int8 QK^T, streaming) and K8b
// (int8 P.V, streaming), one kernel, attn_int8_sm90_kernel<D, QK8, PV8,
// TWO_PASS>, on wgmma and TMA with a warp-specialised ring of K / V tiles,
// at head dims D = 16, 32, 64, 128, 256, 384, 512, 768 and 1024 on bf16
// rows (129 to 1024 zero-padded at 256, 384, 512, 768 or 1024; past 1024,
// and fp32 rows, attention_fp32.cu).
// QK8: int8 scores (else bf16); PV8: int8 P.V (else bf16); TWO_PASS: the
// true row max in a first pass over K (the single-KV kernels), else an
// online softmax over 128-key tiles (the streaming ones).
//
// Replaces, in sd3_tpu/ops/fused_attention.py (all reached through
// _pallas_fused):
//   K4   the `int8_qk` branch of `_fused_fwd_kernel` (:193, :246-281; the
//        serving default at 1024 to 2048 padded tokens):
//        <D, true, false, true>;
//   K8a  the `int8_pv` branch of `_fused_fwd_kernel` (:181-188, :228-245,
//        :282-309; at most 2048 padded tokens), over K1's bf16 scores
//        <D, false, true, true> or over K4's int8 scores <D, true, true,
//        true>;
//   K7q  the `int8_qk` branch of `_stream_fwd_kernel` (:352; `_prep_xla`,
//        `_q8_rows_xla` :483-508; more than 2048 padded tokens):
//        <D, true, false, false>;
//   K8b  the `int8_pv` branch of `_stream_fwd_kernel` (:406-409, :425-426,
//        V from `_q8_cols_xla` :511-518), over K7's bf16 scores <D, false,
//        true, false> (the model's path) or over K7q's int8 scores <D, true,
//        true, false> (the attention API's).
// Why a kernel of its own rather than more Softmax policies of
// attention_sm90.cu's attn_sm90_kernel (K1, K7, K5): every phase of that
// loop would branch. The tiles differ in type and geometry (int8 q^ / k^
// rows, zero-padded to one s8 k-step of 32 bytes; an int8 V^T tile, K-major
// with its keys permuted; per-key scales beside each K tile), K4 and K8a
// make two passes over K, and the int8 P.V has an s32 accumulator of its
// own and a dequantizing epilogue. The skeleton is the same: a producer
// warpgroup issuing TMA loads into a ring with full / empty mbarriers, two
// consumer warpgroups of 64 query rows taking turns on two named barriers,
// S of tile t issued with P.V of tile t-1, on the same sm90.cuh helpers.
//
// What they compute, per (batch b, head h), from raw projections q, k, v
// of (B, N, H*D) bf16 and (N, D) fp32 tables with the norm weights folded
// in (the q tables also carry scale*log2(e), so the softmax runs in exp2):
// q^ = rms(q) (x) (cq, sq), k^ = rms(k) (x) (ck, sk) (attention_common.cuh).
// The scores:
//   bf16 (K8a, K8b over K1's / K7's): q^ and k^ rounded to bf16, fp32 sums;
//   K4's (K4, K8a over K4): q^ quantized per row from fp32, scale s_q =
//        max(|q^|, 1e-12) / 127; k^ rounded to bf16, quantized with ONE scale
//        per (b, h), s_k = max(|bf16(k^)|, 1e-12) / 127; s = fp32(s32) *
//        (s_q * s_k);
//   K7q's (K7q, K8b over K7q): q^ and k^ quantized per row from fp32, s =
//        s32 * s_q * s_k[key].
// The softmax and P.V:
//   K4:  p = exp2(s - max_row s) rounded to bf16, bf16 P.V with fp32 sums,
//        l the sum of the unrounded p, o = acc / l. The TRUE row max comes
//        from a first pass over the int8 K as an INTEGER max of s32: with
//        s_q * s_k > 0 and fp32(s32) exact (|s32| <= 127^2 * 128 < 2^24),
//        the rounded product is monotone in s32, so fp32(max s32) * (s_q *
//        s_k) is the max of the dequantized scores bit for bit.
//   K8a: the true row max m from the first pass (over bf16 scores the max of
//        the fp32 scores, which the second pass's products repeat bit for
//        bit); pb = exp2(s - (m - log2 127)) in [0, 127], l += the unrounded
//        pb, pq = round-half-even of pb as int8; V quantized per (b, h,
//        column) over all rows; P.V pq v_q summed in s32 over every key (|sum|
//        <= 127^2 N < 2^31; no rescale, the max being the true one); o =
//        fp32(acc) / l * v_scale[col], the plain version's arithmetic.
//   K7q: an online softmax over 128-key tiles, m the running row max, p =
//        exp2(s - m) rounded to bf16, bf16 P.V with fp32 sums, alpha =
//        exp2(m_old - m) rescaling l and the accumulator, o = acc / l.
//   K8b: the same online softmax with pb = exp2(s - (m - log2 127)) in [0,
//        127], l += the unrounded pb, pq its int8 levels; pv = pq v_q in s32
//        per tile, acc = acc * alpha + fp32(pv); o = acc / l * v_scale[col].
// K7q and K8b round p against the running max of the card's 128-key tile,
// where JAX's streaming block is ~2176 keys: the plain versions reproduce
// the card with block_k = K7Q_KEY_TILE / K8B_KEY_TILE (128), and a p of a
// tile whose running max later grows is rescaled by alpha after its
// rounding. K8a's single-KV p is against the true row max, as the plain
// version's. Padded keys get p = 0 in all.
//
// Launches:
//   1. q prep: prep_q8rows_kernel<D, TAG> (int8 q^ and its per-row scales;
//      int8 scores; TAG 4: K4, 81: K8a, 7: K7q, 8: K8b) or q_prep_kernel<D,
//      false> (bf16 q^; bf16 scores).
//   2. K prep: K4's k_prep_kernel<D, true> (bf16 k^, max |bf16(k^)| per
//      (b, h)) and k_quant_kernel (K4, K8a over K4); prep_q8rows_kernel<D,
//      TAG> (int8 k^ and per-key scales; K7q, K8b over K7q); or
//      k_prep_kernel<D, false> (bf16 k^; bf16 scores).
//   3. V prep (K8a, K8b): v_amax_kernel and v_quant_kernel: V^T in int8,
//      (B*H, D, NP) with NP = N rounded up to KEY_TILE, keys in v_perm's
//      order within each 32-key chunk, so that pq's A fragment packs straight
//      from the score accumulators (the register A of an s8 wgmma is, per
//      warp, the m16n8k32 fragment the permutation was made for), zero past
//      N.
//   4. attn_int8_sm90_kernel: three warpgroups per (128 query rows, h, b).
//      - Warpgroup 0, the producer, gives its registers away; one thread
//        issues the TMA loads: the block's two 64-row q^ tiles, then the K
//        and V tiles into a ring of STAGES stages with full and empty
//        barriers kept apart for K and V (TWO_PASS: every K tile twice, once
//        for each pass; K7q's scores: each K tile's 128 per-key scales with
//        it, from the (B*H, NP) scales its K prep writes, rows padded to
//        whole tiles).
//      - Warpgroups 1 and 2, the consumers, own 64 query rows each. Per
//        128-key tile: S by wgmma m64n128k32 s8 (or m64n128k16 bf16), A (q^)
//        and B (the K tile) from shared memory, K-major; int8 scores are
//        dequantized in place (the float's bits kept in the s32 registers);
//        the softmax on the score registers; then P.V: bf16 (K4, K7q) by
//        wgmma m64nDk16 with A = bf16(p) from registers and B the V tile
//        MN-major, into the fp32 accumulator; int8 (K8a, K8b) by wgmma
//        m64nDk32 s8 with A = pq from registers and B the int8 V^T tile,
//        K-major, into an s32 accumulator: K8b's fresh each tile (scale-d
//        0), added as acc = acc * alpha + fp32(pv) (one FFMA) once it has
//        landed; K8a's one sum over every tile.
//      - As in K1 / K7, S of tile t is issued with P.V of tile t-1 and the
//        exp2s of tile t run while the tensor cores do that P.V; the
//        consumers take turns to issue; the wait for the P.V sits behind a
//        branch on the softmax's sums (ptxas hoists a wait to the top of its
//        basic block); the ragged tile's mask is one branch ahead of the
//        softmax. The first pass (S and the row's max) takes turns the same
//        way. The int8 P.V packs tile t's levels while P.V of tile t-1 still
//        reads the last ones, into a second buffer, the two alternating over
//        a loop of two tiles: the byte permutes fill the exp2s' latency
//        instead of following the wait (attention_sm90_diag.py on an H100:
//        2.20 against 2.34 ms a K8b call at 1024px).
//      - min(SMs, items) persistent CTAs (see launch_int8), each walking
//        items i, i + grid, ... (q tiles fastest) with its rings and turns
//        running on, so that the producer loads the next item's q^ and
//        first tiles under the last one's final P.V and epilogue.
//      - Registers: ptxas reports 168 (the launch bound of 384 threads,
//        one CTA an SM) for every instance. K8b at D = 64 holds S (64), two
//        level buffers (2 x 16), pv (32) and O (32), and ptxas spills a few
//        values in its loop (attention_sm90_diag.py counts them); K8a needs
//        no O beside pv until the end. The D = 128 instances spill more and
//        ptxas serializes their wgmmas (advisory C7512): off the model's
//        path.
//      - Rounding and conversion on the FMA pipe, not the SFU-rate F2I /
//        I2F: an s32 below 2^22 in magnitude (a score, |s32| <= 127^2 *
//        128; a tile's pv, <= 127 * 127 * 128) is fp32(x) =
//        bits(x + 0x4B400000) - 0x1.8p23 exactly; pb (in [0, 127.5)) rounds
//        half to even as pb + 0x1.8p23 under round-to-nearest, whose low
//        byte is the level; four levels pack with byte permutes. K8a's sum
//        over every key may pass 2^22: it converts once, by I2F, after the
//        loop.
//
// What bounds them on this card, at the slice shapes (K4, K8a: B 8, N 1178,
// H 19, D 64; K7q, K8b: B 8, N 4250, H 19, D 64): the softmax's B*H*N^2
// exp2s, 0.211 / 2.75 G, 0.0546 / 0.7107 ms on the SFU (16 a clock an SM);
// K4's two s8 QK^T passes at the int8 rate and its bf16 P.V cost what K1's
// two bf16 products cost, 54.0 G, 0.0546 ms; K8a's two QK^T passes and s8
// P.V 0.0683 ms over bf16 scores (the tensor cores bound it there), 0.0410
// over K4's; K7q's s8 QK^T and bf16 P.V 0.533 ms; K8b's bf16 QK^T and s8
// P.V, 0.533 ms over K7's scores, 0.355 ms over K7q's; q, k, v and o 92 /
// 331 MB, 0.027 / 0.099 ms at 3.35 TB/s. Elsewhere the exp2 term bounds
// them, as it bounds K1 and K7, so the overlap of the softmax with the
// products is what the design is for, as in attention_sm90.cu.
//
// D = 256 (K4W, K7QW, K8AW, K8BW: heads of 129 to 256 values). The
// accumulator is 128 of a consumer's 240 registers, and the key tiles stay
// at 128 keys, which fix what is quantized (K8b's p levels and K7q's p
// against the running max of a 128-key block, K8B_KEY_TILE and
// K7Q_KEY_TILE; the V^T of int8 P.V is padded to them): 64 score
// registers. So each consumer lets its P.V of tile t-1 land before it
// issues S of tile t (the scores, p and the products' operands are never in
// flight together; the softmax overlaps the other consumer's products, the
// ping-pong), as attention_sm90.cu does at D = 256. K8b's s32 P.V of a tile
// would be another 128 registers beside the fp32 accumulator: it runs in
// PV_PARTS = 4 parts of 64 columns (wgmma m64n64k32 s8), each landed into
// 32 registers and added as acc = acc * alpha + fp32(pv) before the next
// part is issued. K8a's s32 sum over every key is its only accumulator: one
// m64n256k32 a k-step. The rings: KST stages of K tiles (32 KB int8, 64 KB
// bf16) and VST of V tiles (32 KB int8 V^T, 64 KB bf16) beside the q^
// tiles in 227 KB (SmemI8). The V prep's v_quant_kernel takes the head in
// 128-column slices. ptxas spills at most 32 bytes in a D = 256 instance
// (K8b over bf16 scores); K8b's P.V in two halves of 128 columns spilled
// 376-444 bytes, and its kernel took 69 us against 38 us in four parts (B
// 2, N 1178, H 5, H100; utils/wide_attention_diag.py, PERF.md).
// What bounds them at B 2, N 1178, H 5: the bf16 products 0.0144 ms at 989
// TFLOP/s (each s8 product half of its term), the exp2s 0.0036 ms, and
// 100 items of 128 rows on 132 SMs.
//
// D = 384 and 512 (K4_384 .. K8B_512: heads of 257 to 512 values). Each item
// writes one of two column slices of DV = D / 2 columns (a grid dimension;
// attention_sm90.cu's CTAs past 256 take 64 rows whose two consumers each write
// one slice, a layout not tried here), its consumers computing the scores over
// the whole head (s8 k-steps of 32 bytes, or bf16 of 16 values) and P.V over
// their DV columns (bf16 m64nDVk16; int8 V^T's DV rows of the slice, m64nDVk32;
// K8b's s32 P.V in DV / 64 parts of 64 columns, K8a's one m64nDVk32 sum over
// every key); the same S in the same order in both slices, so the levels, the
// max and l agree bit for bit. The loop is the D = 256 one (P.V landed before
// the next S; the accumulator is 96 / 128 registers). The key tiles stay 128
// keys (K8B_KEY_TILE, K7Q_KEY_TILE: the quantization), but a 128-key K tile of
// the whole head in bf16 (96 / 128 KB) does not fit twice beside q^ (96 / 128
// KB): the K ring holds sub-tiles of KSUB keys (64 at D = 384, 32 at 512 over
// bf16 scores; 64 for K4 / K7q at 512, whose bf16 V slice takes 64 KB), and the
// S of a 128-key tile is issued a sub-tile a turn into its part of the score
// registers, each sub-tile waited for, dequantized (its per-key scales with it)
// and released before the next (SmemI8 has every ring). The q^ descriptors are
// one descriptor plus constant offsets (k_step_offset, sm90.cuh): ptxas
// otherwise kept every k-step's in registers. ptxas past 256: no spill at D =
// 384; at 512 K8b over bf16 scores spills 416 bytes, K8a over them 164, K8b
// over K7q's 52 (the accumulator and the scores take 192 of 240 registers, and
// four sub-tiles' turns a tile); a rolled sub-tile loop (one copy of the S
// issue) spilled less but ran 1.5-1.9x slower (utils/wide_attention_diag.py,
// H100). What bounds them at B 2, N 1178, H 5, D 384 / 512: the products with
// QK^T twice, 0.0243 / 0.0324 ms (an s8 product half of its bf16 term; K8a over
// bf16 scores, QK^T four times, 0.0485 / 0.0647); the preps, 25-78 us of a call
// (q, k and V passes over (B, N, H*D) at 10 heads).
//
// D = 768 and 1024 (K4_768 .. K8B_1024: heads of 513 to 1024 values). Two
// slices of D / 2 columns would pass one wgmma's 256 and a consumer's
// registers, so the output is cut into four slices of DV = D / 4 (192 /
// 256 columns), and (PAIRED) an item is 64 query rows and one pair of
// slices (a grid dimension): its two consumers share one q^ tile, consumer
// c writes slice 2 * pair + c, and the V stages hold the pair's 2 * DV
// columns (attention_sm90.cu's layout past 256). Two q^ tiles of 128 rows,
// as below D = 768, would not fit beside any K tile: a bf16 q^ of 64 rows
// is 96 / 128 KB. Each consumer computes the scores over the whole head,
// so QK^T runs once per slice, four times, and every slice sees the same S
// in the same order: the levels, the max and l agree bit for bit across
// the four. The key tiles stay 128 keys (the quantization). A K tile of the
// whole head would not fit twice beside q^, and K sub-tiles of few keys
// make narrow score wgmmas that read their 2 KB of q^ from shared memory
// for 16 or 32 keys (an earlier version of these instances: 16-key bf16 /
// 32-key s8 sub-tiles, K8a over bf16 scores 462 us at B 2, N 1178, H 2, D
// 768; PERF.md). So the K ring holds CHUNKS of a tile: its 128 keys by
// KCOLS = 128 bytes of the head (64 bf16 or 128 int8 values, 16 KB), the S
// of a tile issued a chunk a turn (four wgmma m64n128k16 bf16 / m64n128k32
// s8 into the tile's 64 score registers, each chunk waited for and
// released before the next turn; K7q's per-key scales come with a tile's
// last chunk, dequantized before it is released). bf16 V (K4, K7q) comes
// in sub-tiles of VSUB = 32 keys, the P.V of a 128-key tile issued over
// its four sub-tiles, one in flight behind the next one's issue; the int8
// V^T tile (DV rows a box, two boxes a pair) stays whole. SmemI8 has the
// stages. What bounds them at B 2, N 1178, H 2, D 768 / 1024: the bf16
// products with QK^T four times, 0.0431 / 0.0575 ms at 989 TFLOP/s (an s8
// product half of its bf16 term; the minimal 0.0172 / 0.0230); 152 items
// on 132 SMs.

#include <limits.h>

#include <type_traits>

#include "attention_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int KEY_TILE = 128;               // keys per K / V tile
constexpr int QROWS = 64;                   // query rows per consumer
constexpr int CONSUMERS = 2;                // consumer warpgroups per block
constexpr int BLOCK_Q = QROWS * CONSUMERS;  // query rows per block
constexpr int WG = 128;                     // threads per warpgroup
constexpr int INT8_THREADS = WG * (1 + CONSUMERS);
// named barriers (0 is __syncthreads): TURN + c, consumer c's turn to issue
// its products
constexpr int TURN = 1;
// 384 threads x 168 registers at launch; the producer gives back down to
// 24 and the consumers take 240 (setmaxnreg), as in attention_sm90.cu
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

// x + 0x1.8p23 rounds x (|x| < 2^22) to an integer, half to even, in its
// low mantissa bits; the bits of 0x1.8p23
constexpr float ROUND_MAGIC = 12582912.f;
constexpr int ROUND_MAGIC_BITS = 0x4B400000;

// fp32(x) of an s32 |x| < 2^22, exactly, on the FMA pipe
__device__ __forceinline__ float i2f(int x) {
  return __fsub_rn(__int_as_float(x + ROUND_MAGIC_BITS), ROUND_MAGIC);
}

// round-half-even(x) of four x in [0, 127.5), as bytes, low byte first.
// pb = exp2(s - (m - log2 127)) with s <= m is at most 127 up to ex2's and
// the shift's rounding (relative ~1e-6), so the plain version's clip to
// 127 changes no level and is left out here.
__device__ __forceinline__ uint32_t pack_levels(float a, float b, float c,
                                                float d) {
  auto r = [](float x) { return __float_as_uint(__fadd_rn(x, ROUND_MAGIC)); };
  return __byte_perm(__byte_perm(r(a), r(b), 0x0040),
                     __byte_perm(r(c), r(d), 0x0040), 0x5410);
}

// a score register: fp32, or (int8 QK^T) the s32 of the product, then the
// bits of its dequantized fp32 value
__device__ __forceinline__ float f_of(float x) { return x; }
__device__ __forceinline__ float f_of(int x) { return __int_as_float(x); }
__device__ __forceinline__ void set_f(float& d, float v) { d = v; }
__device__ __forceinline__ void set_f(int& d, float v) { d = __float_as_int(v); }

// The rows of a q^ or K tile: D bf16 values, or D int8 values zero-padded
// to DQ = max(D, 32) bytes (one s8 k-step), in the swizzle of the rows'
// byte width (SwizzledRows of as many bf16 values as half the bytes), read
// by desc_k_major<BYTES / 2> one 32-byte k-step at a time.
template <int D, bool QK8>
struct Rows {
  static constexpr int ELEM = QK8 ? 1 : 2;
  static constexpr int BYTES = QK8 ? (D < 32 ? 32 : D) : 2 * D;
  static constexpr int HALF = BYTES / 2;
  static constexpr int W = SwizzledRows<HALF>::W;
  static constexpr int COLS = SwizzledRows<HALF>::COLS;
  static constexpr int KSTEPS = BYTES / 32;
};

// Shared memory of attn_int8_sm90_kernel<D, QK8, PV8, TWO_PASS>, from a
// 1024-byte aligned base. KST stages of K sub-tiles (KSUB keys: KEY_TILE,
// or fewer where two tiles of a whole bf16 head would not fit; past 512
// chunks of KCOLS bytes of the head) and VST of V tiles (a slice of DV
// columns past D = 256, a pair of them past 512; bf16 V past 512 in
// sub-tiles of VSUB keys): four each up to D = 64,
// three at D = 128; from D = 256 on what fits 227 KB beside the q^ tiles.
// At D = 256 (K tiles of 32 KB in int8, 64 KB in bf16; V tiles of 32 KB in
// int8 V^T, 64 KB in bf16): 2 + 2 (K4, K7q), 3 + 3 (int8 P.V over int8
// scores), 2 + 1 (int8 P.V over bf16 scores, whose q^ takes 64 KB). At D =
// 384 (q^ 48 KB int8, 96 KB bf16): 2 + 1 (K4, K7q: 48 KB K, 48 KB bf16 V
// slices), 2 + 2 (int8 P.V over int8 scores: 48 KB K, 24 KB V^T slices), 2
// + 1 (over bf16 scores: 64-key K sub-tiles of 48 KB). At D = 512 (q^ 64
// KB int8, 128 KB bf16): 3 + 1 (K4, K7q: 64-key K sub-tiles of 32 KB, 64
// KB V slices), 2 + 1 (int8 P.V over int8 scores: 64 KB K, 32 KB V^T), 2 +
// 1 (over bf16 scores: 32-key sub-tiles of 32 KB). Past 512 (PAIRED: one
// q^ tile of 64 rows, 48 / 64 KB int8, 96 / 128 KB bf16; K chunks of 16 KB)
// at D = 768: 4 + 4 (K4, K7q: 32-key V sub-tiles of the pair's 384 columns,
// 24 KB), 4 + 2 (int8 P.V over int8 scores: V^T 48 KB), 5 + 1 (over bf16
// scores); at 1024: 2 + 4 (K4, K7q: 32 KB V sub-tiles, a tile's four in
// the ring, as a consumer issues them in one turn), 6 + 1 (int8 P.V over
// K4's scores; over K7q's 5 + 1: V^T 64 KB), 2 + 1 (over bf16 scores: 128
// KB of q^ and 64 KB of V^T).
template <int D, bool QK8, bool PV8, bool TWO_PASS>
struct SmemI8 {
  using R = Rows<D, QK8>;
  // int8 scores of the streaming kernels: a k scale per key, beside each K
  // sub-tile
  static constexpr bool PER_KEY = QK8 && !TWO_PASS;
  // past D = 512 an item is 64 query rows whose two consumers share one q^
  // tile (see "D = 768 and 1024" above); below, 128 rows, 64 a consumer
  static constexpr bool PAIRED = D > 512;
  static constexpr int ROWS = PAIRED ? QROWS : BLOCK_Q;  // an item's rows
  static constexpr int Q_TILES = PAIRED ? 1 : CONSUMERS;
  // a consumer's output columns: past D = 256 one of two slices, past 512
  // one of four; and an item's (its V tiles'): a pair of them past 512
  static constexpr int DV = D > 512 ? D / 4 : D > 256 ? D / 2 : D;
  static constexpr int VCOLS = PAIRED ? 2 * DV : DV;
  // keys of a K sub-tile: the S of a KEY_TILE-key tile is issued a
  // sub-tile a turn; past 512 a chunk of KCOLS bytes of each row a turn,
  // KCH chunks a tile (up to 512: KCOLS the whole row, one chunk)
  static constexpr int KSUB = D <= 256 || D > 512 ? KEY_TILE
                              : !QK8 ? (D == 384 ? 64 : 32)
                              : !PV8 && D == 512 ? 64 : KEY_TILE;
  static constexpr int KCOLS = PAIRED ? 128 : R::BYTES;
  static constexpr int KCH = R::BYTES / KCOLS;
  // keys of a V sub-tile: bf16 V past 512 in sub-tiles, the P.V of a tile
  // issued over them
  static constexpr int VSUB = PAIRED && !PV8 ? 32 : KEY_TILE;
  static constexpr int KST = D <= 64 ? 4 : D == 128 ? 3
                             : D == 256 ? (QK8 && PV8 ? 3 : 2)
                             : D > 512 ? (QK8 ? (D == 768 ? 4
                                                 : !PV8 ? 2
                                                 : PER_KEY ? 5 : 6)
                                          : D == 768 ? 5 : 2)
                             : !QK8 ? 2
                             : !PV8 && D == 512 ? 3 : 2;
  static constexpr int VST = D <= 64 ? 4 : D == 128 ? 3
                             : D == 256 ? (QK8 ? (PV8 ? 3 : 2) : 1)
                             : D > 512 ? (!PV8 ? 4 : QK8 && D == 768 ? 2 : 1)
                             : QK8 && PV8 && D == 384 ? 2 : 1;
  static constexpr int Q_TILE = QROWS * R::BYTES;    // one consumer's q^
  static constexpr int K_TILE = KSUB * KCOLS;        // one K sub-tile
  // int8 V^T: VCOLS rows of KEY_TILE bytes (128-byte swizzle); or bf16 V:
  // VSUB rows of VCOLS values (SwizzledRows<VCOLS>)
  static constexpr int V_TILE = PV8 ? VCOLS * KEY_TILE : VSUB * VCOLS * 2;
  static constexpr int KS_TILE = PER_KEY ? KSUB * 4 : 0;  // k scales
  static constexpr int Q = 0;                                // [Q_TILES]
  static constexpr int K = Q + Q_TILES * Q_TILE;             // [KST]
  static constexpr int V = K + KST * K_TILE;                 // [VST]
  static constexpr int KS = V + VST * V_TILE;                // [KST]
  // mbarriers: full / empty of each K and V stage, full / empty of each q^
  // tile
  static constexpr int BAR = KS + KST * KS_TILE;
  static constexpr int BYTES =
      BAR + (2 * KST + 2 * VST + 2 * CONSUMERS) * 8 + 1024;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// TMA of ROWS rows (n0.., head h, sample b) of a q^ or K tensor into a tile
// at `dst`, one box per atom column (Rows), NC of them from atom column c0
// on (every column of the row by default).
template <int D, bool QK8, int ROWS, int NC = Rows<D, QK8>::COLS>
__device__ __forceinline__ void load_rows(uint32_t dst, const CUtensorMap* m,
                                          uint32_t bar, int h, int n0, int b,
                                          int c0 = 0) {
  using R = Rows<D, QK8>;
#pragma unroll
  for (int c = 0; c < NC; ++c)
    tma_load_4d(dst + c * ROWS * R::W, m, bar, (c0 + c) * R::W / R::ELEM, h,
                n0, b);
}

// grid: min(SMs, items) persistent CTAs, each walking items (ROWS query
// rows and VCOLS output columns: one slice of DV, or past D = 512 a pair;
// head, sample; column groups, then q tiles fastest) i, i + grid, ...;
// INT8_THREADS threads, SmemI8<D, QK8, PV8, TWO_PASS>::BYTES of dynamic
// shared memory. tm_q, tm_k: tensor maps of q^ and k^ (int8 with QK8, else
// bf16; encode_heads); tm_v: of bf16 v (K4, K7q) or of int8 V^T (B*H*D,
// NP) (K8a, K8b); tm_ks: of the per-key
// k scales, (B*H, NP) fp32 (K7q, K8b over K7q; else unused). q_scale (B*H,
// N): q^'s per-row scales (QK8); k_amax (B*H): max |bf16(k^)| (K4, K8a
// over K4); v_amax (B*H, D) (PV8); o (B, N, H*D) bf16.
template <int D, bool QK8, bool PV8, bool TWO_PASS>
__global__ void __launch_bounds__(INT8_THREADS, 1)
attn_int8_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_ks,
                      const float* __restrict__ q_scale,
                      const float* __restrict__ k_amax,
                      const float* __restrict__ v_amax, bf16* __restrict__ o,
                      int N, int H, int B) {
  using S = SmemI8<D, QK8, PV8, TWO_PASS>;
  using R = Rows<D, QK8>;
  static_assert(QK8 || PV8, "the bf16 kernels are attention_sm90.cu's");
  constexpr bool PER_KEY = S::PER_KEY;
  constexpr int KST = S::KST, VST = S::VST;
  // a consumer's and an item's columns, and an item's column groups
  constexpr int DV = S::DV, VCOLS = S::VCOLS, GROUPS = D / VCOLS;
  constexpr int ROWS = S::ROWS;
  // K sub-tiles of KSUB keys, SUB of them a key tile, each in KCH chunks
  // of the head; V sub-tiles of VSUB keys, VSUBS of them a key tile
  constexpr int KSUB = S::KSUB, SUB = KEY_TILE / KSUB, KCH = S::KCH;
  constexpr int VSUB = S::VSUB, VSUBS = KEY_TILE / VSUB;
  // a consumer issues a tile's V sub-tiles in one turn: all of them must
  // fit the ring, since the other consumer frees each only in its own turn
  static_assert(VSUBS <= VST, "V sub-tiles of a tile");
  // from D = 256 on: the consumers' P.V lands before their next S is
  // issued (the registers; see "D = 256" above), and K8b's in PV_PARTS
  // column parts of 64
  constexpr bool WIDE = D >= 256;
  constexpr bool CHUNKED = WIDE && PV8 && !TWO_PASS;
  constexpr int PV_PARTS = DV / 64;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full_k = sb + S::BAR, full_v = full_k + 8 * KST;
  const uint32_t empty_k = full_v + 8 * VST, empty_v = empty_k + 8 * KST;
  const uint32_t full_q = empty_v + 8 * VST;
  const uint32_t empty_q = full_q + 8 * CONSUMERS;
  const int ntiles = (N + KEY_TILE - 1) / KEY_TILE;
  // K and V ring sub-tiles of an item
  const int k_per_item = (TWO_PASS ? 2 : 1) * ntiles * SUB * KCH;
  const int v_per_item = ntiles * VSUBS;
  const int nqs = (N + ROWS - 1) / ROWS * GROUPS;  // (q tile, group)s
  const int n_items = nqs * H * B;
  const int n_local = (int)blockIdx.x < n_items
                          ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                          : 0;
  // (q tile, column group, head, sample) of this CTA's local item j,
  // groups, then q tiles fastest
  auto item_of = [&](int j, int& qt, int& sl, int& h, int& b) {
    const int it = blockIdx.x + j * gridDim.x;
    qt = it % nqs / GROUPS;
    sl = it % GROUPS;
    h = it / nqs % H;
    b = it / (nqs * H);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < KST; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(empty_k + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
    }
    for (int s = 0; s < VST; ++s) {
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty_v + 8 * s, CONSUMERS * 4);
    }
    for (int c = 0; c < CONSUMERS; ++c) {
      mbar_init(full_q + 8 * c, 1);
      // lane 0 of each warp of consumer c (PAIRED: of both, tile 0)
      mbar_init(empty_q + 8 * c, S::PAIRED ? 4 * CONSUMERS : 4);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // ---- producer: one thread loads the q^ tiles, then keeps the rings full
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_q);
      tma_prefetch(&tm_k);
      tma_prefetch(&tm_v);
      if constexpr (PER_KEY) tma_prefetch(&tm_ks);
      for (int ji = 0; ji < n_local; ++ji) {
        int qt, sl, h, b;
        item_of(ji, qt, sl, h, b);
        const int bh = b * H + h;
        for (int c = 0; c < S::Q_TILES; ++c) {  // once the last item's is done
          mbar_wait(empty_q + 8 * c, (ji & 1) ^ 1);
          mbar_arrive_expect_tx(full_q + 8 * c, S::Q_TILE);
          load_rows<D, QK8, QROWS>(sb + S::Q + c * S::Q_TILE, &tm_q,
                                   full_q + 8 * c, h,
                                   qt * ROWS + c * QROWS, b);
        }
        // chunk ch of the KSUB keys from key n0 on into the K ring's stage
        // kc; with the last chunk their per-key scales
        constexpr int KNC = S::KCOLS / R::W;  // atom columns of a chunk
        auto load_k = [&](int kc, int n0, int ch) {
          const int s = kc % KST;
          const bool scales = PER_KEY && ch == KCH - 1;
          mbar_wait(empty_k + 8 * s, ((kc / KST) & 1) ^ 1);
          mbar_arrive_expect_tx(full_k + 8 * s,
                                S::K_TILE + (scales ? S::KS_TILE : 0));
          load_rows<D, QK8, KSUB, KNC>(sb + S::K + s * S::K_TILE, &tm_k,
                                       full_k + 8 * s, h, n0, b, ch * KNC);
          if (scales)
            tma_load_2d(sb + S::KS + s * S::KS_TILE, &tm_ks, full_k + 8 * s,
                        n0, bh);
        };
        const int kbase = ji * k_per_item, vbase = ji * v_per_item;
        if constexpr (TWO_PASS)
          for (int i = 0; i < ntiles * SUB; ++i)
            for (int ch = 0; ch < KCH; ++ch)
              load_k(kbase + i * KCH + ch, i * KSUB, ch);
        const int k2 = kbase + (TWO_PASS ? ntiles * SUB * KCH : 0);
        for (int t = 0; t < ntiles; ++t) {
          for (int u = 0; u < SUB; ++u)
            for (int ch = 0; ch < KCH; ++ch)
              load_k(k2 + (t * SUB + u) * KCH + ch,
                     t * KEY_TILE + u * KSUB, ch);
          for (int u = 0; u < VSUBS; ++u) {
            const int vc = vbase + t * VSUBS + u, s = vc % VST;
            mbar_wait(empty_v + 8 * s, ((vc / VST) & 1) ^ 1);
            mbar_arrive_expect_tx(full_v + 8 * s, S::V_TILE);
            const uint32_t dst = sb + S::V + s * S::V_TILE;
            if constexpr (PV8) {  // this item's VCOLS rows of V^T, DV a box
#pragma unroll
              for (int c = 0; c < VCOLS / DV; ++c)
                tma_load_2d(dst + c * DV * KEY_TILE, &tm_v, full_v + 8 * s,
                            t * KEY_TILE, bh * D + sl * VCOLS + c * DV);
            } else {  // VSUB keys of this item's VCOLS columns of V
              using SV = SwizzledRows<VCOLS>;
#pragma unroll
              for (int c = 0; c < SV::COLS; ++c)
                tma_load_4d(dst + c * VSUB * SV::W, &tm_v, full_v + 8 * s,
                            sl * VCOLS + c * SV::W / 2, h,
                            t * KEY_TILE + u * VSUB, b);
            }
          }
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each (PAIRED: the same rows, and DV
    // columns each, vcol on in the item's VCOLS)
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int qc = S::PAIRED ? 0 : c;  // this consumer's q^ tile
    const int vcol = S::PAIRED ? c * DV : 0;
    // this consumer's part of a V stage: vcol rows of V^T, or vcol / 64
    // atom columns of bf16 V
    const uint32_t voff = PV8 ? vcol * KEY_TILE : vcol / 64 * VSUB * 128;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const uint32_t q_base = sb + S::Q + qc * S::Q_TILE;
    using Score = typename std::conditional<QK8, int, float>::type;
    Score s[KEY_TILE / 2];  // scores, then p, of one tile
    // the A fragments of the P.V steps: bf16 p (8 steps of 16 keys) or
    // int8 pq (4 steps of 32)
    constexpr int NP = PV8 ? KEY_TILE / 8 : KEY_TILE / 4;
    uint32_t p[NP];
    // K8b: the next tile's levels, packed under the P.V that reads p
    uint32_t pn[NP];
    float acc[DV / 2];
    // the s32 P.V: K8a's sum over every key; one tile's (K8b), from D = 256
    // on one PV_PARTS-th of its columns
    constexpr int PVN = !PV8 ? 1 : CHUNKED ? DV / 2 / PV_PARTS : DV / 2;
    int pv[PVN];
#pragma unroll
    for (int i = 0; i < KEY_TILE / 2; ++i) s[i] = 0;
#pragma unroll
    for (int i = 0; i < PVN; ++i) pv[i] = 0;

    // Ping-pong, as in attention_sm90.cu: named barriers TURN + c, each met
    // by this consumer's sync and the other's arrive; consumer 0 goes
    // first; consumer 1 does not hand over after its last turn.
    const int my_turn = TURN + c, other_turn = TURN + 1 - c;
    if (c == 1) named_bar_arrive(other_turn, 2 * WG);
    auto take_turn = [&]() { named_bar_sync(my_turn, 2 * WG); };
    auto hand_over = [&]() { named_bar_arrive(other_turn, 2 * WG); };

    for (int ji = 0; ji < n_local; ++ji) {
      int qt, sl, h, b;
      item_of(ji, qt, sl, h, b);
      const int bh = b * H + h;
      const int kbase = ji * k_per_item, vbase = ji * v_per_item;
      // the scoring pass's first K stage
      const int k2 = kbase + (TWO_PASS ? ntiles * SUB * KCH : 0);
      const int n0 = qt * ROWS + qc * QROWS + warp * 16 + g;
      const int n1 = n0 + 8;                   // this thread's two rows

      // the dequantization of rows n0, n1: s_q, times s_k for K4 (rows past
      // N: q^ = 0, any scale)
      float qs0 = 0.f, qs1 = 0.f;
      if constexpr (QK8) {
        const float* qsr = q_scale + (size_t)bh * N;
        if (n0 < N) qs0 = qsr[n0];
        if (n1 < N) qs1 = qsr[n1];
        if constexpr (TWO_PASS) {  // one k scale per (b, h)
          const float ks = fmaxf(k_amax[bh], 1e-12f) / 127.f;
          qs0 *= ks;
          qs1 *= ks;
        }
      }
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
      float kx0 = 0.f, kx1 = 0.f;  // K4: the exponent's shift (dequant)
      mbar_wait(full_q + 8 * qc, ji & 1);  // this consumer's q^ tile has landed

      // issue S = q^ k^T of the K ring's stage kc, chunk ch of sub-tile u
      // of its key tile, into (adding to, past chunk 0) that sub-tile's
      // score registers
      auto issue_scores = [&](int kc, int u, int ch) {
        const int st = kc % KST;
        mbar_wait(full_k + 8 * st, (kc / KST) & 1);
        const uint32_t kb = sb + S::K + st * S::K_TILE;
        wgmma_fence();
#pragma unroll
        for (int uu = 0; uu < SUB; ++uu) {
          if (uu != u) continue;
          Score(&su)[KSUB / 2] =
              *reinterpret_cast<Score(*)[KSUB / 2]>(s + uu * (KSUB / 2));
          // past D = 256 k-step 0's descriptors plus each k-step's offset,
          // q^'s made opaque to the loop (k_step_offset, sm90.cuh); the
          // chunk's k-steps, KCH of a row's, from k-step ch * CK of q^
          constexpr int CK = S::KCOLS / 32, KH = S::KCOLS / 2;
          uint64_t dq = desc_k_major<R::HALF>(q_base, QROWS, 0);
          const uint64_t dk = desc_k_major<KH>(kb, KSUB, 0);
          if constexpr (D > 256) asm volatile("" : "+l"(dq));
#pragma unroll
          for (int kk = 0; kk < CK; ++kk) {
            const uint64_t da =
                D > 256 ? dq + k_step_offset<R::HALF>(QROWS, ch * CK + kk)
                        : desc_k_major<R::HALF>(q_base, QROWS, kk);
            const uint64_t db =
                D > 256 ? dk + k_step_offset<KH>(KSUB, kk)
                        : desc_k_major<KH>(kb, KSUB, kk);
            if constexpr (QK8) wgmma_s8<KSUB>(su, da, db, ch > 0 || kk > 0);
            else wgmma_ss<KSUB>(su, da, db, ch > 0 || kk > 0);
          }
        }
        wgmma_commit();
      };
      // this consumer's part of the V stage of key tile t's sub-tile u,
      // once it has landed
      auto v_stage = [&](int t, int u) {
        const int vc = vbase + t * VSUBS + u, st = vc % VST;
        mbar_wait(full_v + 8 * st, (vc / VST) & 1);
        return sb + S::V + st * S::V_TILE + voff;
      };
      // issue P.V of key tile t (this consumer's DV columns; one V stage a
      // tile, VSUBS = 1), its A fragments in pa: K4, K7q acc += bf16(p) v;
      // K8b pv = pq v_q; K8a pv += pq v_q (one s32 sum over every key: its p
      // is against the true row max, so there is no rescale)
      auto issue_pv = [&](int t, const uint32_t (&pa)[NP]) {
        const uint32_t vb = v_stage(t, 0);
        wgmma_fence();
        if constexpr (CHUNKED) {
          // run_pv issues K8b's parts itself
        } else if constexpr (PV8) {
#pragma unroll
          for (int kk = 0; kk < KEY_TILE / 32; ++kk) {
            const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1],
                                   pa[4 * kk + 2], pa[4 * kk + 3]};
            wgmma_s8_rs<DV>(pv, a, desc_s8(vb, kk),
                            kk > 0 || (TWO_PASS && t > 0));
          }
        } else {
#pragma unroll
          for (int kk = 0; kk < KEY_TILE / 16; ++kk) {
            const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1],
                                   pa[4 * kk + 2], pa[4 * kk + 3]};
            wgmma_rs<DV>(acc, a, desc_mn_major<DV>(vb, KEY_TILE, kk), 1);
          }
        }
        wgmma_commit();
      };
      // this warp is done with a stage of K (the K ring's sub-tile kc) or
      // of V (key tile t's sub-tile u, or all of its sub-tiles), or with its
      // q^ tile
      auto release_k = [&](int kc) {
        if (lane == 0) mbar_arrive(empty_k + 8 * (kc % KST));
      };
      auto release_vsub = [&](int t, int u) {
        if (lane == 0)
          mbar_arrive(empty_v + 8 * ((vbase + t * VSUBS + u) % VST));
      };
      auto release_v = [&](int t) {
#pragma unroll
        for (int u = 0; u < VSUBS; ++u) release_vsub(t, u);
      };
      auto release_q = [&]() {
        if (lane == 0) mbar_arrive(empty_q + 8 * qc);
      };
      // int8 scores of the K ring's sub-tile kc, sub-tile u of its key tile,
      // dequantized in place. K4: the
      // exponent's argument s - max = s32 * (s_q s_k) - max, as one FFMA on
      // the biased bits b = bits(s32 + 0x4B400000) = s32 + 0x1.8p23:
      // b * (s_q s_k) + kx, kx = -(0x1.8p23 * (s_q s_k) + max) rounded once
      // per row, an error that is the same for every key of the row and
      // scales all its p alike (cancelling in acc / l but for p's bf16
      // rounding). K8a over K4's scores: s32 * (s_q s_k), as its plain
      // version rounds it, since its levels round p itself. K8b over K7q:
      // s32 * s_q * s_k[key] (the TPU kernel's order). K7q: t = s32 *
      // s_k[key] only; the softmax takes s_q in its max and in the FFMA of
      // each exp2's argument, fma(t, s_q, -m), one multiply a score fewer
      // (rounded once where the plain version rounds s = (s32 s_q) s_k and
      // then s - m: p moves by ~1e-7 relative, far below its bf16
      // rounding). The per-key scales are read before the stage is
      // released.
      auto dequant = [&](int kc, int u) {
        if constexpr (TWO_PASS && !PV8) {
#pragma unroll
          for (int i = 0; i < KEY_TILE / 2; ++i) {
            if (i / (KSUB / 2) != u) continue;
            set_f(s[i], fmaf(__int_as_float(s[i] + ROUND_MAGIC_BITS),
                             (i & 2) ? qs1 : qs0, (i & 2) ? kx1 : kx0));
          }
        } else if constexpr (QK8) {
          const float* ks = reinterpret_cast<const float*>(
              smem + S::KS + (kc % KST) * S::KS_TILE);
#pragma unroll
          for (int j = 0; j < KEY_TILE / 8; ++j) {
            if (j / (KSUB / 8) != u) continue;
            float k0 = 1.f, k1 = 1.f;
            if constexpr (PER_KEY) {
              const float2 kk = *reinterpret_cast<const float2*>(
                  ks + (j % (KSUB / 8)) * 8 + t4 * 2);
              k0 = kk.x;
              k1 = kk.y;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if constexpr (PV8 || TWO_PASS)
                set_f(s[4 * j + e],
                      i2f(s[4 * j + e]) * (e < 2 ? qs0 : qs1) * ((e & 1) ? k1 : k0));
              else
                set_f(s[4 * j + e], i2f(s[4 * j + e]) * ((e & 1) ? k1 : k0));
            }
          }
        }
      };
      // padded keys of the ragged last tile (zero rows of the TMA box,
      // which score 0) to -inf, so that exp2 gives them p = 0: one branch a
      // tile, ahead of the unrolled arithmetic
      auto mask = [&](int t) {
        const int k0 = t * KEY_TILE;
        if (k0 + KEY_TILE > N) {
#pragma unroll
          for (int j = 0; j < KEY_TILE / 8; ++j) {
            const int col = k0 + j * 8 + t4 * 2;
            if (col >= N) {
              set_f(s[4 * j], -INFINITY);
              set_f(s[4 * j + 2], -INFINITY);
            }
            if (col + 1 >= N) {
              set_f(s[4 * j + 1], -INFINITY);
              set_f(s[4 * j + 3], -INFINITY);
            }
          }
        }
      };
      // s -> p in place: K4 p = exp2 of the argument dequant shifted by
      // pass 1's row max; K8a pb = exp2(s - (m - log2 127)) against pass 1's
      // row max m; K7q, K8b the running max m (alpha of rows g, g + 8 in a0,
      // a1), p = exp2(s - m) (K7q) or pb = exp2(s - (m - log2 127)) (K8b); l
      // the sums of the unrounded p
      auto softmax = [&](float& a0, float& a1) {
        float sh0 = 0.f, sh1 = 0.f;  // K4: the argument is shifted (dequant)
        // K7q's deferred s_q of rows g, g + 8 (see dequant); 1 elsewhere,
        // where fma(x, 1, -sh) is x - sh
        constexpr bool DEFER_Q = QK8 && !PV8 && !TWO_PASS;
        const float f0 = DEFER_Q ? qs0 : 1.f, f1 = DEFER_Q ? qs1 : 1.f;
        if constexpr (TWO_PASS && PV8) {
          sh0 = m0 - LOG2_127;
          sh1 = m1 - LOG2_127;
        } else if constexpr (!TWO_PASS) {
          constexpr int PARTS = 4;  // shorter chains for the exp2s to wait on
          float x0[PARTS], x1[PARTS];
#pragma unroll
          for (int i = 0; i < PARTS; ++i) {
            x0[i] = fmaxf(f_of(s[4 * i]), f_of(s[4 * i + 1]));
            x1[i] = fmaxf(f_of(s[4 * i + 2]), f_of(s[4 * i + 3]));
          }
#pragma unroll
          for (int j = PARTS; j < KEY_TILE / 8; ++j) {
            x0[j % PARTS] = fmaxf(x0[j % PARTS],
                                  fmaxf(f_of(s[4 * j]), f_of(s[4 * j + 1])));
            x1[j % PARTS] = fmaxf(
                x1[j % PARTS], fmaxf(f_of(s[4 * j + 2]), f_of(s[4 * j + 3])));
          }
          float mx0 = x0[0], mx1 = x1[0];
#pragma unroll
          for (int i = 1; i < PARTS; ++i) {
            mx0 = fmaxf(mx0, x0[i]);
            mx1 = fmaxf(mx1, x1[i]);
          }
          // every row sees key 0 in tile 0, so the running max is finite
          // from there on and exp2(-inf - finite) = 0 clears the empty start
          // (K7q: the max of t times s_q > 0, the max of the scores)
          const float mn0 = fmaxf(m0, quad_max(mx0) * f0);
          const float mn1 = fmaxf(m1, quad_max(mx1) * f1);
          a0 = fast_exp2(m0 - mn0);
          a1 = fast_exp2(m1 - mn1);
          m0 = mn0;
          m1 = mn1;
          l0 *= a0;
          l1 *= a1;
          sh0 = PV8 ? m0 - LOG2_127 : m0;
          sh1 = PV8 ? m1 - LOG2_127 : m1;
        }
#pragma unroll
        for (int j = 0; j < KEY_TILE / 8; ++j) {
          auto e2 = [&](Score x, float f, float sh) {
            if constexpr (TWO_PASS && !PV8) return fast_exp2(f_of(x));
            else return fast_exp2(fmaf(f_of(x), f, -sh));
          };
          const float p0 = e2(s[4 * j], f0, sh0), p1 = e2(s[4 * j + 1], f0, sh0);
          const float p2 = e2(s[4 * j + 2], f1, sh1), p3 = e2(s[4 * j + 3], f1, sh1);
          set_f(s[4 * j], p0);
          set_f(s[4 * j + 1], p1);
          set_f(s[4 * j + 2], p2);
          set_f(s[4 * j + 3], p3);
          l0 += p0 + p1;
          l1 += p2 + p3;
        }
      };
      // p -> the A fragments in dst: bf16 pairs (K4), or int8 levels of
      // four keys in v_perm's order: groups 4kk, 4kk + 1 (then 4kk + 2,
      // 4kk + 3) of rows g and g + 8 (K8b)
      auto pack_p = [&](uint32_t (&dst)[NP]) {
        if constexpr (PV8) {
#pragma unroll
          for (int kk = 0; kk < KEY_TILE / 32; ++kk) {
            auto q = [&](int i) { return f_of(s[16 * kk + i]); };
            dst[4 * kk] = pack_levels(q(0), q(1), q(4), q(5));
            dst[4 * kk + 1] = pack_levels(q(2), q(3), q(6), q(7));
            dst[4 * kk + 2] = pack_levels(q(8), q(9), q(12), q(13));
            dst[4 * kk + 3] = pack_levels(q(10), q(11), q(14), q(15));
          }
        } else {
#pragma unroll
          for (int i = 0; i < KEY_TILE / 4; ++i)
            dst[i] = pack_bf16(f_of(s[2 * i]), f_of(s[2 * i + 1]));
        }
      };
      // K8b: acc = acc * alpha + fp32(pv), one FFMA, with the alpha of the
      // tile whose pv has just landed (a0p, a1p: the tile before the one
      // whose softmax has run). K8a sums pv in s32 over every key instead.
      float a0p = 0.f, a1p = 0.f;
      auto add_pv = [&]() {
        if constexpr (PV8 && !TWO_PASS && !CHUNKED) {
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            acc[4 * j] = fmaf(acc[4 * j], a0p, i2f(pv[4 * j]));
            acc[4 * j + 1] = fmaf(acc[4 * j + 1], a0p, i2f(pv[4 * j + 1]));
            acc[4 * j + 2] = fmaf(acc[4 * j + 2], a1p, i2f(pv[4 * j + 2]));
            acc[4 * j + 3] = fmaf(acc[4 * j + 3], a1p, i2f(pv[4 * j + 3]));
          }
        }
      };

      // S of a key tile from the K ring's stages kc0 .. kc0 + SUB * KCH -
      // 1 (SUB sub-tiles of KCH chunks), each issued in a turn of its own,
      // waited for and released, a sub-tile dequantized (`deq`) once its
      // last chunk has landed; `pre` issues what goes before the first in
      // its turn
      auto score_tile = [&](int kc0, bool deq, auto&& pre) {
#pragma unroll
        for (int u = 0; u < SUB; ++u) {
#pragma unroll
          for (int ch = 0; ch < KCH; ++ch) {
            const int kc = kc0 + u * KCH + ch;
            take_turn();
            if (u == 0 && ch == 0) pre();
            issue_scores(kc, u, ch);
            hand_over();
            wgmma_wait<0>();
            reg_fence(s);
            if (deq && ch == KCH - 1) dequant(kc, u);
            release_k(kc);
          }
        }
      };
      auto nothing = [] {};

      if constexpr (TWO_PASS) {
        // pass 1: the true row max; of int8 scores as the integer max of the
        // s32 scores, of bf16 ones (K8a) as the max of the fp32 scores,
        // which pass 2's products repeat bit for bit
        int mx0 = INT_MIN, mx1 = INT_MIN;
        float fx0 = -INFINITY, fx1 = -INFINITY;
        for (int t = 0; t < ntiles; ++t) {
          score_tile(kbase + t * SUB * KCH, false, nothing);
          if constexpr (!QK8) {
            mask(t);
#pragma unroll
            for (int j = 0; j < KEY_TILE / 8; ++j) {
              fx0 = fmaxf(fx0, fmaxf(f_of(s[4 * j]), f_of(s[4 * j + 1])));
              fx1 = fmaxf(fx1, fmaxf(f_of(s[4 * j + 2]), f_of(s[4 * j + 3])));
            }
          } else {
            const int k0 = t * KEY_TILE;
            if (k0 + KEY_TILE > N) {
#pragma unroll
              for (int j = 0; j < KEY_TILE / 8; ++j) {
                const int col = k0 + j * 8 + t4 * 2;
                if (col >= N) s[4 * j] = s[4 * j + 2] = INT_MIN;
                if (col + 1 >= N) s[4 * j + 1] = s[4 * j + 3] = INT_MIN;
              }
            }
            int x0[4], x1[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              x0[i] = max(s[4 * i], s[4 * i + 1]);
              x1[i] = max(s[4 * i + 2], s[4 * i + 3]);
            }
#pragma unroll
            for (int j = 4; j < KEY_TILE / 8; ++j) {
              x0[j % 4] = max(x0[j % 4], max(s[4 * j], s[4 * j + 1]));
              x1[j % 4] = max(x1[j % 4], max(s[4 * j + 2], s[4 * j + 3]));
            }
            mx0 = max(mx0, max(max(x0[0], x0[1]), max(x0[2], x0[3])));
            mx1 = max(mx1, max(max(x1[0], x1[1]), max(x1[2], x1[3])));
          }
        }
#pragma unroll
        for (int o = 1; o <= 2; o <<= 1) {
          mx0 = max(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
          mx1 = max(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
        }
        if constexpr (!QK8) {
          m0 = quad_max(fx0);
          m1 = quad_max(fx1);
        } else {
          m0 = i2f(mx0) * qs0;  // = max over keys of fp32(s32) * (s_q * s_k)
          m1 = i2f(mx1) * qs1;
          kx0 = -__fadd_rn(__fmul_rn(ROUND_MAGIC, qs0), m0);
          kx1 = -__fadd_rn(__fmul_rn(ROUND_MAGIC, qs1), m1);
        }
      }

      float a0 = 1.f, a1 = 1.f;
      score_tile(k2, true, nothing);
      if (ntiles == 1) release_q();  // the item's last S = q^ k^T is done
      mask(0);
      softmax(a0, a1);
      a0p = a0;
      a1p = a1;
      pack_p(p);
      // One key tile t >= 1: S of tile t issued with P.V of tile t-1, whose
      // A fragments are in pi; the softmax; tile t's fragments packed into
      // pk. K8b packs its levels into the other buffer while that P.V reads
      // pi, in the block of the exp2s, whose latency the byte permutes fill;
      // the buffers alternate from tile to tile, two tiles a round (a copy
      // from one to the other let ptxas merge them and wait for the P.V
      // before packing). K4's bf16 pack, one instruction for two values,
      // writes pi after the wait.
      auto step = [&](int t, uint32_t (&pi)[NP], uint32_t (&pk)[NP]) {
        take_turn();
        issue_scores(k2 + t, 0, 0);  // S of tile t (one stage below 256) ...
        issue_pv(t - 1, pi);      // ... and P.V of tile t-1 on the tensor cores
        hand_over();
        wgmma_wait<1>();          // S of tile t done
        reg_fence(s);
        dequant(k2 + t, 0);
        release_k(k2 + t);
        if (t == ntiles - 1) release_q();
        mask(t);
        softmax(a0, a1);  // while P.V of tile t-1 and the other's run
        if constexpr (PV8) pack_p(pk);
        // The wait for that P.V behind a branch on the softmax's sums that
        // always takes the first arm, so that ptxas does not hoist it above
        // the softmax (see attention_sm90.cu).
        if (__shfl_sync(0xffffffffu, __float_as_uint(l0 + l1), 0) !=
            0xffffffffu) {
          wgmma_wait<0>();
        } else {
          wgmma_wait<0>();
          __trap();
        }
        reg_fence(acc);
        reg_fence(pi);
        reg_fence(pv);
        release_v(t - 1);
        add_pv();
        a0p = a0;
        a1p = a1;
        if constexpr (!PV8 && !TWO_PASS) {
          // K7q: the sums so far, against the last tile's running max, to
          // this tile's, before its P.V adds to them
#pragma unroll
          for (int j = 0; j < DV / 8; ++j) {
            acc[4 * j] *= a0;
            acc[4 * j + 1] *= a0;
            acc[4 * j + 2] *= a1;
            acc[4 * j + 3] *= a1;
          }
        }
        if constexpr (!PV8) pack_p(pk);
      };
      // the last tile's P.V, its fragments in pl
      auto last_pv = [&](uint32_t (&pl)[NP]) {
        take_turn();
        issue_pv(ntiles - 1, pl);
        if (c == 0 || ji + 1 < n_local) hand_over();
        wgmma_wait<0>();
        reg_fence(acc);
        reg_fence(pl);
        reg_fence(pv);
        release_v(ntiles - 1);
        add_pv();
      };
      // From D = 256 on: P.V of key tile t from the fragments in pa, waited
      // for and added before the caller issues anything more; the turn
      // handed over after the last issue where `hand`. K8b's PV_PARTS parts
      // of 64 columns go one after the other through pv, each added as acc
      // = acc * alpha + fp32(pv) once it has landed.
      auto run_pv = [&](int t, uint32_t (&pa)[NP], bool hand) {
        if constexpr (CHUNKED) {
          constexpr int PART = DV / PV_PARTS;  // columns of a part
          const uint32_t vb = v_stage(t, 0);
#pragma unroll
          for (int part = 0; part < PV_PARTS; ++part) {
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KEY_TILE / 32; ++kk) {
              const uint32_t a[4] = {pa[4 * kk], pa[4 * kk + 1],
                                     pa[4 * kk + 2], pa[4 * kk + 3]};
              wgmma_s8_rs<PART>(
                  pv, a, desc_s8(vb + part * PART * KEY_TILE, kk), kk > 0);
            }
            wgmma_commit();
            if (part == PV_PARTS - 1 && hand) hand_over();
            wgmma_wait<0>();
            reg_fence(pv);
            reg_fence(pa);
#pragma unroll
            for (int i = 0; i < PART / 2; ++i) {
              const int o = part * (PART / 2) + i;  // column group o / 4
              acc[o] = fmaf(acc[o], (i & 2) ? a1p : a0p, i2f(pv[i]));
            }
          }
          release_v(t);
        } else if constexpr (VSUBS > 1) {
          // bf16 V past D = 512 in VSUBS sub-tiles of VSUB keys, each
          // issued once it has landed and released once its P.V has run,
          // one sub-tile's product in flight behind the next one's issue
          // (the ring holds all of a tile's: the other consumer frees them
          // only in its own turn)
          constexpr int KV = VSUB / 16;  // k-steps of a sub-tile
#pragma unroll
          for (int u = 0; u < VSUBS; ++u) {
            const uint32_t vb = v_stage(t, u);
            wgmma_fence();
#pragma unroll
            for (int kk = 0; kk < KV; ++kk) {
              const int k = u * KV + kk;
              const uint32_t a[4] = {pa[4 * k], pa[4 * k + 1], pa[4 * k + 2],
                                     pa[4 * k + 3]};
              wgmma_rs<DV>(acc, a, desc_mn_major<DV>(vb, VSUB, kk), 1);
            }
            wgmma_commit();
            if (u == VSUBS - 1 && hand) hand_over();
            if (u > 0) {
              wgmma_wait<1>();
              release_vsub(t, u - 1);
            }
          }
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(pa);
          release_vsub(t, VSUBS - 1);
        } else {
          issue_pv(t, pa);
          if (hand) hand_over();
          wgmma_wait<0>();
          reg_fence(acc);
          reg_fence(pa);
          reg_fence(pv);
          release_v(t);
          add_pv();
        }
      };
      if constexpr (WIDE) {
        // From D = 256 on, one consumer's products in turn: P.V of tile t-1
        // issued and landed, then S of tile t (a sub-tile a turn), then its
        // softmax while the other consumer's products run (the ping-pong
        // alone overlaps them)
        for (int t = 1; t < ntiles; ++t) {
          score_tile(k2 + t * SUB * KCH, true,
                     [&] { run_pv(t - 1, p, false); });
          if (t == ntiles - 1) release_q();
          mask(t);
          softmax(a0, a1);
          if constexpr (!PV8 && !TWO_PASS) {  // K7q: acc to this tile's max
#pragma unroll
            for (int j = 0; j < DV / 8; ++j) {
              acc[4 * j] *= a0;
              acc[4 * j + 1] *= a0;
              acc[4 * j + 2] *= a1;
              acc[4 * j + 3] *= a1;
            }
          }
          a0p = a0;
          a1p = a1;
          pack_p(p);
        }
        take_turn();
        run_pv(ntiles - 1, p, c == 0 || ji + 1 < n_local);
        if constexpr (PV8 && TWO_PASS) {  // K8a: the s32 sum over every key
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) acc[i] = (float)pv[i];
        }
      } else if constexpr (PV8) {
        int t = 1;
        for (; t + 1 < ntiles; t += 2) {
          step(t, p, pn);
          step(t + 1, pn, p);
        }
        if (t < ntiles) {
          step(t, p, pn);
          last_pv(pn);
        } else {
          last_pv(p);
        }
        if constexpr (TWO_PASS) {  // K8a: the s32 sum over every key
#pragma unroll
          for (int i = 0; i < DV / 2; ++i) acc[i] = (float)pv[i];
        }
      } else {
        for (int t = 1; t < ntiles; ++t) step(t, p, p);
        last_pv(p);
      }

      // o = acc / l (K8a, K8b: times V's column scales) of this consumer's
      // columns, bf16, rows past N not stored
      l0 = quad_sum(l0);
      l1 = quad_sum(l1);
      const float inv0 = 1.f / l0, inv1 = 1.f / l1;
      const size_t rs = (size_t)H * D;
      bf16* oh = o + (size_t)b * N * rs + (size_t)h * D;
#pragma unroll
      for (int j = 0; j < DV / 8; ++j) {
        const int col = sl * VCOLS + vcol + j * 8 + t4 * 2;
        float v0 = 1.f, v1 = 1.f;
        if constexpr (PV8) {
          v0 = fmaxf(v_amax[(size_t)bh * D + col], 1e-12f) / 127.f;
          v1 = fmaxf(v_amax[(size_t)bh * D + col + 1], 1e-12f) / 127.f;
        }
        if (n0 < N)
          *reinterpret_cast<uint32_t*>(oh + (size_t)n0 * rs + col) =
              pack_bf16(acc[4 * j] * inv0 * v0, acc[4 * j + 1] * inv0 * v1);
        if (n1 < N)
          *reinterpret_cast<uint32_t*>(oh + (size_t)n1 * rs + col) =
              pack_bf16(acc[4 * j + 2] * inv1 * v0, acc[4 * j + 3] * inv1 * v1);
      }
    }
  }
}

// ---- host side ----------------------------------------------------------

// The scratch of the entry points (unused ones may be null):
//   q_prep: (B, N, H*D) q^, int8 with int8 scores, else bf16;
//   q_scale: (B*H, N) fp32, q^'s per-row scales (int8 scores);
//   k_prep: (B, N, H*D) bf16 k^ (K4, K8a, K8b over K7);
//   k_q: (B, N, H*D) int8 k^ (int8 scores);
//   k_stat: (B*H) fp32, zero on entry (K4's and K8a's max |bf16(k^)|; over
//     bf16 scores the bf16 prep's ||k^||^2 maxima, unused), or (B*H, NP)
//     fp32 per-key k scales (K7q, K8b over K7q);
//   v_amax: (B*H, D) fp32, zero on entry; v_q: (B*H, D, NP) int8, NP = N
//     rounded up to KEY_TILE (K8a, K8b).
struct Args {
  const void *q, *k, *v, *cq, *sq, *ck, *sk;
  void *q_prep, *q_scale, *k_prep, *k_q, *k_stat, *v_amax, *v_q, *out;
  int B, N, H, dn;
  float eps_q, eps_k;
  cudaStream_t st;
};

// The q, K (and V) preps, the tensor maps, the attention; the first error:
// a cudaError_t of a launch or the CUresult of a tensor-map encode.
template <int D, bool QK8, bool PV8, bool TWO_PASS>
int launch_int8(const Args& a) {
  using S = SmemI8<D, QK8, PV8, TWO_PASS>;
  using R = Rows<D, QK8>;
  // the per-row preps' tag: the TPU kernel the launch serves
  constexpr int TAG = TWO_PASS ? (PV8 ? 81 : 4) : PV8 ? 8 : 7;
  const int B = a.B, N = a.N, H = a.H;
  const int np = (N + KEY_TILE - 1) / KEY_TILE * KEY_TILE;
  int e;
  if constexpr (QK8)
    e = launch_q8rows<D, TAG>(a.q, a.cq, a.sq, a.q_prep, a.q_scale, B, N, H,
                              N, a.eps_q, a.dn, a.st);
  else
    e = launch_q_prep<D, false>(a.q, a.cq, a.sq, a.q_prep, nullptr, B, N, H,
                                a.eps_q, a.dn, a.st);
  if (e != 0) return e;
  if constexpr (QK8 && TWO_PASS)
    e = launch_k_prep_q8bh<D>(a.k, a.ck, a.sk, a.k_prep, a.k_q, a.k_stat, B,
                              N, H, a.eps_k, a.dn, a.st);
  else if constexpr (QK8)
    e = launch_q8rows<D, TAG>(a.k, a.ck, a.sk, a.k_q, a.k_stat, B, N, H, np,
                              a.eps_k, a.dn, a.st);
  else
    e = launch_k_prep<D, false>(a.k, a.ck, a.sk, a.k_prep, a.k_stat, B, N, H,
                                a.eps_k, a.dn, a.st);
  if (e != 0) return e;
  if constexpr (PV8) {
    e = launch_v_prep<D>(a.v, a.v_amax, a.v_q, B, N, H, np, a.st);
    if (e != 0) return e;
  }
  auto kernel = attn_int8_sm90_kernel<D, QK8, PV8, TWO_PASS>;
  e = allow_smem(kernel, S::BYTES);
  if (e != 0) return e;
  CUtensorMap tm_q, tm_k, tm_v, tm_ks;
  e = encode_heads(&tm_q, a.q_prep, R::ELEM, R::W, B, N, H, D, QROWS);
  if (e == 0)
    e = encode_heads(&tm_k, QK8 ? a.k_q : a.k_prep, R::ELEM, R::W, B, N, H,
                     D, S::KSUB);
  if (e == 0)
    e = PV8 ? encode_s8_2d(&tm_v, a.v_q, B * H * D, np, S::DV)
            : encode_heads(&tm_v, a.v, 2, SwizzledRows<S::VCOLS>::W, B, N, H,
                           D, S::VSUB);
  if (e == 0)
    e = S::PER_KEY ? encode_f32_2d(&tm_ks, a.k_stat, B * H, np,
                                   S::KSUB)
                   : encode_heads(&tm_ks, a.q_prep, R::ELEM, R::W, B, N, H,
                                  D, QROWS);  // unused
  if (e != 0) return e;
// persistent CTAs: K4's 1520 items at 512px are 11.5 waves of short ones
  // (10 key tiles, twice over), whose tail wave and per-CTA start and end
  // a CTA per item paid (attention_sm90_diag.py's int8 variants: ~5%; K8b's
  // 34-tile items ~1%)
  int dev = 0, sms = 0;
  e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev);
  if (e != 0) return e;
  const int items = (N + S::ROWS - 1) / S::ROWS * (D / S::VCOLS) * H * B;
  kernel<<<items < sms ? items : sms, INT8_THREADS, S::BYTES, a.st>>>(
      tm_q, tm_k, tm_v, tm_ks, static_cast<const float*>(a.q_scale),
      static_cast<const float*>(a.k_stat),
      static_cast<const float*>(a.v_amax), static_cast<bf16*>(a.out), N, H,
      B);
  return (int)cudaGetLastError();
}

template <bool QK8, bool PV8, bool TWO_PASS>
int dispatch(const Args& a, int D) {
  switch (D) {
    case 16: return launch_int8<16, QK8, PV8, TWO_PASS>(a);
    case 32: return launch_int8<32, QK8, PV8, TWO_PASS>(a);
    case 64: return launch_int8<64, QK8, PV8, TWO_PASS>(a);
    case 128: return launch_int8<128, QK8, PV8, TWO_PASS>(a);
    case 256: return launch_int8<256, QK8, PV8, TWO_PASS>(a);
    case 384: return launch_int8<384, QK8, PV8, TWO_PASS>(a);
    case 512: return launch_int8<512, QK8, PV8, TWO_PASS>(a);
    case 768: return launch_int8<768, QK8, PV8, TWO_PASS>(a);
    case 1024: return launch_int8<1024, QK8, PV8, TWO_PASS>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Every entry point: q, k, v, out (B, N, H*D) bf16, contiguous, 16-byte
// aligned; cq, sq, ck, sk (N, D) fp32 tables (norm weights folded in; cq, sq
// also carry scale*log2(e)); the scratch of `Args`; D the instance's head
// dim (16, 32, 64, 128, 256, 384, 512, 768, 1024) and dn <= D the model's
// (attention_common.cuh);
// int8_qk (K8a, K8b) selects int8 scores under the int8 P.V (K4's for K8a,
// K7q's for K8b), else bf16 ones (K1's, K7's). Each returns 0, or the first
// error: a cudaError_t of a launch or the CUresult of a tensor-map encode.
#define SD3_INT8_SM90_PARAMS                                                  \
  const void *q, const void *k, const void *v, const void *cq,               \
      const void *sq, const void *ck, const void *sk, void *q_prep,          \
      void *q_scale, void *k_prep, void *k_q, void *k_stat, void *v_amax,    \
      void *v_q, void *out, int B, int N, int H, int D, int dn, int int8_qk, \
      float eps_q, float eps_k, void *stream
#define SD3_INT8_SM90_ARGS                                                    \
  Args{q,      k,      v,   cq,    sq,    ck, sk, q_prep, q_scale, k_prep,    \
       k_q,    k_stat, v_amax, v_q, out, B, N, H, dn, eps_q, eps_k,          \
       static_cast<cudaStream_t>(stream)}

// K4: int8 QK^T with one k scale per (b, h), the true row max, bf16 P.V.
// q_prep (int8), q_scale, k_prep, k_q, k_stat (B*H).
extern "C" int sd3_fused_attention_int8qk(SD3_INT8_SM90_PARAMS) {
  (void)int8_qk;
  return dispatch<true, false, true>(SD3_INT8_SM90_ARGS, D);
}

// K7q: online softmax over 128-key tiles of int8 scores (q^ and k^ per row,
// s = s32 * s_q * s_k[key]), bf16 P.V. q_prep (int8), q_scale, k_q, k_stat
// (B*H, NP).
extern "C" int sd3_fused_attention_stream_int8qk(SD3_INT8_SM90_PARAMS) {
  (void)int8_qk;
  return dispatch<true, false, false>(SD3_INT8_SM90_ARGS, D);
}

// K8a: the true row max in a first pass, int8 P.V summed in s32 over every
// key; K1's bf16 scores (q_prep bf16, k_prep, k_stat (B*H)) or with int8_qk
// K4's (q_prep int8, q_scale, k_prep, k_q, k_stat (B*H)); v_amax, v_q.
extern "C" int sd3_fused_attention_int8pv(SD3_INT8_SM90_PARAMS) {
  return int8_qk ? dispatch<true, true, true>(SD3_INT8_SM90_ARGS, D)
                 : dispatch<false, true, true>(SD3_INT8_SM90_ARGS, D);
}

// K8b: online softmax over 128-key tiles, int8 P.V; K7's scores (q_prep
// bf16, k_prep, k_stat (B*H)) or with int8_qk K7q's (q_prep int8, q_scale,
// k_q, k_stat (B*H, NP)); v_amax, v_q.
extern "C" int sd3_fused_attention_stream_int8pv(SD3_INT8_SM90_PARAMS) {
  return int8_qk ? dispatch<true, true, false>(SD3_INT8_SM90_ARGS, D)
                 : dispatch<false, true, false>(SD3_INT8_SM90_ARGS, D);
}
