// Int8 (w8a8) SwiGLU MLP for NVIDIA Hopper (sm_90a), with an optional
// AdaLN prologue and gate + residual epilogue.
//
// Replaces three TPU kernels of sd3_tpu/ops/fused_mlp.py:
//   K3 `_kernel` (through _fused_swiglu_2d): the SwiGLU chain alone, over
//      flattened (M, k) tokens;
//   K2 `_kernel_tail2d` (through _fused_swiglu_tail2d): the whole MLP half
//      of a block, out = x + gate * y, with y the chain on AdaLN(x);
//   K9 `_kernel_tail` (through _fused_swiglu_3d): K2's function on a
//      per-sample grid (b, n_pad / bm, chunks).
// All compute, per row r of x (M, K) and with h_group columns per group:
//   xf  = AdaLN(x_r) = LN(x_r) * (1 + scale[b]) + shift[b]   (K2, K9; b = r / n_tok;
//         LN two-pass, eps 1e-5) or x_r (K3), in fp32
//   xq  = round(xf / s_x), s_x = max(|xf|, 1e-8) / 127        (per row)
//   x1  = (xq . w12q[j]) * s_x * s12[j] + b12[j]               (s32 -> fp32;
//   x2  = the same for row j + hidden of w12)                    j < hidden)
//   h   = silu(x1) * x2
//   hq  = round(h / s_h), s_h = max(|h|, 1e-8) / 127  per (row, h_group chunk)
//   y   = sum over chunks g of (hq_g . w3q_g[c]) * s_h[g] * s3[c], + b3[c]
//   out = x + gate[b] * y (K2, K9 with residual) or y, in x's dtype.
// x is bf16, or fp32 in the fp32 instances (the JAX package's `--dtype
// float32 --quant int8`: its kernels quantize the fp32 rows as they are):
// the prologue reads and the epilogue reads and writes the element type T
// (a template parameter of xquant_kernel and w3_sm90_kernel); the
// quantization and every product are the same.
// h_group is part of the numerics: it is the TPU kernel's hidden-chunk width
// (ops/fused_mlp.py: pick_tail_blocks, pick_block_chunk and pick_blocks
// choose it as the JAX package does), because every chunk of h gets its own
// scale.
//
// K9 has no body of its own. The TPU's per-sample grid kept a token tile
// from straddling two samples' conditioning; here every row finds its sample
// as r / n_tok, in the prologue and in the epilogue, so K2's launches already
// compute K9's function on any stream, the unaligned 154-token text stream
// included, and JAX's padding of n to a multiple of bm (TPU blocking; it
// leaves real rows alone, each row being quantized on its own) has nothing
// to do. What differs is outside the device code: K9's h_group comes from
// `pick_blocks`, and its wrapper rounds shift / scale / gate to x's dtype
// first (sd3_tpu/ops/fused_mlp.py:443-448). It is its own entry point and
// template instance (V = 9) so that its launches and its profile rows are
// its own.
//
// Weights are (out, in) int8, K-contiguous, and xq (M, K) and hq (M,
// hidden) are row-major: every operand of both products is K-major, which is
// what wgmma requires of 8-bit types (it has no transpose for them). No
// transposed copy of anything is made.
//
// What bounds it on this card: at the image stream (M = 8*1024, K = 1216,
// hidden = 4864) one call is 2*M*K*2*hidden + 2*M*hidden*K = 290.7 G int8
// operations (the w12 product 193.8 G, 0.098 ms; the w3 product 96.9 G,
// 0.049 ms) against ~58 MB of input, weight and output bytes, so the int8
// tensor-core rate bounds it: 0.147 ms at 1,979 TOP/s.
//
// Design: both products on wgmma m64nNk32 s8 (sm90.cuh), fed by TMA (2-D
// tensor maps of 128-byte rows in the 128-byte swizzle; rows and K columns
// past the end read as zeros, exact in s32, so K and d_out need only be
// multiples of 16, TMA's stride rule) into a ring of stages, with a
// producer warpgroup (one thread issues the loads; setmaxnreg gives its
// registers to the consumers) and two consumer warpgroups, the shape of
// attention_sm90.cu and flash_bwd_sm90.cu. Three launches:
//   1. xquant_kernel (int8_common.cuh, shared with K10a / K10b): one warp
//      per row: (AdaLN,) per-row quantization -> xq (M, K) int8, s_x (M).
//   2. swiglu_h_sm90_kernel<HG, V>: persistent CTAs over items of (128
//      rows, h_group chunk): the product with both halves of w12 for the
//      chunk, dequant, bias, silu * mul, and the per-(row, chunk)
//      requantization -> hq (M, hidden) int8, s_h (M, hidden / h_group).
//   3. w3_sm90_kernel<HG, V>: a CTA per (128 rows, 128 columns): hq w3^T in
//      s32 per h_group chunk (HG / 32 k-steps), each chunk added as
//      float(s32) * s_h[row, g] * s3[c] into an fp32 accumulator in chunk
//      order, as the TPU kernel and the plain version do (s3 is not
//      factored out of the sum: that would move the rounding), then + b3
//      and the gate and residual. The chunk loop is unrolled over its tiles
//      so that no wgmma wait sits on a divergent path (ptxas serialized the
//      wgmmas of a first version that branched on the chunk's end).
// What bounds both products here is the L2's bandwidth to an SM (~40
// bytes a clock measured, PERF.md), not the tensor cores: a 64 x 256
// int8 wgmma tile over 128 bytes of K needs 40 KB of operands for 512
// clocks of products. So the two consumers of a CTA share every weight tile:
// they take the 128 rows of an item in two halves of 64, in step, on the
// same stages (48 KB a stage for 1024 clocks of products).
// The requantization of h needs the max of |h| over a row's whole chunk
// before any of it is rounded: with h_group 256, 64 rows of both w12
// halves over a chunk are 2 x 256 s32 columns, 256 registers a thread,
// above the 240 a consumer has. So a consumer covers its rows in passes of
// 128 chunk columns (wgmma m64n256k32: 128 of x1, then the matching 128 of
// x2, two TMA boxes side by side, 128 registers), keeps |h|'s row max over
// its passes, and stages the fp32 h of every pass but the last in shared
// memory (32 KB a pass). After the last pass it rounds that pass at once;
// the staged passes it rounds under the next item's first pass, a few
// values after each tile's products are issued, so that that part of the
// epilogue runs under the products. At h_group 512 three staged passes would not fit
// beside the ring, so an item is swept twice: the first sweep's passes
// keep only the row max, the second's round each pass as it ends (twice
// the w12 products; no model path takes 512). Each consumer keeps its
// chunk's s12 and b12 in shared memory, loaded under the first pass: read
// from the L2 in the epilogue, their latency was most of its time.
// h stays in device memory: the TPU kernel keeps an fp32 (bm, 1216)
// accumulator of the w3 product in VMEM over all chunks; at 64 rows that is
// 311 KB, more than a CTA's 227 KB of shared memory and more than its
// registers. hq's round trip is 40 MB written and read at the image stream,
// ~0.024 ms at 3.35 TB/s.

#include <type_traits>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int KT = 128;          // K bytes per tile: one 128-byte swizzled row
constexpr int WG = 128;          // threads per warpgroup
constexpr int CONSUMERS = 2;     // consumer warpgroups per CTA
constexpr int MLP_THREADS = WG * (1 + CONSUMERS);
// 384 threads x 168 registers at launch; the producer keeps 24, so each
// consumer thread can have 240
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int SMEM_MAX = 232448;  // dynamic shared memory of one CTA
constexpr int ROWS = 64;          // rows of a consumer (one wgmma's M)
constexpr int PASS_COLS = 128;    // chunk columns of one h pass (of x1 and x2)
// named barrier (0 is __syncthreads): OWN + c, consumer c's four warps
constexpr int OWN = 1;

// Shared memory of swiglu_h_sm90_kernel<HG, *>, from a 1024-byte aligned
// base: the ring (each stage the 128 rows of xq of an item, then 128 rows
// of x1 and 128 of x2 of w12), the staged fp32 h of each consumer
// (thread-major: [pass][value][thread]), each consumer's s12 and b12 of
// its item's chunk ([s12 x1, s12 x2, b12 x1, b12 x2][HG] fp32), the
// barriers.
template <int HG>
struct HCfg {
  static constexpr int PASSES = HG / PASS_COLS;
  static constexpr int RB = ROWS * CONSUMERS;  // rows of an item
  static constexpr int A_TILE = RB * KT;
  static constexpr int B_TILE = 2 * PASS_COLS * KT;
  static constexpr int STAGE = A_TILE + B_TILE;
  static constexpr int ONE_PASS = ROWS * PASS_COLS * 4;
  static constexpr int SCALES = 4 * HG * 4;
  // stage the h of all passes but the last where that leaves 3 stages
  static constexpr bool STAGE_H =
      (SMEM_MAX - 2048 - CONSUMERS * ((PASSES - 1) * ONE_PASS + SCALES)) /
          STAGE >= 3;
  static constexpr int STAGED = STAGE_H ? (PASSES - 1) * ONE_PASS : 0;
  static constexpr int UNITS = (STAGE_H ? 1 : 2) * PASSES;  // per item
  static constexpr int FIT =
      (SMEM_MAX - 2048 - CONSUMERS * (STAGED + SCALES)) / STAGE;
  static constexpr int STAGES = FIT < 6 ? FIT : 6;
  static_assert(STAGES >= 3, "a ring of at least three stages");
  static constexpr int H = STAGES * STAGE;
  static constexpr int SB = H + CONSUMERS * STAGED;
  static constexpr int BAR = SB + CONSUMERS * SCALES;
  static constexpr int BYTES = BAR + 2 * STAGES * 8 + 1024;
};

// The int8 bytes of round(v[e] / s[e]) clamped to [-127, 127], as quant8
// (int8_common.cuh) gives them, packed as byte e of the result; from v * inv,
// inv = 1 / s: the product is within 2 ulp of the quotient, so the two round
// alike unless a half-integer lies that close, and there (rarely: the warp
// branches once for the four) the true division decides. The byte is the
// low one of r + 1.5 * 2^23, exact for |r| <= 127. All 32 lanes of the warp
// call it.
__device__ __forceinline__ uint32_t quant4_by(const float (&v)[4],
                                              const float (&s)[4],
                                              const float (&inv)[4]) {
  float r[4];
  bool tie[4], any = false;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float t = v[e] * inv[e];
    r[e] = rintf(t);
    tie[e] = fabsf(fabsf(t - r[e]) - 0.5f) <= 2.5e-7f * fabsf(t);
    any |= tie[e];
  }
  if (__any_sync(0xffffffffu, any)) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (tie[e]) r[e] = rintf(v[e] / s[e]);
  }
  uint32_t q = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    q |= (__float_as_uint(fminf(fmaxf(r[e], -127.f), 127.f) + 12582912.f) &
          0xffu) << (8 * e);
  return q;
}

// ---- launch 2 ---------------------------------------------------------

// grid min(SMs, items) persistent CTAs, MLP_THREADS threads, HCfg::BYTES
// of dynamic shared memory. Items (128 rows, chunk), rows fastest, so the
// CTAs in flight share the w12 tiles of one or two chunks in the L2; CTA b
// takes items b, b + grid, b + 2 grid, ... tm_x: xq (M, K), boxes of 128
// rows; tm_w12: w12 (2 * hidden, K), boxes of 128 rows.
template <int HG, int V>
__global__ void __launch_bounds__(MLP_THREADS, 1)
swiglu_h_sm90_kernel(const __grid_constant__ CUtensorMap tm_x,
                     const __grid_constant__ CUtensorMap tm_w12,
                     const float* __restrict__ sx,
                     const float* __restrict__ s12,
                     const float* __restrict__ b12, int8_t* __restrict__ hq,
                     float* __restrict__ s_h, int M, int K, int hidden) {
  using C = HCfg<HG>;
  constexpr int P = C::PASSES, UNITS = C::UNITS, STAGES = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full = sb + C::BAR, empty = full + 8 * STAGES;
  const int nk = (K + KT - 1) / KT;
  const int n_rb = (M + C::RB - 1) / C::RB;
  const int n_items = n_rb * (hidden / HG);
  const int n_local = (int)blockIdx.x < n_items
                          ? (n_items - 1 - (int)blockIdx.x) / (int)gridDim.x + 1
                          : 0;
  // the item (row block, chunk) of this CTA's local item j
  auto item_of = [&](int j, int& rb, int& chunk) {
    const int item = blockIdx.x + j * gridDim.x;
    rb = item % n_rb;
    chunk = item / n_rb;
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // ---- producer: one thread loads the passes of the CTA's items
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_x);
      tma_prefetch(&tm_w12);
      int it = 0;
      for (int q = 0; q < n_local; ++q) {
        int rb, chunk;
        item_of(q, rb, chunk);
        for (int u = 0; u < UNITS; ++u) {
          const int col = chunk * HG + (u % P) * PASS_COLS;
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty + 8 * s, ((it / STAGES) & 1) ^ 1);
            const uint32_t st = sb + s * C::STAGE, bar = full + 8 * s;
            mbar_arrive_expect_tx(bar, C::STAGE);
            tma_load_2d(st, &tm_x, bar, kt * KT, rb * C::RB);
            tma_load_2d(st + C::A_TILE, &tm_w12, bar, kt * KT, col);
            tma_load_2d(st + C::A_TILE + PASS_COLS * KT, &tm_w12, bar,
                        kt * KT, hidden + col);
          }
        }
      }
    }
  } else {
    // ---- consumer c: rows [64 c, 64 c + 64) of every item
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    float* staged = reinterpret_cast<float*>(smem + C::H + c * C::STAGED);
    float* sbuf = reinterpret_cast<float*>(smem + C::SB + c * C::SCALES);
    const int n_groups = hidden / HG;
    int acc[PASS_COLS];         // m64n256: x1 in [0, 64), x2 in [64, 128)
    float hv[PASS_COLS / 2];    // h of the current pass
    auto release = [&](int it) {
      if (lane == 0) mbar_arrive(empty + 8 * (it % STAGES));
    };
    // quantize 4 values get(4 j .. 4 j + 3) of h (rows r0, r1; column
    // group j of 128 columns at cb) against scales s, inverses v, into hq
    auto store4 = [&](auto get, int j, int cb, int r0, int r1,
                      const float (&s)[2], const float (&v)[2]) {
      const int col = cb + j * 8 + t4 * 2;
      const float x[4] = {get(4 * j), get(4 * j + 1), get(4 * j + 2),
                          get(4 * j + 3)};
      const uint32_t q = quant4_by(x, {s[0], s[0], s[1], s[1]},
                                   {v[0], v[0], v[1], v[1]});
      if (r0 < M)
        *reinterpret_cast<uint16_t*>(hq + (size_t)r0 * hidden + col) =
            (uint16_t)(q & 0xffffu);
      if (r1 < M)
        *reinterpret_cast<uint16_t*>(hq + (size_t)r1 * hidden + col) =
            (uint16_t)(q >> 16);
    };
    auto from_regs = [&](int i) { return hv[i]; };
    // the staged passes of the last item, rounded in steps of one column
    // group under the next item's first pass
    int pend_cb = 0, pend_r0 = 0, pend_r1 = 0, pend_done = 0, pend_all = 0;
    float pend_s[2] = {0.f, 0.f}, pend_v[2] = {0.f, 0.f};
    auto pend_step = [&]() {
      const int pp = pend_done / (PASS_COLS / 8), j = pend_done % (PASS_COLS / 8);
      store4([&](int i) {
        return staged[(pp * PASS_COLS / 2 + i) * WG + tid];
      }, j, pend_cb + pp * PASS_COLS, pend_r0, pend_r1, pend_s, pend_v);
      ++pend_done;
    };
    for (int q = 0; q < n_local; ++q) {
      int rb, chunk;
      item_of(q, rb, chunk);
      const int r0 = rb * C::RB + c * ROWS + warp * 16 + g, r1 = r0 + 8;
      const float sx0 = r0 < M ? sx[r0] : 0.f, sx1 = r1 < M ? sx[r1] : 0.f;
      float mx0 = 0.f, mx1 = 0.f;  // max |h| of rows r0, r1 over the chunk
      float sc[2] = {0.f, 0.f}, inv[2] = {0.f, 0.f};  // their scales
      // the chunk's s12 and b12 into sbuf under the first pass, once the
      // four warps are done with the last item's
      named_bar_sync(OWN + c, WG);
      for (int i = tid; i < HG; i += WG) {
        const int a = i / (HG / 4), v = i % (HG / 4) * 4;  // 4 floats of array a
        const float* src = (a < 2 ? s12 : b12) + (a & 1) * hidden + chunk * HG;
        cp_async16(sbuf + a * HG + v, src + v, true);
      }
      cp_async_commit();
      bool have_sbuf = false;
      auto scales = [&]() {
        sc[0] = fmaxf(quad_max(mx0), Q_EPS) / 127.f;
        sc[1] = fmaxf(quad_max(mx1), Q_EPS) / 127.f;
        inv[0] = 1.f / sc[0];
        inv[1] = 1.f / sc[1];
      };
      for (int u = 0; u < UNITS; ++u) {
        const int p = u % P;
        const int base = (q * UNITS + u) * nk;
        for (int kt = 0; kt < nk; ++kt) {
          const int it = base + kt, s = it % STAGES;
          mbar_wait(full + 8 * s, (it / STAGES) & 1);
          const uint32_t st = sb + s * C::STAGE;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < KT / 32; ++kk)
            wgmma_s8<2 * PASS_COLS>(acc, desc_s8(st + c * ROWS * KT, kk),
                                    desc_s8(st + C::A_TILE, kk),
                                    kt > 0 || kk > 0);
          wgmma_commit();
          if (kt > 0) {  // the products of tile kt - 1 are done
            wgmma_wait<1>();
            release(it - 1);
          }
          // a share of the last item's staged rounding, under the products
          for (const int to = pend_all * (kt + 1) / nk; pend_done < to;)
            pend_step();
        }
        wgmma_wait<0>();
        reg_fence(acc);
        release(base + nk - 1);
        if (!have_sbuf) {  // the chunk's s12 and b12 have landed
          cp_async_wait<0>();
          named_bar_sync(OWN + c, WG);
          have_sbuf = true;
        }
        // dequant + bias, silu * mul (silu on the SFU's exp2 and
        // reciprocal: ~1e-7 relative, far below h's int8 levels)
#pragma unroll
        for (int j = 0; j < PASS_COLS / 8; ++j) {
          const int col = p * PASS_COLS + j * 8 + t4 * 2;
          const float2 sa = *reinterpret_cast<const float2*>(sbuf + col);
          const float2 sg = *reinterpret_cast<const float2*>(sbuf + HG + col);
          const float2 ba = *reinterpret_cast<const float2*>(sbuf + 2 * HG + col);
          const float2 bg = *reinterpret_cast<const float2*>(sbuf + 3 * HG + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float s_row = e < 2 ? sx0 : sx1;
            const float x1 =
                (float)acc[4 * j + e] * s_row * (e & 1 ? sa.y : sa.x) +
                (e & 1 ? ba.y : ba.x);
            const float x2 =
                (float)acc[PASS_COLS / 2 + 4 * j + e] * s_row *
                    (e & 1 ? sg.y : sg.x) +
                (e & 1 ? bg.y : bg.x);
            const float h = __fdividef(x1, 1.f + __expf(-x1)) * x2;
            hv[4 * j + e] = h;
            if (e < 2) mx0 = fmaxf(mx0, fabsf(h));
            else mx1 = fmaxf(mx1, fabsf(h));
          }
        }
        const int cb = chunk * HG + p * PASS_COLS;
        if constexpr (C::STAGE_H) {
          if (p + 1 < P) {  // staged until the chunk's max is known
#pragma unroll
            for (int i = 0; i < PASS_COLS / 2; ++i)
              staged[(p * PASS_COLS / 2 + i) * WG + tid] = hv[i];
            continue;
          }
          scales();
#pragma unroll
          for (int j = 0; j < PASS_COLS / 8; ++j)
            store4(from_regs, j, cb, r0, r1, sc, inv);
          // the staged passes, under the next item's first pass
          pend_cb = chunk * HG;
          pend_r0 = r0;
          pend_r1 = r1;
          pend_s[0] = sc[0];
          pend_s[1] = sc[1];
          pend_v[0] = inv[0];
          pend_v[1] = inv[1];
          pend_done = 0;
          pend_all = (P - 1) * PASS_COLS / 8;
        } else {
          if (u < P) {  // the first sweep: the max alone
            if (p + 1 == P) scales();
            continue;
          }
#pragma unroll
          for (int j = 0; j < PASS_COLS / 8; ++j)
            store4(from_regs, j, cb, r0, r1, sc, inv);
        }
        if (p + 1 == P && t4 == 0) {
          if (r0 < M) s_h[(size_t)r0 * n_groups + chunk] = sc[0];
          if (r1 < M) s_h[(size_t)r1 * n_groups + chunk] = sc[1];
        }
      }
    }
    while (pend_done < pend_all) pend_step();  // the last item's
  }
}

// ---- launch 3 ---------------------------------------------------------
constexpr int W3_BM = 128, W3_BN = 128;  // rows (2 x 64) and columns
constexpr int W3_STAGE = (W3_BM + W3_BN) * KT;
constexpr int W3_STAGES = 6;
constexpr int W3_BAR = W3_STAGES * W3_STAGE;
constexpr int W3_BYTES = W3_BAR + 2 * W3_STAGES * 8 + 1024;

// grid (ceil(d_out / W3_BN), ceil(M / W3_BM)), MLP_THREADS threads,
// W3_BYTES of dynamic shared memory. tm_h: hq (M, hidden), tm_w3: w3
// (d_out, hidden), boxes of 128 rows. (Persistent CTAs, the producer
// loading the next tile under an epilogue, ran no faster: the products
// wait on the L2's bandwidth, not on a CTA's start.)
template <int HG, int V, typename T = bf16>
__global__ void __launch_bounds__(MLP_THREADS, 1)
w3_sm90_kernel(const __grid_constant__ CUtensorMap tm_h,
               const __grid_constant__ CUtensorMap tm_w3,
               const float* __restrict__ s_h, const float* __restrict__ s3,
               const float* __restrict__ b3, const T* __restrict__ x,
               const float* __restrict__ gate, T* __restrict__ out, int M,
               int hidden, int d_out, int n_tok, int residual_arg) {
  constexpr int TPG = HG / KT;  // tiles per h_group chunk
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  const uint32_t full = sb + W3_BAR, empty = full + 8 * W3_STAGES;
  const int n0 = blockIdx.x * W3_BN, m0 = blockIdx.y * W3_BM;
  const int nk = hidden / KT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < W3_STAGES; ++s) {
      mbar_init(full + 8 * s, 1);
      mbar_init(empty + 8 * s, CONSUMERS * 4);  // lane 0 of each warp
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      tma_prefetch(&tm_h);
      tma_prefetch(&tm_w3);
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % W3_STAGES;
        mbar_wait(empty + 8 * s, ((kt / W3_STAGES) & 1) ^ 1);
        const uint32_t st = sb + s * W3_STAGE, bar = full + 8 * s;
        mbar_arrive_expect_tx(bar, W3_STAGE);
        tma_load_2d(st, &tm_h, bar, kt * KT, m0);
        tma_load_2d(st + W3_BM * KT, &tm_w3, bar, kt * KT, n0);
      }
    }
  } else {
    setmaxnreg_inc<CONSUMER_REGS>();
    const bool residual = residual_arg;
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;
    const int r0 = m0 + c * 64 + warp * 16 + g, r1 = r0 + 8;
    const int n_groups = hidden / HG;
    int acc[W3_BN / 2];
    float accf[W3_BN / 2];
    float s3c[W3_BN / 4];  // s3 of this thread's 32 columns
#pragma unroll
    for (int j = 0; j < W3_BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = n0 + j * 8 + t4 * 2 + e;
        s3c[2 * j + e] = col < d_out ? s3[col] : 0.f;
      }
#pragma unroll
    for (int i = 0; i < W3_BN / 2; ++i) accf[i] = 0.f;
    auto release = [&](int kt) {
      if (lane == 0) mbar_arrive(empty + 8 * (kt % W3_STAGES));
    };
    for (int grp = 0; grp < n_groups; ++grp) {
      // the chunk's row scales, loaded ahead of its products
      const float sh0 = r0 < M ? s_h[(size_t)r0 * n_groups + grp] : 0.f;
      const float sh1 = r1 < M ? s_h[(size_t)r1 * n_groups + grp] : 0.f;
#pragma unroll
      for (int t = 0; t < TPG; ++t) {
        const int kt = grp * TPG + t, s = kt % W3_STAGES;
        mbar_wait(full + 8 * s, (kt / W3_STAGES) & 1);
        const uint32_t a = sb + s * W3_STAGE + c * 64 * KT;
        const uint32_t bt = sb + s * W3_STAGE + W3_BM * KT;
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 32; ++kk)
          wgmma_s8<W3_BN>(acc, desc_s8(a, kk), desc_s8(bt, kk),
                          t > 0 || kk > 0);
        wgmma_commit();
        if (t > 0) {
          wgmma_wait<1>();
          release(kt - 1);
        }
      }
      wgmma_wait<0>();
      reg_fence(acc);
      release(grp * TPG + TPG - 1);
      // accf += (s32 * s_h[row, chunk]) * s3[col], in chunk order
#pragma unroll
      for (int j = 0; j < W3_BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          accf[4 * j + e] += (float)acc[4 * j + e] * (e < 2 ? sh0 : sh1) *
                             s3c[2 * j + (e & 1)];
    }

    // epilogue: + b3; with the residual x + gate * y; out in T
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = hr ? r1 : r0;
      if (row >= M) continue;
      const size_t samp = row / n_tok;
#pragma unroll
      for (int j = 0; j < W3_BN / 8; ++j) {
        const int col = n0 + j * 8 + t4 * 2;
        if (col >= d_out) continue;  // d_out is even: col + 1 < d_out too
        float y0 = accf[4 * j + 2 * hr] + b3[col];
        float y1 = accf[4 * j + 2 * hr + 1] + b3[col + 1];
        if constexpr (std::is_same<T, float>::value) {
          if (residual) {
            const float2 xr = *reinterpret_cast<const float2*>(x + (size_t)row * d_out + col);
            y0 = xr.x + gate[samp * d_out + col] * y0;
            y1 = xr.y + gate[samp * d_out + col + 1] * y1;
          }
          *reinterpret_cast<float2*>(out + (size_t)row * d_out + col) = make_float2(y0, y1);
        } else {
          if (residual) {
            const float2 xr = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
                x + (size_t)row * d_out + col));
            y0 = xr.x + gate[samp * d_out + col] * y0;
            y1 = xr.y + gate[samp * d_out + col + 1] * y1;
          }
          *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * d_out + col) =
              __floats2bfloat162_rn(y0, y1);
        }
      }
    }
  }
}

// The four tensor maps, then the three launches; the first error. The
// shared-memory opt-ins come first (a runtime call makes the device's
// context current on this thread before the maps' encode, a driver call).
template <int HG, int V, typename T>
int launch(const void* x, const void* shift, const void* scale,
           const void* gate, const void* w12, const void* s12, const void* b12,
           const void* w3, const void* s3, const void* b3, void* xq, void* sx,
           void* hq, void* s_h, void* out, int M, int K, int hidden,
           int d_out, int n_tok, int adaln, int residual, cudaStream_t st) {
  using C = HCfg<HG>;
  auto hk = swiglu_h_sm90_kernel<HG, V>;
  auto wk = w3_sm90_kernel<HG, V, T>;
  CUtensorMap tm_x, tm_w12, tm_h, tm_w3;
  int dev = 0, sms = 0;
  int e = (int)cudaFuncSetAttribute(
      hk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e == 0)
    e = (int)cudaFuncSetAttribute(
        wk, cudaFuncAttributeMaxDynamicSharedMemorySize, W3_BYTES);
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == 0) e = encode_s8_2d(&tm_x, xq, M, K, C::RB);
  if (e == 0) e = encode_s8_2d(&tm_w12, w12, 2 * hidden, K, PASS_COLS);
  if (e == 0) e = encode_s8_2d(&tm_h, hq, M, hidden, W3_BM);
  if (e == 0) e = encode_s8_2d(&tm_w3, w3, d_out, hidden, W3_BN);
  if (e == 0)
    e = launch_xquant<V, T>(x, (long long)n_tok * K, shift, scale, xq, sx, M, K,
                         n_tok, adaln, st);
  if (e != 0) return e;

  const int items = (M + C::RB - 1) / C::RB * (hidden / HG);
  hk<<<items < sms ? items : sms, MLP_THREADS, C::BYTES, st>>>(
      tm_x, tm_w12, static_cast<const float*>(sx),
      static_cast<const float*>(s12), static_cast<const float*>(b12),
      static_cast<int8_t*>(hq), static_cast<float*>(s_h), M, K, hidden);
  e = (int)cudaGetLastError();
  if (e != 0) return e;

  wk<<<dim3((d_out + W3_BN - 1) / W3_BN, (M + W3_BM - 1) / W3_BM),
       MLP_THREADS, W3_BYTES, st>>>(
      tm_h, tm_w3, static_cast<const float*>(s_h),
      static_cast<const float*>(s3), static_cast<const float*>(b3),
      static_cast<const T*>(x), static_cast<const float*>(gate),
      static_cast<T*>(out), M, hidden, d_out, n_tok, residual);
  return (int)cudaGetLastError();
}

// x: (M, K) of T (bf16, or fp32 in the `_fp32` entry points); shift, scale: (M / n_tok, K) fp32 (read when adaln);
// gate: (M / n_tok, d_out) fp32 (read when residual, which needs
// d_out == K); w12: (2 * hidden, K) int8 with s12, b12 (2 * hidden) fp32;
// w3: (d_out, hidden) int8 with s3, b3 (d_out) fp32. Scratch: xq (M, K)
// int8, sx (M) fp32, hq (M, hidden) int8, s_h (M, hidden / h_group) fp32.
// out: (M, d_out) of T. K and d_out multiples of 16, hidden a multiple of
// h_group, h_group one of 128, 256, 512; all pointers 16-byte aligned.
// Returns 0, or the first error: a cudaError_t of a launch or the CUresult
// of a tensor-map encode.
// sd3_swiglu_int8_tail is K2 and sd3_swiglu_int8_tail3d K9 (AdaLN and
// gate + residual as flagged); sd3_swiglu_int8 is K3 (both flags ignored).
template <int V, typename T>
int dispatch(const void* x, const void* shift, const void* scale,
             const void* gate, const void* w12, const void* s12,
             const void* b12, const void* w3, const void* s3, const void* b3,
             void* xq, void* sx, void* hq, void* s_h, void* out, int M, int K,
             int hidden, int d_out, int n_tok, int h_group, int adaln,
             int residual, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h_group) {
    case 128: return launch<128, V, T>(x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M, K, hidden, d_out, n_tok, adaln, residual, st);
    case 256: return launch<256, V, T>(x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M, K, hidden, d_out, n_tok, adaln, residual, st);
    case 512: return launch<512, V, T>(x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M, K, hidden, d_out, n_tok, adaln, residual, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

#define SD3_SWIGLU_ARGS                                                       \
  const void *x, const void *shift, const void *scale, const void *gate,     \
      const void *w12, const void *s12, const void *b12, const void *w3,     \
      const void *s3, const void *b3, void *xq, void *sx, void *hq,          \
      void *s_h, void *out, int M, int K, int hidden, int d_out, int n_tok,  \
      int h_group, int adaln, int residual, void *stream
#define SD3_SWIGLU_PASS                                                       \
  x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M,  \
      K, hidden, d_out, n_tok, h_group, adaln, residual, stream

extern "C" int sd3_swiglu_int8_tail(SD3_SWIGLU_ARGS) {
  return dispatch<V_K2, bf16>(SD3_SWIGLU_PASS);
}

extern "C" int sd3_swiglu_int8_tail3d(SD3_SWIGLU_ARGS) {
  return dispatch<V_K9, bf16>(SD3_SWIGLU_PASS);
}

extern "C" int sd3_swiglu_int8(SD3_SWIGLU_ARGS) {
  adaln = residual = 0;
  return dispatch<V_K3, bf16>(SD3_SWIGLU_PASS);
}

// the fp32 instances: x and out fp32
extern "C" int sd3_swiglu_int8_tail_fp32(SD3_SWIGLU_ARGS) {
  return dispatch<V_K2, float>(SD3_SWIGLU_PASS);
}

extern "C" int sd3_swiglu_int8_tail3d_fp32(SD3_SWIGLU_ARGS) {
  return dispatch<V_K9, float>(SD3_SWIGLU_PASS);
}

extern "C" int sd3_swiglu_int8_fp32(SD3_SWIGLU_ARGS) {
  adaln = residual = 0;
  return dispatch<V_K3, float>(SD3_SWIGLU_PASS);
}
