// Int8 (w8a8) projections of the attention half of a block for NVIDIA
// Hopper (sm_90a), with the block's AdaLN prologue or its gate + residual
// epilogue folded in: one launch each.
//
// Replaces two TPU kernels of sd3_tpu/ops/fused_dense.py:
//   K10a `_kernel_qkv` (through _qkv_adaln_call): per row r of x (M, K),
//      b = r / n_tok,
//        xf  = LN(x_r) * (1 + scale[b]) + shift[b]   (LN two-pass, eps 1e-5)
//        xq  = round(xf / s_x), s_x = max(|xf|, 1e-8) / 127
//        q_r = (xq . wq[j]) * s_x * sq[j]   (s32 -> fp32, one rounding to
//              bf16), and k, v the same with wk, wv;
//   K10b `_kernel_out` (through _out_gate_res_call): per row r of a (M, K),
//        aq  = round(a_r / s_a), s_a = max(|a_r|, 1e-8) / 127
//        y   = (aq . w[j]) * s_a * s[j] [* gate[b, j]] [+ res[r, j]]
//      in fp32, one rounding to bf16.
// The JAX order of operations is kept: (acc * s_x) * s_w, then the gate
// product, then the residual add, each rounded on its own (no fused
// multiply-add), so on the same bf16 inputs K10b repeats its plain version
// bit for bit and K10a differs only where its LayerNorm sums, taken in
// another order, move an int8 level.
//
// Weights are (out, in) int8, K-contiguous: the K-major B operand that s8
// wgmma requires (8-bit types have no transpose). No copy of them is made.
//
// x (a), the residual and the outputs are bf16, or fp32 in the fp32
// instances (the JAX package's `--dtype float32 --quant int8`, whose
// kernels quantize the fp32 rows as they are): the kernel is a template on
// the element type T. The prologue reads a row's values of T (16-byte loads
// of 8 bf16 or 4 fp32); the s8 products do not change; the fp32 epilogue
// writes its values (and reads the residual) in device memory from
// registers, since an fp32 output tile would not fit beside the A tile and
// the rings.
//
// What bounds them on this card, at the 512px image stream (M = 8 * 1024,
// K = N = 1216): K10a does 2 * M * K * 3N = 72.7 G int8 operations (0.0367
// ms at 1,979 TOP/s) on 84.1 MB (0.0251 ms at 3.35 TB/s), so operations
// bound it; K10b does 24.2 G operations (0.0122 ms) on 61.3 MB (0.0183 ms),
// so bytes bound it.
//
// Design: one launch, the row prologue inside it, the products on s8 wgmma
// m64nNk32 (sm90.cuh) fed by TMA. An item is a block of 64 rows and a span
// of the output's column tiles of 128 (q's, k's and v's tiles in turn for
// K10a, through three tensor maps). Persistent CTAs of three warpgroups
// walk the items:
//   - the two consumer warpgroups first run the prologue of the item's 64
//     rows, a warp per row: each row read once from device memory in
//     16-byte loads that bypass the L1 (the next row's issued before this
//     row's arithmetic) and kept in registers as bf16, then passes over it:
//     the LayerNorm statistics (two-pass) and the modulation (K10a), the
//     row max, the rounding. v / s_x is v * (1 / s_x) with Markstein's
//     correction, the correctly rounded quotient that JAX's true division
//     gives, so the levels are JAX's without a division a value. The int8
//     row goes into the A tile in shared memory in the layout a TMA box
//     would have written (128-byte K rows in the 128-byte swizzle: 16-byte
//     chunk i of row r at chunk i ^ (r % 8), 8-row groups 1,024 bytes
//     apart; the K tail past K zeroed), s_x beside it. xq never leaves
//     shared memory. A proxy fence (threads' stores, then wgmma's reads
//     through the async proxy) and a named barrier hand it over.
//   - the producer warpgroup (setmaxnreg down to 24) keeps two rings of
//     weight tiles in flight, through the prologue too: warp c's lane 0
//     feeds ring c with consumer c's tiles, TMA boxes of 128 weight rows x
//     128 bytes of K; rows past d_out and K columns past K read as zeros,
//     which the s32 products take exactly.
//   - consumer c takes the span's column tiles c, c + 2, ...: over every K
//     tile a wgmma m64n128k32 (m64n64k32 for a last tile of 64 columns or
//     fewer: 1216 = 9 x 128 + 64, no product wasted) of the shared A tile
//     with its ring's B tile, then the epilogue above from registers into
//     an output tile in shared memory (K10b's residual tile loaded into it
//     by TMA under the products) and a TMA store of it, which clips rows
//     past M and columns past N; the other consumer's products run
//     meanwhile.
// The A tile holds K_CHUNK = 1536 values of each row (12 K tiles, 96 KB);
// with two rings of 3 stages of 16 KB and the two output tiles a CTA takes
// 226 KB of shared memory. A row of at most K_CHUNK values (the published
// width is 1216) is quantized once, from registers, and the item's column
// tiles all run on it. A wider row (CHUNKED, any K a multiple of 16) runs in
// chunks of K_CHUNK: a first pass over each row computes its statistics
// (K10a's LayerNorm moments, then the modulated row's max; K10b's row max),
// so the row scale is fixed before the first chunk and the levels are the
// unchunked levels; then chunk by chunk both consumers rebuild the A tile
// from the row (read again, from the L2), each quantized with that scale,
// and run the chunk's K tiles into the same s32 accumulators. An item then
// holds one column tile per consumer (its accumulators live across the
// chunks), so each span repeats its rows' passes; the weight rings keep
// their depth. At the 512px image stream the 128 row blocks are one wave,
// each CTA walking all of its block's columns; where M / 64 is well under
// the SM count (CFG batch 2: 32 blocks) the columns split into spans so that
// the items fill the card, each span repeating its rows' prologue (x then
// comes from the L2).
// K10b reads `a`, the image-token slice out[:, :n] of the joint attention
// output, in place: row r of it starts at a + (r / n_tok) * sample_stride +
// (r % n_tok) * K, so the slice is never copied.
// Where the time goes, and designs tried and not kept (clusters sharing the
// weight tiles), is in PERF.md (sd3_torch/utils/fused_dense_diag.py).

#include <type_traits>

#include "int8_common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BM = 64;              // rows of an item (one wgmma's M)
constexpr int TN = 128;             // output columns of a tile
constexpr int KT = 128;             // K bytes of a tile: one swizzled row
constexpr int K_CHUNK = 1536;       // the K values of a row the A tile holds
constexpr int NK_CHUNK = K_CHUNK / KT;
constexpr int WG = 128;             // threads per warpgroup
constexpr int CONSUMERS = 2;
constexpr int THREADS = WG * (1 + CONSUMERS);
// 384 threads x 168 registers at launch; the producer keeps 24, so each
// consumer thread can have 240
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;
constexpr int STAGES = 3;           // per ring
constexpr int ROWS_PER_WARP = BM / (CONSUMERS * 4);
constexpr int CHUNKS = K_CHUNK / (8 * 32);  // 8-value chunks of a row per lane
// shared memory from a 1024-byte aligned base: the A tile (NK_CHUNK K tiles
// of 64 rows x 128 bytes), the two rings, each consumer's output tile (two
// boxes of 64 rows x 64 bf16 in the 128-byte swizzle), s_x of the item's
// rows, their LayerNorm mean and 1 / std (CHUNKED), the barriers (ring c: full then empty, STAGES each; then one a
// consumer for its residual tile)
constexpr int A_KTILE = BM * KT;
constexpr int A_BYTES = NK_CHUNK * A_KTILE;
constexpr int B_TILE = TN * KT;
constexpr int OUT_BOX = BM * 64 * 2;
constexpr int RING = STAGES * B_TILE;
constexpr int STG = A_BYTES + CONSUMERS * RING;
constexpr int SX = STG + CONSUMERS * 2 * OUT_BOX;
constexpr int MR = SX + BM * 4;
constexpr int BAR = MR + BM * 8;
constexpr int SMEM_BYTES = BAR + CONSUMERS * (2 * STAGES + 1) * 8 + 1024;
static_assert(SMEM_BYTES <= 232448, "a CTA's shared memory");
// named barriers (0 is __syncthreads): the two consumers' 256 threads, and
// OWN + c, consumer c's 128
constexpr int CONSUMERS_BAR = 1;
constexpr int OWN = 2;

// 16 bytes of device memory read once: not kept in the L1, which keeps the
// conditioning rows every row of a sample reads
__device__ __forceinline__ uint4 ld_once16(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// 8 values of a row of T as they were loaded: one 16-byte load of bf16,
// two of fp32
template <typename T>
struct Raw8 {
  uint4 u[sizeof(T) / 2];
};

template <typename T>
__device__ __forceinline__ Raw8<T> load8_once(const T* p) {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = ld_once16(p + i * (16 / sizeof(T)));
  return r;
}

template <typename T>
__device__ __forceinline__ Raw8<T> zero8() {
  Raw8<T> r;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(T) / 2); ++i) r.u[i] = make_uint4(0u, 0u, 0u, 0u);
  return r;
}

// the 8 values in fp32: bf16's bits moved up, fp32's as they are
template <typename T>
__device__ __forceinline__ void unpack(const Raw8<T>& r, float (&f)[8]) {
  if constexpr (std::is_same<T, float>::value) {
    const uint32_t w[8] = {r.u[0].x, r.u[0].y, r.u[0].z, r.u[0].w,
                           r.u[1].x, r.u[1].y, r.u[1].z, r.u[1].w};
#pragma unroll
    for (int e = 0; e < 8; ++e) f[e] = __uint_as_float(w[e]);
  } else {
    const uint32_t w[4] = {r.u[0].x, r.u[0].y, r.u[0].z, r.u[0].w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      f[2 * e] = __uint_as_float(w[e] << 16);
      f[2 * e + 1] = __uint_as_float(w[e] & 0xffff0000u);
    }
  }
}

// the outputs of the fp32 instances (its epilogue's stores) and its
// residual
template <typename T>
struct Outs {
  T* o[3];
  const T* res;
};

// The weight scales, (N) fp32, of the projections: q, k, v for K10a; the
// out-projection alone for K10b.
struct Scales {
  const float* s[3];
};

// grid min(items, SMs) persistent CTAs, THREADS threads, SMEM_BYTES of
// dynamic shared memory. Items (row block, span), row blocks fastest; CTA b
// takes items b, b + grid, ... tm_w0..2: the (N, K) int8 weights of the
// n_proj projections, boxes of TN rows; tm_o0..2: their (M, N) bf16
// outputs, tm_res the (M, N) bf16 residual (read when residual), boxes of
// 64 x 64; maps past n_proj (and tm_res when unused) repeat tm_w0 / tm_o0.
// CHUNKED: K > K_CHUNK, in chunks of K_CHUNK, and spans of at most one
// column tile per consumer. T = float: the maps tm_o*, tm_res are unused,
// the outputs and the residual are outs.
template <int V, bool CHUNKED, typename T>
__global__ void __launch_bounds__(THREADS, 1)
dense_sm90_kernel(const __grid_constant__ CUtensorMap tm_w0,
                  const __grid_constant__ CUtensorMap tm_w1,
                  const __grid_constant__ CUtensorMap tm_w2,
                  const __grid_constant__ CUtensorMap tm_o0,
                  const __grid_constant__ CUtensorMap tm_o1,
                  const __grid_constant__ CUtensorMap tm_o2,
                  const __grid_constant__ CUtensorMap tm_res,
                  const T* __restrict__ x, long long sample_stride,
                  const float* __restrict__ shift,
                  const float* __restrict__ scale, Scales sc_w,
                  const float* __restrict__ gate, Outs<T> outs, int M, int K,
                  int N, int n_tok, int n_proj, int spans, int gated,
                  int residual) {
  constexpr bool ADALN = V == V_K10A;
  constexpr bool F32 = std::is_same<T, float>::value;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sb = smem_u32(smem);
  float* sx_s = reinterpret_cast<float*>(smem + SX);
  float2* mr_s = reinterpret_cast<float2*>(smem + MR);
  auto full = [&](int c, int s) { return sb + BAR + (2 * c * STAGES + s) * 8; };
  auto empty = [&](int c, int s) {
    return sb + BAR + ((2 * c + 1) * STAGES + s) * 8;
  };
  auto res_bar = [&](int c) {
    return sb + BAR + (2 * CONSUMERS * STAGES + c) * 8;
  };
  const int nk = (K + KT - 1) / KT;
  const int nch = CHUNKED ? (nk + NK_CHUNK - 1) / NK_CHUNK : 1;
  const int n_rb = (M + BM - 1) / BM;
  const int tpp = (N + TN - 1) / TN;  // column tiles of one projection
  const int n_tiles = n_proj * tpp;
  const int n_items = n_rb * spans;

  if (threadIdx.x == 0) {
    for (int c = 0; c < CONSUMERS; ++c) {
      for (int s = 0; s < STAGES; ++s) {
        mbar_init(full(c, s), 1);
        mbar_init(empty(c, s), 4);  // lane 0 of each of consumer c's warps
      }
      mbar_init(res_bar(c), 1);
    }
    fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG;
  if (wg == 0) {
    // ---- producer: lane 0 of warp c loads consumer c's weight tiles
    setmaxnreg_dec<PRODUCER_REGS>();
    const int c = threadIdx.x / 32;
    if (c < CONSUMERS && threadIdx.x % 32 == 0) {
      tma_prefetch(&tm_w0);
      tma_prefetch(&tm_w1);
      tma_prefetch(&tm_w2);
      const uint32_t ring = sb + A_BYTES + c * RING;
      int it = 0;
      for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
        const int span = item / n_rb;
        const int t1 = (span + 1) * n_tiles / spans;
        for (int t = span * n_tiles / spans + c; t < t1; t += CONSUMERS) {
          const int p = t / tpp, col0 = t % tpp * TN;
          const CUtensorMap* m = p == 0 ? &tm_w0 : p == 1 ? &tm_w1 : &tm_w2;
          for (int kt = 0; kt < nk; ++kt, ++it) {
            const int s = it % STAGES;
            mbar_wait(empty(c, s), ((it / STAGES) & 1) ^ 1);
            mbar_arrive_expect_tx(full(c, s), B_TILE);
            tma_load_2d(ring + s * B_TILE, m, full(c, s), kt * KT, col0);
          }
        }
      }
    }
  } else {
    // ---- consumer c: its warps' share of each item's prologue (rows
    // 8 w .. 8 w + 7 of the block for warp w = 4 c .. 4 c + 3 of the eight),
    // then the span's column tiles c, c + 2, ...
    setmaxnreg_inc<CONSUMER_REGS>();
    const int c = wg - 1;
    const int tid = threadIdx.x % WG, warp = tid / 32, lane = tid % 32;
    const int g = lane >> 2, t4 = lane & 3;  // accumulator coordinates
    const int cw = c * 4 + warp;             // this warp among the eight
    const uint32_t ring = sb + A_BYTES + c * RING;
    const uint32_t stg = sb + STG + c * 2 * OUT_BOX;
    unsigned char* stg_p = smem + STG + c * 2 * OUT_BOX;
    int acc[TN / 2], acc_narrow[32];  // s32 accumulators of a tile
    int it = 0, tiles = 0;
    auto release = [&](int i) {
      if (lane == 0) mbar_arrive(empty(c, i % STAGES));
    };

    // row r's values from k0 on: chunk i of this lane (values k0 + 8 (lane
    // + 32 i) .. + 7), or zeros past K or M
    auto row_ptr = [&](int r) {
      return x + (r < M ? (size_t)(r / n_tok) * sample_stride +
                              (size_t)(r % n_tok) * K
                        : 0);
    };
    auto load_row = [&](int r, int k0, Raw8<T> (&v)[CHUNKS]) {
      const T* xr = row_ptr(r);
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        const int e = k0 + (lane + 32 * i) * 8;
        v[i] = r < M && e < K ? load8_once(xr + e) : zero8<T>();
      }
    };
    // CHUNKED: row r's statistics into local row lr of s_x and of the
    // LayerNorm's (mean, 1 / std), in passes over the whole row read from
    // device memory: the LayerNorm moments (K10a), then the row max of the
    // (modulated) values. Sums and maxima in 8 partial values a lane.
    auto row_stats = [&](int r, int lr) {
      const bool live = r < M;  // warp-uniform
      const T* xr = row_ptr(r);
      float mean = 0.f, rstd = 1.f, part[8], f[8];
      if (ADALN && live) {
#pragma unroll
        for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll 4
        for (int e0 = lane * 8; e0 < K; e0 += 256) {
          unpack(load8_once(xr + e0), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) part[e] += f[e];
        }
        mean = warp_sum(((part[0] + part[1]) + (part[2] + part[3])) +
                        ((part[4] + part[5]) + (part[6] + part[7]))) / K;
#pragma unroll
        for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll 4
        for (int e0 = lane * 8; e0 < K; e0 += 256) {
          unpack(load8_once(xr + e0), f);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const float d = f[e] - mean;
            part[e] += d * d;
          }
        }
        rstd = rsqrtf(warp_sum(((part[0] + part[1]) + (part[2] + part[3])) +
                               ((part[4] + part[5]) + (part[6] + part[7]))) / K +
                      LN_EPS);
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) part[e] = 0.f;
      if (live) {
        const size_t cb = ADALN ? (size_t)(r / n_tok) * K : 0;
#pragma unroll 2
        for (int e0 = lane * 8; e0 < K; e0 += 256) {
          unpack(load8_once(xr + e0), f);
          if constexpr (ADALN) {
            const float4* c4 = reinterpret_cast<const float4*>(scale + cb + e0);
            const float4* h4 = reinterpret_cast<const float4*>(shift + cb + e0);
            const float4 c0 = c4[0], c1 = c4[1], h0 = h4[0], h1 = h4[1];
            const float scf[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
            const float shf[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              f[e] = (f[e] - mean) * rstd * (1.f + scf[e]) + shf[e];
          }
#pragma unroll
          for (int e = 0; e < 8; ++e) part[e] = fmaxf(part[e], fabsf(f[e]));
        }
      }
      const float amax = fmaxf(fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3])),
                               fmaxf(fmaxf(part[4], part[5]), fmaxf(part[6], part[7])));
      const float s = fmaxf(warp_max(amax), Q_EPS) / 127.f;
      if (lane == 0) {
        sx_s[lr] = s;
        mr_s[lr] = make_float2(mean, rstd);
      }
    };
    // row r's (AdaLN and) quantization of its values from k0 on (ktiles K
    // tiles) into local row lr of the A tile, in passes over its raw chunks
    // v (so that no fp32 copy of the row takes registers from the loads in
    // flight); sums and maxima in 8 partial values a lane. CHUNKED takes the
    // row's statistics from row_stats.
    auto quantize_row = [&](int r, int lr, int k0, int ktiles,
                            const Raw8<T> (&v)[CHUNKS]) {
      const bool live = r < M;  // warp-uniform
      float mean = 0.f, rstd = 1.f, part[8];
      const float* sc_r = scale;
      const float* sh_r = shift;
      if constexpr (CHUNKED) {
        const float2 mr = mr_s[lr];
        mean = mr.x;
        rstd = mr.y;
        if (ADALN && live) {
          sc_r += (size_t)(r / n_tok) * K;
          sh_r += (size_t)(r / n_tok) * K;
        }
      } else if constexpr (ADALN) {
        if (live) {
#pragma unroll
          for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
          for (int i = 0; i < CHUNKS; ++i) {
            float f[8];
            unpack(v[i], f);  // zeros past K
#pragma unroll
            for (int e = 0; e < 8; ++e) part[e] += f[e];
          }
          mean = warp_sum(((part[0] + part[1]) + (part[2] + part[3])) +
                          ((part[4] + part[5]) + (part[6] + part[7]))) / K;
#pragma unroll
          for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
          for (int i = 0; i < CHUNKS; ++i)
            if ((lane + 32 * i) * 8 < K) {
              float f[8];
              unpack(v[i], f);
#pragma unroll
              for (int e = 0; e < 8; ++e) {
                const float d = f[e] - mean;
                part[e] += d * d;
              }
            }
          rstd = rsqrtf(warp_sum(((part[0] + part[1]) + (part[2] + part[3])) +
                                 ((part[4] + part[5]) + (part[6] + part[7]))) / K +
                        LN_EPS);
          sc_r += (size_t)(r / n_tok) * K;
          sh_r += (size_t)(r / n_tok) * K;
        }
      }
      // the row's chunk i in fp32: modulated (K10a), zeros past K or M
      auto values = [&](int i, float (&f)[8]) {
        unpack(v[i], f);
        if constexpr (ADALN) {
          const int e0 = k0 + (lane + 32 * i) * 8;
          if (live && e0 < K) {
            const float4 c0 = *reinterpret_cast<const float4*>(sc_r + e0);
            const float4 c1 = *reinterpret_cast<const float4*>(sc_r + e0 + 4);
            const float4 h0 = *reinterpret_cast<const float4*>(sh_r + e0);
            const float4 h1 = *reinterpret_cast<const float4*>(sh_r + e0 + 4);
            const float scf[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
            const float shf[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
            for (int e = 0; e < 8; ++e)
              f[e] = (f[e] - mean) * rstd * (1.f + scf[e]) + shf[e];
          } else {
#pragma unroll
            for (int e = 0; e < 8; ++e) f[e] = 0.f;
          }
        }
      };
      float s;
      if constexpr (CHUNKED) {
        s = sx_s[lr];
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) part[e] = 0.f;
#pragma unroll
        for (int i = 0; i < CHUNKS; ++i) {
          float f[8];
          values(i, f);
#pragma unroll
          for (int e = 0; e < 8; ++e) part[e] = fmaxf(part[e], fabsf(f[e]));
        }
        const float amax = fmaxf(fmaxf(fmaxf(part[0], part[1]), fmaxf(part[2], part[3])),
                                 fmaxf(fmaxf(part[4], part[5]), fmaxf(part[6], part[7])));
        s = fmaxf(warp_max(amax), Q_EPS) / 127.f;
      }
      const float inv = 1.f / s;
      // round(f / s) as JAX rounds it: half to even, of the correctly
      // rounded quotient, which q1 is (inv = RN(1 / s), q0 within an ulp of
      // f / s and the residual exact: Markstein's correction). |f| <= 127 s,
      // so no level passes 127: no clamp. The byte is the low one of
      // rint(q1) + 1.5 * 2^23.
#pragma unroll
      for (int i = 0; i < CHUNKS; ++i) {
        float f[8];
        values(i, f);
        uint32_t q[2] = {0u, 0u};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float q0 = __fmul_rn(f[e], inv);
          const float q1 = __fmaf_rn(__fmaf_rn(-q0, s, f[e]), inv, q0);
          q[e / 4] |= (__float_as_uint(rintf(q1) + 12582912.f) & 0xffu) << (8 * (e % 4));
        }
        const int e0 = (lane + 32 * i) * 8;  // rows past M, K tail: zeros
        if (e0 < ktiles * KT) {
          const int w = e0 % KT;
          *reinterpret_cast<uint2*>(
              smem + e0 / KT * A_KTILE + lr * KT +
              (((w >> 4) ^ (lr & 7)) << 4) + (w & 8)) = make_uint2(q[0], q[1]);
        }
      }
      if (!CHUNKED && lane == 0) sx_s[lr] = live ? s : 0.f;
    };
    // the item's rows' values from k0 on (ktiles K tiles) into the A tile:
    // rows 8 cw .. 8 cw + 7 of the block, each row's loads issued before the
    // last row's arithmetic; then handed over to both consumers' wgmmas
    auto prologue = [&](int m0, int k0, int ktiles) {
      const int lr0 = cw * ROWS_PER_WARP;
      Raw8<T> buf[2][CHUNKS];
      load_row(m0 + lr0, k0, buf[0]);
#pragma unroll 1
      for (int i0 = 0; i0 < ROWS_PER_WARP; i0 += 2) {
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const int i = i0 + k;
          if (i + 1 < ROWS_PER_WARP) load_row(m0 + lr0 + i + 1, k0, buf[k ^ 1]);
          quantize_row(m0 + lr0 + i, lr0 + i, k0, ktiles, buf[k]);
        }
      }
      fence_proxy_async_shared();
      named_bar_sync(CONSUMERS_BAR, CONSUMERS * WG);
    };

    // the products of K tiles kt0 .. kt1 - 1 of a column tile of width W
    // (128, or 64 for a narrow last tile), K tile kt at A tile kt - kt0, into
    // d (the tile's first overwrites it; no wgmma wait sits in a branch)
    auto products = [&](auto width, int (&d)[decltype(width)::value / 2],
                        int kt0, int kt1) {
      constexpr int W = decltype(width)::value;
      {
        const int i = it + kt0, s = i % STAGES;
        mbar_wait(full(c, s), (i / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 32; ++kk)
          wgmma_s8<W>(d, desc_s8(sb, kk), desc_s8(ring + s * B_TILE, kk),
                      kk > 0 || kt0 > 0);
        wgmma_commit();
      }
      for (int kt = kt0 + 1; kt < kt1; ++kt) {
        const int i = it + kt, s = i % STAGES;
        mbar_wait(full(c, s), (i / STAGES) & 1);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KT / 32; ++kk)
          wgmma_s8<W>(d, desc_s8(sb + (kt - kt0) * A_KTILE, kk),
                      desc_s8(ring + s * B_TILE, kk), 1);
        wgmma_commit();
        wgmma_wait<1>();  // the products of K tile kt - 1 are done
        release(i - 1);
      }
      wgmma_wait<0>();
      reg_fence(d);
      release(it + kt1 - 1);
    };

    // one column tile of width W: its residual tile into the output tile by
    // TMA (K10b), the products over every K tile (CHUNKED: chunk by chunk,
    // each chunk's A tile built by both consumers first; `has` false: a
    // consumer with no tile in the item, which builds the chunks only), then
    // the epilogue into the output tile and its TMA store, which clips rows
    // past M and columns past N
    auto run_tile = [&](auto width, int (&d)[decltype(width)::value / 2],
                        int m0, int p, int col0, bool has) {
      constexpr int W = decltype(width)::value;
      constexpr int BOXES = W / 64;
      if (!F32 && has && tid == 0) {
        bulk_wait_read<0>();  // the last tile's store has read the tile
        if (residual) {
          mbar_arrive_expect_tx(res_bar(c), BOXES * OUT_BOX);
          for (int bx = 0; bx < BOXES; ++bx)
            tma_load_2d(stg + bx * OUT_BOX, &tm_res, res_bar(c), col0 + 64 * bx, m0);
        }
      }
      // this thread's weight scales of the tile, loaded under its products
      // (columns past N take the last two, and are not stored)
      const float* __restrict__ sw = p == 0 ? sc_w.s[0] : p == 1 ? sc_w.s[1] : sc_w.s[2];
      float2 swc[W / 8];
#pragma unroll
      for (int j = 0; j < W / 8; ++j)
        swc[j] = *reinterpret_cast<const float2*>(
            sw + min(col0 + j * 8 + t4 * 2, N - 2));
      if constexpr (CHUNKED) {
        for (int ch = 0; ch < nch; ++ch) {
          const int kt0 = ch * NK_CHUNK, kt1 = min(nk, kt0 + NK_CHUNK);
          // both consumers' products of the last chunk are done with the
          // A tile (the item's first: the barrier at the item's start)
          if (ch > 0) named_bar_sync(CONSUMERS_BAR, CONSUMERS * WG);
          prologue(m0, kt0 * KT, kt1 - kt0);
          if (has) products(width, d, kt0, kt1);
        }
        if (!has) return;
      } else {
        products(width, d, 0, nk);
      }
      it += nk;

      // epilogue: (acc * s_x) * s_w [* gate] [+ res], each rounded on its
      // own, bf16, into the output tile (row lr, 16-byte chunk j of box bx
      // at chunk j ^ (lr % 8); lr % 8 = g)
      if constexpr (F32) {
        // fp32: from registers into device memory, the residual read there
        T* __restrict__ op = outs.o[p];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int lr = warp * 16 + g + 8 * hr, row = m0 + lr;
          if (row >= M) continue;
          const float sxr = sx_s[lr];
          const float* __restrict__ gr = gate + (size_t)(row / n_tok) * N;
#pragma unroll
          for (int j = 0; j < W / 8; ++j) {
            const int col = col0 + j * 8 + t4 * 2;
            if (col >= N) continue;  // N is even: col + 1 < N too
            float y0 = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * hr], sxr), swc[j].x);
            float y1 = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * hr + 1], sxr), swc[j].y);
            if (gated) {
              const float2 gv = *reinterpret_cast<const float2*>(gr + col);
              y0 = __fmul_rn(y0, gv.x);
              y1 = __fmul_rn(y1, gv.y);
            }
            if (residual) {
              const float2 rv = *reinterpret_cast<const float2*>(
                  outs.res + (size_t)row * N + col);
              y0 = __fadd_rn(y0, rv.x);
              y1 = __fadd_rn(y1, rv.y);
            }
            *reinterpret_cast<float2*>(op + (size_t)row * N + col) = make_float2(y0, y1);
          }
        }
        return;
      }
      named_bar_sync(OWN + c, WG);  // thread 0 saw the last store's reads end
      if (residual) mbar_wait(res_bar(c), tiles & 1);
      ++tiles;
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int lr = warp * 16 + g + 8 * hr, row = m0 + lr;
        const float sxr = sx_s[lr];
        const float* __restrict__ gr = gate + (size_t)((row < M ? row : M - 1) / n_tok) * N;
#pragma unroll
        for (int j = 0; j < W / 8; ++j) {
          const int col = min(col0 + j * 8 + t4 * 2, N - 2);
          float y0 = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * hr], sxr), swc[j].x);
          float y1 = __fmul_rn(__fmul_rn((float)d[4 * j + 2 * hr + 1], sxr), swc[j].y);
          if (gated) {
            const float2 gv = *reinterpret_cast<const float2*>(gr + col);
            y0 = __fmul_rn(y0, gv.x);
            y1 = __fmul_rn(y1, gv.y);
          }
          __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(
              stg_p + j / 8 * OUT_BOX + lr * 128 + (((j % 8) ^ g) << 4) + t4 * 4);
          if (residual) {
            const float2 rv = __bfloat1622float2(*o);
            y0 = __fadd_rn(y0, rv.x);
            y1 = __fadd_rn(y1, rv.y);
          }
          *o = __floats2bfloat162_rn(y0, y1);
        }
      }
      fence_proxy_async_shared();
      named_bar_sync(OWN + c, WG);
      if (tid == 0) {
        const CUtensorMap* m = p == 0 ? &tm_o0 : p == 1 ? &tm_o1 : &tm_o2;
        for (int bx = 0; bx < BOXES; ++bx)
          tma_store_2d(m, stg + bx * OUT_BOX, col0 + 64 * bx, m0);
        bulk_commit();
      }
    };

    for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
      const int m0 = item % n_rb * BM;
      const int span = item / n_rb, t1 = (span + 1) * n_tiles / spans;
      // the last item's products and epilogues are done with the A tile,
      // s_x and the LayerNorm statistics
      named_bar_sync(CONSUMERS_BAR, CONSUMERS * WG);
      if constexpr (CHUNKED) {
        // the statistics of rows 8 cw .. 8 cw + 7, which this warp alone
        // quantizes; then this consumer's one column tile of the span (or
        // none), chunk by chunk
        for (int i = 0; i < ROWS_PER_WARP; ++i)
          row_stats(m0 + cw * ROWS_PER_WARP + i, cw * ROWS_PER_WARP + i);
        __syncwarp();
        const int t = span * n_tiles / spans + c;
        const bool has = t < t1;
        const int p = has ? t / tpp : 0, col0 = has ? t % tpp * TN : 0;
        if (!has || N - col0 > 64)
          run_tile(std::integral_constant<int, TN>(), acc, m0, p, col0, has);
        else
          run_tile(std::integral_constant<int, 64>(), acc_narrow, m0, p, col0,
                   has);
      } else {
        prologue(m0, 0, nk);
        for (int t = span * n_tiles / spans + c; t < t1; t += CONSUMERS) {
          const int p = t / tpp, col0 = t % tpp * TN;
          if (N - col0 > 64)
            run_tile(std::integral_constant<int, TN>(), acc, m0, p, col0, true);
          else
            run_tile(std::integral_constant<int, 64>(), acc_narrow, m0, p, col0,
                     true);
        }
      }
    }
    if (tid == 0) bulk_wait_read<0>();  // the output tile outlives its stores
  }
}

// The tensor maps, then the launch; 0, or the first error (a cudaError_t,
// or the CUresult of a tensor-map encode). Spans: as many as fill the SMs
// with items, at most one per pair of column tiles; for K past K_CHUNK, one
// per pair of column tiles.
template <int V, typename T>
int launch_dense(const void* x, long long sample_stride, const void* shift,
                 const void* scale, const void* const (&w)[3],
                 const Scales& sc_w, void* const (&out)[3], int n_proj,
                 const void* gate, const void* res, int M, int K, int N,
                 int n_tok, int gated, int residual, cudaStream_t st) {
  if (M <= 0) return 0;
  if (K % 16 != 0 || N % 8 != 0 || n_tok <= 0)
    return (int)cudaErrorInvalidValue;
  const bool chunked = K > K_CHUNK;
  auto kern = chunked ? dense_sm90_kernel<V, true, T> : dense_sm90_kernel<V, false, T>;
  constexpr bool F32 = std::is_same<T, float>::value;
  CUtensorMap tw[3], to[3], tr;
  int dev = 0, sms = 0;
  int e = (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (e == 0) e = (int)cudaGetDevice(&dev);
  if (e == 0)
    e = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  for (int p = 0; p < n_proj && e == 0; ++p) {
    e = encode_s8_2d(&tw[p], w[p], N, K, TN);
    if (e == 0 && !F32) e = encode_bf16_2d(&to[p], out[p], M, N, BM);
  }
  if (e == 0 && residual && !F32) e = encode_bf16_2d(&tr, res, M, N, BM);
  if (e != 0) return e;
  if (F32) to[0] = tw[0];  // unused
  for (int p = n_proj; p < 3; ++p) {
    tw[p] = tw[0];
    to[p] = to[0];
  }
  if (F32) to[1] = to[2] = to[0];
  if (!residual || F32) tr = to[0];
  const Outs<T> outs = {{static_cast<T*>(out[0]), static_cast<T*>(out[1]),
                         static_cast<T*>(out[2])},
                        static_cast<const T*>(res)};
  const int n_rb = (M + BM - 1) / BM;
  const int n_tiles = n_proj * ((N + TN - 1) / TN);
  const int most = n_tiles / CONSUMERS > 1 ? n_tiles / CONSUMERS : 1;
  int spans = sms / n_rb;
  spans = spans < 1 ? 1 : spans > most ? most : spans;
  if (chunked) spans = (n_tiles + CONSUMERS - 1) / CONSUMERS;
  const int items = n_rb * spans;
  kern<<<items < sms ? items : sms, THREADS, SMEM_BYTES, st>>>(
      tw[0], tw[1], tw[2], to[0], to[1], to[2], tr,
      static_cast<const T*>(x), sample_stride,
      static_cast<const float*>(shift), static_cast<const float*>(scale), sc_w,
      static_cast<const float*>(gate), outs, M, K, N, n_tok, n_proj, spans,
      gated, residual);
  return (int)cudaGetLastError();
}

}  // namespace

// K10a. x: (M, K) bf16, M = B * n_tok rows of B samples; shift, scale:
// (B, K) fp32; wq, wk, wv: (N, K) int8 with sq, sk, sv (N) fp32. q, k, v:
// (M, N) bf16. K a multiple of 16, N a multiple of 8;
// all pointers 16-byte aligned. Returns 0, or the first error: a
// cudaError_t of the launch or the CUresult of a tensor-map encode.
#define SD3_QKV_PARAMS                                                        \
  const void *x, const void *shift, const void *scale, const void *wq,       \
      const void *wk, const void *wv, const void *sq, const void *sk,        \
      const void *sv, void *q, void *k, void *v, int M, int K, int N,        \
      int n_tok, void *stream

template <typename T>
int qkv(SD3_QKV_PARAMS) {
  const void* const w[3] = {wq, wk, wv};
  void* const out[3] = {q, k, v};
  const Scales s = {{static_cast<const float*>(sq), static_cast<const float*>(sk),
                     static_cast<const float*>(sv)}};
  return launch_dense<V_K10A, T>(x, (long long)n_tok * K, shift, scale, w, s,
                                 out, 3, nullptr, nullptr, M, K, N, n_tok, 0,
                                 0, static_cast<cudaStream_t>(stream));
}

extern "C" int sd3_qkv_adaln_int8(SD3_QKV_PARAMS) {
  return qkv<bf16>(x, shift, scale, wq, wk, wv, sq, sk, sv, q, k, v, M, K, N,
                   n_tok, stream);
}

// K10a on fp32: x, q, k, v fp32
extern "C" int sd3_qkv_adaln_int8_fp32(SD3_QKV_PARAMS) {
  return qkv<float>(x, shift, scale, wq, wk, wv, sq, sk, sv, q, k, v, M, K, N,
                    n_tok, stream);
}

// K10b. a: M = B * n_tok rows of K bf16, row r at a + (r / n_tok) *
// sample_stride + (r % n_tok) * K (elements; a and sample_stride * 2 bytes
// 16-byte aligned); gate: (B, N) fp32 (read when gated); res: (M, N) bf16
// (read when residual); w: (N, K) int8 with s (N) fp32. out: (M, N) bf16. K
// a multiple of 16, N a multiple of 8; all pointers 16-byte aligned. Returns 0, or the first error, as K10a.
#define SD3_OUT_PARAMS                                                        \
  const void *a, long long sample_stride, const void *gate, const void *res, \
      const void *w, const void *s, void *out, int M, int K, int N,          \
      int n_tok, int gated, int residual, void *stream

template <typename T>
int out_gate_residual(SD3_OUT_PARAMS) {
  const void* const ws[3] = {w, nullptr, nullptr};
  void* const outs[3] = {out, nullptr, nullptr};
  const Scales sc = {{static_cast<const float*>(s), nullptr, nullptr}};
  return launch_dense<V_K10B, T>(a, sample_stride, nullptr, nullptr, ws, sc,
                                 outs, 1, gate, res, M, K, N, n_tok, gated,
                                 residual, static_cast<cudaStream_t>(stream));
}

extern "C" int sd3_out_gate_residual_int8(SD3_OUT_PARAMS) {
  return out_gate_residual<bf16>(a, sample_stride, gate, res, w, s, out, M, K,
                                 N, n_tok, gated, residual, stream);
}

// K10b on fp32: a, res, out fp32 (a and sample_stride * 4 bytes 16-byte
// aligned)
extern "C" int sd3_out_gate_residual_int8_fp32(SD3_OUT_PARAMS) {
  return out_gate_residual<float>(a, sample_stride, gate, res, w, s, out, M,
                                  K, N, n_tok, gated, residual, stream);
}
