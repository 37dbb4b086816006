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
//   out = x + gate[b] * y (K2, K9 with residual) or y, in bf16.
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
// Weights are (out, in) int8, K-contiguous: the B operand of the int8 mma
// (m16n8k32 .row.col) must be K-major, and ldmatrix cannot transpose 8-bit
// elements, so the fragments of both operands are read with plain
// (non-transposed) ldmatrix from K-contiguous shared-memory rows.
//
// What bounds it on this card: at the image stream (M = 8*1024, K = 1216,
// hidden = 4864) one call is 2*M*K*2*hidden + 2*M*hidden*K = 290.7 G int8
// operations against ~58 MB of input, weight and output bytes, so the int8
// tensor-core rate bounds it (0.147 ms at 1,979 TOP/s). The TPU kernel keeps
// an fp32 (bm, 1216) accumulator in VMEM over all hidden chunks; on Hopper
// that does not fit a block's shared memory, so this simple, right version
// runs three launches and lets h make one round trip through device memory:
//   1. xquant_kernel (int8_common.cuh): one warp per row: (AdaLN,) per-row
//      quantization -> xq (M, K) int8, s_x (M) fp32;
//   2. swiglu_h_kernel: one block per (BM rows, h_group chunk): the int8
//      product with both halves of w12 for the chunk, dequant, bias,
//      silu * mul, the per-(row, chunk) requantization -> hq (M, hidden)
//      int8, s_h (M, hidden / h_group) fp32 (40 MB at the image stream);
//   3. w3_gemm_kernel: one block per (64 rows, 128 columns): hq . w3^T in
//      s32 per h_group chunk, each chunk dequantized into an fp32
//      accumulator in chunk order (the TPU kernel's order), then the
//      epilogue.
// Products run on mma.sync (s8 x s8 -> s32) from a two-stage cp.async ring;
// wgmma, TMA and keeping h on chip are the later work.

#include "int8_common.cuh"

namespace {

// ---- launch 2 ---------------------------------------------------------
// One block: BM rows x one h_group chunk of both w12 halves. Warps: WM
// along the rows (MT m16 tiles each) x WN along the chunk (NT n8 tiles of
// x1 and the same NT of x2 each).
template <int HG>
struct HCfg {
  static constexpr int WN = 8;
  static constexpr int WM = 2;
  static constexpr int NT = HG / (8 * WN);
  static constexpr int MT = HG >= 512 ? 1 : 2;
  static constexpr int BM = WM * MT * 16;
  static constexpr int THREADS = WM * WN * 32;
  static constexpr int A_BYTES = BM * SK;
  static constexpr int STAGE = A_BYTES + 2 * HG * SK;
  static constexpr int RED = 2 * STAGE;               // [BM][WN] fp32
  static constexpr int SMEM = RED + BM * WN * 4;
  static_assert(NT % 2 == 0, "pairs of n8 tiles per ldmatrix");
};

// grid (ceil(M / BM), hidden / HG), HCfg<HG>::THREADS threads.
template <int HG, int V>
__global__ void __launch_bounds__(HCfg<HG>::THREADS)
swiglu_h_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                const int8_t* __restrict__ w12, const float* __restrict__ s12,
                const float* __restrict__ b12, int8_t* __restrict__ hq,
                float* __restrict__ s_h, int M, int K, int hidden) {
  using C = HCfg<HG>;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + C::RED);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / C::WN, wn = warp % C::WN;
  const int m0 = blockIdx.x * C::BM, chunk = blockIdx.y;
  const int nk = (K + BK - 1) / BK;

  auto load_tile = [&](int kt) {
    unsigned char* st = smem + (kt & 1) * C::STAGE;
    const int k0 = kt * BK;
    for (int c = tid; c < (C::BM + 2 * HG) * (BK / 16); c += C::THREADS) {
      const int r = c / (BK / 16), kc = k0 + (c % (BK / 16)) * 16;
      const int8_t* src;
      bool valid;
      if (r < C::BM) {
        valid = m0 + r < M && kc < K;
        src = xq + (valid ? (size_t)(m0 + r) * K + kc : 0);
      } else {
        const int j = r - C::BM;  // chunk row: x1 half, then x2 half
        const size_t wrow = (j < HG ? 0 : hidden - HG) + (size_t)chunk * HG + j;
        valid = kc < K;
        src = w12 + (valid ? wrow * K + kc : 0);
      }
      cp_async16(st + r * SK + (c % (BK / 16)) * 16, src, valid);
    }
    cp_async_commit();
  };

  int acc[C::MT][2 * C::NT][4];
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int j = 0; j < 2 * C::NT; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0;

  load_tile(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* sA = reinterpret_cast<const int8_t*>(smem + (kt & 1) * C::STAGE);
    const int8_t* sB = sA + C::A_BYTES;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      uint32_t a[C::MT][4];
#pragma unroll
      for (int i = 0; i < C::MT; ++i)
        load_a(a[i], sA, (wm * C::MT + i) * 16, kb, lane);
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int p = 0; p < C::NT; p += 2) {
          uint32_t b[4];
          load_b2(b, sB, half * HG + (wn * C::NT + p) * 8, kb, lane);
#pragma unroll
          for (int i = 0; i < C::MT; ++i) {
            mma_s8(acc[i][half * C::NT + p], a[i], b[0], b[1]);
            mma_s8(acc[i][half * C::NT + p + 1], a[i], b[2], b[3]);
          }
        }
    }
    __syncthreads();  // tile kt consumed: its stage may be refilled
  }

  // epilogue: dequant + bias, silu * mul, requantize per (row, chunk)
  const int g = lane >> 2, t4 = lane & 3;
  float hv[C::MT][C::NT][4];
  float rmax[C::MT][2];
#pragma unroll
  for (int i = 0; i < C::MT; ++i) {
    const int r0 = m0 + (wm * C::MT + i) * 16 + g;
    const float sx0 = r0 < M ? sx[r0] : 0.f;
    const float sx1 = r0 + 8 < M ? sx[r0 + 8] : 0.f;
    rmax[i][0] = rmax[i][1] = 0.f;
#pragma unroll
    for (int n = 0; n < C::NT; ++n) {
      const int j = chunk * HG + (wn * C::NT + n) * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j + (e & 1);
        const float s_row = e < 2 ? sx0 : sx1;
        const float x1 = (float)acc[i][n][e] * s_row * s12[col] + b12[col];
        const float x2 = (float)acc[i][C::NT + n][e] * s_row * s12[hidden + col] +
                         b12[hidden + col];
        const float h = x1 * (1.f / (1.f + expf(-x1))) * x2;
        hv[i][n][e] = h;
        rmax[i][e >> 1] = fmaxf(rmax[i][e >> 1], fabsf(h));
      }
    }
  }
  // row amax over the chunk: the quad's lanes, then the WN warps of a row
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float v = rmax[i][hr];
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
      if (t4 == 0) red[((wm * C::MT + i) * 16 + g + hr * 8) * C::WN + wn] = v;
    }
  __syncthreads();
  const int n_groups = hidden / HG;
#pragma unroll
  for (int i = 0; i < C::MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int lr = (wm * C::MT + i) * 16 + g + hr * 8;
      float amax = 0.f;
#pragma unroll
      for (int w = 0; w < C::WN; ++w) amax = fmaxf(amax, red[lr * C::WN + w]);
      const float s = fmaxf(amax, Q_EPS) / 127.f;
      const int row = m0 + lr;
      if (row >= M) continue;
      int8_t* dst = hq + (size_t)row * hidden + chunk * HG;
#pragma unroll
      for (int n = 0; n < C::NT; ++n) {
        const int cc = (wn * C::NT + n) * 8 + t4 * 2;
        char2 q;
        q.x = (signed char)quant8(hv[i][n][hr * 2], s);
        q.y = (signed char)quant8(hv[i][n][hr * 2 + 1], s);
        *reinterpret_cast<char2*>(dst + cc) = q;
      }
      if (wn == 0 && t4 == 0) s_h[(size_t)row * n_groups + chunk] = s;
    }
}

// ---- launch 3 ---------------------------------------------------------
constexpr int W3_BM = 64, W3_BN = 128, W3_THREADS = 256;  // 2 x 4 warps
constexpr int W3_MT = 2, W3_NT = 4;                       // 32 x 32 per warp
constexpr int W3_A = W3_BM * SK;
constexpr int W3_STAGE = W3_A + W3_BN * SK;
constexpr int W3_SMEM = 2 * W3_STAGE;

// grid (ceil(d_out / W3_BN), ceil(M / W3_BM)), W3_THREADS threads.
template <int HG, int V>
__global__ void __launch_bounds__(W3_THREADS)
w3_gemm_kernel(const int8_t* __restrict__ hq, const float* __restrict__ s_h,
               const int8_t* __restrict__ w3, const float* __restrict__ s3,
               const float* __restrict__ b3, const bf16* __restrict__ x,
               const float* __restrict__ gate, bf16* __restrict__ out, int M,
               int hidden, int d_out, int n_tok, int residual_arg) {
  const bool residual = residual_arg;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * W3_BN, m0 = blockIdx.y * W3_BM;
  const int nk = hidden / BK;
  constexpr int KT_PER_GROUP = HG / BK;
  const int n_groups = hidden / HG;

  auto load_tile = [&](int kt) {
    unsigned char* st = smem + (kt & 1) * W3_STAGE;
    const int k0 = kt * BK;
    for (int c = tid; c < (W3_BM + W3_BN) * (BK / 16); c += W3_THREADS) {
      const int r = c / (BK / 16), kc = k0 + (c % (BK / 16)) * 16;
      const int8_t* src;
      bool valid;
      if (r < W3_BM) {
        valid = m0 + r < M;
        src = hq + (valid ? (size_t)(m0 + r) * hidden + kc : 0);
      } else {
        valid = n0 + r - W3_BM < d_out;
        src = w3 + (valid ? (size_t)(n0 + r - W3_BM) * hidden + kc : 0);
      }
      cp_async16(st + r * SK + (c % (BK / 16)) * 16, src, valid);
    }
    cp_async_commit();
  };

  const int g = lane >> 2, t4 = lane & 3;
  int acc[W3_MT][W3_NT][4];
  float accf[W3_MT][W3_NT][4];
  float s3c[W3_NT][2];
#pragma unroll
  for (int n = 0; n < W3_NT; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = n0 + wn * 32 + n * 8 + t4 * 2 + e;
      s3c[n][e] = col < d_out ? s3[col] : 0.f;
    }
#pragma unroll
  for (int i = 0; i < W3_MT; ++i)
#pragma unroll
    for (int n = 0; n < W3_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0, accf[i][n][e] = 0.f;

  load_tile(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* sA = reinterpret_cast<const int8_t*>(smem + (kt & 1) * W3_STAGE);
    const int8_t* sB = sA + W3_A;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      uint32_t a[W3_MT][4];
#pragma unroll
      for (int i = 0; i < W3_MT; ++i) load_a(a[i], sA, (wm * W3_MT + i) * 16, kb, lane);
#pragma unroll
      for (int p = 0; p < W3_NT; p += 2) {
        uint32_t b[4];
        load_b2(b, sB, (wn * W3_NT + p) * 8, kb, lane);
#pragma unroll
        for (int i = 0; i < W3_MT; ++i) {
          mma_s8(acc[i][p], a[i], b[0], b[1]);
          mma_s8(acc[i][p + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();
    if ((kt + 1) % KT_PER_GROUP == 0) {
      // chunk done: acc += (s32 * s_h[row, chunk]) * s3[col], in chunk order
      const int grp = kt / KT_PER_GROUP;
#pragma unroll
      for (int i = 0; i < W3_MT; ++i) {
        const int r0 = m0 + (wm * W3_MT + i) * 16 + g;
        const float sh0 = r0 < M ? s_h[(size_t)r0 * n_groups + grp] : 0.f;
        const float sh1 = r0 + 8 < M ? s_h[(size_t)(r0 + 8) * n_groups + grp] : 0.f;
#pragma unroll
        for (int n = 0; n < W3_NT; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            accf[i][n][e] += (float)acc[i][n][e] * (e < 2 ? sh0 : sh1) * s3c[n][e & 1];
            acc[i][n][e] = 0;
          }
      }
    }
  }

  // epilogue: + b3; with the residual x + gate * y; bf16 out
#pragma unroll
  for (int i = 0; i < W3_MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + (wm * W3_MT + i) * 16 + g + hr * 8;
      if (row >= M) continue;
      const size_t samp = row / n_tok;
#pragma unroll
      for (int n = 0; n < W3_NT; ++n) {
        const int col = n0 + wn * 32 + n * 8 + t4 * 2;
        if (col >= d_out) continue;  // d_out is even: col + 1 < d_out too
        float y0 = accf[i][n][hr * 2] + b3[col];
        float y1 = accf[i][n][hr * 2 + 1] + b3[col + 1];
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

template <int HG, int V>
int launch(const void* x, const void* shift, const void* scale,
           const void* gate, const void* w12, const void* s12, const void* b12,
           const void* w3, const void* s3, const void* b3, void* xq, void* sx,
           void* hq, void* s_h, void* out, int M, int K, int hidden,
           int d_out, int n_tok, int adaln, int residual, cudaStream_t st) {
  cudaError_t e = (cudaError_t)launch_xquant<V>(
      x, (long long)n_tok * K, shift, scale, xq, sx, M, K, n_tok, adaln, st);
  if (e != cudaSuccess) return (int)e;

  using C = HCfg<HG>;
  static bool smem_set = false;  // once, before any graph capture
  if (!smem_set) {
    e = cudaFuncSetAttribute(swiglu_h_kernel<HG, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (e != cudaSuccess) return (int)e;
    smem_set = true;
  }
  dim3 g2((M + C::BM - 1) / C::BM, hidden / HG);
  swiglu_h_kernel<HG, V><<<g2, C::THREADS, C::SMEM, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx),
      static_cast<const int8_t*>(w12), static_cast<const float*>(s12),
      static_cast<const float*>(b12), static_cast<int8_t*>(hq),
      static_cast<float*>(s_h), M, K, hidden);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;

  dim3 g3((d_out + W3_BN - 1) / W3_BN, (M + W3_BM - 1) / W3_BM);
  w3_gemm_kernel<HG, V><<<g3, W3_THREADS, W3_SMEM, st>>>(
      static_cast<const int8_t*>(hq), static_cast<const float*>(s_h),
      static_cast<const int8_t*>(w3), static_cast<const float*>(s3),
      static_cast<const float*>(b3), static_cast<const bf16*>(x),
      static_cast<const float*>(gate), static_cast<bf16*>(out), M, hidden,
      d_out, n_tok, residual);
  return (int)cudaGetLastError();
}

// x: (M, K) bf16; shift, scale: (M / n_tok, K) fp32 (read when adaln);
// gate: (M / n_tok, d_out) fp32 (read when residual, which needs
// d_out == K); w12: (2 * hidden, K) int8 with s12, b12 (2 * hidden) fp32;
// w3: (d_out, hidden) int8 with s3, b3 (d_out) fp32. Scratch: xq (M, K)
// int8, sx (M) fp32, hq (M, hidden) int8, s_h (M, hidden / h_group) fp32.
// out: (M, d_out) bf16. K and d_out multiples of 16, hidden a multiple of
// h_group, h_group one of 128, 256, 512; all pointers 16-byte aligned.
// Returns the CUDA error code of the launches (0 = success).
// sd3_swiglu_int8_tail is K2 and sd3_swiglu_int8_tail3d K9 (AdaLN and
// gate + residual as flagged); sd3_swiglu_int8 is K3 (both flags ignored).
template <int V>
int dispatch(const void* x, const void* shift, const void* scale,
             const void* gate, const void* w12, const void* s12,
             const void* b12, const void* w3, const void* s3, const void* b3,
             void* xq, void* sx, void* hq, void* s_h, void* out, int M, int K,
             int hidden, int d_out, int n_tok, int h_group, int adaln,
             int residual, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (h_group) {
    case 128: return launch<128, V>(x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M, K, hidden, d_out, n_tok, adaln, residual, st);
    case 256: return launch<256, V>(x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M, K, hidden, d_out, n_tok, adaln, residual, st);
    case 512: return launch<512, V>(x, shift, scale, gate, w12, s12, b12, w3, s3, b3, xq, sx, hq, s_h, out, M, K, hidden, d_out, n_tok, adaln, residual, st);
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
  return dispatch<V_K2>(SD3_SWIGLU_PASS);
}

extern "C" int sd3_swiglu_int8_tail3d(SD3_SWIGLU_ARGS) {
  return dispatch<V_K9>(SD3_SWIGLU_PASS);
}

extern "C" int sd3_swiglu_int8(SD3_SWIGLU_ARGS) {
  adaln = residual = 0;
  return dispatch<V_K3>(SD3_SWIGLU_PASS);
}
