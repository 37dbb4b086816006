// Int8 (w8a8) projections of the attention half of a block for NVIDIA
// Hopper (sm_90a), with the block's AdaLN prologue or its gate + residual
// epilogue folded in.
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
// Weights are (out, in) int8, K-contiguous, the B operand of m16n8k32
// (.row.col): both operands' fragments come from plain ldmatrix of
// K-contiguous shared-memory rows (int8_common.cuh).
//
// What bounds them on this card, at the 512px image stream (M = 8 * 1024,
// K = N = 1216): K10a does 2 * M * K * 3N = 72.7 G int8 operations (0.0367
// ms at 1,979 TOP/s) on 84.1 MB (0.0251 ms at 3.35 TB/s), so operations
// bound it; K10b does 24.2 G operations (0.0122 ms) on 61.3 MB (0.0183 ms),
// so bytes bound it.
//
// Design. The TPU kernel keeps all three 1.48 MB weight matrices resident in
// VMEM and runs the LayerNorm, modulation and quantization of a row tile in
// front of the three products. A Hopper block's 227 KB of shared memory
// holds none of them whole, so the work splits in two launches:
//   1. xquant_kernel (int8_common.cuh, the prologue K2, K3 and K9 run too):
//      one warp per row, LN statistics in fp32, modulation, per-row
//      quantization -> xq (M, K) int8 and s_x (M) fp32. Its 10 MB round trip
//      through device memory costs ~3 us at the image stream; a block that
//      quantized its own 64 rows into shared memory (77.8 KB at K = 1216)
//      would instead walk all 3 * 1216 output columns alone, 128 blocks for
//      132 SMs at two blocks an SM.
//   2. dense_int8_kernel: one block per 64 x 128 output tile of one
//      projection (grid z picks q, k or v: three weight pointers, no copy of
//      the weights into one matrix), s8 x s8 -> s32 on mma.sync from a
//      two-stage cp.async ring over 64-byte K tiles, then the epilogue above.
// K10b reads `a`, the image-token slice out[:, :n] of the joint attention
// output, in place: row r of it starts at a + (r / n_tok) * sample_stride +
// (r % n_tok) * K, so the slice is never copied. wgmma, TMA and one launch
// are later work.

#include "int8_common.cuh"

namespace {

constexpr int D_BM = 64, D_BN = 128, D_THREADS = 256;  // 2 x 4 warps
constexpr int D_MT = 2, D_NT = 4;                       // 32 x 32 per warp
constexpr int D_A = D_BM * SK;
constexpr int D_STAGE = D_A + D_BN * SK;
constexpr int D_SMEM = 2 * D_STAGE;                     // 30,720 bytes

// Up to three products of one quantized input: q, k, v (K10a) or the
// out-projection (K10b), each with its weight, scales and output.
struct Projections {
  const int8_t* w[3];
  const float* s[3];
  bf16* out[3];
};

// grid (ceil(N / D_BN), ceil(M / D_BM), number of projections), D_THREADS
// threads, D_SMEM bytes of dynamic shared memory.
template <int V>
__global__ void __launch_bounds__(D_THREADS)
dense_int8_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                  Projections p, const float* __restrict__ gate,
                  const bf16* __restrict__ res, int M, int K, int N, int n_tok,
                  int gated, int residual) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z = blockIdx.z;
  const int8_t* __restrict__ w = z == 0 ? p.w[0] : z == 1 ? p.w[1] : p.w[2];
  const float* __restrict__ s_w = z == 0 ? p.s[0] : z == 1 ? p.s[1] : p.s[2];
  bf16* __restrict__ out = z == 0 ? p.out[0] : z == 1 ? p.out[1] : p.out[2];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int wm = warp / 4, wn = warp % 4;
  const int n0 = blockIdx.x * D_BN, m0 = blockIdx.y * D_BM;
  const int nk = (K + BK - 1) / BK;

  auto load_tile = [&](int kt) {
    unsigned char* st = smem + (kt & 1) * D_STAGE;
    const int k0 = kt * BK;
    for (int c = tid; c < (D_BM + D_BN) * (BK / 16); c += D_THREADS) {
      const int r = c / (BK / 16), kc = k0 + (c % (BK / 16)) * 16;
      const int8_t* src;
      bool valid;
      if (r < D_BM) {
        valid = m0 + r < M && kc < K;
        src = xq + (valid ? (size_t)(m0 + r) * K + kc : 0);
      } else {
        valid = n0 + r - D_BM < N && kc < K;
        src = w + (valid ? (size_t)(n0 + r - D_BM) * K + kc : 0);
      }
      cp_async16(st + r * SK + (c % (BK / 16)) * 16, src, valid);
    }
    cp_async_commit();
  };

  int acc[D_MT][D_NT][4];
#pragma unroll
  for (int i = 0; i < D_MT; ++i)
#pragma unroll
    for (int n = 0; n < D_NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][n][e] = 0;

  load_tile(0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) {
      load_tile(kt + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* sA = reinterpret_cast<const int8_t*>(smem + (kt & 1) * D_STAGE);
    const int8_t* sB = sA + D_A;
#pragma unroll
    for (int kb = 0; kb < BK; kb += 32) {
      uint32_t a[D_MT][4];
#pragma unroll
      for (int i = 0; i < D_MT; ++i) load_a(a[i], sA, (wm * D_MT + i) * 16, kb, lane);
#pragma unroll
      for (int q = 0; q < D_NT; q += 2) {
        uint32_t b[4];
        load_b2(b, sB, (wn * D_NT + q) * 8, kb, lane);
#pragma unroll
        for (int i = 0; i < D_MT; ++i) {
          mma_s8(acc[i][q], a[i], b[0], b[1]);
          mma_s8(acc[i][q + 1], a[i], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // tile kt consumed: its stage may be refilled
  }

  // epilogue: (acc * s_x) * s_w [* gate] [+ res], each rounded on its own;
  // bf16 out
  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int i = 0; i < D_MT; ++i)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int row = m0 + (wm * D_MT + i) * 16 + g + hr * 8;
      if (row >= M) continue;
      const float sxr = sx[row];
      const size_t samp = row / n_tok;
#pragma unroll
      for (int n = 0; n < D_NT; ++n) {
        const int col = n0 + wn * 32 + n * 8 + t4 * 2;
        if (col >= N) continue;  // N is even: col + 1 < N too
        float y0 = __fmul_rn(__fmul_rn((float)acc[i][n][hr * 2], sxr), s_w[col]);
        float y1 = __fmul_rn(__fmul_rn((float)acc[i][n][hr * 2 + 1], sxr), s_w[col + 1]);
        if (gated) {
          y0 = __fmul_rn(y0, gate[samp * N + col]);
          y1 = __fmul_rn(y1, gate[samp * N + col + 1]);
        }
        if (residual) {
          const float2 r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              res + (size_t)row * N + col));
          y0 = __fadd_rn(y0, r.x);
          y1 = __fadd_rn(y1, r.y);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row * N + col) =
            __floats2bfloat162_rn(y0, y1);
      }
    }
}

template <int V>
int launch_dense(const void* xq, const void* sx, const Projections& p,
                 int n_proj, const void* gate, const void* res, int M, int K,
                 int N, int n_tok, int gated, int residual, cudaStream_t st) {
  dim3 grid((N + D_BN - 1) / D_BN, (M + D_BM - 1) / D_BM, n_proj);
  dense_int8_kernel<V><<<grid, D_THREADS, D_SMEM, st>>>(
      static_cast<const int8_t*>(xq), static_cast<const float*>(sx), p,
      static_cast<const float*>(gate), static_cast<const bf16*>(res), M, K, N,
      n_tok, gated, residual);
  return (int)cudaGetLastError();
}

}  // namespace

// K10a. x: (M, K) bf16, M = B * n_tok rows of B samples; shift, scale:
// (B, K) fp32; wq, wk, wv: (N, K) int8 with sq, sk, sv (N) fp32. Scratch:
// xq (M, K) int8, sx (M) fp32. q, k, v: (M, N) bf16. K a multiple of 16, N
// even; all pointers 16-byte aligned. Returns the CUDA error code of the
// launches (0 = success).
extern "C" int sd3_qkv_adaln_int8(const void* x, const void* shift,
                                  const void* scale, const void* wq,
                                  const void* wk, const void* wv,
                                  const void* sq, const void* sk,
                                  const void* sv, void* xq, void* sx, void* q,
                                  void* k, void* v, int M, int K, int N,
                                  int n_tok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = launch_xquant<V_K10A>(x, (long long)n_tok * K, shift, scale, xq, sx,
                                M, K, n_tok, 1, st);
  if (e != 0) return e;
  Projections p = {{static_cast<const int8_t*>(wq), static_cast<const int8_t*>(wk),
                    static_cast<const int8_t*>(wv)},
                   {static_cast<const float*>(sq), static_cast<const float*>(sk),
                    static_cast<const float*>(sv)},
                   {static_cast<bf16*>(q), static_cast<bf16*>(k),
                    static_cast<bf16*>(v)}};
  return launch_dense<V_K10A>(xq, sx, p, 3, nullptr, nullptr, M, K, N, n_tok,
                              0, 0, st);
}

// K10b. a: M = B * n_tok rows of K bf16, row r at a + (r / n_tok) *
// sample_stride + (r % n_tok) * K (elements); gate: (B, N) fp32 (read when
// gated); res: (M, N) bf16 (read when residual); w: (N, K) int8 with s (N)
// fp32. Scratch: aq (M, K) int8, sa (M) fp32. out: (M, N) bf16. K a
// multiple of 16, N even; all pointers but a 16-byte aligned. Returns the
// CUDA error code of the launches (0 = success).
extern "C" int sd3_out_gate_residual_int8(const void* a, long long sample_stride,
                                          const void* gate, const void* res,
                                          const void* w, const void* s,
                                          void* aq, void* sa, void* out, int M,
                                          int K, int N, int n_tok, int gated,
                                          int residual, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int e = launch_xquant<V_K10B>(a, sample_stride, nullptr, nullptr, aq, sa, M,
                                K, n_tok, 0, st);
  if (e != 0) return e;
  Projections p = {{static_cast<const int8_t*>(w), nullptr, nullptr},
                   {static_cast<const float*>(s), nullptr, nullptr},
                   {static_cast<bf16*>(out), nullptr, nullptr}};
  return launch_dense<V_K10B>(aq, sa, p, 1, gate, res, M, K, N, n_tok, gated,
                              residual, st);
}
