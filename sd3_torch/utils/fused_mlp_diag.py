"""Where the time of the int8 SwiGLU kernels goes (K2, K3, K9:
sd3_torch/csrc/fused_mlp.cu), on one NVIDIA Hopper GPU. From the root of the
repository (it takes its shapes, timing and bounds from chip_smoke.py
there):

    python3 -m sd3_torch.utils.fused_mlp_diag

1. "ptxas": registers, shared memory and spills of each kernel of the
   source, from the compiler's report of a fresh build beside the library;
2. "sass": in that build, for each kernel, its int8 wgmmas (IGMMA), its
   waits for wgmma groups (WARPGROUP.DEPBAR, by the count of groups they
   leave pending), its exp and reciprocal instructions (MUFU) and its
   local-memory stores (STL: spills);
3. "launches": at the 512px image stream (M 8192) and text stream (M 1232)
   and the 1024px image stream (M 32768), for K2, K3 and K9 as the model
   calls them: the device time of each launch (the per-row quantization
   prologue, the w12 product with silu * mul and h's requantization, the
   w3 product with its epilogue; torch.profiler), the call in a CUDA graph
   with its bound, and torch._int_mm of the two products on operands
   quantized beforehand (the GEMMs alone: a yardstick the port never
   calls);
4. "phases": at the 512px image stream (K2), the cycles per item of each
   consumer of the h launch in each phase (its mainloop over a pass's
   tiles, the last item's staged rounding run inside it, the waits for
   full stages, the drain of the last products, dequant + silu, the
   rounding of the last pass), from a copy of the kernel with clock64()
   around each phase; and the h launch of a copy that does not store hq
   (its rounding kept), beside the kernel's;
5. "rate": a microbenchmark of one CTA per SM, two warpgroups issuing
   wgmma m64n256k32 s8 back to back on tiles in shared memory: int8 MACs
   a clock an SM and TOP/s, the rate the products can reach.
One JSON line per part on stdout.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np

import chip_smoke as cs  # shapes, timing, bounds
from sd3_torch.utils.attention_sm90_diag import nvcc_build

SOURCE = "fused_mlp.cu"
# (kernel, rows, tokens per sample) at the streams the model hands over
STREAMS = (("K2", 8 * 1024, 1024), ("K9", 8 * 1024, 1024),
           ("K3", 8 * 154, 8 * 154), ("K9", 8 * 154, 154),
           ("K2", 8 * 4096, 4096))
WIDTH, HIDDEN = 1216, 4864


# The instrumented copy: (text of the source, its replacement). Each must
# match once; the anchors are those of the kernel as committed. Per consumer
# thread 0 of each CTA of the K2 (V = 2) h launch: cycles in the mainloop
# (the deferred rounding included), in the deferred rounding, in the waits
# for full stages, in the drain, in dequant + silu, in the last pass's
# rounding, and the CTA's items.
PHASE_EDITS = [
    ('#include "sm90.cuh"\n',
     '#include "sm90.cuh"\n__device__ unsigned long long g_phase[1024 * 2 * 8];\n'),
    ('extern "C" int sd3_swiglu_int8_tail(',
     'extern "C" int sd3_phase_dump(void* dst, int n) {\n'
     '  return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)n * 8);\n}\n'
     'extern "C" int sd3_swiglu_int8_tail('),
    ("    for (int q = 0; q < n_local; ++q) {\n      int rb, chunk;\n"
     "      item_of(q, rb, chunk);\n      const int r0 = rb",
     "    unsigned long long T[6] = {0, 0, 0, 0, 0, 0};\n"
     "    for (int q = 0; q < n_local; ++q) {\n      int rb, chunk;\n"
     "      item_of(q, rb, chunk);\n      const int r0 = rb"),
    ("        const int base = (q * UNITS + u) * nk;\n"
     "        for (int kt = 0; kt < nk; ++kt) {\n"
     "          const int it = base + kt, s = it % STAGES;\n"
     "          mbar_wait(full + 8 * s, (it / STAGES) & 1);\n",
     "        const int base = (q * UNITS + u) * nk;\n"
     "        const unsigned long long c0 = clock64();\n"
     "        for (int kt = 0; kt < nk; ++kt) {\n"
     "          const int it = base + kt, s = it % STAGES;\n"
     "          const unsigned long long cw = clock64();\n"
     "          mbar_wait(full + 8 * s, (it / STAGES) & 1);\n"
     "          T[2] += clock64() - cw;\n"),
    ("          for (const int to = pend_all * (kt + 1) / nk; pend_done < to;)\n"
     "            pend_step();\n        }\n        wgmma_wait<0>();\n"
     "        reg_fence(acc);\n        release(base + nk - 1);\n",
     "          const unsigned long long cp = clock64();\n"
     "          for (const int to = pend_all * (kt + 1) / nk; pend_done < to;)\n"
     "            pend_step();\n          T[1] += clock64() - cp;\n        }\n"
     "        const unsigned long long c1 = clock64();\n"
     "        T[0] += c1 - c0;\n        wgmma_wait<0>();\n"
     "        reg_fence(acc);\n        release(base + nk - 1);\n"
     "        const unsigned long long c2 = clock64();\n"
     "        T[3] += c2 - c1;\n"),
    ("        const int cb = chunk * HG + p * PASS_COLS;\n",
     "        const int cb = chunk * HG + p * PASS_COLS;\n"
     "        const unsigned long long c3 = clock64();\n"
     "        T[4] += c3 - c2;\n"),
    ("          pend_all = (P - 1) * PASS_COLS / 8;\n",
     "          pend_all = (P - 1) * PASS_COLS / 8;\n"
     "          T[5] += clock64() - c3;\n"),
    ("    while (pend_done < pend_all) pend_step();  // the last item's\n",
     "    while (pend_done < pend_all) pend_step();  // the last item's\n"
     "    if (tid == 0 && V == V_K2) {\n"
     "      unsigned long long* out = g_phase + (blockIdx.x * 2 + c) * 8;\n"
     "      for (int i = 0; i < 6; ++i) out[i] = T[i];\n"
     "      out[6] = n_local;\n    }\n"),
]
PHASES = ["mainloop", "deferred rounding in it", "waits for full stages",
          "drain", "dequant + silu", "rounding of the last pass"]
# The copy that keeps its rounding (folded into a value it stores once, if
# ever) and stores nothing of hq: (text, replacement), each once.
NO_STORES = [
    ("""      if (r0 < M)
        *reinterpret_cast<uint16_t*>(hq + (size_t)r0 * hidden + col) =
            (uint16_t)(q & 0xffffu);
      if (r1 < M)
        *reinterpret_cast<uint16_t*>(hq + (size_t)r1 * hidden + col) =
            (uint16_t)(q >> 16);
""", """      sink ^= q + col;
"""),
    ("    int acc[PASS_COLS];  ", "    uint32_t sink = 0;\n    int acc[PASS_COLS];  "),
    ("    while (pend_done < pend_all) pend_step();  // the last item's\n",
     "    while (pend_done < pend_all) pend_step();  // the last item's\n"
     "    if (sink == 0x5a5a5a5au) hq[tid] = (int8_t)sink;\n"),
]

RATE_CU = r"""
#include "sm90.cuh"
// two warpgroups, each R iterations of 4 x wgmma m64n256k32 s8 on the same
// shared-memory tiles; cycles of each in cyc
__global__ void __launch_bounds__(256, 1) rate(int iters, long long* cyc,
                                               int* sink) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  for (int i = threadIdx.x; i < 384 * 128 / 4; i += 256)
    reinterpret_cast<uint32_t*>(smem)[i] = i * 2654435761u;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const uint32_t a = smem_u32(smem) + wg * 64 * 128;
  const uint32_t b = smem_u32(smem) + 128 * 128;
  int acc[128];
  const long long t0 = clock64();
  for (int r = 0; r < iters; ++r) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_s8<256>(acc, desc_s8(a, kk), desc_s8(b, kk), r > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<1>();
  }
  wgmma_wait<0>();
  reg_fence(acc);
  const long long t1 = clock64();
  int sum = 0;
  for (int i = 0; i < 128; ++i) sum += acc[i];
  if (sum == 12345) sink[0] = sum;
  if (threadIdx.x % 128 == 0) cyc[blockIdx.x * 2 + wg] = t1 - t0;
}
extern "C" int run_rate(int blocks, int iters, long long* cyc, int* sink,
                        void* stream) {
  const int smem = 384 * 128 + 1024;
  cudaFuncSetAttribute(rate, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       smem);
  rate<<<blocks, 256, smem, (cudaStream_t)stream>>>(iters, cyc, sink);
  return (int)cudaGetLastError();
}
"""


def fresh_build() -> tuple[str, str]:
    """nvcc of the source into _build/diag: (library path, ptxas report)."""
    from sd3_torch import kernels
    out_dir = kernels.BUILD_DIR / "diag"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "fused_mlp.so"
    r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                        str(lib), str(kernels.CSRC_DIR / SOURCE)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {SOURCE}:\n{r.stdout}{r.stderr}")
    return str(lib), r.stdout + r.stderr


def part_ptxas(report: str) -> dict:
    res, fn = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = ln.split("'")[1]
        elif fn and ("Used" in ln or "spill" in ln):
            res.setdefault(fn, []).append(ln.split("ptxas info    :")[-1]
                                          .strip())
    return res


def part_sass(lib: str) -> dict:
    from sd3_torch import kernels
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    res = {}
    for fn in txt.split("Function : ")[1:]:
        head = fn.split("\n")[0].strip()
        res[head] = dict(
            igmma=fn.count("IGMMA"),
            wait_pending_0=fn.count("DEPBAR.LE gsb0, 0x0"),
            wait_pending_1=fn.count("DEPBAR.LE gsb0, 0x1"),
            mufu=fn.count("MUFU."), local_stores=fn.count("STL"))
    return res


def call(kind: str, m: int, n_tok: int, gen):
    """The wrapper of `kind` on seeded operands of one stream, as the model
    calls it (K3: the chain alone; K2, K9: AdaLN, gate and residual), with
    its h_group as the model's picker gives it; returns (run, operands)."""
    import torch
    from sd3_torch.ops import fused_mlp as fm
    from sd3_torch.ops.quant import quantize_weight

    dev, bf = "cuda", torch.bfloat16
    rnd = lambda *sz, sd=1.0: torch.randn(sz, generator=gen, device=dev) * sd
    k, hidden = WIDTH, HIDDEN
    b = m // n_tok
    x = rnd(m, k).to(bf)
    w12_q, s12 = quantize_weight(rnd(2 * hidden, k, sd=k ** -0.5))
    w3_q, s3 = quantize_weight(rnd(k, hidden, sd=hidden ** -0.5))
    b12, b3 = (rnd(n, sd=0.1).to(bf) for n in (2 * hidden, k))
    shift, scale, gate = (rnd(b, k, sd=0.3).to(bf) for _ in range(3))
    w = (w12_q, s12, b12, w3_q, s3, b3)
    if kind == "K3":
        hg = fm.pick_block_chunk(m, hidden, k, k)[1]
        run = lambda: fm.swiglu_int8(x, *w, h_group=hg)
    elif kind == "K2":
        hg = fm.pick_tail_blocks(m, n_tok, hidden, k, k)[1]
        run = lambda: fm.swiglu_int8_tail(x, shift, scale, gate, *w,
                                          n_tok=n_tok, h_group=hg)
    else:
        hg = fm.pick_blocks(n_tok, hidden)[1]
        run = lambda: fm.swiglu_int8_tail3d(x, shift, scale, gate, *w,
                                            n_tok=n_tok, h_group=hg)
    return run, dict(x=x, w12_q=w12_q, w3_q=w3_q, h_group=hg)


def part_launches() -> dict:
    import torch
    from sd3_torch.ops.quant import int_mm

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for kind, m, n_tok in STREAMS:
        run, t = call(kind, m, n_tok, gen)
        ops = 2.0 * m * WIDTH * 2 * HIDDEN + 2.0 * m * HIDDEN * WIDTH
        xq = torch.randint(-127, 128, (m, WIDTH), generator=gen,
                           device="cuda", dtype=torch.int8)
        hq = torch.randint(-127, 128, (m, HIDDEN), generator=gen,
                           device="cuda", dtype=torch.int8)
        gemms = lambda: (int_mm(xq, t["w12_q"]), int_mm(hq, t["w3_q"]))
        res[f"{kind} M={m} n_tok={n_tok} h_group={t['h_group']}"] = dict(
            ms=cs.cuda_ms(run), **cs.bound(ops / cs.PEAK_INT8_OPS, 0.0),
            int_mm_gemms_alone_ms=cs.cuda_ms(gemms),
            us_per_launch=cs.per_launch_us(run))
    return res


def with_copy(kern, lib, run):
    """Run `run` with `kern` bound to the same entry point of a copy's
    library: (the copy's ms, its device time of each launch in us)."""
    import torch
    fn = getattr(lib, kern.symbol)
    fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
    kept = kern.function()
    kern._fn = fn
    try:
        ms = cs.cuda_ms(run)
        launches = cs.per_launch_us(run)
        run()
        torch.cuda.synchronize()
    finally:
        kern._fn = kept
    return ms, launches


def part_phases() -> dict:
    import torch
    from sd3_torch import kernels
    from sd3_torch.ops import fused_mlp as fm
    src = (kernels.CSRC_DIR / SOURCE).read_text()
    timed = src
    for a, b in PHASE_EDITS:
        if timed.count(a) != 1:
            raise RuntimeError(f"anchor not found once: {a[:60]!r}")
        timed = timed.replace(a, b)
    bare = src
    for a, b in NO_STORES:
        if bare.count(a) != 1:
            raise RuntimeError(f"anchor not found once: {a[:60]!r}")
        bare = bare.replace(a, b)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run, t = call("K2", 8 * 1024, 1024, gen)
    lib = ctypes.CDLL(nvcc_build(timed, "fused_mlp_phases"))
    copy_ms, _ = with_copy(fm.K2, lib, run)
    ctas = torch.cuda.get_device_properties(0).multi_processor_count
    buf = np.zeros(ctas * 16, np.uint64)
    lib.sd3_phase_dump(ctypes.c_void_p(buf.ctypes.data), ctypes.c_int(buf.size))
    tr = buf.reshape(ctas, 2, 8).astype(np.float64)
    per_item = [{p: round(float(np.median(tr[:, c, i] / tr[:, c, 6])))
                 for i, p in enumerate(PHASES)} for c in (0, 1)]
    nostore = ctypes.CDLL(nvcc_build(bare, "fused_mlp_nostores"))
    _, nostore_launches = with_copy(fm.K2, nostore, run)
    return dict(copy_ms=copy_ms, cycles_per_item=per_item,
                items_per_cta=float(np.median(tr[:, 0, 6])),
                kernel_us_per_launch=cs.per_launch_us(run),
                without_hq_stores_us_per_launch=nostore_launches)


def part_rate() -> dict:
    import torch
    lib = ctypes.CDLL(nvcc_build(RATE_CU, "int8_wgmma_rate"))
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    cyc = torch.zeros(blocks * 2, dtype=torch.int64, device="cuda")
    sink = torch.zeros(1, dtype=torch.int32, device="cuda")
    iters = 2000
    stream = torch.cuda.current_stream().cuda_stream
    run = lambda: lib.run_rate(blocks, iters, ctypes.c_void_p(cyc.data_ptr()),
                               ctypes.c_void_p(sink.data_ptr()),
                               ctypes.c_void_p(stream))
    if run():
        raise RuntimeError("rate launch failed")
    ms = cs.cuda_ms(run, iters=3, groups=3, graph=False)
    macs = 2.0 * blocks * iters * 4 * 64 * 256 * 32
    clk = cyc.double().median().item() / iters
    return dict(mac_per_clock_per_sm=2 * 4 * 64 * 256 * 32 / clk,
                tops=2 * macs / ms / 1e9, ms=ms)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", flush=True)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    lib, report = fresh_build()
    for part, fn in (("ptxas", lambda: part_ptxas(report)),
                     ("sass", lambda: part_sass(lib)),
                     ("launches", part_launches),
                     ("phases", part_phases),
                     ("rate", part_rate)):
        print(json.dumps({part: fn()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
