"""Where the time of the int8 block-tail projections goes (K10a, K10b:
sd3_torch/csrc/fused_dense.cu), on one NVIDIA Hopper GPU. From the root of
the repository (it takes its timing and bounds from chip_smoke.py there):

    python3 -m sd3_torch.utils.fused_dense_diag

1. "ptxas": registers, shared memory and spills of each kernel of the
   source, from the compiler's report of a fresh build;
2. "sass": in that build, for each kernel, its int8 wgmmas (IGMMA), its
   waits for wgmma groups (WARPGROUP.DEPBAR, by the count of groups they
   leave pending) and its local-memory stores (STL: spills);
3. "launches": at the 512px image stream (B 8 samples of 1024 tokens, K =
   d_out = 1216) and at CFG batch 2 (B 2), K10a and K10b as the model calls
   them (K10b on the image half of a joint sequence, gated, with the
   residual): the call in a CUDA graph with its bound, the device time of
   its launch (torch.profiler), and torch._int_mm of the products on
   activations quantized beforehand (the GEMMs alone: a yardstick the port
   never calls);
4. "phases": at the 512px image stream, from a copy of the kernel that reads
   the global timer: per CTA, the microseconds from the first CTA's start to
   the end of its item's prologue, of its first column tile and of its last;
   and per consumer (its thread 0) the time in waits for full ring stages,
   in waits for wgmma groups and in epilogues. Medians over the CTAs;
5. "copies": the call in a CUDA graph of copies with one change each, in
   turns with the kernel (kernel, copies, copies reversed, kernel): without
   the prologue (the A tile left as it is), without weight loads (each ring
   loaded once, its stages then handed over empty-handed), without the
   epilogue, without the products, with rings of 2 stages (3 in the
   kernel), and with the rows of x read through the L1.
One JSON line per part on stdout.
"""

from __future__ import annotations

import ctypes
import json
import statistics
import sys

import numpy as np

import chip_smoke as cs  # timing, bounds
from sd3_torch.utils.attention_sm90_diag import nvcc_build
from sd3_torch.utils.fused_mlp_diag import part_ptxas, part_sass

SOURCE = "fused_dense.cu"
WIDTH = 1216
BATCHES = (8, 2)  # the 512px image stream, and at CFG batch 2
TOKENS, TEXT = 1024, 154

TIMER = ("#include \"sm90.cuh\"\n",
         "#include \"sm90.cuh\"\n__device__ unsigned long long g_t[1024][8];\n"
         "__device__ __forceinline__ unsigned long long gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n")
DUMP = ("extern \"C\" int sd3_qkv_adaln_int8(",
        "extern \"C\" int sd3_phase_dump(void* dst) {\n"
        "  return (int)cudaMemcpyFromSymbol(dst, g_t, sizeof(g_t));\n}\n"
        "extern \"C\" int sd3_phase_zero() {\n"
        "  static unsigned long long z[1024][8];\n"
        "  return (int)cudaMemcpyToSymbol(g_t, z, sizeof(g_t));\n}\n"
        "extern \"C\" int sd3_qkv_adaln_int8(")
# The timed copy: (text, replacement), each once. Consumer 0's thread 0 of
# CTA b: g_t[b][0..3] the times at its start, at the end of the prologue,
# after its first tile's products and at its end; g_t[b][4..6] its time in
# waits for full stages, for wgmma groups and in epilogues.
PHASE_EDITS = [
    TIMER, DUMP,
    ("    setmaxnreg_inc<CONSUMER_REGS>();\n    const int c = wg - 1;\n",
     "    setmaxnreg_inc<CONSUMER_REGS>();\n    const int c = wg - 1;\n"
     "    const bool rec = threadIdx.x == WG;\n"
     "    unsigned long long w_full = 0, w_mma = 0, w_epi = 0, t_q;\n"
     "    if (rec) g_t[blockIdx.x][0] = gtime();\n"),
    ("        const int i = it + kt0, s = i % STAGES;\n        mbar_wait(full(c, s), (i / STAGES) & 1);\n",
     "        const int i = it + kt0, s = i % STAGES;\n        t_q = gtime();\n"
     "        mbar_wait(full(c, s), (i / STAGES) & 1);\n"
     "        w_full += gtime() - t_q;\n"),
    ("        const int i = it + kt, s = i % STAGES;\n        mbar_wait(full(c, s), (i / STAGES) & 1);\n",
     "        const int i = it + kt, s = i % STAGES;\n        t_q = gtime();\n"
     "        mbar_wait(full(c, s), (i / STAGES) & 1);\n"
     "        w_full += gtime() - t_q;\n"),
    ("        wgmma_wait<1>();  // the products of K tile kt - 1 are done\n",
     "        t_q = gtime();\n"
     "        wgmma_wait<1>();  // the products of K tile kt - 1 are done\n"
     "        w_mma += gtime() - t_q;\n"),
    ("      wgmma_wait<0>();\n      reg_fence(d);\n",
     "      t_q = gtime();\n      wgmma_wait<0>();\n      reg_fence(d);\n"
     "      w_mma += gtime() - t_q;\n"
     "      if (rec && tiles == 0) g_t[blockIdx.x][2] = gtime();\n"),
    ("      it += nk;\n",
     "      it += nk;\n      const unsigned long long t_e = gtime();\n"),
    ("        bulk_commit();\n      }\n    };\n",
     "        bulk_commit();\n      }\n      w_epi += gtime() - t_e;\n    };\n"),
    ("      fence_proxy_async_shared();\n      named_bar_sync(CONSUMERS_BAR, CONSUMERS * WG);\n",
     "      if (rec) g_t[blockIdx.x][1] = gtime();\n"
     "      fence_proxy_async_shared();\n"
     "      named_bar_sync(CONSUMERS_BAR, CONSUMERS * WG);\n"),
    ("    if (tid == 0) bulk_wait_read<0>();  // the output tile outlives its stores\n",
     "    if (rec) {\n      g_t[blockIdx.x][3] = gtime();\n"
     "      g_t[blockIdx.x][4] = w_full;\n      g_t[blockIdx.x][5] = w_mma;\n"
     "      g_t[blockIdx.x][6] = w_epi;\n    }\n"
     "    if (tid == 0) bulk_wait_read<0>();  // the output tile outlives its stores\n"),
]
PHASES = ["prologue done", "first tile done", "end", "waits for full stages",
          "waits for wgmma groups", "epilogues"]
# Copies with one change each: (text, replacement), each once.
COPIES = {
    "no prologue": [
        ("      load_row(m0 + lr0, k0, buf[0]);\n", ""),
        ("          if (i + 1 < ROWS_PER_WARP) load_row(m0 + lr0 + i + 1, k0, buf[k ^ 1]);\n"
         "          quantize_row(m0 + lr0 + i, lr0 + i, k0, ktiles, buf[k]);\n", "")],
    "no weight loads": [
        ("            mbar_arrive_expect_tx(full(c, s), B_TILE);\n"
         "            tma_load_2d(ring + s * B_TILE, m, full(c, s), kt * KT, col0);\n",
         "            if (it < STAGES) {\n"
         "              mbar_arrive_expect_tx(full(c, s), B_TILE);\n"
         "              tma_load_2d(ring + s * B_TILE, m, full(c, s), kt * KT, col0);\n"
         "            } else {\n              mbar_arrive(full(c, s));\n"
         "            }\n")],
    "no epilogue": [
        ("      named_bar_sync(OWN + c, WG);  // thread 0 saw the last store's reads end\n",
         "      if (M > 0) {\n        if (residual) mbar_wait(res_bar(c), tiles & 1);\n"
         "        ++tiles;\n        return;\n      }\n"
         "      named_bar_sync(OWN + c, WG);  // thread 0 saw the last store's reads end\n")],
    "no products": [
        ("          wgmma_s8<W>(d, desc_s8(sb, kk), desc_s8(ring + s * B_TILE, kk),\n"
         "                      kk > 0 || kt0 > 0);\n", "          d[kk] = kk;\n"),
        ("          wgmma_s8<W>(d, desc_s8(sb + (kt - kt0) * A_KTILE, kk),\n"
         "                      desc_s8(ring + s * B_TILE, kk), 1);\n",
         "          d[kk] += kt;\n")],
    "rings of 2 stages": [
        ("constexpr int STAGES = 3;", "constexpr int STAGES = 2;")],
    "x through the L1": [
        ("ld_once16(xr + e)", "*reinterpret_cast<const uint4*>(xr + e)")],
}


def edited(src: str, edits) -> str:
    for a, b in edits:
        if src.count(a) != 1:
            raise RuntimeError(f"anchor not found once: {a[:60]!r}")
        src = src.replace(a, b)
    return src


def case(b: int, gen):
    """Seeded operands of one image stream: x, the joint sequence's image
    half, conditioning, three int8 weights; (K10a's call, K10b's call,
    the int8 activations for the yardstick, the weights)."""
    import torch
    from sd3_torch.ops import fused_dense as fd
    from sd3_torch.ops.quant import quantize_rows, quantize_weight
    dev, bf, k = "cuda", torch.bfloat16, WIDTH
    rnd = lambda *sz, sd=1.0: torch.randn(sz, generator=gen, device=dev) * sd
    ws = [t for _ in range(3) for t in quantize_weight(rnd(k, k, sd=k ** -0.5))]
    x = rnd(b, TOKENS, k).to(bf)
    shift, scale, gate = (rnd(b, k, sd=0.3).to(bf) for _ in range(3))
    a = rnd(b, TOKENS + TEXT, k).to(bf)[:, :TOKENS]
    res = rnd(b, TOKENS, k).to(bf)
    xq, _ = quantize_rows(x.reshape(-1, k).float())
    return (lambda: fd.qkv_adaln_int8(x, shift, scale, *ws),
            lambda: fd.out_gate_residual_int8(a, gate, res, *ws[:2]), xq, ws)


def part_launches() -> dict:
    from sd3_torch.ops.quant import int_mm
    import torch
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for b in BATCHES:
        run_a, run_b, xq, ws = case(b, gen)
        m = b * TOKENS
        for name, run, n_w in (("K10a", run_a, 3), ("K10b", run_b, 1)):
            ops = 2.0 * m * WIDTH * WIDTH * n_w
            # x or a, the weights and scales, the outputs; shift and scale,
            # or gate and the residual
            nbytes = (m * WIDTH * 2 + n_w * WIDTH * (WIDTH + 4)
                      + n_w * m * WIDTH * 2
                      + (2 * b * WIDTH * 2 if n_w == 3
                         else b * WIDTH * 2 + m * WIDTH * 2))
            gemms = lambda: [int_mm(xq, w) for w in ws[0:2 * n_w:2]]
            res[f"{name} M={m}"] = dict(
                ms=cs.cuda_ms(run),
                **cs.bound(ops / cs.PEAK_INT8_OPS, nbytes / cs.PEAK_BYTES),
                us_per_launch=cs.per_launch_us(run),
                int_mm_gemms_alone_ms=cs.cuda_ms(gemms))
    return res


def bind(lib):
    """The copy's two entry points, as the wrappers bind theirs."""
    from sd3_torch.ops import fused_dense as fd
    fns = []
    for kern in (fd.K10A, fd.K10B):
        fn = getattr(lib, kern.symbol)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        fns.append(fn)
    return fns


def swapped(fns, run):
    """Run `run` with K10a / K10b bound to a copy's entry points."""
    from sd3_torch.ops import fused_dense as fd
    kept = [fd.K10A.function(), fd.K10B.function()]
    fd.K10A._fn, fd.K10B._fn = fns
    try:
        return run()
    finally:
        fd.K10A._fn, fd.K10B._fn = kept


def part_phases() -> dict:
    import torch
    from sd3_torch import kernels
    src = (kernels.CSRC_DIR / SOURCE).read_text()
    lib = ctypes.CDLL(nvcc_build(edited(src, PHASE_EDITS), "fused_dense_phases"))
    fns = bind(lib)
    gen = torch.Generator(device="cuda").manual_seed(0)
    run_a, run_b, _, _ = case(BATCHES[0], gen)
    res = {}
    for name, run in (("K10a", run_a), ("K10b", run_b)):
        def once():
            run()
            torch.cuda.synchronize()
            lib.sd3_phase_zero()
            run()
            torch.cuda.synchronize()
        swapped(fns, once)
        buf = np.zeros((1024, 8), np.uint64)
        if lib.sd3_phase_dump(ctypes.c_void_p(buf.ctypes.data)):
            raise RuntimeError("phase dump failed")
        t = buf[buf[:, 3] > 0].astype(np.float64)
        since = t[:, 1:4] - t[:, 0].min()
        cols = np.concatenate([since, t[:, 4:7]], axis=1) / 1e3
        res[name] = dict(ctas=len(t), us={p: round(float(np.median(cols[:, i])), 2)
                                          for i, p in enumerate(PHASES)})
    return res


def part_copies() -> dict:
    import torch
    from sd3_torch import kernels
    src = (kernels.CSRC_DIR / SOURCE).read_text()
    libs = {n: ctypes.CDLL(nvcc_build(edited(src, e), "fused_dense_" +
                                      n.replace(" ", "_")))
            for n, e in COPIES.items()}
    fns = {n: bind(lib) for n, lib in libs.items()}
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for b in BATCHES:
        run_a, run_b, _, _ = case(b, gen)
        order = ["kernel", *COPIES, *reversed(COPIES), "kernel"]
        got = {}
        for n in order:
            for kname, run in (("K10a", run_a), ("K10b", run_b)):
                ms = (cs.cuda_ms(run) if n == "kernel"
                      else swapped(fns[n], lambda: cs.cuda_ms(run)))
                got.setdefault((kname, n), []).append(ms)
        res[f"M={b * TOKENS}"] = {f"{k} {n}": statistics.median(v)
                                  for (k, n), v in got.items()}
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", flush=True)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    report: list = []
    from sd3_torch import kernels
    lib = nvcc_build((kernels.CSRC_DIR / SOURCE).read_text(), "fused_dense",
                     report)
    for part, fn in (("ptxas", lambda: part_ptxas(report[0])),
                     ("sass", lambda: part_sass(lib)),
                     ("launches", part_launches),
                     ("phases", part_phases),
                     ("copies", part_copies)):
        print(json.dumps({part: fn()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
