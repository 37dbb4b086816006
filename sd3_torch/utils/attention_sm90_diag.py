"""Where the time of the wgmma attention kernels goes (K1, K7:
sd3_torch/csrc/attention_sm90.cu; K4, K8b: attention_int8_sm90.cu), on one
NVIDIA Hopper GPU. From the root
of the repository (it takes its shapes, inputs and timing from
chip_smoke.py there):

    python3 -m sd3_torch.utils.attention_sm90_diag

1. "launches": device time of each launch of one K1 and one K7 call at the
   slice shapes (torch.profiler), beside scaled_dot_product_attention on
   q / k / v prepared beforehand (a yardstick; the port never calls it);
2. "phases": cycles per key tile of each consumer warpgroup in each phase
   of its loop (waiting for its turn, issuing S, issuing P.V, waiting for
   S, the softmax, waiting for P.V, release / rescale / pack), from a copy
   of the kernel with clock64() around each phase, built beside the
   library (its times are the copy's, a little slower than the kernel's);
3. "sass": in the built library, the exp2s (MUFU.EX2) of each D = 64
   kernel placed between the loop's two wgmma waits, where they overlap
   the products, and the spill stores ptxas reports;
4. "overlap": a microbenchmark of one block per SM, one warpgroup issuing
   wgmma m64n128k16 back to back and the other a stream of ex2 or FFMA,
   alone and together: cycles per iteration of each.
The same for the int8 attention kernels (K4, K8b:
sd3_torch/csrc/attention_int8_sm90.cu):
5. "int8_sass": registers and spills of each instance (ptxas, from a fresh
   build), and in the SASS of each D = 64 instance the count of exp2s
   (MUFU.EX2), F2I and I2F conversions, byte permutes (PRMT), wgmmas
   (HGMMA bf16, IGMMA s8), wgmma waits (WARPGROUP.DEPBAR) and spill stores
   (STL), in the whole kernel (its key-tile body appears twice: tile 0 and
   the main loop) and between the main loop's wait for S and its wait for
   P.V (the softmax), and per key tile of the main loop (its instructions
   counted too), with ptxas's advisories; K7's main loop beside them;
6. "int8_launches": the device time of each launch of K4 at the 512px
   slice shape and of K8b (over K7's and over K7q's scores) at the 1024px
   one, with the call times of K1 and K7 in the same process;
7. "int8_phases": cycles per key tile of each consumer warpgroup in each
   phase of the main loop (waiting for its turn, issuing S and P.V,
   waiting for S, dequant + mask + softmax (K8b: and packing its
   levels), waiting for P.V, adding P.V (K8b) or packing p (K4)), medians
   over the CTAs of one call, from an instrumented
   copy (its times are the copy's);
8. "int8_variants": call times of K4 and K8b built from copies of the
   source with one change each (INT8_VARIANTS), beside the source's own,
   each in turn, in the same process.
`python3 -m sd3_torch.utils.attention_sm90_diag int8` runs parts 5-8 only.
One JSON line per part on stdout.
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np

import chip_smoke as cs  # shapes, inputs, timing

# The instrumented copy: (text of the source, its replacement). Each must
# match once; the loop's anchors are those of the kernel as committed.
PHASE_EDITS = [
    ("namespace {\n\nconstexpr int KEY_TILE",
     "__device__ unsigned long long g_phase[2 * 8 * 8192];\n"
     "namespace {\n\nconstexpr int KEY_TILE"),
    ('extern "C" int sd3_fused_attention_bf16(',
     'extern "C" int sd3_phase_dump(void* dst, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)n * 8);\n}\n"
     'extern "C" int sd3_fused_attention_bf16('),
    ("    for (int t = 1; t < ntiles; ++t) {\n      take_turn();\n"
     "      issue_scores(t);   // S of tile t ...\n"
     "      issue_pv(t - 1);   // ... and P.V of tile t-1 on the tensor cores\n"
     "      hand_over();\n      wgmma_wait<1>();   // S of tile t done\n"
     "      reg_fence(s);\n      release(empty_k, t);\n"
     "      softmax(t, a0, a1);  // while P.V of tile t-1 and the other's run\n",
     "    long long tw[7] = {0, 0, 0, 0, 0, 0, 0};\n"
     "    for (int t = 1; t < ntiles; ++t) {\n"
     "      const long long c0 = clock64();\n      take_turn();\n"
     "      const long long c1 = clock64();\n      issue_scores(t);\n"
     "      const long long c2 = clock64();\n      issue_pv(t - 1);\n"
     "      hand_over();\n      const long long c3 = clock64();\n"
     "      wgmma_wait<1>();\n      reg_fence(s);\n"
     "      const long long c4 = clock64();\n      release(empty_k, t);\n"
     "      softmax(t, a0, a1);\n      reg_fence(s);\n"
     "      const long long c5 = clock64();\n"),
    ("      reg_fence(acc);\n      reg_fence(p);\n      release(empty_v, t - 1);\n",
     "      reg_fence(acc);\n      reg_fence(p);\n"
     "      const long long c6 = clock64();\n      release(empty_v, t - 1);\n"),
    ("      pack_p();\n    }\n    take_turn();",
     "      pack_p();\n      reg_fence(p);\n"
     "      const long long c7 = clock64();\n"
     "      tw[0] += c1 - c0; tw[1] += c2 - c1; tw[2] += c3 - c2;\n"
     "      tw[3] += c4 - c3; tw[4] += c5 - c4; tw[5] += c6 - c5;\n"
     "      tw[6] += c7 - c6;\n    }\n"
     "    if (tid == 0) {\n      const int blk = blockIdx.x + gridDim.x *"
     " (blockIdx.y + gridDim.y * blockIdx.z);\n"
     "      unsigned long long* out = g_phase + (size_t)(blk * 2 + c) * 8;\n"
     "      for (int i = 0; i < 7; ++i) out[i] = tw[i];\n"
     "      out[7] = ntiles;\n    }\n    take_turn();"),
]
PHASES = ["wait turn", "issue S", "issue P.V", "wait S", "softmax",
          "wait P.V", "release, rescale, pack"]

OVERLAP_CU = r'''
#include "sm90.cuh"
// mode bit 0: warpgroup 0 issues wgmma; bit 1: warpgroup 1 runs ex2, bit 2:
// FFMA instead
__global__ void __launch_bounds__(256, 1) overlap(float* out, long long* cyc,
                                                  int mode, int iters) {
  extern __shared__ __align__(1024) unsigned char smem[];
  for (int i = threadIdx.x; i < 24576 / 4; i += 256)
    reinterpret_cast<uint32_t*>(smem)[i] = 0;
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();
  const int wg = threadIdx.x / 128;
  const long long t0 = clock64();
  float r = 0.f;
  if (wg == 0 && (mode & 1)) {
    float acc[64];
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    const uint32_t a = smem_u32(smem), b = a + 8192;
    for (int it = 0; it < iters; ++it) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss<128>(acc, gmma_desc(a + kk * 32, 16, 1024, kSwizzle128B),
                      gmma_desc(b + kk * 32, 16, 1024, kSwizzle128B), 1);
      wgmma_commit();
      wgmma_wait<0>();
      reg_fence(acc);
    }
    for (int i = 0; i < 64; ++i) r += acc[i];
  }
  if (wg == 1 && (mode & 6)) {
    float x[8];
    for (int i = 0; i < 8; ++i) x[i] = (threadIdx.x + i) * 1e-3f;
    for (int it = 0; it < iters * 16; ++it) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (mode & 2) {
          float y;
          asm volatile("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x[i]));
          x[i] = y * -0.5f;
        } else {
          x[i] = fmaf(x[i], 0.999f, 1e-3f);
        }
      }
    }
    for (int i = 0; i < 8; ++i) r += x[i];
  }
  const long long t1 = clock64();
  out[blockIdx.x * 256 + threadIdx.x] = r;
  if (threadIdx.x % 128 == 0) cyc[blockIdx.x * 2 + wg] = t1 - t0;
}
extern "C" int run_overlap(float* out, long long* cyc, int blocks, int mode,
                           int iters) {
  cudaFuncSetAttribute(overlap, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       100000);
  overlap<<<blocks, 256, 100000>>>(out, cyc, mode, iters);
  return (int)cudaGetLastError();
}
'''


def nvcc_build(src_text: str, name: str, report: list | None = None) -> str:
    """Build a copy of a source into its own library beside the kernels';
    the compiler's report appended to `report` if given."""
    from sd3_torch import kernels
    out_dir = kernels.BUILD_DIR / "diag"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / f"{name}.cu"
    src.write_text(src_text)
    lib = out_dir / f"{name}.so"
    r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-I",
                        str(kernels.CSRC_DIR), "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    if r.returncode:
        raise RuntimeError(f"nvcc {name}:\n{r.stdout}{r.stderr}")
    if report is not None:
        report.append(r.stdout + r.stderr)
    return str(lib)


def part_launches(gen) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sd3_torch.ops import fused_attention as fa
    res = {}
    for name, shape in (("K1", cs.SLICE), ("K7", cs.SLICE_1024)):
        q, k, v, _, _, _, tabs = cs.attn_inputs(shape, gen)
        nh, d, n = shape["heads"], shape["d"], q.shape[1]
        run = lambda: fa.fused_attention(q, k, v, nh, *tabs, d ** -0.5)
        heads = [x.reshape(shape["b"], n, nh, d).transpose(1, 2).contiguous()
                 for x in (q, k, v)]
        sdpa = lambda: torch.nn.functional.scaled_dot_product_attention(
            *heads, scale=d ** -0.5)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                run()
            torch.cuda.synchronize()
        name_of = lambda key: key.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0][:60]
        per = {name_of(e.key): e.self_device_time_total / e.count
               for e in prof.key_averages() if e.self_device_time_total > 0}
        res[name] = dict(call_ms=cs.cuda_ms(run), sdpa_ms=cs.cuda_ms(sdpa),
                         us_per_launch=per)
    return res


def part_phases(gen) -> dict:
    import torch
    from sd3_torch import kernels
    from sd3_torch.ops import fused_attention as fa
    src = (kernels.CSRC_DIR / "attention_sm90.cu").read_text()
    for a, b in PHASE_EDITS:
        if src.count(a) != 1:
            raise RuntimeError(f"anchor not found once: {a[:60]!r}")
        src = src.replace(a, b)
    lib = ctypes.CDLL(nvcc_build(src, "attention_sm90_phases"))
    res = {}
    for name, shape, kern in (("K1", cs.SLICE, fa.K1),
                              ("K7", cs.SLICE_1024, fa.K7)):
        q, k, v, _, _, _, tabs = cs.attn_inputs(shape, gen)
        nh, d = shape["heads"], shape["d"]
        fn = getattr(lib, kern.symbol)
        fn.argtypes, fn.restype = kern.argtypes, ctypes.c_int
        kept = kern.function()
        kern._fn = fn
        try:
            run = lambda: fa.fused_attention(q, k, v, nh, *tabs, d ** -0.5)
            ms = cs.cuda_ms(run)
            run()
            torch.cuda.synchronize()
        finally:
            kern._fn = kept
        blocks = -(-q.shape[1] // 128) * nh * shape["b"]
        buf = np.zeros(blocks * 16, np.uint64)
        lib.sd3_phase_dump(ctypes.c_void_p(buf.ctypes.data),
                           ctypes.c_int(buf.size))
        tr = buf.reshape(blocks, 2, 8).astype(np.float64)
        tiles = tr[0, 0, 7] - 1
        res[name] = dict(copy_ms=ms, cycles_per_tile=[
            {p: round(float(np.median(tr[:, c, i])) / tiles, 1)
             for i, p in enumerate(PHASES)} for c in (0, 1)])
    return res


# The wait for P.V as a plain wgmma_wait<0>(), without the branch that holds
# it below the softmax: the copy part_sass compares with the kernel.
UNBRANCHED_WAIT = ("      if (__shfl_sync(0xffffffffu, __float_as_uint(l0 + l1), 0) !=\n"
                   "          0xffffffffu) {\n        wgmma_wait<0>();\n"
                   "      } else {\n        wgmma_wait<0>();\n        __trap();\n"
                   "      }\n", "      wgmma_wait<0>();\n")


def exp2_between_waits(lib: str) -> dict:
    """MUFU.EX2 of each D = 64 kernel between the loop's wait for S
    (DEPBAR.LE gsb0, 0x1) and its wait for P.V (0x0), and in all."""
    from sd3_torch import kernels
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    res = {}
    for fn in txt.split("Function : ")[1:]:
        head = fn.split("\n")[0]
        if "attn_sm90_kernelILi64" not in head:
            continue
        i = fn.find("DEPBAR.LE gsb0, 0x1")
        j = fn.find("DEPBAR.LE gsb0, 0x0", i)
        res["Online" if "Online" in head else "Bounded"] = dict(
            between_waits=fn[i:j].count("MUFU.EX2"),
            total=fn.count("MUFU.EX2"))
    return res


def part_sass() -> dict:
    from sd3_torch import kernels
    reports = kernels.build(["attention_sm90.cu"])
    src = (kernels.CSRC_DIR / "attention_sm90.cu").read_text()
    if src.count(UNBRANCHED_WAIT[0]) != 1:
        raise RuntimeError("the branch-held wait is not in the source")
    copy = nvcc_build(src.replace(*UNBRANCHED_WAIT), "attention_sm90_unbranched")
    spills, fn = [], None
    for rep in reports.values():
        for ln in rep.splitlines():
            if "Function properties for" in ln:
                fn = ln.split("for", 1)[1].strip()
            elif "spill stores" in ln and " 0 bytes spill stores" not in ln:
                spills.append(f"{fn}: {ln.strip()}")
    return dict(
        kernel=exp2_between_waits(str(kernels._library_path("attention_sm90.cu"))),
        unbranched_wait_copy=exp2_between_waits(copy),
        spills=spills if reports else "library cached: not reported")


def part_overlap() -> dict:
    import torch
    lib = ctypes.CDLL(nvcc_build(OVERLAP_CU, "overlap"))
    blocks = torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.empty(blocks * 256, device="cuda")
    cyc = torch.zeros(blocks * 2, dtype=torch.int64, device="cuda")
    iters, res = 2000, {}
    for mode, name in ((1, "wgmma"), (2, "ex2"), (4, "ffma"),
                       (3, "wgmma + ex2"), (5, "wgmma + ffma")):
        for _ in range(2):
            err = lib.run_overlap(ctypes.c_void_p(out.data_ptr()),
                                  ctypes.c_void_p(cyc.data_ptr()), blocks,
                                  mode, iters)
            torch.cuda.synchronize()
        if err:
            raise RuntimeError(f"overlap launch failed: {err}")
        c = cyc.view(blocks, 2).double().median(0).values / iters
        res[name] = dict(wgmma_clk_per_iter=round(c[0].item(), 1),
                         stream_clk_per_iter=round(c[1].item(), 1))
    return res


INT8_SOURCE = "attention_int8_sm90.cu"
# the D = 64 instances of attn_int8_sm90_kernel<D, QK8, PV8> by their mangled
# template arguments
INT8_INSTANCES = (("K4", "ILi64ELb1ELb0E"), ("K8b", "ILi64ELb0ELb1E"),
                  ("K8b over K7q", "ILi64ELb1ELb1E"))
SASS_OPS = ("MUFU.EX2", "F2I", "I2F", "PRMT", "HGMMA", "IGMMA",
            "WARPGROUP.DEPBAR", "STL")


def sass_functions(lib: str) -> dict:
    """{function name: its SASS} of a built library (cuobjdump)."""
    from sd3_torch import kernels
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    txt = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    return {fn.split("\n")[0].strip(): fn
            for fn in txt.split("Function : ")[1:]}


def _count(sass: str) -> dict:
    return {op: sass.count(op) for op in SASS_OPS}


def loop_body(sass: str) -> str:
    """The SASS of the main loop: from the target of the first backward
    branch after the loop's wait for S (DEPBAR.LE gsb0, 0x1) to that
    branch; empty if the listing's form is not recognised."""
    lines = [(int(m.group(1), 16), ln) for ln in sass.splitlines()
             if (m := re.search(r"/\*([0-9a-f]{4,})\*/", ln))]
    at = next((a for a, ln in lines if "DEPBAR.LE gsb0, 0x1" in ln), None)
    if at is None:
        return ""
    for a, ln in lines:
        m = re.search(r"BRA\s+(?:\S+\s+)?0x([0-9a-f]+)", ln)
        if a > at and m and int(m.group(1), 16) < at:
            lo = int(m.group(1), 16)
            return "\n".join(l for x, l in lines if lo <= x <= a)
    return ""


def _loop_count(sass: str) -> dict:
    """Counts per key tile of the main loop (its body may hold two tiles:
    one wait for S, DEPBAR.LE gsb0 0x1, each)."""
    body = loop_body(sass)
    tiles = max(body.count("DEPBAR.LE gsb0, 0x1"), 1)
    counts = dict(_count(body), instructions=len(body.splitlines()))
    return dict({k: v / tiles for k, v in counts.items()}, tiles=tiles)


def part_int8_sass() -> dict:
    from sd3_torch import kernels
    report = []
    lib = nvcc_build((kernels.CSRC_DIR / INT8_SOURCE).read_text(),
                     "attention_int8_sm90_fresh", report)
    regs, fn = {}, None
    for ln in report[0].splitlines():
        if "Function properties for" in ln:
            fn = ln.split("for", 1)[1].strip()
        elif fn and "attn_int8_sm90_kernel" in fn and (
                "spill" in ln or "Used" in ln):
            tag = fn[fn.index("attn_int8_sm90_kernel") + 21:][:16]
            regs.setdefault(tag, []).append(ln.strip())
        elif "warning" in ln or "C75" in ln:  # e.g. wgmma serialization
            m = re.search(r"\((C\d+)\).*attn_int8_sm90_kernel(\w{16})", ln)
            regs.setdefault("advisories", []).append(
                " ".join(m.groups()) if m else ln.strip()[:200])
    res = dict(ptxas=regs)
    fns = sass_functions(lib)
    for name, tag in INT8_INSTANCES:
        sass = next(v for k, v in fns.items() if "attn_int8_sm90_kernel" + tag
                    in k)
        i = sass.rfind("DEPBAR.LE gsb0, 0x1")  # the main loop's wait for S
        j = sass.find("DEPBAR.LE gsb0, 0x0", i)
        res[name] = dict(kernel=_count(sass), between_waits=_count(sass[i:j]),
                         main_loop=_loop_count(sass))
    # K7's main loop beside them (attention_sm90.cu)
    kernels.build(["attention_sm90.cu"])
    fns = sass_functions(str(kernels._library_path("attention_sm90.cu")))
    k7 = next(v for k, v in fns.items()
              if "attn_sm90_kernelILi64ENS_7Softmax6OnlineE" in k)
    res["K7"] = dict(kernel=_count(k7), main_loop=_loop_count(k7))
    return res


def _int8_runs(gen):
    """(name, shape, the call) of K1, K4, K7 and both K8b at the slice
    shapes."""
    from sd3_torch.ops import fused_attention as fa
    runs = []
    for name, shape, kw in (
            ("K1", cs.SLICE, {}), ("K4", cs.SLICE, dict(int8_qk=True)),
            ("K7", cs.SLICE_1024, {}),
            ("K8b", cs.SLICE_1024, dict(int8_pv=True)),
            ("K8b over K7q", cs.SLICE_1024, dict(int8_qk=True,
                                                 int8_pv=True))):
        q, k, v, _, _, _, tabs = cs.attn_inputs(shape, gen)
        nh, d = shape["heads"], shape["d"]
        runs.append((name, lambda q=q, k=k, v=v, tabs=tabs, nh=nh, d=d, kw=kw:
                     fa.fused_attention(q, k, v, nh, *tabs, d ** -0.5, **kw)))
    return runs


def part_int8_launches(gen) -> dict:
    return {name: dict(call_ms=cs.cuda_ms(run),
                       us_per_launch=cs.per_launch_us(run))
            for name, run in _int8_runs(gen)}


# (name, [(text of the source, its replacement)]): one change each
INT8_VARIANTS = [
    # a CTA per item in place of persistent CTAs
    ("a CTA per item", [("  kernel<<<items < sms ? items : sms, INT8_THREADS",
                         "  kernel<<<items, INT8_THREADS")]),
    ("K4 pass 1 without turns",
     [("          take_turn();\n          issue_scores(kbase + t);\n"
       "          hand_over();\n",
       "          issue_scores(kbase + t);\n")]),
    # the turn handed over once the consumer's S has landed rather than once
    # its products are issued, so that the other consumer's products run
    # under this one's softmax (in the first pass, the first tile and the
    # main loop)
    ("hand over after S", [
        ("          issue_scores(kbase + t);\n          hand_over();\n"
         "          wgmma_wait<0>();\n",
         "          issue_scores(kbase + t);\n          wgmma_wait<0>();\n"
         "          hand_over();\n"),
        ("      issue_scores(k2);\n      hand_over();\n      wgmma_wait<0>();\n",
         "      issue_scores(k2);\n      wgmma_wait<0>();\n      hand_over();\n"),
        ("        hand_over();\n        wgmma_wait<1>();       // S of tile t done\n",
         "        wgmma_wait<1>();       // S of tile t done\n        hand_over();\n"),
    ]),
    # K4's first pass with its K tiles loaded and released but no product
    # or max (timing only: the max is wrong), and K4 without a first pass
    # at all, neither loads nor products: what a K kept in shared memory
    # from the first pass could save at most is the difference of the two
    ("K4 pass 1 loads only",
     [("          issue_scores(kbase + t);\n          hand_over();\n"
       "          wgmma_wait<0>();\n",
       "          mbar_wait(full_k + 8 * ((kbase + t) % STAGES),\n"
       "                    ((kbase + t) / STAGES) & 1);\n"
       "          hand_over();\n")]),
    ("K4 without pass 1", [
        ("const int k_per_item = TWO_PASS ? 2 * ntiles : ntiles;",
         "const int k_per_item = ntiles;"),
        ("        if constexpr (TWO_PASS)\n"
         "          for (int t = 0; t < ntiles; ++t) load_k(kbase + t, t);\n"
         "        const int k2 = kbase + (TWO_PASS ? ntiles : 0);\n",
         "        const int k2 = kbase;\n"),
        ("const int k2 = kbase + (TWO_PASS ? ntiles : 0);  // the scoring pass",
         "const int k2 = kbase;"),
        ("        for (int t = 0; t < ntiles; ++t) {\n          take_turn();\n",
         "        for (int t = 0; t < 0; ++t) {\n          take_turn();\n"),
    ]),
]


# The instrumented copy of the int8 kernel: per consumer of each CTA, the
# cycles of each phase of the main loop summed over its tiles, and the
# tiles (INT8_PHASES), from clock64() around the phases. Each edit must
# match once; the anchors are those of the kernel as committed.
INT8_PHASE_EDITS = [
    ("namespace {\n\nconstexpr int KEY_TILE",
     "__device__ unsigned long long g_phase[8192 * 2 * 8];\n"
     "namespace {\n\nconstexpr int KEY_TILE"),
    ('extern "C" int sd3_fused_attention_int8qk(',
     'extern "C" int sd3_phase_dump(void* dst, int n) {\n'
     "  return (int)cudaMemcpyFromSymbol(dst, g_phase, (size_t)n * 8);\n}\n"
     'extern "C" int sd3_fused_attention_int8qk('),
    ("    const int my_turn = TURN + c, other_turn = TURN + 1 - c;\n",
     "    long long tw[7] = {0, 0, 0, 0, 0, 0, 0}, tiles = 0;\n"
     "    const int my_turn = TURN + c, other_turn = TURN + 1 - c;\n"),
    ("        take_turn();\n        issue_scores(k2 + t);  // S of tile t ...\n"
     "        issue_pv(t - 1, pi);   // ... and P.V of tile t-1 on the tensor cores\n"
     "        hand_over();\n        wgmma_wait<1>();       // S of tile t done\n"
     "        reg_fence(s);\n",
     "        const long long c0 = clock64();\n        take_turn();\n"
     "        const long long c1 = clock64();\n        issue_scores(k2 + t);\n"
     "        issue_pv(t - 1, pi);\n        hand_over();\n"
     "        const long long c2 = clock64();\n        wgmma_wait<1>();\n"
     "        reg_fence(s);\n        const long long c3 = clock64();\n"),
    ("        softmax(a0, a1);  // while P.V of tile t-1 and the other's run\n"
     "        if constexpr (PV8) pack_p(pk);\n",
     "        softmax(a0, a1);\n        reg_fence(s);\n"
     "        if constexpr (PV8) { pack_p(pk); reg_fence(pk); }\n"
     "        const long long c4 = clock64();\n"),
    ("        reg_fence(pv);\n        release(empty_v, vbase + t - 1);\n"
     "        add_pv();\n        a0p = a0;\n        a1p = a1;\n"
     "        if constexpr (!PV8) pack_p(pk);\n      };\n",
     "        reg_fence(pv);\n        const long long c5 = clock64();\n"
     "        release(empty_v, vbase + t - 1);\n"
     "        add_pv();\n        a0p = a0;\n        a1p = a1;\n"
     "        if constexpr (!PV8) pack_p(pk);\n"
     "        reg_fence(pk);\n        reg_fence(acc);\n"
     "        const long long c6 = clock64();\n"
     "        tw[0] += c1 - c0; tw[1] += c2 - c1; tw[2] += c3 - c2;\n"
     "        tw[3] += c4 - c3; tw[4] += c5 - c4; tw[5] += c6 - c5;\n"
     "        ++tiles;\n      };\n"),
    ("              pack_bf16(acc[4 * j + 2] * inv1 * v0, acc[4 * j + 3] * inv1 * v1);\n"
     "      }\n    }\n",
     "              pack_bf16(acc[4 * j + 2] * inv1 * v0, acc[4 * j + 3] * inv1 * v1);\n"
     "      }\n    }\n"
     "    if (tid == 0 && blockIdx.x < 8192) {\n"
     "      unsigned long long* out = g_phase + (size_t)(blockIdx.x * 2 + c) * 8;\n"
     "      for (int i = 0; i < 6; ++i) out[i] = tw[i];\n"
     "      out[7] = tiles;\n    }\n"),
]
INT8_PHASES = ["wait turn", "issue S and P.V", "wait S",
               "dequant, mask, softmax (K8b: and pack)", "wait P.V",
               "add P.V (K8b), pack (K4)"]


def part_int8_phases(gen) -> dict:
    import torch
    from sd3_torch import kernels
    from sd3_torch.ops import fused_attention as fa
    src = (kernels.CSRC_DIR / INT8_SOURCE).read_text()
    for a, b in INT8_PHASE_EDITS:
        if src.count(a) != 1:
            raise RuntimeError(f"anchor not found once: {a[:60]!r}")
        src = src.replace(a, b)
    lib = ctypes.CDLL(nvcc_build(src, "attention_int8_sm90_phases"))
    res = {}
    kept = {k: k.function() for k in (fa.K4, fa.K8B)}
    try:
        for kern in kept:
            f = getattr(lib, kern.symbol)
            f.argtypes, f.restype = kern.argtypes, ctypes.c_int
            kern._fn = f
        for name, run in _int8_runs(gen):
            if name in ("K1", "K7"):
                continue
            ms = cs.cuda_ms(run)
            buf = np.zeros(8192 * 16, np.uint64)
            run()
            torch.cuda.synchronize()
            lib.sd3_phase_dump(ctypes.c_void_p(buf.ctypes.data),
                               ctypes.c_int(buf.size))
            tr = buf.reshape(8192, 2, 8).astype(np.float64)
            tr = tr[tr[:, 0, 7] > 0]  # the CTAs of this call
            res[name] = dict(copy_ms=ms, ctas=len(tr), cycles_per_tile=[
                {p: round(float(np.median(tr[:, c, i] / tr[:, c, 7])), 1)
                 for i, p in enumerate(INT8_PHASES)} for c in (0, 1)])
    finally:
        for kern, fn in kept.items():
            kern._fn = fn
    return res


def part_int8_variants(gen) -> dict:
    import torch
    from concurrent.futures import ThreadPoolExecutor
    from sd3_torch import kernels
    from sd3_torch.ops import fused_attention as fa
    src = (kernels.CSRC_DIR / INT8_SOURCE).read_text()
    copies = {}
    for name, edits in INT8_VARIANTS:
        text = src
        for a, b in edits:
            if text.count(a) != 1:
                raise RuntimeError(f"{name}: anchor not found once: {a[:60]!r}")
            text = text.replace(a, b)
        copies[name] = text
    with ThreadPoolExecutor(len(copies)) as ex:
        libs = dict(zip(copies, ex.map(
            lambda kv: nvcc_build(kv[1], "int8_" + re.sub(r"\W+", "_", kv[0])),
            copies.items())))
    runs = [(n, r) for n, r in _int8_runs(gen) if n != "K1" and n != "K7"]
    kept = {k: k.function() for k in (fa.K4, fa.K8B)}
    res = {}
    try:
        for variant in ["source", *libs, "source"]:
            if variant != "source":
                lib = ctypes.CDLL(libs[variant])
            for kern, fn in kept.items():
                if variant == "source":
                    kern._fn = fn
                else:
                    f = getattr(lib, kern.symbol)
                    f.argtypes, f.restype = kern.argtypes, ctypes.c_int
                    kern._fn = f
            torch.cuda.synchronize()
            res.setdefault(variant, []).append(
                {name: cs.cuda_ms(run) for name, run in runs})
    finally:
        for kern, fn in kept.items():
            kern._fn = fn
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", flush=True)
        return 1
    gen = torch.Generator(device="cuda").manual_seed(0)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    parts = [("int8_sass", part_int8_sass),
             ("int8_launches", lambda: part_int8_launches(gen)),
             ("int8_phases", lambda: part_int8_phases(gen)),
             ("int8_variants", lambda: part_int8_variants(gen))]
    if sys.argv[1:] != ["int8"]:
        parts = [("sass", part_sass),
                 ("launches", lambda: part_launches(gen)),
                 ("phases", lambda: part_phases(gen)),
                 ("overlap", part_overlap)] + parts
    for part, fn in parts:
        print(json.dumps({part: fn()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
