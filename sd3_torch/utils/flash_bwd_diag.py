"""Where the time of the wgmma flash-attention backward goes (K6a, K6b:
sd3_torch/csrc/flash_bwd_sm90.cu), on one NVIDIA Hopper GPU. From the root
of the repository (it takes its timing and its yardstick from chip_smoke.py
there):

    python3 -m sd3_torch.utils.flash_bwd_diag

1. "ptxas": registers, shared memory and spills of each kernel of the
   source, from the compiler's report of a fresh build beside the library;
2. "sass": in that build, for each kernel, the exp2s (MUFU.EX2) between the
   loop's wait for the score products (DEPBAR.LE gsb0, 0x1) and its wait
   for every wgmma group (0x0), where they overlap the gradient products,
   and in all;
3. "launches": at the 512px and 1024px training shapes, the device time of
   each launch of K5, K6a and K6b (torch.profiler), their times in a CUDA
   graph with their bounds, and SDPA's backward on the card alone by
   backend (chip_smoke.sdpa_backward_ms; a yardstick the port never calls)
   with the device time of each of its launches under the fastest backend.
One JSON line per part on stdout.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import chip_smoke as cs  # shapes, timing, bounds, the SDPA yardstick

SOURCE = "flash_bwd_sm90.cu"


def fresh_build() -> tuple[str, str]:
    """nvcc of the source into _build/diag: (library path, ptxas report)."""
    from sd3_torch import kernels
    out_dir = kernels.BUILD_DIR / "diag"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib = out_dir / "flash_bwd_sm90.so"
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
        i = fn.find("DEPBAR.LE gsb0, 0x1")
        j = fn.find("DEPBAR.LE gsb0, 0x0", i)
        res[head] = dict(
            ex2_between_waits=fn[i:j].count("MUFU.EX2") if i >= 0 else None,
            ex2_total=fn.count("MUFU.EX2"),
            local_stores=fn.count("STL"))
    return res


def part_launches() -> dict:
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    from torch.profiler import ProfilerActivity, profile
    from sd3_torch.ops import flash_attention as fl

    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    for shape in (cs.FLASH_SLICE, cs.FLASH_SLICE_1024):
        b, h, n, d = shape
        scale = d ** -0.5
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        out, lse = fl.flash_fwd(q, k, v, scale)
        dq, delta = fl.flash_dq(q, k, v, out, do, lse, scale)
        runs = dict(K5=lambda: fl.flash_fwd(q, k, v, scale),
                    K6a=lambda: fl.flash_dq(q, k, v, out, do, lse, scale),
                    K6b=lambda: fl.flash_dkv(q, k, v, do, lse, delta, scale))
        products = dict(K5=2, K6a=3, K6b=4)
        t_exp = 1.0 * b * h * n * n / cs.PEAK_EXP2
        graphed = {
            name: dict(ms=cs.cuda_ms(run), **cs.bound(
                products[name] * 2 * b * h * n * n * d / cs.PEAK_BF16_FLOPS,
                0.0, t_exp))
            for name, run in runs.items()}
        sdpa = cs.sdpa_backward_ms(q, k, v, do, scale)
        qr, kr, vr = (t.clone().requires_grad_() for t in (q, k, v))

        def sdpa_fwd_bwd():
            o = torch.nn.functional.scaled_dot_product_attention(
                qr, kr, vr, scale=scale)
            torch.autograd.grad(o, (qr, kr, vr), do)
        with sdpa_kernel(getattr(SDPBackend, sdpa["backend"])):
            for _ in range(3):
                sdpa_fwd_bwd()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(10):
                    for run in runs.values():
                        run()
                    sdpa_fwd_bwd()
                torch.cuda.synchronize()
        name_of = lambda key: key.replace("void ", "").replace(
            "(anonymous namespace)::", "").split("(")[0][:80]
        per = {name_of(e.key): round(e.self_device_time_total / e.count, 2)
               for e in prof.key_averages() if e.self_device_time_total > 0}
        res[f"B={b} H={h} N={n} D={d}"] = dict(
            graphed=graphed, sdpa_backward=sdpa, us_per_launch=per)
    return res


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", flush=True)
        return 1
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    lib, report = fresh_build()
    for part, fn in (("ptxas", lambda: part_ptxas(report)),
                     ("sass", lambda: part_sass(lib)),
                     ("launches", part_launches)):
        print(json.dumps({part: fn()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
