"""Where the time of the wgmma flash-attention backward goes (K6a, K6b:
sd3_torch/csrc/flash_bwd_sm90.cu), on one NVIDIA Hopper GPU. From the root
of the repository (it takes its timing and its yardstick from chip_smoke.py
there):

    python3 -m sd3_torch.utils.flash_bwd_diag [ptxas] [sass] [launches]
        [d256] [d384] [d512] [d640] [d1024] [past512_calls]
        [sassdiff=OTHER.cu]

(the first four parts by default):
1. "ptxas": registers, shared memory and spills of each kernel of the
   source (every instance, D = 16 to 1024), from the compiler's report of a
   fresh build beside the library;
2. "sass": in that build, for each kernel, the exp2s (MUFU.EX2) between the
   loop's wait for the score products (DEPBAR.LE gsb0, 0x1) and its wait
   for every wgmma group (0x0), where they overlap the gradient products
   (null where the loop waits for all its groups at once: D = 256), and in
   all;
3. "launches": at the 512px and 1024px training shapes, the device time of
   each launch of K5, K6a and K6b (torch.profiler), their times in a CUDA
   graph with their bounds, and SDPA's backward on the card alone by
   backend (chip_smoke.sdpa_backward_ms; a yardstick the port never calls)
   with the device time of each of its launches under the fastest backend;
4. "d256": the head-dim-256 instances K6A_256 and K6B_256 beside the
   mma.sync K6AW and K6BW (csrc/attention_fp32.cu) that took bf16 head dims
   of 129-256 before them, on the same inputs at chip_smoke.FLASH_WIDE[0]
   (B 4, H 5, N 1178, D 256): the call time of each route in turns (wgmma,
   mma.sync, mma.sync, wgmma; CUDA events around a graph of 10 calls,
   chip_smoke.cuda_ms), the largest difference of the two routes' outputs,
   the device time of each launch, and K6A_256 at B 2 (100 blocks, one
   wave on 132 SMs) beside B 4 (200 blocks, two waves): the cost of the
   second wave;
5. "d384", "d512": the same for K6A_384 / K6B_384 at FLASH_WIDE[2] (B 4,
   H 3, N 1178, D 384) and K6A_512 / K6B_512 at FLASH_WIDE[3] (B 4, H 2,
   N 1178, D 512) beside K6AW / K6BW, and K6a at half the batch (one wave
   of 64-row blocks) beside the whole; "d640", "d1024": K6A_768 / K6B_768
   at FLASH_PAST_512 (B 2, H 2, N 1178, D 640, its inputs padded to 768
   once, outside the timing) and K6A_1024 / K6B_1024 at FLASH_1024 (D
   1024) beside K6AW / K6BW at the head dim itself, and K6a at B 1 beside
   B 2;
6. "sassdiff=OTHER.cu": OTHER.cu (another tree's copy of the source, with
   its own headers beside it) built beside this one, and for every kernel
   of both, whether its SASS (cuobjdump -sass) is the same;
7. "past512_calls": the call times of K6A_768 / K6B_768 at FLASH_PAST_512
   and phase 4d's shape (B 2, H 2, N 410, D 640) and K6A_1024 / K6B_1024
   at FLASH_1024 (inputs padded once, outside the timing), each output's
   rel L2 against its plain version, through the sd3_torch first on the
   path: so it also times a copy of the tree with one change, from a
   directory outside both trees, with that copy's root first on the path
   and this repository's root next (for chip_smoke.py),
       PYTHONPATH=<its root>:<this root> python3 -c "import runpy, sys;
           sys.argv[1:] = ['past512_calls']; runpy.run_path('<this file>',
           run_name='__main__')"
   in turns with this tree's;
One JSON line per part on stdout.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile

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


def kernel_name(mangled: str) -> str:
    """`flash_dq_sm90_kernel<256>` of a mangled kernel name."""
    m = re.search(r"(flash_[a-z]+_sm90_kernel)ILi(\d+)E", mangled)
    return f"{m.group(1)}<{m.group(2)}>" if m else mangled


def part_ptxas(report: str) -> dict:
    res, fn = {}, None
    for ln in report.splitlines():
        if "Compiling entry function" in ln:
            fn = kernel_name(ln.split("'")[1])
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
        head = kernel_name(fn.split("\n")[0].strip())
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


# the FLASH_WIDE shape of each wgmma instance past 128, and past 512 the
# shapes of FLASH_PAST_512 (two heads of 640, run at 768) and FLASH_1024
WIDE_SHAPES = {256: cs.FLASH_WIDE[0], 384: cs.FLASH_WIDE[2],
               512: cs.FLASH_WIDE[3], 640: cs.FLASH_PAST_512,
               1024: cs.FLASH_1024}


def _wide_case(d):
    """WIDE_SHAPES' inputs at head dim d, with out, lse and delta, and the
    runs of a K6a and a K6b kernel on them: (dims, dq(kern, bb),
    dkv(kern)). The wgmma instances read the inputs zero-padded to their
    head dim (forward_dim; padded once, here), the mma.sync ones the
    inputs themselves."""
    import torch
    from sd3_torch.ops import flash_attention as fl

    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = WIDE_SHAPES[d]
    b, h, n, m, d = cs.flash_dims(shape)
    scale = d ** -0.5
    q, k, v, do = cs.flash_inputs(shape, gen, torch.bfloat16)
    out, lse = fl.flash_fwd(q, k, v, scale)
    _, delta = fl.flash_dq(q, k, v, out, do, lse, scale)
    dp = fl.forward_dim(d, torch.bfloat16)
    padded = dict(zip("qkvod", (fl._pad(t, dp).contiguous()
                                for t in (q, k, v, out, do))))
    plain = dict(zip("qkvod", (q, k, v, out, do)))
    wide = (fl.K6AW, fl.K6BW)
    ins = lambda kern: ((plain, d) if kern in wide else (padded, dp))

    def dq(kern, bb=b):
        t, dd = ins(kern)
        sl = lambda x: x[:bb]
        res = fl._bnhd((bb, h, n, dd), q), torch.empty_like(lse[:bb])
        fl._launch(kern, (*(sl(t[c]) for c in "qkvod"),
                          sl(lse).contiguous(), res[1], res[0]),
                   (*(sl(t[c]) for c in "qkvod"), res[0]), bb, h, n, m, dd,
                   scale)
        return tuple(x[..., :d] for x in res[:1]) + res[1:]

    def dkv(kern):
        t, dd = ins(kern)
        res = fl._bnhd(t["k"].shape, k), fl._bnhd(t["k"].shape, k)
        fl._launch(kern, (t["q"], t["k"], t["v"], t["d"], lse, delta, *res),
                   (t["q"], t["k"], t["v"], t["d"], *res), b, h, n, m, dd,
                   scale)
        return tuple(x[..., :d] for x in res)
    return (b, h, n, m, d), dq, dkv


def part_wide(d) -> dict:
    import torch
    from sd3_torch.ops import flash_attention as fl

    (b, h, n, m, d), dq, dkv = _wide_case(d)
    shape = WIDE_SHAPES[d]
    dp = fl.forward_dim(d, torch.bfloat16)
    res = {}
    for name, run, routes in (("K6a", dq, (fl._WGMMA["dq"][dp], fl.K6AW)),
                              ("K6b", dkv, (fl._WGMMA["dkv"][dp], fl.K6BW))):
        outs = [run(kern) for kern in routes]
        times = {kern.name: [] for kern in routes}
        for kern in (*routes, *routes[::-1]):
            times[kern.name].append(cs.cuda_ms(lambda kern=kern: run(kern)))
        res[name] = dict(
            shape=cs.flash_label(shape), ms=times,
            max_abs_diff=max((x.float() - y.float()).abs().max().item()
                             for x, y in zip(*outs)),
            us_per_launch={kern.name: cs.per_launch_us(
                lambda kern=kern: run(kern)) for kern in routes})
    rows = 128 if d == 256 else 64  # K6a's rows per block
    pairs = 2 if dp > 512 else 1    # and its blocks per row block
    res["K6a waves"] = {f"B={bb} ({-(-n // rows) * h * bb * pairs} blocks)":
                        cs.cuda_ms(lambda bb=bb: dq(fl._WGMMA["dq"][dp], bb))
                        for bb in (b // 2, b)}
    return res


def part_past512_calls() -> dict:
    import torch
    from sd3_torch.ops import flash_attention as fl

    res = {}
    for shape in (cs.FLASH_PAST_512, cs.FLASH_1024,
                  cs.step_flash_shape(cs.train_step_config().replace(
                      **cs.D640_MODEL), cs.TRAIN32_LAT)):
        b, h, n, d = shape
        gen = torch.Generator(device="cuda").manual_seed(0)
        q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                       .to(torch.bfloat16) for _ in range(4))
        scale = d ** -0.5
        qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
        out32, lse = fl.flash_fwd_plain(qf, kf, vf, scale)
        out = out32.to(torch.bfloat16)
        dp = fl.forward_dim(d, torch.bfloat16)
        pq, pk, pv, po, pd = (fl._pad(t, dp).contiguous()
                              for t in (q, k, v, out, do))
        delta = torch.empty_like(lse)
        dq = fl._bnhd((b, h, n, dp), q)
        dk, dv = fl._bnhd((b, h, n, dp), q), fl._bnhd((b, h, n, dp), q)
        k6a, k6b = fl._WGMMA["dq"][dp], fl._WGMMA["dkv"][dp]
        run_a = lambda: fl._launch(k6a, (pq, pk, pv, po, pd, lse, delta, dq),
                                   (pq, pk, pv, po, pd, dq), b, h, n, n, dp,
                                   scale)
        run_b = lambda: fl._launch(k6b, (pq, pk, pv, pd, lse, delta, dk, dv),
                                   (pq, pk, pv, pd, dk, dv), b, h, n, n, dp,
                                   scale)
        run_a()
        run_b()
        w_dq, w_delta = fl.flash_dq_plain(qf, kf, vf, out.float(), dof, lse,
                                          scale)
        w_dk, w_dv = fl.flash_dkv_plain(qf, kf, vf, dof, lse, w_delta, scale)
        err = lambda g, w: ((g[..., :d].float() - w).norm() / w.norm()).item()
        res[cs.flash_label(shape)] = {
            k6a.name: cs.cuda_ms(run_a), k6b.name: cs.cuda_ms(run_b),
            "rel_l2": dict(dq=err(dq, w_dq), dk=err(dk, w_dk),
                           dv=err(dv, w_dv))}
    return res


def part_sassdiff(lib: str, other: str) -> dict:
    from sd3_torch import kernels
    from sd3_torch.utils.flag_diag import _sass
    cuobjdump = os.path.join(os.path.dirname(kernels.find_nvcc()),
                             "cuobjdump")
    sass = lambda path: {kernel_name(fn): code
                         for fn, code in _sass(cuobjdump, path).items()}
    with tempfile.TemporaryDirectory() as tmp:
        olib = os.path.join(tmp, "other.so")
        r = subprocess.run([kernels.find_nvcc(), *kernels.NVCC_FLAGS, "-o",
                            olib, other], capture_output=True, text=True)
        if r.returncode:
            raise RuntimeError(f"nvcc {other}:\n{r.stdout}{r.stderr}")
        mine, theirs = sass(lib), sass(olib)
    return {fn: ("same" if mine.get(fn) == theirs.get(fn) else
                 "only here" if fn not in theirs else
                 "only there" if fn not in mine else "different")
            for fn in sorted(set(mine) | set(theirs))}


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", flush=True)
        return 1
    parts = (sys.argv[1:] if argv is None else argv) or [
        "ptxas", "sass", "launches", "d256"]
    args = dict(p.split("=", 1) if "=" in p else (p, None) for p in parts)
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    lib, report = fresh_build() if {"ptxas", "sass", "sassdiff"} & set(
        args) else (None, None)
    for part, fn in (("ptxas", lambda: part_ptxas(report)),
                     ("sass", lambda: part_sass(lib)),
                     ("sassdiff", lambda: part_sassdiff(lib,
                                                        args["sassdiff"])),
                     ("launches", part_launches),
                     ("d256", lambda: part_wide(256)),
                     ("d384", lambda: part_wide(384)),
                     ("d512", lambda: part_wide(512)),
                     ("d640", lambda: part_wide(640)),
                     ("d1024", lambda: part_wide(1024)),
                     ("past512_calls", part_past512_calls)):
        if part in args:
            print(json.dumps({part: fn()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
