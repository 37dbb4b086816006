#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (sd3_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ok line):
  1. header: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 off for fp32 matmuls and convolutions;
  2. build every kernel from sd3_torch/csrc (one nvcc per source, in
     parallel) and print the compiler's register / shared-memory report;
  3. each kernel against its plain PyTorch version in fp32 on the same
     inputs: K1 (fused joint attention) at the 512px slice shape, a ragged
     shape with odd H and a NoPE shape; K4 (its int8-QK^T variant) at the
     slice and a ragged shape; K3 (int8 SwiGLU) at the text stream and a
     ragged shape; K2 (int8 SwiGLU block tail) at the image stream and a
     shape whose tiles straddle samples. Kernel (CUDA graph), eager,
     plain-version and, for attention, library (scaled_dot_product_attention
     on pre-prepped q/k/v, a yardstick only) times, and the bound;
  4. the published widths at a depth of 2 blocks, 512px, batch 2, on the
     card against the same weights in fp32 on the CPU (the plain path):
     the bf16 model (through K1), then the int8 (w8a8) model (through K2,
     K3 and K4);
  5. the published 19-block model with seeded random bf16 weights through
     sampler.sample_imgs: 512px, batch 4, 20 Euler steps, guidance 5, stub
     encoders and decode; one warmup, then the median of 3 timed runs; each
     sample call must launch K1 exactly 19 * 20 times; then one more call
     under torch.profiler for the card time by kernel family;
  6. the same with the model quantized to int8 (quantize_model): each sample
     call must launch K2 19 * 20, K3 18 * 20 (the last block has no text
     MLP), K4 19 * 20 and K1 0 times;
  7. one JSON line {"kernels": [...]} per ported kernel, then the last line
     {"ok": true, "device": {...}}.
Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
sd3_torch package beside this file.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

# Tolerances, each with its reason.
# K1 against the fp32 plain version: the kernel rounds q^, k^ and the
# softmax numerators to bf16 (8-bit mantissa) before each product and writes
# bf16, so expect ~1e-3 absolute on outputs of magnitude <= 1; 1e-2 is 10x.
ATTN_ATOL = 1e-2
# K4 against the fp32 plain version: as K1, and k^'s bf16 rounding before
# its quantization moves int8 levels, each a score change of ~1e-2 on one
# key. With few keys that shows: the plain version run on bf16 is itself
# ~1e-2 off its fp32 run at the ragged shape (47 keys). Limit 3e-2. Against
# the plain version on the same bf16 inputs (the kernel's roundings) only
# fp32 sum order and exp2's approximation differ: within one bf16 ulp of
# an output of magnitude <= 2, 1e-2.
K4_ATOL = 3e-2
K4_SAME_ROUNDING_ATOL = 1e-2
# K2 / K3 against the fp32 plain version: the kernel writes bf16 (half an
# ulp is 2^-9 of an element, RMS ~1.6e-3 of the output), and sums the
# LayerNorm statistics and the dequantization in another order, so the odd
# x or h element lands on the other side of an int8 rounding boundary (one
# level moves an output by ~1e-3 of its scale). Limits: max abs error
# 1e-2 x max |plain|, rel L2 5e-3. Against the plain version run on the
# same bf16 inputs with a bf16 output (the kernel's roundings), only those
# rare level moves remain: rel L2 1e-3, which a wrong h_group (every h
# scale) or a dropped AdaLN / gate term exceeds.
MLP_MAX_REL = 1e-2
MLP_REL_L2 = 5e-3
MLP_SAME_ROUNDING_REL_L2 = 1e-3
# bf16 model on the card against fp32 on the CPU through 2 blocks of the
# published widths: ~20 bf16 roundings on the residual path at ~0.4% each.
MODEL_REL_L2 = 3e-2
# The int8 model, on the same int8 weights: the bf16 residual path as
# above, and bf16 rounding of every quantizer's input (0.4%, up to half an
# int8 level) moves a large share of int8 levels by one (1/127 of a row's
# scale each) in ~14 quantizers per block.
INT8_MODEL_REL_L2 = 5e-2
# H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor-core rates
# and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12

SLICE = dict(b=8, h=32, w=32, n_txt=154, heads=19, d=64, rope=True)
RAGGED = dict(b=2, h=5, w=7, n_txt=12, heads=3, d=32, rope=True)
NOPE = dict(b=2, h=10, w=15, n_txt=50, heads=4, d=64, rope=False)
# int8 SwiGLU: rows, tokens per sample, width, hidden, h_group (the JAX
# pickers' chunk at these shapes: ops/fused_mlp.py)
K3_SLICE = dict(m=8 * 154, n_tok=8 * 154, k=1216, hidden=4864, h_group=256)
K3_RAGGED = dict(m=300, n_tok=300, k=96, hidden=512, h_group=512)
K2_SLICE = dict(m=8 * 1024, n_tok=1024, k=1216, hidden=4864, h_group=256)
K2_RAGGED = dict(m=300, n_tok=100, k=64, hidden=384, h_group=128)


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def nvidia_smi(fields: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, groups=5, graph=True):
    """Milliseconds per fn() call: CUDA events around `iters` back-to-back
    calls, median of `groups` such runs. With `graph` the calls are
    captured in one CUDA graph and replayed, so the time is the card's
    alone; without it, the host's launch work is in it wherever the host
    cannot keep ahead of the card (what the eager sampling loop sees)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture's stream
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    if graph:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(iters):
                fn()
        run = g.replay
    else:
        def run():
            for _ in range(iters):
                fn()
    run()
    torch.cuda.synchronize()
    times = []
    for _ in range(groups):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        run()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / iters)
    return statistics.median(times)


def phase_attention(shape, gen, int8_qk=False):
    """K1 (or with int8_qk K4) vs its plain version at one shape; returns
    the measurements."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import fused_attention as fa
    from sd3_torch.ops.rope import _rotate_half_interleaved, rope2d_axial_angles

    b, nh, d = shape["b"], shape["heads"], shape["d"]
    n_img = shape["h"] * shape["w"]
    n = n_img + shape["n_txt"]
    f = nh * d
    dev = "cuda"
    q, k, v = (torch.randn((b, n, f), generator=gen, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    ws = [1 + 0.1 * torch.randn(d, generator=gen, device=dev) for _ in range(4)]
    angles = (rope2d_axial_angles(shape["h"], shape["w"], d).reshape(n_img, d)
              if shape["rope"] else None)
    cos, sin = (torch.as_tensor(t, device=dev)
                for t in fa.rope_row_tables(angles, n, d))
    cosq, sinq = fa.fold_row_tables(cos, sin, ws[0], ws[1], n_img)
    cosk, sink = fa.fold_row_tables(cos, sin, ws[2], ws[3], n_img)
    scale = d ** -0.5
    eps = float(torch.finfo(torch.bfloat16).eps)

    name = "K4" if int8_qk else "K1"
    plain = fa.composition_int8_qk if int8_qk else fa.composition
    run_k = lambda: fa.fused_attention(q, k, v, nh, cosq, sinq, cosk, sink,
                                       scale, int8_qk=int8_qk)
    run_plain = lambda: plain(q, k, v, cosq, sinq, cosk, sink, scale, eps,
                              eps, nh)
    got = run_k()
    torch.cuda.synchronize()
    want = plain(q.float(), k.float(), v.float(), cosq, sinq, cosk, sink,
                 scale, eps, eps, nh)
    plain_bf16 = run_plain()
    err = (got.float() - want).abs().max().item()
    rel = err / want.abs().max().item()
    plain_err = (plain_bf16.float() - want).abs().max().item()
    require(bool(torch.isfinite(got).all()), f"{name} non-finite at {shape}")

    # library yardstick: SDPA on q/k/v prepped by the plain version
    def heads(x):
        return x.reshape(b, n, nh, d).transpose(1, 2).contiguous()

    def prep(x, c, s):
        xf = x.float()
        xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        return (xn * c + _rotate_half_interleaved(xn) * s).to(x.dtype)

    qh, kh, vh = prep(heads(q), cosq, sinq), prep(heads(k), cosk, sink), heads(v)
    run_lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

    ms = cuda_ms(run_k)
    eager_ms = cuda_ms(run_k, graph=False)
    plain_ms = cuda_ms(run_plain, iters=3, groups=3)
    library_ms = cuda_ms(run_lib)
    # QK^T and P.V, 2*B*H*N^2*D each: both bf16 in K1; QK^T int8 in K4
    prod = 2.0 * b * nh * n * n * d
    t_ops = prod / (PEAK_INT8_OPS if int8_qk else PEAK_BF16_FLOPS) \
        + prod / PEAK_BF16_FLOPS
    nbytes = 4.0 * b * n * f * 2 + 4.0 * n * d * 4  # q, k, v, out + 4 tables
    t_bytes = nbytes / PEAK_BYTES
    res = dict(shape=f"B={b} N={n} n_img={n_img} H={nh} D={d} "
               f"{'RoPE2d' if shape['rope'] else 'NoPE'}",
               max_abs_err=err, max_rel_err=rel, plain_bf16_max_abs_err=plain_err,
               kernel_vs_plain_bf16_max_abs_err=(
                   got.float() - plain_bf16.float()).abs().max().item(),
               ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"  {name}", json.dumps(res), flush=True)
    atol = K4_ATOL if int8_qk else ATTN_ATOL
    require(err <= atol, f"{name} max abs err {err} > {atol} at {res['shape']}")
    same = res["kernel_vs_plain_bf16_max_abs_err"]
    require(not int8_qk or same <= K4_SAME_ROUNDING_ATOL,
            f"K4 max abs err {same} against the plain version's own roundings "
            f"> {K4_SAME_ROUNDING_ATOL} at {res['shape']}")
    return res


def phase_mlp(shape, gen, tail):
    """K2 (tail) or K3 vs the plain version at one shape."""
    import torch
    from sd3_torch.ops import fused_mlp as fm
    from sd3_torch.ops.quant import quantize_weight

    name = "K2" if tail else "K3"
    m, n_tok, k, hidden = shape["m"], shape["n_tok"], shape["k"], shape["hidden"]
    h_group, b = shape["h_group"], m // n_tok
    dev = "cuda"
    rnd = lambda *sz, sd=1.0: torch.randn(sz, generator=gen, device=dev) * sd
    x = rnd(m, k).to(torch.bfloat16)
    w12_q, s12 = quantize_weight(rnd(2 * hidden, k, sd=k ** -0.5))
    w3_q, s3 = quantize_weight(rnd(k, hidden, sd=hidden ** -0.5))
    # biases and conditioning in bf16, as the model's cast leaves them
    b12, b3 = (rnd(n, sd=0.1).to(torch.bfloat16) for n in (2 * hidden, k))
    shift, scale = (rnd(b, k, sd=0.3).to(torch.bfloat16) for _ in range(2))
    gate = rnd(b, k, sd=0.5).to(torch.bfloat16)
    w = (w12_q, s12, b12, w3_q, s3, b3)
    cond = dict(shift=shift, scale=scale, gate=gate, n_tok=n_tok, adaln=tail,
                residual=tail)
    if tail:
        run_k = lambda: fm.swiglu_int8_tail(x, shift, scale, gate, *w,
                                            n_tok=n_tok, h_group=h_group)
    else:
        run_k = lambda: fm.swiglu_int8(x, *w, h_group=h_group)
    run_plain = lambda: fm.swiglu_int8_plain(x, *w, h_group=h_group, **cond)
    got = run_k()
    torch.cuda.synchronize()
    require(bool(torch.isfinite(got).all()), f"{name} non-finite at {shape}")
    want = fm.swiglu_int8_plain(x.float(), *w, h_group=h_group, **cond)
    same = run_plain()
    d = got.float() - want
    err = d.abs().max().item()
    rel = err / want.abs().max().item()
    rel_l2 = (d.norm() / want.norm()).item()
    same_l2 = ((got.float() - same.float()).norm() / same.float().norm()).item()
    ms = cuda_ms(run_k)
    eager_ms = cuda_ms(run_k, graph=False)
    plain_ms = cuda_ms(run_plain, iters=3, groups=3)
    ops = 2.0 * m * k * 2 * hidden + 2.0 * m * hidden * k
    ins = (x, *w) + ((shift, scale, gate) if tail else ())
    nbytes = sum(t.numel() * t.element_size() for t in ins) + m * k * 2
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    res = dict(shape=f"M={m} n_tok={n_tok} K={k} hidden={hidden} "
               f"h_group={h_group}", max_abs_err=err, max_rel_err=rel,
               rel_l2=rel_l2, kernel_vs_plain_bf16_rel_l2=same_l2, ms=ms,
               eager_ms=eager_ms, plain_ms=plain_ms, library_ms=None,
               bound_ms=max(t_ops, t_bytes) * 1e3,
               bound_by="operations" if t_ops >= t_bytes else "bytes")
    print(f"  {name}", json.dumps(res), flush=True)
    require(rel <= MLP_MAX_REL and rel_l2 <= MLP_REL_L2,
            f"{name} max err {rel} x max|plain| (limit {MLP_MAX_REL}), rel L2 "
            f"{rel_l2} (limit {MLP_REL_L2}) at {res['shape']}")
    require(same_l2 <= MLP_SAME_ROUNDING_REL_L2,
            f"{name} rel L2 {same_l2} against the plain version's own "
            f"roundings (limit {MLP_SAME_ROUNDING_REL_L2}) at {res['shape']}")
    return res


def launch_counts():
    """{kernel name: launches so far} of every registered kernel."""
    from sd3_torch import kernels
    return {k.name: k.launches for k in kernels.REGISTRY}


def reset_launches():
    from sd3_torch import kernels
    for k in kernels.REGISTRY:
        k.launches = 0


def phase_model(gen_seed, int8=False):
    """2-block published-width model, bf16 or int8 (w8a8) on the card vs
    the same weights in fp32 on the CPU."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.quant import quantize_model

    cfg = published_config(stage_res=512).replace(num_blocks=2)
    ref = MMDiT(cfg.replace(dtype="float32"), device="cpu").init_weights(
        torch.Generator().manual_seed(gen_seed)).eval()
    if int8:
        quantize_model(ref)
        cfg = ref.cfg.replace(dtype=cfg.dtype)
    dut = MMDiT(cfg, device="cuda")
    dut.load_state_dict(ref.state_dict(), strict=True)
    dut.cast_params(torch.bfloat16).eval()
    g = torch.Generator().manual_seed(gen_seed + 1)
    b = 2
    x = torch.randn((b, cfg.inCh, 64, 64), generator=g)
    t = torch.rand((b,), generator=g)
    c = torch.randn((b, cfg.text_tokens, cfg.text_hidden_dim), generator=g)
    cp = torch.randn((b, cfg.class_dim), generator=g)
    nulls = (torch.tensor([False, True]), torch.tensor([True, False]),
             torch.tensor([False, True]))
    with torch.inference_mode():
        t0 = time.time()
        want = ref(x, t, c, cp, *nulls)
        cpu_s = time.time() - t0
        reset_launches()
        got = dut(*(a.cuda() for a in (x, t, c, cp)),
                  *(m.cuda() for m in nulls)).cpu()
    launches = launch_counts()
    require(bool(torch.isfinite(got).all()), "2-block model output non-finite")
    rel = ((got - want).norm() / want.norm()).item()
    res = dict(quant=cfg.quant, rel_l2=rel,
               max_abs_err=(got - want).abs().max().item(),
               ref_max_abs=want.abs().max().item(), launches=launches,
               cpu_fp32_s=cpu_s)
    print("  model", json.dumps(res), flush=True)
    nb = cfg.num_blocks
    # int8: attention K4 (1178 tokens pad to 1280), the image-stream MLP K2,
    # the text-stream MLP K3 in every block but the last
    want_launches = (dict(swiglu_int8_tail=nb, swiglu_int8=nb - 1,
                          fused_attention_int8qk=nb, fused_attention_bf16=0)
                     if int8 else dict(fused_attention_bf16=nb))
    for name, n in want_launches.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times "
                f"in a {nb}-block {cfg.quant} forward, expected {n}")
    limit = INT8_MODEL_REL_L2 if int8 else MODEL_REL_L2
    require(rel <= limit, f"2-block {cfg.quant} model rel L2 {rel} > {limit}")
    return res


def phase_sample(card, int8=False):
    """Full-width sampling through the port's entry points: the bf16 model,
    or (int8) the same seeded weights quantized by quantize_model."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.inference.sampler import sample_imgs
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.models.text_encoders import StubTextEncoders
    from sd3_torch.ops.quant import quantize_model

    cfg = published_config(stage_res=512)
    batch, steps, res = 4, 20, 512
    t0 = time.time()
    model = MMDiT(cfg, device="cuda", dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0)).eval()
    if int8:
        quantize_model(model).cast_params(torch.bfloat16)
    n_params = sum(t.numel() for t in model.state_dict().values())
    enc = StubTextEncoders(device="cuda")
    torch.cuda.synchronize()
    print(f"  {model.cfg.quant} model: {n_params / 1e6:.1f}M weights, built "
          f"in {time.time() - t0:.1f} s", flush=True)
    nb = cfg.num_blocks
    # per sample call: one launch per block and step, the text-stream MLP
    # in every block but the last
    expect = (dict(swiglu_int8_tail=nb * steps, swiglu_int8=(nb - 1) * steps,
                   fused_attention_int8qk=nb * steps, fused_attention_bf16=0)
              if int8 else dict(fused_attention_bf16=nb * steps))

    def run(decode):
        gen = torch.Generator().manual_seed(1)
        reset_launches()
        out = sample_imgs(model, enc, batch, steps, "a red fox in the snow",
                          cfg_scale=5.0, width=res, height=res,
                          sampler="euler", generator=gen, decode=decode)
        torch.cuda.synchronize()
        launches = launch_counts()
        for name, n in expect.items():
            require(launches[name] == n, f"{name} launched {launches[name]} "
                    f"times in one {model.cfg.quant} sample call, expected {n}")
        return out, launches

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    lat, _ = run(decode=False)
    warm_s = time.time() - t0
    require(bool(torch.isfinite(lat).all()), "sampled latents non-finite")
    require(tuple(lat.shape) == (batch, cfg.inCh, res // 8, res // 8),
            f"latents shape {tuple(lat.shape)}")
    imgs = enc.vae_decode(lat)
    require(tuple(imgs.shape) == (batch, 3, res, res),
            f"decode shape {tuple(imgs.shape)}")
    times, launches = [], {}
    for _ in range(3):
        t0 = time.time()
        imgs, launches = run(decode=True)
        times.append(time.time() - t0)
        require(bool(torch.isfinite(imgs).all()), "decoded images non-finite")
    med = statistics.median(times)
    res_d = dict(quant=model.cfg.quant, batch=batch, steps=steps, res=res,
                 warmup_s=warm_s, run_s=times, median_s_per_batch=med,
                 images_per_s=batch / med, launches_per_call=launches,
                 peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9,
                 card=card,
                 clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                         "temperature.gpu"))
    print("  sample", json.dumps(res_d), flush=True)

    # One more call under torch.profiler (not timed above): card time by
    # kernel family. The profiler slows the host, so its idle share is an
    # upper bound on the untraced run's.
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        run(decode=True)
        traced_s = time.time() - t0
    tr = device_breakdown(prof, traced_s)
    # kernels are not slowed by the trace: their sum against the untraced
    # median gives the untraced run's idle share
    tr["idle_share_untraced"] = 1 - tr["device_busy_ms"] / (med * 1e3)
    print("  trace", json.dumps(tr), flush=True)
    res_d["trace"] = tr
    return res_d


MLP_KERNELS = ("xquant_kernel", "swiglu_h_kernel", "w3_gemm_kernel")


def kernel_family(name: str) -> str:
    """The family of one device row: the port's kernels by their CUDA
    function names (K2 / K3 are the TAIL=true / false instantiations of one
    source; K4 is k_prep_kernel<D, true> with its quantize and attention
    kernels), int8 and other GEMMs, and the rest."""
    low = name.lower()
    if "attn_int8_kernel" in name or "k_quant_kernel" in name or (
            "k_prep_kernel" in name and "true>" in name):
        return "K4"
    if "attn_kernel" in name or "k_prep_kernel" in name:
        return "K1"
    if any(k in name for k in MLP_KERNELS):
        return "K2" if "true>" in name else "K3"
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        if any(s in low for s in ("s8", "i8", "int8", "imma")):
            return "gemm_int8"
        return "gemm"
    return "other"


def device_breakdown(prof, wall_s):
    """Self device time (ms) by kernel family (see kernel_family); the top
    kernels; and the idle share of the traced wall time."""
    fams = dict.fromkeys(("K1", "K2", "K3", "K4", "gemm_int8", "gemm",
                          "other"), 0.0)
    rows = []
    for e in prof.key_averages():
        # device-side rows (kernels, copies, fills) only: they take no host
        # time. An operator's row repeats its kernels' device time.
        us = e.self_device_time_total
        if e.self_cpu_time_total > 0 or us <= 0:
            continue
        fams[kernel_family(e.key)] += us
        rows.append((us, e.count, e.key[:100]))
    busy_ms = sum(fams.values()) / 1e3
    rows.sort(reverse=True)
    require(busy_ms > 0, "the profiler saw no device time")
    return dict(traced_wall_ms=wall_s * 1e3, device_busy_ms=busy_ms,
                device_ops=sum(n for _, n, _ in rows),
                idle_share=1 - busy_ms / (wall_s * 1e3),
                by_family_ms={k: v / 1e3 for k, v in fams.items()},
                top=[dict(ms=us / 1e3, calls=n, name=nm)
                     for us, n, nm in rows[:14]])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this script runs "
              "only on a CUDA card", flush=True)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sd3_torch")):
        print(f"FAIL: no sd3_torch package beside {__file__}", flush=True)
        return 1
    sys.path.insert(0, here)
    try:
        print("phase 1: header", flush=True)
        card = nvidia_smi("name,power.limit")
        print(card, flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        print("phase 2: build", flush=True)
        from sd3_torch import kernels
        from sd3_torch.ops import fused_attention, fused_mlp  # register K1-K4
        t0 = time.time()
        reports = kernels.build_all()
        print(f"  built {sorted(reports) or 'nothing (cached)'} in "
              f"{time.time() - t0:.1f} s", flush=True)
        for src, rep in reports.items():
            for line in rep.splitlines():
                if "ptxas info" in line and ("Used" in line or "spill" in line
                                             or "Compiling" in line):
                    print(f"  {src}: {line.strip()}", flush=True)

        print("phase 3: kernels against their plain versions", flush=True)
        gen = torch.Generator(device="cuda").manual_seed(0)
        k1 = [phase_attention(s, gen) for s in (SLICE, RAGGED, NOPE)]
        k4 = [phase_attention(s, gen, int8_qk=True) for s in (SLICE, RAGGED)]
        k3 = [phase_mlp(s, gen, tail=False) for s in (K3_SLICE, K3_RAGGED)]
        k2 = [phase_mlp(s, gen, tail=True) for s in (K2_SLICE, K2_RAGGED)]

        print("phase 4: 2-block models on the card vs fp32 on the CPU",
              flush=True)
        phase_model(gen_seed=0)
        phase_model(gen_seed=0, int8=True)

        print("phase 5: 19-block bf16 sampling, 512px, batch 4, 20 Euler "
              "steps, CFG 5", flush=True)
        sample = phase_sample(card)

        print("phase 6: 19-block int8 sampling, the same", flush=True)
        sample8 = phase_sample(card, int8=True)

        print("phase 7: kernels", flush=True)
        rows = [  # (kernel, phase-3 result at the slice shape, source,
                  #  TPU kernel it replaces, sampling run it launched in)
            (fused_attention.K1, k1[0], "fused_attention.cu",
             "sd3_tpu/ops/fused_attention.py:135", sample),
            (fused_mlp.K2, k2[0], "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:212", sample8),
            (fused_mlp.K3, k3[0], "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:93", sample8),
            (fused_attention.K4, k4[0], "fused_attention.cu",
             "sd3_tpu/ops/fused_attention.py:193", sample8),
        ]
        line = {"kernels": [{
            "name": kern.name, "route": "cuda",
            "source": f"sd3_torch/csrc/{src}", "replaces": tpu,
            "launches": run["launches_per_call"][kern.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
            for kern, r, src, tpu, run in rows]}
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
