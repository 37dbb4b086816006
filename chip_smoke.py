#!/usr/bin/env python3
"""Run the PyTorch/CUDA port (sd3_torch) end to end on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero without the final ok line):
  1. header: the card's name and power limit (nvidia-smi), torch and CUDA
     versions; TF32 off for fp32 matmuls and convolutions;
  2. build every kernel from sd3_torch/csrc (one nvcc per source, in
     parallel; attention_sm90.cu, attention_int8_sm90.cu,
     flash_bwd_sm90.cu, fused_mlp.cu and fused_dense.cu encode their TMA
     descriptors through the runtime's driver entry point, so nothing
     links libcuda; attention_fp32.cu holds the fp32 instances)
     and print the compiler's register / shared-memory report;
  3. each kernel against its plain PyTorch version in fp32 on the same
     inputs: K1 (fused joint attention; wgmma + TMA, attention_sm90.cu) at
     the 512px slice shape, a ragged shape with odd H and a NoPE shape; K4
     (its int8-QK^T variant) and K8a (int8 P.V over bf16 and over K4's
     scores; both s8 / bf16 wgmma + TMA, attention_int8_sm90.cu, the true
     row max from a first pass) at the slice and a ragged shape; K7
     (streaming attention, K1's kernel with an online softmax, compared
     over its 128-key tiles), K7q (its int8-QK^T branch) and K8b (int8 P.V
     over K7's and over K7q's scores; K4's kernel, 128-key tiles) at the
     1024px shape and a ragged shape just past 2048 tokens, the int8 ones
     each with the device time of its launches (q prep, K prep / quantize,
     V amax / quantize, attention); the public attention entry point
     once per kernel, and in fp32 (K7q, K8a and K7F are reached only
     there); K3 (int8
     SwiGLU; wgmma + TMA, fused_mlp.cu) at the text stream and a ragged
     shape; K2 (int8 SwiGLU block tail, the same device code) at the image
     stream and a shape whose tiles straddle samples; K9 (K2's function on
     any stream) at the image and the 154-token text stream, each with the
     device time of its three launches (prologue, h, w3); K10a (AdaLN +
     int8 q/k/v) and K10b (int8 out-projection + gate + residual, reading
     the image half of the joint sequence in place, also without gate and
     residual; both s8 wgmma + TMA, fused_dense.cu, one launch with the
     row prologue in it) at the 512px image stream and a ragged shape,
     each with the device time of its launch, and at rows wider than one A
     tile (k 1600, 1728, 2944, 4096: in chunks; K10b bit for bit); K5, K6a
     and K6b (flash attention forward, dq, dk / dv; wgmma + TMA: K5
     attention_sm90.cu, K6a and K6b flash_bwd_sm90.cu) at the 512px
     training shape, a ragged one, the 1024px training shape (checked on
     two heads) and at head dims 16, 128 and 48 (padded to 64); the fp32
     instances (attention_fp32.cu, 3xTF32 mma.sync), each where phase 4 or
     the attention API launches it: K5F, K6AF, K6BF at the fp32 training
     step's shape (B 2, H 19, N 410, D 64), at tiny_config's head dim 16
     and at a ragged shape; K1F at the fp32 model's (512px, batch 2), K7F
     at the 1024px slice shape and at a ragged one past 2048 tokens; each
     against its fp32 plain version with TF32 off (rel L2 <= 1e-5) and 50x
     below the bf16 instance's error.
     Kernel (CUDA graph), eager, plain-version and library times
     (attention: scaled_dot_product_attention on bf16, forward, or backward
     on the card alone: each backend pinned, the CUDA graph of forward +
     backward less that of the forward, the fastest kept, and the eager
     figure of earlier runs beside it; K10a / K10b: torch._int_mm of the
     pre-quantized activations, the GEMM alone; K2, K3, K9: torch._int_mm of
     the two products on pre-quantized operands, the GEMMs alone;
     yardsticks only), and the
     bound: the largest of the operations at the tensor-core rate, the
     bytes, and for attention the exp2s at the SFU's rate. Then K1's
     backward (K5, K6a, K6b under its autograd Function)
     against the fp32 composition's autograd;
  4. the published widths at a depth of 2 blocks on the card against the
     same weights in fp32 on the CPU (the plain path): 512px, batch 2, the
     bf16 model (through K1), the int8 (w8a8) model (through K2, K3 and
     K4) and the int8 model with the opt-in block tails, attn_tail="all"
     and mlp_tail_fusion="3d" (K4, K9, K10a, K10b); 1024px, batch 1, bf16
     (K7), int8 (K7, K2, K3) and int8 with int8 P.V (K8b, K2, K3); the fp32
     model at 512px (K1F); then one training step at 256px, batch 2 (loss,
     gradients and the update against fp32 on the CPU), in bf16 (K5, K6a,
     K6b) and in fp32 (K5F, K6AF, K6BF), and one of tiny_config in bf16
     (head dim 16: K5, K6a, K6b at D = 16);
  5. the published 19-block model with seeded random bf16 weights through
     sampler.sample_imgs: 512px, batch 4, 20 Euler steps, guidance 5, stub
     encoders and decode; one warmup, then the median of 3 timed runs; each
     sample call must launch K1 exactly 19 * 20 times; then one more call
     under torch.profiler for the card time by kernel family;
  6. the same with the model quantized to int8 (quantize_model): each sample
     call must launch K2 19 * 20, K3 18 * 20 (the last block has no text
     MLP), K4 19 * 20 and K1 0 times;
  7. the int8 model with the opt-in block tails (attn_tail="all",
     mlp_tail_fusion="3d"): each sample call must launch K10a 380 (the
     image stream's q/k/v), K10b 380 (the image out-projection; the text
     stream's declines, and the last block has none), K9 740 (380 image +
     360 text), K4 380 and K2, K3, K1 0 times (with int8 P.V asked for,
     the model's gate, the JAX package's, keeps it to more than 2048
     tokens: 512px stays on K4, tests/test_torch_model.py);
  8.-10. the same at 1024px (4250 joint tokens): bf16 (K7 380, K1 0), int8
     (K7 380, K2 380, K3 360, K4 0, K1 0), and int8 with int8 P.V (K8b 380,
     K7 0, K2 380, K3 360; one timed call);
  11. training through Trainer.train_step with the slice's configuration
     (bench.py --train defaults: the 19-block model, 512px, batch 4, fused
     low-mem AdamW, bf16 gradients, precast weights, remat): one warmup,
     then the median of 5 timed steps, each launching K5 38, K6a 19, K6b 19
     and K1-K4 0 times; one more step under torch.profiler. Then two steps
     of the default TrainConfig path (optax-shaped AdamW, fp32 gradients,
     accumulation 2, device EMA) at a depth of 2 blocks;
  12. one JSON line {"kernels": [...]} per ported kernel (with its design:
     wgmma + TMA warp-specialised, or for the fp32 instances 3xTF32
     mma.sync over shared-memory tiles), then the card's name and power
     limit, then the last line
     {"ok": true, "device": {...}}.
Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
sd3_torch package beside this file.
"""

from __future__ import annotations

import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
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
INT8_SAME_ROUNDING_ATOL = 1e-2
# K7 and K7q against the fp32 plain version over the kernel's key tiles
# (K7: fa.K7_KEY_TILE, K7q: fa.K7Q_KEY_TILE): K1's roundings (bf16 q^, k^
# and p, a bf16 output), ATTN_ATOL. K7q
# quantizes q^ and k^ from fp32 in both, so only the odd element whose
# fp32 prep sums land on the other side of an int8 rounding boundary moves
# (one level: a score change of ~1e-2 on one key). The online softmax runs
# over the same tiles in both, so p is rounded against the same running max
# (K7q's s_q enters its exp2's argument by an FFMA: ~1e-7 of p).
# K8a / K8b (int8 P.V) against the fp32 plain version: the kernel rounds q^
# and k^ to bf16 before the scores (2^-9 relative), which moves a share of
# the int8 levels of p by one (1/127 of a row's largest p); each such level
# moves its row's output by |v| / l, l the row's sum of p (>= 127), so the
# effect is K4's: K8_ATOL = K4_ATOL. Against the plain version on the same
# bf16 inputs (its roundings) only the sum order and exp2's approximation
# differ: INT8_SAME_ROUNDING_ATOL, as for K4. The card's K8b quantizes p
# against the running max of 128-key tiles (fa.K8B_KEY_TILE), the plain
# version over the same tiles; JAX's ~2176-key blocks give other levels on
# the rows whose max moves (the CPU tests hold the plain version to JAX at
# JAX's blocks and at the card's tile).
K8_ATOL = K4_ATOL
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
# K9 runs K2's device code: the same limits. K10a / K10b against the fp32
# plain version: a bf16 output (RMS ~1.6e-3 of it), and for K10a the
# LayerNorm statistics summed in another order, which moves the odd int8
# level of the quantized row (one level: 1/127 of its row scale times a
# weight, ~1e-3 of the output scale). Limits: max abs error 1e-2 x max
# |plain|, rel L2 5e-3, as for K2. Against the plain version on the same
# bf16 inputs with a bf16 output only those level moves remain (K10b: none,
# it repeats the plain arithmetic in its order): rel L2 1e-3, which a
# dropped modulation, gate or residual term, or a row given another
# sample's conditioning, exceeds by far.
K10_MAX_REL = MLP_MAX_REL
K10_REL_L2 = MLP_REL_L2
K10_SAME_ROUNDING_REL_L2 = MLP_SAME_ROUNDING_REL_L2
# bf16 model on the card against fp32 on the CPU through 2 blocks of the
# published widths: ~20 bf16 roundings on the residual path at ~0.4% each.
MODEL_REL_L2 = 3e-2
# The int8 model, on the same int8 weights: the bf16 residual path as
# above, and bf16 rounding of every quantizer's input (0.4%, up to half an
# int8 level) moves a large share of int8 levels by one (1/127 of a row's
# scale each) in ~14 quantizers per block. The same limit with int8 P.V
# (K8b): p's int8 levels move with the scores' bf16 roundings, and the
# card's 128-key tiles quantize p against other running maxima than the
# CPU's ~2176-key blocks, each noise of one p level (1/127) on a key.
INT8_MODEL_REL_L2 = 5e-2
# K5 / K6a / K6b against their fp32 plain versions on the same bf16 inputs:
# p and ds are rounded to bf16 (relative 2^-9) before their products, K5
# rounds p against a running row max (an online softmax over 128-key tiles)
# where the plain version takes the true one, and every output is written
# in bf16. Outputs
# of magnitude <= ~2: out within 1e-2; lse from fp32 statistics within 1e-3
# (a padded key let into the sum moves it by > 1e-1); dq, dk, dv within 2e-2
# of their largest element and 1e-2 relative L2 (measured at the training
# shape: 3.8e-3 and 2.4e-3).
FLASH_OUT_ATOL = 1e-2
FLASH_LSE_ATOL = 1e-3
FLASH_GRAD_MAX_REL = 2e-2
FLASH_GRAD_REL_L2 = 1e-2
# K1's backward (the prep recomputed, then K5, K6a, K6b) against the fp32
# composition's autograd: on top of the flash kernels' roundings, the prep's
# output is rounded to bf16 before K5 / K6 (the fp32 composition keeps it),
# and K5's bf16 output enters delta, whose difference with dO.v^T cancels.
# The reference uses the kernel's RMSNorm eps (bf16's). Measured at the
# training shape: 8.4e-3 of the largest element, 5.5e-3 relative L2.
K1_GRAD_MAX_REL = 3e-2
K1_GRAD_REL_L2 = 1.5e-2
# One training step of the 2-block published-width model, bf16 on the card
# (K5 / K6, bf16 gradients against bf16 weight copies) against fp32 on the
# CPU: ~20 bf16 roundings on the residual path move the velocity ~1%
# (MODEL_REL_L2 above), the loss, a mean of squares dominated by the target,
# much less; gradients carry the forward's error and the backward's own
# roundings. Adam's first step moves each weight by ~lr * sign(g), so the
# update differs by 2 lr wherever bf16 noise flips the sign of a small
# gradient; a wrong path (gradients of other weights, or none) is ~1.4.
# Measured: loss 3.1e-4 relative, gradients 1.5e-2 and the update 0.13
# relative L2.
TRAIN_LOSS_REL = 1e-2
TRAIN_GRAD_REL_L2 = 5e-2
TRAIN_UPDATE_REL_L2 = 0.4
# The fp32 instances (K1F, K7F: the fp32 prep and 3xTF32 attention; K5F,
# K6AF, K6BF: 3xTF32 flash attention) against their plain versions in fp32
# on the card, TF32 off for matmuls and convolutions (phase 1 sets both):
# the 3xTF32 products keep ~21 bits, exp2f is within 2 ulp, and the sums
# run in another order, so rel L2 within 1e-5; and the bf16 instance's
# error at the same shape (bf16 inputs, p and outputs, against the same
# fp32 plain version) at least FP32_OVER_BF16 times larger. A single TF32
# pass (~1e-3 relative) fails both.
FP32_REL_L2 = 1e-5
FP32_OVER_BF16 = 50
# The fp32 model and training step on the card against fp32 on the CPU:
# every operation in fp32 on both sides (cuBLAS without TF32, the fp32
# attention instances), only the order of the sums differs, ~1e-6 relative
# per operation. 2-block forward and gradients: rel L2 within 1e-4; the
# loss within 1e-5 relative. Adam's first step moves a weight by ~lr *
# sign(g), so an update differs by 2 lr only where fp32 noise flips the
# sign of a gradient ~1e-6 of the largest: the update within 1e-2.
FP32_MODEL_REL_L2 = 1e-4
FP32_TRAIN_LOSS_REL = 1e-5
FP32_TRAIN_GRAD_REL_L2 = 1e-4
FP32_TRAIN_UPDATE_REL_L2 = 1e-2
# H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor-core rates
# and HBM3.
PEAK_BF16_FLOPS = 989e12
PEAK_INT8_OPS = 1979e12
PEAK_BYTES = 3.35e12
# fp32-accurate products on the tensor cores: 3xTF32, three TF32 passes at
# the data sheet's 495 TFLOP/s each (beyond the 67 TFLOP/s of fp32 outside
# the tensor cores)
PEAK_FP32_FLOPS = 495e12 / 3
# The softmax's exp2s run on the SFU: 16 ex2 per SM per clock against the
# tensor cores' 4096 bf16 FLOP, so their peak rate is 1/256 of the FLOP
# rate. At D = 64 one score costs 4D = 256 FLOP in the two products, so the
# exp2s bound the attention kernels as tightly as their products.
PEAK_EXP2 = PEAK_BF16_FLOPS / 256

SLICE = dict(b=8, h=32, w=32, n_txt=154, heads=19, d=64, rope=True)
RAGGED = dict(b=2, h=5, w=7, n_txt=12, heads=3, d=32, rope=True)
# the 1024px stage: 64x64 image + 154 text tokens = 4250, batch 4 doubled by
# CFG; and odd heads at head dim 32 with a length just past the single-KV
# kernels' 2048 (2100 tokens, a ragged last tile)
SLICE_1024 = dict(b=8, h=64, w=64, n_txt=154, heads=19, d=64, rope=True)
RAGGED_STREAM = dict(b=2, h=45, w=46, n_txt=30, heads=3, d=32, rope=True)
NOPE = dict(b=2, h=10, w=15, n_txt=50, heads=4, d=64, rope=False)
# flash attention (B, H, N, D): the 512px training step (batch 4, 1024 image
# + 154 text tokens, 19 heads of 64), and odd heads with a ragged length at
# head dim 32
FLASH_SLICE = (4, 19, 1178, 64)
FLASH_RAGGED = (2, 3, 47, 32)
# the 1024px training step (4096 image + 154 text tokens), checked against
# the plain versions on the first sample's first two heads
FLASH_SLICE_1024 = (4, 19, 4250, 64)
FLASH_CHECK_1024 = (1, 2)
# the slice's training configuration (bench.py --train defaults)
TRAIN_RES, TRAIN_BATCH = 512, 4
# int8 SwiGLU: rows, tokens per sample, width, hidden, h_group (the JAX
# pickers' chunk at these shapes: ops/fused_mlp.py)
K3_SLICE = dict(m=8 * 154, n_tok=8 * 154, k=1216, hidden=4864, h_group=256)
K3_RAGGED = dict(m=300, n_tok=300, k=96, hidden=512, h_group=512)
K2_SLICE = dict(m=8 * 1024, n_tok=1024, k=1216, hidden=4864, h_group=256)
K2_RAGGED = dict(m=300, n_tok=100, k=64, hidden=384, h_group=128)
# K9 at the 512px image and text streams; its h_group is pick_blocks'
K9_SLICE = dict(m=8 * 1024, n_tok=1024, k=1216, hidden=4864)
K9_TEXT = dict(m=8 * 154, n_tok=154, k=1216, hidden=4864)
# K10a / K10b: samples, image tokens, width, output width, and the text
# tokens behind the image ones in the joint sequence K10b reads from; the
# 512px image stream and a ragged shape (300 rows: a partial 64-row tile)
K10_SLICE = dict(b=8, n=1024, k=1216, d_out=1216, n_txt=154)
K10_RAGGED = dict(b=3, n=100, k=96, d_out=64, n_txt=7)
# rows wider than the kernels' A tile (fd.K_CHUNK, 1536), which run in
# chunks: 1600 and 1728 (the widest the JAX K10a takes), 2944 (K10b's) and
# 4096 (the dim of 64 blocks), the 1024 image tokens at CFG batch 2
K10_WIDE = [dict(b=2, n=1024, k=k, d_out=k, n_txt=154)
            for k in (1600, 1728, 2944, 4096)]
# flash attention at the instances' other head dims: 16 (tiny_config's),
# 128, and 48, which runs padded to the 64 instance; the 512px token count
FLASH_DIMS = [(4, 8, 1178, 16), (4, 10, 1178, 128), (4, 8, 1178, 48)]
# the fp32 training steps on the card: the published widths at 2 blocks,
# 256px latents (32 x 32), where K5F, K6AF and K6BF launch on the main path;
# tiny_config's (head dim 16) runs in bf16 (K5, K6a, K6b at D 16)
TRAIN32_LAT = 256 // 8
TINY_LAT = 8
# the fp32 attention instances K1F and K7F are held to their plain versions
# where the main path launches them: K1F in the fp32 2-block 512px model
# (batch 2), K7F through the attention API at the 1024px slice shape; and
# at a ragged stream shape (head dim 32, a ragged last tile)
SLICE_FP32 = dict(SLICE, b=2)


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


def per_launch_us(run, iters=10) -> dict:
    """Device time (us) of each launch of one run() call, by kernel name
    (torch.profiler over `iters` calls after one more)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    name_of = lambda key: key.replace("void ", "").replace(
        "(anonymous namespace)::", "").split("(")[0][:80]
    return {name_of(e.key): round(e.self_device_time_total / e.count, 2)
            for e in prof.key_averages() if e.self_device_time_total > 0}


# (int8_qk, int8_pv, streaming) -> the kernel's row name in the output
ATTN_NAMES = {(False, False, False): "K1", (True, False, False): "K4",
              (False, True, False): "K8a", (True, True, False): "K8a over K4",
              (False, False, True): "K7", (True, False, True): "K7q",
              (False, True, True): "K8b", (True, True, True): "K8b over K7q"}


def bound(t_ops, t_bytes, t_exp=0.0) -> dict:
    """The least time of a kernel's work (seconds in, ms out): the largest
    of its products at the tensor-core rate, its exp2s at the SFU's and its
    bytes. bound_by is "bytes" or "operations" (both rates are operations
    over their peak); bound_term names the term: tensor, exp2 or bytes."""
    terms = {"tensor": t_ops, "exp2": t_exp, "bytes": t_bytes}
    term = max(terms, key=terms.get)
    return dict(bound_ms=terms[term] * 1e3,
                bound_by="bytes" if term == "bytes" else "operations",
                bound_term=term)


def _rel_l2(got, want) -> float:
    """Relative L2 error of got against want, in fp64."""
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


def prep_for_sdpa(x, c, s, eps):
    """The plain q / k prep (per-head RMSNorm + table rotation) of (B, H, N,
    D) heads in x's dtype: SDPA's inputs for the library yardstick."""
    import torch
    from sd3_torch.ops.rope import _rotate_half_interleaved
    xf = x.float()
    xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return (xn * c + _rotate_half_interleaved(xn) * s).to(x.dtype)


def attn_inputs(shape, gen):
    """bf16 q, k, v (B, N, H*D), the norm weights and the folded tables of
    one attention shape, on the card."""
    import torch
    from sd3_torch.ops import fused_attention as fa
    from sd3_torch.ops.rope import rope2d_axial_angles

    b, nh, d = shape["b"], shape["heads"], shape["d"]
    n_img = shape["h"] * shape["w"]
    n = n_img + shape["n_txt"]
    q, k, v = (torch.randn((b, n, nh * d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ws = [1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
          for _ in range(4)]
    angles = (rope2d_axial_angles(shape["h"], shape["w"], d).reshape(n_img, d)
              if shape["rope"] else None)
    cos, sin = (torch.as_tensor(t, device="cuda")
                for t in fa.rope_row_tables(angles, n, d))
    tables = (*fa.fold_row_tables(cos, sin, ws[0], ws[1], n_img),
              *fa.fold_row_tables(cos, sin, ws[2], ws[3], n_img))
    return q, k, v, ws, angles, n_img, tables


def phase_attention(shape, gen, int8_qk=False, int8_pv=False):
    """One fused-attention kernel (K1; K4 with int8_qk; K8a with int8_pv; K7,
    K7q, K8b above 2048 padded tokens) vs its plain version at one shape;
    returns the measurements."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import fused_attention as fa

    b, nh, d = shape["b"], shape["heads"], shape["d"]
    q, k, v, _, _, n_img, tables = attn_inputs(shape, gen)
    n = q.shape[1]
    cosq, sinq, cosk, sink = tables
    scale = d ** -0.5
    eps = float(torch.finfo(torch.bfloat16).eps)
    streaming = -(-n // 128) * 128 > fa.SINGLE_KV_MAX
    name = ATTN_NAMES[(int8_qk, int8_pv, streaming)]
    if streaming:
        plain = (fa.composition_stream_int8_qk if int8_qk
                 else fa.composition_stream)
    else:
        plain = fa.composition_int8_qk if int8_qk else fa.composition
    # the plain versions take int8_pv where they have it; the streaming ones
    # are compared over the kernel's key tiles (K7's and K8b's 128, K7q's
    # 64), timed with JAX's blocks
    kw = dict(int8_pv=True) if int8_pv else {}
    tile = (fa.K8B_KEY_TILE if int8_pv else fa.K7Q_KEY_TILE if int8_qk
            else fa.K7_KEY_TILE)
    cmp_kw = dict(kw, block_k=tile) if streaming else kw
    run_k = lambda: fa.fused_attention(q, k, v, nh, *tables, scale,
                                       int8_qk=int8_qk, int8_pv=int8_pv)
    run_plain = lambda: plain(q, k, v, *tables, scale, eps, eps, nh, **kw)
    got = run_k()
    torch.cuda.synchronize()
    want = plain(q.float(), k.float(), v.float(), *tables, scale, eps, eps, nh,
                 **cmp_kw)
    same_rounding = plain(q, k, v, *tables, scale, eps, eps, nh, **cmp_kw)
    err = (got.float() - want).abs().max().item()
    rel = err / want.abs().max().item()
    plain_err = (same_rounding.float() - want).abs().max().item()
    require(bool(torch.isfinite(got).all()), f"{name} non-finite at {shape}")

    # library yardstick: SDPA on q/k/v prepped by the plain version (bf16;
    # no library attention takes int8 operands)
    def heads(x):
        return x.reshape(b, n, nh, d).transpose(1, 2).contiguous()

    qh, kh, vh = (prep_for_sdpa(heads(q), cosq, sinq, eps),
                  prep_for_sdpa(heads(k), cosk, sink, eps), heads(v))
    run_lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)

    ms = cuda_ms(run_k)
    eager_ms = cuda_ms(run_k, graph=False)
    plain_ms = cuda_ms(run_plain, iters=3, groups=3)
    library_ms = cuda_ms(run_lib)
    # QK^T and P.V, 2*B*H*N^2*D operations each, at the int8 rate where the
    # kernel's product is int8 (K8a's second score pass is its own choice);
    # one exp2 per score
    prod = 2.0 * b * nh * n * n * d
    rate = lambda int8: PEAK_INT8_OPS if int8 else PEAK_BF16_FLOPS
    t_ops = prod / rate(int8_qk) + prod / rate(int8_pv)
    t_exp = 1.0 * b * nh * n * n / PEAK_EXP2
    nbytes = 4.0 * b * n * nh * d * 2 + 4.0 * n * d * 4  # q, k, v, out + tables
    t_bytes = nbytes / PEAK_BYTES
    res = dict(shape=f"B={b} N={n} n_img={n_img} H={nh} D={d} "
               f"{'RoPE2d' if shape['rope'] else 'NoPE'}",
               max_abs_err=err, max_rel_err=rel, plain_bf16_max_abs_err=plain_err,
               kernel_vs_plain_bf16_max_abs_err=(
                   got.float() - same_rounding.float()).abs().max().item(),
               ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=library_ms, **bound(t_ops, t_bytes, t_exp))
    if name in ("K4", "K8a", "K8a over K4", "K7q", "K8b", "K8b over K7q"):
        # the device time of each launch: q prep, K prep / quantize, V amax
        # / quantize, attention
        res["us_per_launch"] = per_launch_us(run_k)
    print(f"  {name}", json.dumps(res), flush=True)
    atol = (K8_ATOL if int8_pv else K4_ATOL if int8_qk and not streaming
            else ATTN_ATOL)
    require(err <= atol, f"{name} max abs err {err} > {atol} at {res['shape']}")
    same = res["kernel_vs_plain_bf16_max_abs_err"]
    require(not (int8_qk or int8_pv) or same <= INT8_SAME_ROUNDING_ATOL,
            f"{name} max abs err {same} against the plain version's own "
            f"roundings > {INT8_SAME_ROUNDING_ATOL} at {res['shape']}")
    return res


def phase_attention_api(gen):
    """The public entry point `fused_dual_flash_attention` once per kernel,
    at the 512px and 1024px slice shapes, in bf16 (and in fp32, K1F / K7F):
    the int8 QK^T branch above 2048 tokens (K7q) and int8 P.V at or below it
    (K8a) are reached only this way (the model gates them off, as the JAX
    package does). Launch counts reset before, read after; returns them."""
    import torch
    from sd3_torch.ops import fused_attention as fa

    calls = []
    for shape in (SLICE, SLICE_1024):
        q, k, v, ws, angles, n_img, _ = attn_inputs(shape, gen)
        for int8_qk, int8_pv in ((False, False), (True, False), (False, True),
                                 (True, True)):
            calls.append((q, k, v, ws, angles, n_img, shape, int8_qk,
                          int8_pv))
        calls.append((q.float(), k.float(), v.float(), ws, angles, n_img,
                      shape, False, False))
    torch.cuda.synchronize()
    reset_launches()
    with torch.inference_mode():
        for q, k, v, ws, angles, n_img, shape, int8_qk, int8_pv in calls:
            out = fa.fused_dual_flash_attention(
                q, k, v, shape["heads"], *ws, angles, n_img,
                shape["d"] ** -0.5, int8_qk=int8_qk, int8_pv=int8_pv)
            require(bool(torch.isfinite(out).all()) and out.shape == q.shape,
                    f"fused_dual_flash_attention int8_qk={int8_qk} "
                    f"int8_pv={int8_pv} at {shape}: bad output")
    torch.cuda.synchronize()
    launches = launch_counts()
    print("  attention API", json.dumps(launches), flush=True)
    want = dict(fused_attention_bf16=1, fused_attention_int8qk=1,
                fused_attention_int8pv=2, fused_attention_stream=1,
                fused_attention_stream_int8qk=1,
                fused_attention_stream_int8pv=2, fused_attention_fp32=1,
                fused_attention_stream_fp32=1)
    for nm, c in want.items():
        require(launches[nm] == c, f"{nm} launched {launches[nm]} times "
                f"through the attention API, expected {c}")
    return launches


def phase_mlp(shape, gen, kind):
    """K2, K3 or K9 (`kind`) vs the plain version at one shape."""
    import torch
    from sd3_torch.ops import fused_mlp as fm
    from sd3_torch.ops.quant import int_mm, quantize_weight

    name, tail = kind, kind != "K3"
    m, n_tok, k, hidden = shape["m"], shape["n_tok"], shape["k"], shape["hidden"]
    h_group = (fm.pick_blocks(n_tok, hidden)[1] if kind == "K9"
               else shape["h_group"])
    b = m // n_tok
    dev = "cuda"
    rnd = lambda *sz, sd=1.0: torch.randn(sz, generator=gen, device=dev) * sd
    x = rnd(m, k).to(torch.bfloat16)
    w12_q, s12 = quantize_weight(rnd(2 * hidden, k, sd=k ** -0.5))
    w3_q, s3 = quantize_weight(rnd(k, hidden, sd=hidden ** -0.5))
    # biases and conditioning in bf16, as the model's cast leaves them (so
    # K9's rounding of the conditioning to x's dtype changes nothing here)
    b12, b3 = (rnd(n, sd=0.1).to(torch.bfloat16) for n in (2 * hidden, k))
    shift, scale = (rnd(b, k, sd=0.3).to(torch.bfloat16) for _ in range(2))
    gate = rnd(b, k, sd=0.5).to(torch.bfloat16)
    w = (w12_q, s12, b12, w3_q, s3, b3)
    cond = dict(shift=shift, scale=scale, gate=gate, n_tok=n_tok, adaln=tail,
                residual=tail)
    tail_fn = {"K2": fm.swiglu_int8_tail, "K9": fm.swiglu_int8_tail3d}
    if tail:
        run_k = lambda: tail_fn[kind](x, shift, scale, gate, *w,
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
    # library yardstick: torch._int_mm of the two products on operands
    # quantized beforehand, the GEMMs alone (no quantization, silu * mul,
    # requantization or epilogue), which the port never calls
    xq = torch.randint(-127, 128, (m, k), generator=gen, device=dev,
                       dtype=torch.int8)
    hq = torch.randint(-127, 128, (m, hidden), generator=gen, device=dev,
                       dtype=torch.int8)
    run_lib = lambda: (int_mm(xq, w12_q), int_mm(hq, w3_q))
    ms = cuda_ms(run_k)
    eager_ms = cuda_ms(run_k, graph=False)
    plain_ms = cuda_ms(run_plain, iters=3, groups=3)
    library_ms = cuda_ms(run_lib)
    ops = 2.0 * m * k * 2 * hidden + 2.0 * m * hidden * k
    ins = (x, *w) + ((shift, scale, gate) if tail else ())
    nbytes = sum(t.numel() * t.element_size() for t in ins) + m * k * 2
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    res = dict(shape=f"M={m} n_tok={n_tok} K={k} hidden={hidden} "
               f"h_group={h_group}", max_abs_err=err, max_rel_err=rel,
               rel_l2=rel_l2, kernel_vs_plain_bf16_rel_l2=same_l2, ms=ms,
               eager_ms=eager_ms, plain_ms=plain_ms, library_ms=library_ms,
               library_is="torch._int_mm x2 on pre-quantized operands: the "
               "GEMMs alone", us_per_launch=per_launch_us(run_k),
               **bound(t_ops, t_bytes))
    print(f"  {name}", json.dumps(res), flush=True)
    require(rel <= MLP_MAX_REL and rel_l2 <= MLP_REL_L2,
            f"{name} max err {rel} x max|plain| (limit {MLP_MAX_REL}), rel L2 "
            f"{rel_l2} (limit {MLP_REL_L2}) at {res['shape']}")
    require(same_l2 <= MLP_SAME_ROUNDING_REL_L2,
            f"{name} rel L2 {same_l2} against the plain version's own "
            f"roundings (limit {MLP_SAME_ROUNDING_REL_L2}) at {res['shape']}")
    return res


def phase_dense(shape, gen, name, gated=True, residual=True):
    """K10a (AdaLN + int8 q/k/v) or K10b (int8 out-projection [* gate]
    [+ residual], `name`) vs its plain version at one shape; K10b reads the
    image half of a joint sequence in place, as the model hands it over.
    The library yardstick is torch._int_mm of the activations quantized
    beforehand against the three weights (K10a) or the one (K10b): the
    GEMMs alone, which the port never calls in these kernels' place."""
    import torch
    from sd3_torch.ops import fused_dense as fd
    from sd3_torch.ops.quant import int_mm, quantize_rows, quantize_weight

    b, n, k, d = shape["b"], shape["n"], shape["k"], shape["d_out"]
    bf = torch.bfloat16
    dev = "cuda"
    rnd = lambda *sz, sd=1.0: torch.randn(sz, generator=gen, device=dev) * sd
    n_w = 3 if name == "K10a" else 1
    ws = [t for _ in range(n_w)
          for t in quantize_weight(rnd(d, k, sd=k ** -0.5))]
    # conditioning in bf16, as the model's cast leaves it, far apart per
    # sample: a row given another sample's vector is a large error
    step = torch.arange(b, device=dev, dtype=torch.float32)[:, None]
    if name == "K10a":
        x = rnd(b, n, k).to(bf)
        shift = (step + rnd(b, k, sd=0.1)).to(bf)
        scale = rnd(b, k, sd=0.3).to(bf)
        run_k = lambda: fd.qkv_adaln_int8(x, shift, scale, *ws)
        plain = lambda t: fd.qkv_adaln_int8_plain(t, shift, scale, *ws)
        act, ins, out_bytes = x, (x, shift, scale, *ws), 3 * b * n * d * 2
        label = f"B={b} N={n} K={k} N_out={d} x3"
    else:
        joint = rnd(b, n + shape["n_txt"], k).to(bf)
        x = joint[:, :n]                      # a strided view, not a copy
        gate = (step - 1 + rnd(b, d, sd=0.5)).to(bf) if gated else None
        res = rnd(b, n, d).to(bf) if residual else None
        run_k = lambda: fd.out_gate_residual_int8(x, gate, res, *ws)
        plain = lambda t: fd.out_gate_residual_int8_plain(
            t, gate, None if res is None else res.to(t.dtype), *ws)
        act, ins, out_bytes = x, (x, gate, res, *ws), b * n * d * 2
        label = (f"B={b} N={n} (of {n + shape['n_txt']}) K={k} N_out={d}"
                 f"{' gate' if gated else ''}{' residual' if residual else ''}")
    cat = lambda outs: (torch.cat([o.float().reshape(-1) for o in outs])
                        if isinstance(outs, tuple) else outs.float())
    got = run_k()
    torch.cuda.synchronize()
    got = cat(got)
    require(bool(torch.isfinite(got).all()), f"{name} non-finite at {label}")
    want = cat(plain(act.float()))
    same = cat(plain(act))
    e = _errs(got, want)
    same_l2 = ((got - same).norm() / same.norm()).item()
    xq, _ = quantize_rows(act.reshape(-1, k).float())
    run_lib = lambda: [int_mm(xq, w) for w in ws[0::2]]
    ms = cuda_ms(run_k)
    eager_ms = cuda_ms(run_k, graph=False)
    plain_ms = cuda_ms(lambda: plain(act), iters=3, groups=3)
    library_ms = cuda_ms(run_lib)
    ops = 2.0 * b * n * k * d * n_w
    nbytes = sum(t.numel() * t.element_size() for t in ins
                 if t is not None) + out_bytes
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    res_d = dict(shape=label, **e, kernel_vs_plain_bf16_rel_l2=same_l2,
                 ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                 library_ms=library_ms, us_per_launch=per_launch_us(run_k),
                 **bound(t_ops, t_bytes))
    print(f"  {name}", json.dumps(res_d), flush=True)
    require(e["max_rel_err"] <= K10_MAX_REL and e["rel_l2"] <= K10_REL_L2,
            f"{name} max err {e['max_rel_err']} x max|plain| (limit "
            f"{K10_MAX_REL}), rel L2 {e['rel_l2']} (limit {K10_REL_L2}) at "
            f"{label}")
    require(same_l2 <= K10_SAME_ROUNDING_REL_L2,
            f"{name} rel L2 {same_l2} against the plain version's own "
            f"roundings (limit {K10_SAME_ROUNDING_REL_L2}) at {label}")
    # K10b repeats its plain version's arithmetic on the same bf16 values:
    # the same bits
    require(name != "K10b" or torch.equal(got, same),
            f"K10b differs from its plain version's bits at {label}")
    return res_d


def _errs(got, want) -> dict:
    """Max abs error, max abs error / max |want| and relative L2 of got
    against want."""
    d = got.float() - want.float()
    err = d.abs().max().item()
    return dict(max_abs_err=err, max_rel_err=err / want.abs().max().item(),
                rel_l2=(d.norm() / want.norm()).item())


SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def sdpa_backward_ms(q, k, v, do, scale) -> dict:
    """SDPA's backward (dq, dk, dv together), a yardstick the port never
    calls, on the card alone: for each backend of the installed PyTorch,
    pinned with sdpa_kernel, the CUDA graph of its forward +
    torch.autograd.grad less that of its forward (by_backend: ms, or why it
    did not run); the fastest as ms, with its backend; and eager_ms, the
    figure of earlier runs: forward + backward less forward under the
    default dispatch, both eager, so that autograd's host work is in it
    wherever the host falls behind the card."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    fwd = lambda: F.scaled_dot_product_attention(qr, kr, vr, scale=scale)

    def fwd_bwd():
        torch.autograd.grad(fwd(), (qr, kr, vr), do)
    by = {}
    for name in SDPA_BACKENDS:
        backend = getattr(SDPBackend, name, None)
        if backend is None:
            by[name] = "not in this PyTorch"
            continue
        try:
            with sdpa_kernel(backend):
                fwd_bwd()  # a backend that refuses the shape raises here,
                torch.cuda.synchronize()  # outside a graph capture
                by[name] = cuda_ms(fwd_bwd) - cuda_ms(fwd)
        except RuntimeError as e:
            by[name] = f"did not run: {str(e).strip().splitlines()[0][:160]}"
    timed = {n: t for n, t in by.items() if isinstance(t, float)}
    require(timed, f"no SDPA backend ran the backward: {by}")
    best = min(timed, key=timed.get)
    plain_fwd = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    eager = cuda_ms(fwd_bwd, graph=False) - cuda_ms(plain_fwd, graph=False)
    return dict(ms=timed[best], backend=best, by_backend=by, eager_ms=eager)


def phase_flash(shape, gen, check=None):
    """K5, K6a and K6b vs their fp32 plain versions at one (B, H, N, D)
    shape, on the samples and heads [:check[0], :check[1]] where `check` is
    given (the plain versions' fp32 score matrices at the 1024px training
    shape take 5.5 GB each); the kernels, the plain versions and SDPA timed
    at the full shape (SDPA's backward by sdpa_backward_ms); returns
    {"K5" | "K6a" | "K6b": measurements}."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import flash_attention as fl

    b, h, n, d = shape
    scale = d ** -0.5
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   .to(torch.bfloat16) for _ in range(4))
    out, lse = fl.flash_fwd(q, k, v, scale)
    dq, delta = fl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    for t in (out, lse, dq, delta, dk, dv):
        require(bool(torch.isfinite(t).all()), f"flash non-finite at {shape}")
    cut = (lambda t: t[:check[0], :check[1]]) if check else (lambda t: t)
    qf, kf, vf, dof = (cut(t).float() for t in (q, k, v, do))
    w_out, w_lse = fl.flash_fwd_plain(qf, kf, vf, scale)
    w_dq, w_delta = fl.flash_dq_plain(qf, kf, vf, w_out, dof, w_lse, scale)
    w_dk, w_dv = fl.flash_dkv_plain(qf, kf, vf, dof, w_lse, w_delta, scale)
    errs = dict(
        K5=dict(out=_errs(cut(out), w_out), lse=_errs(cut(lse), w_lse)),
        K6a=dict(dq=_errs(cut(dq), w_dq), delta=_errs(cut(delta), w_delta)),
        K6b=dict(dk=_errs(cut(dk), w_dk), dv=_errs(cut(dv), w_dv)))
    label = f"B={b} H={h} N={n} D={d}"

    # library yardsticks, never called by the port: SDPA's forward, and its
    # backward (dq, dk, dv together) on the card alone
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    lib_bwd = sdpa_backward_ms(q, k, v, do, scale)
    print("  SDPA backward", json.dumps(dict(shape=label, **lib_bwd)),
          flush=True)
    bwd_lib = dict(library_ms=lib_bwd["ms"],
                   library_backend=lib_bwd["backend"],
                   library_eager_ms=lib_bwd["eager_ms"])
    one, stat = b * h * n * d * 2, b * h * n * 4  # bytes: a bf16 tensor, lse
    bh_nnd = b * h * n * n * d
    # each kernel takes exp2 of every score once (K6a, K6b recompute p)
    t_exp = 1.0 * b * h * n * n / PEAK_EXP2
    runs = dict(  # kernel, plain version, products of 2*B*H*N^2*D, bytes,
                  # library figures
        K5=(lambda: fl.flash_fwd(q, k, v, scale),
            lambda: fl.flash_fwd_plain(q, k, v, scale), 2, 4 * one + stat,
            dict(library_ms=cuda_ms(sdpa))),
        K6a=(lambda: fl.flash_dq(q, k, v, out, do, lse, scale),
             lambda: fl.flash_dq_plain(q, k, v, out, do, lse, scale), 3,
             6 * one + 2 * stat, bwd_lib),
        K6b=(lambda: fl.flash_dkv(q, k, v, do, lse, delta, scale),
             lambda: fl.flash_dkv_plain(q, k, v, do, lse, delta, scale), 4,
             6 * one + 2 * stat, bwd_lib))
    results = {}
    for name, (run, plain, products, nbytes, lib) in runs.items():
        t_ops = products * 2 * bh_nnd / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        res = dict(shape=label, checked=(f"[:{check[0]}, :{check[1]}]"
                                         if check else "all"),
                   errors=errs[name],
                   max_abs_err=max(e["max_abs_err"] for k, e in
                                   errs[name].items() if k not in ("lse",
                                                                   "delta")),
                   ms=cuda_ms(run), eager_ms=cuda_ms(run, graph=False),
                   plain_ms=cuda_ms(plain, iters=3, groups=3), **lib,
                   **bound(t_ops, t_bytes, t_exp))
        print(f"  {name}", json.dumps(res), flush=True)
        results[name] = res
    out_err = errs["K5"]["out"]["max_abs_err"]
    require(out_err <= FLASH_OUT_ATOL,
            f"K5 out max abs err {out_err} > {FLASH_OUT_ATOL} at {shape}")
    lse_err = errs["K5"]["lse"]["max_abs_err"]
    require(lse_err <= FLASH_LSE_ATOL,
            f"K5 lse max abs err {lse_err} > {FLASH_LSE_ATOL} at {shape}")
    for name, key in (("K6a", "dq"), ("K6b", "dk"), ("K6b", "dv")):
        e = errs[name][key]
        require(e["max_rel_err"] <= FLASH_GRAD_MAX_REL
                and e["rel_l2"] <= FLASH_GRAD_REL_L2,
                f"{name} {key}: max err {e['max_rel_err']} of max|plain| "
                f"(limit {FLASH_GRAD_MAX_REL}), rel L2 {e['rel_l2']} (limit "
                f"{FLASH_GRAD_REL_L2}) at {shape}")
    return results


def phase_flash_fp32(shape, gen):
    """K5F, K6AF and K6BF (the fp32 instances) vs their plain versions in
    fp32 on the card (TF32 off) at one (B, H, N, D) shape: rel L2 within
    FP32_REL_L2, and FP32_OVER_BF16 times below the bf16 instances' error
    at the same shape; kernel, plain-version and SDPA (fp32) times."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import flash_attention as fl

    b, h, n, d = shape
    scale = d ** -0.5
    # fp32 values that bf16 does not hold, so the bf16 instance's error
    # includes its inputs' rounding
    q, k, v, do = (torch.randn(shape, generator=gen, device="cuda")
                   for _ in range(4))
    w_out, w_lse = fl.flash_fwd_plain(q, k, v, scale)
    w_dq, w_delta = fl.flash_dq_plain(q, k, v, w_out, do, w_lse, scale)
    w_dk, w_dv = fl.flash_dkv_plain(q, k, v, do, w_lse, w_delta, scale)
    out, lse = fl.flash_fwd(q, k, v, scale)
    dq, delta = fl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = fl.flash_dkv(q, k, v, do, lse, delta, scale)
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    bo, bl = fl.flash_fwd(qb, kb, vb, scale)
    bdq, bdelta = fl.flash_dq(qb, kb, vb, bo, dob, bl, scale)
    bdk, bdv = fl.flash_dkv(qb, kb, vb, dob, bl, bdelta, scale)
    torch.cuda.synchronize()
    rel = _rel_l2
    errs = dict(K5F=dict(out=rel(out, w_out)), K6AF=dict(dq=rel(dq, w_dq)),
                K6BF=dict(dk=rel(dk, w_dk), dv=rel(dv, w_dv)))
    bf16 = dict(K5F=dict(out=rel(bo, w_out)), K6AF=dict(dq=rel(bdq, w_dq)),
                K6BF=dict(dk=rel(bdk, w_dk), dv=rel(bdv, w_dv)))
    lse_err = (lse - w_lse).abs().max().item()
    label = f"B={b} H={h} N={n} D={d} fp32"
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    lib_bwd = sdpa_backward_ms(q, k, v, do, scale)
    bwd_lib = dict(library_ms=lib_bwd["ms"], library_backend=lib_bwd["backend"],
                   library_eager_ms=lib_bwd["eager_ms"])
    one, stat = b * h * n * d * 4, b * h * n * 4
    bh_nnd = b * h * n * n * d
    t_exp = 1.0 * b * h * n * n / PEAK_EXP2
    runs = dict(
        K5F=(lambda: fl.flash_fwd(q, k, v, scale),
             lambda: fl.flash_fwd_plain(q, k, v, scale), 2, 4 * one + stat,
             dict(library_ms=cuda_ms(sdpa))),
        K6AF=(lambda: fl.flash_dq(q, k, v, out, do, lse, scale),
              lambda: fl.flash_dq_plain(q, k, v, out, do, lse, scale), 3,
              6 * one + 2 * stat, bwd_lib),
        K6BF=(lambda: fl.flash_dkv(q, k, v, do, lse, delta, scale),
              lambda: fl.flash_dkv_plain(q, k, v, do, lse, delta, scale), 4,
              6 * one + 2 * stat, bwd_lib))
    results = {}
    for name, (run, plain, products, nbytes, lib) in runs.items():
        e = max(errs[name].values())
        res = dict(shape=label, rel_l2=errs[name], bf16_rel_l2=bf16[name],
                   max_abs_err=max((g - w).abs().max().item() for g, w in {
                       "K5F": [(out, w_out)], "K6AF": [(dq, w_dq)],
                       "K6BF": [(dk, w_dk), (dv, w_dv)]}[name]),
                   ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=3, groups=3),
                   **lib, **bound(products * 2 * bh_nnd / PEAK_FP32_FLOPS,
                                  nbytes / PEAK_BYTES, t_exp))
        if name == "K5F":
            res["lse_max_abs_err"] = lse_err
        print(f"  {name}", json.dumps(res), flush=True)
        results[name] = res
        require(e <= FP32_REL_L2, f"{name} rel L2 {errs[name]} > "
                f"{FP32_REL_L2} at {label}")
        for key, err in errs[name].items():
            require(err * FP32_OVER_BF16 <= bf16[name][key],
                    f"{name} {key}: rel L2 {err} is not {FP32_OVER_BF16}x "
                    f"below the bf16 instance's {bf16[name][key]} at {label}")
    require(lse_err <= FP32_REL_L2 * 10,
            f"K5F lse max abs err {lse_err} at {label}")
    return results


def phase_attention_fp32(shape, gen):
    """K1F (at most 2048 padded tokens) or K7F (above) on fp32 q, k, v
    against the fp32 plain composition on the card (TF32 off): rel L2
    within FP32_REL_L2, and FP32_OVER_BF16 times below the bf16 kernel's
    error at the same shape; kernel, plain-version and SDPA (fp32) times."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import fused_attention as fa

    b, nh, d = shape["b"], shape["heads"], shape["d"]
    qb, kb, vb, _, _, n_img, tables = attn_inputs(shape, gen)
    q, k, v = (t.float() + 1e-3 * torch.randn(t.shape, generator=gen,
                                              device="cuda")
               for t in (qb, kb, vb))
    n = q.shape[1]
    scale = d ** -0.5
    streaming = -(-n // 128) * 128 > fa.SINGLE_KV_MAX
    name = "K7F" if streaming else "K1F"
    eps32 = float(torch.finfo(torch.float32).eps)
    eps16 = float(torch.finfo(torch.bfloat16).eps)
    run_k = lambda: fa.fused_attention(q, k, v, nh, *tables, scale)
    plain = fa.composition_stream if streaming else fa.composition
    run_plain = lambda: plain(q, k, v, *tables, scale, eps32, eps32, nh)
    got = run_k()
    bf = fa.fused_attention(*(t.bfloat16() for t in (q, k, v)), nh, *tables,
                            scale)
    torch.cuda.synchronize()
    want = run_plain()
    want16 = plain(q, k, v, *tables, scale, eps16, eps16, nh)
    err, bf_err = _rel_l2(got, want), _rel_l2(bf, want16)
    require(bool(torch.isfinite(got).all()), f"{name} non-finite at {shape}")

    def heads(x):
        return x.reshape(b, n, nh, d).transpose(1, 2).contiguous()

    cq, sq, ck, sk = tables
    qh, kh, vh = (prep_for_sdpa(heads(q), cq, sq, eps32),
                  prep_for_sdpa(heads(k), ck, sk, eps32), heads(v))
    run_lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    prod = 2.0 * b * nh * n * n * d
    nbytes = 4.0 * b * n * nh * d * 4 + 4.0 * n * d * 4
    res = dict(shape=f"B={b} N={n} H={nh} D={d} fp32", rel_l2=err,
               bf16_rel_l2=bf_err,
               max_abs_err=(got - want).abs().max().item(), ms=cuda_ms(run_k),
               plain_ms=cuda_ms(run_plain, iters=3, groups=3),
               library_ms=cuda_ms(run_lib),
               **bound(2 * prod / PEAK_FP32_FLOPS, nbytes / PEAK_BYTES,
                       1.0 * b * nh * n * n / PEAK_EXP2))
    print(f"  {name}", json.dumps(res), flush=True)
    require(err <= FP32_REL_L2, f"{name} rel L2 {err} > {FP32_REL_L2} at "
            f"{res['shape']}")
    require(err * FP32_OVER_BF16 <= bf_err,
            f"{name} rel L2 {err} is not {FP32_OVER_BF16}x below the bf16 "
            f"kernel's {bf_err} at {res['shape']}")
    return res


def phase_k1_backward(gen):
    """K1's autograd Function at the training shape: K1 forward, then the
    prep recomputed and K5, K6a, K6b; gradients of q, k, v and the four norm
    weights against the fp32 plain composition's autograd."""
    import torch
    from sd3_torch.ops import flash_attention as fl
    from sd3_torch.ops import fused_attention as fa
    from sd3_torch.ops.rope import rope2d_axial_angles

    b, nh, d, hw, n_txt = TRAIN_BATCH, 19, 64, (32, 32), 154
    n_img = hw[0] * hw[1]
    n, f = n_img + n_txt, nh * d
    q, k, v, g = (torch.randn((b, n, f), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    ws = [1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
          for _ in range(4)]
    angles = rope2d_axial_angles(*hw, d).reshape(n_img, d)
    ins = [t.clone().requires_grad_() for t in (q, k, v, *ws)]
    before = launch_counts()
    out = fa.fused_dual_flash_attention(*ins[:3], nh, *ins[3:], angles, n_img,
                                        d ** -0.5)
    got = torch.autograd.grad(out, ins, g)
    torch.cuda.synchronize()
    after = launch_counts()
    ran = {kern.name: after[kern.name] - before[kern.name]
           for kern in (fa.K1, fl.K5, fl.K6A, fl.K6B)}
    require(all(c == 1 for c in ran.values()),
            f"K1 forward + backward launched {ran}, expected one each")
    # the plain composition in fp32 on the same values, with the kernel's
    # RMSNorm eps (that of bf16)
    ref = [t.detach().float().requires_grad_() for t in (q, k, v, *ws)]
    cos, sin = (torch.as_tensor(t, device="cuda")
                for t in fa.rope_row_tables(angles, n, d))
    cq, sq = fa.fold_row_tables(cos, sin, ref[3], ref[4], n_img)
    ck, sk = fa.fold_row_tables(cos, sin, ref[5], ref[6], n_img)
    eps = float(torch.finfo(torch.bfloat16).eps)
    want = torch.autograd.grad(fa.composition(
        *ref[:3], cq, sq, ck, sk, d ** -0.5, eps, eps, nh), ref, g.float())
    names = ("dq", "dk", "dv", "dw_q_img", "dw_q_txt", "dw_k_img", "dw_k_txt")
    errs = {nm: _errs(a, w) for nm, a, w in zip(names, got, want)}
    print("  K1 backward", json.dumps(dict(
        shape=f"B={b} N={n} H={nh} D={d}", launches=ran, errors=errs)),
        flush=True)
    for nm, e in errs.items():
        require(e["max_rel_err"] <= K1_GRAD_MAX_REL
                and e["rel_l2"] <= K1_GRAD_REL_L2,
                f"K1 backward {nm}: max err {e['max_rel_err']} of max|plain| "
                f"(limit {K1_GRAD_MAX_REL}), rel L2 {e['rel_l2']} (limit "
                f"{K1_GRAD_REL_L2})")
    return errs


def _flat_rel_l2(got: dict, want: dict) -> float:
    """Relative L2 of two {name: tensor} dicts as one vector each."""
    num = sum(float((got[k].float().cpu() - want[k].float()).square().sum())
              for k in want)
    den = sum(float(want[k].float().square().sum()) for k in want)
    return (num / den) ** 0.5


def train_step_config():
    """The training steps' model: the published widths at a depth of 2
    blocks, stage 256px."""
    from sd3_torch.config import published_config
    return published_config(stage_res=256).replace(num_blocks=2)


def step_flash_shape(cfg, lat, batch=2) -> tuple:
    """(B, H, N, D) of the flash attention calls of a training step of `cfg`
    on lat x lat latents: the image patches and the text tokens."""
    return (batch, cfg.num_heads, (lat // cfg.patch_size) ** 2
            + cfg.text_tokens, cfg.dim // cfg.num_heads)


def phase_train_step_2block(log_dir, fp32=False):
    """One training step of the published widths at a depth of 2 blocks,
    256px, batch 2 on the card: the slice's flags in bf16 (K5, K6a, K6b),
    or with `fp32` all in fp32 (K5F, K6AF, K6BF), against the same weights
    and noise in fp32 on the CPU (plain path)."""
    return phase_train_step(log_dir, train_step_config(), "2-block",
                            lat=TRAIN32_LAT, fp32=fp32)


def phase_train_step(log_dir, cfg, label, lat, fp32=False):
    """One training step of `cfg` (latents lat x lat, batch 2) on the card
    against the same weights and noise in fp32 on the CPU (plain path):
    in bf16 with the slice's flags (bf16 gradients against bf16 weight
    copies; K5, K6a, K6b) or, with `fp32`, all in fp32 (K5F, K6AF, K6BF)."""
    import torch
    from sd3_torch.training.trainer import Noise, TrainConfig, Trainer, draw_noise

    kw = dict(batch_size=2, accumulation_steps=1, lr=1e-4, warmup_steps=0,
              low_mem_optimizer=True, fused_optimizer=True, track_ema=False,
              remat_blocks=True)
    ref = Trainer(cfg.replace(dtype="float32"), TrainConfig(**kw),
                  device="cpu", log_dir=log_dir, use_wandb=False)
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    if fp32:
        dut = Trainer(cfg.replace(dtype="float32"), TrainConfig(**kw),
                      params=p0, device="cuda", log_dir=log_dir,
                      use_wandb=False)
    else:
        dut = Trainer(cfg, TrainConfig(**kw, bf16_grads=True,
                                       precast_params=True),
                      params=p0, device="cuda", log_dir=log_dir,
                      use_wandb=False)
    g = torch.Generator().manual_seed(2)
    batch = {"x0": torch.randn((1, 2, cfg.inCh, lat, lat), generator=g),
             "text": torch.randn((1, 2, cfg.text_tokens, cfg.text_hidden_dim),
                                 generator=g),
             "pooled": torch.randn((1, 2, cfg.class_dim), generator=g)}
    noise = draw_noise(g, batch["x0"][0], ref.tcfg)
    noise = Noise(noise.t, noise.eps, torch.tensor([False, True]),
                  torch.tensor([True, False]), torch.tensor([False, False]))
    on_card = lambda tree: type(tree)(*(t.cuda() for t in tree))
    card_batch = dut.shard_batch(batch)
    t0 = time.time()
    want_g, want_m = ref.gradients(batch, [noise])
    cpu_s = time.time() - t0
    reset_launches()
    got_g, got_m = dut.gradients(card_batch, [on_card(noise)])
    torch.cuda.synchronize()
    launches = launch_counts()
    require(all(bool(torch.isfinite(t).all()) for t in got_g.values()),
            f"{label} training gradients non-finite on the card")
    ref.train_step(batch, [noise])
    dut.train_step(card_batch, [on_card(noise)])
    torch.cuda.synchronize()
    delta = lambda tr: {k: v.detach().float().cpu() - p0[k]
                        for k, v in tr.params.items()}
    res = dict(model=label, dtype="float32" if fp32 else cfg.dtype,
               head_dim=cfg.dim // cfg.num_heads,
               loss_card=got_m["loss"].item(),
               loss_cpu_fp32=want_m["loss"].item(),
               grad_rel_l2=_flat_rel_l2(got_g, want_g),
               update_rel_l2=_flat_rel_l2(delta(dut), delta(ref)),
               launches=launches, cpu_fp32_gradient_s=cpu_s)
    res["loss_rel"] = abs(res["loss_card"] / res["loss_cpu_fp32"] - 1)
    print("  train step", json.dumps(res), flush=True)
    nb = cfg.num_blocks
    sfx = "_fp32" if fp32 else ""
    other = "" if fp32 else "_fp32"
    for name, n in {f"flash_attention_fwd{sfx}": 2 * nb,
                    f"flash_attention_dq{sfx}": nb,
                    f"flash_attention_dkv{sfx}": nb,
                    f"flash_attention_fwd{other}": 0,
                    "fused_attention_bf16": 0}.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times "
                f"in a {label} training step with remat, expected {n}")
    limits = ((FP32_TRAIN_LOSS_REL, FP32_TRAIN_GRAD_REL_L2,
               FP32_TRAIN_UPDATE_REL_L2) if fp32 else
              (TRAIN_LOSS_REL, TRAIN_GRAD_REL_L2, TRAIN_UPDATE_REL_L2))
    require(res["loss_rel"] <= limits[0],
            f"{label} training loss {res['loss_card']} vs fp32 "
            f"{res['loss_cpu_fp32']} (limit {limits[0]} relative)")
    require(res["grad_rel_l2"] <= limits[1],
            f"{label} gradients rel L2 {res['grad_rel_l2']} > {limits[1]}")
    require(res["update_rel_l2"] <= limits[2],
            f"{label} update rel L2 {res['update_rel_l2']} > {limits[2]}")
    return res


def model_flops_per_forward(cfg, img_tokens: int) -> float:
    """Matmul FLOPs of one MMDiT forward, batch 1 (bench.py's model)."""
    s = img_tokens + cfg.text_tokens
    d, hd = cfg.dim, cfg.hidden_dim
    per_block = (2 * s * d * d * 4 + 2 * s * s * d * 2
                 + 2 * s * (d * 2 * hd + hd * d) + 2 * d * d * 7)
    embed = (2 * img_tokens * (cfg.inCh * cfg.patch_size ** 2) * d
             + 2 * img_tokens * d * d * 2)
    return cfg.num_blocks * per_block + embed


TRAIN_STEPS_TIMED = 5


def phase_train(card, log_dir):
    """The slice's training configuration through Trainer.train_step: the
    published 19-block model, 512px, batch 4, accumulation 1, fused low-mem
    AdamW, bf16 gradients, precast weights, remat of every block, no EMA.
    One warmup step, then the median of TRAIN_STEPS_TIMED timed steps, each
    launching K5 38, K6a 19, K6b 19 and K1-K4 0 times; then one more step
    under torch.profiler for the card time by kernel family."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.optim import global_norm_f32
    from sd3_torch.training.trainer import TrainConfig, Trainer

    cfg = published_config(stage_res=TRAIN_RES)
    tc = TrainConfig(batch_size=TRAIN_BATCH, accumulation_steps=1,
                     total_steps=10 ** 9, ema_update_freq=10 ** 9,
                     num_save_steps=10 ** 9, log_steps=10 ** 9,
                     low_mem_optimizer=True, track_ema=False,
                     remat_policy="nothing", bf16_grads=True,
                     bf16_grad_accum=True, precast_params=True,
                     fused_optimizer=True, remat_blocks=True)
    t0 = time.time()
    trainer = Trainer(cfg, tc, device="cuda", log_dir=log_dir, use_wandb=False)
    n_params = sum(p.numel() for p in trainer.params.values())
    batch = trainer.shard_batch(next(synthetic_batch_iter(
        cfg, TRAIN_BATCH, 1, TRAIN_RES, TRAIN_RES)))
    torch.cuda.synchronize()
    print(f"  trainer: {n_params / 1e6:.1f}M parameters, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    nb = cfg.num_blocks
    expect = dict(flash_attention_fwd=2 * nb, flash_attention_dq=nb,
                  flash_attention_dkv=nb, fused_attention_bf16=0,
                  fused_attention_int8qk=0,
                  **block_tail_launches(nb, 1, False, False))
    watch = trainer.params["blocks.0.attn.query_proj_x.weight"]
    w0 = watch.clone()

    def step():
        reset_launches()
        t0 = time.time()
        m = trainer.train_step(batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()  # synchronises
        dt = time.time() - t0
        launches = launch_counts()
        for name, n in expect.items():
            require(launches[name] == n, f"{name} launched {launches[name]} "
                    f"times in one training step, expected {n}")
        require(all(map(math.isfinite, (loss, gnorm))),
                f"training loss {loss} / grad norm {gnorm} non-finite")
        return dt, loss, gnorm, launches

    warm_s = step()[0]
    torch.cuda.reset_peak_memory_stats()
    runs = [step() for _ in range(TRAIN_STEPS_TIMED)]
    times = [r[0] for r in runs]
    med = statistics.median(times)
    require(not torch.equal(watch, w0), "training steps left the weights as "
            "they were")
    require(math.isfinite(global_norm_f32(trainer.params).item()),
            "weights non-finite after training")
    img_tokens = cfg.img_tokens(TRAIN_RES // 8, TRAIN_RES // 8)
    flops = model_flops_per_forward(cfg, img_tokens) * 3 * TRAIN_BATCH
    res = dict(batch=TRAIN_BATCH, res=TRAIN_RES, blocks=nb, warmup_s=warm_s,
               step_s=times, median_s_per_step=med,
               images_per_s=TRAIN_BATCH / med,
               bf16_peak_share=flops / med / PEAK_BF16_FLOPS,
               model_flops_per_step=flops, loss=[r[1] for r in runs],
               grad_norm=[r[2] for r in runs], launches_per_step=runs[-1][3],
               peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9, card=card,
               clocks_power=nvidia_smi("clocks.sm,power.draw,power.limit,"
                                       "temperature.gpu"))
    print("  train", json.dumps(res), flush=True)

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s = step()[0]
    tr = device_breakdown(prof, traced_s)
    tr["idle_share_untraced"] = 1 - tr["device_busy_ms"] / (med * 1e3)
    print("  trace", json.dumps(tr), flush=True)
    res["trace"] = tr
    return res


def phase_train_default_path(log_dir):
    """One step of TrainConfig's default path, the optax-shaped AdamW with
    an outer clip, fp32 gradients summed over 2 micro-batches and the
    device EMA, at the published widths and a depth of 2 blocks; two steps,
    since under warmup the first update is zero."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.trainer import TrainConfig, Trainer

    cfg = published_config(stage_res=TRAIN_RES).replace(num_blocks=2)
    tc = TrainConfig(batch_size=TRAIN_BATCH, accumulation_steps=2,
                     ema_update_freq=1)
    trainer = Trainer(cfg, tc, device="cuda", log_dir=log_dir, use_wandb=False)
    require(trainer.optimizer is not None and trainer.ema is not None,
            "the default TrainConfig should take the optax path with an EMA")
    batches = synthetic_batch_iter(cfg, TRAIN_BATCH, 2, TRAIN_RES, TRAIN_RES)
    p0 = {k: v.detach().clone() for k, v in trainer.params.items()}
    out = []
    for _ in range(2):
        batch = trainer.shard_batch(next(batches))
        reset_launches()
        m = trainer.train_step(batch)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        launches = launch_counts()
        nb = cfg.num_blocks
        for name, n in dict(flash_attention_fwd=2 * nb * 2,
                            flash_attention_dq=nb * 2,
                            flash_attention_dkv=nb * 2).items():
            require(launches[name] == n, f"{name} launched {launches[name]} "
                    f"times in one accumulation-2 step, expected {n}")
        require(all(map(math.isfinite, (loss, gnorm))),
                f"default-path loss {loss} / grad norm {gnorm} non-finite")
        out.append(dict(loss=loss, grad_norm=gnorm))
    moved = sum(int(not torch.equal(v, p0[k])) for k, v in trainer.params.items())
    ema_moved = sum(int(not torch.equal(v, p0[k])) for k, v in trainer.ema.items())
    require(moved > 0 and ema_moved > 0, "the default path's second step "
            "moved no weight or no EMA entry")
    res = dict(steps=out, launches_per_step=launches, leaves_moved=moved,
               ema_leaves_moved=ema_moved, leaves=len(p0))
    print("  default path", json.dumps(res), flush=True)
    return res


def launch_counts():
    """{kernel name: launches so far} of every registered kernel."""
    from sd3_torch import kernels
    return {k.name: k.launches for k in kernels.REGISTRY}


def reset_launches():
    from sd3_torch import kernels
    for k in kernels.REGISTRY:
        k.launches = 0


def block_tail_launches(nb: int, calls: int, int8: bool, tails: bool) -> dict:
    """Launches of the int8 block-tail kernels in `calls` forwards of an
    nb-block model: under int8, K2 in every block and K3 in every block but
    the last (whose text stream has no MLP), or with the tails (attn_tail
    "all", mlp_tail_fusion "3d") K9 for both streams and K10a, K10b once a
    block (the image stream: the text stream's 154 tokens decline them, and
    the last block has no text out-projection); none in bf16."""
    k2 = nb * calls if int8 and not tails else 0
    k3 = (nb - 1) * calls if int8 and not tails else 0
    k10 = nb * calls if tails else 0
    return dict(swiglu_int8_tail=k2, swiglu_int8=k3,
                swiglu_int8_tail3d=(2 * nb - 1) * calls if tails else 0,
                qkv_adaln_int8=k10, out_gate_residual_int8=k10)


TAILS = dict(attn_tail="all", mlp_tail_fusion="3d")


def phase_model(gen_seed, int8=False, res=512, batch=2, int8_pv=False,
                tails=False, fp32=False):
    """2-block published-width model at `res`, bf16 or int8 (w8a8, with
    int8_pv int8 P.V too, with `tails` the opt-in block tails), or with
    `fp32` the fp32 model (the fp32 attention instances), on the card vs the
    same weights in fp32 on the CPU."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.quant import quantize_model

    cfg = published_config(stage_res=res).replace(
        num_blocks=2, int8_pv=int8_pv, **(TAILS if tails else {}))
    ref = MMDiT(cfg.replace(dtype="float32"), device="cpu").init_weights(
        torch.Generator().manual_seed(gen_seed)).eval()
    if int8:
        quantize_model(ref)
        cfg = ref.cfg.replace(dtype=cfg.dtype)
    if fp32:
        cfg = cfg.replace(dtype="float32")
    dut = MMDiT(cfg, device="cuda")
    dut.load_state_dict(ref.state_dict(), strict=True)
    if not fp32:
        dut.cast_params(torch.bfloat16)
    dut.eval()
    g = torch.Generator().manual_seed(gen_seed + 1)
    lat = res // 8
    x = torch.randn((batch, cfg.inCh, lat, lat), generator=g)
    t = torch.rand((batch,), generator=g)
    c = torch.randn((batch, cfg.text_tokens, cfg.text_hidden_dim), generator=g)
    cp = torch.randn((batch, cfg.class_dim), generator=g)
    nulls = tuple(torch.tensor(m[:batch]) for m in (
        [False, True], [True, False], [False, True]))
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
    res_d = dict(quant=cfg.quant, dtype=cfg.dtype, int8_pv=int8_pv,
                 tails=tails, res=res, batch=batch, rel_l2=rel,
                 max_abs_err=(got - want).abs().max().item(),
                 ref_max_abs=want.abs().max().item(), launches=launches,
                 cpu_fp32_s=cpu_s)
    print("  model", json.dumps(res_d), flush=True)
    nb = cfg.num_blocks
    # attention: K1 / K4 up to 2048 padded tokens (512px: 1178 tokens pad
    # to 1280, K4 under int8), K7 / K8b above (1024px: 4250); int8: the
    # image-stream MLP K2, the text-stream MLP K3 in every block but the last
    streaming = res > 512
    attn = attention_kernel(int8, int8_pv, streaming, fp32)
    want_launches = {k: 0 for k in ATTENTION_KERNELS}
    want_launches[attn] = nb
    want_launches.update(block_tail_launches(nb, 1, int8, tails))
    for name, n in want_launches.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times "
                f"in a {nb}-block {cfg.quant} {cfg.dtype} {res}px forward, "
                f"expected {n}")
    limit = (INT8_MODEL_REL_L2 if int8 else FP32_MODEL_REL_L2 if fp32
             else MODEL_REL_L2)
    require(rel <= limit, f"2-block {cfg.quant} {res}px model rel L2 {rel} > "
            f"{limit}")
    return res_d


ATTENTION_KERNELS = ("fused_attention_bf16", "fused_attention_int8qk",
                     "fused_attention_int8pv", "fused_attention_stream",
                     "fused_attention_stream_int8qk",
                     "fused_attention_stream_int8pv", "fused_attention_fp32",
                     "fused_attention_stream_fp32")


def attention_kernel(int8, int8_pv, streaming, fp32=False) -> str:
    """The attention kernel a model forward launches once a block: K1 / K4
    up to 2048 padded tokens (K4 under int8), K7 / K8b above (K8b with
    int8_pv), as the JAX package's gates choose (int8 P.V only past 2048
    tokens, so no model path takes K8a); the fp32 instances in fp32."""
    if fp32:
        return "fused_attention_stream_fp32" if streaming else \
            "fused_attention_fp32"
    if streaming:
        return ("fused_attention_stream_int8pv" if int8_pv
                else "fused_attention_stream")
    return "fused_attention_int8qk" if int8 else "fused_attention_bf16"


def phase_sample(card, int8=False, res=512, int8_pv=False, timed=3,
                 tails=False):
    """Full-width sampling through the port's entry points: the bf16 model,
    or (int8) the same seeded weights quantized by quantize_model, with
    int8_pv int8 P.V in the streaming attention, with `tails` the opt-in
    block tails. One warmup call, `timed` timed calls, then one more under
    torch.profiler."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.inference.sampler import sample_imgs
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.models.text_encoders import StubTextEncoders
    from sd3_torch.ops.quant import quantize_model

    cfg = published_config(stage_res=res).replace(
        int8_pv=int8_pv, **(TAILS if tails else {}))
    batch, steps = 4, 20
    t0 = time.time()
    model = MMDiT(cfg, device="cuda", dtype=torch.bfloat16).init_weights(
        torch.Generator(device="cuda").manual_seed(0)).eval()
    if int8:
        quantize_model(model).cast_params(torch.bfloat16)
    n_params = sum(t.numel() for t in model.state_dict().values())
    enc = StubTextEncoders(device="cuda")
    torch.cuda.synchronize()
    label = (f"{model.cfg.quant}{' int8_pv' if int8_pv else ''}"
             f"{' tails' if tails else ''} {res}px")
    print(f"  {label} model: {n_params / 1e6:.1f}M weights, built in "
          f"{time.time() - t0:.1f} s", flush=True)
    nb = cfg.num_blocks
    # per sample call: one attention launch per block and step (K1 / K4 up
    # to 2048 padded tokens, K7 / K8b above), and the block-tail kernels of
    # block_tail_launches per step
    streaming = res > 512
    attn = attention_kernel(int8, int8_pv, streaming)
    expect = {k: 0 for k in ATTENTION_KERNELS}
    expect[attn] = nb * steps
    expect.update(block_tail_launches(nb, steps, int8, tails))
    bf16_prep = {"fused_attention_stream_int8pv": "K8b",
                 "fused_attention_stream": "K7"}.get(attn, "K1")

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
                    f"times in one {label} sample call, expected {n}")
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
    for _ in range(timed):
        t0 = time.time()
        imgs, launches = run(decode=True)
        times.append(time.time() - t0)
        require(bool(torch.isfinite(imgs).all()), "decoded images non-finite")
    med = statistics.median(times)
    res_d = dict(quant=model.cfg.quant, int8_pv=int8_pv, tails=tails,
                 batch=batch,
                 steps=steps, res=res, warmup_s=warm_s, run_s=times,
                 median_s_per_batch=med, images_per_s=batch / med,
                 launches_per_call=launches,
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
    tr = device_breakdown(prof, traced_s, bf16_prep)
    # kernels are not slowed by the trace: their sum against the untraced
    # median gives the untraced run's idle share
    tr["idle_share_untraced"] = 1 - tr["device_busy_ms"] / (med * 1e3)
    print("  trace", json.dumps(tr), flush=True)
    res_d["trace"] = tr
    return res_d


# the int8 kernels' launches carry the number of their TPU kernel as their
# last template argument (csrc/int8_common.cuh): xquant_kernel<2>,
# swiglu_h_sm90_kernel<256, 9>, w3_sm90_kernel<256, 9>, ...; K10a / K10b's as
# their first, dense_sm90_kernel<10, false> (the second: chunked or not)
INT8_LAUNCH = re.compile(r"(?:xquant_kernel|swiglu_h_sm90_kernel|"
                         r"w3_sm90_kernel)<(?:\d+, )*(\d+)>|"
                         r"dense_sm90_kernel<(\d+)")
INT8_FAMILIES = {"2": "K2", "3": "K3", "9": "K9", "10": "K10a", "11": "K10b"}
# attn_int8_sm90_kernel<D, QK8, PV8, TWO_PASS> instantiations by family
INT8_ATTN_FAMILIES = {"true, false, true>": "K4", "true, false, false>": "K7q",
                      "false, true, true>": "K8a", "true, true, true>": "K8a",
                      "false, true, false>": "K8b", "true, true, false>": "K8b"}
# the per-row int8 prep carries the number of its TPU kernel as its last
# template argument (csrc/attention_common.cuh): prep_q8rows_kernel<64, 4>
Q8ROWS_LAUNCH = re.compile(r"prep_q8rows_kernel<\d+, (\d+)>")
Q8ROWS_FAMILIES = {"4": "K4", "7": "K7q", "8": "K8b", "81": "K8a"}
# the fp32 attention kernels (csrc/attention_fp32.cu): K1 / K7 / K5 and
# K6a / K6b on fp32 operands
FP32_KERNELS = ("attn_fp32_kernel", "dq_fp32_kernel", "dkv_fp32_kernel")


# the flash backward's kernels (csrc/flash_bwd_sm90.cu) by family
FLASH_BWD_FAMILIES = {"flash_dq_sm90_kernel": "K6a",
                      "flash_dkv_sm90_kernel": "K6b"}
# the design of each kernel source, for the {"kernels"} line
SOURCE_DESIGNS = {"attention_sm90.cu": "wgmma+TMA, warp-specialised",
                  "flash_bwd_sm90.cu": "wgmma+TMA, warp-specialised",
                  "fused_mlp.cu": "wgmma+TMA, warp-specialised",
                  "attention_int8_sm90.cu": "wgmma+TMA, warp-specialised",
                  "attention_fp32.cu": "3xTF32 mma.sync, shared-memory tiles",
                  "fused_dense.cu": "wgmma+TMA, warp-specialised"}


def kernel_family(name: str, bf16_prep: str = "K1",
                  pv_prep: str = "K8b") -> str:
    """The family of one device row: the port's kernels by their CUDA
    function names (K2, K3, K9, K10a and K10b by the template tag of their
    launches, INT8_LAUNCH; K1, K7 and K5 are attn_sm90_kernel<D, Softmax::
    Bounded>, <D, Softmax::Online> and <D, Softmax::Flash>; K4, K7q, K8a and
    K8b the instances of attn_int8_sm90_kernel<D, QK8, PV8, TWO_PASS>,
    INT8_ATTN_FAMILIES, K4 with k_prep_kernel<D, true> and k_quant_kernel;
    the V prep of int8 P.V to `pv_prep` (K8a or K8b); the per-row int8
    preps by their tag, Q8ROWS_LAUNCH; the bf16 K prep k_prep_kernel<D,
    false>, which K1, K7, K8a and K8b share, and their bf16 q_prep_kernel
    go to `bf16_prep`; K6a and K6b FLASH_BWD_FAMILIES; the fp32 attention
    kernels to "fp32 attention"), int8 and other GEMMs, and the rest."""
    low = name.lower()
    for fn, fam in FLASH_BWD_FAMILIES.items():
        if fn in name:
            return fam
    if any(fn in name for fn in FP32_KERNELS):
        return "fp32 attention"
    if "attn_sm90_kernel" in name:
        return ("K5" if "Flash" in name else "K7" if "Online" in name
                else "K1")
    if "attn_int8_sm90_kernel" in name:
        return next((f for args, f in INT8_ATTN_FAMILIES.items()
                     if args in name), "other")
    if "v_amax_kernel" in name or "v_quant_kernel" in name:
        return pv_prep
    m = Q8ROWS_LAUNCH.search(name)
    if m:
        return Q8ROWS_FAMILIES[m.group(1)]
    if "k_quant_kernel" in name or re.search(r"k_prep_kernel<\d+, true", name):
        return "K4"
    if "k_prep_kernel" in name or "q_prep_kernel" in name:
        return bf16_prep
    m = INT8_LAUNCH.search(name)
    if m:
        return INT8_FAMILIES[m.group(1) or m.group(2)]
    if any(s in low for s in ("gemm", "nvjet", "cutlass", "xmma", "sm90_")):
        if any(s in low for s in ("s8", "i8", "int8", "imma")):
            return "gemm_int8"
        return "gemm"
    return "other"


def device_breakdown(prof, wall_s, bf16_prep="K1"):
    """Self device time (ms) by kernel family (see kernel_family); the top
    kernels; and the idle share of the traced wall time."""
    fams = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6a", "K6b", "K7",
                          "K7q", "K8a", "K8b", "K9", "K10a", "K10b",
                          "fp32 attention", "gemm_int8", "gemm", "other"),
                         0.0)
    rows = []
    for e in prof.key_averages():
        # device-side rows (kernels, copies, fills) only: they take no host
        # time. An operator's row repeats its kernels' device time.
        us = e.self_device_time_total
        if e.self_cpu_time_total > 0 or us <= 0:
            continue
        fams[kernel_family(e.key, bf16_prep)] += us
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
    logs = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
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
        from sd3_torch.ops import (  # register K1-K10b
            flash_attention, fused_attention, fused_dense, fused_mlp)
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
        k8a = [phase_attention(s, gen, int8_qk=qk, int8_pv=True)
               for qk in (False, True) for s in (SLICE, RAGGED)]
        k7 = [phase_attention(s, gen) for s in (SLICE_1024, RAGGED_STREAM)]
        k7q = [phase_attention(s, gen, int8_qk=True)
               for s in (SLICE_1024, RAGGED_STREAM)]
        k8b = [phase_attention(s, gen, int8_qk=qk, int8_pv=True)
               for qk in (False, True) for s in (SLICE_1024, RAGGED_STREAM)]
        api = phase_attention_api(gen)
        k3 = [phase_mlp(s, gen, "K3") for s in (K3_SLICE, K3_RAGGED)]
        k2 = [phase_mlp(s, gen, "K2") for s in (K2_SLICE, K2_RAGGED)]
        k9 = [phase_mlp(s, gen, "K9") for s in (K9_SLICE, K9_TEXT)]
        k10a = [phase_dense(s, gen, "K10a") for s in (K10_SLICE, K10_RAGGED)]
        k10b = [phase_dense(s, gen, "K10b") for s in (K10_SLICE, K10_RAGGED)]
        phase_dense(K10_SLICE, gen, "K10b", gated=False, residual=False)
        for s in K10_WIDE:
            phase_dense(s, gen, "K10a")
            phase_dense(s, gen, "K10b")
        k56 = [phase_flash(s, gen) for s in (FLASH_SLICE, FLASH_RAGGED)]
        phase_flash(FLASH_SLICE_1024, gen, check=FLASH_CHECK_1024)
        for s in FLASH_DIMS:
            phase_flash(s, gen)
        # the fp32 flash instances at the fp32 training step's shape, where
        # the main path launches them (B 2, H 19, N 410, D 64), at
        # tiny_config's head dim 16 and at a ragged shape
        from sd3_torch.config import tiny_config
        tiny = tiny_config(attn_type="softmax_flash", dtype="bfloat16")
        k56f = [phase_flash_fp32(s, gen) for s in (
            step_flash_shape(train_step_config(), TRAIN32_LAT),
            step_flash_shape(tiny, TINY_LAT), FLASH_RAGGED)]
        k1f = phase_attention_fp32(SLICE_FP32, gen)
        k7f = phase_attention_fp32(SLICE_1024, gen)
        phase_attention_fp32(RAGGED_STREAM, gen)
        phase_k1_backward(gen)

        print("phase 4: 2-block models on the card vs fp32 on the CPU: "
              "512px batch 2, 1024px batch 1", flush=True)
        phase_model(gen_seed=0)
        phase_model(gen_seed=0, int8=True)
        phase_model(gen_seed=0, int8=True, tails=True)
        phase_model(gen_seed=0, res=1024, batch=1)
        phase_model(gen_seed=0, int8=True, res=1024, batch=1)
        phase_model(gen_seed=0, int8=True, res=1024, batch=1, int8_pv=True)
        model32 = phase_model(gen_seed=0, fp32=True)
        # the trainers' metric logs, removed at exit
        log_dir = logs.name
        phase_train_step_2block(log_dir)
        step32 = phase_train_step_2block(log_dir, fp32=True)
        # tiny_config (head dim 16: the flash instances at D = 16)
        phase_train_step(log_dir, tiny, "tiny_config", lat=TINY_LAT)

        print("phase 5: 19-block bf16 sampling, 512px, batch 4, 20 Euler "
              "steps, CFG 5", flush=True)
        sample = phase_sample(card)

        print("phase 6: 19-block int8 sampling, the same", flush=True)
        sample8 = phase_sample(card, int8=True)

        print("phase 7: 19-block int8 sampling with the block tails "
              "(attn_tail all, mlp_tail_fusion 3d), the same", flush=True)
        sample8_tails = phase_sample(card, int8=True, tails=True)

        print("phase 8: 19-block bf16 sampling, 1024px, batch 4, 20 Euler "
              "steps, CFG 5", flush=True)
        sample_1024 = phase_sample(card, res=1024)

        print("phase 9: 19-block int8 sampling, 1024px, the same", flush=True)
        phase_sample(card, int8=True, res=1024)

        print("phase 10: 19-block int8 sampling with int8 P.V, 1024px, the "
              "same, one timed call", flush=True)
        sample8pv_1024 = phase_sample(card, int8=True, res=1024, int8_pv=True,
                                      timed=1)

        print("phase 11: 19-block training, 512px, batch 4, fused low-mem "
              "AdamW, bf16 grads, remat; then the default TrainConfig path "
              "at 2 blocks", flush=True)
        train = phase_train(card, log_dir)
        phase_train_default_path(log_dir)

        print("phase 12: kernels", flush=True)
        per_call = lambda run: run["launches_per_call"]
        per_step = lambda run: run["launches_per_step"]
        rows = [  # (kernel, phase-3 result at the slice shape, source,
                  #  TPU kernel it replaces, the run it launched in and how
                  #  that run counts launches)
            (fused_attention.K1, k1[0], "attention_sm90.cu",
             "sd3_tpu/ops/fused_attention.py:135", sample, per_call),
            (fused_mlp.K2, k2[0], "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:212", sample8, per_call),
            (fused_mlp.K3, k3[0], "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:93", sample8, per_call),
            (fused_attention.K4, k4[0], "attention_int8_sm90.cu",
             "sd3_tpu/ops/fused_attention.py:193", sample8, per_call),
            (flash_attention.K5, k56[0]["K5"], "attention_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:103", train, per_step),
            (flash_attention.K6A, k56[0]["K6a"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:191", train, per_step),
            (flash_attention.K6B, k56[0]["K6b"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:222", train, per_step),
            (fused_attention.K7, k7[0], "attention_sm90.cu",
             "sd3_tpu/ops/fused_attention.py:312", sample_1024, per_call),
            # K7q and K8a: the model never takes them (as in JAX); their
            # launches are those of the attention API phase
            (fused_attention.K7Q, k7q[0], "attention_int8_sm90.cu",
             "sd3_tpu/ops/fused_attention.py:352", api, lambda run: run),
            (fused_attention.K8A, k8a[0], "attention_int8_sm90.cu",
             "sd3_tpu/ops/fused_attention.py:181", api, lambda run: run),
            (fused_attention.K8B, k8b[0], "attention_int8_sm90.cu",
             "sd3_tpu/ops/fused_attention.py:406", sample8pv_1024, per_call),
            (fused_mlp.K9, k9[0], "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:365", sample8_tails, per_call),
            (fused_dense.K10A, k10a[0], "fused_dense.cu",
             "sd3_tpu/ops/fused_dense.py:92", sample8_tails, per_call),
            (fused_dense.K10B, k10b[0], "fused_dense.cu",
             "sd3_tpu/ops/fused_dense.py:166", sample8_tails, per_call),
            # the fp32 instances: K1F on the fp32 model (phase 4), K7F
            # through the attention API, K5F / K6AF / K6BF in the fp32
            # 2-block training step
            (fused_attention.K1F, k1f, "attention_fp32.cu",
             "sd3_tpu/ops/fused_attention.py:135", model32,
             lambda run: run["launches"]),
            (fused_attention.K7F, k7f, "attention_fp32.cu",
             "sd3_tpu/ops/fused_attention.py:312", api, lambda run: run),
            (flash_attention.K5F, k56f[0]["K5F"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:103", step32,
             lambda run: run["launches"]),
            (flash_attention.K6AF, k56f[0]["K6AF"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:191", step32,
             lambda run: run["launches"]),
            (flash_attention.K6BF, k56f[0]["K6BF"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:222", step32,
             lambda run: run["launches"]),
        ]
        line = {"kernels": [{
            "name": kern.name, "route": "cuda",
            "source": f"sd3_torch/csrc/{src}", "replaces": tpu,
            "launches": count(run)[kern.name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_term": r["bound_term"],
            "library_ms": r["library_ms"],
            **{k: r[k] for k in ("library_backend", "library_eager_ms")
               if k in r},
            "design": SOURCE_DESIGNS[src]}
            for kern, r, src, tpu, run, count in rows]}
    except SmokeFailure as e:
        print(f"FAIL: {e}", flush=True)
        return 1
    finally:
        logs.cleanup()
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
