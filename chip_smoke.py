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
     below the bf16 instance's error; the int8 kernels' fp32 instances
     (fp32 rows, fp32 out: K4F and K8aF at the fp32 int8 model's 512px
     shape, batch 1 doubled by CFG, K7qF and K8bF at the 1024px slice
     shape, K2F, K3F, K9F at that model's 512px streams, K10AF and K10BF
     there and at k 1600, K10BF bit for bit), and K8aF over K4F's scores
     on 32 draws of its own beside its plain version against itself an
     ulp away (k8af_study: the level noise its limit rests on) with a
     failing control; flash at head dims 256 and 160 (padded to 256: in
     bf16 K5_256, K6A_256, K6B_256, the wgmma kernels' instances at 256,
     with controls, dq and dk of the plain backward at twice the scale,
     that must fail the gradient limits, and K6A_256, K6B_256 with that
     control at phase 4b's shape, B 2, H 5, N 410), 384 and 512 (bf16:
     K5_384 / K6A_384 / K6B_384 and K5_512 / K6A_512 / K6B_512, the same
     kernels in two column slices, with the same controls; also at M != N,
     and K6A_384, K6B_384 at phase 4c's shape, B 2, H 3, N 410; the
     K6a / K6b instances at 256-512 the same bits twice), 640 (K5_768,
     K6A_768, K6B_768, the wgmma instances in four column slices, with the
     same controls, K6AW and K6BW timed beside them once), 1024 (K5_1024,
     K6A_1024, K6B_1024, the same way), the D = 768 / 1024 backward also
     at M != N and at phase 4d's shape (B 2, H 2, N 410, D 640) with the
     controls, 1152 (K5W, K6AW, K6BW past them) and fp32 at
     256-512 (K5WF, K6AWF, K6BWF), the bf16 forwards with a control (the
     plain version at twice the scale) that must fail its limit, then
     through the flash API, which counts their launches; the fused route
     past the dividers of 128: every fused kernel, bf16 and fp32, at head
     dims 48, 96, 192 (padded to 64, 128, 256), 256, 384, 512, 640, 768,
     1000, 1024 and 1152 at a small shape, each in its family's limit
     (bf16 at 192-1024: the wgmma kernels' D = 256, 384, 512, 768 and 1024
     instances, K1_256 .. K8B_1024; bf16 at 1152 and fp32 past 128 the
     wide instances K1W .. K8BW, K1WF .. K8BWF; every bf16 one past 128
     with a failing control), then those timed at the 512px joint length
     with five heads of 256 (K1_256 .. K8B_256 with controls, K1WF ..
     K8BWF; the streaming ones forced there), of 384 and 512 (K1_384 ..
     K8B_512, with controls), two of 640 and two of 1024 (K1_768 ..
     K8B_1024, with controls) and two of 1152 (K1W .. K8BW), their
     launches counted through the attention API.
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
     model at 512px (K1F), the fp32 int8 model (K4F, K2F, K3F) and with the
     tails (K4F, K9F, K10AF, K10BF), each also module by module: every
     attention and MLP module on the inputs the CPU model handed it, its
     increment within the kernels' limit, and the same check failed in
     every module by the bf16 int8 model and the unquantized fp32 model
     (controls); models of five heads of 256 (dim 1280, D256_MODEL), of
     three heads of 384 (dim 1152, D384_MODEL) and of two heads of 640
     (dim 1280, D640_MODEL) at 512px, batch 1, bf16 and int8 (K2, K3),
     their attention K5_256 / K5_384 / K5_768 (the general path: heads
     that do not divide 128; never K5W), each with a control (RoPE1d's
     tables on the same weights) that must fail; then
     one training step at 256px,
     batch 2 (loss,
     gradients and the update against fp32 on the CPU), in bf16 (K5, K6a,
     K6b) and in fp32 (K5F, K6AF, K6BF), and one of tiny_config in bf16
     (head dim 16: K5, K6a, K6b at D = 16); 4b. one of five heads of 256
     (D256_MODEL, 2 blocks, 256px, batch 2) in bf16 through K5_256,
     K6A_256 and K6B_256, with a control (RoPE1d's tables on the same
     weights on the CPU) whose gradients must miss the limit; 4c. one of
     three heads of 384 (D384_MODEL) through K5_384, K6A_384 and K6B_384,
     the same way; 4d. one of two heads of 640 (D640_MODEL) through
     K5_768, K6A_768 and K6B_768 (K6AW and K6BW launched 0 times), the
     same way;
  5. the published 19-block model with seeded random bf16 weights through
     sampler.sample_imgs: 512px, batch 4, 20 Euler steps, guidance 5, stub
     encoders and decode; one warmup, then one timed run; each sample call must launch K1 exactly 19 * 20 times; then one more call
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
     K7 0, K2 380, K3 360);
  11. training through Trainer.train_step with the slice's configuration
     (bench.py --train defaults: the 19-block model, 512px, batch 4, fused
     low-mem AdamW, bf16 gradients, precast weights, remat): one warmup,
     then the median of 3 timed steps, each launching K5 38, K6a 19, K6b 19
     and K1-K4 0 times; one more step under torch.profiler. The same
     configuration with 8-bit moments, and with the host EMA combined every
     step: one warmup, then the median of 2 timed steps each. Then two steps
     of the default TrainConfig path (optax-shaped AdamW, fp32 gradients,
     accumulation 2, device EMA) at a depth of 2 blocks;
  11b. phase 11's configuration over a ("dp", "fsdp", "tp") mesh of one
     NCCL rank (sd3_torch.parallel: multihost.initialize, the trainer's
     TrainMesh): the NCCL version, world and mesh; a warmup step and two
     timed ones (s a step; K5 38, K6a 19, K6b 19 each, as phase 11) and one
     traced (the idle share, the NCCL kernels' ms); each step's loss and
     grad norm and the update after the first and the last step against
     the trainer without a process group on the same seed, batch and
     noise, within MESH_LOSS_REL / MESH_UPDATE_REL_L2, and a control (the
     noise's rows rolled by one) that must fail them; the group destroyed;
  12. the slice's path through the CLIs (sd3_torch.training.train,
     sd3_torch.inference.infer): train.main at the published widths cut to
     CLI_BLOCKS (3) blocks, 256px, 2 steps, --moments_8bit --ema_on_host,
     writing the six artifacts under
     .chip_smoke_ckpt/ (free space checked in phase 1; removed at exit),
     reloaded and hash-compared with the trainer's tensors, with save and
     load seconds and GB/s; infer.main on the EMA at 512px in bf16 (K1),
     int8 (K2, K3, K4) and fp32 int8 with and without the block tails (the
     fp32 instances), each run's launches counted from 0; tiny_config:
     a bf16-moment run, an 8-bit resume from its artifact, and --gif;
  12b. the eval path on that checkpoint (sd3_torch/evals/): generate_images
     at 512px, 2 prompts x 4 images, batch 4, 4 Euler steps, stub encoders,
     in bf16 (K1 blocks x steps x calls), with --quant int8 (K2, K3, K4)
     and in bf16 from another --seed, the first batch of the first two
     under utils.profiling.trace, whose trace file must name those kernels;
     s per image of one untraced batch (a smoke timing at 3 blocks x 4
     steps, host-bound: not the cost of a published-model eval);
     calculate_fid score, on EVAL_FID_DIM-dimensional features, of int8
     against bf16 (the drift, within EVAL_FID_DRIFT) and of the other seed
     against bf16 (the control, past it);
  13. the frozen encoders and the FLUX VAE (sd3_torch/models/
     encoder_suite.py) at the published widths, random weights seeded and
     built on the card, token ids from a seed (no tokenizer): Gemma-2,
     ModernBERT (bf16) and CLIP (fp16) at 2 layers and the whole VAE (bf16;
     decoding 32 x 32 latents, encoding a 256px image) against the same
     weights in fp32 on the CPU, each with a control that must fail its
     limit (no causal mask, a swapped GeGLU, no mid attention); ms and peak
     memory at full depth (text_to_embedding from ids at batch 4,
     vae_decode at 64 x 64 and 128 x 128 latents and vae_encode at 512px,
     batch 4, with the operations counted by hooks and their bound); then
     phase 5's sampling through the suite in place of the stub (K1 380
     launches a call), with each call's share spent encoding and decoding;
  14. the data feed (sd3_torch/data/): a raw parquet folder written from a
     seed (150 images in three aspect families, two captions each, a
     low-resolution and an undecodable row a file) through filter_dataset
     -> create_phase (max 256) -> create_indices; HostDataLoader (2
     threads) and RingDataLoader (2 processes) alone, 30 batches of 8,
     their streams equal; train.main at the published widths (CLI_BLOCKS
     blocks) from the folder (stub encoders, batch 8, accumulation 2, 6
     steps, 2 ring workers, --remat_policy attn --scan_blocks): K5, K6a,
     K6b twice a block and step and K1-K4 none, two bucket shapes at least, the model artifact
     strict into an unrolled MMDiT; the ops each remat policy keeps in one
     block; one encoded group through Trainer.train_step under the four
     policies, unrolled and stacked (loss and grad norm within 1e-6 of each
     other, a control with one sample's noise changed outside it; K5 38 or
     19 a step), with step times, peaks and the card's busy ms; phase 11's
     configuration at 256px, batch 8, accumulation 2 fed by synthetic
     batches, by the encoded feed on threads and on ring workers (median s
     a step, idle share); vae_encode of the real-architecture FLUX VAE at
     each bucket, batch 8;
  15. a reference checkpoint of the old layout at the published widths
     (19 blocks, the absolute PE, swiglu_old; seeded weights) written as
     the reference writes it (a torch.save'd state_dict with its
     recomputed pos_enc.pos_embed, a params JSON without MLP_type), then
     infer.main --torch_ckpt --loadDefFile at 512px, batch 2, OLD_STEPS
     steps: bf16 (K1 19 a step) and --quant int8 (K2 19, K3 18, K4 19 a
     step), each call's launches and images/s;
  16. the model variants: RoPE1d (K1 with its tables), RoPE2dV2 and
     kv_merge_attn (K5, at M = N / 2), the eight other attention types and
     "both" (no kernel), and the old layout, each held at 2 blocks of the
     published widths (512px, batch 1) on the card in bf16 against fp32 on
     the CPU, with a control (a neighbouring variant of the same weights)
     that must fail the limit, then sampled at full depth (512px, batch
     2, VARIANT_STEPS Euler steps; s a call, the idle share); training:
     text_loss (weight 0.1), kv_merge (K5 / K6a / K6b at M = N / 2) and
     "both" under scan_blocks (the pair scan), each held at 2 blocks (3 for
     the pair scan) against fp32 on the CPU with a control, then 19 blocks
     at 256px, batch 4 with phase 11's flags (first loss, grad norm, s a
     step, launches, idle share); phase 3 holds K5, K6a, K6b, their fp32
     and wide instances at M != N (FLASH_KV, FLASH_KV_WIDE); then RoPE1d,
     NoPE and the absolute PE at 2 blocks through K7 (1024px bf16), K4
     (512px int8) and K8b (1024px int8 + int8_pv), and swiglu_old through
     K2 / K3 (1024px int8), each against fp32 on the CPU with the next
     variant's CPU result as its control; K7q through the attention API
     with RoPE1d's tables and with none, against its plain version;
  17. the golden config (tests/fixtures/golden_mid.npz, weights from the
     seeds of scripts/gen_golden.py): the CPU fp32 path at the JAX gate,
     then the card's bf16 (K1) and int8 (K1, K2, K3) sampling against the
     same latents and, tighter, against the plain versions' sampling in
     bf16 on the CPU (the same weights and noise), each with a control
     that must fail (block 7 scaled);
  18. one JSON line {"kernels": [...]} per ported kernel (with its design:
     wgmma + TMA warp-specialised, or for the fp32 instances 3xTF32
     mma.sync over shared-memory tiles), then the card's name and power
     limit, then the last line
     {"ok": true, "device": {...}}.
Needs one CUDA card, nvcc (CUDA_HOME, PATH or /usr/local/cuda) and the
sd3_torch package beside this file.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import math
import os
import re
import shutil
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
# (fa.stream_key_tile: K7's fa.K7_KEY_TILE, at head dim 256
# fa.K7_KEY_TILE_256; K7q's fa.K7Q_KEY_TILE): K1's roundings (bf16 q^, k^
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
# The fp32 instances of the int8 kernels (K4F, K7qF, K8aF, K8bF; K2F, K3F,
# K9F; K10AF, K10BF) on fp32 rows against their plain versions on the same
# rows in fp32 (TF32 off): the same int8 levels but for the odd value an ulp
# from a rounding boundary (exp2f, the sums of the preps, the LayerNorms and
# the dequantization in another order), each moving an output by a level's
# share, and the attentions' fp32 products in 3xTF32 (~1e-6). Attention:
# max abs error 1e-2 x max |plain|, rel L2 2e-3 (the card tests measured
# under 1e-4 at their shapes); the MLP and projections: MLP_MAX_REL and
# MLP_REL_L2, and K10BF bit for bit (it repeats its plain version's
# arithmetic in its order, as K10b does).
INT8_FP32_MAX_REL, INT8_FP32_REL_L2 = 1e-2, 2e-3
# K8aF over K4F's scores (int8 QK^T and int8 P.V on fp32 rows) against its
# plain version: max abs error 2.4e-2 x max |plain| (it was
# INT8_FP32_MAX_REL, 1e-2, which undercounts the level noise of two int8
# roundings in series). Measured on an H100 (k8af_study, 40 seeds at
# SLICE_FP32): the plain version against itself on q, k, v moved by one
# ulp (torch.nextafter) gives 0.574-1.565e-2 of max |plain| (median
# 9.75e-3; rel L2 2.37-4.21e-4): one ulp moves the odd K4 score level, and
# each moved score moves that key's p by a level's share of the row max
# on top of p's own int8 level. The kernel against the plain version lies
# inside that spread: 0.415-1.513e-2 (median 7.36e-3; rel L2 1.25-3.14e-4).
# So the limit is the plain version's own maximum over the seeds, 1.565e-2,
# times a margin of 1.5; the control, the plain version at twice the
# softmax scale, misses it by 35x (0.839-0.976). Over fp32 scores (K8aF
# alone) the same study gives 1.80-5.14e-3 against 1.50-3.97e-3, under
# INT8_FP32_MAX_REL, which stays its limit.
K8AF_OVER_K4F_MAX_REL = 2.4e-2
# seeds of the K8aF level study (k8af_study): K8aF against its plain
# version beside the plain version against itself an ulp away
K8AF_SEEDS = range(1000, 1040)
K8AF_STUDY_SEEDS = 32  # of them, what phase 3d runs
# The 2-block fp32 int8 model on the card against the same int8 weights in
# fp32 on the CPU. Its output cannot tell a right model from a wrong one:
# the plain ops around the kernels differ between the two devices by an ulp
# or so, which moves the odd int8 level of the next quantizer; each moved
# level moves the next layer's inputs by more, so the moves cascade through
# the ~14 quantizers a block until the output differs by about the int8
# effect itself (on an H100: 1.1e-2, where the bf16 int8 model gives 1.9e-2
# and the unquantized fp32 model 1.75e-2; PERF.md section 6). So the output
# is held only to INT8_MODEL_REL_L2, and the model is held module by
# module: every attention and MLP module of the card model is run on the
# inputs that the CPU model handed the same module, and its increment (its
# output less the residual it adds to) is held to the CPU's within
# INT8_FP32_MODULE_REL_L2. With the CPU's inputs only the module's own
# quantizers (three in series at most) can move a level, on an ulp's
# difference, so a module comes within the kernels' own limit against
# their plain versions. Two controls run through the same check and must
# fail it in every module: the bf16 int8 model (inputs rounded to bf16 move
# a few per cent of the levels, a full level each, about half the int8
# effect) and the unquantized fp32 model (the int8 effect).
INT8_FP32_MODULE_REL_L2 = INT8_FP32_REL_L2
FP32_TRAIN_LOSS_REL = 1e-5
FP32_TRAIN_GRAD_REL_L2 = 1e-4
FP32_TRAIN_UPDATE_REL_L2 = 1e-2
# H100 SXM peaks (NVIDIA data sheet): dense bf16 and int8 tensor-core rates
# and HBM3.
# The frozen encoders and the VAE (phase 13) on the card in their serving
# dtypes (Gemma-2, ModernBERT, VAE bf16; CLIP fp16) against the same weights
# in fp32 on the CPU, rel L2. Text towers at 2 layers: one rounding to bf16
# is 2^-9 = 2e-3 relative, and the CPU's bf16 towers sit at 4.5e-3 of fp32
# (calibration with PyTorch's initialisation); 1e-2 leaves 2x. The VAE:
# some 60 convs deep, each rounding to bf16, 1.4e-2 (decode) and 1.7e-2
# (encode) on the CPU; 3e-2 leaves 2x. Each limit has a control that must
# fail it: Gemma-2 and CLIP without the causal mask (2.1e-2 and 5.4e-2
# from the intact fp32 tower on the CPU), ModernBERT with its GeGLU's input
# and gate swapped (0.12), the VAE without its mid attention (encode 0.23).
TEXT_REL_L2 = 1e-2
VAE_REL_L2 = 3e-2

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
# head dims past 128, at the 512px token count and a width near the
# published one: 256 (K5_256 / K6A_256 / K6B_256 in bf16, K5WF / K6AWF /
# K6BWF in fp32), 160, which runs padded to 256, 384 and 512 (K5_384 /
# K6A_384 / K6B_384, K5_512 / K6A_512 / K6B_512 in bf16)
FLASH_WIDE = [(4, 5, 1178, 256), (4, 8, 1178, 160), (4, 3, 1178, 384),
              (4, 2, 1178, 512)]
# past 512: 640, drawn from a generator of its own (wide_gen) with the D =
# 384 / 512 instances at M != N (M = N / 2, M > N), so that the shapes
# before them see the inputs they saw
FLASH_PAST_512 = (2, 2, 1178, 640)
# since the bf16 flash kernels past 512 have wgmma instances at 768 and
# 1024, 640 runs K5_768, K6A_768, K6B_768; two heads of 1024 run K5_1024,
# K6A_1024, K6B_1024, and of 1152, past them, K5W, K6AW, K6BW
FLASH_1024 = (2, 2, 1178, 1024)
FLASH_PAST_1024 = (2, 2, 1178, 1152)
FLASH_KV_SLICED = [(2, 3, 410, 205, 384), (2, 3, 129, 300, 512)]
# the D = 768 / 1024 backward at M != N: the 256px kv_merge shape with two
# heads of 640 (M = N / 2) and M > N at 1000 (run at 1024), on draws of
# their own
FLASH_KV_PAST_512 = [(2, 2, 410, 205, 640), (2, 2, 129, 300, 1000)]
# k and v with a key length M of their own, as kv_merge_attn's pairwise
# merge makes them: (B, H, N, M, D) at the 512px and 256px kv_merge training
# shapes (M = N / 2), a ragged M against a whole N, and M > N; the
# instances at head dim 256 (bf16: K5_256, K6A_256, K6B_256; fp32: the wide
# ones) with M = N / 2 and M > N
FLASH_KV = [(4, 19, 1178, 589, 64), (4, 19, 410, 205, 64),
            (2, 3, 256, 77, 64), (2, 3, 129, 300, 64)]
FLASH_KV_WIDE = [(2, 3, 410, 205, 256), (2, 3, 129, 300, 256)]
# the fused route at head dims JAX's fused attention takes with one head a
# lane block: 48, 96 and 192 padded to the 64, 128 and 256 instances, 256,
# 384 and 512 on the wgmma instances there, 640 on the wide mma.sync ones
# (every multiple of 128 past 512); every kernel, bf16 and fp32, checked at
# WIDE_CHECK's small shape (512 and 640 from a generator of their own), and
# the wide instances timed at SLICE_WIDE (the 512px joint sequence, batch 2,
# five heads of 256: about the published width) and, for the streaming
# ones, forced past their single-KV length there
WIDE_DIMS = (48, 96, 192, 256, 384)
# past 384: 512; 640 and 768 on the D = 768 instances, 1000 and 1024 on the
# D = 1024 ones, and past them 1152 on the wide mma.sync ones
WIDE_DIMS_PAST_384 = (512, 640, 768, 1000, 1024, 1152)
WIDE_CHECK = dict(b=2, h=8, w=9, n_txt=20, heads=2, rope=True)
SLICE_WIDE = dict(b=2, h=32, w=32, n_txt=154, heads=5, d=256, rope=True)
# the bf16 wgmma instances past 256 (D = 384, 512: two column slices) and
# the mma.sync wide instances past 512 (two heads of 640), timed at the
# same length; their inputs come from generators of their own
# (wide_gen), so that the checks that were there before them see the
# inputs they saw
SLICE_WIDE_384 = dict(SLICE_WIDE, d=384)
SLICE_WIDE_512 = dict(SLICE_WIDE, d=512)
SLICE_WIDE_640 = dict(SLICE_WIDE, d=640, heads=2)
# the bf16 wgmma instances past 512 (D = 768, 1024: four column slices, a
# pair a CTA): two heads of 640 (run at 768) and two of 1024; and past
# 1024 the mma.sync wide instances, two heads of 1152
SLICE_WIDE_1024 = dict(SLICE_WIDE, d=1024, heads=2)
SLICE_WIDE_1152 = dict(SLICE_WIDE, d=1152, heads=2)
# the models of five heads of 256 (dim 1280) and of three heads of 384 (dim
# 1152) that phase 4 holds to the CPU
D256_MODEL = dict(dim=1280, num_heads=5)
D384_MODEL = dict(dim=1152, num_heads=3)
# and of two heads of 640 (dim 1280), whose attention runs K5_768
D640_MODEL = dict(dim=1280, num_heads=2)
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
# the fp32 int8 instances at the shapes of the run that launches them, the
# fp32 int8 512px model at CFG batch 2 (infer --dtype float32 --quant int8
# at batch 1): K4F and K8aF at SLICE_FP32, the MLP and projections here
K3_FP32 = dict(K3_SLICE, m=2 * 154, n_tok=2 * 154)
K2_FP32 = dict(K2_SLICE, m=2 * 1024)
K9_FP32 = [dict(s, m=2 * s["n_tok"]) for s in (K9_SLICE, K9_TEXT)]
K10_FP32 = dict(K10_SLICE, b=2)
# The train CLI runs (phases 12 and 14) take the published widths at a
# depth of CLI_BLOCKS blocks: the first and the last block's layouts and a
# scan of two; their checkpoints hold 0.19B values a tree (~2.3 GB each).
# Phase 15's reference checkpoint of 19 blocks takes 5.3 GB. The directory
# needs this much free space, and is removed at exit
CKPT_DIR = ".chip_smoke_ckpt"
CKPT_DISK_BYTES = 8e9
CLI_BLOCKS = 3
CLI_STEPS = 2   # sampling steps of each infer CLI call at the published size


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


def device_rows(prof) -> dict:
    """{name: [device us, count]} of a finished trace's device-side events
    (kernels, copies, fills), read from the profiler's raw results:
    key_averages() first builds every event's tree in Python, about 0.1 ms
    an event, seconds for a sampling call's 50-85k launches."""
    from torch.autograd import DeviceType
    rows = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            row = rows.setdefault(e.name(), [0.0, 0])
            row[0] += e.duration_ns() / 1e3
            row[1] += 1
    return rows


def device_ms(run, iters=3) -> float:
    """The card's busy time of one run() call: the device time of every
    launch in `iters` calls under torch.profiler, over iters (the rest of
    an eager call's time is the host's)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            run()
        torch.cuda.synchronize()
    return sum(us for us, _ in device_rows(prof).values()) / (1e3 * iters)


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
    return {name_of(key): round(us / n, 2)
            for key, (us, n) in device_rows(prof).items() if us > 0}


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


def launched_once(run) -> str:
    """The name of the one kernel a run() call launches (the route taken)."""
    import torch
    before = launch_counts()
    run()
    torch.cuda.synchronize()
    after = launch_counts()
    moved = [nm for nm in after if after[nm] != before[nm]]
    require(len(moved) == 1 and after[moved[0]] - before[moved[0]] == 1,
            f"one call launched {moved}, expected one kernel once")
    return moved[0]


def phase_attention(shape, gen, int8_qk=False, int8_pv=False,
                    streaming=None, control=False):
    """One fused-attention kernel (K1; K4 with int8_qk; K8a with int8_pv; K7,
    K7q, K8b above 2048 padded tokens, or at any length with `streaming`)
    vs its plain version at one shape; with `control` also against the
    plain version at twice the softmax scale, which must miss the limit;
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
    if streaming is None:
        streaming = -(-n // 128) * 128 > fa.SINGLE_KV_MAX
    kv_max = 0 if streaming else 1 << 30
    name = ATTN_NAMES[(int8_qk, int8_pv, streaming)]
    if streaming:
        plain = (fa.composition_stream_int8_qk if int8_qk
                 else fa.composition_stream)
    else:
        plain = fa.composition_int8_qk if int8_qk else fa.composition
    # the plain versions take int8_pv where they have it; the streaming ones
    # are compared over the kernel's key tiles (fa.stream_key_tile: 128, K7
    # at head dim 256 64), timed with JAX's blocks
    kw = dict(int8_pv=True) if int8_pv else {}
    tile = fa.stream_key_tile(int8_qk, int8_pv, d)
    cmp_kw = dict(kw, block_k=tile) if streaming else kw
    run_k = lambda: fa.fused_attention(q, k, v, nh, *tables, scale,
                                       int8_qk=int8_qk, int8_pv=int8_pv,
                                       single_kv_max=kv_max)
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
               f"{'RoPE2d' if shape['rope'] else 'NoPE'}"
               f"{' streaming' if streaming and n <= 2048 else ''}",
               kernel=launched_once(run_k),
               max_abs_err=err, max_rel_err=rel, plain_bf16_max_abs_err=plain_err,
               kernel_vs_plain_bf16_max_abs_err=(
                   got.float() - same_rounding.float()).abs().max().item(),
               ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
               library_ms=library_ms,
               **bound(t_ops, t_bytes, t_exp))
    if name in ("K4", "K8a", "K8a over K4", "K7q", "K8b", "K8b over K7q"):
        # the device time of each launch: q prep, K prep / quantize, V amax
        # / quantize, attention
        res["us_per_launch"] = per_launch_us(run_k)
    atol = (K8_ATOL if int8_pv else K4_ATOL if int8_qk and not streaming
            else ATTN_ATOL)
    if control:
        res["control_max_abs_err"] = (got.float() - plain(
            q.float(), k.float(), v.float(), *tables, 2 * scale, eps, eps, nh,
            **cmp_kw)).abs().max().item()
    print(f"  {name}", json.dumps(res), flush=True)
    require(err <= atol, f"{name} max abs err {err} > {atol} at {res['shape']}")
    require(not control or res["control_max_abs_err"] > atol,
            f"{name}: the control (twice the scale) passes at {res['shape']}: "
            f"{res.get('control_max_abs_err')} <= {atol}")
    same = res["kernel_vs_plain_bf16_max_abs_err"]
    require(not (int8_qk or int8_pv) or same <= INT8_SAME_ROUNDING_ATOL,
            f"{name} max abs err {same} against the plain version's own "
            f"roundings > {INT8_SAME_ROUNDING_ATOL} at {res['shape']}")
    return res


def wide_gen(d=384):
    """The generator of SLICE_WIDE_384's (512's, 640's) inputs, apart from
    phase 3's."""
    import torch
    return torch.Generator(device="cuda").manual_seed(d)


def phase_attention_api(gen):
    """The public entry point `fused_dual_flash_attention` once per kernel,
    at the 512px and 1024px slice shapes, in bf16 and in fp32 (K1F / K7F,
    and the int8 kernels' fp32 instances):
    the int8 QK^T branch above 2048 tokens (K7q) and int8 P.V at or below it
    (K8a) are reached only this way (the model gates them off, as the JAX
    package does). Launch counts reset before, read after; returns them."""
    import torch
    from sd3_torch.ops import fused_attention as fa

    calls = []
    for shape in (SLICE, SLICE_1024, SLICE_WIDE, dict(SLICE_WIDE, h=64, w=64),
                  SLICE_WIDE_384, dict(SLICE_WIDE_384, h=64, w=64),
                  SLICE_WIDE_512, dict(SLICE_WIDE_512, h=64, w=64),
                  SLICE_WIDE_640, dict(SLICE_WIDE_640, h=64, w=64),
                  SLICE_WIDE_1024, dict(SLICE_WIDE_1024, h=64, w=64),
                  SLICE_WIDE_1152, dict(SLICE_WIDE_1152, h=64, w=64)):
        q, k, v, ws, angles, n_img, _ = attn_inputs(
            shape, gen if shape["d"] <= 256 else wide_gen(shape["d"]))
        for int8_qk, int8_pv in ((False, False), (True, False), (False, True),
                                 (True, True)):
            calls.append((q, k, v, ws, angles, n_img, shape, int8_qk,
                          int8_pv))
        if shape["d"] > 256:  # fp32 past 128: the same instances as at 256
            continue
        for int8_qk, int8_pv in ((False, False), (True, False), (False, True),
                                 (True, True)):
            calls.append((q.float(), k.float(), v.float(), ws, angles, n_img,
                          shape, int8_qk, int8_pv))
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
                fused_attention_stream_fp32=1,
                fused_attention_int8qk_fp32=1, fused_attention_int8pv_fp32=2,
                fused_attention_stream_int8qk_fp32=1,
                fused_attention_stream_int8pv_fp32=2)
    # past head dim 128 (SLICE_WIDE, and at 64 x 64 past 2048 tokens) the
    # same calls take in bf16 the wgmma kernels' D = 256 instances, in fp32
    # the wide instances; at 384 and 512 the bf16 wgmma instances there, at
    # 640 the D = 768 ones, at 1024 the D = 1024 ones, at 1152 the bf16
    # wide ones
    want.update({f"{nm}{sfx}": c for nm, c in list(want.items())
                 if not nm.endswith("_fp32")
                 for sfx in ("_256", "_384", "_512", "_768", "_1024", "_wide",
                             "_wide_fp32")})
    for nm, c in want.items():
        require(launches[nm] == c, f"{nm} launched {launches[nm]} times "
                f"through the attention API, expected {c}")
    return launches


def phase_attention_dims(gen, dims=WIDE_DIMS):
    """Every fused kernel (K1, K7, K4, K7q, K8a over both scores, K8b over
    both) in bf16 and fp32 at each of `dims`, at WIDE_CHECK's shape,
    against its plain version on the same inputs, in its family's limits:
    bf16 ATTN_ATOL (float scores and P.V), K4_ATOL / K8_ATOL (int8 scores
    or P.V); fp32 FP32_REL_L2, INT8_FP32_MAX_REL / INT8_FP32_REL_L2. The
    streaming kernels forced by single_kv_max=0 and compared over their
    key tiles (fa.stream_key_tile; fp32: 128). bf16 at 192, 256, 384 and
    512 (the wgmma instances past 128) also against the plain version at
    twice the scale, a control that must miss the limit, as at every bf16
    head dim past 128 (768, 1024 and the wide 1152 too). Returns the worst
    error of each (kernel, head dim)."""
    import torch
    from sd3_torch.ops import fused_attention as fa

    worst = {}
    for d in dims:
        shape = dict(WIDE_CHECK, d=d)
        qb, kb, vb, _, _, _, tables = attn_inputs(shape, gen)
        nh = shape["heads"]
        for dt in (torch.bfloat16, torch.float32):
            q, k, v = (t.to(dt) for t in (qb, kb, vb))
            eps = float(torch.finfo(dt).eps)
            for (int8_qk, int8_pv, streaming), nm in ATTN_NAMES.items():
                got = fa.fused_attention(q, k, v, nh, *tables, d ** -0.5,
                                         int8_qk=int8_qk, int8_pv=int8_pv,
                                         single_kv_max=0 if streaming
                                         else 1 << 30)
                if streaming:
                    plain = (fa.composition_stream_int8_qk if int8_qk
                             else fa.composition_stream)
                    kw = dict(block_k=fa.K8B_KEY_TILE if dt == torch.float32
                              else fa.stream_key_tile(int8_qk, int8_pv, d))
                else:
                    plain = (fa.composition_int8_qk if int8_qk
                             else fa.composition)
                    kw = {}
                if int8_pv:
                    kw["int8_pv"] = True
                want = plain(q.float(), k.float(), v.float(), *tables,
                             d ** -0.5, eps, eps, nh, **kw)
                require(got.dtype == dt and bool(torch.isfinite(got).all()),
                        f"{nm} at head dim {d} {dt}: bad output")
                label = f"{nm}{' fp32' if dt == torch.float32 else ''} D={d}"
                if dt == torch.bfloat16:
                    err = (got.float() - want).abs().max().item()
                    lim = K8_ATOL if int8_pv else (
                        K4_ATOL if int8_qk else ATTN_ATOL)
                    require(err <= lim, f"{label}: max abs err {err} > {lim}")
                    if fa.instance_dim(d) > fa.HEAD_DIMS[-1]:
                        ctl = (got.float() - plain(
                            q.float(), k.float(), v.float(), *tables,
                            2 * d ** -0.5, eps, eps, nh, **kw)).abs().max()
                        worst[label + " control"] = ctl.item()
                        require(ctl.item() > lim, f"{label}: the control "
                                f"(twice the scale) passes: {ctl.item()}")
                elif int8_qk or int8_pv:
                    e = _errs(got, want)
                    err = e["rel_l2"]
                    require(e["max_rel_err"] <= INT8_FP32_MAX_REL
                            and err <= INT8_FP32_REL_L2,
                            f"{label}: {e} past INT8_FP32 limits")
                else:
                    err = _rel_l2(got, want)
                    require(err <= FP32_REL_L2,
                            f"{label}: rel L2 {err} > {FP32_REL_L2}")
                worst[label] = err
    print("  fused attention by head dim (bf16: max abs err; fp32: rel L2)",
          json.dumps(worst), flush=True)
    return worst


def phase_mlp(shape, gen, kind, fp32=False):
    """K2, K3 or K9 (`kind`) vs the plain version at one shape; with `fp32`
    their fp32 instances (K2F, K3F, K9F) on fp32 rows and conditioning."""
    import torch
    from sd3_torch.ops import fused_mlp as fm
    from sd3_torch.ops.quant import int_mm, quantize_weight

    name, tail = kind + ("F" if fp32 else ""), kind != "K3"
    act = torch.float32 if fp32 else torch.bfloat16
    m, n_tok, k, hidden = shape["m"], shape["n_tok"], shape["k"], shape["hidden"]
    h_group = (fm.pick_blocks(n_tok, hidden)[1] if kind == "K9"
               else shape["h_group"])
    b = m // n_tok
    dev = "cuda"
    rnd = lambda *sz, sd=1.0: torch.randn(sz, generator=gen, device=dev) * sd
    x = rnd(m, k).to(act)
    w12_q, s12 = quantize_weight(rnd(2 * hidden, k, sd=k ** -0.5))
    w3_q, s3 = quantize_weight(rnd(k, hidden, sd=hidden ** -0.5))
    # biases and conditioning in x's dtype, as the model's cast leaves them
    # (so K9's rounding of the conditioning to x's dtype changes nothing)
    b12, b3 = (rnd(n, sd=0.1).to(act) for n in (2 * hidden, k))
    shift, scale = (rnd(b, k, sd=0.3).to(act) for _ in range(2))
    gate = rnd(b, k, sd=0.5).to(act)
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
    nbytes = (sum(t.numel() * t.element_size() for t in ins)
              + m * k * x.element_size())
    t_ops, t_bytes = ops / PEAK_INT8_OPS, nbytes / PEAK_BYTES
    res = dict(shape=f"M={m} n_tok={n_tok} K={k} hidden={hidden} "
               f"h_group={h_group}{' fp32' if fp32 else ''}", max_abs_err=err, max_rel_err=rel,
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


def phase_dense(shape, gen, name, gated=True, residual=True, fp32=False):
    """K10a (AdaLN + int8 q/k/v) or K10b (int8 out-projection [* gate]
    [+ residual], `name`) vs its plain version at one shape; K10b reads the
    image half of a joint sequence in place, as the model hands it over.
    With `fp32` their fp32 instances (K10AF, K10BF) on fp32 activations.
    The library yardstick is torch._int_mm of the activations quantized
    beforehand against the three weights (K10a) or the one (K10b): the
    GEMMs alone, which the port never calls in these kernels' place."""
    import torch
    from sd3_torch.ops import fused_dense as fd
    from sd3_torch.ops.quant import int_mm, quantize_rows, quantize_weight

    b, n, k, d = shape["b"], shape["n"], shape["k"], shape["d_out"]
    bf = torch.float32 if fp32 else torch.bfloat16
    row = name + ("F" if fp32 else "")
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
        act, ins = x, (x, shift, scale, *ws)
        out_bytes = 3 * b * n * d * x.element_size()
        label = f"B={b} N={n} K={k} N_out={d} x3"
    else:
        joint = rnd(b, n + shape["n_txt"], k).to(bf)
        x = joint[:, :n]                      # a strided view, not a copy
        gate = (step - 1 + rnd(b, d, sd=0.5)).to(bf) if gated else None
        res = rnd(b, n, d).to(bf) if residual else None
        run_k = lambda: fd.out_gate_residual_int8(x, gate, res, *ws)
        plain = lambda t: fd.out_gate_residual_int8_plain(
            t, gate, None if res is None else res.to(t.dtype), *ws)
        act, ins = x, (x, gate, res, *ws)
        out_bytes = b * n * d * x.element_size()
        label = (f"B={b} N={n} (of {n + shape['n_txt']}) K={k} N_out={d}"
                 f"{' gate' if gated else ''}{' residual' if residual else ''}")
    label += " fp32" if fp32 else ""
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
    print(f"  {row}", json.dumps(res_d), flush=True)
    require(e["max_rel_err"] <= K10_MAX_REL and e["rel_l2"] <= K10_REL_L2,
            f"{name} max err {e['max_rel_err']} x max|plain| (limit "
            f"{K10_MAX_REL}), rel L2 {e['rel_l2']} (limit {K10_REL_L2}) at "
            f"{label}")
    require(same_l2 <= K10_SAME_ROUNDING_REL_L2,
            f"{name} rel L2 {same_l2} against the plain version's own "
            f"roundings (limit {K10_SAME_ROUNDING_REL_L2}) at {label}")
    # K10b repeats its plain version's arithmetic on the same values: the
    # same bits
    require(name != "K10b" or torch.equal(got, same),
            f"{row} differs from its plain version's bits at {label}")
    return res_d


def _errs(got, want) -> dict:
    """Max abs error, max abs error / max |want| and relative L2 of got
    against want."""
    d = got.float() - want.float()
    err = d.abs().max().item()
    return dict(max_abs_err=err, max_rel_err=err / want.abs().max().item(),
                rel_l2=(d.norm() / want.norm()).item())


# MATH is timed only for the head dims and dtypes that FLASH_ATTENTION and
# CUDNN_ATTENTION refuse (where either ran, it beat MATH at every shape of
# phase 3)
SDPA_BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION",
                 "MATH")


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
        if name == "MATH" and any(isinstance(by.get(n), float) for n in (
                "FLASH_ATTENTION", "CUDNN_ATTENTION")):
            by[name] = "not timed: FLASH_ATTENTION or CUDNN_ATTENTION ran"
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


def flash_dims(shape) -> tuple:
    """(B, H, N, M, D) of a flash shape (B, H, N, D) or (B, H, N, M, D): M
    keys against N queries (kv_merge_attn's M = N / 2), M = N by default."""
    if len(shape) == 4:
        b, h, n, d = shape
        return b, h, n, n, d
    return tuple(shape)


def flash_inputs(shape, gen, dtype):
    """q, k, v, dO of a flash shape: q, dO (B, H, N, D), k, v (B, H, M,
    D), drawn in that order."""
    import torch
    b, h, n, m, d = flash_dims(shape)
    return [torch.randn((b, h, rows, d), generator=gen, device="cuda")
            .to(dtype) for rows in (n, m, m, n)]


def flash_label(shape, suffix="") -> str:
    b, h, n, m, d = flash_dims(shape)
    return f"B={b} H={h} N={n}{f' M={m}' if m != n else ''} D={d}{suffix}"


def wide_backward(kern, q, k, v, out, do, lse, delta, scale):
    """K6AW (dq, delta) or K6BW (dk, dv), the mma.sync backward of
    attention_fp32.cu, launched at the inputs' own head dim, a multiple of
    128, whichever instance the bf16 route takes there: a yardstick for
    the wgmma instances past 512, timed beside them."""
    import torch
    from sd3_torch.ops import flash_attention as fl

    b, h, n, d = q.shape
    m = k.shape[2]
    if kern is fl.K6AW:
        dq = fl._bnhd(q.shape, q)
        fl._launch(kern, (q, k, v, out, do, lse, torch.empty_like(lse), dq),
                   (q, k, v, out, do, dq), b, h, n, m, d, scale)
    else:
        dk, dv = fl._bnhd(k.shape, k), fl._bnhd(k.shape, k)
        fl._launch(kern, (q, k, v, do, lse, delta, dk, dv),
                   (q, k, v, do, dk, dv), b, h, n, m, d, scale)


def phase_flash(shape, gen, check=None, control=False, grad_control=False,
                beside=False):
    """K5, K6a and K6b vs their fp32 plain versions at one (B, H, N, D)
    shape, or (B, H, N, M, D) with k and v of M keys, on the samples and
    heads [:check[0], :check[1]] where `check` is given (the plain versions'
    fp32 score matrices at the 1024px training shape take 5.5 GB each); with
    `control` K5's output also against the plain forward at twice the
    scale, which must miss FLASH_OUT_ATOL, and with `grad_control` dq and dk
    against the plain backward at twice the scale, which must miss the
    FLASH_GRAD limits; the kernels, the plain versions and SDPA timed at the
    full shape (SDPA's backward by sdpa_backward_ms), with `beside` (bf16
    past 512) the mma.sync K6AW / K6BW too (wide_backward; mma_sync_ms);
    returns {"K5" | "K6a" | "K6b": measurements}."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import flash_attention as fl

    b, h, n, m, d = flash_dims(shape)
    scale = d ** -0.5
    q, k, v, do = flash_inputs(shape, gen, torch.bfloat16)
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
    label = flash_label(shape)

    # library yardsticks, never called by the port: SDPA's forward, and its
    # backward (dq, dk, dv together) on the card alone
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    lib_bwd = sdpa_backward_ms(q, k, v, do, scale)
    print("  SDPA backward", json.dumps(dict(shape=label, **lib_bwd)),
          flush=True)
    bwd_lib = dict(library_ms=lib_bwd["ms"],
                   library_backend=lib_bwd["backend"],
                   library_eager_ms=lib_bwd["eager_ms"])
    # bytes: a bf16 tensor of N rows (q, out, dO, dq) and of M (k, v, dk,
    # dv), lse / delta
    one_n, one_m, stat = b * h * n * d * 2, b * h * m * d * 2, b * h * n * 4
    bh_nmd = b * h * n * m * d
    # each kernel takes exp2 of every score once (K6a, K6b recompute p)
    t_exp = 1.0 * b * h * n * m / PEAK_EXP2
    runs = dict(  # kernel, plain version, products of 2*B*H*N*M*D, bytes,
                  # library figures
        K5=(lambda: fl.flash_fwd(q, k, v, scale),
            lambda: fl.flash_fwd_plain(q, k, v, scale), 2,
            2 * one_n + 2 * one_m + stat, dict(library_ms=cuda_ms(sdpa))),
        K6a=(lambda: fl.flash_dq(q, k, v, out, do, lse, scale),
             lambda: fl.flash_dq_plain(q, k, v, out, do, lse, scale), 3,
             4 * one_n + 2 * one_m + 2 * stat, bwd_lib),
        K6b=(lambda: fl.flash_dkv(q, k, v, do, lse, delta, scale),
             lambda: fl.flash_dkv_plain(q, k, v, do, lse, delta, scale), 4,
             2 * one_n + 4 * one_m + 2 * stat, bwd_lib))
    results = {}
    for name, (run, plain, products, nbytes, lib) in runs.items():
        t_ops = products * 2 * bh_nmd / PEAK_BF16_FLOPS
        t_bytes = nbytes / PEAK_BYTES
        res = dict(shape=label, kernel=launched_once(run),
                   checked=(f"[:{check[0]}, :{check[1]}]"
                            if check else "all"),
                   errors=errs[name],
                   max_abs_err=max(e["max_abs_err"] for k, e in
                                   errs[name].items() if k not in ("lse",
                                                                   "delta")),
                   ms=cuda_ms(run), eager_ms=cuda_ms(run, graph=False),
                   plain_ms=cuda_ms(plain, iters=3, groups=3), **lib,
                   **bound(t_ops, t_bytes, t_exp))
        if beside and name != "K5":
            wide = fl.K6AW if name == "K6a" else fl.K6BW
            res["mma_sync_ms"] = cuda_ms(lambda: wide_backward(
                wide, q, k, v, out, do, lse, delta, scale))
        print(f"  {name}", json.dumps(res), flush=True)
        results[name] = res
    out_err = errs["K5"]["out"]["max_abs_err"]
    require(out_err <= FLASH_OUT_ATOL,
            f"K5 out max abs err {out_err} > {FLASH_OUT_ATOL} at {shape}")
    if control:
        ctl = (cut(out).float() - fl.flash_fwd_plain(
            qf, kf, vf, 2 * scale)[0]).abs().max().item()
        results["K5"]["control_max_abs_err"] = ctl
        print("  K5 control (twice the scale)", json.dumps(dict(
            shape=label, max_abs_err=ctl)), flush=True)
        require(ctl > FLASH_OUT_ATOL, f"K5's control passes at {shape}: "
                f"{ctl} <= {FLASH_OUT_ATOL}")
    lse_err = errs["K5"]["lse"]["max_abs_err"]
    require(lse_err <= FLASH_LSE_ATOL,
            f"K5 lse max abs err {lse_err} > {FLASH_LSE_ATOL} at {shape}")
    grad_ok = lambda e: (e["max_rel_err"] <= FLASH_GRAD_MAX_REL
                         and e["rel_l2"] <= FLASH_GRAD_REL_L2)
    for name, key in (("K6a", "dq"), ("K6b", "dk"), ("K6b", "dv")):
        e = errs[name][key]
        require(grad_ok(e),
                f"{name} {key}: max err {e['max_rel_err']} of max|plain| "
                f"(limit {FLASH_GRAD_MAX_REL}), rel L2 {e['rel_l2']} (limit "
                f"{FLASH_GRAD_REL_L2}) at {shape}")
    if grad_control:
        # the plain backward at twice the scale on the kernels' inputs
        c_dq, c_delta = fl.flash_dq_plain(qf, kf, vf, w_out, dof, w_lse,
                                          2 * scale)
        c_dk, _ = fl.flash_dkv_plain(qf, kf, vf, dof, w_lse, c_delta,
                                     2 * scale)
        for name, key, got, ctl in (("K6a", "dq", dq, c_dq),
                                    ("K6b", "dk", dk, c_dk)):
            e = _errs(cut(got), ctl)
            results[name][f"control_{key}"] = e
            print(f"  {name} control ({key}, twice the scale)", json.dumps(
                dict(shape=label, **e)), flush=True)
            require(not grad_ok(e), f"{name}'s control passes at {shape}: "
                    f"{key} {e}")
    if fl.flash_kernel("dq", q.dtype, d) in fl._WGMMA["dq"].values():
        # the wgmma backward past 128 sums each output element in one
        # order, with no atomics: the same inputs give the same bits twice
        dq2, delta2 = fl.flash_dq(q, k, v, out, do, lse, scale)
        dk2, dv2 = fl.flash_dkv(q, k, v, do, lse, delta2, scale)
        same = all(torch.equal(x, y) for x, y in (
            (dq, dq2), (delta, delta2), (dk, dk2), (dv, dv2)))
        results["K6a"]["same_bits_twice"] = same
        results["K6b"]["same_bits_twice"] = same
        print("  K6a / K6b twice", json.dumps(dict(shape=label,
                                                    same_bits=same)),
              flush=True)
        require(same, f"K6a / K6b: two runs differ at {shape}")
    return results


def phase_flash_fp32(shape, gen):
    """K5F, K6AF and K6BF (the fp32 instances) vs their plain versions in
    fp32 on the card (TF32 off) at one (B, H, N, D) or (B, H, N, M, D)
    shape: rel L2 within FP32_REL_L2, and FP32_OVER_BF16 times below the
    bf16 instances' error at the same shape; kernel, plain-version and SDPA
    (fp32) times."""
    import torch
    import torch.nn.functional as F
    from sd3_torch.ops import flash_attention as fl

    b, h, n, m, d = flash_dims(shape)
    scale = d ** -0.5
    # fp32 values that bf16 does not hold, so the bf16 instance's error
    # includes its inputs' rounding
    q, k, v, do = flash_inputs(shape, gen, torch.float32)
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
    label = flash_label(shape, " fp32")
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, scale=scale)
    lib_bwd = sdpa_backward_ms(q, k, v, do, scale)
    bwd_lib = dict(library_ms=lib_bwd["ms"], library_backend=lib_bwd["backend"],
                   library_eager_ms=lib_bwd["eager_ms"])
    one_n, one_m, stat = b * h * n * d * 4, b * h * m * d * 4, b * h * n * 4
    bh_nmd = b * h * n * m * d
    t_exp = 1.0 * b * h * n * m / PEAK_EXP2
    runs = dict(
        K5F=(lambda: fl.flash_fwd(q, k, v, scale),
             lambda: fl.flash_fwd_plain(q, k, v, scale), 2,
             2 * one_n + 2 * one_m + stat, dict(library_ms=cuda_ms(sdpa))),
        K6AF=(lambda: fl.flash_dq(q, k, v, out, do, lse, scale),
              lambda: fl.flash_dq_plain(q, k, v, out, do, lse, scale), 3,
              4 * one_n + 2 * one_m + 2 * stat, bwd_lib),
        K6BF=(lambda: fl.flash_dkv(q, k, v, do, lse, delta, scale),
              lambda: fl.flash_dkv_plain(q, k, v, do, lse, delta, scale), 4,
              2 * one_n + 4 * one_m + 2 * stat, bwd_lib))
    results = {}
    for name, (run, plain, products, nbytes, lib) in runs.items():
        e = max(errs[name].values())
        res = dict(shape=label, rel_l2=errs[name], bf16_rel_l2=bf16[name],
                   max_abs_err=max((g - w).abs().max().item() for g, w in {
                       "K5F": [(out, w_out)], "K6AF": [(dq, w_dq)],
                       "K6BF": [(dk, w_dk), (dv, w_dv)]}[name]),
                   ms=cuda_ms(run), plain_ms=cuda_ms(plain, iters=3, groups=3),
                   **lib, **bound(products * 2 * bh_nmd / PEAK_FP32_FLOPS,
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


def phase_attention_fp32(shape, gen, streaming=None):
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
    if streaming is None:
        streaming = -(-n // 128) * 128 > fa.SINGLE_KV_MAX
    kv_max = 0 if streaming else 1 << 30
    name = "K7F" if streaming else "K1F"
    eps32 = float(torch.finfo(torch.float32).eps)
    eps16 = float(torch.finfo(torch.bfloat16).eps)
    run_k = lambda: fa.fused_attention(q, k, v, nh, *tables, scale,
                                       single_kv_max=kv_max)
    plain = fa.composition_stream if streaming else fa.composition
    run_plain = lambda: plain(q, k, v, *tables, scale, eps32, eps32, nh)
    got = run_k()
    bf = fa.fused_attention(*(t.bfloat16() for t in (q, k, v)), nh, *tables,
                            scale, single_kv_max=kv_max)
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


def phase_attention_int8_fp32(shape, gen, int8_qk=False, int8_pv=False,
                              streaming=None):
    """The fp32 instance of an int8 attention kernel (K4F, K8aF up to 2048
    padded tokens; K7qF, K8bF above) on fp32 q, k, v against its plain
    version in fp32 on the card (TF32 off; the streaming ones over the
    kernel's 128-key blocks): INT8_FP32_MAX_REL (K8aF over K4F's scores:
    K8AF_OVER_K4F_MAX_REL) and INT8_FP32_REL_L2; kernel, plain-version and
    SDPA (fp32) times."""
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
    if streaming is None:
        streaming = -(-n // 128) * 128 > fa.SINGLE_KV_MAX
    kv_max = 0 if streaming else 1 << 30
    name = ATTN_NAMES[(int8_qk, int8_pv, streaming)] + " fp32"
    eps = float(torch.finfo(torch.float32).eps)
    if streaming:
        plain = (fa.composition_stream_int8_qk if int8_qk
                 else fa.composition_stream)
    else:
        plain = fa.composition_int8_qk if int8_qk else fa.composition
    kw = dict(int8_pv=True) if int8_pv else {}
    cmp_kw = dict(kw, block_k=fa.K8B_KEY_TILE) if streaming else kw
    run_k = lambda: fa.fused_attention(q, k, v, nh, *tables, scale,
                                       int8_qk=int8_qk, int8_pv=int8_pv,
                                       single_kv_max=kv_max)
    run_plain = lambda: plain(q, k, v, *tables, scale, eps, eps, nh, **kw)
    got = run_k()
    torch.cuda.synchronize()
    require(got.dtype == torch.float32 and bool(torch.isfinite(got).all()),
            f"{name}: output {got.dtype}, or non-finite, at {shape}")
    want = plain(q, k, v, *tables, scale, eps, eps, nh, **cmp_kw)
    e = _errs(got, want)

    def heads(x):
        return x.reshape(b, n, nh, d).transpose(1, 2).contiguous()

    cq, sq, ck, sk = tables
    qh, kh, vh = (prep_for_sdpa(heads(q), cq, sq, eps),
                  prep_for_sdpa(heads(k), ck, sk, eps), heads(v))
    run_lib = lambda: F.scaled_dot_product_attention(qh, kh, vh, scale=scale)
    # QK^T and P.V, 2*B*H*N^2*D each: int8 where the kernel's product is,
    # else fp32-accurate (3xTF32); one exp2 per score
    prod = 2.0 * b * nh * n * n * d
    rate = lambda int8: PEAK_INT8_OPS if int8 else PEAK_FP32_FLOPS
    nbytes = 4.0 * b * n * nh * d * 4 + 4.0 * n * d * 4
    # K8aF over K4F's scores: the limit of the level study (k8af_study)
    max_rel = (K8AF_OVER_K4F_MAX_REL if int8_qk and int8_pv and not streaming
               else INT8_FP32_MAX_REL)
    res = dict(shape=f"B={b} N={n} H={nh} D={d} fp32", **e,
               ms=cuda_ms(run_k), plain_ms=cuda_ms(run_plain, iters=3,
                                                   groups=3),
               library_ms=cuda_ms(run_lib), us_per_launch=per_launch_us(run_k),
               **bound(prod / rate(int8_qk) + prod / rate(int8_pv),
                       nbytes / PEAK_BYTES, 1.0 * b * nh * n * n / PEAK_EXP2))
    print(f"  {name}", json.dumps(res), flush=True)
    require(e["max_rel_err"] <= max_rel and e["rel_l2"] <= INT8_FP32_REL_L2,
            f"{name} max err {e['max_rel_err']} x max|plain| (limit "
            f"{max_rel}), rel L2 {e['rel_l2']} (limit "
            f"{INT8_FP32_REL_L2}) at {res['shape']}")
    return res


def k8af_study(seeds=K8AF_SEEDS, int8_qk=True):
    """K8aF (K8a's body on fp32 rows, over K4F's scores with int8_qk)
    against its plain version at SLICE_FP32 on `seeds` draws of the inputs
    phase_attention_int8_fp32 makes (each seed a generator of its own),
    beside the plain version against itself on the same inputs moved by one
    ulp (torch.nextafter towards +inf on q, k and v), and the control (the
    plain version at twice the softmax scale). Returns, per seed and over
    the seeds, max abs error / max |plain| and rel L2 of each; fails if the
    kernel misses its limits (K8AF_OVER_K4F_MAX_REL with int8_qk, else
    INT8_FP32_MAX_REL; INT8_FP32_REL_L2) on a seed or a control meets
    them."""
    import torch
    from sd3_torch.ops import fused_attention as fa

    shape = SLICE_FP32
    nh, d = shape["heads"], shape["d"]
    scale = d ** -0.5
    eps = float(torch.finfo(torch.float32).eps)
    plain = fa.composition_int8_qk if int8_qk else fa.composition
    rows = []
    for seed in seeds:
        gen = torch.Generator(device="cuda").manual_seed(seed)
        qb, kb, vb, _, _, _, tables = attn_inputs(shape, gen)
        q, k, v = (t.float() + 1e-3 * torch.randn(t.shape, generator=gen,
                                                  device="cuda")
                   for t in (qb, kb, vb))
        got = fa.fused_attention(q, k, v, nh, *tables, scale, int8_qk=int8_qk,
                                 int8_pv=True, single_kv_max=1 << 30)
        want = plain(q, k, v, *tables, scale, eps, eps, nh, int8_pv=True)
        up = [torch.nextafter(t, torch.full_like(t, math.inf))
              for t in (q, k, v)]
        moved = plain(*up, *tables, scale, eps, eps, nh, int8_pv=True)
        ctl = plain(q, k, v, *tables, 2 * scale, eps, eps, nh, int8_pv=True)
        torch.cuda.synchronize()
        rows.append(dict(seed=seed, kernel=_errs(got, want),
                         plain_moved=_errs(moved, want),
                         control=_errs(got, ctl)))
    out = {}
    for key in ("kernel", "plain_moved", "control"):
        for m in ("max_rel_err", "rel_l2"):
            vals = sorted(r[key][m] for r in rows)
            out[f"{key} {m}"] = dict(
                min=vals[0], median=statistics.median(vals), max=vals[-1])
    res = dict(shape=f"B={shape['b']} H={nh} D={d} "
               f"{'K8a over K4 fp32' if int8_qk else 'K8a fp32'}",
               seeds=len(rows), summary=out, per_seed=[
                   dict(seed=r["seed"],
                        kernel=[r["kernel"]["max_rel_err"],
                                r["kernel"]["rel_l2"]],
                        plain_moved=[r["plain_moved"]["max_rel_err"],
                                     r["plain_moved"]["rel_l2"]])
                   for r in rows])
    print("  K8aF level study", json.dumps(res), flush=True)
    lim = K8AF_OVER_K4F_MAX_REL if int8_qk else INT8_FP32_MAX_REL
    require(out["kernel max_rel_err"]["max"] <= lim
            and out["kernel rel_l2"]["max"] <= INT8_FP32_REL_L2,
            f"{res['shape']}: {out['kernel max_rel_err']} of max |plain| "
            f"(limit {lim}), rel L2 {out['kernel rel_l2']} (limit "
            f"{INT8_FP32_REL_L2}) over {len(rows)} seeds")
    require(out["control max_rel_err"]["min"] > lim,
            f"{res['shape']}: the control (twice the scale) passes: "
            f"{out['control max_rel_err']} <= {lim}")
    return res


def phase_flash_api(gen, gen_past):
    """The flash-attention entry point (the autograd Function: forward and
    backward) at FLASH_WIDE's head dims (gen's draws) and FLASH_PAST_512's,
    FLASH_1024's and FLASH_PAST_1024's (gen_past's), in bf16 and fp32, the path of a model of such heads (the
    repo's configs have none but phase 4's): launch counts reset before,
    read after; each wide kernel must launch; returns them."""
    import torch
    from sd3_torch.ops import flash_attention as fl

    cases = []
    for shape, g in [(s, gen) for s in FLASH_WIDE] + [
            (s, gen_past) for s in (FLASH_PAST_512, FLASH_1024,
                                    FLASH_PAST_1024)]:
        for dt in (torch.bfloat16, torch.float32):
            q, k, v, do = (torch.randn(shape, generator=g, device="cuda")
                           .to(dt) for _ in range(4))
            cases.append((q, k, v, do))
    torch.cuda.synchronize()
    reset_launches()
    for q, k, v, do in cases:
        qr, kr, vr = (t.requires_grad_() for t in (q, k, v))
        out = fl.flash_attention(qr, kr, vr, q.shape[-1] ** -0.5)
        grads = torch.autograd.grad(out, (qr, kr, vr), do)
        require(all(bool(torch.isfinite(g).all()) and g.shape == q.shape
                    for g in (out, *grads)),
                f"flash_attention at {tuple(q.shape)} {q.dtype}: bad output")
    torch.cuda.synchronize()
    launches = launch_counts()
    print("  flash API", json.dumps(
        {n: c for n, c in launches.items() if c}), flush=True)
    # bf16 up to 512: K5_256 .. K5_512, K6A_256 .. K6B_512; past it K5_768,
    # K5_1024 (K5W past 1024), K6AW, K6BW; fp32 past 128: the wide instances
    shapes = [*FLASH_WIDE, FLASH_PAST_512, FLASH_1024, FLASH_PAST_1024]
    want = dict.fromkeys((*(k for ks in fl._WGMMA.values()
                            for k in ks.values()),
                          fl.K5W, fl.K6AW, fl.K6BW), 0)
    for s in shapes:
        for which in ("fwd", "dq", "dkv"):
            want[fl.flash_kernel(which, torch.bfloat16, s[-1])] += 1
    want.update(dict.fromkeys((fl.K5WF, fl.K6AWF, fl.K6BWF), len(shapes)))
    for kern, n in want.items():
        require(launches[kern.name] == n,
                f"{kern.name} launched {launches[kern.name]} times through "
                f"the flash API, expected {n}")
    return launches


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


def phase_train_step(log_dir, cfg, label, lat, fp32=False, control=None):
    """One training step of `cfg` (latents lat x lat, batch 2) on the card
    against the same weights and noise in fp32 on the CPU (plain path):
    in bf16 with the slice's flags (bf16 gradients against bf16 weight
    copies; K5, K6a, K6b, or their instances at the head dim) or, with
    `fp32`, all in fp32 (K5F, K6AF, K6BF). With `control` (config fields),
    the gradients of that config on the same weights in fp32 on the CPU
    must miss the gradient limit."""
    import torch
    from sd3_torch.ops import flash_attention as fl
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
    on_card = lambda noise: noise.to("cuda")
    card_batch = dut.shard_batch(batch)
    t0 = time.time()
    want_g, want_m = ref.gradients(batch, [noise])
    cpu_s = time.time() - t0
    if control:
        ctl = Trainer(cfg.replace(dtype="float32", **control),
                      TrainConfig(**kw), device="cpu", log_dir=log_dir,
                      use_wandb=False)
        _load_loose(ctl.model, p0)
        ctl_g, _ = ctl.gradients(batch, [noise])
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
    if control:
        res["control"] = control
        res["control_grad_rel_l2"] = _flat_rel_l2(got_g, {
            k: ctl_g[k] for k in want_g if k in ctl_g})
    print("  train step", json.dumps(res), flush=True)
    # the flash kernels of the head dim and dtype: the forward twice a block
    # (remat), dq and dk / dv once; no other flash or fused attention kernel
    nb, hd = cfg.num_blocks, cfg.dim // cfg.num_heads
    dtype = torch.float32 if fp32 else torch.bfloat16
    want = {n: 0 for n in launches if n.startswith("flash_attention_")}
    want.update({fl.flash_kernel("fwd", dtype, hd).name: 2 * nb,
                 fl.flash_kernel("dq", dtype, hd).name: nb,
                 fl.flash_kernel("dkv", dtype, hd).name: nb,
                 "fused_attention_bf16": 0})
    for name, n in want.items():
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
    if control:
        require(res["control_grad_rel_l2"] > limits[1], f"{label}: the "
                f"control {control} passes the gradient check "
                f"({res['control_grad_rel_l2']})")
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


TRAIN_STEPS_TIMED = 3
TRAIN_OPTION_STEPS = 2


def phase_train(card, log_dir):
    """The slice's training configuration through Trainer.train_step: the
    published 19-block model, 512px, batch 4, accumulation 1, fused low-mem
    AdamW, bf16 gradients, precast weights, remat of every block, no EMA.
    One warmup step, then the median of TRAIN_STEPS_TIMED timed steps, each
    launching K5 38, K6a 19, K6b 19 and K1-K4 0 times; then one more step
    under torch.profiler for the card time by kernel family."""
    import torch
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.optim import global_norm_f32
    from sd3_torch.training.trainer import Trainer

    cfg, tc = train_slice_config()
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        traced_s = step()[0]
    tr = device_breakdown(prof, traced_s)
    tr["idle_share_untraced"] = 1 - tr["device_busy_ms"] / (med * 1e3)
    print("  trace", json.dumps(tr), flush=True)
    res["trace"] = tr
    return res


def train_slice_config():
    """(model config, TrainConfig) of phase 11's training configuration."""
    from sd3_torch.config import published_config
    from sd3_torch.training.trainer import TrainConfig

    return published_config(stage_res=TRAIN_RES), TrainConfig(
        batch_size=TRAIN_BATCH, accumulation_steps=1, total_steps=10 ** 9,
        ema_update_freq=10 ** 9, num_save_steps=10 ** 9, log_steps=10 ** 9,
        low_mem_optimizer=True, track_ema=False, remat_policy="nothing",
        bf16_grads=True, bf16_grad_accum=True, precast_params=True,
        fused_optimizer=True, remat_blocks=True)


def phase_train_options(card, log_dir):
    """The two options that shape a checkpoint, each alone on phase 11's
    training configuration: 8-bit moments (adamw_8bit in place of the fused
    low-mem AdamW), and the host EMA combined every step (ema_on_host with
    ema_update_freq 1, its dearest setting: a step joins the last step's
    combine). One warmup step, then the median of TRAIN_OPTION_STEPS timed
    steps of each."""
    import dataclasses
    import torch
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.trainer import Trainer

    cfg, tc = train_slice_config()
    out = {}
    for label, opts in (
            ("moments_8bit", dict(moments_8bit=True)),
            ("ema_on_host_every_step", dict(track_ema=True, ema_on_host=True,
                                            ema_update_freq=1))):
        torch.cuda.empty_cache()
        t0 = time.time()
        trainer = Trainer(cfg, dataclasses.replace(tc, **opts), device="cuda",
                          log_dir=log_dir, use_wandb=False)
        build_s = time.time() - t0
        batch = trainer.shard_batch(next(synthetic_batch_iter(
            cfg, TRAIN_BATCH, 1, TRAIN_RES, TRAIN_RES)))

        def step():
            t0 = time.time()
            loss = trainer.train_step(batch)["loss"].item()  # synchronises
            require(math.isfinite(loss), f"{label}: training loss {loss}")
            return time.time() - t0

        warm_s = step()
        times = [step() for _ in range(TRAIN_OPTION_STEPS)]
        trainer.ema_state()  # joins the last host combine
        out[label] = dict(build_s=build_s, warmup_s=warm_s, step_s=times,
                          median_s_per_step=statistics.median(times))
        del trainer, batch
    out["card"] = card
    print("  train options", json.dumps(out), flush=True)
    return out


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


# ---- phase 11b: the mesh ---------------------------------------------------
# Phase 11's configuration over a ("dp", "fsdp", "tp") mesh of one NCCL rank
# (the card is one H100, and NCCL takes one rank per card): the sharding
# code and the collectives of a multi-card run (the gradients averaged over
# the data group, the metrics reduced over it, the clip's norm summed over
# the world), held step by step to the trainer without a process group on
# the same seed, batch and noise. Limits: each step's loss and grad norm to
# MESH_LOSS_REL relative; the update (gathered masters minus the initial
# ones) after the first and the last step to MESH_UPDATE_REL_L2 (a gradient
# within bf16's reach of Adam's eps may flip its first update, as in
# tests/test_torch_parallel.py). The control, the first step with each
# micro-batch's draws rolled by one row (what a rank keeping another rank's
# rows would train on), must fail both.
MESH_STEPS = 3            # a warmup step and two timed ones
MESH_LOSS_REL = 1e-4
MESH_UPDATE_REL_L2 = 1e-2


def free_port() -> int:
    """A free TCP port on localhost (the process group's rendezvous)."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_train_mesh(card, log_dir):
    """Phase 11b (see the note above): returns the run's numbers, errors
    and control."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.parallel import MeshConfig, multihost
    from sd3_torch.training.trainer import Noise, Trainer, draw_noise

    cfg, tc = train_slice_config()
    batch = {k: torch.as_tensor(v).cuda() for k, v in next(
        synthetic_batch_iter(cfg, TRAIN_BATCH, 1, TRAIN_RES, TRAIN_RES)).items()}
    gen = torch.Generator(device="cuda").manual_seed(11)
    noises = [[draw_noise(gen, batch["x0"][0], tc)]
              for _ in range(MESH_STEPS + 1)]
    nb = cfg.num_blocks
    expect = dict(flash_attention_fwd=2 * nb, flash_attention_dq=nb,
                  flash_attention_dkv=nb)
    snap_at = (0, MESH_STEPS - 1)

    t0 = time.time()
    dev = multihost.initialize(f"localhost:{free_port()}", 1, 0,
                               device="cuda", timeout_s=300)
    trainer = None
    try:
        require(dist.get_backend() == "nccl", "the card's group is not NCCL")
        trainer = Trainer(cfg, dataclasses.replace(
            tc, mesh=MeshConfig(1, 1, 1)), device=dev, log_dir=log_dir,
            use_wandb=False)
        require(trainer.mesh is not None, "the trainer took no mesh")
        v = torch.cuda.nccl.version()
        group = dict(nccl=".".join(map(str, v)) if isinstance(v, tuple)
                     else str(v), backend=dist.get_backend(),
                     world=dist.get_world_size(),
                     mesh=dict(zip(trainer.mesh.device_mesh.mesh_dim_names,
                                   trainer.mesh.device_mesh.shape)),
                     data_ranks=trainer.mesh.n_data,
                     built_s=time.time() - t0, card=card)
        print("  group", json.dumps(group), flush=True)
        p0 = {k: v.detach().clone()
              for k, v in trainer.gather(trainer.params).items()}
        runs, snaps = [], {}
        for i in range(MESH_STEPS):
            reset_launches()
            t1 = time.time()
            m = trainer.train_step(batch, noises[i])
            loss, gnorm = m["loss"].item(), m["grad_norm"].item()
            dt = time.time() - t1
            launches = launch_counts()
            for name, n in expect.items():
                require(launches[name] == n, f"{name} launched "
                        f"{launches[name]} times in a mesh step, expected {n}")
            require(all(map(math.isfinite, (loss, gnorm))),
                    f"mesh loss {loss} / grad norm {gnorm} non-finite")
            runs.append(dict(s=dt, loss=loss, grad_norm=gnorm,
                             launches={k: launches[k] for k in expect}))
            if i in snap_at:
                snaps[i] = {k: v.detach() - p0[k] for k, v in
                            trainer.gather(trainer.params).items()}
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            t1 = time.time()
            trainer.train_step(batch, noises[-1])["loss"].item()
            traced_s = time.time() - t1
        tr = device_breakdown(prof, traced_s)
        tr["nccl_ms"] = sum(us for key, (us, _) in device_rows(prof).items()
                            if "nccl" in key.lower()) / 1e3
    finally:
        del trainer
        dist.destroy_process_group()
    require(not dist.is_initialized(), "the phase left its group")

    def rel(a, b):
        return abs(a - b) / abs(b)

    def update_err(snap, ref_params):
        num = sum(float(torch.linalg.vector_norm(
            snap[k] - (v.detach() - p0[k])) ** 2) for k, v in
            ref_params.items())
        den = sum(float(torch.linalg.vector_norm(v.detach() - p0[k]) ** 2)
                  for k, v in ref_params.items())
        return math.sqrt(num / den)

    ref = Trainer(cfg, tc, device="cuda", log_dir=log_dir, use_wandb=False)
    require(ref.mesh is None, "the reference trainer took a mesh")
    errs = []
    for i in range(MESH_STEPS):
        m = ref.train_step(batch, noises[i])
        e = dict(loss=rel(runs[i]["loss"], m["loss"].item()),
                 grad_norm=rel(runs[i]["grad_norm"], m["grad_norm"].item()))
        if i in snap_at:
            e["update"] = update_err(snaps[i], ref.params)
        errs.append(e)
    del ref
    rolled = [Noise(*(None if x is None else torch.roll(x, 1, 0)
                      for x in noises[0][0]))]
    ctl = Trainer(cfg, tc, device="cuda", log_dir=log_dir, use_wandb=False)
    m = ctl.train_step(batch, rolled)
    control = dict(loss=rel(runs[0]["loss"], m["loss"].item()),
                   grad_norm=rel(runs[0]["grad_norm"], m["grad_norm"].item()),
                   update=update_err(snaps[0], ctl.params))
    del ctl, snaps, p0
    times = [r["s"] for r in runs[1:]]
    res = dict(group=group, batch=TRAIN_BATCH, res=TRAIN_RES, blocks=nb,
               steps=runs, median_s_per_step=statistics.median(times),
               idle_share=tr["idle_share"], trace=tr,
               launches_per_step=runs[-1]["launches"],
               errors=errs, control=control,
               limits=dict(loss=MESH_LOSS_REL, update=MESH_UPDATE_REL_L2),
               card=card, clocks_power=nvidia_smi(
                   "clocks.sm,power.draw,power.limit,temperature.gpu"))
    print("  train mesh", json.dumps(res), flush=True)
    for i, e in enumerate(errs):
        require(e["loss"] < MESH_LOSS_REL and e["grad_norm"] < MESH_LOSS_REL
                and e.get("update", 0.0) < MESH_UPDATE_REL_L2,
                f"mesh step {i} off the trainer without a group: {e}")
    require(control["loss"] > MESH_LOSS_REL
            and control["update"] > MESH_UPDATE_REL_L2,
            f"the control (rolled noise) passed the mesh limits: {control}")
    return res


def _tree_digest(tree) -> str:
    """sha256 over a tree's leaves in key order: path, dtype, shape and the
    bytes of each array (CPU tensors or numpy arrays), numbers by value."""
    import hashlib
    import numpy as np
    import torch
    h = hashlib.sha256()

    def walk(node, path):
        if isinstance(node, dict):
            for key in sorted(node):
                walk(node[key], f"{path}/{key}")
            return
        h.update(path.encode())
        if isinstance(node, np.ndarray):
            node = torch.from_numpy(node.copy())  # keeps a 0-d shape
        if isinstance(node, torch.Tensor):
            t = node.detach().cpu().contiguous()
            h.update(f"{t.dtype}{tuple(t.shape)}".encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(repr(node).encode())
    walk(tree, "")
    return h.hexdigest()


def require_disk(root):
    """Fail unless `root` (made here) has CKPT_DISK_BYTES free for the CLI
    phase's checkpoint."""
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    require(free >= CKPT_DISK_BYTES,
            f"{free / 1e9:.1f} GB free under {root}: the CLI phases' "
            f"checkpoints (phase 15's of 5.3 GB the largest) need "
            f"{CKPT_DISK_BYTES / 1e9:.0f} GB")
    return free


@contextlib.contextmanager
def cli_depth(blocks=CLI_BLOCKS):
    """Inside the block, the train CLI's --preset published builds the
    published widths at a depth of `blocks` (sd3_torch.config's
    published_config with num_blocks replaced): the CLI runs of phases 12
    and 14 write checkpoints of that depth, which infer reloads as saved."""
    from sd3_torch import config
    full = config.published_config
    with patched(config, "published_config", lambda *a, **k: full(
            *a, **k).replace(num_blocks=blocks)):
        yield


def phase_cli(card, root):
    """The slice's main path through the port's own CLIs: train.main at the
    published widths (CLI_BLOCKS blocks, 256px, 2 steps, 8-bit moments, the
    host EMA) writes the six artifacts, which are reloaded and hash-compared with
    the trainer's tensors; infer.main samples 512px from the EMA in bf16
    (K1), int8 (K2, K3, K4), and fp32 int8 without and with the block tails
    (the fp32 instances K4F, K2F, K3F; K4F, K9F, K10AF, K10BF), each run's
    launches counted from 0; then tiny_config: a bf16 run, a resume with
    8-bit moments (the optimizer restored from its canonical artifact), and
    --gif. Save and load seconds and GB/s beside the card. Returns the
    launches of each run and the timings."""
    import shutil
    import torch
    from PIL import Image
    from sd3_torch.inference import infer as infer_cli
    from sd3_torch.training import checkpoint as tck
    from sd3_torch.training import train as train_cli
    from sd3_torch.training.optim import to_artifact
    from sd3_torch.training.trainer import Trainer
    from sd3_torch.weights import jax_tree_from_state_dict

    require_disk(root)
    pub = os.path.join(root, "published")
    saves = []
    save = Trainer.save

    def timed_save(self):
        torch.cuda.synchronize()
        t0 = time.time()
        names = save(self)
        saves.append(time.time() - t0)
        return names

    out = {}
    Trainer.save = timed_save
    try:
        reset_launches()
        t0 = time.time()
        with cli_depth():
            tr = train_cli.main([
                "--device", "cuda", "--preset", "published", "--synthetic",
                "--stage_res", "256", "--batchSize", "4",
                "--accumulation_steps", "1", "--totalSteps", "2",
                "--numSaveSteps", "2", "--moments_8bit", "--ema_on_host",
                "--ema_update_freq", "1", "--warmup_steps", "1",
                "--log_steps", "1", "--saveDir", pub])
        torch.cuda.synchronize()
        out["train"] = launch_counts()
        out["train_s"] = time.time() - t0
    finally:
        Trainer.save = save
    nb = tr.cfg.num_blocks
    launched = out["train"]
    for name, n in (("flash_attention_fwd", 2 * 2 * nb),
                    ("flash_attention_dq", 2 * nb),
                    ("flash_attention_dkv", 2 * nb)):
        # per step: the forward and its remat recompute (K5), one backward
        require(launched[name] == n, f"{name} launched {launched[name]} "
                f"times in 2 published-width training steps, expected {n}")
    require(tr.step == 2 and tr.saved_step == 2 and len(saves) == 1,
            f"train CLI ended at step {tr.step}, saved {len(saves)} times")
    names = tck._names(2)
    paths = {k: os.path.join(pub, v) for k, v in names.items()}
    for key, path in paths.items():
        require(os.path.isfile(path), f"train CLI wrote no {names[key]}")
    sizes = {k: os.path.getsize(p) for k, p in paths.items()}
    written = sum(sizes.values())
    t0 = time.time()
    arts = {k: tck.load_artifact(pub, names[k])
            for k in ("model", "ema", "optim", "scheduler")}
    load_s = time.time() - t0
    want = {"model": jax_tree_from_state_dict(tr.params),
            "ema": jax_tree_from_state_dict(tr.ema_state()),
            "optim": tck.to_state_dict(to_artifact(tr.opt_state, tr.params)),
            "scheduler": {"step": 2}}
    digests = {k: (_tree_digest(arts[k]), _tree_digest(want[k]))
               for k in arts}
    for key, (got, exp) in digests.items():
        require(got == exp, f"the reloaded {names[key]} differs from the "
                f"trainer's tensors (sha256 {got[:12]} vs {exp[:12]})")
    cfg = tck.load_config(pub, names["defs"])
    require(cfg.num_blocks == CLI_BLOCKS and cfg.start_step == 2,
            f"model_params_2s.json: {cfg.num_blocks} blocks, start_step "
            f"{cfg.start_step}")
    out.update(save_s=saves[0], save_GBps=written / saves[0] / 1e9,
               load_s=load_s, load_GBps=(written - sizes["defs"]) / load_s
               / 1e9, bytes=sizes, card=card,
               sha256={k: v[0] for k, v in digests.items()})
    del tr, arts, want
    torch.cuda.empty_cache()

    def infer(label, extra, steps, batch, res=512, args=(), root_dir=pub,
              step=2):
        img = os.path.join(root_dir, label.replace(" ", "_"))
        reset_launches()
        t0 = time.time()
        infer_cli.main(["--loadDir", root_dir, "--step", str(step), "--ema",
                        "--text_input", "a red fox in the snow",
                        "--num_steps", str(steps), "--guidance", "5",
                        "--width", str(res), "--height", str(res),
                        "--sampler", "euler", "--seed", "7", "--batch_size",
                        str(batch), "--stub_encoders", "--out_imgname", img,
                        *extra, *args])
        torch.cuda.synchronize()
        out[label] = launch_counts()
        out[f"{label}_s"] = time.time() - t0
        for i in range(batch):
            with Image.open(f"{img}_{i}.png") as im:
                require(im.size == (res, res), f"{label}: {img}_{i}.png is "
                        f"{im.size}")
        return img

    # each infer call: one model forward a step (CFG doubles the batch)
    for label, extra, int8, tails, fp32, batch in (
            ("infer bf16", [], False, False, False, 2),
            ("infer int8", ["--quant", "int8"], True, False, False, 2),
            ("infer fp32 int8", ["--dtype", "float32", "--quant", "int8"],
             True, False, True, 1),
            ("infer fp32 int8 tails", ["--dtype", "float32", "--quant",
                                       "int8", "--attn_tail", "all",
                                       "--mlp_tail_fusion", "3d"],
             True, True, True, 1)):
        infer(label, extra, CLI_STEPS, batch)
        expect = {k: 0 for k in ATTENTION_KERNELS}
        expect[attention_kernel(int8, False, False, fp32)] = nb * CLI_STEPS
        expect.update(block_tail_launches(nb, CLI_STEPS, int8, tails, fp32))
        for name, n in expect.items():
            require(out[label][name] == n, f"{name} launched "
                    f"{out[label][name]} times in `{label}`, expected {n}")
        print(f"  {label}: {out[f'{label}_s']:.1f} s", json.dumps(
            {k: v for k, v in out[label].items() if v}), flush=True)

    # tiny_config: a bf16-moment run, an 8-bit resume from its canonical
    # optimizer artifact, and the GIF
    tiny, tiny8 = os.path.join(root, "tiny"), os.path.join(root, "tiny8")
    common = ["--device", "cuda", "--preset", "tiny", "--synthetic",
              "--stage_res", "64", "--batchSize", "2",
              "--accumulation_steps", "1", "--warmup_steps", "1",
              "--ema_update_freq", "1"]
    train_cli.main([*common, "--totalSteps", "2", "--numSaveSteps", "2",
                    "--low_mem_optimizer", "--saveDir", tiny])
    tr = train_cli.main([*common, "--totalSteps", "3", "--numSaveSteps", "3",
                         "--moments_8bit", "--loadDir", tiny, "--loadStep",
                         "2", "--saveDir", tiny8])
    require(type(tr.opt_state).__name__ == "Adam8bitState"
            and tr.opt_state.count == 3 and tr.step == 3,
            f"tiny resume: {type(tr.opt_state).__name__} count "
            f"{tr.opt_state.count} at step {tr.step}, expected an 8-bit "
            "state restored at 2 and stepped once")
    gif = infer("tiny gif", ["--gif"], 3, 2, res=64, root_dir=tiny8, step=3)
    with Image.open(f"{gif}_diffusion.gif") as im:
        require(im.n_frames == 3, f"the GIF has {im.n_frames} frames")
    print("  checkpoint", json.dumps(dict(
        card=card, save_s=out["save_s"], save_GBps=out["save_GBps"],
        load_s=out["load_s"], load_GBps=out["load_GBps"],
        bytes=out["bytes"], train_s=out["train_s"],
        sha256=out["sha256"])), flush=True)
    return out


# ---- phase 12b: the eval path ----------------------------------------------
# generate_images on phase 12's checkpoint (the published widths at
# CLI_BLOCKS blocks, its EMA): EVAL_PROMPTS x EVAL_PER_PROMPT images at
# 512px, batch EVAL_BATCH, EVAL_STEPS Euler steps, stub encoders; in bf16
# (K1), with --quant int8 (K2, K3, K4) and, as the FID's control, in bf16
# from another --seed. The first batch of the bf16 and int8 runs runs under
# utils.profiling.trace. calculate_fid (ReducedPixelFeatures: no Inception
# weights are here) scores int8 against bf16 (the quantization's drift)
# and the control against bf16, on EVAL_FID_DIM features: 8 images a
# folder give covariances of rank 7 at most, which 2048 dimensions (22-43
# s of sqrtm on the host) resolve no better. Quantization moves the
# latents far less than another seed (BASELINE.md): on an H100 the drift
# measured 2.09e-4 and the control 0.0227 (PERF.md; 0.0074 and 0.79 on
# 2048 features). The limit sits 11x above the one and 9x under the other.
EVAL_PROMPTS = ("a red fox in the snow", "a lighthouse at dusk")
EVAL_PER_PROMPT, EVAL_BATCH, EVAL_STEPS, EVAL_RES = 4, 4, 4, 512
EVAL_FID_DIM = 64
EVAL_FID_DRIFT = 2.4e-3


def trace_families(trace_dir) -> dict:
    """{family: kernel launches} in the Chrome trace(s) that
    utils.profiling.trace wrote under `trace_dir` (kernel_family names)."""
    fams = {}
    for name in os.listdir(trace_dir):
        with open(os.path.join(trace_dir, name)) as f:
            events = json.load(f)["traceEvents"]
        for e in events:
            if e.get("cat") == "kernel":
                fam = kernel_family(e.get("name", ""))
                fams[fam] = fams.get(fam, 0) + 1
    return fams


def phase_eval(card, ckpt_dir, step=2):
    """Phase 12b (see EVAL_PROMPTS): generate_images.main in bf16, int8 and
    bf16 from another seed, each run's launches counted from 0 against
    blocks x steps x calls, the traced batches' kernels read from the trace
    file, s per image from the untraced batch, and calculate_fid.main's
    drift and control."""
    import torch
    from PIL import Image
    from sd3_torch.evals import calculate_fid, fid, generate_images
    from sd3_torch.training import checkpoint as tck

    nb = tck.load_config(ckpt_dir, f"model_params_{step}s.json").num_blocks
    root = os.path.join(ckpt_dir, "eval")
    os.makedirs(root, exist_ok=True)
    prompts = os.path.join(root, "prompts.txt")
    with open(prompts, "w") as f:
        f.write("\n".join(EVAL_PROMPTS) + "\n")
    calls = len(EVAL_PROMPTS) * -(-EVAL_PER_PROMPT // EVAL_BATCH)
    out = dict(card=card, blocks=nb, steps=EVAL_STEPS, res=EVAL_RES,
               batch=EVAL_BATCH, images=len(EVAL_PROMPTS) * EVAL_PER_PROMPT)
    dirs = {}
    for label, extra, int8, traced in (
            ("bf16", [], False, ["K1"]),
            ("int8", ["--quant", "int8"], True, ["K2", "K3", "K4"]),
            ("bf16 seed 1", ["--seed", "1"], False, [])):
        d = dirs[label] = os.path.join(root, label.replace(" ", "_"))
        trace_dir = os.path.join(root, "trace_" + label.replace(" ", "_"))
        reset_launches()
        t0 = time.time()
        manifest, batch_s = generate_images.main([
            "--loadDir", ckpt_dir, "--step", str(step), "--ema",
            "--prompts_file", prompts, "--num_per_prompt",
            str(EVAL_PER_PROMPT), "--batch_size", str(EVAL_BATCH),
            "--num_steps", str(EVAL_STEPS), "--res", str(EVAL_RES),
            "--out_dir", d, "--stub_encoders", *extra,
            *(["--trace_dir", trace_dir] if traced else [])])
        torch.cuda.synchronize()
        launches = launch_counts()
        run = dict(wall_s=time.time() - t0, batch_s=batch_s,
                   s_per_image=batch_s["mean"] / EVAL_BATCH,
                   launches={k: v for k, v in launches.items() if v})
        expect = {k: 0 for k in ATTENTION_KERNELS}
        expect[attention_kernel(int8, False, False)] = nb * EVAL_STEPS * calls
        expect.update(block_tail_launches(nb, EVAL_STEPS * calls, int8,
                                          False))
        for name, n in expect.items():
            require(launches[name] == n, f"generate_images {label}: {name} "
                    f"launched {launches[name]} times, expected {n} ({nb} "
                    f"blocks x {EVAL_STEPS} steps x {calls} calls)")
        require(len(manifest) == len(EVAL_PROMPTS) and all(
            m["count"] == EVAL_PER_PROMPT for m in manifest),
            f"generate_images {label}: manifest {manifest}")
        for pi in range(len(EVAL_PROMPTS)):
            for k in range(EVAL_PER_PROMPT):
                with Image.open(os.path.join(d, str(pi), f"{k}.png")) as im:
                    require(im.size == (EVAL_RES, EVAL_RES),
                            f"generate_images {label}: {pi}/{k}.png is "
                            f"{im.size}")
        if traced:
            fams = run["trace_kernels"] = trace_families(trace_dir)
            for fam in traced:
                require(fams.get(fam, 0) > 0, f"the trace of generate_images"
                        f" {label}'s first batch names no {fam} kernel: "
                        f"{fams}")
        out[label] = run
    t0 = time.time()
    with patched(fid.ReducedPixelFeatures, "dim", EVAL_FID_DIM):
        out["fid_int8_vs_bf16"] = calculate_fid.main(
            ["score", "--generated_dir", dirs["int8"], "--ref_dir",
             dirs["bf16"]])
        out["fid_control_vs_bf16"] = calculate_fid.main(
            ["score", "--generated_dir", dirs["bf16 seed 1"], "--ref_dir",
             dirs["bf16"]])
    out.update(fid_s=time.time() - t0, fid_dim=EVAL_FID_DIM,
               fid_limit=EVAL_FID_DRIFT)
    print("  eval", json.dumps(out), flush=True)
    require(out["fid_int8_vs_bf16"] <= EVAL_FID_DRIFT, f"the int8 images' "
            f"FID against bf16 {out['fid_int8_vs_bf16']} > {EVAL_FID_DRIFT}")
    require(out["fid_control_vs_bf16"] > EVAL_FID_DRIFT, f"the control "
            f"(another seed) passes the FID drift limit "
            f"({out['fid_control_vs_bf16']})")
    shutil.rmtree(root, ignore_errors=True)
    return out


def launch_counts():
    """{kernel name: launches so far} of every registered kernel."""
    from sd3_torch import kernels
    return {k.name: k.launches for k in kernels.REGISTRY}


def reset_launches():
    from sd3_torch import kernels
    for k in kernels.REGISTRY:
        k.launches = 0


def block_tail_launches(nb: int, calls: int, int8: bool, tails: bool,
                        fp32: bool = False) -> dict:
    """Launches of the int8 block-tail kernels in `calls` forwards of an
    nb-block model: under int8, K2 in every block and K3 in every block but
    the last (whose text stream has no MLP), or with the tails (attn_tail
    "all", mlp_tail_fusion "3d") K9 for both streams and K10a, K10b once a
    block (the image stream: the text stream's 154 tokens decline them, and
    the last block has no text out-projection); none in bf16. With `fp32`
    (the fp32 int8 model) their fp32 instances, and none of the bf16 ones."""
    k2 = nb * calls if int8 and not tails else 0
    k3 = (nb - 1) * calls if int8 and not tails else 0
    k10 = nb * calls if tails else 0
    counts = dict(swiglu_int8_tail=k2, swiglu_int8=k3,
                  swiglu_int8_tail3d=(2 * nb - 1) * calls if tails else 0,
                  qkv_adaln_int8=k10, out_gate_residual_int8=k10)
    fp32_counts = {f"{name}_fp32": n for name, n in counts.items()}
    if fp32:
        return {**fp32_counts, **dict.fromkeys(counts, 0)}
    return {**counts, **dict.fromkeys(fp32_counts, 0)}


TAILS = dict(attn_tail="all", mlp_tail_fusion="3d")


def phase_model(gen_seed, int8=False, res=512, batch=2, int8_pv=False,
                tails=False, fp32=False):
    """2-block published-width model at `res`, bf16 or int8 (w8a8, with
    int8_pv int8 P.V too, with `tails` the opt-in block tails), or with
    `fp32` the fp32 model (the fp32 attention instances), on the card vs the
    same weights in fp32 on the CPU; the fp32 int8 model module by module
    too (module_errors), beside its two controls."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.quant import quantize_model

    cfg = published_config(stage_res=res).replace(
        num_blocks=2, int8_pv=int8_pv, **(TAILS if tails else {}))
    ref = MMDiT(cfg.replace(dtype="float32"), device="cpu").init_weights(
        torch.Generator().manual_seed(gen_seed)).eval()
    g = torch.Generator().manual_seed(gen_seed + 1)
    lat = res // 8
    x = torch.randn((batch, cfg.inCh, lat, lat), generator=g)
    t = torch.rand((batch,), generator=g)
    c = torch.randn((batch, cfg.text_tokens, cfg.text_hidden_dim), generator=g)
    cp = torch.randn((batch, cfg.class_dim), generator=g)
    nulls = tuple(torch.tensor(m[:batch]) for m in (
        [False, True], [True, False], [False, True]))
    modules = int8 and fp32
    float_sd = ({k: v.clone() for k, v in ref.state_dict().items()}
                if modules else None)
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
    records, hooks = record_modules(ref) if modules else ([], [])
    with torch.inference_mode():
        t0 = time.time()
        want = ref(x, t, c, cp, *nulls)
        cpu_s = time.time() - t0
        for h in hooks:
            h.remove()
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
    if modules:
        # the check, then its controls: the bf16 int8 model and the
        # unquantized fp32 model on the same recorded inputs
        bf16 = MMDiT(cfg.replace(dtype="bfloat16"), device="cuda")
        bf16.load_state_dict(ref.state_dict(), strict=True)
        bf16.cast_params(torch.bfloat16)
        unq = MMDiT(cfg.replace(quant="none"), device="cuda")
        unq.load_state_dict(float_sd, strict=True)
        res_d["module_rel_l2"] = {
            run: module_errors(records, m.eval(), dt) for run, m, dt in (
                ("fp32_int8", dut, torch.float32),
                ("control_bf16_int8", bf16, torch.bfloat16),
                ("control_fp32_unquantized", unq, torch.float32))}
        del bf16, unq
    print("  model", json.dumps(res_d), flush=True)
    nb = cfg.num_blocks
    # attention: K1 / K4 up to 2048 padded tokens (512px: 1178 tokens pad
    # to 1280, K4 under int8), K7 / K8b above (1024px: 4250); int8: the
    # image-stream MLP K2, the text-stream MLP K3 in every block but the last
    streaming = res > 512
    attn = attention_kernel(int8, int8_pv, streaming, fp32)
    want_launches = {k: 0 for k in ATTENTION_KERNELS}
    want_launches[attn] = nb
    want_launches.update(block_tail_launches(nb, 1, int8, tails, fp32))
    for name, n in want_launches.items():
        require(launches[name] == n, f"{name} launched {launches[name]} times "
                f"in a {nb}-block {cfg.quant} {cfg.dtype} {res}px forward, "
                f"expected {n}")
    limit = (INT8_MODEL_REL_L2 if int8 else FP32_MODEL_REL_L2 if fp32
             else MODEL_REL_L2)
    require(rel <= limit, f"2-block {cfg.quant} {res}px model rel L2 {rel} > "
            f"{limit}")
    if modules:
        errs = res_d["module_rel_l2"]
        worst = max(errs["fp32_int8"].values())
        require(worst <= INT8_FP32_MODULE_REL_L2,
                f"2-block fp32 int8 {res}px model (tails {tails}): a module's "
                f"rel L2 {worst} > {INT8_FP32_MODULE_REL_L2} on the CPU's "
                f"inputs: {errs['fp32_int8']}")
        for run in ("control_bf16_int8", "control_fp32_unquantized"):
            best = min(errs[run].values())
            require(best > INT8_FP32_MODULE_REL_L2,
                    f"a module of the {run} passes the module check (rel L2 "
                    f"{best} <= {INT8_FP32_MODULE_REL_L2}): it cannot tell "
                    f"that model from the fp32 int8 one there")
    return res_d


def phase_model_wide(int8=False, seed=0, model=D256_MODEL):
    """The published widths but the dim and heads of `model` (D256_MODEL:
    dim 1280 in five heads of 256; D384_MODEL: 1152 in three of 384;
    D640_MODEL: 1280 in two of 640, run padded at 768) at 2
    blocks, 512px, batch 1, on the card in bf16 or int8 (w8a8, with K2 and
    K3) against the same weights in fp32 on the CPU, within phase 4's
    MODEL_REL_L2 / INT8_MODEL_REL_L2. Its attention takes the general path,
    as the JAX package's gate sends every head dim that does not divide 128
    (sd3_tpu/ops/attention.py `_fused_path_ok`): flash attention, the wgmma
    kernel's instance at the head dim (K5_256, K5_384, K5_768), once a
    block, in bf16 and int8 alike, and the wide K5W never. The control, RoPE1d's tables on the same weights
    on the CPU, must miss the limit."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops import flash_attention as fl
    from sd3_torch.ops.quant import quantize_model

    cfg = published_config(stage_res=512).replace(num_blocks=2, **model)
    hd = cfg.dim // cfg.num_heads
    ref = MMDiT(cfg.replace(dtype="float32"), device="cpu").init_weights(
        torch.Generator().manual_seed(seed)).eval()
    if int8:
        quantize_model(ref)
    ctl = _load_loose(MMDiT(ref.cfg.replace(positional_encoding="RoPE"),
                            device="cpu").eval(), ref.state_dict())
    g = torch.Generator().manual_seed(seed + 1)
    args = (torch.randn((1, cfg.inCh, 64, 64), generator=g),
            torch.rand((1,), generator=g),
            torch.randn((1, cfg.text_tokens, cfg.text_hidden_dim), generator=g),
            torch.randn((1, cfg.class_dim), generator=g))
    dut = MMDiT(ref.cfg.replace(dtype="bfloat16"), device="cuda")
    dut.load_state_dict(ref.state_dict(), strict=True)
    dut.cast_params(torch.bfloat16)
    dut.eval()
    with torch.inference_mode():
        want, other = ref(*args), ctl(*args)
        reset_launches()
        got = dut(*(a.cuda() for a in args)).cpu()
    launches = launch_counts()
    require(bool(torch.isfinite(got).all()), f"the D = {hd} model: 2-block "
            "output non-finite")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    limit = INT8_MODEL_REL_L2 if int8 else MODEL_REL_L2
    res = dict(quant=ref.cfg.quant, heads=cfg.num_heads, dim=cfg.dim,
               limit=limit, rel_l2=rel(got, want),
               control_rel_l2=rel(got, other), launches={
                   k: n for k, n in launches.items() if n})
    print(f"  model, {cfg.num_heads} heads of {hd}", json.dumps(res),
          flush=True)
    nb = cfg.num_blocks
    want_launches = {k: 0 for k in ATTENTION_KERNELS}
    dims = (*fl.WGMMA_PAST_128, *fl.WGMMA_PAST_512)
    want_launches.update({f"{k}_{d}": 0 for k in ATTENTION_KERNELS
                          if not k.endswith("_fp32") for d in dims})
    want_launches.update({f"flash_attention_fwd_{d}": 0 for d in dims})
    want_launches.update({fl.flash_kernel("fwd", torch.bfloat16, hd).name: nb,
                          "flash_attention_fwd_wide": 0,
                          "flash_attention_fwd": 0})
    want_launches.update(block_tail_launches(nb, 1, int8, False))
    for name, n in want_launches.items():
        require(launches[name] == n, f"{name} launched {launches[name]} "
                f"times in the 2-block D = {hd} {res['quant']} forward, "
                f"expected {n}")
    require(res["rel_l2"] <= limit, f"the D = {hd} {res['quant']} model: "
            f"rel L2 {res['rel_l2']} > {limit}")
    require(res["control_rel_l2"] > limit, f"the D = {hd} model's control "
            f"(RoPE1d) passes: rel L2 {res['control_rel_l2']} <= {limit}")
    res["launches"] = launches
    return res


def record_modules(model):
    """Forward hooks on every JointAttention and MLP module of the CPU
    `model` that keep each call's (name, args, kwargs, output), cloned.
    Returns (records, hook handles)."""
    import torch
    from torch.utils._pytree import tree_map
    from sd3_torch.ops.attention import JointAttention
    from sd3_torch.ops.mlp import MLP

    records = []
    keep = lambda v: tree_map(
        lambda a: a.clone() if isinstance(a, torch.Tensor) else a, v)

    def hook(name):
        return lambda mod, args, kwargs, out: records.append(
            (name, keep(args), keep(kwargs), keep(out)))

    hooks = [m.register_forward_hook(hook(n), with_kwargs=True)
             for n, m in model.named_modules()
             if isinstance(m, (JointAttention, MLP))]
    return records, hooks


def module_errors(records, dut, dtype):
    """Each recorded module call run on the card model `dut`'s module of the
    same name, on the recorded inputs cast to `dtype`: {module.output: rel
    L2 of its increment (the output less the residual it adds to, where it
    adds one) against the recorded one}. An unquantized MLP given the int8
    MLP's block tail (AdaLN, gate, residual) computes it around itself, as
    the attention's tail path does."""
    import torch
    from torch.utils._pytree import tree_map
    from sd3_torch.ops.attention import _adaln, _gate_res
    from sd3_torch.ops.mlp import MLP

    def to_card(a):
        if not isinstance(a, torch.Tensor):
            return a
        a = a.cuda()
        return a.to(dtype) if a.is_floating_point() else a

    errs = {}
    with torch.inference_mode():
        for name, args, kwargs, want in records:
            mod = dut.get_submodule(name)
            d_args, d_kw = tree_map(to_card, (args, kwargs))
            if isinstance(mod, MLP):
                tail = kwargs.get("residual", False)
                if tail and not mod.fused_ok:
                    x = d_args[0]
                    got = _gate_res(mod(_adaln(x, d_kw["shift"],
                                                   d_kw["scale"])),
                                    d_kw["gate"], x)
                else:
                    got = mod(*d_args, **d_kw)
                outs = {"": (got, want, (d_args[0], args[0]) if tail
                             else None)}
            else:
                got = mod(*d_args, **d_kw)
                tail = kwargs.get("tail")
                outs = {".x": (got[0], want[0], (d_kw["tail"]["res_x"],
                                                  tail["res_x"]) if tail
                               else None)}
                if not (tail and mod.last):  # a last block returns res_c
                    outs[".c"] = (got[1], want[1], (d_kw["tail"]["res_c"],
                                                     tail["res_c"]) if tail
                                  else None)
            for key, (g, w, resid) in outs.items():
                g = g.float().cpu()
                if resid is not None:
                    g = g - resid[0].float().cpu()
                    w = w - resid[1]
                errs[name + key] = ((g - w).norm() / w.norm()).item()
    return errs


ATTENTION_KERNELS = ("fused_attention_bf16", "fused_attention_int8qk",
                     "fused_attention_int8pv", "fused_attention_stream",
                     "fused_attention_stream_int8qk",
                     "fused_attention_stream_int8pv", "fused_attention_fp32",
                     "fused_attention_stream_fp32",
                     "fused_attention_int8qk_fp32",
                     "fused_attention_int8pv_fp32",
                     "fused_attention_stream_int8qk_fp32",
                     "fused_attention_stream_int8pv_fp32")


def attention_kernel(int8, int8_pv, streaming, fp32=False) -> str:
    """The attention kernel a model forward launches once a block: K1 / K4
    up to 2048 padded tokens (K4 under int8), K7 / K8b above (K8b with
    int8_pv), as the JAX package's gates choose (int8 P.V only past 2048
    tokens, so no model path takes K8a); the fp32 instances in fp32."""
    if streaming:
        name = ("fused_attention_stream_int8pv" if int8_pv
                else "fused_attention_stream")
    else:
        name = "fused_attention_int8qk" if int8 else "fused_attention_bf16"
    if fp32:
        name = {"fused_attention_bf16": "fused_attention"}.get(name, name)
        name += "_fp32"
    return name


class TimedSuite:
    """The real-architecture suite (encoder_suite.RealTextEncoders, random
    weights) behind the sampler's encoder interface: the token ids of every
    prompt from a seed, as no tokenizer is there; `spent` holds the seconds
    of its encodes and decodes (each synchronised on both sides)."""

    def __init__(self, suite, seed=0):
        self.suite = suite
        self.latent_channels = suite.latent_channels
        self.seed = seed
        self.spent = dict(encode_s=0.0, decode_s=0.0)

    def _timed(self, key, fn, *args):
        import torch
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn(*args)
        torch.cuda.synchronize()
        self.spent[key] += time.time() - t0
        return out

    def text_to_embedding(self, text):
        n = 1 if isinstance(text, str) else len(text)
        return self._timed("encode_s", self.suite.embed_ids,
                           *text_ids(self.suite, n, self.seed))

    def vae_decode(self, latents):
        return self._timed("decode_s", self.suite.vae_decode, latents)


def text_ids(suite, batch, seed, valid=None):
    """Seeded token ids and masks of the suite's three towers (77 tokens;
    row i valid up to valid[i], else whole)."""
    import torch
    from sd3_torch.models.text_encoders import TEXT_TOKENS
    gen = torch.Generator().manual_seed(seed)
    mask = torch.ones((batch, TEXT_TOKENS), dtype=torch.long)
    for i, n in enumerate(valid or []):
        mask[i, n:] = 0
    out = []
    for net in (suite.gemma, suite.bert, suite.clip):
        out += [torch.randint(0, net.cfg.vocab_size, (batch, TEXT_TOKENS),
                              generator=gen), mask]
    return out


@contextlib.contextmanager
def patched(obj, name, value):
    """obj.name = value inside the block (the controls of phase 13)."""
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def net_pair(cls, cfg, dtype, seed):
    """(the network on the card in `dtype` with PyTorch's initialisation
    seeded by `seed`, the same weights in fp32 on the CPU)."""
    import torch
    torch.manual_seed(seed)
    card = cls(cfg, dtype=dtype, device="cuda")
    cpu = cls(cfg, dtype=torch.float32, device="meta")
    cpu.load_state_dict({k: v.float().cpu() for k, v in
                         card.state_dict().items()}, assign=True)
    return card, cpu


def count_flops(run, root) -> float:
    """The operations of run(): 2 * MACs of every conv and linear under
    `root` (forward hooks on the modules), and of the VAE's mid attention
    QK^T and P.V, 4 * B * N^2 * C."""
    import torch
    from sd3_torch.models.vae import AttnBlock
    total = [0.0]

    def hook(m, inp, out):
        if isinstance(m, torch.nn.Conv2d):
            kh, kw = m.kernel_size
            total[0] += 2.0 * out.numel() * m.in_channels // m.groups * kh * kw
        elif isinstance(m, torch.nn.Linear):
            total[0] += 2.0 * out.numel() * m.in_features
        else:
            b, c, h, w = out.shape
            total[0] += 4.0 * b * (h * w) ** 2 * c
    hooks = [m.register_forward_hook(hook) for m in root.modules()
             if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear, AttnBlock))]
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return total[0]


def phase_encoders(card):
    """The frozen encoders and the FLUX VAE (models/encoder_suite.py) at the
    published widths with seeded random weights built on the card, no
    tokenizer (seeded ids): each network in its serving dtype against the
    same weights in fp32 on the CPU (Gemma-2, ModernBERT, CLIP at 2 layers;
    the whole VAE decoding 32 x 32 latents and encoding a 256px image) in
    TEXT_REL_L2 / VAE_REL_L2, each with a control that must fail its limit;
    then ms, the card's busy ms (device_ms) and peak memory at full depth
    (text_to_embedding from ids at batch 4; vae_decode at 64 x 64 and 128 x
    128 latents and vae_encode at 512px, batch 4, beside the bound of their
    counted operations); then
    512px bf16 sampling of the published 19-block MMDiT through the suite
    (batch 4, 20 Euler steps, CFG 5; K1 380 launches a call), with the
    share of each call spent encoding and decoding."""
    import dataclasses

    import torch
    from sd3_torch.models import clip_text, encoder_ops, gemma2, modernbert
    from sd3_torch.models import vae as vae_mod
    from sd3_torch.models.encoder_suite import RealTextEncoders

    out = {}
    # 1. each network against fp32 on the CPU, and its control
    ids_gen = torch.Generator().manual_seed(11)
    mask = torch.ones((2, 77), dtype=torch.long)
    mask[1, 40:] = 0
    non_causal = lambda m, t, causal, dev: encoder_ops.pad_bias(m, t, False,
                                                                dev)

    def swapped_geglu(self, x):
        inp, gate = self.Wi(x).chunk(2, dim=-1)
        return self.Wo(torch.nn.functional.gelu(gate) * inp)

    towers = (  # name, class, 2-layer published config, dtype, control
        ("Gemma-2", gemma2.Gemma2Encoder,
         dataclasses.replace(gemma2.Gemma2Config(), num_hidden_layers=2),
         torch.bfloat16, ("no causal mask", gemma2, "pad_bias", non_causal)),
        ("ModernBERT", modernbert.ModernBertEncoder,
         dataclasses.replace(modernbert.ModernBertConfig(),
                             num_hidden_layers=2), torch.bfloat16,
         ("GeGLU input and gate swapped", modernbert.ModernBertMLP,
          "forward", swapped_geglu)),
        ("CLIP", clip_text.ClipTextEncoder,
         dataclasses.replace(clip_text.ClipTextConfig(), num_hidden_layers=2),
         torch.float16, ("no causal mask", clip_text, "pad_bias", non_causal)))
    for seed, (name, cls, cfg, dt, (what, obj, attr, value)) in enumerate(
            towers):
        dut, ref = net_pair(cls, cfg, dt, seed)
        ids = torch.randint(0, cfg.vocab_size, (2, 77), generator=ids_gen)
        flat = lambda o: (torch.cat([o[0].flatten().float().cpu(),
                                     o[1].flatten().float().cpu()])
                          if isinstance(o, tuple) else o.float().cpu())
        want = flat(ref(ids, mask))
        err = _rel_l2(flat(dut(ids, mask)), want)
        with patched(obj, attr, value):
            ctl = _rel_l2(flat(dut(ids, mask)), want)
        out[name] = dict(dtype=str(dt), rel_l2=err, limit=TEXT_REL_L2,
                         control=what, control_rel_l2=ctl)
        print(f"  {name}", json.dumps(out[name]), flush=True)
        require(err <= TEXT_REL_L2, f"{name} rel L2 {err} > {TEXT_REL_L2}")
        require(ctl > TEXT_REL_L2, f"{name} with its control ({what}) at "
                f"rel L2 {ctl}: the limit {TEXT_REL_L2} would pass it")
        del dut, ref
    dut, ref = net_pair(vae_mod.FluxVAE, vae_mod.VAEConfig.flux(),
                        torch.bfloat16, 7)
    gen = torch.Generator().manual_seed(12)
    z = torch.randn((1, 16, 32, 32), generator=gen)
    img = torch.rand((1, 3, 256, 256), generator=gen) * 2 - 1
    flat = lambda m: torch.cat([m.decode(z).flatten().cpu(),
                                *(t.flatten().cpu()
                                  for t in m.encode_moments(img))])
    want = flat(ref)
    err = _rel_l2(flat(dut), want)
    with patched(vae_mod.AttnBlock, "forward", lambda self, x: x):
        ctl = _rel_l2(flat(dut), want)
    out["VAE"] = dict(dtype="torch.bfloat16", rel_l2=err, limit=VAE_REL_L2,
                      control="no mid attention", control_rel_l2=ctl)
    print("  VAE (decode 32x32 latents, encode 256px)", json.dumps(out["VAE"]),
          flush=True)
    require(err <= VAE_REL_L2, f"VAE rel L2 {err} > {VAE_REL_L2}")
    require(ctl > VAE_REL_L2, f"VAE without its mid attention at rel L2 "
            f"{ctl}: the limit {VAE_REL_L2} would pass it")
    del dut, ref

    # 2. times and peak memory at full depth, batch 4
    torch.manual_seed(0)
    suite = RealTextEncoders.build("cuda")
    ids = [t.cuda() for t in text_ids(suite, 4, 1, valid=[77, 60, 30, 10])]

    def timed(label, fn, flops=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(fn, iters=1, groups=3, graph=False)
        r = dict(ms=ms, device_ms=device_ms(fn),
                 peak_gb=(torch.cuda.max_memory_allocated() - base) / 1e9)
        if flops:
            r.update(tflop=flops / 1e12,
                     **bound(flops / PEAK_BF16_FLOPS, 0.0))
        out[label] = r
        print(f"  {label}", json.dumps(r), flush=True)
    timed("text_to_embedding ids B=4", lambda: suite.embed_ids(*ids))
    for hw in (64, 128):
        zz = torch.randn((4, 16, hw, hw), device="cuda")
        flops = count_flops(lambda: suite.vae_decode(zz[:1]),
                            suite.vae.decoder) * 4
        timed(f"vae_decode {hw}x{hw} latents B=4",
              lambda: suite.vae_decode(zz), flops)
    im = torch.rand((4, 3, 512, 512), device="cuda") * 2 - 1
    flops = count_flops(lambda: suite.vae.encode_moments(im[:1]),
                        suite.vae.encoder) * 4
    g = torch.Generator(device="cuda").manual_seed(3)
    timed("vae_encode 512px B=4", lambda: suite.vae_encode(im, g), flops)
    z = suite.vae_encode(im, g)
    require(tuple(z.shape) == (4, 16, 64, 64) and
            bool(torch.isfinite(z).all()), f"vae_encode: {tuple(z.shape)}")

    # 3. 512px sampling of the published model through the suite
    run = phase_sample(card, enc=TimedSuite(suite))
    med = run["median_s_per_batch"]
    i = run["run_s"].index(med)
    part = run["encode_decode_s"][i]
    out["sample"] = dict(images_per_s=run["images_per_s"], median_s=med,
                         encode_share=part["encode_s"] / med,
                         decode_share=part["decode_s"] / med, **part)
    print("  sample through the suite", json.dumps(out["sample"]), flush=True)
    return out, run


def phase_sample(card, int8=False, res=512, int8_pv=False, timed=1,
                 tails=False, enc=None):
    """Full-width sampling through the port's entry points: the bf16 model,
    or (int8) the same seeded weights quantized by quantize_model, with
    int8_pv int8 P.V in the streaming attention, with `tails` the opt-in
    block tails; through the stub encoders, or `enc` (a TimedSuite: the
    seconds of its encode and decode in each timed call are kept). One
    warmup call, `timed` timed calls, then one more under torch.profiler."""
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
    enc = enc or StubTextEncoders(device="cuda")
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
        if isinstance(enc, TimedSuite):
            enc.spent = dict(encode_s=0.0, decode_s=0.0)
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
    times, launches, parts = [], {}, []
    for _ in range(timed):
        t0 = time.time()
        imgs, launches = run(decode=True)
        times.append(time.time() - t0)
        parts.append(dict(getattr(enc, "spent", {})))
        require(bool(torch.isfinite(imgs).all()), "decoded images non-finite")
    med = statistics.median(times)
    res_d = dict(quant=model.cfg.quant, int8_pv=int8_pv, tails=tails,
                 encoders=type(enc).__name__, encode_decode_s=parts,
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
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
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
# last integer template argument (csrc/int8_common.cuh), the element type
# after it where there is one: xquant_kernel<2, __nv_bfloat16>,
# swiglu_h_sm90_kernel<256, 9>, w3_sm90_kernel<256, 9, float>, ...; K10a /
# K10b's as their first, dense_sm90_kernel<10, false, float> (the second:
# chunked or not)
INT8_LAUNCH = re.compile(r"(?:xquant_kernel|swiglu_h_sm90_kernel|"
                         r"w3_sm90_kernel)<(?:\d+, )*(\d+)(?:, [\w ]+)?>|"
                         r"dense_sm90_kernel<(\d+)")
INT8_FAMILIES = {"2": "K2", "3": "K3", "9": "K9", "10": "K10a", "11": "K10b"}
# attn_int8_sm90_kernel<D, QK8, PV8, TWO_PASS> instantiations by family
INT8_ATTN_FAMILIES = {"true, false, true>": "K4", "true, false, false>": "K7q",
                      "false, true, true>": "K8a", "true, true, true>": "K8a",
                      "false, true, false>": "K8b", "true, true, false>": "K8b"}
# the per-row int8 prep carries the number of its TPU kernel as its second
# template argument (csrc/attention_common.cuh), the element type after it:
# prep_q8rows_kernel<64, 4, __nv_bfloat16>
Q8ROWS_LAUNCH = re.compile(r"prep_q8rows_kernel<\d+, (\d+)(?:, [\w ]+)?>")
Q8ROWS_FAMILIES = {"4": "K4", "7": "K7q", "8": "K8b", "81": "K8a"}
# the fp32 attention kernels (csrc/attention_fp32.cu): K1 / K7 / K5 and
# K6a / K6b on fp32 operands
FP32_KERNELS = ("attn_fp32_kernel", "dq_fp32_kernel", "dkv_fp32_kernel",
                "attn_q8_fp32_kernel")


# the flash backward's kernels (csrc/flash_bwd_sm90.cu) by family
# the fused kernels' rows past head dim 128: (name of the base kernel in
# ops/fused_attention.py, its row in ATTN_NAMES, the TPU kernel's line)
WIDE_ROWS = (("K1", "K1", 135), ("K4", "K4", 193), ("K8A", "K8a", 181),
             ("K7", "K7", 312), ("K7Q", "K7q", 352), ("K8B", "K8b", 406))
FLASH_BWD_FAMILIES = {"flash_dq_sm90_kernel": "K6a",
                      "flash_dkv_sm90_kernel": "K6b"}
# the design of each kernel source, for the {"kernels"} line
SOURCE_DESIGNS = {"attention_sm90.cu": "wgmma+TMA, warp-specialised",
                  "flash_bwd_sm90.cu": "wgmma+TMA, warp-specialised",
                  "fused_mlp.cu": "wgmma+TMA, warp-specialised",
                  "attention_int8_sm90.cu": "wgmma+TMA, warp-specialised",
                  "attention_fp32.cu": "mma.sync over shared-memory tiles "
                  "(fp32 products in 3xTF32, bf16 in one tf32 pass, int8 "
                  "s8)",
                  "fused_dense.cu": "wgmma+TMA, warp-specialised"}


# ---- phase 14: data-fed training ------------------------------------------
# The dataset phase 14 builds from a seed: two raw parquet files of
# FEED_ROWS images each in three aspect families (h x w about 300 x 300,
# 250 x 400 and 400 x 250, each side jittered by up to FEED_JITTER px: one
# bucket a family after the phase resize), two seeded captions a row, and in
# each file a low-resolution row and an undecodable one that the filter
# drops; phased to a larger side of FEED_MAX_RES, multiples of 16.
FEED_FAMILIES = ((300, 300), (250, 400), (400, 250))
FEED_BUCKETS = {"256x256", "160x256", "256x160"}
FEED_ROWS, FEED_JITTER, FEED_MAX_RES = 75, 4, 256
FEED_BATCH = 8
FEED_LOADER_BATCHES = 30   # batches each loader delivers alone
FEED_SLOT_MB = 8           # a ring slot: one 256px batch of 8 in fp32
FEED_CLI_STEPS = 6         # the CLI run: 6 optimizer steps, accumulation 2
POLICY_STEPS = 2           # timed steps of each policy run, after one
FEED_STEPS = 2             # timed steps of each feed, after two
# The eight policy x layout runs take one encoded group and one noise draw
# from the same seeded weights; every recompute repeats the same kernels
# and GEMMs on the same bits, so their first steps' loss and gradient norm
# are expected bit for bit; the limit is 1e-6 relative, and a run whose
# noise differs in one sample must exceed it (the control).
POLICY_REL = 1e-6
POLICIES = ("nothing", "dots", "attn", "dots_attn")


def feed_dataset(root, card):
    """Phase 14.1: the raw folder written from a seed, then
    filter_dataset -> create_phase -> create_indices through their main().
    Returns (phase folder, bucket index, an index of the 256x256 bucket
    alone, the summary)."""
    import io
    import numpy as np
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image
    from sd3_torch.data import create_indices, create_phase, filter_dataset

    r = np.random.default_rng(14)
    subjects = ("red fox", "blue house", "old oak tree", "small boat",
                "white cat", "stone bridge")
    places = ("on a hill", "by the sea", "in a forest", "under a cloudy sky",
              "at dawn", "in the snow")

    def png(h, w):
        small = (r.random((h // 16 + 2, w // 16 + 2, 3)) * 255).astype(
            np.uint8)
        im = Image.fromarray(small).resize((w, h), Image.Resampling.BICUBIC)
        buf = io.BytesIO()
        im.save(buf, format="PNG", compress_level=1)
        return buf.getvalue()

    raw = os.path.join(root, "raw")
    os.makedirs(raw, exist_ok=True)
    t0 = time.time()
    for f in range(2):
        rows = []
        for i in range(FEED_ROWS):
            h, w = FEED_FAMILIES[(i + f) % 3]
            dh, dw = (int(v) for v in r.integers(-FEED_JITTER,
                                                 FEED_JITTER + 1, 2))
            subj = subjects[int(r.integers(len(subjects)))]
            place = places[int(r.integers(len(places)))]
            rows.append({"image": {"bytes": png(h + dh, w + dw),
                                   "path": None},
                         "recaption": f"The image shows a {subj} {place}, "
                                      f"seen from afar.",
                         "recaption_short": f"a {subj} {place}"})
        rows.append({"image": {"bytes": png(100, 90), "path": None},
                     "recaption": "a low-resolution image, dropped",
                     "recaption_short": "low resolution"})
        rows.append({"image": {"bytes": b"not an image", "path": None},
                     "recaption": "an undecodable image, dropped",
                     "recaption_short": "undecodable"})
        pq.write_table(pa.Table.from_pylist(rows),
                       os.path.join(raw, f"part{f}.parquet"))
    make_s = time.time() - t0
    filt, phase = os.path.join(root, "filtered"), os.path.join(root, "phase")
    idx = os.path.join(root, "buckets.npy")
    t0 = time.time()
    with contextlib.redirect_stdout(io.StringIO()):
        filter_dataset.main(["--input_dir", raw, "--output_dir", filt])
        create_phase.main(["--input_dir", filt, "--output_dir", phase,
                           "--max_resolution", str(FEED_MAX_RES)])
        buckets = create_indices.main(["--data_parquet_folder", phase,
                                       "--bucket_indices_path", idx])
    counts = {k: len(v) for k, v in sorted(buckets.items())}
    res = dict(raw_rows=2 * (FEED_ROWS + 2),
               rows_kept=sum(counts.values()), buckets=counts,
               make_s=make_s, prep_s=time.time() - t0, card=card)
    print("  dataset", json.dumps(res), flush=True)
    require(res["rows_kept"] == 2 * FEED_ROWS, f"the filter kept "
            f"{res['rows_kept']} rows, expected {2 * FEED_ROWS}")
    require(set(counts) == FEED_BUCKETS, f"buckets {sorted(counts)}, "
            f"expected {sorted(FEED_BUCKETS)}")
    square = os.path.join(root, "buckets_256x256.npy")
    np.save(square, {"256x256": buckets["256x256"]})
    return phase, idx, square, res


def phase_loaders(phase, card):
    """Phase 14.2: HostDataLoader (2 threads) and RingDataLoader (2
    worker processes) alone over FEED_LOADER_BATCHES batches of FEED_BATCH;
    the ring's stream must equal the threads' (bucket, captions, images bit
    for bit)."""
    import numpy as np
    from sd3_torch.data.pipeline import HostDataLoader, ParquetImageText
    from sd3_torch.data.ringbuffer import RingDataLoader

    out, streams = {}, {}
    for name in ("threads", "ring"):
        t0 = time.time()
        loader = (HostDataLoader(ParquetImageText(phase), FEED_BATCH, seed=5,
                                 num_threads=2) if name == "threads" else
                  RingDataLoader(phase, FEED_BATCH, num_workers=2, seed=5,
                                 slot_mb=FEED_SLOT_MB, num_slots=4))
        try:
            got = [next(loader)]
            t1 = time.time()
            got += [next(loader) for _ in range(FEED_LOADER_BATCHES - 1)]
            t2 = time.time()
        finally:
            loader.close()
        streams[name] = got
        rate = (FEED_LOADER_BATCHES - 1) / (t2 - t1)
        out[name] = dict(first_batch_s=t1 - t0, total_s=t2 - t0,
                         batches_per_s=rate, images_per_s=rate * FEED_BATCH,
                         card=card)
        print(f"  loader {name}", json.dumps(out[name]), flush=True)
    for i, (a, b) in enumerate(zip(streams["threads"], streams["ring"])):
        require(a["bucket"] == b["bucket"] and a["caption"] == b["caption"]
                and np.array_equal(a["image"], b["image"]),
                f"batch {i}: the ring's stream differs from the threads'")
    out["buckets_seen"] = sorted({b["bucket"] for b in streams["ring"]})
    print(f"  the ring's {FEED_LOADER_BATCHES} batches equal the threads' "
          f"(buckets {out['buckets_seen']})", flush=True)
    return out


def phase_feed_cli(phase, idx, root, card):
    """Phase 14.3: train.main at the published widths (CLI_BLOCKS blocks)
    from the phase folder: stub encoders, batch 8, accumulation 2,
    FEED_CLI_STEPS steps, 2 ring workers, 1 group prefetched, fused
    optimizer, remat policy "attn", the scan layout. Each step must launch
    K5, K6a and K6b twice a block and K1-K4 none; at least two bucket shapes must occur; the
    saved model artifact must load strict into an unrolled MMDiT and equal
    the trainer's parameters."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.training import checkpoint as tck
    from sd3_torch.training import train as train_cli
    from sd3_torch.training.trainer import Trainer
    from sd3_torch.weights import state_dict_from_jax

    save = os.path.join(root, "feed_run")
    require_disk(save)
    steps = []
    step_fn = Trainer.train_step

    def counted(self, batch, noise=None):
        reset_launches()
        m = step_fn(self, batch, noise)
        steps.append((tuple(batch["x0"].shape), launch_counts(), m["loss"]))
        return m

    t0 = time.time()
    with patched(Trainer, "train_step", counted), cli_depth():
        tr = train_cli.main([
            "--preset", "published", "--stage_res", str(FEED_MAX_RES),
            "--data_parquet_folder", phase, "--bucket_indices_path", idx,
            "--stub_encoders", "--batchSize", str(FEED_BATCH),
            "--accumulation_steps", "2", "--totalSteps",
            str(FEED_CLI_STEPS), "--ring_workers", "2",
            "--prefetch_batches", "1", "--fused_optimizer", "--remat_policy",
            "attn", "--scan_blocks", "--saveDir", save])
    run_s = time.time() - t0
    nb = tr.cfg.num_blocks
    expect = dict(flash_attention_fwd=2 * nb, flash_attention_dq=2 * nb,
                  flash_attention_dkv=2 * nb, fused_attention_bf16=0,
                  fused_attention_int8qk=0,
                  **block_tail_launches(nb, 1, False, False))
    require(len(steps) == FEED_CLI_STEPS and tr.step == FEED_CLI_STEPS,
            f"the CLI ran {len(steps)} steps, expected {FEED_CLI_STEPS}")
    for i, (shape, launches, _) in enumerate(steps):
        for name, n in expect.items():
            require(launches[name] == n, f"step {i + 1}: {name} launched "
                    f"{launches[name]} times, expected {n}")
    losses = [float(m) for _, _, m in steps]
    shapes = [s for s, _, _ in steps]
    require(all(map(math.isfinite, losses)), f"CLI losses {losses}")
    require(len(set(shapes)) >= 2, f"one bucket shape only: {shapes}")
    require(tr.model.num_scan == nb - 1, "the CLI's model is not stacked")
    t1 = time.time()
    sd = state_dict_from_jax(tck.load_artifact(
        save, f"model_{FEED_CLI_STEPS}s.msgpack"), tr.cfg.patch_size)
    load_s = time.time() - t1
    pub = published_config(FEED_MAX_RES)
    require((tr.cfg.dim, tr.cfg.num_heads, nb) == (pub.dim, pub.num_heads,
                                                   CLI_BLOCKS),
            f"the CLI's model: dim {tr.cfg.dim}, {tr.cfg.num_heads} heads, "
            f"{nb} blocks")
    unrolled = MMDiT(tr.cfg, device="meta", fused_attn=False)
    unrolled.load_state_dict(sd, strict=True, assign=True)
    for name in ("blocks.0.attn.query_proj_x.weight",
                 f"blocks.{nb - 2}.MLP_c.MLP.w3.weight",
                 f"blocks.{nb - 1}.y_proj.0.weight", "out_proj.weight"):
        require(torch.equal(sd[name], tr.params[name].cpu()),
                f"the saved {name} is not the trainer's")
    res = dict(steps=FEED_CLI_STEPS, shapes=[list(s) for s in shapes],
               losses=losses, launches_per_step={
                   k: steps[-1][1][k] for k in ("flash_attention_fwd",
                                                "flash_attention_dq",
                                                "flash_attention_dkv")},
               run_s=run_s, artifact_load_s=load_s, card=card)
    print("  train CLI", json.dumps(res), flush=True)
    del tr, sd, unrolled
    shutil.rmtree(save, ignore_errors=True)
    return res


def feed_train_config(**kw):
    """Phase 11's training configuration (fused low-mem AdamW, bf16
    gradients, precast weights, remat) at batch FEED_BATCH."""
    import dataclasses
    from sd3_torch.config import published_config
    _, tc = train_slice_config()
    return published_config(stage_res=FEED_MAX_RES), dataclasses.replace(
        tc, batch_size=FEED_BATCH, **kw)


def saved_ops_per_policy():
    """The ops each policy keeps in one block of the published widths at
    the 256x256 bucket's token counts, batch 8, bf16 (what a recording copy
    of the policy marks MUST_SAVE in the forward)."""
    import functools
    import torch
    from torch.utils.checkpoint import create_selective_checkpoint_contexts
    from sd3_torch.config import published_config
    from sd3_torch.models import mmdit

    cfg = published_config(stage_res=FEED_MAX_RES)
    blk = mmdit.DualStreamBlock(cfg, 0, fused_attn=False, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    kw = dict(device="cuda", generator=g, dtype=torch.bfloat16)
    x = torch.randn(FEED_BATCH, 256, cfg.dim, **kw).requires_grad_()
    c = torch.randn(FEED_BATCH, cfg.text_tokens, cfg.dim, **kw)
    y = torch.randn(FEED_BATCH, cfg.dim, **kw)
    out = {}
    for pol in POLICIES:
        keep, ops = mmdit.remat_saved_ops(pol), {}

        def record(ctx, op, *a, **k):
            if op in keep and not ctx.is_recompute:
                ops[str(op)] = ops.get(str(op), 0) + 1
            return mmdit._keep(keep, ctx, op, *a, **k)
        xo, co = torch.utils.checkpoint.checkpoint(
            blk, x, c, y, (16, 16), use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         record))
        (xo.float().sum() + co.float().sum()).backward()
        out[pol] = ops
    torch.cuda.synchronize()
    n_linear = sum(isinstance(m, torch.nn.Linear) for m in blk.modules())
    require(sum(out["dots"].values()) == n_linear, f"'dots' kept "
            f"{out['dots']}, expected the {n_linear} projections' products")
    require(out["attn"] == {"sd3_torch.flash_fwd.default": 1},
            f"'attn' kept {out['attn']}")
    return out


def phase_policies(phase, square, card, log_dir):
    """Phase 14.4: one encoded group of the 256x256 bucket (batch 8,
    accumulation 1) and one noise draw through Trainer.train_step under
    each remat policy, unrolled and in the scan layout, from the same
    seeded weights: the first step's loss and gradient norm (all within
    POLICY_REL of "nothing" unrolled; a control with one sample's noise
    changed must not be), then the median of POLICY_STEPS steps, the peak
    memory over them (the optimizer's pass included) and over one forward
    and backward alone (Trainer.gradients), the card's busy ms of one
    more step (under torch.profiler) and each step's K5 / K6a / K6b
    launches."""
    import dataclasses
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sd3_torch.data.encoded import encoded_batch_iter, resolve_encoders
    from sd3_torch.training.optim import global_norm_f32
    from sd3_torch.training.trainer import Trainer, draw_noise

    saved = saved_ops_per_policy()
    print("  ops kept per block", json.dumps(saved), flush=True)
    cfg, tc = feed_train_config(accumulation_steps=1)
    enc = resolve_encoders(cfg, stub=True, device="cuda")
    it = encoded_batch_iter(cfg, tc, phase, square, encoders=enc, seed=3,
                            num_threads=1)
    batch = next(it)
    it.close()
    require(tuple(batch["x0"].shape) == (1, FEED_BATCH, cfg.inCh, 32, 32),
            f"the policy group's x0 is {tuple(batch['x0'].shape)}")
    noise = [draw_noise(torch.Generator(device="cuda").manual_seed(4),
                        batch["x0"][0], tc)]
    eps = noise[0].eps.clone()
    eps[0] = -eps[0]
    control = [noise[0]._replace(eps=eps)]
    nb = cfg.num_blocks
    out, ref = {}, None
    for scan in (False, True):
        for pol in POLICIES:
            gc.collect()
            torch.cuda.empty_cache()
            t0 = time.time()
            tr = Trainer(cfg, dataclasses.replace(tc, remat_policy=pol,
                                                  scan_blocks=scan),
                         device="cuda", log_dir=log_dir, use_wandb=False)
            build_s = time.time() - t0
            k5 = 2 * nb if pol in ("nothing", "dots") else nb
            expect = dict(flash_attention_fwd=k5, flash_attention_dq=nb,
                          flash_attention_dkv=nb, fused_attention_bf16=0)
            row = dict(scan=scan, build_s=build_s, card=card)
            if ref is None:
                g, m = tr.gradients(batch, control)
                row["control"] = (m["loss"].item(),
                                  global_norm_f32(g).item())
                del g

            def step():
                reset_launches()
                t0 = time.time()
                m = tr.train_step(batch, noise)
                loss, gnorm = m["loss"].item(), m["grad_norm"].item()
                dt = time.time() - t0
                launches = launch_counts()
                for name, n in expect.items():
                    require(launches[name] == n, f"{pol} (scan {scan}): "
                            f"{name} launched {launches[name]} times in a "
                            f"step, expected {n}")
                return dt, loss, gnorm
            _, row["loss"], row["grad_norm"] = step()
            torch.cuda.reset_peak_memory_stats()
            times = [step()[0] for _ in range(POLICY_STEPS)]
            row.update(step_s=times, median_s=statistics.median(times),
                       peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                       launches_per_step={k: launch_counts()[k]
                                          for k in list(expect)[:3]})
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            row["held_gb"] = torch.cuda.memory_allocated() / 1e9
            tr.gradients(batch, noise)
            torch.cuda.synchronize()
            row["fwd_bwd_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                tr.train_step(batch, noise)
                torch.cuda.synchronize()
            row["device_busy_ms"] = sum(
                us for us, _ in device_rows(prof).values()) / 1e3
            if ref is None:
                ref = row
            row["loss_rel_diff"] = abs(row["loss"] / ref["loss"] - 1)
            row["grad_norm_rel_diff"] = abs(row["grad_norm"]
                                            / ref["grad_norm"] - 1)
            label = f"{pol}{' scan' if scan else ''}"
            out[label] = row
            print(f"  policy {label}", json.dumps(row), flush=True)
            del tr
    worst = max(max(r["loss_rel_diff"], r["grad_norm_rel_diff"])
                for r in out.values())
    c_loss, c_gnorm = ref["control"]
    ctl = max(abs(c_loss / ref["loss"] - 1), abs(c_gnorm / ref["grad_norm"]
                                                  - 1))
    print(f"  policies x layouts: largest relative difference {worst} "
          f"(limit {POLICY_REL}); control (one sample's noise changed) "
          f"{ctl}", flush=True)
    require(worst <= POLICY_REL, f"the policy runs differ by {worst}")
    require(ctl > POLICY_REL, f"the control differs by {ctl} only: the "
            f"limit {POLICY_REL} would pass it")
    gc.collect()
    torch.cuda.empty_cache()
    return dict(runs=out, largest_rel_diff=worst, control_rel_diff=ctl,
                saved_ops=saved)


def phase_feed(phase, square, card, log_dir):
    """Phase 14.5: phase 11's training configuration at 256px, batch 8,
    accumulation 2, fed three ways behind prefetch_iterator(depth 1,
    map_fn=shard_batch): synthetic_batch_iter, encoded_batch_iter on 2
    threads, and on 2 ring workers (stub encoders, the 256x256 bucket
    alone, so every step has the synthetic one's shape). Two warmup steps,
    then the median of FEED_STEPS, then one step under torch.profiler for
    the card's busy time and idle share. Then vae_encode of the
    real-architecture FLUX VAE (seeded, bf16) at each bucket's shape at
    batch 8: the card cost of real encoding between steps."""
    import gc
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sd3_torch.data.encoded import (encoded_batch_iter, prefetch_iterator,
                                        resolve_encoders)
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.trainer import Trainer

    cfg, tc = feed_train_config(accumulation_steps=2)
    tr = Trainer(cfg, tc, device="cuda", log_dir=log_dir, use_wandb=False)
    enc = resolve_encoders(cfg, stub=True, device="cuda")
    sources = {
        "synthetic": lambda: synthetic_batch_iter(
            cfg, FEED_BATCH, 2, FEED_MAX_RES, FEED_MAX_RES, seed=1),
        "threads": lambda: encoded_batch_iter(
            cfg, tc, phase, square, encoders=enc, seed=1, num_threads=2),
        "ring": lambda: encoded_batch_iter(
            cfg, tc, phase, square, encoders=enc, seed=1, ring_workers=2)}
    out = {}
    for name, make in sources.items():
        it = prefetch_iterator(make(), depth=1, map_fn=tr.shard_batch)

        def step():
            t0 = time.time()
            loss = tr.train_step(tr.shard_batch(next(it)))["loss"].item()
            require(math.isfinite(loss), f"{name}: loss {loss}")
            return time.time() - t0
        try:
            warm = [step() for _ in range(2)]
            times = [step() for _ in range(FEED_STEPS)]
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                traced_s = step()
        finally:
            it.close()
        med = statistics.median(times)
        trace = device_breakdown(prof, traced_s)
        out[name] = dict(warmup_s=warm, step_s=times, median_s_per_step=med,
                         device_busy_ms=trace["device_busy_ms"],
                         idle_share_traced=trace["idle_share"],
                         idle_share=1 - trace["device_busy_ms"] / (med * 1e3),
                         card=card)
        print(f"  feed {name}", json.dumps(out[name]), flush=True)
    for name in ("threads", "ring"):
        out[f"{name}_minus_synthetic_s"] = (out[name]["median_s_per_step"]
                                           - out["synthetic"]
                                           ["median_s_per_step"])
    del tr
    gc.collect()
    torch.cuda.empty_cache()

    # the real-architecture VAE's encode at each bucket's shape
    from sd3_torch.models.clip_text import ClipTextConfig
    from sd3_torch.models.encoder_suite import RealTextEncoders
    from sd3_torch.models.gemma2 import Gemma2Config
    from sd3_torch.models.modernbert import ModernBertConfig
    torch.manual_seed(0)
    suite = RealTextEncoders.build(  # the FLUX VAE at its size; towers tiny
        "cuda", gemma_cfg=Gemma2Config.tiny(),
        bert_cfg=ModernBertConfig.tiny(), clip_cfg=ClipTextConfig.tiny())
    g = torch.Generator(device="cuda").manual_seed(5)
    vae = {}
    for bucket in sorted(FEED_BUCKETS):
        h, w = (int(v) for v in bucket.split("x"))
        im = torch.rand((FEED_BATCH, 3, h, w), device="cuda") * 2 - 1
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        ms = cuda_ms(lambda: suite.vae_encode(im, g), iters=1, groups=3,
                     graph=False)
        z = suite.vae_encode(im, g)
        require(tuple(z.shape) == (FEED_BATCH, 16, h // 8, w // 8)
                and bool(torch.isfinite(z).all()),
                f"vae_encode at {bucket}: {tuple(z.shape)}")
        vae[bucket] = dict(ms=ms, per_step_ms=2 * ms,
                           peak_gb=(torch.cuda.max_memory_allocated()
                                    - base) / 1e9, card=card)
        print(f"  vae_encode {bucket} B={FEED_BATCH}", json.dumps(vae[bucket]),
              flush=True)
    out["vae_encode"] = vae
    del suite
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_data_feed(card, root, log_dir):
    """Phase 14: the dataset, the loaders alone, the train CLI from it, the
    remat policies and layouts, the feed against synthetic batches."""
    t0 = time.time()
    spent = {}

    def mark(part):
        spent[part] = time.time() - t0 - sum(spent.values())
    phase, idx, square, data = feed_dataset(os.path.join(root, "data"), card)
    mark("dataset")
    loaders = phase_loaders(phase, card)
    mark("loaders")
    cli = phase_feed_cli(phase, idx, root, card)
    mark("train CLI")
    policies = phase_policies(phase, square, card, log_dir)
    mark("policies")
    feed = phase_feed(phase, square, card, log_dir)
    mark("feed")
    print("  phase 14 seconds", json.dumps(dict(spent, card=card)),
          flush=True)
    return dict(data=data, loaders=loaders, cli=cli, policies=policies,
                feed=feed, seconds=spent)


# ---- phases 15-16: the model variants off the published config ----------

# the reference's old checkpoints: the absolute sin-cos PE and the flat
# SwiGLU (`MLP_type` absent from their params JSON means swiglu_old)
OLD_LAYOUT = dict(positional_encoding="absolute", MLP_type="swiglu_old")
OLD_STEPS = 2        # Euler steps of each infer CLI call of phase 15
VARIANT_STEPS = 3    # Euler steps of each variant's sampling call
VARIANT_BATCH = 2
# (label, config fields, the kernel the forward launches once a block or
# None, the control's config fields: a configuration of the same parameter
# tree, up to RMSNorm weights at their initial ones, whose CPU result the
# card's must NOT match within the check's limit). The fused path takes
# RoPE1d's tables (K1); RoPE2dV2 and kv_merge take the general path's flash
# attention (K5; kv_merge at M = N / 2); the other attention types run no
# kernel, as they run none in the JAX package. Each is held in bf16 (phase
# 4's MODEL_REL_L2) but silu, held in fp32 (FP32_MODEL_REL_L2, TF32 off):
# its linear attention divides by q . sum(k), a sum of terms of both signs
# that nears zero on some rows, which then carry bf16's rounding of the
# terms many times over and set the output's norm (CPU bf16 against fp32
# at head dim 32: rel L2 6.5e-2); fp32 holds the port's arithmetic there
FP32_CHECKED = ("silu",)
SAMPLE_VARIANTS = [
    ("RoPE1d", dict(positional_encoding="RoPE"), "fused_attention_bf16",
     dict(positional_encoding="RoPE2d")),
    ("RoPE2dV2", dict(positional_encoding="RoPE2dV2"), "flash_attention_fwd",
     dict(positional_encoding="RoPE2d")),
    ("kv_merge", dict(kv_merge_attn=True), "flash_attention_fwd",
     dict(kv_merge_attn=False)),
    ("cosine", dict(attn_type="cosine"), None, dict(attn_type="cosine2")),
    ("cosine2", dict(attn_type="cosine2"), None, dict(attn_type="cosine3")),
    ("cosine3", dict(attn_type="cosine3"), None, dict(attn_type="cosine4")),
    ("cosine4", dict(attn_type="cosine4"), None,
     dict(attn_type="cosine_norm")),
    ("cosine_norm", dict(attn_type="cosine_norm"), None,
     dict(attn_type="cosine2")),
    ("relu", dict(attn_type="relu"), None, dict(attn_type="silu")),
    ("silu", dict(attn_type="silu"), None, dict(attn_type="exp")),
    ("exp", dict(attn_type="exp"), None, dict(attn_type="relu")),
    ("both", dict(attn_type="both"), None, dict(attn_type="softmax")),
    ("old layout", OLD_LAYOUT, "fused_attention_bf16",
     dict(positional_encoding="NoPE")),
]
# (label, config fields, TrainConfig fields, the control's config fields,
# the control's TrainConfig fields, flash launches a step, blocks of the
# 2-block check: 3 for the pair scan, whose 2 blocks would scan none)
TRAIN_VARIANTS = [
    ("text_loss", dict(text_loss=True), dict(text_loss_weight=0.1), {},
     dict(text_loss_weight=1.0), True, 2),
    ("kv_merge", dict(kv_merge_attn=True), {}, dict(kv_merge_attn=False), {},
     True, 2),
    ("both scan", dict(attn_type="both"), dict(scan_blocks=True),
     dict(attn_type="softmax"), {}, False, 3),
]
VARIANT_TRAIN_RES, VARIANT_TRAIN_BATCH, VARIANT_TRAIN_STEPS = 256, 4, 2


def _load_loose(model, sd):
    """Load `sd` into `model` (a control of another variant): the keys it
    lacks must be RMSNorm weights, which stay at their initial ones."""
    missing, _ = model.load_state_dict(sd, strict=False)
    require(all(re.search(r"norm_[xc]?\.?weight$|norm\.weight$", k)
                for k in missing), f"the control lacks weights {missing}")
    return model


def variant_model_check(label, fields, control, seed=0):
    """A variant's published widths at 2 blocks, 512px, batch 1, on the card
    in bf16 (FP32_CHECKED: fp32) against the same weights in fp32 on the
    CPU (rel L2 within phase 4's MODEL_REL_L2, FP32_MODEL_REL_L2); the
    control's CPU result on the same weights must miss that limit."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT

    cfg = published_config(stage_res=512).replace(num_blocks=2, **fields)
    ref = MMDiT(cfg.replace(dtype="float32"), device="cpu").init_weights(
        torch.Generator().manual_seed(seed)).eval()
    ctl = _load_loose(MMDiT(cfg.replace(dtype="float32", **control),
                            device="cpu").eval(), ref.state_dict())
    g = torch.Generator().manual_seed(seed + 1)
    args = (torch.randn((1, cfg.inCh, 64, 64), generator=g),
            torch.rand((1,), generator=g),
            torch.randn((1, cfg.text_tokens, cfg.text_hidden_dim), generator=g),
            torch.randn((1, cfg.class_dim), generator=g))
    fp32 = label in FP32_CHECKED
    limit = FP32_MODEL_REL_L2 if fp32 else MODEL_REL_L2
    dut = MMDiT(cfg.replace(dtype="float32") if fp32 else cfg, device="cuda")
    dut.load_state_dict(ref.state_dict(), strict=True)
    if not fp32:
        dut.cast_params(torch.bfloat16)
    dut.eval()
    with torch.inference_mode():
        want, other = ref(*args), ctl(*args)
        got = dut(*(a.cuda() for a in args)).cpu()
    require(bool(torch.isfinite(got).all()), f"{label}: 2-block output "
            "non-finite")
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    res = dict(dtype="float32" if fp32 else "bfloat16", limit=limit,
               rel_l2=rel(got, want), control_rel_l2=rel(got, other))
    require(res["rel_l2"] <= limit, f"{label}: 2-block model rel L2 "
            f"{res['rel_l2']} > {limit}")
    require(res["control_rel_l2"] > limit, f"{label}: the control "
            f"{control} passes the 2-block check (rel L2 "
            f"{res['control_rel_l2']})")
    return res


def phase_sample_variants(card):
    """Phase 16.1: each of SAMPLE_VARIANTS held at 2 blocks against the CPU
    (variant_model_check), then the 19-block published-width model with
    seeded bf16 weights sampled at 512px, batch 2, VARIANT_STEPS Euler
    steps, CFG 5, stub encoders: one warmup call of one step, one timed
    call, one traced call (the card's busy ms, the idle share); the
    attention kernel launched once a block and step, no other kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sd3_torch.config import published_config
    from sd3_torch.inference.sampler import sample_imgs
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.models.text_encoders import StubTextEncoders

    enc = StubTextEncoders(device="cuda")
    out = {}
    for label, fields, kern, control in SAMPLE_VARIANTS:
        check = variant_model_check(label, fields, control)
        cfg = published_config(stage_res=512).replace(**fields)
        model = MMDiT(cfg, device="cuda", dtype=torch.bfloat16).init_weights(
            torch.Generator(device="cuda").manual_seed(0)).eval()
        nb = cfg.num_blocks

        def run(steps):
            reset_launches()
            t0 = time.time()
            lat = sample_imgs(model, enc, VARIANT_BATCH, steps,
                              "a red fox in the snow", cfg_scale=5.0,
                              width=512, height=512, sampler="euler",
                              generator=torch.Generator().manual_seed(1),
                              decode=False)
            torch.cuda.synchronize()
            return lat, time.time() - t0, launch_counts()

        run(1)
        lat, call_s, launches = run(VARIANT_STEPS)
        require(bool(torch.isfinite(lat).all()) and tuple(lat.shape) == (
            VARIANT_BATCH, cfg.inCh, 64, 64), f"{label}: sampled latents "
            f"{tuple(lat.shape)} or non-finite")
        expect = {k: 0 for k in launches}
        if kern:
            expect[kern] = nb * VARIANT_STEPS
        for name, n in expect.items():
            require(launches[name] == n, f"{name} launched {launches[name]} "
                    f"times in one {label} sample call, expected {n}")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced_s = run(VARIANT_STEPS)[1]
        tr = device_breakdown(prof, traced_s)
        res = dict(variant=label, fields=fields, batch=VARIANT_BATCH,
                   steps=VARIANT_STEPS, call_s=call_s,
                   s_per_step=call_s / VARIANT_STEPS,
                   launches={k: v for k, v in launches.items() if v},
                   device_busy_ms=tr["device_busy_ms"],
                   idle_share_untraced=1 - tr["device_busy_ms"]
                   / (call_s * 1e3),
                   by_family_ms={k: v for k, v in tr["by_family_ms"].items()
                                 if v}, two_block=check, card=card)
        print("  variant sample", json.dumps(res), flush=True)
        out[label] = res
        del model
        torch.cuda.empty_cache()
    return out


def variant_step_check(label, fields, tfields, control, tcontrol, flash,
                       blocks, log_dir):
    """One training step's gradients of a variant at `blocks` blocks of the
    published widths, 256px, batch 2, on the card in bf16 with phase 11's
    flags against the same weights and noise in fp32 on the CPU (phase 4's
    training limits); the control's CPU gradients (its config or its
    TrainConfig on the same weights) must miss the gradient limit."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.training.trainer import TrainConfig, Trainer, draw_noise

    cfg = published_config(stage_res=256).replace(num_blocks=blocks,
                                                  **fields)
    kw = dict(batch_size=2, accumulation_steps=1, lr=1e-4, warmup_steps=0,
              low_mem_optimizer=True, fused_optimizer=True, track_ema=False,
              remat_blocks=True, **tfields)
    mk = lambda c, dev, **t: Trainer(c, TrainConfig(**{**kw, **t}),
                                     device=dev, log_dir=log_dir,
                                     use_wandb=False)
    ref = mk(cfg.replace(dtype="float32"), "cpu", scan_blocks=False)
    p0 = {k: v.detach().clone() for k, v in ref.params.items()}
    ctl = mk(cfg.replace(dtype="float32", **control), "cpu", scan_blocks=False,
             **tcontrol)
    _load_loose(ctl.model, p0)
    dut = Trainer(cfg, TrainConfig(**kw, bf16_grads=True,
                                   precast_params=True),
                  params=p0, device="cuda", log_dir=log_dir, use_wandb=False)
    g = torch.Generator().manual_seed(2)
    lat = 256 // 8
    batch = {"x0": torch.randn((1, 2, cfg.inCh, lat, lat), generator=g),
             "text": torch.randn((1, 2, cfg.text_tokens, cfg.text_hidden_dim),
                                 generator=g),
             "pooled": torch.randn((1, 2, cfg.class_dim), generator=g)}
    noise = draw_noise(g, batch["x0"][0], ref.tcfg,
                       text_shape=batch["text"].shape[1:3])
    # one sample with each null flag set, so the text mask applies
    noise = noise._replace(null_pooled=torch.tensor([False, True]),
                           null_gemma=torch.tensor([True, False]),
                           null_bert=torch.tensor([False, True]))
    want_g, want_m = ref.gradients(batch, [noise])
    ctl_g, _ = ctl.gradients(batch, [noise])
    reset_launches()
    got_g, got_m = dut.gradients(dut.shard_batch(batch),
                                 [noise.to("cuda")])
    torch.cuda.synchronize()
    launches = launch_counts()
    require(all(bool(torch.isfinite(t).all()) for t in got_g.values()),
            f"{label}: training gradients non-finite on the card")
    res = dict(variant=label, blocks=blocks,
               loss_card=got_m["loss"].item(),
               loss_cpu_fp32=want_m["loss"].item(),
               grad_rel_l2=_flat_rel_l2(got_g, want_g),
               control_grad_rel_l2=_flat_rel_l2(got_g, {
                   k: ctl_g[k] for k in want_g if k in ctl_g}),
               metrics={k: v.item() for k, v in got_m.items()},
               launches={k: v for k, v in launches.items() if v})
    res["loss_rel"] = abs(res["loss_card"] / res["loss_cpu_fp32"] - 1)
    nflash = {"flash_attention_fwd": 2 * blocks, "flash_attention_dq": blocks,
              "flash_attention_dkv": blocks}
    for name, n in nflash.items():
        require(launches[name] == (n if flash else 0), f"{label}: {name} "
                f"launched {launches[name]} times in a {blocks}-block step")
    require(res["loss_rel"] <= TRAIN_LOSS_REL, f"{label}: training loss "
            f"{res['loss_card']} vs fp32 {res['loss_cpu_fp32']}")
    require(res["grad_rel_l2"] <= TRAIN_GRAD_REL_L2, f"{label}: gradients "
            f"rel L2 {res['grad_rel_l2']} > {TRAIN_GRAD_REL_L2}")
    require(res["control_grad_rel_l2"] > TRAIN_GRAD_REL_L2, f"{label}: the "
            f"control {control or tcontrol} passes the gradient check "
            f"({res['control_grad_rel_l2']})")
    return res


def phase_train_variants(card, log_dir):
    """Phase 16.2: each of TRAIN_VARIANTS held at 2 (3) blocks against the
    CPU (variant_step_check), then Trainer.train_step of the 19-block model
    with phase 11's flags at 256px, batch 4: a warmup step, then
    VARIANT_TRAIN_STEPS timed steps (the first loss and grad norm, s a
    step) and one traced (the card's busy ms); K5 38, K6a 19, K6b 19 a
    step on the flash variants, none on "both"."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.trainer import Trainer

    out = {}
    for label, fields, tfields, control, tcontrol, flash, blocks in \
            TRAIN_VARIANTS:
        check = variant_step_check(label, fields, tfields, control, tcontrol,
                                   flash, blocks, log_dir)
        cfg, tc = train_slice_config()
        cfg = cfg.replace(max_res=VARIANT_TRAIN_RES, **fields)
        tc = dataclasses.replace(tc, batch_size=VARIANT_TRAIN_BATCH,
                                 **tfields)
        trainer = Trainer(cfg, tc, device="cuda", log_dir=log_dir,
                          use_wandb=False)
        batch = trainer.shard_batch(next(synthetic_batch_iter(
            cfg, VARIANT_TRAIN_BATCH, 1, VARIANT_TRAIN_RES,
            VARIANT_TRAIN_RES)))
        nb = cfg.num_blocks

        def step():
            reset_launches()
            t0 = time.time()
            m = trainer.train_step(batch)
            m = {k: v.item() for k, v in m.items()}  # synchronises
            return time.time() - t0, m, launch_counts()

        warm_s, first, _ = step()
        runs = [step() for _ in range(VARIANT_TRAIN_STEPS)]
        for _, m, launches in runs:
            require(all(map(math.isfinite, m.values())),
                    f"{label}: metrics {m} non-finite")
            for name, n in (("flash_attention_fwd", 2 * nb),
                            ("flash_attention_dq", nb),
                            ("flash_attention_dkv", nb)):
                require(launches[name] == (n if flash else 0),
                        f"{label}: {name} launched {launches[name]} times "
                        "in a 19-block step")
        if "text_loss" in fields:
            require(set(first) == {"loss", "image_loss", "text_loss",
                                   "grad_norm"}, f"{label}: metrics {first}")
        med = statistics.median(r[0] for r in runs)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            traced_s = step()[0]
        tr = device_breakdown(prof, traced_s)
        res = dict(variant=label, fields=fields, train=tfields,
                   res=VARIANT_TRAIN_RES, batch=VARIANT_TRAIN_BATCH,
                   blocks=nb, scan=trainer.model.num_scan, warmup_s=warm_s,
                   first_metrics=first, step_s=[r[0] for r in runs],
                   median_s_per_step=med, launches_per_step={
                       k: v for k, v in runs[-1][2].items() if v},
                   device_busy_ms=tr["device_busy_ms"],
                   idle_share_untraced=1 - tr["device_busy_ms"] / (med * 1e3),
                   by_family_ms={k: v for k, v in tr["by_family_ms"].items()
                                 if v}, check=check, card=card)
        print("  variant train", json.dumps(res), flush=True)
        out[label] = res
        del trainer
        torch.cuda.empty_cache()
    return out


def phase_reference_layout(card, root):
    """Phase 15: a reference checkpoint of the old layout at the published
    widths (19 blocks, dim 1216, 19 heads; the absolute PE and swiglu_old,
    seeded weights), written as the reference writes it: a torch.save'd
    state_dict with its recomputed `pos_enc.pos_embed` buffer, and a
    model_params JSON with the reference's keys but MLP_type, so swiglu_old
    comes from the back-compat default. Then infer.main --torch_ckpt
    --loadDefFile at 512px, batch 2, OLD_STEPS steps: in bf16 (K1 with
    identity tables: the absolute PE rotates nothing) and with --quant int8
    (K2, K3, K4); images/s and the launches of each call."""
    import numpy as np
    import torch
    from PIL import Image
    from sd3_torch.config import MMDiTConfig, published_config
    from sd3_torch.inference import infer as infer_cli
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.patch import cropped_pos_embed

    require_disk(root)
    d = os.path.join(root, "reference")
    os.makedirs(d, exist_ok=True)
    cfg = published_config(stage_res=512).replace(**OLD_LAYOUT)
    t0 = time.time()
    model = MMDiT(cfg.replace(dtype="float32"), device="cuda").init_weights(
        torch.Generator(device="cuda").manual_seed(3))
    sd = {k: v.cpu() for k, v in model.state_dict().items()}
    del model
    torch.cuda.empty_cache()
    m = cfg.pos_embed_max_size
    sd["pos_enc.pos_embed"] = torch.from_numpy(np.array(
        cropped_pos_embed(cfg.dim, m, m, m, cfg.pos_embed_base_size)))
    torch.save(sd, os.path.join(d, "model_0s.pkl"))
    params = {k: v for k, v in cfg.to_json_dict().items()
              if k in MMDiTConfig._JSON_KEYS and k != "MLP_type"}
    params["device"] = "cpu"
    with open(os.path.join(d, "model_params_0s.json"), "w") as f:
        json.dump(params, f)
    write_s = time.time() - t0
    nbytes = os.path.getsize(os.path.join(d, "model_0s.pkl"))
    del sd
    out = dict(write_s=write_s, checkpoint_bytes=nbytes, card=card)
    nb = cfg.num_blocks
    for label, extra, int8 in (("bf16", [], False),
                               ("int8", ["--quant", "int8"], True)):
        img = os.path.join(d, f"old_{label}")
        reset_launches()
        t0 = time.time()
        infer_cli.main(["--loadDir", d, "--torch_ckpt", "model_0s.pkl",
                        "--loadDefFile", "model_params_0s.json",
                        "--text_input", "a red fox in the snow",
                        "--num_steps", str(OLD_STEPS), "--guidance", "5",
                        "--width", "512", "--height", "512", "--seed", "7",
                        "--batch_size", "2", "--stub_encoders",
                        "--out_imgname", img, *extra])
        torch.cuda.synchronize()
        call_s = time.time() - t0
        launches = launch_counts()
        for i in range(2):
            with Image.open(f"{img}_{i}.png") as im:
                require(im.size == (512, 512), f"old layout {label}: "
                        f"{img}_{i}.png is {im.size}")
        expect = {k: 0 for k in ATTENTION_KERNELS}
        expect[attention_kernel(int8, False, False)] = nb * OLD_STEPS
        expect.update(block_tail_launches(nb, OLD_STEPS, int8, False))
        for name, n in expect.items():
            require(launches[name] == n, f"{name} launched {launches[name]} "
                    f"times in the old-layout {label} infer call, expected "
                    f"{n}")
        out[label] = dict(call_s=call_s, images_per_s=2 / call_s,
                          launches={k: v for k, v in launches.items() if v})
    print("  reference layout", json.dumps(out), flush=True)
    shutil.rmtree(d, ignore_errors=True)
    return out


# ---- phase 16.3: the position tables and swiglu_old past 512px bf16 -------
# Phase 16 holds RoPE1d's tables, none (NoPE) and the absolute PE (which adds
# its table to the tokens and rotates nothing) at 512px in bf16 only (K1).
# Here each at 2 blocks of the published widths, batch 1, through the
# routes past it: K7 (1024px bf16), K4 (512px int8) and K8b (1024px int8
# with int8_pv), on the card in bf16 against the same weights in fp32 on
# the CPU (the int8 routes on the same int8 weights), within phase 4's
# limits (MODEL_REL_L2, INT8_MODEL_REL_L2); and swiglu_old (the flat SwiGLU
# of the old checkpoints) through K2 / K3 at 1024px int8, beside
# swiglu_old with RoPE1d's tables. One seed gives every variant of a route
# the same weights, so a variant's control is the CPU result of the next
# variant of its route: the card's output must miss the limit there.
TABLES = (("RoPE1d", dict(positional_encoding="RoPE")),
          ("NoPE", dict(positional_encoding="NoPE")),
          ("absolute", dict(positional_encoding="absolute")))
TABLE_ROUTES = (
    ("K7, 1024px bf16", 1024, False, False, TABLES),
    ("K4, 512px int8", 512, True, False, TABLES),
    ("K8b, 1024px int8 + int8_pv", 1024, True, True, TABLES),
    ("K2 / K3, 1024px int8", 1024, True, False,
     (("swiglu_old", dict(MLP_type="swiglu_old")),
      ("swiglu_old RoPE1d", dict(MLP_type="swiglu_old",
                                 positional_encoding="RoPE")))))


def route_check(route, res, int8, int8_pv, variants, seed=0):
    """Each of `variants` at 2 blocks of the published widths, `res`, batch
    1, through one route (bf16, or int8 with or without int8_pv) on the
    card against fp32 on the CPU, with its launches; its control the next
    variant's CPU result (see TABLE_ROUTES)."""
    import torch
    from sd3_torch.config import published_config
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.quant import quantize_model

    base = published_config(stage_res=res).replace(num_blocks=2,
                                                   int8_pv=int8_pv)
    g = torch.Generator().manual_seed(seed + 1)
    lat = res // 8
    args = (torch.randn((1, base.inCh, lat, lat), generator=g),
            torch.rand((1,), generator=g),
            torch.randn((1, base.text_tokens, base.text_hidden_dim),
                        generator=g),
            torch.randn((1, base.class_dim), generator=g))
    want, got, launches = {}, {}, {}
    t0 = time.time()
    for label, fields in variants:
        cfg = base.replace(**fields)
        ref = MMDiT(cfg.replace(dtype="float32"), device="cpu").init_weights(
            torch.Generator().manual_seed(seed)).eval()
        if int8:
            quantize_model(ref)
            cfg = ref.cfg.replace(dtype=cfg.dtype)
        dut = MMDiT(cfg, device="cuda")
        dut.load_state_dict(ref.state_dict(), strict=True)
        dut.cast_params(torch.bfloat16).eval()
        with torch.inference_mode():
            want[label] = ref(*args)
            reset_launches()
            got[label] = dut(*(a.cuda() for a in args)).cpu()
        launches[label] = launch_counts()
        del ref, dut
    torch.cuda.empty_cache()
    nb = base.num_blocks
    expect = {k: 0 for k in ATTENTION_KERNELS}
    expect[attention_kernel(int8, int8_pv, res > 512)] = nb
    expect.update(block_tail_launches(nb, 1, int8, False))
    limit = INT8_MODEL_REL_L2 if int8 else MODEL_REL_L2
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()
    labels = [label for label, _ in variants]
    out = dict(route=route, limit=limit, s=time.time() - t0)
    for i, label in enumerate(labels):
        other = labels[(i + 1) % len(labels)]
        require(bool(torch.isfinite(got[label]).all()),
                f"{route} {label}: 2-block output non-finite")
        for name, n in expect.items():
            require(launches[label][name] == n, f"{route} {label}: {name} "
                    f"launched {launches[label][name]} times in a 2-block "
                    f"forward, expected {n}")
        out[label] = dict(rel_l2=rel(got[label], want[label]), control=other,
                          control_rel_l2=rel(got[label], want[other]))
    print("  route", json.dumps(out), flush=True)
    for label in labels:
        r = out[label]
        require(r["rel_l2"] <= limit, f"{route} {label}: 2-block model rel "
                f"L2 {r['rel_l2']} > {limit}")
        require(r["control_rel_l2"] > limit, f"{route} {label}: the control "
                f"({r['control']}'s CPU result) passes the check (rel L2 "
                f"{r['control_rel_l2']})")
    return out


def phase_attention_tables(gen):
    """K7q (the int8-QK^T streaming kernel, which the model never takes)
    through the attention API at the 1024px slice shape, batch 2, with
    RoPE1d's tables and with none (NoPE, and the absolute PE's attention),
    each against the fp32 plain version over K7q's key tiles within
    ATTN_ATOL, phase 3's K7q limit; its control, the plain version with the
    other tables, must miss it."""
    import torch
    from sd3_torch.ops import fused_attention as fa
    from sd3_torch.ops.rope import rope1d_angles

    shape = dict(SLICE_1024, b=2)
    b, nh, d = shape["b"], shape["heads"], shape["d"]
    n_img = shape["h"] * shape["w"]
    n = n_img + shape["n_txt"]
    q, k, v = (torch.randn((b, n, nh * d), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ws = [1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
          for _ in range(4)]
    scale = d ** -0.5
    eps = float(torch.finfo(torch.bfloat16).eps)
    got, want = {}, {}
    for label, angles in (("RoPE1d", rope1d_angles(n_img, d)),
                          ("NoPE", None)):
        reset_launches()
        with torch.inference_mode():
            got[label] = fa.fused_dual_flash_attention(
                q, k, v, nh, *ws, angles, n_img, scale, int8_qk=True)
        torch.cuda.synchronize()
        launches = launch_counts()
        for name in ATTENTION_KERNELS:
            n_want = int(name == "fused_attention_stream_int8qk")
            require(launches[name] == n_want, f"the attention API with "
                    f"{label} tables launched {name} {launches[name]} times")
        cos, sin = (torch.as_tensor(t, device="cuda")
                    for t in fa.rope_row_tables(angles, n, d))
        tables = (*fa.fold_row_tables(cos, sin, ws[0], ws[1], n_img),
                  *fa.fold_row_tables(cos, sin, ws[2], ws[3], n_img))
        want[label] = fa.composition_stream_int8_qk(
            q.float(), k.float(), v.float(), *tables, scale, eps, eps, nh,
            block_k=fa.K7Q_KEY_TILE)
    err = lambda a, b: (a.float() - b).abs().max().item()
    out = {label: dict(max_abs_err=err(got[label], want[label]),
                       control=other,
                       control_max_abs_err=err(got[label], want[other]))
           for label, other in (("RoPE1d", "NoPE"), ("NoPE", "RoPE1d"))}
    print("  K7q tables", json.dumps(dict(shape=shape, limit=ATTN_ATOL,
                                          **out)), flush=True)
    for label, r in out.items():
        require(r["max_abs_err"] <= ATTN_ATOL, f"K7q with {label} tables: "
                f"max abs err {r['max_abs_err']} > {ATTN_ATOL}")
        require(r["control_max_abs_err"] > ATTN_ATOL, f"K7q with {label} "
                f"tables: the control ({r['control']} tables) passes")
    return out


# ---- phase 17: the golden config on the card ------------------------------
# ROADMAP section 3's first check. tests/fixtures/golden_mid.npz holds the
# fp32 torch oracle's 4-step Euler latents (scripts/gen_golden.py: 14
# blocks, dim 640, 10 heads of 64, 128px: 64 image + 154 text tokens, CFG
# 5); its weights are regenerated from their seeds. The port's CPU fp32 path
# must meet the JAX gate (atol 5e-3, rtol 1e-3): the CPU tests show it does
# on the torch they run on, so a miss here says the seeded weights do not
# regenerate on this machine's torch. Then the card's bf16 path (K1 at 218
# tokens) and its int8 path (K1, K2, K3: int8 QK^T is gated to 1024-2048
# padded tokens) against the same latents, rel L2. bf16 itself sets their
# distance: CFG 5 takes 6 v_cond - 5 v_uncond, which multiplies the
# roundings of 14 bf16 blocks, so the first velocity is 0.185 off and the
# latents 0.0955 with the plain versions in bf16 on the CPU of an H100's
# machine (0.0947 int8), and 0.0959 / 0.0963 on the card (PERF.md). Limit 0.13 for both; the
# control, the same model with every matrix of block 7 scaled by
# GOLDEN_CONTROL_SCALE, measured 0.227 / 0.224 there, must miss it. That
# limit leaves a kernel error smaller than the control little to show, so
# the card's latents are also held to the plain versions' in bf16 on the
# CPU (the same weights, noise and quantization), which share bf16's
# roundings: on an H100 the gap measured 0.0102 (bf16) and 0.0172 (int8),
# the control 0.198 / 0.197 (PERF.md). GOLDEN_PLAIN_REL_L2 sits ~2.4x
# above each gap and 8x / 5x under the control.
GOLDEN_GATE = dict(atol=5e-3, rtol=1e-3)
GOLDEN_BF16_REL_L2 = 0.13
GOLDEN_INT8_REL_L2 = 0.13
GOLDEN_PLAIN_REL_L2 = dict(bf16=0.025, int8=0.04)
GOLDEN_CONTROL_SCALE = 1.2


def golden_oracle():
    """scripts/gen_golden.py, loaded from this checkout with its
    `tests.torch_ref.mini_mmdit` import served from here too: the repo's
    `tests` is a namespace package, and a machine may hold a regular
    top-level `tests` package that would win it."""
    import importlib.util
    import types
    here = os.path.dirname(os.path.abspath(__file__))
    saved = sys.modules.get("tests")
    pkg = types.ModuleType("tests")
    pkg.__path__ = [os.path.join(here, "tests")]
    sys.modules["tests"] = pkg
    try:
        spec = importlib.util.spec_from_file_location(
            "gen_golden", os.path.join(here, "scripts", "gen_golden.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        for name in ("tests.torch_ref.mini_mmdit", "tests.torch_ref"):
            sys.modules.pop(name, None)
        if saved is None:
            sys.modules.pop("tests", None)
        else:
            sys.modules["tests"] = saved
    return mod


def phase_golden(card):
    """The golden config: the CPU fp32 path at the JAX gate, then the card's
    bf16 and int8 paths against golden_mid and against the plain versions
    in bf16 on the CPU, with their controls (see GOLDEN_GATE)."""
    import numpy as np
    import torch
    from sd3_torch import torch_dtype
    from sd3_torch.config import tiny_config
    from sd3_torch.inference.sampler import make_velocity_fn, sample_latents
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.quant import quantize_model
    from sd3_torch.weights import load_reference_state_dict

    here = os.path.dirname(os.path.abspath(__file__))
    want = np.load(os.path.join(here, "tests", "fixtures",
                                "golden_mid.npz"))["latents"]
    t0 = time.time()
    oracle = golden_oracle()
    GOLD, GUIDANCE, NUM_STEPS = oracle.GOLD, oracle.GUIDANCE, oracle.NUM_STEPS
    sd = oracle.build_model().state_dict()
    noise, text, pooled = oracle.build_inputs()
    control = {k: v * GOLDEN_CONTROL_SCALE
               if k.startswith("blocks.7.") and v.ndim == 2 else v
               for k, v in sd.items()}

    def sample(weights, device, dtype, int8=False):
        cfg = tiny_config(**{**GOLD, "attn_type": "softmax_flash",
                             "dtype": dtype})
        model = MMDiT(cfg, device="cpu")
        load_reference_state_dict(model, weights)
        if int8:
            quantize_model(model)
        model.cast_params(torch_dtype(dtype)).to(device).eval()
        vel = make_velocity_fn(model, text.to(device), pooled.to(device))
        reset_launches()
        lat = sample_latents(vel, noise.to(device), NUM_STEPS, GUIDANCE)
        return lat.cpu().numpy(), launch_counts()

    def errs(lat, ref=want):
        return dict(max_abs=float(np.abs(lat - ref).max()),
                    rel_l2=float(np.linalg.norm(lat - ref)
                                 / np.linalg.norm(ref)))

    cpu = sample(sd, "cpu", "float32")[0]
    out = dict(cpu_fp32=errs(cpu), scale=float(np.abs(want).max()))
    bad = np.abs(cpu - want) > (GOLDEN_GATE["atol"]
                                + GOLDEN_GATE["rtol"] * np.abs(want))
    require(not bad.any(), f"the port's CPU fp32 path misses golden_mid at "
            f"the JAX gate ({out['cpu_fp32']}): the oracle's seeded weights "
            f"do not regenerate on torch {torch.__version__}, or the plain "
            "path moved")
    nb = GOLD["num_blocks"]
    for label, int8, limit in (("bf16", False, GOLDEN_BF16_REL_L2),
                               ("int8", True, GOLDEN_INT8_REL_L2)):
        plain = sample(sd, "cpu", "bfloat16", int8)[0]
        got, launches = sample(sd, "cuda", "bfloat16", int8)
        expect = {k: 0 for k in ATTENTION_KERNELS}
        expect["fused_attention_bf16"] = nb * NUM_STEPS
        expect.update(block_tail_launches(nb, NUM_STEPS, int8, False))
        for name, n in expect.items():
            require(launches[name] == n, f"golden {label}: {name} launched "
                    f"{launches[name]} times, expected {n}")
        ctl = sample(control, "cuda", "bfloat16", int8)[0]
        out[label] = dict(errs(got), limit=limit,
                          control=errs(ctl)["rel_l2"],
                          plain=errs(plain),
                          vs_plain=errs(got, plain),
                          plain_limit=GOLDEN_PLAIN_REL_L2[label],
                          control_vs_plain=errs(ctl, plain)["rel_l2"],
                          launches={k: v for k, v in launches.items() if v})
    out.update(s=time.time() - t0, card=card)
    print("  golden", json.dumps(out), flush=True)
    for label in ("bf16", "int8"):
        r = out[label]
        require(np.isfinite(r["rel_l2"]) and r["rel_l2"] <= r["limit"],
                f"golden {label} on the card: rel L2 {r['rel_l2']} > "
                f"{r['limit']}")
        require(r["control"] > r["limit"], f"golden {label}: the control "
                f"(block 7 x {GOLDEN_CONTROL_SCALE}) passes ({r['control']})")
        gap = r["vs_plain"]["rel_l2"]
        require(np.isfinite(gap) and gap <= r["plain_limit"], f"golden "
                f"{label} on the card against the plain versions in bf16 on"
                f" the CPU: rel L2 {gap} > {r['plain_limit']}")
        require(r["control_vs_plain"] > r["plain_limit"], f"golden {label}:"
                f" the control passes against the plain versions in bf16 "
                f"({r['control_vs_plain']})")
    return out


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
    kernels; and the idle share of the traced wall time. The traces record
    the card's activity alone (ProfilerActivity.CUDA), read by device_rows:
    no host operator events to process."""
    fams = dict.fromkeys(("K1", "K2", "K3", "K4", "K5", "K6a", "K6b", "K7",
                          "K7q", "K8a", "K8b", "K9", "K10a", "K10b",
                          "fp32 attention", "gemm_int8", "gemm", "other"),
                         0.0)
    rows = []
    for key, (us, n) in device_rows(prof).items():
        if us <= 0:
            continue
        fams[kernel_family(key, bf16_prep)] += us
        rows.append((us, n, key[:100]))
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
    start = time.time()

    # (phase, seconds since the start) of each phase header, for the line
    # of phase seconds before the last lines
    marks = []

    def say(*parts, flush=True):
        marks.append((str(parts[0]).split(":")[0], time.time() - start))
        print(f"[{time.time() - start:.1f} s]", *parts, flush=flush)
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "sd3_torch")):
        print(f"FAIL: no sd3_torch package beside {__file__}", flush=True)
        return 1
    sys.path.insert(0, here)
    logs = tempfile.TemporaryDirectory(prefix="chip_smoke_train_")
    ckpt_root = os.path.join(here, CKPT_DIR)
    try:
        say("phase 1: header", flush=True)
        card = nvidia_smi("name,power.limit")
        print(card, flush=True)
        print(f"  torch {torch.__version__} cuda {torch.version.cuda} "
              f"python {sys.version.split()[0]} device "
              f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}",
              flush=True)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        free = require_disk(ckpt_root)
        print(f"  {free / 1e9:.1f} GB free for the CLI phase's checkpoint "
              f"under {CKPT_DIR}/", flush=True)

        say("phase 2: build", flush=True)
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

        say("phase 3: kernels against their plain versions", flush=True)
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
        say("phase 3b: the int8 MLP and projections")
        k3 = [phase_mlp(s, gen, "K3") for s in (K3_SLICE, K3_RAGGED)]
        k2 = [phase_mlp(s, gen, "K2") for s in (K2_SLICE, K2_RAGGED)]
        k9 = [phase_mlp(s, gen, "K9") for s in (K9_SLICE, K9_TEXT)]
        k10a = [phase_dense(s, gen, "K10a") for s in (K10_SLICE, K10_RAGGED)]
        k10b = [phase_dense(s, gen, "K10b") for s in (K10_SLICE, K10_RAGGED)]
        phase_dense(K10_SLICE, gen, "K10b", gated=False, residual=False)
        for s in K10_WIDE:
            phase_dense(s, gen, "K10a")
            phase_dense(s, gen, "K10b")
        say("phase 3c: flash attention")
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
        say("phase 3d: the fp32 instances")
        k1f = phase_attention_fp32(SLICE_FP32, gen)
        k7f = phase_attention_fp32(SLICE_1024, gen)
        phase_attention_fp32(RAGGED_STREAM, gen)
        # the int8 kernels on fp32 rows: the attentions at the 512px shape
        # of the fp32 int8 model (K4F, K8aF over fp32 and over K4F's
        # scores) and the 1024px slice shape (K7qF, K8bF over fp32 and over
        # K7qF's scores), the MLP and projections at the fp32 int8 model's
        # 512px streams and past K_CHUNK
        k4f = phase_attention_int8_fp32(SLICE_FP32, gen, int8_qk=True)
        k8af = [phase_attention_int8_fp32(SLICE_FP32, gen, int8_qk=qk,
                                          int8_pv=True) for qk in (False, True)]
        # K8aF over K4F on 32 draws of its own beside the plain version an
        # ulp away (the level noise its limit rests on), with the control
        k8af_study(K8AF_SEEDS[:K8AF_STUDY_SEEDS])
        k7qf = phase_attention_int8_fp32(SLICE_1024, gen, int8_qk=True)
        k8bf = [phase_attention_int8_fp32(SLICE_1024, gen, int8_qk=qk,
                                          int8_pv=True) for qk in (False, True)]
        k3f = phase_mlp(K3_FP32, gen, "K3", fp32=True)
        k2f = phase_mlp(K2_FP32, gen, "K2", fp32=True)
        k9f = [phase_mlp(s, gen, "K9", fp32=True) for s in K9_FP32]
        k10af = phase_dense(K10_FP32, gen, "K10a", fp32=True)
        k10bf = phase_dense(K10_FP32, gen, "K10b", fp32=True)
        phase_dense(K10_WIDE[0], gen, "K10a", fp32=True)
        phase_dense(K10_WIDE[0], gen, "K10b", fp32=True)
        # flash past head dim 128: bf16 and fp32 at 256, 160 (padded), 384
        # and 512; the bf16 wgmma instances up to 512 (K5_256 .. K5_512,
        # K6A_256 .. K6B_512) with controls
        say("phase 3e: the flash instances past 128, M != N")
        k56w = [phase_flash(s, gen, control=True, grad_control=True)
                for s in FLASH_WIDE]
        # K6A_256 / K6B_256 and K6A_384 / K6B_384 at the shapes the training
        # steps of phases 4b and 4c give them (B 2, H 5, N 410, D 256; B 2,
        # H 3, N 410, D 384), on draws of their own, with the control
        k56s256, k56s384 = (
            phase_flash(step_flash_shape(train_step_config().replace(
                **model), TRAIN32_LAT), wide_gen(d), grad_control=True)
            for model, d in ((D256_MODEL, 256), (D384_MODEL, 384)))
        k56wf = [phase_flash_fp32(s, gen) for s in FLASH_WIDE]
        # k and v of M keys (kv_merge_attn): K5, K6a, K6b, their fp32
        # instances, and at head dim 256 K5_256, K6A_256, K6B_256 and the
        # wide fp32 instances
        for shp in FLASH_KV:
            phase_flash(shp, gen)
            phase_flash_fp32(shp, gen)
        for shp in FLASH_KV_WIDE:
            phase_flash(shp, gen, control=True)
            phase_flash_fp32(shp, gen)
        # past 512: K5_768, K6A_768, K6B_768 at two heads of 640 with the
        # controls, the mma.sync K6AW / K6BW timed beside them once, and
        # the D = 384 / 512 instances at M != N with controls, on draws of
        # their own; then K5_1024, K6A_1024, K6B_1024 at two heads of 1024
        # the same way, and K5W, K6AW, K6BW past them at 1152
        gen_past = wide_gen(640)
        k56w640 = phase_flash(FLASH_PAST_512, gen_past, control=True,
                              grad_control=True, beside=True)
        for shp in FLASH_KV_SLICED:
            phase_flash(shp, gen_past, control=True, grad_control=True)
        k56w1024 = phase_flash(FLASH_1024, wide_gen(1024), control=True,
                               grad_control=True, beside=True)
        k56w1152 = phase_flash(FLASH_PAST_1024, wide_gen(1152),
                               control=True)
        # K6A_768 / K6B_768 and K6A_1024 / K6B_1024 at M != N, and at the
        # shape phase 4d's training step gives K6A_768 / K6B_768 (B 2, H 2,
        # N 410, D 640), with the controls, on draws of their own
        for shp in FLASH_KV_PAST_512:
            phase_flash(shp, wide_gen(shp[-1] + 1), control=True,
                        grad_control=True)
        phase_flash(step_flash_shape(train_step_config().replace(
            **D640_MODEL), TRAIN32_LAT), wide_gen(641), grad_control=True)
        flash_api = phase_flash_api(gen, gen_past)
        phase_k1_backward(gen)
        # the fused route past head dim 128: every kernel at each of
        # WIDE_DIMS and WIDE_DIMS_PAST_384 in bf16 and fp32, then timed at
        # SLICE_WIDE (bf16: the D = 256 instances, with controls; fp32: the
        # wide instances), the bf16 D = 384 and 512 instances at
        # SLICE_WIDE_384 / 512, the D = 768 instances at SLICE_WIDE_640 and
        # the D = 1024 ones at SLICE_WIDE_1024 (with controls), and the bf16
        # wide instances past 1024 at SLICE_WIDE_1152
        say("phase 3f: the fused instances past 128")
        phase_attention_dims(gen)
        phase_attention_dims(wide_gen(512), WIDE_DIMS_PAST_384)
        wide, wide384, wide512, wide640 = {}, {}, {}, {}
        wide1024, wide1152 = {}, {}
        gen384, gen512, gen640, gen1024, gen1152 = (
            wide_gen(d) for d in (384, 512, 640, 1024, 1152))
        for (int8_qk, int8_pv, streaming), nm in ATTN_NAMES.items():
            wide[nm] = phase_attention(SLICE_WIDE, gen, int8_qk, int8_pv,
                                       streaming=streaming, control=True)
            wide[nm + " fp32"] = (
                phase_attention_int8_fp32(SLICE_WIDE, gen, int8_qk, int8_pv,
                                          streaming=streaming)
                if int8_qk or int8_pv else
                phase_attention_fp32(SLICE_WIDE, gen, streaming=streaming))
            wide384[nm] = phase_attention(SLICE_WIDE_384, gen384, int8_qk,
                                          int8_pv, streaming=streaming,
                                          control=True)
            wide512[nm] = phase_attention(SLICE_WIDE_512, gen512, int8_qk,
                                          int8_pv, streaming=streaming,
                                          control=True)
            wide640[nm] = phase_attention(SLICE_WIDE_640, gen640, int8_qk,
                                          int8_pv, streaming=streaming,
                                          control=True)
            wide1024[nm] = phase_attention(SLICE_WIDE_1024, gen1024, int8_qk,
                                           int8_pv, streaming=streaming,
                                           control=True)
            wide1152[nm] = phase_attention(SLICE_WIDE_1152, gen1152, int8_qk,
                                           int8_pv, streaming=streaming)

        say("phase 4: 2-block models on the card vs fp32 on the CPU: "
              "512px batch 2, 1024px batch 1", flush=True)
        phase_model(gen_seed=0)
        phase_model(gen_seed=0, int8=True)
        phase_model(gen_seed=0, int8=True, tails=True)
        phase_model(gen_seed=0, res=1024, batch=1)
        phase_model(gen_seed=0, int8=True, res=1024, batch=1)
        phase_model(gen_seed=0, int8=True, res=1024, batch=1, int8_pv=True)
        model32 = phase_model(gen_seed=0, fp32=True)
        phase_model(gen_seed=0, int8=True, fp32=True)
        phase_model(gen_seed=0, int8=True, tails=True, fp32=True)
        model256 = phase_model_wide()
        phase_model_wide(int8=True)
        model384 = phase_model_wide(model=D384_MODEL)
        phase_model_wide(int8=True, model=D384_MODEL)
        model640 = phase_model_wide(model=D640_MODEL)
        phase_model_wide(int8=True, model=D640_MODEL)
        # the trainers' metric logs, removed at exit
        log_dir = logs.name
        phase_train_step_2block(log_dir)
        step32 = phase_train_step_2block(log_dir, fp32=True)
        # tiny_config (head dim 16: the flash instances at D = 16)
        phase_train_step(log_dir, tiny, "tiny_config", lat=TINY_LAT)
        say("phase 4b: a training step of five heads of 256 (dim 1280, 2 "
            "blocks, 256px, batch 2) on K5_256, K6A_256, K6B_256 against "
            "fp32 on the CPU, RoPE1d's tables the control")
        step256 = phase_train_step(
            log_dir, train_step_config().replace(**D256_MODEL),
            "D-256 2-block", lat=TRAIN32_LAT,
            control=dict(positional_encoding="RoPE"))
        say("phase 4c: a training step of three heads of 384 (dim 1152, 2 "
            "blocks, 256px, batch 2) on K5_384, K6A_384, K6B_384 against "
            "fp32 on the CPU, RoPE1d's tables the control")
        step384 = phase_train_step(
            log_dir, train_step_config().replace(**D384_MODEL),
            "D-384 2-block", lat=TRAIN32_LAT,
            control=dict(positional_encoding="RoPE"))
        say("phase 4d: a training step of two heads of 640 (dim 1280, 2 "
            "blocks, 256px, batch 2) on K5_768, K6A_768, K6B_768 (K6AW, "
            "K6BW 0 launches) against fp32 on the CPU, RoPE1d's tables the "
            "control")
        step640 = phase_train_step(
            log_dir, train_step_config().replace(**D640_MODEL),
            "D-640 2-block", lat=TRAIN32_LAT,
            control=dict(positional_encoding="RoPE"))
        for kern in (flash_attention.K6AW, flash_attention.K6BW):
            require(step640["launches"][kern.name] == 0,
                    f"{kern.name} launched in the D-640 training step")

        say("phase 5: 19-block bf16 sampling, 512px, batch 4, 20 Euler "
              "steps, CFG 5", flush=True)
        sample = phase_sample(card)

        say("phase 6: 19-block int8 sampling, the same", flush=True)
        sample8 = phase_sample(card, int8=True)

        say("phase 7: 19-block int8 sampling with the block tails "
              "(attn_tail all, mlp_tail_fusion 3d), the same", flush=True)
        sample8_tails = phase_sample(card, int8=True, tails=True)

        say("phase 8: 19-block bf16 sampling, 1024px, batch 4, 20 Euler "
              "steps, CFG 5", flush=True)
        sample_1024 = phase_sample(card, res=1024)

        say("phase 9: 19-block int8 sampling, 1024px, the same", flush=True)
        phase_sample(card, int8=True, res=1024)

        say("phase 10: 19-block int8 sampling with int8 P.V, 1024px, the "
              "same", flush=True)
        sample8pv_1024 = phase_sample(card, int8=True, res=1024, int8_pv=True)

        say("phase 11: 19-block training, 512px, batch 4, fused low-mem "
              "AdamW, bf16 grads, remat; the same with 8-bit moments, and "
              "with the host EMA; then the default TrainConfig path at 2 "
              "blocks", flush=True)
        train = phase_train(card, log_dir)
        phase_train_options(card, log_dir)
        phase_train_default_path(log_dir)

        say("phase 11b: phase 11's training over a dp x fsdp x tp mesh of "
            "one NCCL rank (sd3_torch.parallel), held to the trainer without "
            "a group on the same seed, batch and noise, with a control",
            flush=True)
        phase_train_mesh(card, log_dir)

        say(f"phase 12: the CLIs at the published widths, {CLI_BLOCKS} "
            "blocks: train (2 steps, 8-bit moments, host EMA) -> six "
            "artifacts -> infer (bf16, int8, fp32 int8 with and without the "
            "tails); tiny_config resume and GIF", flush=True)
        cli = phase_cli(card, ckpt_root)

        say("phase 12b: the eval path on that checkpoint: generate_images "
            f"({len(EVAL_PROMPTS)} prompts x {EVAL_PER_PROMPT} images, "
            f"{EVAL_RES}px, {EVAL_STEPS} steps) in bf16 (K1), int8 (K2, K3, "
            "K4) and from another seed, traced; calculate_fid", flush=True)
        phase_eval(card, os.path.join(ckpt_root, "published"))
        # the published-width checkpoint is checked: it goes before the
        # later phases write theirs
        shutil.rmtree(os.path.join(ckpt_root, "published"),
                      ignore_errors=True)

        say("phase 13: the frozen encoders and the FLUX VAE at the "
              "published widths (random weights): against fp32 on the CPU "
              "with controls, times at full depth, 512px sampling through "
              "them", flush=True)
        phase_encoders(card)

        say("phase 14: data-fed training: a seeded parquet folder ->"
              " filter -> phase -> index; the loaders alone (threads, ring); "
              f"the train CLI at the published widths ({CLI_BLOCKS} blocks) "
              "from it; the remat "
              "policies and the scan layout; the feed against synthetic "
              "batches, and the VAE's encode per bucket", flush=True)
        phase_data_feed(card, os.path.join(ckpt_root, "feed"), log_dir)

        say("phase 15: a reference checkpoint of the old layout (absolute "
            "PE, swiglu_old from a params JSON without MLP_type) at the "
            "published widths through infer --torch_ckpt --loadDefFile, "
            "bf16 and int8", flush=True)
        phase_reference_layout(card, ckpt_root)

        say("phase 16: the model variants at the published widths: each "
            "held at 2 blocks against fp32 on the CPU with a control; 512px "
            "sampling (RoPE1d K1, RoPE2dV2 and kv_merge K5, the other "
            "attention types, both); 256px training (text_loss, kv_merge, "
            "both under scan_blocks)", flush=True)
        phase_sample_variants(card)
        phase_train_variants(card, log_dir)
        say("phase 16.3: RoPE1d / NoPE / absolute through K7, K4, K8b and "
            "(the API) K7q, swiglu_old through K2 / K3 at 1024px int8",
            flush=True)
        for route in TABLE_ROUTES:
            route_check(*route)
        phase_attention_tables(gen)

        say("phase 17: the golden config (golden_mid.npz): the CPU fp32 "
            "path at the JAX gate, the card's bf16 (K1) and int8 (K1, K2, "
            "K3) paths with controls", flush=True)
        phase_golden(card)

        say("phase 18: kernels", flush=True)
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
            # the int8 kernels' fp32 instances: K4F, K2F, K3F on the fp32
            # int8 infer CLI run, K9F, K10AF, K10BF on its run with the
            # tails, K7qF, K8aF, K8bF through the attention API
            (fused_attention.K4F, k4f, "attention_fp32.cu",
             "sd3_tpu/ops/fused_attention.py:193", cli["infer fp32 int8"],
             lambda run: run),
            (fused_attention.K7QF, k7qf, "attention_fp32.cu",
             "sd3_tpu/ops/fused_attention.py:352", api, lambda run: run),
            (fused_attention.K8AF, k8af[0], "attention_fp32.cu",
             "sd3_tpu/ops/fused_attention.py:181", api, lambda run: run),
            (fused_attention.K8BF, k8bf[0], "attention_fp32.cu",
             "sd3_tpu/ops/fused_attention.py:406", api, lambda run: run),
            (fused_mlp.K2F, k2f, "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:212", cli["infer fp32 int8"],
             lambda run: run),
            (fused_mlp.K3F, k3f, "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:93", cli["infer fp32 int8"],
             lambda run: run),
            (fused_mlp.K9F, k9f[0], "fused_mlp.cu",
             "sd3_tpu/ops/fused_mlp.py:365", cli["infer fp32 int8 tails"],
             lambda run: run),
            (fused_dense.K10AF, k10af, "fused_dense.cu",
             "sd3_tpu/ops/fused_dense.py:92", cli["infer fp32 int8 tails"],
             lambda run: run),
            (fused_dense.K10BF, k10bf, "fused_dense.cu",
             "sd3_tpu/ops/fused_dense.py:166", cli["infer fp32 int8 tails"],
             lambda run: run),
            # flash past head dim 128 (bf16: the wgmma instances at 256, 384
            # and 512, the shared-memory kernels past them, timed at 640;
            # fp32: the shared-memory kernels, at 256): their launches are
            # those of the flash API phase, but K5_256's and K5_384's: the D
            # = 256 and 384 models' attention (phase 4), and K6A_256's /
            # K6B_256's and K6A_384's / K6B_384's: the D = 256 and 384
            # training steps (phases 4b, 4c), timed at their shapes
            (flash_attention.K5_256, k56w[0]["K5"], "attention_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:103", model256,
             lambda run: run["launches"]),
            (flash_attention.K6A_256, k56s256["K6a"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:191", step256,
             lambda run: run["launches"]),
            (flash_attention.K6B_256, k56s256["K6b"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:222", step256,
             lambda run: run["launches"]),
            (flash_attention.K5_384, k56w[2]["K5"], "attention_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:103", model384,
             lambda run: run["launches"]),
            (flash_attention.K6A_384, k56s384["K6a"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:191", step384,
             lambda run: run["launches"]),
            (flash_attention.K6B_384, k56s384["K6b"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:222", step384,
             lambda run: run["launches"]),
            (flash_attention.K5_512, k56w[3]["K5"], "attention_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:103", flash_api, lambda run: run),
            # past 512: K5_768, the D = 640 model's attention (phase 4),
            # timed at two heads of 640; K5_1024 through the flash API
            (flash_attention.K5_768, k56w640["K5"], "attention_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:103", model640,
             lambda run: run["launches"]),
            (flash_attention.K5_1024, k56w1024["K5"], "attention_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:103", flash_api, lambda run: run),
            (flash_attention.K6A_512, k56w[3]["K6a"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:191", flash_api, lambda run: run),
            (flash_attention.K6B_512, k56w[3]["K6b"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:222", flash_api, lambda run: run),
            # the backward past 512: K6A_768 / K6B_768, the D = 640
            # training step's (phase 4d), timed at two heads of 640 of the
            # 512px length; K6A_1024 / K6B_1024 through the flash API
            (flash_attention.K6A_768, k56w640["K6a"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:191", step640,
             lambda run: run["launches"]),
            (flash_attention.K6B_768, k56w640["K6b"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:222", step640,
             lambda run: run["launches"]),
            (flash_attention.K6A_1024, k56w1024["K6a"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:191", flash_api, lambda run: run),
            (flash_attention.K6B_1024, k56w1024["K6b"], "flash_bwd_sm90.cu",
             "sd3_tpu/ops/flash_attention.py:222", flash_api, lambda run: run),
            # past 1024 in bf16: K5W, K6AW, K6BW at two heads of 1152
            (flash_attention.K5W, k56w1152["K5"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:103", flash_api, lambda run: run),
            (flash_attention.K6AW, k56w1152["K6a"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:191", flash_api, lambda run: run),
            (flash_attention.K6BW, k56w1152["K6b"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:222", flash_api, lambda run: run),
            (flash_attention.K5WF, k56wf[0]["K5F"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:103", flash_api, lambda run: run),
            (flash_attention.K6AWF, k56wf[0]["K6AF"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:191", flash_api, lambda run: run),
            (flash_attention.K6BWF, k56wf[0]["K6BF"], "attention_fp32.cu",
             "sd3_tpu/ops/flash_attention.py:222", flash_api, lambda run: run),
            # the fused kernels past head dim 128: in bf16 up to 1024 the
            # wgmma kernels' D = 256, 384, 512, 768 and 1024 instances
            # (SLICE_WIDE, SLICE_WIDE_384, SLICE_WIDE_512, SLICE_WIDE_640,
            # SLICE_WIDE_1024), past it the wide instances
            # (SLICE_WIDE_1152), in fp32 the wide instances (SLICE_WIDE); no
            # model takes the fused path at these head dims (phase 4's
            # models take K5_256 / K5_384), so their launches are those of
            # the attention API phase
            *[(insts[getattr(fused_attention, base)], res[nm],
               getattr(fused_attention, base).source,
               f"sd3_tpu/ops/fused_attention.py:{line}", api,
               lambda run: run)
              for insts, res in ((fused_attention._D256, wide),
                                 (fused_attention._D384, wide384),
                                 (fused_attention._D512, wide512),
                                 (fused_attention._D768, wide640),
                                 (fused_attention._D1024, wide1024))
              for base, nm, line in WIDE_ROWS],
            *[(fused_attention._WIDE[getattr(fused_attention, base)][fp32],
               (wide[nm + " fp32"] if fp32 else wide1152[nm]),
               "attention_fp32.cu", f"sd3_tpu/ops/fused_attention.py:{line}",
               api, lambda run: run)
              for base, nm, line in WIDE_ROWS for fp32 in (0, 1)],
        ]
        for kern, r, *_ in rows:
            require(r.get("kernel", kern.name) == kern.name,
                    f"the {kern.name} row was timed on {r.get('kernel')}")
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
        shutil.rmtree(ckpt_root, ignore_errors=True)
    ends = [t for _, t in marks[1:]] + [time.time() - start]
    print(json.dumps({"total_s": round(ends[-1], 1), "phase_s": {
        name: round(end - t, 1) for (name, t), end in zip(marks, ends)}}),
        flush=True)
    print(card, flush=True)
    print(json.dumps(line), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
