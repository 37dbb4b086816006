"""Fused q/k-RMSNorm + RoPE joint attention (JAX counterpart:
sd3_tpu/ops/fused_attention.py).

Raw q/k/v projections (B, N, H*D) go in; the kernels apply the per-head
RMSNorm and the interleaved-pair rotation themselves, with the per-stream
norm weights folded into per-row cos/sin tables (text rows get cos = W,
sin = 0) and the softmax scale * log2(e) folded into the q tables, so the
softmax runs in exp2. As `_pallas_fused` does, `fused_attention` picks the
kernel by the 128-padded length: up to `single_kv_max` (2048) padded tokens
the single-KV kernels, above it the streaming ones.

Single-KV, replacing the branches of `_fused_fwd_kernel`:
- K1, bf16 (`csrc/attention_sm90.cu`: wgmma, TMA, a warp-specialised ring
  of 128-key tiles): softmax against the bound ||q^|| * max||k^||;
- K4, `int8_qk` (`csrc/attention_int8_sm90.cu`: s8 / bf16 wgmma, TMA, a
  warp-specialised ring of 128-key tiles): QK^T as s8 x s8 -> s32, q^
  quantized per row from fp32, k^ rounded to the input dtype with one
  scale per (batch, head), the true row max (an integer max of s32 in a
  first pass over K);
- K8a, `int8_pv` (`csrc/attention_int8_sm90.cu`, K4's kernel, over
  K1-style bf16 scores or over K4's): the true row max from a first pass,
  p = exp2(s - (max - log2 127)) in [0, 127] rounded to int8, V quantized
  per (batch, head, column) over all rows, s8 x s8 -> s32 P.V summed over
  every key, o = acc / l * v_scale with l the sum of the unrounded p.
Streaming, replacing `_stream_fwd_kernel`:
- K7, bf16 (`csrc/attention_sm90.cu`, K1's kernel): an online softmax
  (true running max) over `K7_KEY_TILE` keys at a time (`K7_KEY_TILE_256`
  at head dim 256, `K7_KEY_TILE_512` at 384 and 512);
- K7q, `int8_qk` (`csrc/attention_int8_sm90.cu`, K4's kernel, over
  `K7Q_KEY_TILE` keys at a time): k^ prepped in fp32 and quantized per row
  (per head), q^ per row, s = s32 * s_q * s_k[key], bf16 P.V;
- K8b, `int8_pv` over K7's or K7q's scores (`csrc/attention_int8_sm90.cu`,
  K4's kernel, over `K8B_KEY_TILE` keys at a time): P quantized against the
  running max with log2(127) folded into the shift, V as for K8a, s8 P.V
  per tile.
fp32 q / k / v (the JAX package's `--dtype float32`) take K1F and K7F, the
fp32 instances of K1 and K7 (`csrc/attention_fp32.cu`: the fp32 prep, then
3xTF32 mma.sync products, fp32-accurate as JAX's Precision.HIGHEST), and
under int8 (`--dtype float32 --quant int8`, where the JAX kernels quantize
the fp32 rows) K4F, K7QF, K8AF and K8BF, the fp32 instances of K4, K7q,
K8a and K8b (the same source: the fp32 preps quantize the fp32 rows, the
int8 product on s8 mma.sync, the floating-point one in 3xTF32; p and the
output in fp32, as the plain versions keep them).
The CUDA sources' heads say what bounds each kernel on an H100.

Head dims: the kernels take every even head dim. They have instances at
the flash kernels' `HEAD_DIMS` (16, 32, 64, 128) and, on bf16, at 256
(`WGMMA_WIDE`): K1_256, K7_256, K4_256, K7Q_256, K8A_256 and K8B_256, the
same wgmma + TMA kernels and entry points at D = 256, counted apart (a
64 x 256 fp32 accumulator is 128 of a consumer's registers, so each
consumer's P.V lands before its next scores, K1 / K7 take 64-key tiles
(K7 rounds p over `K7_KEY_TILE_256` keys), the int8 kernels keep their
128-key tiles and K8b's s8 P.V runs in four 64-column parts: the sources'
heads say why); at 384 and 512 (`WGMMA_SLICED`): K1_384 .. K8B_384,
K1_512 .. K8B_512, where each consumer warpgroup computes the scores over
the whole head and writes one of two column slices of the output (192 /
256 columns: the registers of one wgmma's accumulator; K1 / K7's two
consumers share 64 query rows, the int8 kernels' slice is a grid
dimension), K1 / K7 on 32-key tiles (K7's p
over `K7_KEY_TILE_512` keys), the int8 kernels on their 128-key tiles
with K in sub-tiles where a whole-head bf16 K tile does not fit twice;
and at 768 and 1024 (`WGMMA_PAST_512`: heads of 513 to 1024 values,
`forward_dim`): K1_768 .. K8B_768, K1_1024 .. K8B_1024, where the output
is cut into four slices of D / 4 (192 / 256 columns) and every kernel's
CTA takes 64 query rows whose two consumers share q^ and write one pair
of slices, the pair a grid dimension; K1 / K7 on 64-key tiles (K7's p
over `K7_KEY_TILE_1024` keys) with K in chunks of 128 values of the head,
the int8 kernels on their 128-key tiles with K in chunks of 128 bytes of
the head and bf16 V in 32-key sub-tiles.
Past 1024 on bf16, and past 128 on fp32, every kernel runs
on one set of instances for every multiple of 128 (`csrc/attention_fp32.cu`:
K1W, K7W, K4W, K7QW, K8AW, K8BW and their F instances): q and k prepped in
their own launches (the RMSNorm over the true head dim, then the rotation,
scale*log2(e) folded into the q tables; int8 rows with their scales over
the whole head), then mma.sync attention that sums the scores over
128-wide chunks of the head, staged through shared memory a chunk at a
time, each block writing one 128-wide column slice of the output, so that
shared memory does not grow with the head dim. `kernel_for` names the
kernel of each (kernel, dtype, head dim). Any other head dim is
zero-padded to the next instance (48 to 64, 160 and 192 to 256, 300 to
384, 400 to 512, on bf16 640 to 768 and 1000 to 1024), q / k / v and
the tables zero-padded on each head and the output
sliced back, the true head dim passed to the prep so that its RMSNorm
takes the mean over the head's own values.

Beside them, the plain PyTorch versions (the JAX kernels' arithmetic):
`composition` (K1; K8a with `int8_pv`), `composition_int8_qk` (K4; K8a),
`composition_stream` (K7; K8b) and `composition_stream_int8_qk` (K7q; K8b),
the streaming ones over blocks of `block_k` keys (default: JAX's block
rule, `default_block_k`), and the table helpers `rope_row_tables`,
`_swap_pairs` and `fold_row_tables`. The wrapper takes the plain versions
for tensors on the CPU; on a CUDA tensor it launches a kernel or raises:
there is no fallback. The JAX package's streaming tunables (`SD3_FLASH_BK`,
`SD3_FLASH_BQPAD`, `SD3_FUSED_UNROLL`, `SD3_FLASH_LOOKAHEAD`) shape its TPU
blocking only and are not ported; the card's tiles are fixed in the source.

K1 and K7 are differentiable: `_FusedAttention`, an autograd Function, runs
K1 or K7 (or its plain version) forward and, as the JAX package's
`_fused_core_bwd` does at every length, differentiates the plain prep
followed by `flash_attention` (K5, K6a, K6b on the card) in its backward,
with gradients for q, k, v and the four tables (`fold_row_tables` carries
those on to the norm weights). K4, K7q, K8a and K8b are for inference only,
as in the JAX package: they raise when an input requires grad.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sd3_torch.kernels import Kernel, check
from sd3_torch.ops.flash_attention import (HEAD_DIMS, WGMMA_PAST_128,
                                           WGMMA_PAST_512, WGMMA_SLICED,
                                           WGMMA_WIDE, flash_attention,
                                           forward_dim, instance_dim)
from sd3_torch.ops.quant import scale_of
from sd3_torch.ops.rope import _rotate_half_interleaved

LOG2E = 1.4426950408889634  # the kernel's softmax runs in exp2
LOG2_127 = 6.988684686772166  # int8 P.V: folds P's 1/127 scale into the shift
SINGLE_KV_MAX = 2048        # padded tokens of the single-KV kernels (beyond:
                            # the streaming ones, K7 / K7q / K8b)
STREAM_BLOCK = 2176         # JAX's streaming K block target (rows)

# the key tiles of the card's kernels, which the plain versions' `block_k`
# must take to round p against the same running max (`stream_key_tile`):
# K1 and K7's (csrc/attention_sm90.cu KEY_TILE), and K4, K8a, K7q and K8b's
# at every head dim (csrc/attention_int8_sm90.cu KEY_TILE; the int8 V^T of
# K8a and K8b is padded to it)
K7_KEY_TILE = 128
K8B_KEY_TILE = 128
K7Q_KEY_TILE = 128
# K7's at head dim 256 (csrc/attention_sm90.cu WIDE_KEY_TILE: the registers
# of a 64 x 256 accumulator leave room for 64-key tiles only), and at 384
# and 512 (SLICE_KEY_TILE: two stages of K tiles of the whole head beside
# q^ of 96 / 128 KB)
K7_KEY_TILE_256 = 64
K7_KEY_TILE_512 = 32
# and at 768 and 1024 (PAST_512_KEY_TILE: 64-key tiles, their K in chunks
# of 128 values of the head beside q^ of 96 / 128 KB)
K7_KEY_TILE_1024 = 64

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# K1 and K7 (and their fp32 instances) share one signature: q, k, v, the
# four tables, scratch q_prep, q_norm, k_prep, k_max2, out; B, N, H, D (the
# instance), dn (the model's head dim); eps_q, eps_k; the stream
_SM90_ARGS = [_P] * 12 + [_I] * 5 + [_F] * 2 + [_P]
K1 = Kernel("fused_attention_bf16", "attention_sm90.cu",
            "sd3_fused_attention_bf16", argtypes=_SM90_ARGS)
K7 = Kernel("fused_attention_stream", "attention_sm90.cu",
            "sd3_fused_attention_stream", argtypes=_SM90_ARGS)
K1F = Kernel("fused_attention_fp32", "attention_fp32.cu",
             "sd3_fused_attention_fp32", argtypes=_SM90_ARGS)
K7F = Kernel("fused_attention_stream_fp32", "attention_fp32.cu",
             "sd3_fused_attention_stream_fp32", argtypes=_SM90_ARGS)
# K4, K8a, K7q and K8b share one signature: q, k, v, the four tables,
# scratch q_prep, q_scale, k_prep, k_q, k_stat, v_amax, v_q, out; B, N, H, D
# (the instance), dn (the model's head dim), int8_qk; eps_q, eps_k; the
# stream
_INT8_SM90_ARGS = [_P] * 15 + [_I] * 6 + [_F] * 2 + [_P]
K4 = Kernel("fused_attention_int8qk", "attention_int8_sm90.cu",
            "sd3_fused_attention_int8qk", argtypes=_INT8_SM90_ARGS)
K7Q = Kernel("fused_attention_stream_int8qk", "attention_int8_sm90.cu",
             "sd3_fused_attention_stream_int8qk", argtypes=_INT8_SM90_ARGS)
K8A = Kernel("fused_attention_int8pv", "attention_int8_sm90.cu",
             "sd3_fused_attention_int8pv", argtypes=_INT8_SM90_ARGS)
K8B = Kernel("fused_attention_stream_int8pv", "attention_int8_sm90.cu",
             "sd3_fused_attention_stream_int8pv", argtypes=_INT8_SM90_ARGS)
# their fp32 instances (csrc/attention_fp32.cu), the same signature
K4F = Kernel("fused_attention_int8qk_fp32", "attention_fp32.cu",
             "sd3_fused_attention_int8qk_fp32", argtypes=_INT8_SM90_ARGS)
K7QF = Kernel("fused_attention_stream_int8qk_fp32", "attention_fp32.cu",
              "sd3_fused_attention_stream_int8qk_fp32",
              argtypes=_INT8_SM90_ARGS)
K8AF = Kernel("fused_attention_int8pv_fp32", "attention_fp32.cu",
              "sd3_fused_attention_int8pv_fp32", argtypes=_INT8_SM90_ARGS)
K8BF = Kernel("fused_attention_stream_int8pv_fp32", "attention_fp32.cu",
              "sd3_fused_attention_stream_int8pv_fp32",
              argtypes=_INT8_SM90_ARGS)
_FP32 = {K1: K1F, K7: K7F, K4: K4F, K7Q: K7QF, K8A: K8AF, K8B: K8BF}
# past head dim 128 (csrc/attention_fp32.cu), bf16 and fp32: one entry
# point each, told the kernel by its TPU number (71: K7q, 81: K8a, 82: K8b)
_WIDE_ARGS = [_P] * 15 + [_I] * 7 + [_F] * 2 + [_P]
_WIDE = {}
for _k, _kind in ((K1, 1), (K7, 7), (K4, 4), (K7Q, 71), (K8A, 81),
                  (K8B, 82)):
    _WIDE[_k] = tuple(
        Kernel(f"{_k.name}_wide{sfx}", "attention_fp32.cu",
               f"sd3_fused_attention_wide{sfx}", argtypes=_WIDE_ARGS)
        for sfx in ("", "_fp32")) + (_kind,)
K1W, K1WF, _ = _WIDE[K1]
K7W, K7WF, _ = _WIDE[K7]
K4W, K4WF, _ = _WIDE[K4]
K7QW, K7QWF, _ = _WIDE[K7Q]
K8AW, K8AWF, _ = _WIDE[K8A]
K8BW, K8BWF, _ = _WIDE[K8B]
_MMA_WIDE = {kern for w in _WIDE.values() for kern in w[:2]}
# bf16 at head dims 256 (129 to 256, padded), 384 (257 to 384), 512 (385
# to 512), 768 (513 to 768) and 1024 (769 to 1024): the wgmma kernels'
# instances there (csrc/attention_sm90.cu, csrc/attention_int8_sm90.cu at
# D = 256 .. 1024), the same entry points as K1 .. K8b, counted apart
_WGMMA_PAST_128 = {
    dp: {k: Kernel(f"{k.name}_{dp}", k.source, k.symbol, argtypes=k.argtypes)
         for k in (K1, K7, K4, K7Q, K8A, K8B)}
    for dp in (*WGMMA_PAST_128, *WGMMA_PAST_512)}
_D256, _D384, _D512, _D768, _D1024 = _WGMMA_PAST_128.values()
K1_256, K7_256, K4_256, K7Q_256, K8A_256, K8B_256 = _D256.values()
Q8_EPS = 1e-12  # q / k / v int8 scale floor (JAX fused_attention.py:122,256)


def kernel_for(base: Kernel, dtype: torch.dtype, d: int) -> Kernel:
    """The kernel that runs `base` (K1, K7, K4, K7q, K8a or K8b) on q / k /
    v of `dtype` at head dim d (padded to `forward_dim(d, dtype)`): up to
    128 `base` (fp32: its F instance, `_FP32`); bf16 at 129 to 1024 its
    wgmma instance at 256, 384, 512, 768 or 1024 (`_D256` .. `_D1024`);
    past 1024 in bf16, and fp32 past 128, its wide mma.sync instance
    (`_WIDE`)."""
    dp = forward_dim(d, dtype)
    fp32 = dtype == torch.float32
    if dp <= HEAD_DIMS[-1]:
        return _FP32[base] if fp32 else base
    if dp in _WGMMA_PAST_128 and not fp32:
        return _WGMMA_PAST_128[dp][base]
    return _WIDE[base][fp32]


def stream_key_tile(int8_qk: bool, int8_pv: bool, d: int) -> int:
    """The key tile over which the card's bf16 streaming kernel at head dim
    d rounds p (the plain version's `block_k` for holding it to the card):
    K8b's K8B_KEY_TILE, K7q's K7Q_KEY_TILE, K7's K7_KEY_TILE, at 129 to 256
    K7_KEY_TILE_256, at 257 to 512 K7_KEY_TILE_512, at 513 to 1024
    K7_KEY_TILE_1024 (past 1024 the mma.sync instance's K7_KEY_TILE)."""
    if int8_pv:
        return K8B_KEY_TILE
    if int8_qk:
        return K7Q_KEY_TILE
    dp = forward_dim(d, torch.bfloat16)
    if dp == WGMMA_WIDE:
        return K7_KEY_TILE_256
    if dp in WGMMA_PAST_512:
        return K7_KEY_TILE_1024
    return K7_KEY_TILE_512 if dp in WGMMA_SLICED else K7_KEY_TILE


def rope_row_tables(angles_img, n: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Full-sequence (n, d) cos/sin with identity rows for the text tokens
    (rows >= n_img): cos=1, sin=0 makes the rotation a no-op there."""
    cos = np.ones((n, d), np.float32)
    sin = np.zeros((n, d), np.float32)
    if angles_img is not None:
        a = np.asarray(angles_img, np.float32)
        cos[:a.shape[0]] = np.cos(a)
        sin[:a.shape[0]] = np.sin(a)
    return cos, sin


def _swap_pairs(w: torch.Tensor) -> torch.Tensor:
    """(w0, w1, w2, w3, ...) -> (w1, w0, w3, w2, ...)."""
    return w.reshape(*w.shape[:-1], w.shape[-1] // 2, 2).flip(-1).reshape(w.shape)


def fold_row_tables(cos: torch.Tensor, sin: torch.Tensor, w_img: torch.Tensor,
                    w_txt: torch.Tensor, n_img: int):
    """Fold the per-stream RMSNorm weights into the rotation tables (fp32):
    rope(rms(x)*W) == rms(x)*(W.cos) + rot(rms(x))*(swap(W).sin)."""
    n = cos.shape[0]
    row_img = (torch.arange(n, device=cos.device) < n_img)[:, None]
    w = torch.where(row_img, w_img.float()[None, :], w_txt.float()[None, :])
    return cos * w, sin * _swap_pairs(w)


def composition(q, k, v, cosq, sinq, cosk, sink, scale: float, eps_q: float,
                eps_k: float, num_heads: int, int8_pv: bool = False
                ) -> torch.Tensor:
    """Plain PyTorch version of K1: per-head RMSNorm + table rotation in fp32
    (cast back to the input dtype), then softmax(q^ k^T * scale) v with fp32
    logits. Tables here are un-scaled (no scale*log2e fold). With int8_pv,
    K8a's: the same scores (q tables folded, exp2 domain) and int8 P.V
    against the true row max (`_online` over one block)."""
    b, n, f = q.shape
    if int8_pv:
        o = _online(_float_scores(q, k, cosq, sinq, cosk, sink, scale, eps_q,
                                  eps_k, num_heads), v, num_heads, n, n, True)
        return _unheads(o)
    qh = _prep(_heads(q, num_heads), cosq, sinq, eps_q).to(q.dtype)
    kh = _prep(_heads(k, num_heads), cosk, sink, eps_k).to(k.dtype)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, _heads(v, num_heads))
    return o.transpose(1, 2).reshape(b, n, f)


def default_block_k(n: int) -> int:
    """JAX's streaming K block for n tokens: the 128-padded length cut into
    the fewest equal chunks of at most ~2176 rows, rounded up to 128
    (sd3_tpu/ops/fused_attention.py:563)."""
    n128 = _round_up(n, 128)
    return min(_round_up(-(-n128 // -(-n128 // STREAM_BLOCK)), 128), n128)


def composition_stream(q, k, v, cosq, sinq, cosk, sink, scale: float,
                       eps_q: float, eps_k: float, num_heads: int,
                       block_k: int | None = None, int8_pv: bool = False
                       ) -> torch.Tensor:
    """Plain PyTorch version of K7 (and with int8_pv of K8b over K7's
    scores): the JAX streaming kernel's arithmetic
    (sd3_tpu/ops/fused_attention.py:364-427). q^ from the q tables times
    scale*log2(e), q^ and k^ rounded to the input dtype, fp32 scores, an
    online softmax in exp2 over blocks of `block_k` keys (default: JAX's
    rule, `default_block_k`; K7 on the card takes `K7_KEY_TILE`, at head
    dim 256 `K7_KEY_TILE_256`, at 384 and 512 `K7_KEY_TILE_512`, K8b
    `K8B_KEY_TILE`: `stream_key_tile`).
    Tables
    un-scaled, as for `composition`."""
    n = q.shape[1]
    o = _online(_float_scores(q, k, cosq, sinq, cosk, sink, scale, eps_q,
                              eps_k, num_heads), v, num_heads, n,
                block_k or default_block_k(n), int8_pv)
    return _unheads(o)


def composition_stream_int8_qk(q, k, v, cosq, sinq, cosk, sink, scale: float,
                               eps_q: float, eps_k: float, num_heads: int,
                               block_k: int | None = None,
                               int8_pv: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K7q (and with int8_pv of K8b over K7q's
    scores): the JAX streaming int8_qk branch (`_prep_xla`, `_q8_rows_xla`,
    sd3_tpu/ops/fused_attention.py:483-508, 383-396). k^ prepped in fp32
    and quantized per row per head from fp32 (not rounded to the input
    dtype first, unlike K4); q^ per row from fp32 with the fold;
    s = s32 * s_q * s_k[key]; the online softmax of `composition_stream`."""
    n = q.shape[1]
    o = _online(_int8_scores(q, k, cosq, sinq, cosk, sink, scale, eps_q,
                             eps_k, num_heads, per_row_k=True), v, num_heads,
                n, block_k or default_block_k(n), int8_pv)
    return _unheads(o)


def composition_flash(q, k, v, cosq, sinq, cosk, sink, scale: float,
                      eps_q: float, eps_k: float, num_heads: int
                      ) -> torch.Tensor:
    """What K1's backward differentiates, the JAX `_composition`: the plain
    prep cast to the input dtype, then `flash_attention` (K5 / K6)."""
    b, n, f = q.shape
    qh = _prep(_heads(q, num_heads), cosq, sinq, eps_q).to(q.dtype)
    kh = _prep(_heads(k, num_heads), cosk, sink, eps_k).to(k.dtype)
    o = flash_attention(qh, kh, _heads(v, num_heads), scale)
    return o.transpose(1, 2).reshape(b, n, f)


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D)."""
    b, n, f = x.shape
    return x.reshape(b, n, num_heads, f // num_heads).transpose(1, 2)


def _unheads(x: torch.Tensor) -> torch.Tensor:
    """(B, H, N, D) -> (B, N, H*D)."""
    b, h, n, d = x.shape
    return x.transpose(1, 2).reshape(b, n, h * d)


def _prep(x, cos, sin, eps, dn: int | None = None) -> torch.Tensor:
    """Per-head RMSNorm + table rotation, in fp32. dn: the true head dim of
    heads zero-padded past it (tables too), as the kernels' prep takes
    them: the mean of squares over dn values, the padded lanes left zero."""
    xf = x.float()
    if dn is None or dn == x.shape[-1]:
        ms = xf.square().mean(-1, keepdim=True)
    else:
        ms = xf.square().sum(-1, keepdim=True) / dn
    xn = xf * torch.rsqrt(ms + eps)
    return xn * cos.float() + _rotate_half_interleaved(xn) * sin.float()


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Integer-valued fp32 round(x / scale) clipped to +-127 (half to even,
    a true division, as the JAX kernel)."""
    return torch.clamp(torch.round(x / scale), -127, 127)


def composition_int8_qk(q, k, v, cosq, sinq, cosk, sink, scale: float,
                        eps_q: float, eps_k: float, num_heads: int,
                        int8_pv: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K4 (and with int8_pv of K8a over K4's
    scores), the JAX kernel's int8_qk arithmetic
    (sd3_tpu/ops/fused_attention.py:193-205, 246-281): q^ with the tables
    scaled by scale*log2(e), quantized per row from fp32; k^ rounded to the
    input dtype, one scale per (batch, head); s = s32 * (s_q * s_k); the
    true row max; p = exp2(s - max) rounded to v's dtype for P.V, fp32 sums
    (`_online` over one block). Tables un-scaled, as for `composition`."""
    n = q.shape[1]
    o = _online(_int8_scores(q, k, cosq, sinq, cosk, sink, scale, eps_q,
                             eps_k, num_heads, per_row_k=False), v, num_heads,
                n, n, int8_pv)
    return _unheads(o)


def _float_scores(q, k, cosq, sinq, cosk, sink, scale, eps_q, eps_k,
                  num_heads):
    """scores(j0, j1): fp32 q^ k^T of keys [j0, j1) in the exp2 domain, q^
    (tables times scale*log2e) and k^ rounded to the input dtype, as the
    TPU kernels' bf16 branches take them."""
    fold = float(scale) * LOG2E
    qh = _prep(_heads(q, num_heads), cosq.float() * fold, sinq.float() * fold,
               eps_q).to(q.dtype).float()
    kh = _prep(_heads(k, num_heads), cosk, sink, eps_k).to(k.dtype).float()
    return lambda j0, j1: torch.matmul(qh, kh[:, :, j0:j1].transpose(-1, -2))


def _int8_scores(q, k, cosq, sinq, cosk, sink, scale, eps_q, eps_k,
                 num_heads, per_row_k: bool):
    """scores(j0, j1) of the int8_qk branches: q^ per row from fp32 (with
    the fold); k^ per row per head from fp32 with s = s32 * s_q * s_k[key]
    (`per_row_k`, the streaming kernel, K7q), or rounded to the input dtype
    with one scale per (batch, head) and s = s32 * (s_q * s_k) (the
    single-KV kernel, K4). The s32 product runs as an fp32 matmul of integer
    values, exact (|sum| <= 127^2 * D < 2^24) where fp32 matmuls are not
    TF32."""
    fold = float(scale) * LOG2E
    qf = _prep(_heads(q, num_heads), cosq.float() * fold, sinq.float() * fold,
               eps_q)
    kf = _prep(_heads(k, num_heads), cosk, sink, eps_k)
    s_q = scale_of(qf.abs().amax(-1, keepdim=True), Q8_EPS)
    qi = _q8(qf, s_q)
    if per_row_k:
        s_k = scale_of(kf.abs().amax(-1, keepdim=True), Q8_EPS)
        ki, s_kt = _q8(kf, s_k), s_k.transpose(-1, -2)
        return lambda j0, j1: (torch.matmul(qi, ki[:, :, j0:j1].transpose(
            -1, -2)) * s_q * s_kt[..., j0:j1])
    kh = kf.to(k.dtype).float()
    s_k = scale_of(kh.abs().amax((-2, -1), keepdim=True), Q8_EPS)
    ki, comb = _q8(kh, s_k), s_q * s_k
    return lambda j0, j1: torch.matmul(
        qi, ki[:, :, j0:j1].transpose(-1, -2)) * comb


def _v8(vh: torch.Tensor):
    """K8's V: int8 levels per (batch, head, column) over all rows, as
    integer-valued fp64 (for exact products), and the fp32 (B, H, 1, D)
    scales (sd3_tpu/ops/fused_attention.py:229-245, 511-518)."""
    vf = vh.float()
    sc = scale_of(vf.abs().amax(-2, keepdim=True), Q8_EPS)
    return _q8(vf, sc).double(), sc


def _online(scores, v, num_heads: int, n: int, block_k: int,
            int8_pv: bool) -> torch.Tensor:
    """o (B, H, N, D) in v's dtype: the TPU kernels' softmax over blocks of
    `block_k` keys (sd3_tpu/ops/fused_attention.py:398-427; one block is
    the single-KV kernels' true-max softmax). scores(j0, j1) gives fp32
    scores in the exp2 domain. Per block: the running max, p = exp2(s - m),
    alpha = exp2(m_old - m) rescaling l and the accumulator; l sums the
    unrounded p. P.V takes p rounded to v's dtype, or with int8_pv
    pb = exp2(s - (m - log2 127)) in [0, 127] rounded to int8 times V's int8
    levels, an exact integer product (fp64 here, s32 in the kernels), and
    the result times V's column scales."""
    vh = _heads(v, num_heads)
    vq, vsc = _v8(vh) if int8_pv else (vh.float(), None)
    m = l = acc = None
    for j0 in range(0, n, block_k):
        j1 = min(j0 + block_k, n)
        s = scores(j0, j1)
        bmax = s.amax(-1, keepdim=True)
        m_new = bmax if m is None else torch.maximum(m, bmax)
        if int8_pv:
            pb = torch.exp2(s - (m_new - LOG2_127))
            pq = torch.clamp(torch.round(pb), 0, 127).double()
            pv = torch.matmul(pq, vq[:, :, j0:j1]).float()
        else:
            pb = torch.exp2(s - m_new)
            pv = torch.matmul(pb.to(v.dtype).float(), vq[:, :, j0:j1])
        psum = pb.sum(-1, keepdim=True)
        if m is None:
            l, acc = psum, pv
        else:
            alpha = torch.exp2(m - m_new)
            l, acc = l * alpha + psum, acc * alpha + pv
        m = m_new
    o = acc / l
    if int8_pv:
        o = o * vsc
    return o.to(v.dtype)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _pad_heads(x: torch.Tensor, num_heads: int, dp: int) -> torch.Tensor:
    """(B, N, H*d) -> (B, N, H*dp), each head zero-padded to dp values."""
    b, n, f = x.shape
    d = f // num_heads
    return torch.nn.functional.pad(x.reshape(b, n, num_heads, d),
                                   (0, dp - d)).reshape(b, n, num_heads * dp)


def _launch(kern: Kernel, q, k, v, cq, sq, ck, sk, eps_q, eps_k,
            num_heads, int8_qk=False, route: Kernel | None = None):
    """Launch `kern` (K1, K4, K7, K7q, K8a or K8b) through the instance
    `kernel_for` picks, or `route` (one of `kern`'s instances at this head
    dim: the wide mma.sync one at 256, for timing it beside the wgmma one);
    for K8a / K8b `int8_qk` picks the scores under the int8 P.V; tables
    already carry scale*log2(e). Head dims between the instances run
    zero-padded to the next (`flash_attention.instance_dim`). Allocates the
    outputs and the kernels' scratch."""
    b, n, f = q.shape
    d = f // num_heads
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in (
            torch.bfloat16, torch.float32):
        raise TypeError(f"{kern.name} takes bfloat16 or float32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if not (k.shape == v.shape == q.shape):
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (k.device == v.device == q.device):
        raise ValueError("q/k/v must lie on one device")
    if d * num_heads != f or d % 2:
        raise ValueError(f"{f} features / {num_heads} heads: the heads must "
                         "be of one even head dim (the rotation takes pairs)")
    base = kern
    kern = route or kernel_for(base, q.dtype, d)
    wide = kern in _MMA_WIDE
    # the wide instances take every multiple of 128, the others their own
    dp = instance_dim(d) if wide else forward_dim(d, q.dtype)
    cq, sq, ck, sk = (t.to(q.device, torch.float32).contiguous()
                      for t in (cq, sq, ck, sk))
    for t in (cq, sq, ck, sk):
        if t.shape != (n, d):
            raise ValueError(f"tables must be ({n}, {d}), got {tuple(t.shape)}")
    if dp != d:
        q, k, v = (_pad_heads(t, num_heads, dp) for t in (q, k, v))
        cq, sq, ck, sk = (torch.nn.functional.pad(t, (0, dp - d))
                          for t in (cq, sq, ck, sk))
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    bh, dev = b * num_heads, q.device
    if not wide and base in (K1, K7):
        # q^ and k^ in the input dtype, K1's ||q^|| per row (the bf16
        # instances'), max ||k^||^2 per (b, h)
        q_norm = torch.empty(bh * n if base is K1 and kern is not K1F else 0,
                             dtype=torch.float32, device=dev)
        args = [torch.empty_like(q), q_norm, torch.empty_like(k),
                torch.zeros(bh, dtype=torch.float32, device=dev), out]
    else:
        # q^ (int8 under int8 scores, else in q's dtype) and its per-row
        # scales; k^ in k's dtype (float scores, and K4's scores: its prep
        # writes it before quantizing), int8 k^ (int8 scores), k_stat: per
        # (b, h) statistics of the float prep or K4's amax, or the streaming
        # kernels' per-key k scales in rows padded to whole key tiles (their
        # tensor map); V's column amax and its int8 levels (int8 P.V), V^T's
        # keys padded to whole key tiles (csrc/attention_int8_sm90.cu). The
        # wide kernels take the same; K1's ||q^|| per row goes in q_scale,
        # its max ||k^||^2 per (b, h) in k_stat.
        int8_qk = base in (K4, K7Q) or (int8_qk and base in (K8A, K8B))
        per_row = int8_qk and base in (K7Q, K8B)
        pv8 = base in (K8A, K8B)
        tiles = _round_up(n, K8B_KEY_TILE)
        none = torch.empty(0, device=dev)
        k_prep = torch.empty_like(k) if not per_row else none
        k_q = (torch.empty(k.shape, dtype=torch.int8, device=dev)
               if int8_qk else none)
        k_stat = torch.zeros(bh * tiles if per_row else bh,
                             dtype=torch.float32, device=dev)
        v_amax = torch.zeros(bh * dp if pv8 else 0, dtype=torch.float32,
                             device=dev)
        v_q = torch.empty(bh * dp * tiles if pv8 else 0, dtype=torch.int8,
                          device=dev)
        q_prep = (torch.empty(q.shape, dtype=torch.int8, device=dev)
                  if int8_qk else torch.empty_like(q))
        q_scale = torch.empty(bh * n if int8_qk or base is K1 else 0,
                              dtype=torch.float32, device=dev)
        args = [q_prep, q_scale, k_prep, k_q, k_stat, v_amax, v_q, out]
    ints = [b, n, num_heads, dp, d]
    if wide:
        ints.append(_WIDE[base][2])
    if wide or base not in (K1, K7):
        ints.append(int(int8_qk))
    with torch.cuda.device(dev):
        fn = kern.function()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(*(t.data_ptr() for t in (q, k, v, cq, sq, ck, sk, *args)),
                 *ints, eps_q, eps_k, stream)
    check(kern, err)
    kern.launches += 1
    if dp != d:
        out = out.reshape(b, n, num_heads, dp)[..., :d].reshape(b, n, f)
    return out


class _FusedAttention(torch.autograd.Function):
    """K1 or, above the single-KV length, K7 forward (their plain versions
    on the CPU); the backward recomputes through `composition_flash` on the
    saved inputs, at every length (sd3_tpu/ops/fused_attention.py:716-729)."""

    @staticmethod
    def forward(ctx, q, k, v, cosq, sinq, cosk, sink, scale, eps_q, eps_k,
                num_heads, streaming):
        ctx.save_for_backward(q, k, v, cosq, sinq, cosk, sink)
        ctx.consts = (scale, eps_q, eps_k, num_heads)
        args = (q, k, v, cosq, sinq, cosk, sink, scale, eps_q, eps_k,
                num_heads)
        if q.device.type == "cpu":
            return (composition_stream if streaming else composition)(*args)
        kern = K7 if streaming else K1
        if q.device.type != "cuda":
            raise ValueError(f"no {kern.name} path for device {q.device}")
        fold = float(scale) * LOG2E
        return _launch(kern, q, k, v, cosq * fold, sinq * fold, cosk, sink,
                       eps_q, eps_k, num_heads)

    @staticmethod
    def backward(ctx, g):
        need = ctx.needs_input_grad[:7]
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(r)
                   for t, r in zip(ctx.saved_tensors, need)]
            out = composition_flash(*ins, *ctx.consts)
            grads = iter(torch.autograd.grad(
                out, [t for t in ins if t.requires_grad], g))
        return (*(next(grads) if r else None for r in need),
                None, None, None, None, None)


# (int8_qk, int8_pv, streaming) -> the inference kernel and the name of its
# plain version in this module
_INFERENCE = {
    (True, False, False): (K4, "composition_int8_qk"),
    (False, True, False): (K8A, "composition"),
    (True, True, False): (K8A, "composition_int8_qk"),
    (True, False, True): (K7Q, "composition_stream_int8_qk"),
    (False, True, True): (K8B, "composition_stream"),
    (True, True, True): (K8B, "composition_stream_int8_qk"),
}


def fused_attention(q, k, v, num_heads: int, cosq, sinq, cosk, sink,
                    scale: float, int8_qk: bool = False,
                    int8_pv: bool = False,
                    single_kv_max: int = SINGLE_KV_MAX) -> torch.Tensor:
    """Joint attention from folded row tables (see `fold_row_tables`).

    q, k, v: (B, N, H*D) raw projections; tables (N, D) with the norm
    weights folded in but not the softmax scale. Up to `single_kv_max`
    128-padded tokens the single-KV kernels (K1; K4 with int8_qk; K8a with
    int8_pv), above it the streaming ones (K7; K7q; K8b), as
    `_pallas_fused` chooses. CPU tensors take the plain versions; CUDA
    tensors launch a kernel or raise. Differentiable through K1 and K7:
    the int8 kernels raise when an input requires grad."""
    n = q.shape[1]
    streaming = _round_up(n, 128) > single_kv_max
    eps_q = float(torch.finfo(q.dtype).eps)
    eps_k = float(torch.finfo(k.dtype).eps)
    if not (int8_qk or int8_pv):
        return _FusedAttention.apply(q, k, v, cosq, sinq, cosk, sink,
                                     float(scale), eps_q, eps_k, num_heads,
                                     streaming)
    kern, plain = _INFERENCE[(bool(int8_qk), bool(int8_pv), streaming)]
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, cosq, sinq, cosk, sink)):
        raise NotImplementedError(
            f"fused attention int8_qk / int8_pv ({kern.name}) is "
            "inference-only: its gradient would be the float composition's "
            "(sd3_tpu/ops/fused_attention.py:716-723); train with "
            "quant='none'")
    if q.device.type == "cpu":
        kw = dict(int8_pv=True) if int8_pv else {}
        return globals()[plain](q, k, v, cosq, sinq, cosk, sink, scale, eps_q,
                                eps_k, num_heads, **kw)
    if q.device.type != "cuda":
        raise ValueError(f"no {kern.name} path for device {q.device}")
    fold = float(scale) * LOG2E
    return _launch(kern, q, k, v, cosq * fold, sinq * fold, cosk, sink, eps_q,
                   eps_k, num_heads, int8_qk)


def fused_dual_flash_attention(q, k, v, num_heads: int, w_q_img, w_q_txt,
                               w_k_img, w_k_txt, angles_img, n_img: int,
                               scale: float, int8_qk: bool = False,
                               int8_pv: bool = False) -> torch.Tensor:
    """Joint-sequence attention with fused per-head RMSNorm + image-only RoPE,
    in the JAX function's layout.

    q, k, v: (B, N, num_heads*D) raw projections; rows [0, n_img) are image
    tokens, the rest text. w_*_img / w_*_txt: (D,) RMSNorm weights of each
    stream. angles_img: (n_img, D) numpy rotation angles, or None (NoPE).
    """
    b, n, f = q.shape
    d = f // num_heads
    cos, sin = (torch.as_tensor(t, device=q.device)
                for t in rope_row_tables(angles_img, n, d))
    cosq, sinq = fold_row_tables(cos, sin, w_q_img, w_q_txt, n_img)
    cosk, sink = fold_row_tables(cos, sin, w_k_img, w_k_txt, n_img)
    return fused_attention(q, k, v, num_heads, cosq, sinq, cosk, sink, scale,
                           int8_qk, int8_pv)
