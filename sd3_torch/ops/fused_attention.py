"""Fused q/k-RMSNorm + RoPE joint attention (JAX counterpart:
sd3_tpu/ops/fused_attention.py).

Kernel K1, `csrc/fused_attention.cu`, replaces the TPU kernel
`sd3_tpu/ops/fused_attention.py::_fused_fwd_kernel` (bf16 branch, <= 2048
padded tokens). Raw q/k/v projections (B, N, H*D) go in; the kernel applies
the per-head RMSNorm and the interleaved-pair rotation itself, with the
per-stream norm weights folded into per-row cos/sin tables (text rows get
cos = W, sin = 0) and the softmax scale * log2(e) folded into the q tables,
and runs the softmax in exp2 against the bound ||q^|| * max||k^||. The
design note (what bounds it on an H100, what the two launches do) heads the
CUDA source.

Kernel K4, the same source's `sd3_fused_attention_int8qk`, replaces the
`int8_qk` branch of that TPU kernel: QK^T as s8 x s8 -> s32 with q^
quantized per row from fp32, k^ rounded to the input dtype and quantized
with one scale per (batch, head), and the true row max as the softmax
shift; P.V stays in bf16. The int8 P.V branch (TPU kernel K8) is not
ported yet and raises.

Beside them: `composition` and `composition_int8_qk`, the plain PyTorch
versions of the two functions (the JAX kernel's arithmetic), which the
wrapper takes for tensors on the CPU, and the table helpers
`rope_row_tables`, `_swap_pairs` and `fold_row_tables`. On a CUDA tensor
the wrapper launches a kernel or raises: there is no fallback.

K1 is differentiable: `_FusedAttention`, an autograd Function, runs K1 (or
its plain version) forward and, as the JAX package's `_fused_core_bwd`
does, differentiates the plain prep followed by `flash_attention` (K5, K6a,
K6b on the card) in its backward, with gradients for q, k, v and the four
tables (`fold_row_tables` carries those on to the norm weights). K4 is for
inference only, as in the JAX package: it raises when an input requires
grad.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sd3_torch.kernels import Kernel, check
from sd3_torch.ops.flash_attention import flash_attention
from sd3_torch.ops.quant import scale_of
from sd3_torch.ops.rope import _rotate_half_interleaved

LOG2E = 1.4426950408889634  # the kernel's softmax runs in exp2
SINGLE_KV_MAX = 2048        # padded tokens one K1 call takes (beyond: K7)
HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K1 = Kernel("fused_attention_bf16", "fused_attention.cu",
            "sd3_fused_attention_bf16",
            argtypes=[_P] * 10 + [_I] * 4 + [_F] * 2 + [_P])
K4 = Kernel("fused_attention_int8qk", "fused_attention.cu",
            "sd3_fused_attention_int8qk",
            argtypes=[_P] * 11 + [_I] * 4 + [_F] * 2 + [_P])
Q8_EPS = 1e-12  # K4's q / k scale floor (JAX fused_attention.py:122,256)


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
                eps_k: float, num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of K1: per-head RMSNorm + table rotation in fp32
    (cast back to the input dtype), then softmax(q^ k^T * scale) v with fp32
    logits. Tables here are un-scaled (no scale*log2e fold)."""
    b, n, f = q.shape
    qh = _prep(_heads(q, num_heads), cosq, sinq, eps_q).to(q.dtype)
    kh = _prep(_heads(k, num_heads), cosk, sink, eps_k).to(k.dtype)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, _heads(v, num_heads))
    return o.transpose(1, 2).reshape(b, n, f)


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


def _heads(x: torch.Tensor, num_heads: int) -> torch.Tensor:
    """(B, N, H*D) -> (B, H, N, D)."""
    b, n, f = x.shape
    return x.reshape(b, n, num_heads, f // num_heads).transpose(1, 2)


def _prep(x, cos, sin, eps) -> torch.Tensor:
    """Per-head RMSNorm + table rotation, in fp32."""
    xf = x.float()
    xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
    return xn * cos.float() + _rotate_half_interleaved(xn) * sin.float()


def _q8(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """Integer-valued fp32 round(x / scale) clipped to +-127 (half to even,
    a true division, as the JAX kernel)."""
    return torch.clamp(torch.round(x / scale), -127, 127)


def composition_int8_qk(q, k, v, cosq, sinq, cosk, sink, scale: float,
                        eps_q: float, eps_k: float, num_heads: int
                        ) -> torch.Tensor:
    """Plain PyTorch version of K4, the JAX kernel's int8_qk arithmetic
    (sd3_tpu/ops/fused_attention.py:193-205, 246-281): q^ with the tables
    scaled by scale*log2(e), quantized per row from fp32; k^ rounded to the
    input dtype, one scale per (batch, head); s = s32 * s_q * s_k; the true
    row max; p = exp2(s - max) rounded to v's dtype for P.V, fp32 sums.
    Tables un-scaled, as for `composition`. The s32 product runs as an fp32
    matmul of integer values, exact (|sum| <= 127^2 * D < 2^24) where fp32
    matmuls are not TF32."""
    b, n, f = q.shape
    fold = float(scale) * LOG2E
    qf = _prep(_heads(q, num_heads), cosq.float() * fold, sinq.float() * fold,
               eps_q)
    kh = _prep(_heads(k, num_heads), cosk, sink, eps_k).to(k.dtype).float()
    s_q = scale_of(qf.abs().amax(-1, keepdim=True), Q8_EPS)
    s_k = scale_of(kh.abs().amax((-2, -1), keepdim=True), Q8_EPS)
    s32 = torch.matmul(_q8(qf, s_q), _q8(kh, s_k).transpose(-1, -2))
    s = s32 * (s_q * s_k)
    p = torch.exp2(s - s.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), _heads(v, num_heads).float()) / l
    return o.to(v.dtype).transpose(1, 2).reshape(b, n, f)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch(kern: Kernel, q, k, v, cq, sq, ck, sk, eps_q, eps_k,
            num_heads):
    """Launch K1 or K4 (`kern`); tables already carry scale*log2(e)."""
    b, n, f = q.shape
    d = f // num_heads
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"{kern.name} takes bfloat16 q/k/v, got {q.dtype}/"
                        f"{k.dtype}/{v.dtype}")
    if not (k.shape == v.shape == q.shape):
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (k.device == v.device == q.device):
        raise ValueError("q/k/v must lie on one device")
    if d not in HEAD_DIMS or d * num_heads != f:
        raise NotImplementedError(
            f"{kern.name} takes head dims {HEAD_DIMS}; got {f} features / "
            f"{num_heads} heads")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    cq, sq, ck, sk = (t.to(q.device, torch.float32).contiguous()
                      for t in (cq, sq, ck, sk))
    for t in (cq, sq, ck, sk):
        if t.shape != (n, d):
            raise ValueError(f"tables must be ({n}, {d}), got {tuple(t.shape)}")
    out = torch.empty_like(q)
    k_prep = torch.empty_like(k)
    k_max = torch.zeros(b * num_heads, dtype=torch.float32, device=q.device)
    scratch = [k_prep.data_ptr()]
    if kern is K4:
        k_q = torch.empty(k.shape, dtype=torch.int8, device=k.device)
        scratch.append(k_q.data_ptr())
    with torch.cuda.device(q.device):
        fn = kern.function()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cq.data_ptr(),
                 sq.data_ptr(), ck.data_ptr(), sk.data_ptr(), *scratch,
                 k_max.data_ptr(), out.data_ptr(), b, n, num_heads, d, eps_q,
                 eps_k, stream)
    check(kern, err)
    kern.launches += 1
    return out


class _FusedAttention(torch.autograd.Function):
    """K1 forward (its plain version on the CPU); the backward recomputes
    through `composition_flash` on the saved inputs."""

    @staticmethod
    def forward(ctx, q, k, v, cosq, sinq, cosk, sink, scale, eps_q, eps_k,
                num_heads):
        ctx.save_for_backward(q, k, v, cosq, sinq, cosk, sink)
        ctx.consts = (scale, eps_q, eps_k, num_heads)
        if q.device.type == "cpu":
            return composition(q, k, v, cosq, sinq, cosk, sink, scale, eps_q,
                               eps_k, num_heads)
        if q.device.type != "cuda":
            raise ValueError(f"no {K1.name} path for device {q.device}")
        fold = float(scale) * LOG2E
        return _launch(K1, q, k, v, cosq * fold, sinq * fold, cosk, sink,
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
                None, None, None, None)


def fused_attention(q, k, v, num_heads: int, cosq, sinq, cosk, sink,
                    scale: float, int8_qk: bool = False,
                    int8_pv: bool = False) -> torch.Tensor:
    """Joint attention from folded row tables (see `fold_row_tables`).

    q, k, v: (B, N, H*D) raw projections; tables (N, D) with the norm
    weights folded in but not the softmax scale. CPU tensors take the plain
    versions; CUDA tensors launch K1 (bf16 QK^T) or K4 (int8_qk), or
    raise. Differentiable through K1 only: K4 raises when an input requires
    grad."""
    if int8_pv:
        raise NotImplementedError(
            "int8 P.V attention (TPU kernel K8) is not ported yet: "
            "ROADMAP.md, kernel queue")
    b, n, f = q.shape
    if -(-n // 128) * 128 > SINGLE_KV_MAX:
        raise NotImplementedError(
            f"{n} tokens need the streaming kernel (TPU kernel K7, "
            "_stream_fwd_kernel), not ported yet: ROADMAP.md, kernel queue")
    eps_q = float(torch.finfo(q.dtype).eps)
    eps_k = float(torch.finfo(k.dtype).eps)
    if not int8_qk:
        return _FusedAttention.apply(q, k, v, cosq, sinq, cosk, sink,
                                     float(scale), eps_q, eps_k, num_heads)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v, cosq, sinq, cosk, sink)):
        raise NotImplementedError(
            "int8 QK^T attention (K4) is inference-only: its gradient would "
            "be the float composition's (sd3_tpu/ops/fused_attention.py:"
            "716-723); train with quant='none'")
    if q.device.type == "cpu":
        return composition_int8_qk(q, k, v, cosq, sinq, cosk, sink, scale,
                                   eps_q, eps_k, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no {K4.name} path for device {q.device}")
    fold = float(scale) * LOG2E
    return _launch(K4, q, k, v, cosq * fold, sinq * fold, cosk, sink, eps_q,
                   eps_k, num_heads)


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
