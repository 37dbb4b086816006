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

Beside it: `composition`, the plain PyTorch version of the same function
(the JAX `_composition` with a plain softmax), which the wrapper takes for
tensors on the CPU, and the table helpers `rope_row_tables`, `_swap_pairs`
and `fold_row_tables`. On a CUDA tensor the wrapper launches the kernel or
raises: there is no fallback. Inference only: the backward recomputes
through the training kernels K5/K6, which are not ported yet.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from sd3_torch.kernels import Kernel, check
from sd3_torch.ops.rope import _rotate_half_interleaved

LOG2E = 1.4426950408889634  # the kernel's softmax runs in exp2
SINGLE_KV_MAX = 2048        # padded tokens one K1 call takes (beyond: K7)
HEAD_DIMS = (16, 32, 64, 128)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
K1 = Kernel("fused_attention_bf16", "fused_attention.cu",
            "sd3_fused_attention_bf16",
            argtypes=[_P] * 10 + [_I] * 4 + [_F] * 2 + [_P])


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
    d = f // num_heads

    def heads(x):
        return x.reshape(b, n, num_heads, d).transpose(1, 2)

    def prep(x, cos, sin, eps):
        xf = x.float()
        xn = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)
        out = xn * cos.float() + _rotate_half_interleaved(xn) * sin.float()
        return out.to(x.dtype)

    qh = prep(heads(q), cosq, sinq, eps_q)
    kh = prep(heads(k), cosk, sink, eps_k)
    logits = torch.matmul(qh.float(), kh.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    o = torch.matmul(probs, heads(v))
    return o.transpose(1, 2).reshape(b, n, f)


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """Contiguous with a 16-byte aligned start (the kernel's vector loads)."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def _launch_k1(q, k, v, cq, sq, ck, sk, eps_q, eps_k, num_heads):
    b, n, f = q.shape
    d = f // num_heads
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"K1 takes bfloat16 q/k/v, got {q.dtype}/{k.dtype}/"
                        f"{v.dtype}")
    if not (k.shape == v.shape == q.shape):
        raise ValueError(f"q/k/v shapes differ: {q.shape} {k.shape} {v.shape}")
    if not (k.device == v.device == q.device):
        raise ValueError("q/k/v must lie on one device")
    if d not in HEAD_DIMS or d * num_heads != f:
        raise NotImplementedError(
            f"K1 takes head dims {HEAD_DIMS}; got {f} features / "
            f"{num_heads} heads")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    cq, sq, ck, sk = (t.to(q.device, torch.float32).contiguous()
                      for t in (cq, sq, ck, sk))
    for t in (cq, sq, ck, sk):
        if t.shape != (n, d):
            raise ValueError(f"tables must be ({n}, {d}), got {tuple(t.shape)}")
    out = torch.empty_like(q)
    k_prep = torch.empty_like(k)
    k_max2 = torch.zeros(b * num_heads, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        fn = K1.function()
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), cq.data_ptr(),
                 sq.data_ptr(), ck.data_ptr(), sk.data_ptr(),
                 k_prep.data_ptr(), k_max2.data_ptr(), out.data_ptr(),
                 b, n, num_heads, d, eps_q, eps_k, stream)
    check(K1, err)
    K1.launches += 1
    return out


def fused_attention(q, k, v, num_heads: int, cosq, sinq, cosk, sink,
                    scale: float, int8_qk: bool = False,
                    int8_pv: bool = False) -> torch.Tensor:
    """Joint attention from folded row tables (see `fold_row_tables`).

    q, k, v: (B, N, H*D) raw projections; tables (N, D) with the norm
    weights folded in but not the softmax scale. CPU tensors take the plain
    version; CUDA tensors launch K1 (bf16) or raise."""
    if int8_qk or int8_pv:
        raise NotImplementedError(
            "int8 QK^T / P.V attention (TPU kernels K4 / K8) is not ported "
            "yet: ROADMAP.md, kernel queue (int8 serving slice)")
    b, n, f = q.shape
    if -(-n // 128) * 128 > SINGLE_KV_MAX:
        raise NotImplementedError(
            f"{n} tokens need the streaming kernel (TPU kernel K7, "
            "_stream_fwd_kernel), not ported yet: ROADMAP.md, kernel queue")
    eps_q = float(torch.finfo(q.dtype).eps)
    eps_k = float(torch.finfo(k.dtype).eps)
    if q.device.type == "cpu":
        return composition(q, k, v, cosq, sinq, cosk, sink, scale, eps_q,
                           eps_k, num_heads)
    if q.device.type != "cuda":
        raise ValueError(f"no K1 path for device {q.device}")
    fold = float(scale) * LOG2E
    return _launch_k1(q, k, v, cosq * fold, sinq * fold, cosk, sink, eps_q,
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
