"""Flash attention for training (JAX counterpart:
sd3_tpu/ops/flash_attention.py).

`flash_attention(q, k, v, scale)` is softmax(q k^T * scale) v on (B, H, N, D)
tensors, non-causal, as a `torch.autograd.Function` whose forward saves q,
k, v, the output and the fp32 logsumexp, and whose backward recomputes p
from them, as the JAX custom VJP does. Three kernels, each source's head
saying what bounds them and how they are built:

- K5 `flash_attention_fwd` replaces the TPU kernel `_fwd_kernel`: out, lse
  (`csrc/flash_attention.cu`, mma.sync);
- K6a `flash_attention_dq` replaces `_dq_kernel`: dq, and on the way
  delta = rowsum(dO * out) in fp32, which the JAX package computes in XLA
  between the kernels and K6b reads;
- K6b `flash_attention_dkv` replaces `_dkv_kernel`: dk, dv
  (K6a and K6b: `csrc/flash_bwd_sm90.cu`, wgmma and TMA).

Their wrappers are `flash_fwd`, `flash_dq` and `flash_dkv`. Beside them,
their plain PyTorch versions `flash_fwd_plain`, `flash_dq_plain` and
`flash_dkv_plain`, which repeat the TPU kernels' arithmetic: fp32 logits
from input-dtype operands times `scale`; the true row max; p rounded to v's
dtype before P.V; lse = m + log(l); in the backward p = exp(s - lse),
ds = p (dp - delta) rounded to the input dtype, dq = ds k scale,
dv = p^T dO, dk = ds^T q scale; results in the input dtype. They need no
padding, so there are no padded keys to mask. The wrappers take them for
tensors on the CPU; on a CUDA tensor they launch the kernel or raise. K5
runs an online softmax where the plain version takes the true row max
(csrc/flash_attention.cu says what that changes).

The kernels read each tensor in place through its (b, h, n) strides (K6a
and K6b through TMA tensor maps built from them) when the head dim is
contiguous and the start and the strides are positive multiples of 16
bytes, else the wrapper makes one contiguous copy. The port's attention hands over q, k, v (and
autograd dO) that way, so the training path makes no copy. Outputs are
(B, H, N, D) views of (B, N, H, D) buffers, so the caller's (B, N, H*D)
reshape copies nothing.
The TPU layout choices (the 128-lane head-dim pad, the 8-lane lse, the VMEM
budget and the unroll knob) have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from sd3_torch.kernels import Kernel, check

HEAD_DIMS = (32, 64)   # head dims the kernels take

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
K5 = Kernel("flash_attention_fwd", "flash_attention.cu",
            "sd3_flash_attention_fwd",
            argtypes=[_P] * 5 + [_STRIDES] + [_I] * 4 + [_F, _P])
K6A = Kernel("flash_attention_dq", "flash_bwd_sm90.cu",
             "sd3_flash_attention_dq",
             argtypes=[_P] * 8 + [_STRIDES] + [_I] * 4 + [_F, _P])
K6B = Kernel("flash_attention_dkv", "flash_bwd_sm90.cu",
             "sd3_flash_attention_dkv",
             argtypes=[_P] * 8 + [_STRIDES] + [_I] * 4 + [_F, _P])


# ---- plain versions ------------------------------------------------------

def _logits(q, k, scale: float) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_fwd_plain(q, k, v, scale: float):
    """Plain version of K5: (out in q's dtype, lse fp32 (B, H, N))."""
    s = _logits(q, k, scale)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float()) / l
    return o.to(q.dtype), (m + torch.log(l)).squeeze(-1)


def flash_dq_plain(q, k, v, out, dout, lse, scale: float):
    """Plain version of K6a: (dq in q's dtype, delta fp32 (B, H, N))."""
    delta = (dout.float() * out.float()).sum(-1)
    p = torch.exp(_logits(q, k, scale) - lse[..., None])
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(k.dtype)
    dq = torch.matmul(ds.float(), k.float()) * scale
    return dq.to(q.dtype), delta


def flash_dkv_plain(q, k, v, dout, lse, delta, scale: float):
    """Plain version of K6b: (dk in k's dtype, dv in v's dtype)."""
    p = torch.exp(_logits(q, k, scale) - lse[..., None])
    dv = torch.matmul(p.to(dout.dtype).float().transpose(-1, -2), dout.float())
    dp = torch.matmul(dout.float(), v.float().transpose(-1, -2))
    ds = (p * (dp - delta[..., None])).to(q.dtype)
    dk = torch.matmul(ds.float().transpose(-1, -2), q.float()) * scale
    return dk.to(k.dtype), dv.to(v.dtype)


# ---- kernels -------------------------------------------------------------

def _readable(x: torch.Tensor) -> torch.Tensor:
    """x if the kernels can read it in place (head dim contiguous, start and
    (b, h, n) strides positive multiples of 16 bytes, as TMA requires), else
    a contiguous copy."""
    if (x.stride(-1) == 1 and all(s > 0 and s % 8 == 0
                                  for s in x.stride()[:3])
            and x.data_ptr() % 16 == 0):
        return x
    return x.contiguous()


def _bnhd(shape, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised (B, H, N, D) view of a (B, N, H, D) buffer."""
    b, h, n, d = shape
    return torch.empty((b, n, h, d), dtype=like.dtype,
                       device=like.device).transpose(1, 2)


def _strides(*ts):
    vals = [s for t in ts for s in t.stride()[:3]]
    return (ctypes.c_longlong * len(vals))(*vals)


def _launch(kern: Kernel, tensors, strided, b, h, n, d, scale):
    with torch.cuda.device(tensors[0].device):
        fn = kern.function()
        # the stream at launch time: autograd runs backward on its own thread
        stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), _strides(*strided), b, h,
                 n, d, float(scale), stream)
    check(kern, err)
    kern.launches += 1


def _check_cuda(kern: Kernel, *ts):
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"no {kern.name} path for device {q.device}")
    for t in ts:
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{kern.name} takes bfloat16 tensors, got {t.dtype}")
        if t.device != q.device:
            raise ValueError(f"{kern.name}: tensors on {t.device} and "
                             f"{q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{kern.name}: shapes {tuple(t.shape)} and "
                             f"{tuple(q.shape)} differ")
    if q.ndim != 4 or q.shape[-1] not in HEAD_DIMS:
        raise NotImplementedError(
            f"{kern.name} takes (B, H, N, D) with D in {HEAD_DIMS}; got "
            f"{tuple(q.shape)}")


def _stats(lse: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """lse / delta as the kernels read them: (B, H, N) fp32, contiguous."""
    if lse.shape != like.shape[:3]:
        raise ValueError(f"statistics of shape {tuple(lse.shape)} for "
                         f"tensors of shape {tuple(like.shape)}")
    return lse.to(like.device, torch.float32).contiguous()


def flash_fwd(q, k, v, scale: float):
    """K5: (out in q's dtype, lse fp32 (B, H, N)); its plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, scale)
    _check_cuda(K5, q, k, v)
    q, k, v = (_readable(t) for t in (q, k, v))
    b, h, n, d = q.shape
    out = _bnhd(q.shape, q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    _launch(K5, (q, k, v, out, lse), (q, k, v, out), b, h, n, d, scale)
    return out, lse


def flash_dq(q, k, v, out, dout, lse, scale: float):
    """K6a: (dq, delta fp32 (B, H, N)); its plain version on the CPU."""
    if q.device.type == "cpu":
        return flash_dq_plain(q, k, v, out, dout, lse, scale)
    _check_cuda(K6A, q, k, v, out, dout)
    q, k, v, out, dout = (_readable(t) for t in (q, k, v, out, dout))
    lse = _stats(lse, q)
    b, h, n, d = q.shape
    delta = torch.empty_like(lse)
    dq = _bnhd(q.shape, q)
    _launch(K6A, (q, k, v, out, dout, lse, delta, dq),
            (q, k, v, out, dout, dq), b, h, n, d, scale)
    return dq, delta


def flash_dkv(q, k, v, dout, lse, delta, scale: float):
    """K6b: (dk, dv) from the delta K6a returned; its plain version on the
    CPU."""
    if q.device.type == "cpu":
        return flash_dkv_plain(q, k, v, dout, lse, delta, scale)
    _check_cuda(K6B, q, k, v, dout)
    q, k, v, dout = (_readable(t) for t in (q, k, v, dout))
    lse, delta = _stats(lse, q), _stats(delta, q)
    b, h, n, d = q.shape
    dk, dv = _bnhd(q.shape, q), _bnhd(q.shape, q)
    _launch(K6B, (q, k, v, dout, lse, delta, dk, dv),
            (q, k, v, dout, dk, dv), b, h, n, d, scale)
    return dk, dv


class _FlashAttention(torch.autograd.Function):
    """K5 forward, K6a + K6b backward (plain versions on the CPU). The
    forward saves out and lse, so the backward recomputes only p."""

    @staticmethod
    def forward(ctx, q, k, v, scale):
        out, lse = flash_fwd(q, k, v, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, delta = flash_dq(q, k, v, out, dout, lse, ctx.scale)
        # K6b reads the delta K6a wrote: both on one stream, in this order
        dk, dv = flash_dkv(q, k, v, dout, lse, delta, ctx.scale)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Non-causal softmax(q k^T * scale) v on (B, H, N, D) tensors of one
    shape; differentiable in q, k and v."""
    if not (q.shape == k.shape == v.shape) or q.ndim != 4:
        raise ValueError(f"q/k/v must be (B, H, N, D) of one shape, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")
    return _FlashAttention.apply(q, k, v, float(scale))
