"""Flash attention for training (JAX counterpart:
sd3_tpu/ops/flash_attention.py).

`flash_attention(q, k, v, scale)` is softmax(q k^T * scale) v on (B, H, N, D)
tensors, non-causal, as a `torch.autograd.Function` whose forward saves q,
k, v, the output and the fp32 logsumexp, and whose backward recomputes p
from them, as the JAX custom VJP does. Three kernels, each source's head
saying what bounds them and how they are built:

- K5 `flash_attention_fwd` replaces the TPU kernel `_fwd_kernel`: out, lse
  (`csrc/attention_sm90.cu`, the Hopper attention kernel of K1 and K7 with
  an online softmax on raw q, k, v, one launch);
- K6a `flash_attention_dq` replaces `_dq_kernel`: dq, and on the way
  delta = rowsum(dO * out) in fp32, which the JAX package computes in XLA
  between the kernels and K6b reads;
- K6b `flash_attention_dkv` replaces `_dkv_kernel`: dk, dv
  (K6a and K6b: `csrc/flash_bwd_sm90.cu`).
All three are wgmma + TMA kernels with a warp-specialised ring, on bf16
tensors. fp32 tensors (JAX's fp32 kernels run their products at
Precision.HIGHEST) take their fp32 instances K5F, K6AF and K6BF
(`csrc/attention_fp32.cu`: 3xTF32 mma.sync, fp32-accurate products).

The kernels have instances at head dims `HEAD_DIMS` (16, 32, 64, 128).
Any other head dim up to 128 is zero-padded to the next instance, as the
JAX wrapper pads D to 128 lanes: q, k, v (and out, dO) padded on D, the
kernel run with the caller's scale, and out, dq, dk, dv sliced back. Zero
columns add nothing to the scores, to lse or to delta.

Their wrappers are `flash_fwd`, `flash_dq` and `flash_dkv`. Beside them,
their plain PyTorch versions `flash_fwd_plain`, `flash_dq_plain` and
`flash_dkv_plain`, which repeat the TPU kernels' arithmetic: fp32 logits
from input-dtype operands times `scale`; the true row max; p rounded to v's
dtype before P.V; lse = m + log(l); in the backward p = exp(s - lse),
ds = p (dp - delta) rounded to the input dtype, dq = ds k scale,
dv = p^T dO, dk = ds^T q scale; results in the input dtype. They need no
padding, so there are no padded keys to mask. The wrappers take them for
tensors on the CPU; on a CUDA tensor they launch the kernel or raise. K5
runs an online softmax over 128-key tiles where the plain version takes the
true row max (csrc/attention_sm90.cu says what that changes).

The kernels read each tensor in place through TMA tensor maps built from
its (b, h, n) strides when the head dim is contiguous and the start and the
strides are positive multiples of 16 bytes, else the wrapper makes one
contiguous copy. The port's attention hands over q, k, v (and autograd dO)
that way, so the training path makes no copy. Outputs are
(B, H, N, D) views of (B, N, H, D) buffers, so the caller's (B, N, H*D)
reshape copies nothing.
The TPU layout choices (the 8-lane lse, the VMEM budget and the unroll
knob) have no counterpart here; head dims above 128 are not taken.
"""

from __future__ import annotations

import ctypes

import torch

from sd3_torch.kernels import Kernel, check

HEAD_DIMS = (16, 32, 64, 128)   # the kernels' instances

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
_FWD_ARGS = [_P] * 5 + [_STRIDES] + [_I] * 4 + [_F, _P]
_BWD_ARGS = [_P] * 8 + [_STRIDES] + [_I] * 4 + [_F, _P]
K5 = Kernel("flash_attention_fwd", "attention_sm90.cu",
            "sd3_flash_attention_fwd", argtypes=_FWD_ARGS)
K6A = Kernel("flash_attention_dq", "flash_bwd_sm90.cu",
             "sd3_flash_attention_dq", argtypes=_BWD_ARGS)
K6B = Kernel("flash_attention_dkv", "flash_bwd_sm90.cu",
             "sd3_flash_attention_dkv", argtypes=_BWD_ARGS)
# the fp32 instances (one source, csrc/attention_fp32.cu)
K5F = Kernel("flash_attention_fwd_fp32", "attention_fp32.cu",
             "sd3_flash_attention_fwd_fp32", argtypes=_FWD_ARGS)
K6AF = Kernel("flash_attention_dq_fp32", "attention_fp32.cu",
              "sd3_flash_attention_dq_fp32", argtypes=_BWD_ARGS)
K6BF = Kernel("flash_attention_dkv_fp32", "attention_fp32.cu",
              "sd3_flash_attention_dkv_fp32", argtypes=_BWD_ARGS)


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
    (b, h, n) strides positive multiples of 16 bytes, as TMA and the fp32
    kernels' 16-byte loads require), else a contiguous copy."""
    per16 = 16 // x.element_size()
    if (x.stride(-1) == 1 and all(s > 0 and s % per16 == 0
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


def instance_dim(d: int) -> int:
    """The kernel instance that takes head dim d: the least of HEAD_DIMS at
    least d; NotImplementedError past the largest."""
    for e in HEAD_DIMS:
        if d <= e:
            return e
    raise NotImplementedError(
        f"the flash kernels take head dims up to {HEAD_DIMS[-1]}; got {d}")


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t zero-padded on its last (head) dim to dp values."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def _check_cuda(kerns, *ts) -> Kernel:
    """The kernel of `kerns` (bf16, fp32) that takes tensors `ts`, checked:
    one CUDA device, one dtype, one (B, H, N, D) shape, D up to 128."""
    q = ts[0]
    kern = kerns[q.dtype == torch.float32]
    if q.device.type != "cuda":
        raise ValueError(f"no {kern.name} path for device {q.device}")
    for t in ts:
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"{kern.name} takes bfloat16 or float32 tensors "
                            f"of one dtype, got {t.dtype} and {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{kern.name}: tensors on {t.device} and "
                             f"{q.device}")
        if t.shape != q.shape:
            raise ValueError(f"{kern.name}: shapes {tuple(t.shape)} and "
                             f"{tuple(q.shape)} differ")
    if q.ndim != 4:
        raise NotImplementedError(
            f"{kern.name} takes (B, H, N, D); got {tuple(q.shape)}")
    instance_dim(q.shape[-1])
    return kern


def _stats(lse: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """lse / delta as the kernels read them: (B, H, N) fp32, contiguous."""
    if lse.shape != like.shape[:3]:
        raise ValueError(f"statistics of shape {tuple(lse.shape)} for "
                         f"tensors of shape {tuple(like.shape)}")
    return lse.to(like.device, torch.float32).contiguous()


def _padded_dim(q: torch.Tensor) -> int:
    """The head dim the tensors of q's call are padded to: the instance of
    q's head dim; a CPU call past the largest runs its plain version
    unpadded."""
    d = q.shape[-1]
    if q.device.type == "cpu" and d > HEAD_DIMS[-1]:
        return d
    return instance_dim(d)


def _operands(ts, dp):
    """Each tensor padded to head dim dp and, on the card, readable in place
    or copied."""
    ts = [_pad(t, dp) for t in ts]
    return ts if ts[0].device.type == "cpu" else [_readable(t) for t in ts]


def flash_fwd(q, k, v, scale: float):
    """K5 (fp32 tensors: K5F): (out in q's dtype, lse fp32 (B, H, N)); its
    plain version on the CPU."""
    if q.device.type != "cpu":
        kern = _check_cuda((K5, K5F), q, k, v)
    b, h, n, d = q.shape
    dp = _padded_dim(q)
    q, k, v = _operands((q, k, v), dp)
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, scale)
    else:
        out = _bnhd(q.shape, q)
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        _launch(kern, (q, k, v, out, lse), (q, k, v, out), b, h, n, dp, scale)
    return out[..., :d], lse


def flash_dq(q, k, v, out, dout, lse, scale: float):
    """K6a (fp32 tensors: K6AF): (dq, delta fp32 (B, H, N)); its plain
    version on the CPU."""
    if q.device.type != "cpu":
        kern = _check_cuda((K6A, K6AF), q, k, v, out, dout)
    b, h, n, d = q.shape
    dp = _padded_dim(q)
    q, k, v, out, dout = _operands((q, k, v, out, dout), dp)
    if q.device.type == "cpu":
        dq, delta = flash_dq_plain(q, k, v, out, dout, lse, scale)
    else:
        lse = _stats(lse, q)
        delta = torch.empty_like(lse)
        dq = _bnhd(q.shape, q)
        _launch(kern, (q, k, v, out, dout, lse, delta, dq),
                (q, k, v, out, dout, dq), b, h, n, dp, scale)
    return dq[..., :d], delta


def flash_dkv(q, k, v, dout, lse, delta, scale: float):
    """K6b (fp32 tensors: K6BF): (dk, dv) from the delta K6a returned; its
    plain version on the CPU."""
    if q.device.type != "cpu":
        kern = _check_cuda((K6B, K6BF), q, k, v, dout)
    b, h, n, d = q.shape
    dp = _padded_dim(q)
    q, k, v, dout = _operands((q, k, v, dout), dp)
    if q.device.type == "cpu":
        dk, dv = flash_dkv_plain(q, k, v, dout, lse, delta, scale)
    else:
        lse, delta = _stats(lse, q), _stats(delta, q)
        dk, dv = _bnhd(q.shape, q), _bnhd(q.shape, q)
        _launch(kern, (q, k, v, dout, lse, delta, dk, dv),
                (q, k, v, dout, dk, dv), b, h, n, dp, scale)
    return dk[..., :d], dv[..., :d]


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
