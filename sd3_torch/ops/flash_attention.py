"""Flash attention for training (JAX counterpart:
sd3_tpu/ops/flash_attention.py).

`flash_attention(q, k, v, scale)` is softmax(q k^T * scale) v, non-causal,
on q of shape (B, H, N, D) and k, v of shape (B, H, M, D), as the JAX
wrapper takes them (`kv_merge_attn` halves the key length M), through the registered op `sd3_torch::flash_fwd`
(`flash_fwd_op`, returning the output and the fp32 logsumexp), whose
autograd saves q, k, v, the output and the logsumexp, and whose backward
recomputes p from them, as the JAX custom VJP does. Being an op of the
dispatcher, it is what the remat policies "attn" and "dots_attn" save
(models/mmdit.py), as JAX's save the kernel's outputs by name. Three kernels, each source's head
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
On bf16 the wgmma kernels have more: at `WGMMA_WIDE` (256) K5_256, K6A_256
and K6B_256, whose 64 x 256 fp32 accumulators take 128 registers of a
consumer thread (K5: 64-key tiles, each consumer's P.V landed before its
next scores; K6a: 32-key tiles; K6b: both consumers on one 64-row item of
keys, one summing dV, the other dK from the first's p, handed over in
shared memory; `csrc/flash_bwd_sm90.cu` says why), and at `WGMMA_SLICED`
(384, 512) K5_384, K5_512, K6A_384, K6A_512, K6B_384 and K6B_512, where
the output is cut into two column slices of D / 2: K5 is the same kernel
with the two consumers of a CTA on the same 64 query rows, each writing
one slice (32-key tiles; `csrc/attention_sm90.cu` says why); K6a's two
consumers also share 64 query rows, one taking p, the other dP, which
they exchange in shared memory, each summing one slice of dq (32-key
tiles at 384, 16 at 512); K6b is K6B_256's split by gradient on one
slice of dk and dv a work item, the slice a grid dimension (32-query
tiles at 384, 16 at 512; `csrc/flash_bwd_sm90.cu`). The forward has two more, at
`WGMMA_PAST_512` (768, 1024): K5_768 and K5_1024, where the output is cut
into four slices of D / 4 and a CTA's two consumers share 64 query rows
and write one pair of slices, the pair a grid dimension (64-key tiles,
K in chunks of 128 values of the head; `csrc/attention_sm90.cu`), so a bf16 forward of 513 to 1024 values runs
padded to 768 or 1024 (`forward_dim`) where its backward keeps the
multiple of 128. Past those, one set
for every multiple of 128: bf16 tensors take K5W (past 1024), K6AW and
K6BW (past 512; `csrc/attention_fp32.cu`: one tf32 product of the exact
bf16 values a step, p and ds rounded to bf16), fp32 tensors K5WF, K6AWF
and K6BWF (3xTF32). Those sum the scores over
128-wide chunks of the head, staged through shared memory a chunk at a
time, and a block writes one 128-wide column slice of the output, so their
shared memory does not grow with the head dim. `flash_kernel` names the
kernel of each (entry point, dtype, head dim). Any other head dim is
zero-padded to the next instance (up to 512 in bf16, 128 in fp32) or
multiple of 128, as the JAX wrapper pads D to a multiple of
128 lanes: q, k, v (and out, dO) padded on D, the kernel run with the
caller's scale, and out, dq, dk, dv sliced back. Zero columns add nothing
to the scores, to lse or to delta.

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
knob) have no counterpart here.
"""

from __future__ import annotations

import ctypes

import torch

from sd3_torch.kernels import Kernel, check

HEAD_DIMS = (16, 32, 64, 128)   # the kernels' instances; past 128 the
WIDE = 128                      # wide ones, at every multiple of WIDE
WGMMA_WIDE = 256                # and the wgmma kernels' bf16 instances past
WGMMA_SLICED = (384, 512)       # 128: at 256, and in two column slices at
                                # 384, 512 (K5, K6a, K6b and the fused
                                # kernels)
WGMMA_PAST_128 = (WGMMA_WIDE, *WGMMA_SLICED)
WGMMA_PAST_512 = (768, 1024)    # and the forwards' past 512, in four
                                # column slices (K5, the fused kernels)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_STRIDES = ctypes.POINTER(ctypes.c_longlong)
# (pointers, strides, B, H, N, M, D, scale, stream)
_FWD_ARGS = [_P] * 5 + [_STRIDES] + [_I] * 5 + [_F, _P]
_BWD_ARGS = [_P] * 8 + [_STRIDES] + [_I] * 5 + [_F, _P]
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
# head dims past 128: bf16 (K5W, K6AW, K6BW past 512) and fp32 (the fp32
# entry points there, counted apart)
K5W = Kernel("flash_attention_fwd_wide", "attention_fp32.cu",
             "sd3_flash_attention_fwd_wide", argtypes=_FWD_ARGS)
K6AW = Kernel("flash_attention_dq_wide", "attention_fp32.cu",
              "sd3_flash_attention_dq_wide", argtypes=_BWD_ARGS)
K6BW = Kernel("flash_attention_dkv_wide", "attention_fp32.cu",
              "sd3_flash_attention_dkv_wide", argtypes=_BWD_ARGS)
K5WF = Kernel("flash_attention_fwd_fp32_wide", "attention_fp32.cu",
              "sd3_flash_attention_fwd_fp32", argtypes=_FWD_ARGS)
K6AWF = Kernel("flash_attention_dq_fp32_wide", "attention_fp32.cu",
               "sd3_flash_attention_dq_fp32", argtypes=_BWD_ARGS)
K6BWF = Kernel("flash_attention_dkv_fp32_wide", "attention_fp32.cu",
               "sd3_flash_attention_dkv_fp32", argtypes=_BWD_ARGS)
# K5 on bf16 at head dims 256 (129 to 256, padded), 384 (257 to 384) and
# 512 (385 to 512): the wgmma kernel's instances there, each counted apart
# from K5's
K5_256 = Kernel("flash_attention_fwd_256", "attention_sm90.cu",
                "sd3_flash_attention_fwd", argtypes=_FWD_ARGS)
K5_384, K5_512 = (Kernel(f"flash_attention_fwd_{d}", "attention_sm90.cu",
                         "sd3_flash_attention_fwd", argtypes=_FWD_ARGS)
                  for d in WGMMA_SLICED)
# and at 768 (513 to 768) and 1024 (769 to 1024)
K5_768, K5_1024 = (Kernel(f"flash_attention_fwd_{d}", "attention_sm90.cu",
                          "sd3_flash_attention_fwd", argtypes=_FWD_ARGS)
                   for d in WGMMA_PAST_512)
# K6a and K6b on bf16 at head dims 256 (129 to 256, padded), 384 (257 to
# 384) and 512 (385 to 512): the wgmma backward's instances there, each
# counted apart from K6A's and K6B's
K6A_256, K6A_384, K6A_512 = (
    Kernel(f"flash_attention_dq_{d}", "flash_bwd_sm90.cu",
           "sd3_flash_attention_dq", argtypes=_BWD_ARGS)
    for d in WGMMA_PAST_128)
K6B_256, K6B_384, K6B_512 = (
    Kernel(f"flash_attention_dkv_{d}", "flash_bwd_sm90.cu",
           "sd3_flash_attention_dkv", argtypes=_BWD_ARGS)
    for d in WGMMA_PAST_128)
_WGMMA = {"fwd": {WGMMA_WIDE: K5_256, 384: K5_384, 512: K5_512,
                 768: K5_768, 1024: K5_1024},
          "dq": {WGMMA_WIDE: K6A_256, 384: K6A_384, 512: K6A_512},
          "dkv": {WGMMA_WIDE: K6B_256, 384: K6B_384, 512: K6B_512}}
# (bf16, fp32) kernels up to 128 and past it
_KERNELS = {
    "fwd": {"small": (K5, K5F), "wide": (K5W, K5WF)},
    "dq": {"small": (K6A, K6AF), "wide": (K6AW, K6AWF)},
    "dkv": {"small": (K6B, K6BF), "wide": (K6BW, K6BWF)},
}


def flash_kernel(which: str, dtype: torch.dtype, d: int) -> Kernel:
    """The kernel of `which` ("fwd", "dq" or "dkv") for tensors of `dtype`
    at head dim d: up to 128 K5 / K6a / K6b (fp32: their F instances); on
    bf16 at 129 to 512 their wgmma instances at 256, 384 and 512 (K5_256,
    K6A_256, K6B_256 .. K6B_512), and the forward's at 513 to 1024 too
    (K5_768, K5_1024); past those, and fp32 at every head dim past 128,
    the wide mma.sync instances (W, WF)."""
    dp = forward_dim(d, dtype) if which == "fwd" else instance_dim(d)
    fp32 = dtype == torch.float32
    if dp in _WGMMA[which] and not fp32:
        return _WGMMA[which][dp]
    size = "wide" if dp > HEAD_DIMS[-1] else "small"
    return _KERNELS[which][size][fp32]


# ---- plain versions ------------------------------------------------------

def _logits(q, k, scale: float) -> torch.Tensor:
    return torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale


def flash_fwd_plain(q, k, v, scale: float):
    """Plain version of K5: (out in q's dtype, lse fp32 (B, H, N)); q
    (B, H, N, D), k and v (B, H, M, D)."""
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
    """Plain version of K6b: (dk in k's dtype, dv in v's dtype), (B, H, M,
    D) like k and v."""
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


def _launch(kern: Kernel, tensors, strided, b, h, n, m, d, scale):
    with torch.cuda.device(tensors[0].device):
        fn = kern.function()
        # the stream at launch time: autograd runs backward on its own thread
        stream = torch.cuda.current_stream(tensors[0].device).cuda_stream
        err = fn(*(t.data_ptr() for t in tensors), _strides(*strided), b, h,
                 n, m, d, float(scale), stream)
    check(kern, err)
    kern.launches += 1


def instance_dim(d: int) -> int:
    """The kernel instance that takes head dim d: the least of HEAD_DIMS at
    least d, past them d rounded up to a multiple of WIDE."""
    for e in HEAD_DIMS:
        if d <= e:
            return e
    return -(-d // WIDE) * WIDE


def forward_dim(d: int, dtype: torch.dtype) -> int:
    """The head dim of the forward instance (K5, and the fused kernels K1
    .. K8b) that takes head dim d on `dtype`: `instance_dim(d)`, but on bf16
    513 to 768 values run at 768 and 769 to 1024 at 1024 (WGMMA_PAST_512),
    past which the wide instances take every multiple of WIDE again."""
    dp = instance_dim(d)
    if dtype != torch.float32 and WGMMA_SLICED[-1] < dp <= WGMMA_PAST_512[-1]:
        return next(e for e in WGMMA_PAST_512 if dp <= e)
    return dp


def _pad(t: torch.Tensor, dp: int) -> torch.Tensor:
    """t zero-padded on its last (head) dim to dp values."""
    d = t.shape[-1]
    return t if d == dp else torch.nn.functional.pad(t, (0, dp - d))


def check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor):
    """q (B, H, N, D), k and v (B, H, M, D): what the JAX wrapper asserts
    (sd3_tpu/ops/flash_attention.py:378-380); a ValueError otherwise."""
    if q.ndim != 4 or k.ndim != 4 or not (
            k.shape == v.shape and k.shape[:2] == q.shape[:2]
            and k.shape[3] == q.shape[3]):
        raise ValueError(f"q must be (B, H, N, D) and k, v (B, H, M, D) of "
                         f"its batch, heads and head dim, got "
                         f"{tuple(q.shape)} {tuple(k.shape)} {tuple(v.shape)}")


def _check_cuda(which: str, rows, keys) -> Kernel:
    """The kernel of `_KERNELS[which]` that takes the query-row tensors
    `rows` (B, H, N, D) and the key-row tensors `keys` (B, H, M, D),
    checked: one CUDA device, one dtype (bf16 or fp32), those shapes."""
    q = rows[0]
    kern = flash_kernel(which, q.dtype, q.shape[-1])
    if q.device.type != "cuda":
        raise ValueError(f"no {kern.name} path for device {q.device}")
    if q.ndim != 4:
        raise NotImplementedError(
            f"{kern.name} takes (B, H, N, D); got {tuple(q.shape)}")
    for t in (*rows, *keys):
        if t.dtype not in (torch.bfloat16, torch.float32) or t.dtype != q.dtype:
            raise TypeError(f"{kern.name} takes bfloat16 or float32 tensors "
                            f"of one dtype, got {t.dtype} and {q.dtype}")
        if t.device != q.device:
            raise ValueError(f"{kern.name}: tensors on {t.device} and "
                             f"{q.device}")
    for group in (rows, keys):
        for t in group:
            if t.shape != group[0].shape:
                raise ValueError(f"{kern.name}: shapes {tuple(t.shape)} and "
                                 f"{tuple(group[0].shape)} differ")
    check_shapes(q, keys[0], keys[0])
    return kern


def _stats(lse: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """lse / delta as the kernels read them: (B, H, N) fp32, contiguous."""
    if lse.shape != like.shape[:3]:
        raise ValueError(f"statistics of shape {tuple(lse.shape)} for "
                         f"tensors of shape {tuple(like.shape)}")
    return lse.to(like.device, torch.float32).contiguous()


def _operands(ts, dp):
    """Each tensor padded to head dim dp and, on the card, readable in place
    or copied."""
    ts = [_pad(t, dp) for t in ts]
    return ts if ts[0].device.type == "cpu" else [_readable(t) for t in ts]


def flash_fwd(q, k, v, scale: float):
    """K5 (fp32 tensors: K5F; bf16 at 129 to 1024: K5_256 .. K5_1024;
    past that, and fp32 past 128: K5W / K5WF): (out in q's dtype, lse fp32
    (B, H, N)) of q (B, H, N, D) and k, v (B, H, M, D); its plain version
    on the CPU."""
    if q.device.type != "cpu":
        kern = _check_cuda("fwd", (q,), (k, v))
    b, h, n, d = q.shape
    m = k.shape[2]
    dp = forward_dim(d, q.dtype)
    q, k, v = _operands((q, k, v), dp)
    if q.device.type == "cpu":
        out, lse = flash_fwd_plain(q, k, v, scale)
    else:
        out = _bnhd(q.shape, q)
        lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
        _launch(kern, (q, k, v, out, lse), (q, k, v, out), b, h, n, m, dp,
                scale)
    return out[..., :d], lse


def flash_dq(q, k, v, out, dout, lse, scale: float):
    """K6a (fp32 tensors: K6AF; bf16 at 129-256, 257-384 and 385-512:
    K6A_256, K6A_384, K6A_512; past that, and fp32 past 128: K6AW /
    K6AWF): (dq, delta fp32 (B, H, N)); its plain version on the CPU."""
    if q.device.type != "cpu":
        kern = _check_cuda("dq", (q, out, dout), (k, v))
    b, h, n, d = q.shape
    m = k.shape[2]
    dp = instance_dim(d)
    q, k, v, out, dout = _operands((q, k, v, out, dout), dp)
    if q.device.type == "cpu":
        dq, delta = flash_dq_plain(q, k, v, out, dout, lse, scale)
    else:
        lse = _stats(lse, q)
        delta = torch.empty_like(lse)
        dq = _bnhd(q.shape, q)
        _launch(kern, (q, k, v, out, dout, lse, delta, dq),
                (q, k, v, out, dout, dq), b, h, n, m, dp, scale)
    return dq[..., :d], delta


def flash_dkv(q, k, v, dout, lse, delta, scale: float):
    """K6b (fp32 tensors: K6BF; bf16 at 129-256, 257-384 and 385-512:
    K6B_256, K6B_384, K6B_512; past that, and fp32 past 128: K6BW /
    K6BWF): (dk, dv) (B, H, M, D) from the delta K6a returned; its plain
    version on the CPU."""
    if q.device.type != "cpu":
        kern = _check_cuda("dkv", (q, dout), (k, v))
    b, h, n, d = q.shape
    m = k.shape[2]
    dp = instance_dim(d)
    q, k, v, dout = _operands((q, k, v, dout), dp)
    if q.device.type == "cpu":
        dk, dv = flash_dkv_plain(q, k, v, dout, lse, delta, scale)
    else:
        lse, delta = _stats(lse, q), _stats(delta, q)
        dk, dv = _bnhd(k.shape, k), _bnhd(k.shape, k)
        _launch(kern, (q, k, v, dout, lse, delta, dk, dv),
                (q, k, v, dout, dk, dv), b, h, n, m, dp, scale)
    return dk[..., :d], dv[..., :d]


@torch.library.custom_op("sd3_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 scale: float) -> tuple[torch.Tensor, torch.Tensor]:
    """`flash_fwd` (K5) as a registered op: (out, lse). Selective
    checkpointing (models/mmdit.py's remat policies) sees ops at the
    dispatcher, so it can save this op's outputs, as the JAX package names
    `out` and `lse` "attn_out" (sd3_tpu/ops/flash_attention.py:331-332);
    a launch inside an autograd Function would be hidden from it."""
    return flash_fwd(q, k, v, scale)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, scale):
    b, h, n, d = q.shape
    return (q.new_empty((b, n, h, d)).transpose(1, 2),
            q.new_empty((b, h, n), dtype=torch.float32))


def _flash_setup(ctx, inputs, output):
    q, k, v, scale = inputs
    out, lse = output
    ctx.save_for_backward(q, k, v, out, lse)
    ctx.scale = scale
    ctx.mark_non_differentiable(lse)


def _flash_backward(ctx, dout, _dlse):
    """K6a, then K6b on the delta K6a wrote (plain versions on the CPU);
    the forward saved out and lse, so only p is recomputed."""
    q, k, v, out, lse = ctx.saved_tensors
    dq, delta = flash_dq(q, k, v, out, dout, lse, ctx.scale)
    # K6b reads the delta K6a wrote: both on one stream, in this order
    dk, dv = flash_dkv(q, k, v, dout, lse, delta, ctx.scale)
    return dq, dk, dv, None


flash_fwd_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """Non-causal softmax(q k^T * scale) v of q (B, H, N, D) and k, v
    (B, H, M, D), (B, H, N, D); differentiable in q, k and v
    (`flash_fwd_op`, K5; K6a and K6b in its backward)."""
    check_shapes(q, k, v)
    if q.device.type not in ("cpu", "cuda"):
        # the op's fake would answer a meta tensor; nothing computes there
        raise ValueError(f"no flash attention path for device {q.device}")
    return flash_fwd_op(q, k, v, float(scale))[0]
