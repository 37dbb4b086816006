"""Int8 SwiGLU MLP kernels (JAX counterpart: sd3_tpu/ops/fused_mlp.py).

Three kernels of one CUDA source, `csrc/fused_mlp.cu`:

- K3 (`swiglu_int8`) replaces the TPU kernel `_kernel`: the chain
  quant(x) -> w12 -> dequant + b12 -> silu * mul -> quant(h) per (row,
  h_group chunk) -> w3 -> dequant, summed over chunks -> + b3, over
  flattened (M, k) tokens;
- K2 (`swiglu_int8_tail`) replaces `_kernel_tail2d`: the same chain on
  AdaLN(x) with per-sample shift / scale, then x + gate * y: the whole MLP
  half of a block;
- K9 (`swiglu_int8_tail3d`) replaces `_kernel_tail`, K2's function on the
  TPU's per-sample grid (the JAX package's SD3_MLP_TAIL_FUSION=3d, here
  `tail_fusion="3d"`, `MMDiTConfig.mlp_tail_fusion`). The grid kept a TPU
  tile inside one sample; the Hopper launches find each row's sample as
  r // n_tok, so K9 runs K2's device code (its own entry point and launch
  count) on every stream, the unaligned 154-token text stream included. It
  differs from K2 in its h_group (`pick_blocks`) and in rounding shift /
  scale / gate to x's dtype first, as the JAX wrapper does.

`h_group` is numerics, not tiling: each chunk of h is requantized with its
own scale, and the chunk width is the TPU picker's (`pick_tail_blocks` for
K2, `pick_block_chunk` for K3, `pick_blocks` for K9, copies of the JAX
package's pickers). The kernels and `swiglu_int8_plain`, the plain PyTorch
version that repeats the arithmetic, take it as an argument.

x is bf16, or fp32 (the JAX package's `--dtype float32 --quant int8`,
whose kernels quantize the fp32 rows as they are): fp32 rows take the fp32
instances K2F, K3F and K9F of the same device code, whose prologue reads
and whose epilogue reads and writes fp32; the output is in x's dtype.

Each launches three kernels: the per-row quantization prologue, the w12
product with silu * mul and h's requantization, and the group-scaled w3
product with its epilogue; both products on wgmma with TMA (the source's
head says how, and why h makes one round trip through device memory).

`fused_swiglu_int8` keeps the JAX dispatch: under `tail_fusion="2d"` (the
default) K2 when the stream's rows can be tiled sample-aligned (the image
stream), otherwise the PyTorch AdaLN prologue, K3, and the PyTorch gate and
residual epilogue (the 154-token text stream). The Hopper kernel could index
the sample of any row; the two routes are kept because they round
differently (bf16 AdaLN output before quantization, bf16 gate product), and
each stream is held to JAX. Under "3d" every block tail is K9's.

Wrappers take the plain version for tensors on the CPU; on a CUDA tensor
they launch the kernel or raise. Inference only, as `quant` is a serving
flag in the JAX package: no VJP is ported, and the wrappers raise when an
input requires grad, on every device, rather than return a result cut off
from autograd.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from sd3_torch.config import MLP_TAIL_FUSIONS
from sd3_torch.kernels import Kernel, check
from sd3_torch.ops.quant import int_mm, quantize_rows

LN_EPS = 1e-5                 # torch LayerNorm default (ops/norms.py)
H_GROUPS = (128, 256, 512)    # the TPU pickers' hidden-chunk widths
_VMEM_CAP = 13 * 2 ** 20      # their default VMEM budget (fused_mlp.py:135)

_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGS = [_P] * 15 + [_I] * 8 + [_P]
K2 = Kernel("swiglu_int8_tail", "fused_mlp.cu", "sd3_swiglu_int8_tail",
            _ARGS)
K3 = Kernel("swiglu_int8", "fused_mlp.cu", "sd3_swiglu_int8", _ARGS)
K9 = Kernel("swiglu_int8_tail3d", "fused_mlp.cu", "sd3_swiglu_int8_tail3d",
            _ARGS)
# the fp32 instances (fp32 x and output)
K2F = Kernel("swiglu_int8_tail_fp32", "fused_mlp.cu",
             "sd3_swiglu_int8_tail_fp32", _ARGS)
K3F = Kernel("swiglu_int8_fp32", "fused_mlp.cu", "sd3_swiglu_int8_fp32",
             _ARGS)
K9F = Kernel("swiglu_int8_tail3d_fp32", "fused_mlp.cu",
             "sd3_swiglu_int8_tail3d_fp32", _ARGS)
_FP32 = {K2: K2F, K3: K3F, K9: K9F}


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def _vmem_est(bm: int, bc: int, k: int, d_out: int) -> int:
    """The TPU kernel's VMEM estimate (sd3_tpu/ops/fused_mlp.py:262-272)."""
    return (2 * bm * k * 2 + bm * k + bm * d_out * 4 + 2 * bm * d_out * 2
            + 2 * bm * bc * 4 + 2 * (2 * k * bc + bc * d_out))


def pick_tail_blocks(m: int, n_tok: int, hidden: int, k: int,
                     d_out: int) -> tuple[int, int] | None:
    """JAX's (bm, bc) for K2 (sd3_tpu/ops/fused_mlp.py:275-287): bm
    sample-aligned and dividing m; None when no tile fits (K3 route)."""
    chunks = [c for c in (512, 256, 128) if hidden % c == 0] or [128]
    for bm in (1024, 512, 256, 128):
        if m % bm or (n_tok % bm and bm % n_tok):
            continue
        for bc in chunks:
            if _vmem_est(bm, bc, k, d_out) <= _VMEM_CAP:
                return bm, bc
    return None


def pick_block_chunk(m: int, hidden: int, k: int, d_out: int
                     ) -> tuple[int, int]:
    """JAX's (bm, bc) for K3 (sd3_tpu/ops/fused_mlp.py:121-141)."""
    if m <= 256:
        bm = _round_up(max(m, 16), 16)
        for bc in (512, 256, 128):
            if hidden % bc == 0:
                return bm, bc
        return bm, 128
    chunks = [c for c in (512, 256, 128) if hidden % c == 0] or [128]
    for bm in (1024, 512, 256):
        for bc in chunks:
            if _vmem_est(bm, bc, k, d_out) <= _VMEM_CAP:
                return bm, bc
    return 256, chunks[-1]


def pick_blocks(n: int, hidden: int) -> tuple[int, int]:
    """JAX's (bm, bc) for K9 (sd3_tpu/ops/fused_mlp.py:405-422, its default
    SD3_FUSED_MLP_BM of 640): bc, the first of 512, 256, 128 dividing hidden,
    is K9's h_group; bm, the per-sample token tile n is padded to, is TPU
    blocking, which the Hopper launches do not need."""
    bc = next((c for c in (512, 256, 128) if hidden % c == 0), 128)
    parts = 1
    while _round_up(-(-n // parts), 16) > 640:
        parts += 1
    return _round_up(-(-n // parts), 16), bc


def per_row(v: torch.Tensor, m: int, n_tok: int) -> torch.Tensor:
    """(B, d) per-sample vectors -> (m, d) fp32, row r taking sample
    r // n_tok."""
    return v.float()[torch.arange(m, device=v.device) // n_tok]


def adaln_rows(xf, shift, scale, n_tok: int) -> torch.Tensor:
    """The kernels' AdaLN prologue on fp32 (M, k) rows, in fp32: LayerNorm
    (mean, then the mean of squared deviations, eps 1e-5) * (1 + scale) +
    shift of the row's sample."""
    m = xf.shape[0]
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    xn = (xf - mean) * torch.rsqrt(var + LN_EPS)
    return xn * (1.0 + per_row(scale, m, n_tok)) + per_row(shift, m, n_tok)


def swiglu_int8_plain(x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
                      h_group: int, shift=None, scale=None, gate=None,
                      n_tok: int | None = None, adaln: bool = False,
                      residual: bool = False) -> torch.Tensor:
    """Plain PyTorch version of K2 / K3 on (M, k) rows, in fp32, cast to
    x.dtype. Weights (out, in) int8 with (out,) fp32 scales; shift / scale
    (B, k) and gate (B, d_out) per sample, row r taking sample r // n_tok.
    As the TPU kernel: gate applies only with the residual."""
    m, _ = x.shape
    hidden = w12_q.shape[0] // 2
    n_tok = m if n_tok is None else n_tok
    xf = x.float()
    if adaln:
        xf = adaln_rows(xf, shift, scale, n_tok)
    xq, sx = quantize_rows(xf)
    x12 = int_mm(xq, w12_q).float() * sx * w12_scale.float() + b12.float()
    h = F.silu(x12[:, :hidden]) * x12[:, hidden:]
    s3 = w3_scale.float()
    acc = torch.zeros(m, w3_q.shape[0], device=x.device)
    for g0 in range(0, hidden, h_group):
        hq, sh = quantize_rows(h[:, g0:g0 + h_group])
        acc = acc + int_mm(hq, w3_q[:, g0:g0 + h_group].contiguous()
                           ).float() * sh * s3
    y = acc + b3.float()
    if residual:
        y = x.float() + per_row(gate, m, n_tok) * y
    return y.to(x.dtype)


def _launch(kern: Kernel, x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
            h_group: int, shift, scale, gate, n_tok: int, adaln: bool,
            residual: bool) -> torch.Tensor:
    m, k = x.shape
    hidden = w12_q.shape[0] // 2
    d_out = w3_q.shape[0]
    if x.dtype == torch.float32:
        kern = _FP32[kern]
    elif x.dtype != torch.bfloat16:
        raise TypeError(f"{kern.name} takes bfloat16 or float32 x, got "
                        f"{x.dtype}")
    if w12_q.dtype != torch.int8 or w3_q.dtype != torch.int8:
        raise TypeError(f"{kern.name} takes int8 weights")
    if tuple(w12_q.shape) != (2 * hidden, k) or w3_q.shape[1] != hidden:
        raise ValueError(f"weight shapes {tuple(w12_q.shape)} / "
                         f"{tuple(w3_q.shape)} do not fit x {tuple(x.shape)}")
    if h_group not in H_GROUPS or hidden % h_group or k % 16 or d_out % 16:
        raise NotImplementedError(
            f"{kern.name} takes h_group in {H_GROUPS} dividing hidden, and "
            f"k, d_out multiples of 16; got h_group {h_group}, hidden "
            f"{hidden}, k {k}, d_out {d_out}")
    if residual and d_out != k:
        raise ValueError("the residual needs d_out == k")
    if m % n_tok:
        raise ValueError(f"{m} rows are not whole samples of {n_tok} tokens")
    dev = x.device
    for t in (w12_q, w12_scale, b12, w3_q, w3_scale, b3):
        if t.device != dev:
            raise ValueError(f"{kern.name}: operands on {t.device} and {dev}")
    f32 = lambda t: t.to(dev, torch.float32).contiguous()
    x = x.contiguous()
    # the weights go to TMA, which reads from 16-byte aligned starts
    w12_q, w3_q = (w if w.is_contiguous() and w.data_ptr() % 16 == 0
                   else w.clone(memory_format=torch.contiguous_format)
                   for w in (w12_q, w3_q))
    s12, bias12, s3, bias3 = f32(w12_scale), f32(b12), f32(w3_scale), f32(b3)
    nb = m // n_tok
    sh = f32(shift) if adaln else None
    sc = f32(scale) if adaln else None
    gt = f32(gate) if residual else None
    if adaln and (sh.shape != (nb, k) or sc.shape != (nb, k)):
        raise ValueError(f"shift / scale must be ({nb}, {k})")
    if residual and gt.shape != (nb, d_out):
        raise ValueError(f"gate must be ({nb}, {d_out})")
    xq = torch.empty((m, k), dtype=torch.int8, device=dev)
    sx = torch.empty(m, dtype=torch.float32, device=dev)
    hq = torch.empty((m, hidden), dtype=torch.int8, device=dev)
    s_h = torch.empty((m, hidden // h_group), dtype=torch.float32, device=dev)
    out = torch.empty((m, d_out), dtype=x.dtype, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        fn = kern.function()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), ptr(sh), ptr(sc), ptr(gt), w12_q.data_ptr(),
                 s12.data_ptr(), bias12.data_ptr(), w3_q.data_ptr(),
                 s3.data_ptr(), bias3.data_ptr(), xq.data_ptr(),
                 sx.data_ptr(), hq.data_ptr(), s_h.data_ptr(), out.data_ptr(),
                 m, k, hidden, d_out, n_tok, h_group, int(adaln),
                 int(residual), stream)
    check(kern, err)
    kern.launches += 1
    return out


def refuse_grad(kern: Kernel, *tensors) -> None:
    """Raise when an input requires grad: the int8 kernels have no VJP."""
    if torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise NotImplementedError(
            f"{kern.name} is inference-only (int8 serving): no gradient is "
            "ported; run it under torch.no_grad() or train with quant='none'")


def _dispatch(kern, x, *args, **kw):
    refuse_grad(kern, x, *args, *kw.values())
    if x.device.type == "cpu":
        return swiglu_int8_plain(x, *args, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"no {kern.name} path for device {x.device}")
    return _launch(kern, x, *args, **kw)


def swiglu_int8(x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
                h_group: int) -> torch.Tensor:
    """K3: the int8 SwiGLU chain on (M, k) rows."""
    return _dispatch(K3, x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
                     h_group=h_group, shift=None, scale=None, gate=None,
                     n_tok=x.shape[0], adaln=False, residual=False)


def swiglu_int8_tail(x, shift, scale, gate, w12_q, w12_scale, b12, w3_q,
                     w3_scale, b3, n_tok: int, h_group: int,
                     adaln: bool = True, residual: bool = True
                     ) -> torch.Tensor:
    """K2: [x + gate *] chain(AdaLN(x)) on (B * n_tok, k) rows."""
    return _dispatch(K2, x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
                     h_group=h_group, shift=shift, scale=scale, gate=gate,
                     n_tok=n_tok, adaln=adaln, residual=residual)


def swiglu_int8_tail3d(x, shift, scale, gate, w12_q, w12_scale, b12, w3_q,
                       w3_scale, b3, n_tok: int, h_group: int,
                       adaln: bool = True, residual: bool = True
                       ) -> torch.Tensor:
    """K9: K2's function, [x + gate *] chain(AdaLN(x)) on (B * n_tok, k)
    rows, on any n_tok."""
    return _dispatch(K9, x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
                     h_group=h_group, shift=shift, scale=scale, gate=gate,
                     n_tok=n_tok, adaln=adaln, residual=residual)


def fused_swiglu_int8(x, w12_q, w12_scale, b12, w3_q, w3_scale, b3,
                      shift=None, scale=None, gate=None,
                      residual: bool = False,
                      tail_fusion: str = "2d") -> torch.Tensor:
    """y = [x +] [gate *] (w3(silu(x1) * x2) + b3), (x1, x2) = w12(xn) + b12,
    xn = AdaLN(x, shift, scale) when given, else x; the dispatch of the JAX
    function (sd3_tpu/ops/fused_mlp.py:486-554), with `tail_fusion` in place
    of its SD3_MLP_TAIL_FUSION read: "3d" sends every block tail to K9.

    x: (B, N, k) or (M, k); shift / scale: (B, k); gate: (B, d_out);
    w12_q: (2 * hidden, k) int8, w3_q: (d_out, hidden) int8, (out,) scales.
    Returns x.dtype."""
    if tail_fusion not in MLP_TAIL_FUSIONS:
        raise ValueError(f"tail_fusion must be one of {MLP_TAIL_FUSIONS}, got "
                         f"{tail_fusion!r}")
    hidden = w12_q.shape[0] // 2
    d_out = w3_q.shape[0]
    w = (w12_q, w12_scale, b12, w3_q, w3_scale, b3)
    if shift is None and gate is None and not residual:
        x2d = x.reshape(-1, x.shape[-1])
        _, bc = pick_block_chunk(x2d.shape[0], hidden, x2d.shape[1], d_out)
        return swiglu_int8(x2d, *w, h_group=bc).reshape(*x.shape[:-1], d_out)
    squeeze = x.ndim == 2
    if squeeze:
        x = x[None]
    b, n, k = x.shape
    if tail_fusion == "3d":
        # the conditioning in x's dtype, as _fused_swiglu_3d casts it
        cast = lambda t: None if t is None else t.to(x.dtype)
        g = cast(gate)
        if residual and g is None:
            g = torch.ones((b, d_out), dtype=x.dtype, device=x.device)
        out = swiglu_int8_tail3d(x.reshape(b * n, k), cast(shift),
                                 cast(scale), g, *w, n_tok=n,
                                 h_group=pick_blocks(n, hidden)[1],
                                 adaln=shift is not None, residual=residual)
        out = out.reshape(b, n, d_out)
        return out[0] if squeeze else out
    blocks = pick_tail_blocks(b * n, n, hidden, k, d_out)
    if blocks is not None:
        g = gate
        if residual and g is None:
            g = torch.ones((b, d_out), device=x.device)
        out = swiglu_int8_tail(x.reshape(b * n, k), shift, scale, g, *w,
                               n_tok=n, h_group=blocks[1],
                               adaln=shift is not None, residual=residual)
        out = out.reshape(b, n, d_out)
        return out[0] if squeeze else out
    # not sample-alignable (the 154-token text stream): PyTorch prologue and
    # epilogue around K3, with the JAX fallback's roundings
    xn = x
    if shift is not None:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = (xf - mean).square().mean(-1, keepdim=True)
        ln = (xf - mean) * torch.rsqrt(var + LN_EPS)
        xn = (ln * (1.0 + scale[:, None, :].float())
              + shift[:, None, :].float()).to(x.dtype)
    y = fused_swiglu_int8(xn, *w)   # K3
    if gate is not None:
        y = (y.float() * gate[:, None, :].float()).to(x.dtype)
    if residual:
        y = x + y
    return y[0] if squeeze else y
