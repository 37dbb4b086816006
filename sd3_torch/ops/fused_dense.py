"""Int8 projections of the attention half of a block, with the block's
AdaLN prologue or gate + residual epilogue folded in (JAX counterpart:
sd3_tpu/ops/fused_dense.py, the JAX package's opt-in SD3_ATTN_TAIL, here
`MMDiTConfig.attn_tail`).

Two kernels of one CUDA source, `csrc/fused_dense.cu`, each one launch
(the row prologue inside it, the products on s8 wgmma fed by TMA; the
quantized activations never leave shared memory):

- K10a (`qkv_adaln_int8`) replaces the TPU kernel `_kernel_qkv`: per row,
  LayerNorm (eps 1e-5) -> * (1 + scale) + shift of the row's sample ->
  per-row int8 quantization -> three int8 products (q, k, v) -> (acc * s_x)
  * s_w -> x's dtype;
- K10b (`out_gate_residual_int8`) replaces `_kernel_out`: per-row int8
  quantization of the attention output -> one int8 product -> (acc * s_a) *
  s_w [* gate of the row's sample] [+ res] -> a's dtype.

Both keep fp32 until one final rounding, where the JAX fallback of a
declined shape (`ops/attention.py::_adaln`, `_gate_res`) rounds the AdaLN
output, the projection and the gate product to the compute dtype. So the
route is numerics, and `fused_qkv_adaln_int8` / `fused_out_gate_residual_int8`
take it as the JAX functions do: `pick_bm`, a copy of the TPU kernel's
sample-aligned tile picker with its VMEM estimates and 13 MiB budget, and
None (the caller's fallback) wherever it finds no tile. At the published
512px shapes K10a takes the image stream (bm 256), K10b the image stream
(bm 512), and both decline the 154-token text stream. The tile itself is
TPU blocking: the Hopper kernels take any row count.

The kernels take any k a multiple of 16 and d_out a multiple of 8 (the row
stride of the outputs' tensor maps). A row of up to `K_CHUNK` values (the
published width is 1216) is quantized once into the kernel's shared-memory
A tile; a wider one runs in chunks of `K_CHUNK`, its int8 scale fixed by a
first pass over the whole row, so the levels are the same. Weights are
the port's (out, in) int8 with (out,) fp32 scales. Wrappers take the plain
version for tensors on the CPU; on a CUDA tensor they launch the kernel or
raise. Inference only, as in the JAX package: they raise when an
input requires grad, on every device.
"""

from __future__ import annotations

import ctypes

import torch

from sd3_torch.kernels import Kernel, check
from sd3_torch.ops.fused_mlp import adaln_rows, per_row, refuse_grad
from sd3_torch.ops.quant import int_mm, quantize_rows

VMEM_CAP = 13 * 2 ** 20   # JAX's default (sd3_tpu/ops/fused_dense.py:79)
TILES = (1024, 512, 256, 128)
K_CHUNK = 1536            # csrc/fused_dense.cu's K_CHUNK

_P, _I = ctypes.c_void_p, ctypes.c_int
K10A = Kernel("qkv_adaln_int8", "fused_dense.cu", "sd3_qkv_adaln_int8",
              [_P] * 12 + [_I] * 4 + [_P])
K10B = Kernel("out_gate_residual_int8", "fused_dense.cu",
              "sd3_out_gate_residual_int8",
              [_P, ctypes.c_longlong] + [_P] * 5 + [_I] * 6 + [_P])


def pick_bm(m: int, n_tok: int, vmem_per_row: int, resident: int
            ) -> int | None:
    """JAX's `pick_bm` (sd3_tpu/ops/fused_dense.py:74-85): the largest
    sample-aligned row tile (bm | n_tok or n_tok | bm) dividing m whose VMEM
    estimate fits the budget; None when none does."""
    for bm in TILES:
        if m % bm or (n_tok % bm and bm % n_tok):
            continue
        if bm * vmem_per_row + resident <= VMEM_CAP:
            return bm
    return None


def qkv_bm(b: int, n: int, k: int, d_out: int) -> int | None:
    """K10a's tile, with JAX's estimates (fused_dense.py:149-151): x in two
    bf16 buffers, xq, an fp32 temporary and three double-buffered outputs a
    row; the three int8 weights resident."""
    per_row = 2 * k * 2 + k + k * 4 + 3 * 2 * d_out * 2
    return pick_bm(b * n, n, per_row, 3 * k * d_out)


def out_bm(b: int, n: int, k: int, d_out: int) -> int | None:
    """K10b's tile, with JAX's estimates (fused_dense.py:216-217): a, aq,
    the residual and the output a row; one int8 weight resident."""
    per_row = 2 * k * 2 + k + 2 * d_out * 2 + 2 * d_out * 2
    return pick_bm(b * n, n, per_row, k * d_out)


def _dequant(xq, sx, w, s) -> torch.Tensor:
    return int_mm(xq, w).float() * sx * s.float()


def qkv_adaln_int8_plain(x, shift, scale, wq, sq, wk, sk, wv, sv):
    """Plain PyTorch version of K10a on (B, N, k) x, in fp32, each of the
    three (B, N, d_out) outputs cast to x.dtype; shift / scale (B, k)."""
    b, n, k = x.shape
    xq, sx = quantize_rows(adaln_rows(x.reshape(b * n, k).float(), shift,
                                      scale, n))
    return tuple(_dequant(xq, sx, w, s).to(x.dtype).reshape(b, n, -1)
                 for w, s in ((wq, sq), (wk, sk), (wv, sv)))


def out_gate_residual_int8_plain(a, gate, res, w, s):
    """Plain PyTorch version of K10b on (B, N, k) a, in fp32, cast to
    a.dtype: gate (B, d_out) or None, res (B, N, d_out) or None."""
    b, n, k = a.shape
    aq, sa = quantize_rows(a.reshape(b * n, k).float())
    y = _dequant(aq, sa, w, s)
    if gate is not None:
        y = y * per_row(gate, b * n, n)
    if res is not None:
        y = y + res.reshape(b * n, -1).float()
    return y.to(a.dtype).reshape(b, n, -1)


def _check_device(kern: Kernel, x: torch.Tensor, *operands) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"no {kern.name} path for device {x.device}")
    if x.dtype != torch.bfloat16:
        raise TypeError(f"{kern.name} takes bfloat16 activations, got "
                        f"{x.dtype}")
    for t in operands:
        if t is not None and t.device != x.device:
            raise ValueError(f"{kern.name}: operands on {t.device} and "
                             f"{x.device}")


def _check_weights(kern: Kernel, k: int, ws) -> int:
    """The common (d_out, k) shape of int8 weights `ws`, which the kernel
    takes for k a multiple of 16 and d_out a multiple of 8."""
    d_out = ws[0].shape[0]
    for w in ws:
        if w.dtype != torch.int8 or tuple(w.shape) != (d_out, k):
            raise TypeError(f"{kern.name} takes ({d_out}, {k}) int8 weights, "
                            f"got {w.dtype} {tuple(w.shape)}")
    if k % 16 or d_out % 8:
        raise NotImplementedError(
            f"{kern.name} takes k a multiple of 16 and d_out a multiple of 8; "
            f"got k {k}, d_out {d_out}")
    return d_out


def qkv_adaln_int8(x, shift, scale, wq, sq, wk, sk, wv, sv):
    """K10a on (B, N, k) x: three (B, N, d_out) projections of AdaLN(x)."""
    refuse_grad(K10A, x, shift, scale)
    if x.device.type == "cpu":
        return qkv_adaln_int8_plain(x, shift, scale, wq, sq, wk, sk, wv, sv)
    _check_device(K10A, x, shift, scale, wq, sq, wk, sk, wv, sv)
    b, n, k = x.shape
    d_out = _check_weights(K10A, k, (wq, wk, wv))
    f32 = lambda t: t.to(torch.float32).contiguous()
    sh, sc = f32(shift), f32(scale)
    if sh.shape != (b, k) or sc.shape != (b, k):
        raise ValueError(f"shift / scale must be ({b}, {k})")
    x = x.contiguous()
    ws = [w.contiguous() for w in (wq, wk, wv)]
    ss = [f32(s) for s in (sq, sk, sv)]
    m, dev = b * n, x.device
    outs = [torch.empty((b, n, d_out), dtype=torch.bfloat16, device=dev)
            for _ in range(3)]
    with torch.cuda.device(dev):
        fn = K10A.function()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), sh.data_ptr(), sc.data_ptr(),
                 *(w.data_ptr() for w in ws), *(s.data_ptr() for s in ss),
                 *(o.data_ptr() for o in outs),
                 m, k, d_out, n, stream)
    check(K10A, err)
    K10A.launches += 1
    return tuple(outs)


def out_gate_residual_int8(a, gate, res, w, s):
    """K10b on a (B, N, k), which may be a per-sample slice of a longer
    sequence (rows contiguous, any sample stride): (B, N, d_out)
    [res +] [gate *] the int8 projection."""
    refuse_grad(K10B, a, gate, res)
    if a.device.type == "cpu":
        return out_gate_residual_int8_plain(a, gate, res, w, s)
    _check_device(K10B, a, gate, res, w, s)
    b, n, k = a.shape
    d_out = _check_weights(K10B, k, (w,))
    if (a.stride(2) != 1 or (n > 1 and a.stride(1) != k) or a.stride(0) % 8
            or a.data_ptr() % 16):
        a = a.contiguous()   # the kernel reads rows of k contiguous values
        #                      in 16-byte loads
    g = None if gate is None else gate.to(torch.float32).contiguous()
    if g is not None and g.shape != (b, d_out):
        raise ValueError(f"gate must be ({b}, {d_out})")
    r = None if res is None else res.to(torch.bfloat16).contiguous()
    if r is not None and r.shape != (b, n, d_out):
        raise ValueError(f"res must be ({b}, {n}, {d_out})")
    w, s = w.contiguous(), s.to(torch.float32).contiguous()
    m, dev = b * n, a.device
    out = torch.empty((b, n, d_out), dtype=torch.bfloat16, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    with torch.cuda.device(dev):
        fn = K10B.function()
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(a.data_ptr(), a.stride(0), ptr(g), ptr(r), w.data_ptr(),
                 s.data_ptr(), out.data_ptr(),
                 m, k, d_out, n, int(g is not None), int(r is not None),
                 stream)
    check(K10B, err)
    K10B.launches += 1
    return out


def fused_qkv_adaln_int8(x, shift, scale, wq, sq, wk, sk, wv, sv):
    """(B, N, k) x and per-sample (B, k) shift / scale -> three (B, N, d_out)
    int8 projections of AdaLN(x) through K10a; None where the JAX function
    returns None (no sample-aligned tile: the caller's fallback)."""
    b, n, k = x.shape
    if qkv_bm(b, n, k, wq.shape[0]) is None:
        return None
    return qkv_adaln_int8(x, shift, scale, wq, sq, wk, sk, wv, sv)


def fused_out_gate_residual_int8(a, gate, res, w, s):
    """res + gate * int8 projection of a, (B, N, k) -> (B, N, d_out), through
    K10b; gate (B, d_out) or None, res (B, N, d_out) or None. None where the
    JAX function returns None (the caller's fallback)."""
    b, n, k = a.shape
    if out_bm(b, n, k, w.shape[0]) is None:
        return None
    return out_gate_residual_int8(a, gate, res, w, s)
