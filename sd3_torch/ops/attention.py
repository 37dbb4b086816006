"""Joint dual-stream attention (JAX counterpart: sd3_tpu/ops/attention.py).

Semantics of reference src/blocks/Attention.py: separate bias-free q/k/v/out
projections per stream (image "x", text "c"), per-head q/k RMSNorm per
stream for the softmax types, RoPE on the IMAGE tokens only, the two streams
concatenated along the sequence and attended jointly, then split back; the
`last` block has no text out-projection. The softmax scale is
head_dim(v) ** -0.5, taken from the *value* head dim (reference
Attention.py:57), also where `qk_half_dim` halves q and k.

Two paths, chosen as the JAX package chooses (`_fused_path_ok`):
- the fused path, the one the published config takes for sampling
  ("softmax_flash", dual stream, not causal, no kv_merge / qk_half_dim, a
  RoPE / RoPE2d / NoPE / absolute PE): raw projections go to kernel K1
  (ops/fused_attention.py), which applies the norms and the rotation
  itself, with RoPE1d's or RoPE2d's row tables;
- the general path (every other variant, and `use_fused=False`, as the
  trainer builds it): per-stream projections (q and k at dim / 2 under
  `qk_half_dim`), per-head RMSNorm in the compute dtype for the softmax
  types, L2 normalisation for cosine / cosine2, RoPE in fp32 on the image
  tokens (RoPE1d, RoPE2d or RoPE2dV2), under `kv_merge_attn` the keys and
  values of each stream merged pairwise (means of rows 2i, 2i + 1: half the
  key length), the streams concatenated, then `attention_core` on
  (B, H, N, D): flash attention (kernels K5, K6a, K6b,
  ops/flash_attention.py, at a key length of its own under kv_merge) for
  "softmax_flash" not causal, else plain PyTorch, as it is XLA in the JAX
  package: masked softmax for causal, and the cosine and linear types.
`dual=False` is the single-stream attention (`query_proj`, `key_proj`,
`value_proj`, `out_proj`, `q_norm`, `k_norm`), general path only; attn_type
"both" is softmax on even layers and cosine on odd ones (`layer_idx`).
What JAX refuses, a ValueError refuses here: `qk_half_dim` under
"softmax_flash" (the flash wrapper's head-dim assert) and an odd stream
length under `kv_merge_attn` (no pairs).

Above 2048 padded joint tokens (the 1024px stage) the fused path's
attention is the streaming kernel K7 instead of K1, as in the JAX package.
Under quant="int8" the projections are w8a8 `Int8Linear`s (names in
quant_skip stay float), and the joint attention takes the int8-QK^T kernel
K4 where the JAX package does (`int8_qk_on`: "attn_qk" not skipped and a
padded joint length in [1024, 2048], sd3_tpu/ops/attention.py:316-318), and
with `int8_pv` the int8-P.V streaming kernel K8b (`int8_pv_on`: "attn_pv"
not skipped and more than 2048 padded tokens, :334-336, where the JAX
package reads the flag from SD3_INT8_PV=1).

With a `tail` (the block's opt-in `attn_tail`, the JAX SD3_ATTN_TAIL) this
module also owns the block's AdaLN prologue and gate + residual epilogue
(sd3_tpu/ops/attention.py:243-365, :401-471): x and c arrive raw and leave
updated. On the fused path under int8 the image stream's q/k/v projections
take K10a and the out-projections K10b (ops/fused_dense.py) as `tail_mode`
allows and quant_skip does not turn them off; where a kernel declines (the
154-token text stream) or is not allowed, `_adaln` and `_gate_res` compute
the same math in PyTorch with the JAX fallback's roundings. The general path
takes the tail with no kernel.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sd3_torch.config import ATTN_TAILS
from sd3_torch.ops.flash_attention import flash_attention
from sd3_torch.ops.fused_attention import (fold_row_tables, fused_attention,
                                           rope_row_tables)
from sd3_torch.ops.fused_dense import (fused_out_gate_residual_int8,
                                       fused_qkv_adaln_int8)
from sd3_torch.ops.norms import RMSNorm, layer_norm, linear
from sd3_torch.ops.quant import make_linear
from sd3_torch.ops.rope import (rope1d_angles, rope2d_axial_angles,
                                rope2dv2_trig, rotate, rotate_v2)

INT8_QK_TOKENS = (1024, 2048)  # padded joint lengths that take K4
INT8_PV_TOKENS = 2048          # int8 P.V only above this padded length
SOFTMAX_TYPES = ("softmax", "softmax_flash")
QKV_X = ("query_proj_x", "key_proj_x", "value_proj_x")


def _adaln(t, shift, scale):
    """AdaLN from per-sample (B, dim) vectors, as the JAX tail path computes
    it (sd3_tpu/ops/attention.py:40-46): LayerNorm(t) rounded to t's dtype,
    then * (1 + scale) + shift in fp32, rounded again."""
    y = layer_norm(t).float()
    return (y * (1.0 + scale[:, None, :].float())
            + shift[:, None, :].float()).to(t.dtype)


def _gate_res(o, gate, res):
    """The per-sample gate and the residual (sd3_tpu/ops/attention.py:49-56),
    each skipped when None: o * gate in fp32 rounded to o's dtype, then
    res + o in res's dtype."""
    if gate is not None:
        o = (o.float() * gate[:, None, :].float()).to(o.dtype)
    if res is not None:
        o = res + o.to(res.dtype)
    return o


def _l2_normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch.nn.functional.normalize over the last axis, in fp32, cast back
    (sd3_tpu/ops/attention.py:61-64)."""
    xf = x.float()
    return (xf / xf.norm(dim=-1, keepdim=True).clamp_min(eps)).to(x.dtype)


def _scores(q, k) -> torch.Tensor:
    """q k^T with fp32 sums (JAX: einsum, preferred fp32)."""
    return torch.matmul(q.float(), k.float().transpose(-1, -2))


def _apply(w: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """w rounded to v's dtype, times v with fp32 sums, in v's dtype."""
    return torch.matmul(w.to(v.dtype).float(), v.float()).to(v.dtype)


def _tril(n: int, m: int, device) -> torch.Tensor:
    return torch.tril(torch.ones(n, m, device=device))


def _softmax_attention(q, k, v, scale: float, causal: bool,
                       use_flash: bool) -> torch.Tensor:
    """q, k (B, H, N, dqk), v (B, H, M, dv) -> (B, H, N, dv): flash
    attention when `use_flash` and not causal, else fp32 logits (masked to
    the lower triangle when causal), an fp32 softmax rounded to v's dtype,
    and P.V with fp32 sums (sd3_tpu/ops/attention.py:67-79)."""
    if use_flash and not causal:
        return flash_attention(q, k, v, scale)
    logits = _scores(q, k) * scale
    if causal:
        n, m = logits.shape[-2:]
        logits = logits.masked_fill(_tril(n, m, q.device) == 0, -torch.inf)
    return _apply(torch.softmax(logits, dim=-1), v)


def _linear_attention_core(q, k, v) -> torch.Tensor:
    """(q (k^T v)) / (q k^T.sum(-1)), fp32 sums (reference
    Attention.py:388-405, sd3_tpu/ops/attention.py:82-88)."""
    kv = _scores(k.transpose(-1, -2), v.transpose(-1, -2))   # (B, H, d, e)
    num = torch.matmul(q.float(), kv)
    ksum = k.float().sum(-2)                                 # (B, H, d)
    den = torch.einsum("bhnd,bhd->bhn", q.float(), ksum)[..., None]
    return (num / den).to(v.dtype)


def attention_core(q, k, v, attn_type: str, scale: float, causal: bool = False,
                   norm_const: torch.Tensor | None = None) -> torch.Tensor:
    """The reference's attention variants on (B, H, N, D) tensors
    (sd3_tpu/ops/attention.py:91-155): the softmax types (flash attention
    for "softmax_flash" unless causal), "cosine" with its learned
    `norm_const` (1, H, 1, 1) (sigmoid power of the key count; causal and
    not), "cosine2", "cosine3" (causal or not), "cosine4", "cosine_norm",
    and the linear "relu", "silu", "exp". Products sum in fp32, each
    result in v's dtype."""
    if attn_type in SOFTMAX_TYPES:
        return _softmax_attention(q, k, v, scale, causal,
                                  attn_type == "softmax_flash")
    if attn_type == "cosine":
        p = torch.sigmoid(norm_const.float())                  # (1, H, 1, 1)
        if causal:
            n, m = q.shape[-2], k.shape[-2]
            mask = _tril(n, m, q.device)
            counts = mask.sum(-1, keepdim=True)                # (n, 1)
            vn = v / (counts[None, None] ** p).clamp_min(1.0).to(v.dtype)
            return _apply(_scores(q, k) * mask, vn)
        vn = (v.float() / (v.shape[-2] ** p)).to(v.dtype)
        kv = _scores(k.transpose(-1, -2), vn.transpose(-1, -2))
        return torch.matmul(q.float(), kv).to(v.dtype)
    if attn_type == "cosine2":
        prod = _scores(q, k) + 1.0
        return _apply(prod / prod.sum(-1, keepdim=True), v)
    if attn_type == "cosine3":
        prod = _scores(q, k)
        if causal:
            prod = prod * _tril(*prod.shape[-2:], q.device)
        return _apply(prod / prod.abs().sum(-1, keepdim=True), v)
    if attn_type == "cosine4":
        # `scale` is the value head dim's, as the reference's cosine4 takes
        # self.head_dim even under qk_half_dim
        qn = q.float().norm(dim=-1, keepdim=True)
        kn = k.float().norm(dim=-1, keepdim=True)
        attn = _scores(q, k) * scale + (qn * kn.transpose(-1, -2)) * scale
        return _apply(attn / attn.sum(-1, keepdim=True), v)
    if attn_type == "cosine_norm":
        qn = q.float().norm(dim=-1, keepdim=True)
        kn = k.float().norm(dim=-1, keepdim=True)
        den = qn * kn.sum(-2, keepdim=True)                    # (B, H, N, 1)
        return _apply(_scores(q, k) / den, v)
    if attn_type == "relu":
        return _linear_attention_core(F.relu(q), F.relu(k), v)
    if attn_type == "silu":
        return _linear_attention_core(F.silu(q), F.silu(k), v)
    if attn_type == "exp":
        return _linear_attention_core(torch.exp(q), torch.exp(k), v)
    raise ValueError(f"unknown attn_type {attn_type}")


def _merge_pairs(t: torch.Tensor) -> torch.Tensor:
    """kv_merge_attn: the means of rows 2i and 2i + 1 of (B, H, L, D), L
    even (sd3_tpu/ops/attention.py:427-431)."""
    if t.shape[2] % 2:
        raise ValueError(f"kv_merge_attn pairs the rows of a stream; "
                         f"{t.shape[2]} rows cannot pair")
    return (t[:, :, ::2] + t[:, :, 1::2]) / 2


def int8_qk_on(quant: str, quant_skip, n_tokens: int) -> bool:
    """The JAX package's int8-QK^T gate (sd3_tpu/ops/attention.py:316-318)."""
    padded = -(-n_tokens // 128) * 128
    return (quant == "int8" and "attn_qk" not in quant_skip
            and INT8_QK_TOKENS[0] <= padded <= INT8_QK_TOKENS[1])


def int8_pv_on(quant: str, quant_skip, n_tokens: int, enabled: bool) -> bool:
    """The JAX package's int8-P.V gate (sd3_tpu/ops/attention.py:334-336),
    with the config's `int8_pv` in place of SD3_INT8_PV=1."""
    padded = -(-n_tokens // 128) * 128
    return (enabled and quant == "int8" and "attn_pv" not in quant_skip
            and padded > INT8_PV_TOKENS)


FUSED_PES = ("RoPE", "RoPE2d", "NoPE", "absolute")


class JointAttention(nn.Module):
    """Dual-stream joint attention, or single-stream with dual=False: the
    fused path (K1 / K4 / K7 / K8b), or the general path (see the module
    docstring). `use_fused=False` keeps the general path even where the
    fused one applies (sd3_tpu/ops/attention.py:177-181: trainers pass it,
    for the real two-kernel flash VJP). `int8_pv` opts in to int8 P.V where
    `int8_pv_on` allows it."""

    def __init__(self, dim: int, num_heads: int = 8,
                 attn_type: str = "softmax_flash", causal: bool = False,
                 positional_encoding: str = "RoPE2d", rope_scale: float = 1.0,
                 kv_merge_attn: bool = False, qk_half_dim: bool = False,
                 layer_idx: int | None = None, dual: bool = True,
                 last: bool = False, rope2d_interpolate: bool = False,
                 quant: str = "none", quant_skip: tuple = (),
                 int8_pv: bool = False, use_fused: bool = True, device=None,
                 dtype=None):
        super().__init__()
        if attn_type == "both":   # sd3_tpu/ops/attention.py:183-186
            attn_type = "softmax" if (layer_idx or 0) % 2 == 0 else "cosine"
        dim_qk = dim // 2 if qk_half_dim else dim
        hd, self.hd_qk = dim // num_heads, dim_qk // num_heads
        if attn_type == "softmax_flash" and not causal and self.hd_qk != hd:
            # the JAX flash wrapper asserts one head dim for q, k and v
            raise ValueError("qk_half_dim under attn_type 'softmax_flash': "
                             "flash attention takes q, k and v of one head "
                             f"dim ({self.hd_qk} and {hd})")
        # sd3_tpu/ops/attention.py:207-217
        self.fused = (use_fused and attn_type == "softmax_flash" and dual
                      and not causal and not kv_merge_attn
                      and not qk_half_dim
                      and positional_encoding in FUSED_PES
                      and hd % 2 == 0 and 128 % hd == 0)
        self.attn_type, self.causal, self.dual = attn_type, causal, dual
        self.kv_merge_attn = kv_merge_attn
        self.dim = dim
        self.num_heads = num_heads
        self.positional_encoding = positional_encoding
        self.rope_scale = rope_scale
        self.rope2d_interpolate = rope2d_interpolate
        self.last = last
        self.scale = hd ** -0.5  # value head dim (reference Attention.py:57)
        self.quant, self.quant_skip = quant, tuple(quant_skip)
        self.int8_pv = int8_pv
        kw = dict(device=device, dtype=dtype)
        streams = ("_x", "_c") if dual else ("",)
        outs = ["out_proj_x"] + ([] if last else ["out_proj_c"]) if dual \
            else ["out_proj"]
        for sfx in streams:
            for name, d_out in (("query_proj", dim_qk), ("key_proj", dim_qk),
                                ("value_proj", dim)):
                setattr(self, name + sfx, make_linear(
                    dim, d_out, False, name + sfx, quant, self.quant_skip,
                    **kw))
        for name in outs:
            setattr(self, name, make_linear(dim, dim, False, name, quant,
                                            self.quant_skip, **kw))
        if attn_type in SOFTMAX_TYPES:
            for sfx in streams:
                setattr(self, "q_norm" + sfx, RMSNorm(self.hd_qk, **kw))
                setattr(self, "k_norm" + sfx, RMSNorm(self.hd_qk, **kw))
        if attn_type == "cosine":   # sd3_tpu/ops/attention.py:450-453
            self.norm_const = nn.Parameter(torch.full((1, num_heads, 1, 1),
                                                      0.5, **kw))
        # (n_img, n, hw, device) -> rotation tables on the device, built once
        # so the sampling loop copies nothing from the host per call.
        self._tables: dict = {}

    def _angles(self, n_img: int, hw):
        """The image tokens' (n_img, hd_qk) angle table of RoPE1d or RoPE2d
        (sd3_tpu/ops/attention.py:219-229), or None."""
        pe, interp = self.positional_encoding, 1.0 / self.rope_scale
        if pe == "RoPE":
            return rope1d_angles(n_img, self.hd_qk, interp)
        if pe == "RoPE2d":
            h, w = hw
            factor = interp if self.rope2d_interpolate else 1.0
            return rope2d_axial_angles(h, w, self.hd_qk, factor).reshape(
                n_img, self.hd_qk)
        return None

    def _rope_tables(self, n_img: int, n: int, hw, device):
        """(cos, sin) fp32 (n, hd_qk) on the device, identity rows past the
        image tokens; under RoPE2dV2 its four trig tables."""
        key = (n_img, n, hw, device)
        if key not in self._tables:
            if self.positional_encoding == "RoPE2dV2":
                tabs = rope2dv2_trig(*hw, self.hd_qk, 1.0 / self.rope_scale)
            else:
                tabs = rope_row_tables(self._angles(n_img, hw), n, self.hd_qk)
            self._tables[key] = tuple(torch.tensor(t, device=device)
                                      for t in tabs)
        return self._tables[key]

    def forward(self, x: torch.Tensor, c: torch.Tensor | None = None,
                hw=None, tail=None, tail_mode: str = "all"):
        """x: (B, N, dim) image tokens, c: (B, M, dim) text tokens (dual
        only), both in the compute dtype; hw: the image token grid (h, w),
        h*w == N. Returns (x_out, c_out), c_out not projected when `last`;
        single-stream, x_out.

        tail: optional dict {shift_x, scale_x, shift_c, scale_c (B, dim),
        gate_x, gate_c (B, dim) or None, res_x (B, N, dim), res_c (B, M,
        dim)}: the block's AdaLN prologue and gate + residual epilogue
        (sd3_tpu/ops/attention.py:367-382). With it x and c arrive raw
        (before AdaLN) and return updated (after the residual); when `last`,
        c returns as res_c. tail_mode, the JAX SD3_ATTN_TAIL ("all" where
        the JAX package's caller sets none): K10a may take the image q/k/v
        under "all" and "qkv", K10b the out-projections under "all" and
        "out"; "none" leaves both kernels out."""
        if tail is not None and tail_mode not in ATTN_TAILS:
            raise ValueError(f"tail_mode must be one of {ATTN_TAILS}, got "
                             f"{tail_mode!r}")
        if not self.fused:
            return self._general(x, c, None if hw is None else tuple(hw),
                                 tail)
        n, m = x.shape[1], c.shape[1]
        qkv_x = None
        if tail is None:
            xn, cn = x, c
        else:
            cn = _adaln(c, tail["shift_c"], tail["scale_c"])
            if tail_mode in ("all", "qkv") and self._int8_ok(QKV_X):
                raw = [t for nm in QKV_X for t in self._raw_int8(nm)]
                qkv_x = fused_qkv_adaln_int8(x, tail["shift_x"],
                                             tail["scale_x"], *raw)
            if qkv_x is None:
                xn = _adaln(x, tail["shift_x"], tail["scale_x"])
        if qkv_x is None:
            qkv_x = tuple(linear(xn, getattr(self, nm)) for nm in QKV_X)
        q_x, k_x, v_x = qkv_x
        q = torch.cat([q_x, linear(cn, self.query_proj_c)], dim=1)
        k = torch.cat([k_x, linear(cn, self.key_proj_c)], dim=1)
        v = torch.cat([v_x, linear(cn, self.value_proj_c)], dim=1)
        cos, sin = self._rope_tables(n, n + m, tuple(hw), x.device)
        cosq, sinq = fold_row_tables(cos, sin, self.q_norm_x.weight,
                                     self.q_norm_c.weight, n)
        cosk, sink = fold_row_tables(cos, sin, self.k_norm_x.weight,
                                     self.k_norm_c.weight, n)
        out = fused_attention(
            q, k, v, self.num_heads, cosq, sinq, cosk, sink, self.scale,
            int8_qk=int8_qk_on(self.quant, self.quant_skip, n + m),
            int8_pv=int8_pv_on(self.quant, self.quant_skip, n + m,
                               self.int8_pv))
        if tail is None:
            out_x = linear(out[:, :n], self.out_proj_x)
            out_c = out[:, n:]
            if not self.last:
                out_c = linear(out_c, self.out_proj_c)
            return out_x, out_c
        out_x = self._out_tail(out[:, :n], "out_proj_x", tail["gate_x"],
                               tail["res_x"], tail_mode)
        if self.last:
            return out_x, tail["res_c"]
        return out_x, self._out_tail(out[:, n:], "out_proj_c",
                                     tail["gate_c"], tail["res_c"], tail_mode)

    def _int8_ok(self, names) -> bool:
        """The JAX `_int8_ok` (sd3_tpu/ops/attention.py:231-233): every
        projection in `names` is int8."""
        return (self.quant == "int8"
                and not any(nm in self.quant_skip for nm in names))

    def _raw_int8(self, name):
        """(weight_q, weight_scale) of the Int8Linear `name`."""
        proj = getattr(self, name)
        return proj.weight_q, proj.weight_scale

    def _out_tail(self, a, name, gate, res, tail_mode):
        """res + gate * out-projection `name` of a: K10b where tail_mode
        allows it, the projection is int8 and the kernel takes the shape;
        else the projection and `_gate_res` (sd3_tpu/ops/attention.py:
        350-358)."""
        o = None
        if tail_mode in ("all", "out") and self._int8_ok((name,)):
            o = fused_out_gate_residual_int8(a, gate, res,
                                             *self._raw_int8(name))
        if o is None:
            o = _gate_res(linear(a, getattr(self, name)), gate, res)
        return o

    def _rope(self, t: torch.Tensor, hw) -> torch.Tensor:
        """The configured RoPE on (B, H, N_img, D) image-token q or k, in
        fp32, cast back (sd3_tpu/ops/attention.py:192-205); the tables are
        the fused path's, already on the device. NoPE / absolute: t."""
        pe = self.positional_encoding
        if pe not in ("RoPE", "RoPE2d", "RoPE2dV2"):
            return t
        n_img = t.shape[2]
        tabs = self._rope_tables(n_img, n_img, hw, t.device)
        if pe == "RoPE2dV2":
            return rotate_v2(t, *hw, tabs)
        return rotate(t, *tabs)

    def _qkv(self, t, sfx, heads, rope, hw):
        """q, k, v of stream `sfx` in heads: normed (softmax types) or L2
        normalised (cosine, cosine2), rotated when `rope`, k and v merged
        pairwise under kv_merge_attn (sd3_tpu/ops/attention.py:407-448)."""
        q = heads(linear(t, getattr(self, "query_proj" + sfx)), self.hd_qk)
        k = heads(linear(t, getattr(self, "key_proj" + sfx)), self.hd_qk)
        v = heads(linear(t, getattr(self, "value_proj" + sfx)),
                  self.dim // self.num_heads)
        if self.attn_type in SOFTMAX_TYPES:
            q = getattr(self, "q_norm" + sfx)(q)
            k = getattr(self, "k_norm" + sfx)(k)
        if self.attn_type in ("cosine", "cosine2"):
            q, k = _l2_normalize(q), _l2_normalize(k)
        if rope:
            q, k = self._rope(q, hw), self._rope(k, hw)
        if self.kv_merge_attn:
            k, v = _merge_pairs(k), _merge_pairs(v)
        return q, k, v

    def _general(self, x, c, hw, tail=None):
        """sd3_tpu/ops/attention.py:401-476: both streams (or one), every
        attention type; a tail's prologue and epilogue in PyTorch, with no
        kernel (the single stream takes the prologue only, as JAX)."""
        if tail is not None:
            x = _adaln(x, tail["shift_x"], tail["scale_x"])
            if self.dual:
                c = _adaln(c, tail["shift_c"], tail["scale_c"])
        b, n, _ = x.shape
        nh = self.num_heads

        def heads(t, hd):
            return t.reshape(b, t.shape[1], nh, hd).transpose(1, 2)

        def unheads(t):
            return t.transpose(1, 2).reshape(b, t.shape[2], -1)

        if self.dual:
            qx, kx, vx = self._qkv(x, "_x", heads, True, hw)
            qc, kc, vc = self._qkv(c, "_c", heads, False, hw)
            q, k, v = (torch.cat(p, dim=2) for p in ((qx, qc), (kx, kc),
                                                     (vx, vc)))
        else:
            q, k, v = self._qkv(x, "", heads, True, hw)
        attn = attention_core(q, k, v, self.attn_type, self.scale,
                              causal=self.causal,
                              norm_const=getattr(self, "norm_const", None))
        if not self.dual:
            return linear(unheads(attn), self.out_proj)
        out_x = linear(unheads(attn[:, :, :n]), self.out_proj_x)
        out_c = unheads(attn[:, :, n:])
        if tail is not None:
            out_x = _gate_res(out_x, tail["gate_x"], tail["res_x"])
            if self.last:
                return out_x, tail["res_c"]
            return out_x, _gate_res(linear(out_c, self.out_proj_c),
                                    tail["gate_c"], tail["res_c"])
        if not self.last:
            out_c = linear(out_c, self.out_proj_c)
        return out_x, out_c
