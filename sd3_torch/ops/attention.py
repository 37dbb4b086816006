"""Joint dual-stream attention (JAX counterpart: sd3_tpu/ops/attention.py).

Semantics of reference src/blocks/Attention.py: separate bias-free q/k/v/out
projections per stream (image "x", text "c"), per-head q/k RMSNorm per
stream, RoPE on the IMAGE tokens only, the two streams concatenated along the
sequence and attended jointly, then split back; the `last` block has no text
out-projection. The softmax scale is head_dim(v) ** -0.5, taken from the
*value* head dim (reference Attention.py:57).

Two paths, chosen as the JAX package chooses (`_fused_path_ok`):
- the fused path, the one the published config takes for sampling: raw
  projections go to kernel K1 (ops/fused_attention.py), which applies the
  norms and the rotation itself;
- the general path (`use_fused=False`, as the trainer builds it, or
  attn_type "softmax"): per-stream projections, per-head RMSNorm in the
  compute dtype, RoPE in fp32 on the image tokens, the streams concatenated,
  then `attention_core` on (B, H, N, D): flash attention (kernels K5, K6a,
  K6b, ops/flash_attention.py) for "softmax_flash", plain softmax attention
  for "softmax" (XLA in the JAX package).
The other attention types, causal, `kv_merge_attn`, `qk_half_dim` and the
single stream raise NotImplementedError.

Above 2048 padded joint tokens (the 1024px stage) the fused path's
attention is the streaming kernel K7 instead of K1, as in the JAX package.
Under quant="int8" the eight projections are w8a8 `Int8Linear`s (names in
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

from sd3_torch.config import ATTN_TAILS
from sd3_torch.ops.flash_attention import flash_attention
from sd3_torch.ops.fused_attention import (fold_row_tables, fused_attention,
                                           rope_row_tables)
from sd3_torch.ops.fused_dense import (fused_out_gate_residual_int8,
                                       fused_qkv_adaln_int8)
from sd3_torch.ops.norms import RMSNorm, layer_norm, linear
from sd3_torch.ops.quant import make_linear
from sd3_torch.ops.rope import _rotate_half_interleaved, rope2d_axial_angles

_GENERAL_PATH = ("is not ported yet: ROADMAP.md, port queue, 'attention "
                 "general path'")
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


def attention_core(q, k, v, attn_type: str, scale: float) -> torch.Tensor:
    """Softmax attention on (B, H, N, D) tensors, non-causal
    (sd3_tpu/ops/attention.py:67-97): flash attention for "softmax_flash",
    else fp32 logits, an fp32 softmax rounded to v's dtype, and P.V with
    fp32 sums."""
    if attn_type == "softmax_flash":
        return flash_attention(q, k, v, scale)
    if attn_type != "softmax":
        raise NotImplementedError(f"attn_type={attn_type!r} {_GENERAL_PATH}")
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


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


class JointAttention(nn.Module):
    """Dual-stream joint attention: the fused path (K1 / K4 / K7 / K8b), or
    the general path (see the module docstring). `use_fused=False` keeps
    the general path even where the fused one applies
    (sd3_tpu/ops/attention.py:177-181: trainers pass it, for the real
    two-kernel flash VJP). `int8_pv` opts in to int8 P.V where
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
        if attn_type == "both":
            attn_type = "softmax" if (layer_idx or 0) % 2 == 0 else "cosine"
        hd = dim // num_heads
        if attn_type not in SOFTMAX_TYPES:
            raise NotImplementedError(f"attn_type={attn_type!r} {_GENERAL_PATH}")
        for flag, name in ((causal, "causal"), (kv_merge_attn, "kv_merge_attn"),
                           (qk_half_dim, "qk_half_dim"), (not dual, "dual=False")):
            if flag:
                raise NotImplementedError(f"{name} {_GENERAL_PATH}")
        if positional_encoding in ("RoPE", "RoPE2dV2"):
            raise NotImplementedError(
                f"positional_encoding={positional_encoding!r} is not ported "
                "yet: ROADMAP.md, port queue, 'RoPE1d / RoPE2dV2'")
        # sd3_tpu/ops/attention.py:207-217, with the options above ruled out
        self.fused = (use_fused and attn_type == "softmax_flash"
                      and hd % 2 == 0 and 128 % hd == 0)
        self.attn_type = attn_type
        self.dim = dim
        self.num_heads = num_heads
        self.positional_encoding = positional_encoding
        self.rope_scale = rope_scale
        self.rope2d_interpolate = rope2d_interpolate
        self.last = last
        self.scale = hd ** -0.5  # value head dim (reference Attention.py:57)
        self.quant, self.quant_skip = quant, tuple(quant_skip)
        self.int8_pv = int8_pv
        names = ["query_proj_x", "key_proj_x", "value_proj_x", "out_proj_x",
                 "query_proj_c", "key_proj_c", "value_proj_c"]
        if not last:
            names.append("out_proj_c")
        for name in names:
            setattr(self, name, make_linear(
                dim, dim, False, name, quant, self.quant_skip, device=device,
                dtype=dtype))
        self.q_norm_x = RMSNorm(hd, device=device, dtype=dtype)
        self.k_norm_x = RMSNorm(hd, device=device, dtype=dtype)
        self.q_norm_c = RMSNorm(hd, device=device, dtype=dtype)
        self.k_norm_c = RMSNorm(hd, device=device, dtype=dtype)
        # (n_img, n, hw, device) -> rotation tables on the device, built once
        # so the sampling loop copies nothing from the host per call.
        self._tables: dict = {}

    def _rope_tables(self, n_img: int, n: int, hw, device):
        key = (n_img, n, hw, device)
        if key not in self._tables:
            hd = self.dim // self.num_heads
            angles = None
            if self.positional_encoding == "RoPE2d":
                h, w = hw
                factor = (1.0 / self.rope_scale if self.rope2d_interpolate
                          else 1.0)
                angles = rope2d_axial_angles(h, w, hd, factor).reshape(n_img, hd)
            self._tables[key] = tuple(torch.as_tensor(t, device=device)
                                      for t in rope_row_tables(angles, n, hd))
        return self._tables[key]

    def forward(self, x: torch.Tensor, c: torch.Tensor, hw, tail=None,
                tail_mode: str = "all"):
        """x: (B, N, dim) image tokens, c: (B, M, dim) text tokens, both in
        the compute dtype; hw: the image token grid (h, w), h*w == N.
        Returns (x_out, c_out); c_out is not projected when `last`.

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
            return self._general(x, c, tuple(hw), tail)
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
        """RoPE on (B, H, N_img, D) image-token q or k, in fp32, cast back
        (sd3_tpu/ops/rope.py::apply_rope with the RoPE2d angles). The cos /
        sin rows are those of the fused path's tables, already on the
        device."""
        if self.positional_encoding != "RoPE2d":
            return t  # NoPE / absolute: nothing at the attention level
        n_img = t.shape[2]
        cos, sin = self._rope_tables(n_img, n_img, hw, t.device)
        tf = t.float()
        return (tf * cos + _rotate_half_interleaved(tf) * sin).to(t.dtype)

    def _general(self, x, c, hw, tail=None):
        """sd3_tpu/ops/attention.py:401-476, dual-stream and non-causal; a
        tail's prologue and epilogue in PyTorch, with no kernel."""
        if tail is not None:
            x = _adaln(x, tail["shift_x"], tail["scale_x"])
            c = _adaln(c, tail["shift_c"], tail["scale_c"])
        b, n, _ = x.shape
        nh, hd = self.num_heads, self.dim // self.num_heads

        def heads(t):
            return t.reshape(b, t.shape[1], nh, hd).transpose(1, 2)

        def unheads(t):
            return t.transpose(1, 2).reshape(b, t.shape[2], -1)

        q_x = self._rope(self.q_norm_x(heads(linear(x, self.query_proj_x))), hw)
        k_x = self._rope(self.k_norm_x(heads(linear(x, self.key_proj_x))), hw)
        v_x = heads(linear(x, self.value_proj_x))
        q_c = self.q_norm_c(heads(linear(c, self.query_proj_c)))
        k_c = self.k_norm_c(heads(linear(c, self.key_proj_c)))
        v_c = heads(linear(c, self.value_proj_c))
        attn = attention_core(torch.cat([q_x, q_c], dim=2),
                              torch.cat([k_x, k_c], dim=2),
                              torch.cat([v_x, v_c], dim=2),
                              self.attn_type, self.scale)
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
