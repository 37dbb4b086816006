"""Feed-forward block (JAX counterpart: sd3_tpu/ops/mlp.py).

Packed SwiGLU as in reference MLP.py and xformers' SwiGLU: w12 (in ->
2*hidden, biased) and w3 (hidden -> out, biased), `w3(silu(x1) * x2)` with
(x1, x2) the two halves of w12(x). The float path: plain GEMMs, as the JAX
package leaves them to XLA. The parameters sit under the scope `MLP`
(`MLP_x.MLP.w12.weight`), the reference state-dict layout.

Under quant="int8" w12 and w3 are `Int8Linear`s. When both are quantized,
hidden is a multiple of 128 and `fused_mlp` is on (`fused_mlp_ok`, the JAX
`_fused_mlp_ok`, whose SD3_NO_FUSED_MLP=1 is `fused_mlp=False`) the chain
runs through the int8 SwiGLU kernels (ops/fused_mlp.py), which also take the
block's AdaLN prologue and gate + residual epilogue, on the route that
`tail_fusion` names (the JAX SD3_MLP_TAIL_FUSION); otherwise it is two int8
projections with silu * mul between them.

`MLP(act=...)` is the JAX dispatcher (sd3_tpu/ops/mlp.py:77-126):
- "swiglu": the SwiGLU above under the scope `MLP` (`MLP_x.MLP.w12`);
- "swiglu_old": the same math with w12 / w3 flat in the block's scope
  (`MLP_x.w12.weight`), the layout of the reference's old checkpoints
  (Transformer_Block_Dual.py:31-34); under int8 it takes the same kernels;
- "gelu": biased `lin_up` (dim -> hidden), exact erf GELU, biased
  `lin_down` (reference MLP.py:20-23); int8 projections under quant, no
  kernel (XLA in the JAX package), and no block tail.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sd3_torch.ops.fused_mlp import fused_swiglu_int8
from sd3_torch.ops.norms import linear
from sd3_torch.ops.quant import make_linear


def fused_mlp_ok(quant: str, hidden: int, quant_skip: tuple = (),
                 fused_mlp: bool = True) -> bool:
    """The int8 SwiGLU kernels serve this MLP (sd3_tpu/ops/mlp.py:44-47,
    with `fused_mlp` in place of its SD3_NO_FUSED_MLP read)."""
    return (fused_mlp and quant == "int8" and hidden % 128 == 0
            and not ({"w12", "w3"} & set(quant_skip)))


MLP_TYPES = ("swiglu", "swiglu_old", "gelu")


class SwiGLU(nn.Module):
    """y = w3(silu(w12(x)[..., :h]) * w12(x)[..., h:])."""

    def __init__(self, dim: int, hidden: int, quant: str = "none",
                 quant_skip: tuple = (), fused_mlp: bool = True,
                 tail_fusion: str = "2d", device=None, dtype=None):
        super().__init__()
        self._init_swiglu(dim, hidden, quant, quant_skip, fused_mlp,
                          tail_fusion, device, dtype)

    def _init_swiglu(self, dim, hidden, quant, quant_skip, fused_mlp,
                     tail_fusion, device, dtype):
        self.hidden = hidden
        self.quant, self.quant_skip = quant, tuple(quant_skip)
        self.fused_mlp, self.tail_fusion = fused_mlp, tail_fusion
        kw = dict(quant=quant, quant_skip=self.quant_skip, device=device,
                  dtype=dtype)
        self.w12 = make_linear(dim, 2 * hidden, True, "w12", **kw)
        self.w3 = make_linear(hidden, dim, True, "w3", **kw)

    @property
    def fused_ok(self) -> bool:
        return fused_mlp_ok(self.quant, self.hidden, self.quant_skip,
                            self.fused_mlp)

    def forward(self, x: torch.Tensor, shift=None, scale=None, gate=None,
                residual: bool = False) -> torch.Tensor:
        if self.fused_ok:
            w12, w3 = self.w12, self.w3
            return fused_swiglu_int8(
                x, w12.weight_q, w12.weight_scale, w12.bias, w3.weight_q,
                w3.weight_scale, w3.bias, shift=shift, scale=scale,
                gate=gate, residual=residual, tail_fusion=self.tail_fusion)
        if shift is not None or gate is not None or residual:
            raise ValueError("the block-tail arguments need the int8 SwiGLU "
                             "kernels (fused_ok)")
        x1, x2 = linear(x, self.w12).chunk(2, dim=-1)
        return linear(F.silu(x1) * x2, self.w3)


class MLP(SwiGLU):
    """MLP dispatcher (see the module docstring): "swiglu" wraps SwiGLU under
    the scope `MLP`, "swiglu_old" holds w12 / w3 itself, "gelu" lin_up /
    lin_down. `fused_ok`: the int8 SwiGLU kernels serve it (never gelu)."""

    def __init__(self, dim: int, hidden_scale: float = 4.0,
                 act: str = "swiglu", quant: str = "none",
                 quant_skip: tuple = (), fused_mlp: bool = True,
                 tail_fusion: str = "2d", device=None, dtype=None):
        nn.Module.__init__(self)
        if act not in MLP_TYPES:
            raise ValueError(f"unknown MLP act: {act!r}")
        self.act = act
        hidden = int(dim * hidden_scale)
        kw = dict(quant=quant, quant_skip=tuple(quant_skip), fused_mlp=fused_mlp,
                  tail_fusion=tail_fusion, device=device, dtype=dtype)
        if act == "swiglu":
            self.MLP = SwiGLU(dim, hidden, **kw)
        elif act == "swiglu_old":
            self._init_swiglu(dim, hidden, **kw)
        else:
            self.quant, self.quant_skip = quant, tuple(quant_skip)
            self.lin_up = make_linear(dim, hidden, True, "lin_up", quant,
                                      self.quant_skip, device=device,
                                      dtype=dtype)
            self.lin_down = make_linear(hidden, dim, True, "lin_down", quant,
                                        self.quant_skip, device=device,
                                        dtype=dtype)

    @property
    def fused_ok(self) -> bool:
        if self.act == "swiglu":
            return self.MLP.fused_ok
        return self.act == "swiglu_old" and super().fused_ok

    def forward(self, x: torch.Tensor, shift=None, scale=None, gate=None,
                residual: bool = False) -> torch.Tensor:
        if self.act == "swiglu":
            return self.MLP(x, shift, scale, gate, residual)
        if self.act == "swiglu_old":
            return super().forward(x, shift, scale, gate, residual)
        if shift is not None or gate is not None or residual:
            raise ValueError("the block-tail arguments need the swiglu int8 "
                             "path")
        return linear(F.gelu(linear(x, self.lin_up)), self.lin_down)
