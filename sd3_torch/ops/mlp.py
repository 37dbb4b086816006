"""Feed-forward block (JAX counterpart: sd3_tpu/ops/mlp.py).

Packed SwiGLU as in reference MLP.py and xformers' SwiGLU: w12 (in ->
2*hidden, biased) and w3 (hidden -> out, biased), `w3(silu(x1) * x2)` with
(x1, x2) the two halves of w12(x). The float path: plain GEMMs, as the JAX
package leaves them to XLA. The parameters sit under the scope `MLP`
(`MLP_x.MLP.w12.weight`), the reference state-dict layout.

`swiglu_old` (flat scope), `gelu` and the int8 fused-MLP kernels are not
ported yet.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from sd3_torch.ops.norms import linear


class SwiGLU(nn.Module):
    """y = w3(silu(w12(x)[..., :h]) * w12(x)[..., h:])."""

    def __init__(self, dim: int, hidden: int, device=None, dtype=None):
        super().__init__()
        self.w12 = nn.Linear(dim, 2 * hidden, bias=True, device=device,
                             dtype=dtype)
        self.w3 = nn.Linear(hidden, dim, bias=True, device=device, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x1, x2 = linear(x, self.w12).chunk(2, dim=-1)
        return linear(F.silu(x1) * x2, self.w3)


class MLP(nn.Module):
    """MLP dispatcher: act='swiglu' wraps SwiGLU under the scope `MLP`."""

    def __init__(self, dim: int, hidden_scale: float = 4.0,
                 act: str = "swiglu", device=None, dtype=None):
        super().__init__()
        if act != "swiglu":
            raise NotImplementedError(
                f"MLP act={act!r} is not ported yet: ROADMAP.md, port queue, "
                "'gelu / swiglu_old'")
        self.MLP = SwiGLU(dim, int(dim * hidden_scale), device=device,
                          dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.MLP(x)
