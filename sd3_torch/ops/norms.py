"""Normalization blocks (JAX counterpart: sd3_tpu/ops/norms.py).

- `rms_norm` / `RMSNorm`: torch.nn.RMSNorm semantics, eps=None meaning the
  epsilon of the *input* dtype (reference Attention.py:61-67,
  diff_model.py:168-169).
- `layer_norm`: no-affine LayerNorm, eps=1e-5 (reference Norm.py:10).
- `AdaLNorm`: LayerNorm then `x * (1 + c_scale(y)) + c_shift(y)` (reference
  Norm.py:16-22), modulated in the compute dtype.

Statistics are computed in float32 whatever the compute dtype, then cast back.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def rms_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
             eps: float | None = None) -> torch.Tensor:
    """RMSNorm over the last axis; eps=None uses the input dtype's epsilon."""
    dtype = x.dtype
    if eps is None:
        eps = torch.finfo(dtype).eps
    xf = x.float()
    y = (xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps)).to(dtype)
    if weight is not None:
        y = y * weight.to(dtype)
    return y


def layer_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """No-affine LayerNorm over the last axis (statistics in fp32)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def linear(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """`layer(x)` in x's dtype: parameters are cast to the compute dtype at
    use, as flax's Dense(dtype=...) does (a no-op when they already are).
    A quantized layer (ops.quant.Int8Linear) applies itself."""
    if not isinstance(layer, nn.Linear):
        return layer(x)
    dt = x.dtype
    b = None if layer.bias is None else layer.bias.to(dt)
    return F.linear(x, layer.weight.to(dt), b)


class RMSNorm(nn.Module):
    """RMSNorm with a learnable elementwise weight (init ones)."""

    def __init__(self, dim: int, eps: float | None = None, device=None,
                 dtype=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, device=device, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.weight, self.eps)


class AdaLNorm(nn.Module):
    """AdaLN: `LayerNorm(x) * (1 + c_scale(y)) + c_shift(y)`; y: (B, c_dim),
    x: (B, N, dim). Both conditioning projections are bias-free."""

    def __init__(self, dim: int, c_dim: int, device=None, dtype=None):
        super().__init__()
        self.c_shift = nn.Linear(c_dim, dim, bias=False, device=device,
                                 dtype=dtype)
        self.c_scale = nn.Linear(c_dim, dim, bias=False, device=device,
                                 dtype=dtype)

    def modulation(self, y: torch.Tensor):
        """The (shift, scale) vectors (B, dim), for consumers that apply the
        LayerNorm and modulation themselves (the int8 MLP kernels)."""
        return linear(y, self.c_shift), linear(y, self.c_scale)

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        shift, scale = self.modulation(y)
        x = layer_norm(x)
        return x * (1.0 + scale[:, None, :]) + shift[:, None, :]
