"""Sinusoidal timestep embedding with the reference's layout (JAX
counterpart: sd3_tpu/ops/time_embed.py; reference PositionalEncoding.py:8-30):

  denom[i] = 10000 ** (2*i / dim),  i in [0, dim)   (full dim, not dim/2)
  emb      = t / denom
  output   = concat(sin(emb[:, 0::2]), cos(emb[:, 1::2]))

The scalar fed in is `t * time_scale`, a learnable scalar that starts at 1000
(reference diff_model.py:213,306). The sinusoid is computed in fp32.
"""

from __future__ import annotations

import torch
from torch import nn

from sd3_torch.ops.norms import linear


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """t: (B,) -> (B, dim) float32 embedding."""
    t = t.float()
    i = torch.arange(dim, dtype=torch.float32, device=t.device)
    denom = torch.pow(10000.0, (2.0 * i) / dim)
    emb = t[:, None] / denom[None, :]
    return torch.cat([torch.sin(emb[:, 0::2]), torch.cos(emb[:, 1::2])], -1)


def embed_time(t: torch.Tensor, time_scale: torch.Tensor, t_emb2: nn.Linear,
               compute_dtype: torch.dtype) -> torch.Tensor:
    """`t_emb2(sinusoid(t * time_scale))` (reference diff_model.py:156-157).

    The reference keeps `time_scale` (shape (1,)) and `t_emb2` at the model's
    top level (state-dict keys `time_scale`, `t_emb2.weight`), so `MMDiT` owns
    both and passes them in.
    """
    emb = timestep_embedding(t.float() * time_scale.float()[0],
                             t_emb2.in_features)
    return linear(emb.to(compute_dtype), t_emb2)
