"""What the frozen networks share (`clip_text.py`, `gemma2.py`,
`modernbert.py`, `vae.py`): the compute dtype of their dense layers, the
text towers' attention, with fp32 logits and softmax as the JAX
modules compute it (`preferred_element_type=jnp.float32`), and the
half-split (NeoX) rotation of Gemma-2 and ModernBERT."""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30  # the JAX modules' additive mask


def cast_dense(module: torch.nn.Module, dtype: torch.dtype) -> torch.nn.Module:
    """Convs and linears of `module` to the compute dtype `dtype`, as JAX
    casts its fp32 parameters to it; every other parameter (norms,
    embeddings, projections held apart) stays fp32."""
    for m in module.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.to(dtype)
    return module


def attend(q, k, v, bias, scale: float = 1.0,
           softcap: float | None = None) -> torch.Tensor:
    """(B, T, H, D) q, k, v in the compute dtype -> (B, T, H, D) in v's
    dtype: fp32 logits q k^T * scale (the products of the compute dtype's
    values are exact in fp32), soft-capped as cap * tanh(x / cap) when
    `softcap`, plus the fp32 additive `bias` (broadcast to (B, H, T, T)),
    a softmax in fp32, the probabilities rounded to v's dtype, P.V summed
    in fp32, the result rounded to v's dtype. The mask is added to fp32
    logits: rounded to fp16, -1e30 would be -inf, and a fully masked row
    NaN."""
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if softcap is not None:
        logits = softcap * torch.tanh(logits / softcap)
    probs = torch.softmax(logits + bias, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(v.dtype)


def neox_tables(t: int, d: int, theta: float, device):
    """cos, sin (T, D/2) fp32 of positions 0..t-1 on `device`, computed in
    numpy fp32 as the JAX modules compute them."""
    inv = 1.0 / (theta ** (np.arange(0, d, 2, dtype=np.float32) / d))
    freqs = np.arange(t, dtype=np.float32)[:, None] * inv[None, :]
    return tuple(torch.from_numpy(f(freqs).astype(np.float32)).to(device)
                 for f in (np.cos, np.sin))


def neox_rope(x: torch.Tensor, cos: torch.Tensor,
              sin: torch.Tensor) -> torch.Tensor:
    """Half-split rotation of (B, T, H, D) x in fp32 with (T, D/2) tables,
    the result in x's dtype."""
    d = x.shape[-1]
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    xf = x.float()
    x1, x2 = xf[..., : d // 2], xf[..., d // 2:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def pad_bias(attention_mask, t: int, causal: bool,
             device) -> torch.Tensor:
    """The additive fp32 mask (B or 1, 1, T, T): causal (when asked) plus
    padding, -1e30 where masked, as the JAX modules build it."""
    bias = torch.zeros((1, 1, t, t), dtype=torch.float32, device=device)
    if causal:
        tri = torch.ones((t, t), dtype=torch.bool, device=device).tril()
        bias = torch.where(tri, 0.0, NEG_INF)[None, None]
    if attention_mask is not None:
        pad = attention_mask.to(device, torch.float32)[:, None, None, :]
        bias = bias + (1.0 - pad) * NEG_INF
    return bias
