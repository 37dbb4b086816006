"""Patchification and patch embedding (JAX counterpart: sd3_tpu/ops/patch.py).

- `patchify` / `unpatchify`: NCHW images <-> (B, N, C*p*p) tokens with
  zero-pad/crop to patch multiples; token feature order (C, ph, pw), as in
  reference patchify.py:4-71.
- `PatchEmbed`: the stride==kernel conv-patchify (reference
  ImagePositionalEncoding.py:90-203) as patchify + one matmul. The weight keeps
  the reference's Conv2d shape (O, C, p, p) under `proj.weight`, so the
  state-dict key is `pos_enc.proj.weight`; (O, C*p*p) is a free view of it
  in exactly the (C, ph, pw) token feature order.
"""

from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


def patchify(images: torch.Tensor, patch_size: tuple[int, int]) -> torch.Tensor:
    """(B, C, H, W) -> (B, N, C*ph*pw), zero-padded to patch multiples."""
    b, c, h, w = images.shape
    ph, pw = patch_size
    pad_h = (ph - h % ph) % ph
    pad_w = (pw - w % pw) % pw
    x = F.pad(images, (0, pad_w, 0, pad_h))
    hp, wp = h + pad_h, w + pad_w
    x = x.reshape(b, c, hp // ph, ph, wp // pw, pw)
    x = x.permute(0, 2, 4, 1, 3, 5)  # (B, h', w', C, ph, pw)
    return x.reshape(b, (hp // ph) * (wp // pw), c * ph * pw)


def unpatchify(patches: torch.Tensor, patch_size: tuple[int, int],
               original_shape: tuple[int, int]) -> torch.Tensor:
    """(B, N, C*ph*pw) -> (B, C, H, W), cropping any padding."""
    b, n, pdim = patches.shape
    ph, pw = patch_size
    h, w = original_shape
    nph = (h + ph - 1) // ph
    npw = (w + pw - 1) // pw
    c = pdim // (ph * pw)
    x = patches.reshape(b, nph, npw, c, ph, pw)
    x = x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, nph * ph, npw * pw)
    return x[:, :, :h, :w]


class _Proj(nn.Module):
    """Holds the Conv2d-shaped weight under the reference name `proj`."""

    def __init__(self, in_channels, embed_dim, patch_size, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            embed_dim, in_channels, patch_size, patch_size, device=device,
            dtype=dtype))


class PatchEmbed(nn.Module):
    """Conv-patchify (kernel = stride = patch_size), bias-free, as a matmul.

    The absolute sin-cos table (positional_encoding="absolute") is not ported
    yet; the RoPE paths add nothing here.
    """

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 pos_embed_type: str = "RoPE2d", device=None, dtype=None):
        super().__init__()
        if pos_embed_type == "absolute":
            raise NotImplementedError(
                "absolute sin-cos position embedding is not ported yet "
                "(ROADMAP.md, port queue, 'absolute PE')")
        self.patch_size = patch_size
        self.proj = _Proj(in_channels, embed_dim, patch_size, device, dtype)

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent: (B, C, H, W) -> (B, N, embed_dim) in latent's dtype."""
        p = self.patch_size
        tokens = patchify(latent, (p, p))
        w = self.proj.weight.to(latent.dtype)
        return tokens @ w.reshape(w.shape[0], -1).t()
