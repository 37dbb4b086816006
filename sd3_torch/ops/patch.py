"""Patchification and patch embedding (JAX counterpart: sd3_tpu/ops/patch.py).

- `patchify` / `unpatchify`: NCHW images <-> (B, N, C*p*p) tokens with
  zero-pad/crop to patch multiples; token feature order (C, ph, pw), as in
  reference patchify.py:4-71.
- `PatchEmbed`: the stride==kernel conv-patchify (reference
  ImagePositionalEncoding.py:90-203) as patchify + one matmul. The weight keeps
  the reference's Conv2d shape (O, C, p, p) under `proj.weight`, so the
  state-dict key is `pos_enc.proj.weight`; (O, C*p*p) is a free view of it
  in exactly the (C, ph, pw) token feature order. With
  pos_embed_type="absolute" it adds the SD3 2-D sin-cos table.
- `get_2d_sincos_pos_embed` / `cropped_pos_embed`: that table (reference
  ImagePositionalEncoding.py:61-80, 152-173): a `pos_embed_max_size` square
  grid whose positions are scaled by base_size / grid_size and
  1 / interpolation_scale, rows embedding the first half of the features
  and columns the second (meshgrid(w, h) order), omega in fp64 as the
  reference's numpy; centre-cropped to the image's token grid. The table is
  a recomputed buffer in the reference (`pos_enc.pos_embed`), never loaded.
"""

from __future__ import annotations

import functools

import numpy as np
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


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """(M,) positions -> (M, embed_dim): [sin(p w) | cos(p w)], fp64 omega."""
    if embed_dim % 2:
        raise ValueError(f"embed_dim {embed_dim} is odd")
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000 ** omega
    out = np.einsum("m,d->md", pos.reshape(-1), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


def get_2d_sincos_pos_embed(embed_dim: int, grid_size, base_size: int = 16,
                            interpolation_scale: float = 1.0) -> np.ndarray:
    """The SD3 absolute table, (grid_h * grid_w, embed_dim), fp64."""
    if isinstance(grid_size, int):
        grid_size = (grid_size, grid_size)
    gh = (np.arange(grid_size[0], dtype=np.float32)
          / (grid_size[0] / base_size) / interpolation_scale)
    gw = (np.arange(grid_size[1], dtype=np.float32)
          / (grid_size[1] / base_size) / interpolation_scale)
    grid = np.meshgrid(gw, gh)  # w goes first, as in the reference
    grid = np.stack(grid, axis=0).reshape([2, 1, grid_size[1], grid_size[0]])
    emb_h = _sincos_1d(embed_dim // 2, grid[0])
    emb_w = _sincos_1d(embed_dim // 2, grid[1])
    return np.concatenate([emb_h, emb_w], axis=1)


@functools.lru_cache(maxsize=8)
def _abs_pos_table(embed_dim: int, max_size: int, base_size: int,
                   interpolation_scale: float) -> np.ndarray:
    t = np.asarray(get_2d_sincos_pos_embed(embed_dim, max_size, base_size,
                                           interpolation_scale), np.float32)
    t.flags.writeable = False  # cached and shared
    return t


def cropped_pos_embed(embed_dim: int, height_tokens: int, width_tokens: int,
                      max_size: int, base_size: int,
                      interpolation_scale: float = 1.0) -> np.ndarray:
    """The centre (height_tokens, width_tokens) crop of the (max_size,
    max_size) table, (1, h * w, embed_dim) fp32."""
    if height_tokens > max_size or width_tokens > max_size:
        raise ValueError(f"a {height_tokens} x {width_tokens} token grid "
                         f"exceeds pos_embed_max_size {max_size}")
    table = _abs_pos_table(embed_dim, max_size, base_size,
                           interpolation_scale)
    table = table.reshape(max_size, max_size, embed_dim)
    top = (max_size - height_tokens) // 2
    left = (max_size - width_tokens) // 2
    crop = table[top:top + height_tokens, left:left + width_tokens]
    return crop.reshape(1, height_tokens * width_tokens, embed_dim)


class _Proj(nn.Module):
    """Holds the Conv2d-shaped weight under the reference name `proj`."""

    def __init__(self, in_channels, embed_dim, patch_size, device=None,
                 dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(
            embed_dim, in_channels, patch_size, patch_size, device=device,
            dtype=dtype))


class PatchEmbed(nn.Module):
    """Conv-patchify (kernel = stride = patch_size), bias-free, as a matmul;
    with pos_embed_type="absolute" plus the centre-cropped sin-cos table
    (`cropped_pos_embed`) in latent's dtype, built once per token grid and
    device and kept there. The RoPE and NoPE paths add nothing here."""

    def __init__(self, patch_size: int, in_channels: int, embed_dim: int,
                 pos_embed_type: str = "RoPE2d", pos_embed_max_size: int = 256,
                 base_size: int = 128, interpolation_scale: float = 1.0,
                 device=None, dtype=None):
        super().__init__()
        self.patch_size = patch_size
        self.absolute = pos_embed_type == "absolute"
        self.table_args = (embed_dim, pos_embed_max_size, base_size,
                           interpolation_scale)
        self.proj = _Proj(in_channels, embed_dim, patch_size, device, dtype)
        self._tables: dict = {}  # (h, w, device) -> fp32 table on device

    def pos_table(self, h: int, w: int, device) -> torch.Tensor:
        """The (1, h * w, embed_dim) fp32 table of an h x w token grid."""
        key = (h, w, torch.device(device))
        if key not in self._tables:
            dim, max_size, base, interp = self.table_args
            self._tables[key] = torch.tensor(
                cropped_pos_embed(dim, h, w, max_size, base, interp),
                device=device)
        return self._tables[key]

    def forward(self, latent: torch.Tensor) -> torch.Tensor:
        """latent: (B, C, H, W) -> (B, N, embed_dim) in latent's dtype."""
        p = self.patch_size
        tokens = patchify(latent, (p, p))
        w = self.proj.weight.to(latent.dtype)
        out = tokens @ w.reshape(w.shape[0], -1).t()
        if self.absolute:
            h, wt = latent.shape[2] // p, latent.shape[3] // p
            out = out + self.pos_table(h, wt, latent.device).to(out.dtype)
        return out
