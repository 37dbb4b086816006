"""Rotary position embeddings (JAX counterpart: sd3_tpu/ops/rope.py).

This slice ports the 2-D axial "RoPE2d" path of the published config:
frequencies `1/theta^(arange(0, dim_r, 2)/dim_r)` per axis, each repeated
twice *consecutively* ([f0, f0, f1, f1, ...]), row angles in the first half of
the head dim and column angles in the second (reference
rotary_embedding.py:269-288), applied with the interleaved-pair rotation
(x0, x1) -> (x0 cos - x1 sin, x1 cos + x0 sin). It is NOT the half-split
`rotate_half` common in PyTorch code. As in the reference, the 2-D path uses
raw `arange` positions unless `interpolate_factor` is given.

The 1-D "RoPE" and the 3-rotation "RoPE2dV2" variants are not ported yet.
Angle tables are computed in numpy float32, exactly as the JAX package does.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    y = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-y[..., 1], y[..., 0]], dim=-1).reshape(x.shape)


def apply_rope(x: torch.Tensor, angles) -> torch.Tensor:
    """Interleaved-pair rotation of the first angles.shape[-1] features of x
    (the rest pass through); computed in fp32, cast back to x's dtype.
    angles: numpy or tensor, broadcastable to x's leading dims."""
    dtype = x.dtype
    a = torch.tensor(np.asarray(angles, np.float32), device=x.device)
    rot = a.shape[-1]
    xf = x.float()
    x_rot, x_pass = xf[..., :rot], xf[..., rot:]
    out = x_rot * torch.cos(a) + _rotate_half_interleaved(x_rot) * torch.sin(a)
    if x_pass.shape[-1]:
        out = torch.cat([out, x_pass], dim=-1)
    return out.to(dtype)


@functools.lru_cache(maxsize=64)
def _rope2d_axial_angles_cached(h: int, w: int, head_dim: int,
                                interpolate_factor: float, theta: float):
    dim_r = head_dim // 2  # per-axis rotation width
    inv = 1.0 / (theta ** (np.arange(0, dim_r, 2, dtype=np.float32)[: dim_r // 2]
                           / dim_r))
    pos_h = np.arange(h, dtype=np.float32) / interpolate_factor
    pos_w = np.arange(w, dtype=np.float32) / interpolate_factor
    ang_h = np.repeat(pos_h[:, None] * inv[None, :], 2, axis=-1)  # (h, dim_r)
    ang_w = np.repeat(pos_w[:, None] * inv[None, :], 2, axis=-1)  # (w, dim_r)
    ang_h = np.broadcast_to(ang_h[:, None, :], (h, w, dim_r))
    ang_w = np.broadcast_to(ang_w[None, :, :], (h, w, dim_r))
    out = np.concatenate([ang_h, ang_w], axis=-1)  # (h, w, head_dim)
    out.flags.writeable = False  # cached and shared: callers must not mutate
    return out


def rope2d_axial_angles(h: int, w: int, head_dim: int,
                        interpolate_factor: float = 1.0,
                        theta: float = 10000.0) -> np.ndarray:
    """Read-only angle table (h, w, head_dim) for the 2-D axial path."""
    return _rope2d_axial_angles_cached(int(h), int(w), int(head_dim),
                                       float(interpolate_factor), float(theta))
