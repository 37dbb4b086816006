"""Rotary position embeddings (JAX counterpart: sd3_tpu/ops/rope.py).

Three variants, matching the reference ones exactly:
- 1-D "RoPE" (lucidrains rotary-embedding-torch, reference
  rotary_embedding.py): frequencies `1/theta^(arange(0, dim, 2)/dim)`, each
  repeated twice *consecutively* ([f0, f0, f1, f1, ...]), positions divided
  by `interpolate_factor` (1 / RoPE_Scale: the NTK-style interpolation of
  a later stage's larger grid);
- 2-D axial "RoPE2d" (the published config): per-axis frequencies over
  head_dim / 2, row angles in the first half of the head dim and column
  angles in the second (reference rotary_embedding.py:269-288). As in the
  reference, this path uses raw `arange` positions unless
  `interpolate_factor` is given;
- "RoPE2dV2" (reference rotary_embedding_2d_v2.py:16-46): coordinate
  triplets (x1, x2, x3) rotated by a row angle theta and a column angle
  alpha over the first dim3 = (D // 3) * 3 features; the output is the
  concatenation of the three rotated strided groups (g1, g2, g3), not the
  triplets re-interleaved, and the last D - dim3 features pass through.
  Its positions are divided by `interpolate_factor`.
1-D and 2-D apply the interleaved-pair rotation (x0, x1) -> (x0 cos - x1
sin, x1 cos + x0 sin), NOT the half-split `rotate_half` common in PyTorch
code, to the first angles.shape[-1] features (the rest pass through).
Angle and trig tables are computed in numpy float32, exactly as the JAX
package does, cached, and read-only; rotations run in fp32 and are cast
back to the input dtype.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


def _rotate_half_interleaved(x: torch.Tensor) -> torch.Tensor:
    """(x0, x1, x2, x3, ...) -> (-x1, x0, -x3, x2, ...)."""
    y = x.reshape(*x.shape[:-1], x.shape[-1] // 2, 2)
    return torch.stack([-y[..., 1], y[..., 0]], dim=-1).reshape(x.shape)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
           ) -> torch.Tensor:
    """The interleaved-pair rotation of the first cos.shape[-1] features of
    x by tables already on x's device (fp32), the rest passed through;
    computed in fp32, cast back to x's dtype."""
    rot = cos.shape[-1]
    xf = x.float()
    x_rot = xf[..., :rot]
    out = x_rot * cos + _rotate_half_interleaved(x_rot) * sin
    if rot < x.shape[-1]:
        out = torch.cat([out, xf[..., rot:]], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, angles) -> torch.Tensor:
    """Interleaved-pair rotation of the first angles.shape[-1] features of x
    (the rest pass through); computed in fp32, cast back to x's dtype.
    angles: numpy or tensor, broadcastable to x's leading dims."""
    a = torch.tensor(np.asarray(angles, np.float32), device=x.device)
    return rotate(x, torch.cos(a), torch.sin(a))


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False  # cached and shared: callers must not mutate
    return a


@functools.lru_cache(maxsize=64)
def _rope1d_angles_cached(n: int, dim: int, interpolate_factor: float,
                          theta: float):
    pos = np.arange(n, dtype=np.float32) / interpolate_factor
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32)[: dim // 2]
                           / dim))
    return _frozen(np.repeat(pos[:, None] * inv[None, :], 2, axis=-1))


def rope1d_angles(n: int, dim: int, interpolate_factor: float = 1.0,
                  theta: float = 10000.0) -> np.ndarray:
    """Read-only angle table (n, dim) of the 1-D "RoPE" path (positions /
    interpolate_factor)."""
    return _rope1d_angles_cached(int(n), int(dim), float(interpolate_factor),
                                 float(theta))


def apply_rope1d(x: torch.Tensor, interpolate_factor: float = 1.0
                 ) -> torch.Tensor:
    """1-D RoPE along the second-to-last axis of x (..., N, D)."""
    return apply_rope(x, rope1d_angles(x.shape[-2], x.shape[-1],
                                       interpolate_factor))


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
    return _frozen(np.concatenate([ang_h, ang_w], axis=-1))  # (h, w, head_dim)


def rope2d_axial_angles(h: int, w: int, head_dim: int,
                        interpolate_factor: float = 1.0,
                        theta: float = 10000.0) -> np.ndarray:
    """Read-only angle table (h, w, head_dim) for the 2-D axial path."""
    return _rope2d_axial_angles_cached(int(h), int(w), int(head_dim),
                                       float(interpolate_factor), float(theta))


@functools.lru_cache(maxsize=64)
def _rope2dv2_trig_cached(h: int, w: int, head_dim: int,
                          interpolate_factor: float):
    dim3 = (head_dim // 3) * 3
    inv = 1.0 / (10000.0 ** (np.arange(0, dim3, 3, dtype=np.float32) / dim3))
    pos_h = np.arange(h, dtype=np.float32)[:, None] / interpolate_factor
    pos_w = np.arange(w, dtype=np.float32)[:, None] / interpolate_factor
    thetas = (pos_h * inv[None, :])[:, None, :]   # (h, 1, dim3 / 3)
    alphas = (pos_w * inv[None, :])[None, :, :]   # (1, w, dim3 / 3)
    return tuple(_frozen(t) for t in (np.sin(thetas), np.cos(thetas),
                                      np.sin(alphas), np.cos(alphas)))


def rope2dv2_trig(h: int, w: int, head_dim: int,
                  interpolate_factor: float = 1.0):
    """Read-only (sin theta, cos theta (h, 1, dim3 / 3), sin alpha, cos
    alpha (1, w, dim3 / 3)) of the RoPE2dV2 path."""
    return _rope2dv2_trig_cached(int(h), int(w), int(head_dim),
                                 float(interpolate_factor))


def rotate_v2(x: torch.Tensor, h: int, w: int, trig) -> torch.Tensor:
    """RoPE2dV2 of x (B, H, N, D), N == h * w, with the four trig tables
    (`rope2dv2_trig`'s, as fp32 tensors on x's device): the rotated groups
    (g1, g2, g3) concatenated, then the D - dim3 features passed through;
    fp32, cast back to x's dtype."""
    b, nh, n, d = x.shape
    if n != h * w:
        raise ValueError(f"{n} tokens on a {h} x {w} grid")
    dim3 = (d // 3) * 3
    t_sin, t_cos, a_sin, a_cos = trig
    xf = x.float().reshape(b, nh, h, w, d)
    x1, x2, x3 = xf[..., 0:dim3:3], xf[..., 1:dim3:3], xf[..., 2:dim3:3]
    g1 = x1 * t_cos + x2 * (-t_sin) * a_cos + x3 * t_sin * a_sin
    g2 = x1 * t_sin + x2 * t_cos * a_cos + x3 * (-t_cos) * a_sin
    g3 = x2 * a_sin + x3 * a_cos
    out = torch.cat([g1, g2, g3, xf[..., dim3:]], dim=-1)
    return out.reshape(b, nh, n, d).to(x.dtype)


def apply_rope2dv2(x: torch.Tensor, h: int, w: int,
                   interpolate_factor: float = 1.0) -> torch.Tensor:
    """RoPE2dV2 of image tokens x (B, H, N, D), N == h * w (see
    `rotate_v2`)."""
    trig = tuple(torch.tensor(t, device=x.device)
                 for t in rope2dv2_trig(h, w, x.shape[-1], interpolate_factor))
    return rotate_v2(x, h, w, trig)
