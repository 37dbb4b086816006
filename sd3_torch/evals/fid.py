"""FID evaluation harness (the port's copy of sd3_tpu/evals/fid.py; the
maths is numpy / scipy and the same in both packages).

reference eval/calculate_fid_imagenet.py + calculate_fid_generated.py:
InceptionV3 pool3 activations -> per-set (mu, Sigma) -> Fréchet distance
  FID = |mu1 - mu2|^2 + tr(S1 + S2 - 2 sqrt(S1 S2))
with scipy.linalg.sqrtm (reference calculate_fid_generated.py:70-77,89-113).

The feature extractor is pluggable:
- `TorchInceptionFeatures`: torchvision InceptionV3 (pool3, 2048-d), the
  standard FID backbone; it needs torchvision and a local weights file
  (`--inception_weights`); nothing is fetched.
- `ReducedPixelFeatures`: a deterministic random projection, no weights,
  the same `default_rng(seed)` draws as the JAX package's, so both packages
  give the same features bit for bit. NOT comparable to published FID
  numbers: it exercises the stats / Fréchet pipeline and allows relative
  comparisons.
`default_features` takes the first and falls back to the second, as the
JAX package does; the fallback picks features, not a device or a kernel.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable

import numpy as np


# ---------------------------------------------------------------------------
# Feature extractors
# ---------------------------------------------------------------------------

class ReducedPixelFeatures:
    """Deterministic 2048-d random projection of 32x32 center-cropped pixels."""

    dim = 2048

    def __init__(self, seed: int = 0):
        rng = np.random.default_rng(seed)
        self._w = rng.standard_normal((32 * 32 * 3, self.dim)).astype(np.float32)
        self._w /= np.sqrt(32 * 32 * 3)

    def __call__(self, images: np.ndarray) -> np.ndarray:
        """images: (B, 3, H, W) in [-1, 1] -> (B, 2048)."""
        from PIL import Image
        feats = []
        for img in images:
            arr = np.clip((img.transpose(1, 2, 0) + 1) / 2 * 255, 0, 255)
            im = Image.fromarray(arr.astype(np.uint8)).resize((32, 32))
            x = np.asarray(im, np.float32).reshape(-1) / 255.0
            feats.append(x @ self._w)
        return np.stack(feats)


class TorchInceptionFeatures:
    """InceptionV3 pool3 features via torchvision (needs weights)."""

    dim = 2048

    def __init__(self, weights_path: str | None = None):
        import torch
        import torchvision  # may be absent; caller handles ImportError
        m = torchvision.models.inception_v3(weights=None, aux_logits=True,
                                            init_weights=False)
        if weights_path:
            m.load_state_dict(torch.load(weights_path, map_location="cpu"))
        m.fc = torch.nn.Identity()
        self._m = m.eval()
        self._torch = torch

    def __call__(self, images: np.ndarray) -> np.ndarray:
        import torch.nn.functional as F
        t = self._torch.from_numpy(images.astype(np.float32))
        t = F.interpolate(t, size=(299, 299), mode="bilinear",
                          align_corners=False)
        with self._torch.no_grad():
            return self._m(t).numpy()


def default_features(weights_path: str | None = None):
    try:
        return TorchInceptionFeatures(weights_path)
    except Exception:
        return ReducedPixelFeatures()


# ---------------------------------------------------------------------------
# Statistics + Fréchet distance
# ---------------------------------------------------------------------------

def activation_stats(feats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    mu = feats.mean(axis=0)
    sigma = np.cov(feats, rowvar=False)
    return mu, sigma


def _sqrtm(m: np.ndarray) -> np.ndarray:
    """scipy.linalg.sqrtm without printing: scipy up to 1.17 prints a
    warning for a singular matrix unless given disp=False (then it returns
    the error estimate too); later releases took the argument away and
    print nothing."""
    from scipy import linalg
    try:
        return linalg.sqrtm(m, disp=False)[0]
    except TypeError:
        return linalg.sqrtm(m)


def frechet_distance(mu1, sigma1, mu2, sigma2, eps: float = 1e-6) -> float:
    """Classic FID formula (reference calculate_fid_generated.py:89-113)."""
    diff = mu1 - mu2
    covmean = _sqrtm(sigma1 @ sigma2)
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = _sqrtm((sigma1 + offset) @ (sigma2 + offset))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2 * np.trace(covmean))


def stats_over_images(image_iter: Iterable[np.ndarray],
                      feature_fn: Callable) -> tuple[np.ndarray, np.ndarray]:
    feats = [feature_fn(batch) for batch in image_iter]
    return activation_stats(np.concatenate(feats))


def fid_between_dirs(dir1: str, dir2: str, feature_fn=None,
                     batch_size: int = 32) -> float:
    feature_fn = feature_fn or default_features()

    def iter_dir(d):
        from PIL import Image
        files = sorted(f for f in os.listdir(d)
                       if f.lower().endswith((".png", ".jpg", ".jpeg")))
        for i in range(0, len(files), batch_size):
            imgs = []
            for f in files[i:i + batch_size]:
                with Image.open(os.path.join(d, f)) as im:
                    arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
                imgs.append(arr.transpose(2, 0, 1) * 2 - 1)
            yield np.stack(imgs)

    mu1, s1 = stats_over_images(iter_dir(dir1), feature_fn)
    mu2, s2 = stats_over_images(iter_dir(dir2), feature_fn)
    return frechet_distance(mu1, s1, mu2, s2)


def save_stats(path: str, mu: np.ndarray, sigma: np.ndarray):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez(path, mu=mu, sigma=sigma)


def load_stats(path: str) -> tuple[np.ndarray, np.ndarray]:
    z = np.load(path)
    return z["mu"], z["sigma"]
