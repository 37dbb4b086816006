"""Synthetic training batches (the port's copy of
sd3_tpu/data/pipeline.py::synthetic_batch_iter: numpy, the same shapes, the
same seed and the same draws). The rest of the data feed (parquet buckets,
the ring buffer, encoded batches) waits: ROADMAP.md, port queue, 'Data
feed'."""

from __future__ import annotations

from typing import Iterator

import numpy as np


def synthetic_batch_iter(cfg, batch_size: int, accumulation_steps: int,
                         height: int, width: int, seed: int = 0
                         ) -> Iterator[dict]:
    """Random pre-encoded batches shaped like the trainer input — for smoke
    tests and benchmarking without the frozen encoders."""
    rng = np.random.default_rng(seed)
    lat_h, lat_w = height // 8, width // 8
    while True:
        yield {
            "x0": rng.standard_normal(
                (accumulation_steps, batch_size, cfg.inCh, lat_h, lat_w),
                dtype=np.float32),
            "text": rng.standard_normal(
                (accumulation_steps, batch_size, cfg.text_tokens,
                 cfg.text_hidden_dim), dtype=np.float32),
            "pooled": rng.standard_normal(
                (accumulation_steps, batch_size, cfg.class_dim),
                dtype=np.float32),
        }
