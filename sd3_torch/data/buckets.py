"""Aspect-ratio bucket indexing and sampling (the port's copy of
sd3_tpu/data/buckets.py: the same files, the same numpy generators and
draws; reference src/helpers/dataset_utils.py:48-161, src/create_indices.py).

- a one-off scan groups dataset row indices by their `bucket_size` column
  ("HxW" strings written by the phase-resize step) and saves the dict as
  .npy, readable by either package;
- training draws a bucket in proportion to its population, then a uniform
  batch within it, so every batch has one shape;
- buckets with <= 3 x batch samples are dropped;
- the first `first_n` batches come from the largest bucket (the reference
  pre-allocates the card's memory with them).
"""

from __future__ import annotations

import os
from collections import defaultdict

import numpy as np


def build_bucket_indices(bucket_sizes, path: str | None = None) -> dict:
    """Group row indices by bucket_size string. bucket_sizes: any iterable
    of str (a pyarrow column's values, a list). With `path`, saves the dict
    as .npy (reference dataset_utils.py:113), or loads it when the file
    already exists."""
    if path and os.path.exists(path):
        return load_bucket_indices(path)
    buckets: dict[str, list[int]] = defaultdict(list)
    for i, b in enumerate(bucket_sizes):
        buckets[str(b)].append(i)
    buckets = dict(buckets)
    if path:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.save(path, buckets)  # type: ignore[arg-type]
    return buckets


def load_bucket_indices(path: str) -> dict:
    return np.load(path, allow_pickle=True).item()


class RandomBucketSampler:
    """Yields (bucket, row indices); every batch from a single bucket.

    Multi-host sharding: every host keeps the same bucket set and choice
    probabilities (global bucket sizes), so a shared `bucket_seed` gives
    every host the same bucket (batch shape) sequence, while each host
    samples items only from its own interleaved slice (`shard_index` of
    `shard_count`)."""

    def __init__(self, buckets: dict, batch_size: int, seed: int = 0,
                 first_n_largest: int = 0, bucket_seed: int | None = None,
                 shard_index: int = 0, shard_count: int = 1):
        if not 0 <= shard_index < shard_count:
            raise ValueError(f"shard {shard_index} of {shard_count}")
        # the reference keeps only len > 3 * batch, scaled by shard_count so
        # that every shard's slice still holds a full batch
        kept = [(k, np.asarray(v)) for k, v in buckets.items()
                if len(v) > 3 * batch_size * shard_count]
        if not kept:
            # tiny datasets (tests): keep every bucket with a batch a shard
            kept = [(k, np.asarray(v)) for k, v in buckets.items()
                    if len(v) >= batch_size * shard_count]
        if not kept:
            raise ValueError("no bucket has enough samples for a batch on "
                             "every shard")
        self.batch_size = batch_size
        total = sum(len(v) for _, v in kept)
        self.probs = np.array([len(v) / total for _, v in kept])
        self.buckets = [(k, v[shard_index::shard_count]) for k, v in kept]
        self.rng = np.random.default_rng(seed)
        # the bucket choice has a stream of its own, so hosts can share it
        self.bucket_rng = np.random.default_rng(
            seed if bucket_seed is None else bucket_seed)
        self.first_n = first_n_largest
        # the largest bucket by H*W (reference dataset_utils.py:137-140)
        areas = [int(np.prod([int(s) for s in k.split("x")]))
                 for k, _ in self.buckets]
        self.first_idx = int(np.argmax(areas))

    def bucket_shapes(self) -> list[tuple[int, int]]:
        return [tuple(int(s) for s in k.split("x")) for k, _ in self.buckets]

    def __iter__(self):
        while True:
            if self.first_n > 0:
                self.first_n -= 1
                bi = self.first_idx
            else:
                bi = self.bucket_rng.choice(len(self.buckets), p=self.probs)
            key, idxs = self.buckets[bi]
            sel = self.rng.choice(idxs, size=self.batch_size, replace=False)
            yield key, sel.tolist()
