"""The frozen encoders on the card between training steps (the port's copy
of sd3_tpu/data/encoded.py; the reference's loader-GPU service,
VAE_T5_CLIP.py).

The host decodes and collates (`data/pipeline.py`, or the ring loader's
processes, `data/ringbuffer.py`); each batch's images go to the card through
pinned memory and are encoded there by the VAE, its captions by the text
encoders, and the results stay on the card: an accumulation group is
stacked there, with no copy back to the host (which would wait for the
card every batch).

The encoder suite is chosen explicitly: real weights come from a directory
(`--encoder_weights DIR`; the port reads no environment variable for it),
stub embeddings only when asked for (`--stub_encoders`). Asking for real
encoders without a directory raises; nothing falls back to the stub.
"""

from __future__ import annotations

import collections
import os
import queue
import threading
from typing import Iterator

import torch

from sd3_torch import resolve_device, to_device
from sd3_torch.data.pipeline import HostDataLoader, ParquetImageText
from sd3_torch.models.text_encoders import load_text_encoders


def resolve_encoders(cfg, stub: bool = False, weights_dir: str | None = None,
                     device="cuda"):
    """The encoder suite of a training run: the stub (sized to `cfg`) when
    `stub`, else the real suite from `weights_dir`; raises when neither is
    given or the directory is missing."""
    if stub:
        return load_text_encoders(device=device, stub=True, model_cfg=cfg)
    if not weights_dir:
        raise RuntimeError(
            "real encoders requested but no weights directory given: pass "
            "--encoder_weights DIR, or opt into stub embeddings explicitly "
            "with --stub_encoders")
    if not os.path.isdir(weights_dir):
        raise RuntimeError(f"encoder weights dir not found: {weights_dir}")
    return load_text_encoders(device=device, weights_dir=weights_dir)


def encoded_batch_iter(cfg, tcfg, parquet_folder: str,
                       bucket_indices_path: str | None = None,
                       encoders=None, seed: int = 0,
                       stub: bool = False, weights_dir: str | None = None,
                       ring_workers: int = 0, loader=None,
                       bucket_seed: int | None = None,
                       num_threads: int = 2,
                       shard_index: int = 0,
                       shard_count: int = 1,
                       device="cuda") -> Iterator[dict]:
    """Yields trainer batches {x0, text, pooled}, fp32 tensors on the
    encoders' device with a leading accumulation-steps axis, encoding raw
    images and captions there.

    One optimizer step takes one shape across its micro-steps, so decoded
    batches wait in per-bucket queues and a group is emitted from whichever
    bucket fills first: no decoded batch is discarded (the reference's
    sampler draws a step's batches from one bucket, dataset_utils.py:
    119-161). The VAE's posterior sample draws from a torch.Generator on
    that device, seeded with `seed`.

    `ring_workers` > 0 decodes in that many processes through the
    shared-memory ring (`data/ringbuffer.py`), else `num_threads` threads
    (`HostDataLoader`); `loader` injects another. A loader made here is
    closed when the iterator is.
    """
    if encoders is None:
        encoders = resolve_encoders(cfg, stub=stub, weights_dir=weights_dir,
                                    device=device)
    dev = getattr(encoders, "device", None)
    dev = resolve_device(device) if dev is None else torch.device(dev)
    own = loader is None
    if own and ring_workers > 0:
        from sd3_torch.data.ringbuffer import RingDataLoader
        loader = RingDataLoader(parquet_folder, batch_size=tcfg.batch_size,
                                num_workers=ring_workers, seed=seed,
                                bucket_indices_path=bucket_indices_path,
                                bucket_seed=bucket_seed,
                                shard_index=shard_index,
                                shard_count=shard_count)
    elif own:
        loader = HostDataLoader(ParquetImageText(parquet_folder,
                                                 bucket_indices_path),
                                batch_size=tcfg.batch_size, seed=seed,
                                bucket_seed=bucket_seed,
                                num_threads=num_threads,
                                shard_index=shard_index,
                                shard_count=shard_count)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    acc = tcfg.accumulation_steps
    pending: dict[str, list] = collections.defaultdict(list)
    try:
        while True:
            try:
                batch = next(loader)
            except StopIteration:
                return  # a finite loader; partial groups are left
            lat = encoders.vae_encode(to_device(batch["image"], dev), gen)
            hid, pooled = encoders.text_to_embedding(batch["caption"])
            q = pending[batch["bucket"]]
            q.append(tuple(to_device(t, dev).float()
                           for t in (lat, hid, pooled)))
            if len(q) >= acc:
                group, pending[batch["bucket"]] = q[:acc], q[acc:]
                x0s, texts, pooleds = zip(*group)
                yield {"x0": torch.stack(x0s), "text": torch.stack(texts),
                       "pooled": torch.stack(pooleds)}
    finally:
        if own:
            loader.close()


def prefetch_iterator(it: Iterator, depth: int = 1,
                      map_fn=None) -> Iterator:
    """Run `it` `depth` items ahead on a background thread: while the
    trainer's step N runs, the thread decodes group N+1 and launches its
    encodes (the reference hides its preprocessing behind loader GPUs,
    VAE_T5_CLIP.py:399-478). `map_fn` (e.g. `Trainer.shard_batch`) runs on
    that thread too. Errors propagate to the consumer, after which the
    thread ends; StopIteration ends the stream; closing the consumer stops
    the thread."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def worker():
        try:
            for item in it:
                if not put(item if map_fn is None else map_fn(item)):
                    return
            put(done)
        except Exception as e:  # surfaced on the consumer side
            put(e)
        finally:
            close = getattr(it, "close", None)
            if close is not None:  # a generator: run its cleanup here
                close()

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        t.join(timeout=10.0)
