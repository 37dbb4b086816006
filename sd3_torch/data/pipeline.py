"""The host side of the data feed (the port's copy of
sd3_tpu/data/pipeline.py; reference VAE_T5_CLIP.py).

The host decodes and collates; the frozen encoders run on the card between
steps (`data/encoded.py`). Kept semantics:
- a parquet folder with `image` bytes (binary, or a {bytes, path} struct),
  `recaption` / `recaption_short` captions and `bucket_size` strings
  (VAE_T5_CLIP.py:327, 347-351), memory-mapped with pyarrow and decoded a
  row group at a time (the port's writers bound a row group at
  ROW_GROUP_BYTES); rows are numbered as
  the JAX package's HF `datasets` numbers them (files in sorted order, rows
  in file order), so a bucket-index .npy serves either package;
- a 50/50 long/short caption pick, stripped; optional caption cleaning
  (`clean_caption`, REPEATED_OPENINGS; the reference defines it and leaves
  it out of its collate, so it is off by default here too);
- images decoded to float32 in [-1, 1], CHW;
- the bucket sampler, so every batch has one shape; `HostDataLoader`
  decodes on threads and emits in the sampler's order; the multi-process
  variant is `data/ringbuffer.py`.

`synthetic_batch_iter` gives random pre-encoded batches (the same shapes,
seed and draws as the JAX package's).
"""

from __future__ import annotations

import glob
import io
import os
import random
import threading
import warnings
from typing import Iterator

import numpy as np

from sd3_torch.data.buckets import RandomBucketSampler, build_bucket_indices

REPEATED_OPENINGS = [
    ("the image showcases ", ""), ("the image portrays ", ""),
    ("the image appears to be ", ""), ("the image is ", ""),
    ("the image depicts ", ""), ("the image features ", ""),
    ("the image captures ", ""), ("the image shows ", ""),
    ("the image displays ", ""), ("the image presents ", ""),
    ("this image showcases ", ""), ("this image portrays ", ""),
    ("this image appears to be ", ""), ("this image is ", ""),
    ("this image depicts ", ""), ("this image features ", ""),
    ("this image captures ", ""), ("this image shows ", ""),
    ("this image displays ", ""), ("this image presents ", ""),
    ("in this picture, ", ""), ("in this artwork, ", "artwork of "),
    ("in this illustration, ", "illustration of "),
    ("in this depiction, ", ""), ("in this piece, ", ""),
    ("in this image, ", ""), ("in this art piece, ", "art of "),
    ("in this scene, ", ""), ("in the picture, ", ""),
    ("in the artwork, ", "artwork of "),
    ("in the illustration, ", "illustration of "),
    ("in the depiction, ", ""), ("in the piece, ", ""),
    ("in the image, ", ""), ("in the art piece, ", "art of "),
    ("in the scene, ", ""),
]


def clean_caption(text: str, rng: random.Random | None = None) -> str:
    """reference VAE_T5_CLIP.clean_text (VAE_T5_CLIP.py:333-346); a caption
    it cannot clean (None, or empty once cleaned) gives "", after the same
    draws as the JAX package's."""
    rng = rng or random
    try:
        if rng.random() < 0.5:
            text = text.replace("A ", "").replace("An ", "")
        for a, b in REPEATED_OPENINGS:
            text = text.replace(a, b)
        if text[-1] in (".", ",", "!", "?") and rng.random() < 0.5:
            text = text[:-1].strip()
        return text
    except (AttributeError, IndexError, TypeError):
        return ""


def pick_caption(row: dict, rng: random.Random | None = None) -> str:
    """50/50 long/short caption (VAE_T5_CLIP.py:347-351)."""
    rng = rng or random
    key = "recaption" if rng.random() < 0.5 else "recaption_short"
    cap = row.get(key) or row.get("recaption") or row.get("recaption_short") or ""
    return cap.strip()


def image_bytes(value) -> bytes:
    """The encoded image of a row's `image` value: binary, or an HF-style
    {bytes, path} struct."""
    return value["bytes"] if isinstance(value, dict) else value


def decode_image(img_bytes: bytes) -> np.ndarray:
    """bytes -> float32 CHW in [-1, 1] (ToTensor then 2x-1)."""
    from PIL import Image
    with Image.open(io.BytesIO(img_bytes)) as im:
        im = im.convert("RGB")
        arr = np.asarray(im, dtype=np.float32) / 255.0
    return np.transpose(arr, (2, 0, 1)) * 2.0 - 1.0


def parquet_files(folder: str) -> list[str]:
    """The folder's *.parquet files in the order that numbers its rows."""
    files = sorted(glob.glob(os.path.join(folder, "*.parquet")))
    if not files:
        raise FileNotFoundError(f"no *.parquet files in {folder}")
    return files


ROW_GROUP_BYTES = 4 << 20  # a row group of the files the port writes
LARGE_ROW_GROUP = 16  # x ROW_GROUP_BYTES: the reader warns past it


def row_group_rows(table) -> int:
    """Rows a row group of `table` holds in the files the port's writers
    write: about ROW_GROUP_BYTES of its Arrow data, so that a random row
    costs `ParquetImageText` that much to decode (10 PNG rows at 512px,
    ~40 at 256px)."""
    return max(1, int(ROW_GROUP_BYTES * max(table.num_rows, 1)
                      // max(table.nbytes, 1)))


def write_parquet(data, path: str, preserve_index: bool | None = False):
    """pq.write_table of a pyarrow Table, or of a pandas DataFrame as its
    `to_parquet(index=preserve_index)` converts it, in row groups of
    `row_group_rows`."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    if not isinstance(data, pa.Table):
        data = pa.Table.from_pandas(data, preserve_index=preserve_index)
    pq.write_table(data, path, row_group_size=row_group_rows(data))


class ParquetImageText:
    """Random access to the rows of a parquet folder with image, caption and
    bucket_size columns, without loading the folder into host memory.

    Each file is opened memory-mapped (`pq.ParquetFile(memory_map=True)`);
    opening reads the files' metadata and their `bucket_size` column alone.
    A global row number maps to (file, row group, offset) through the row
    groups' cumulative row counts. Parquet's unit of random access is the
    row group: `rows` decodes each row group it needs whole, outside the
    lock (each thread reads through its own file handles), and keeps the
    most recent ones up to `cache_bytes` of Arrow data. A row therefore
    costs the decode of its row group: ~ROW_GROUP_BYTES in the files the
    port's writers write (`write_parquet`), the whole file in a file
    written as one row group, which random draws over many such files
    decode once a row. Host memory holds the cache and the groups being
    decoded, not the folder (the JAX package memory-maps the Arrow cache
    HF `datasets` writes; nothing here writes beside the dataset)."""

    cache_bytes = 256 << 20  # decoded row groups kept, the most recent

    def __init__(self, parquet_folder: str,
                 bucket_indices_path: str | None = None):
        import pyarrow.parquet as pq
        self.paths = parquet_files(parquet_folder)
        files = [pq.ParquetFile(f, memory_map=True) for f in self.paths]
        self._meta = [pf.metadata for pf in files]
        groups = [(fi, gi, m.row_group(gi).num_rows)
                  for fi, m in enumerate(self._meta)
                  for gi in range(m.num_row_groups)]
        self._groups = [(fi, gi) for fi, gi, _ in groups]
        self._starts = np.cumsum([0] + [n for _, _, n in groups])
        largest = max((m.row_group(gi).total_byte_size
                       for m in self._meta
                       for gi in range(m.num_row_groups)), default=0)
        if largest > LARGE_ROW_GROUP * ROW_GROUP_BYTES:
            warnings.warn(
                f"{parquet_folder}: row groups of up to {largest / 2**20:.0f}"
                f" MiB; each random row decodes its whole group. Rewrite "
                f"the folder through create_phase (row groups of "
                f"~{ROW_GROUP_BYTES >> 20} MiB).", stacklevel=2)
        self._cache: dict[int, object] = {}  # group -> table, oldest first
        self._lock = threading.Lock()
        self._local = threading.local()  # the thread's file handles
        self._local.files = files
        self.buckets = None
        if all("bucket_size" in pf.schema_arrow.names for pf in files):
            sizes = [s for pf in files for s in pf.read(
                columns=["bucket_size"]).column("bucket_size").to_pylist()]
            self.buckets = build_bucket_indices(sizes, bucket_indices_path)

    def __len__(self):
        return int(self._starts[-1])

    def _file(self, fi: int):
        files = getattr(self._local, "files", None)
        if files is None:
            import pyarrow.parquet as pq
            files = self._local.files = [
                pq.ParquetFile(p, memory_map=True, metadata=m)
                for p, m in zip(self.paths, self._meta)]
        return files[fi]

    def _group(self, g: int):
        with self._lock:
            table = self._cache.pop(g, None)
            if table is not None:
                self._cache[g] = table  # the most recent last
                return table
        fi, gi = self._groups[g]
        table = self._file(fi).read_row_group(gi)
        with self._lock:
            self._cache.pop(g, None)
            if table.nbytes <= self.cache_bytes:
                self._cache[g] = table
                held = sum(t.nbytes for t in self._cache.values())
                while held > self.cache_bytes:
                    held -= self._cache.pop(next(iter(self._cache))).nbytes
        return table

    def rows(self, indices: list[int]) -> list[dict]:
        idx = np.asarray(indices, dtype=np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= len(self)):
            raise IndexError(f"row index out of range 0..{len(self) - 1}")
        groups = np.searchsorted(self._starts, idx, side="right") - 1
        out: list[dict | None] = [None] * len(idx)
        for g in dict.fromkeys(groups.tolist()):
            table = self._group(g)
            for i in np.flatnonzero(groups == g).tolist():
                # a slice a row: `take` concatenates a column's chunks,
                # which overflows binary offsets past 2 GiB of images
                out[i] = table.slice(int(idx[i] - self._starts[g]),
                                     1).to_pylist()[0]
        return out


class HostDataLoader:
    """Threaded prefetch of one-shape (image, caption) batches.

    Yields dicts {"image": (B, 3, H, W) f32 in [-1, 1], "caption":
    list[str], "bucket": "HxW", "seq": the sampler's sequence number}.
    Threads (PIL decode releases the GIL); the shared-memory ring
    (data/ringbuffer.py) is the multi-process variant.

    In-order emission: every sampler draw is tagged with a sequence number
    under the lock, threads decode out of order, and __next__ releases
    batches strictly by sequence, so the stream is the same for any
    `num_threads`. `stride` / `stride_offset`: decode only the draws whose
    sequence number is `stride_offset` modulo `stride`, keeping the global
    numbering (draw order, caption RNG keys): `stride` ring workers with
    offsets 0 .. stride-1 together give exactly the one-loader stream.
    Backpressure: at most `prefetch` undelivered batches. An error in a
    thread is raised by __next__.
    """

    def __init__(self, dataset: ParquetImageText, batch_size: int,
                 seed: int = 0, prefetch: int = 4, num_threads: int = 2,
                 clean_captions: bool = False, first_n_largest: int = 1,
                 bucket_seed: int | None = None,
                 shard_index: int = 0, shard_count: int = 1,
                 stride: int = 1, stride_offset: int = 0):
        if not 0 <= stride_offset < stride:
            raise ValueError(f"stride offset {stride_offset} of {stride}")
        if dataset.buckets is None:
            raise ValueError("dataset has no bucket_size column")
        self.ds = dataset
        self.sampler = RandomBucketSampler(dataset.buckets, batch_size,
                                           seed=seed,
                                           first_n_largest=first_n_largest,
                                           bucket_seed=bucket_seed,
                                           shard_index=shard_index,
                                           shard_count=shard_count)
        self.clean = clean_captions
        self._seed = seed
        self._stop = threading.Event()
        self._prefetch = max(prefetch, num_threads)
        self._cond = threading.Condition()
        self._ready: dict[int, dict] = {}
        self._stride = stride
        self._draw_seq = 0       # next global sequence number (all strides)
        self._emit_seq = stride_offset  # next seq __next__ returns
        self._owned_pending = 0  # own draws not yet emitted (backpressure)
        self._exhausted = False  # the sampler raised StopIteration
        self._error: BaseException | None = None
        self._it = iter(self.sampler)
        self._threads = [threading.Thread(target=self._worker, daemon=True)
                         for _ in range(num_threads)]
        for t in self._threads:
            t.start()

    def _decode(self, bucket, idxs, seq):
        rows = self.ds.rows(idxs)
        imgs = np.stack([decode_image(image_bytes(r["image"])) for r in rows])
        # the caption draws keyed on the sequence number: the same for any
        # thread count or schedule
        rng = random.Random(f"{self._seed}/{seq}")
        caps = []
        for r in rows:
            cap = pick_caption(r, rng)
            if self.clean:
                cap = clean_caption(cap, rng)
            caps.append(cap)
        return {"image": imgs, "caption": caps, "bucket": bucket, "seq": seq}

    def _worker(self):
        while not self._stop.is_set():
            with self._cond:
                while (self._owned_pending >= self._prefetch
                       and not self._stop.is_set()):
                    self._cond.wait(timeout=0.1)
                if self._stop.is_set():
                    return
                try:
                    bucket, idxs = next(self._it)
                except StopIteration:
                    self._exhausted = True
                    self._cond.notify_all()
                    return
                seq = self._draw_seq
                self._draw_seq += 1
                if seq % self._stride != self._emit_seq % self._stride:
                    continue  # another stride worker's draw
                self._owned_pending += 1
            try:
                batch = self._decode(bucket, idxs, seq)
            except Exception as e:  # raised in __next__, not a hang
                with self._cond:
                    self._error = e
                    self._cond.notify_all()
                return
            with self._cond:
                self._ready[seq] = batch
                self._cond.notify_all()

    def __iter__(self):
        return self

    def __next__(self):
        with self._cond:
            while True:
                if self._error is not None:
                    raise self._error
                if self._emit_seq in self._ready:
                    batch = self._ready.pop(self._emit_seq)
                    self._emit_seq += self._stride
                    self._owned_pending -= 1
                    self._cond.notify_all()
                    return batch
                if self._exhausted and self._emit_seq >= self._draw_seq:
                    raise StopIteration
                self._cond.wait(timeout=0.1)

    def close(self, timeout: float = 10.0):
        """Stop the threads and wait for them (each finishes the batch it
        is decoding)."""
        self._stop.set()
        with self._cond:
            self._ready.clear()
            self._cond.notify_all()
        for t in self._threads:
            t.join(timeout)


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
