"""Bucket-resize "phase" CLI (the port's copy of
sd3_tpu/data/create_phase.py; reference data/create_phase.py), with pyarrow
and PIL alone.

For each image of a parquet folder: resize so that the larger side is at
most max_resolution and BOTH sides are the nearest multiple of patch_size
(16), LANCZOS, stored as PNG; write height / width / aspect_ratio and the
"HxW" bucket_size column; drop undecodable rows; skip files already written
(resumable). The reference swaps PIL's (width, height) names throughout;
here they are PIL's, as in the JAX package.

    python -m sd3_torch.data.create_phase --input_dir FILTERED \
        --output_dir PHASE [--max_resolution 1024] [--patch_size 16] \
        [--num_workers N]
"""

from __future__ import annotations

import argparse
import io
import os

from sd3_torch.data.filter_dataset import set_column
from sd3_torch.data.pipeline import image_bytes, write_parquet


def nearest_multiple(x: int, m: int) -> int:
    """Round to the nearest multiple of m (at least m)."""
    r = x % m
    out = x + (m - r) if (m - r) < r else x - r
    return max(out, m)


def phase_size(width: int, height: int, max_resolution: int,
               patch_size: int = 16) -> tuple[int, int]:
    """Target (width, height) by the reference's resize rule
    (create_phase.py:114-135)."""
    if width > max_resolution or height > max_resolution:
        if width > height:
            new_w = max_resolution
            new_h = nearest_multiple(int(height * (max_resolution / width)),
                                     patch_size)
        else:
            new_h = max_resolution
            new_w = nearest_multiple(int(width * (max_resolution / height)),
                                     patch_size)
    else:
        new_w = nearest_multiple(width, patch_size)
        new_h = nearest_multiple(height, patch_size)
    return new_w, new_h


def process_file(in_path: str, out_path: str, max_resolution: int,
                 patch_size: int = 16) -> int:
    """Resize one parquet file's images into `out_path` (not written when
    no row is left); returns the rows written."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image

    table = pq.read_table(in_path)
    heights, widths, aspects, buckets, images, keep = [], [], [], [], [], []
    for row in table.to_pylist():
        try:
            with Image.open(io.BytesIO(image_bytes(row["image"]))) as im:
                im = im.convert("RGB")
                w, h = im.size
                nw, nh = phase_size(w, h, max_resolution, patch_size)
                im = im.resize((nw, nh), resample=Image.Resampling.LANCZOS)
                buf = io.BytesIO()
                im.save(buf, format="PNG")
        except (OSError, SyntaxError, ValueError, TypeError,
                Image.DecompressionBombError) as e:  # undecodable image
            print(f"  drop row: {e}")
            keep.append(False)
            continue
        heights.append(nh)
        widths.append(nw)
        aspects.append(nw / nh)
        buckets.append(f"{nh}x{nw}")
        images.append(buf.getvalue())
        keep.append(True)
    table = table.filter(pa.array(keep, pa.bool_()))
    table = set_column(table, "image", pa.array(images, pa.binary()))
    table = set_column(table, "height", pa.array(heights, pa.int64()))
    table = set_column(table, "width", pa.array(widths, pa.int64()))
    table = set_column(table, "aspect_ratio", pa.array(aspects, pa.float64()))
    table = set_column(table, "bucket_size", pa.array(buckets, pa.string()))
    if table.num_rows:
        write_parquet(table, out_path)
    return table.num_rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--max_resolution", type=int, default=1024)
    p.add_argument("--patch_size", type=int, default=16)
    p.add_argument("--num_workers", type=int, default=1)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    files = sorted(f for f in os.listdir(args.input_dir)
                   if f.endswith(".parquet"))
    todo = [(os.path.join(args.input_dir, f), os.path.join(args.output_dir, f))
            for f in files
            if not os.path.exists(os.path.join(args.output_dir, f))]
    print(f"{len(todo)}/{len(files)} files to process")

    if args.num_workers > 1:
        import concurrent.futures
        import multiprocessing
        with concurrent.futures.ProcessPoolExecutor(
                args.num_workers,
                mp_context=multiprocessing.get_context("spawn")) as ex:
            futs = {ex.submit(process_file, i, o, args.max_resolution,
                              args.patch_size): i for i, o in todo}
            for fut in concurrent.futures.as_completed(futs):
                print(f"{futs[fut]}: {fut.result()} rows")
    else:
        for i, o in todo:
            n = process_file(i, o, args.max_resolution, args.patch_size)
            print(f"{i}: {n} rows")


if __name__ == "__main__":
    main()
