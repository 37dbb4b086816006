"""Quality-filter CLI (the port's copy of sd3_tpu/data/filter_dataset.py;
reference data/filter_lowres_parquets.py), with pyarrow and PIL alone: for
each image compute height, width and aspect ratio, drop the rows whose
sides are BOTH below min_resolution, whose image does not decode, or whose
caption is shorter than min_caption_chars; resumable per file (an output
file that exists is skipped).

    python -m sd3_torch.data.filter_dataset --input_dir RAW --output_dir OUT \
        [--min_resolution 256] [--min_caption_chars 8]
"""

from __future__ import annotations

import argparse
import io
import os

from sd3_torch.data.pipeline import image_bytes, write_parquet


def set_column(table, name: str, values):
    """`table` with column `name` replaced in place, or appended."""
    import pyarrow as pa
    arr = values if isinstance(values, (pa.Array, pa.ChunkedArray)) \
        else pa.array(values)
    if name in table.column_names:
        return table.set_column(table.column_names.index(name), name, arr)
    return table.append_column(name, arr)


def process_file(in_path: str, out_path: str, min_resolution: int,
                 min_caption_chars: int) -> int:
    """Filter one parquet file into `out_path` (not written when no row is
    kept); returns the rows kept."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image

    table = pq.read_table(in_path)
    keep, heights, widths = [], [], []
    for row in table.to_pylist():
        try:
            with Image.open(io.BytesIO(image_bytes(row["image"]))) as im:
                w, h = im.size
        except (OSError, SyntaxError, ValueError, TypeError,
                Image.DecompressionBombError):
            keep.append(False)
            heights.append(0)
            widths.append(0)
            continue
        cap = row.get("recaption") or row.get("recaption_short") or ""
        keep.append((w >= min_resolution or h >= min_resolution)
                    and len(str(cap).strip()) >= min_caption_chars)
        heights.append(h)
        widths.append(w)
    table = set_column(table, "height", pa.array(heights, pa.int64()))
    table = set_column(table, "width", pa.array(widths, pa.int64()))
    table = set_column(table, "aspect_ratio", pa.array(
        [w / h if h else 0.0 for w, h in zip(widths, heights)], pa.float64()))
    table = table.filter(pa.array(keep, pa.bool_()))
    if table.num_rows:
        write_parquet(table, out_path)
    return table.num_rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--min_resolution", type=int, default=256)
    p.add_argument("--min_caption_chars", type=int, default=8)
    args = p.parse_args(argv)

    os.makedirs(args.output_dir, exist_ok=True)
    for f in sorted(os.listdir(args.input_dir)):
        if not f.endswith(".parquet"):
            continue
        out = os.path.join(args.output_dir, f)
        if os.path.exists(out):
            continue
        n = process_file(os.path.join(args.input_dir, f), out,
                         args.min_resolution, args.min_caption_chars)
        print(f"{f}: kept {n} rows")


if __name__ == "__main__":
    main()
