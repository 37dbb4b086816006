"""Bucket-index CLI (the port's copy of sd3_tpu/data/create_indices.py;
reference src/create_indices.py, dataset_utils.load_indices): read a parquet
folder's bucket_size column (pyarrow; files in sorted order, rows in file
order, the JAX package's numbering) and save {bucket: [row indices]} as
.npy, which either package's loader reads.

    python -m sd3_torch.data.create_indices --data_parquet_folder PHASE \
        --bucket_indices_path idx.npy
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--data_parquet_folder", required=True)
    p.add_argument("--bucket_indices_path", required=True)
    args = p.parse_args(argv)

    import pyarrow.parquet as pq
    from sd3_torch.data.buckets import build_bucket_indices
    from sd3_torch.data.pipeline import parquet_files

    sizes = [s for f in parquet_files(args.data_parquet_folder)
             for s in pq.read_table(f, columns=["bucket_size"])
             .column("bucket_size").to_pylist()]
    buckets = build_bucket_indices(sizes, args.bucket_indices_path)
    print(f"saved {len(buckets)} buckets -> {args.bucket_indices_path}")
    for k, n in sorted(((k, len(v)) for k, v in buckets.items()),
                       key=lambda kv: -kv[1]):
        print(f"  {k}: {n}")
    return buckets


if __name__ == "__main__":
    main()
