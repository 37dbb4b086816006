"""The parquet loaders alone, decoding only, on a folder of many files of
512px PNG rows: images/s, first-batch and open seconds and peak host memory
of `HostDataLoader` (threads) and `RingDataLoader` (worker processes), for
this checkout, or for the checkouts of the repository given with --tree
in that order (to compare a parent commit unpacked beside this one: parent,
this, this, parent), each run in a process of its own with the package
imported from its tree. No card is used.

    python3 -m sd3_torch.utils.loader_diag --work_dir DIR \
        [--tree CHECKOUT ...] [--out FILE.json]

The folder: --files files of --rows rows each, one --res x --res bucket,
two captions a row and create_phase's columns. The images are a pool of 64
smooth random PNGs (~0.4 MB each at 512px, compress level 1), each row's
made unique by 8 bytes after its IEND chunk (PIL stops at IEND), so that
parquet stores every value (no dictionary). It is written in two layouts
in turn, each removed once measured:
- "one_group": `pq.write_table`'s default, one row group a file (folders
  written by other tools);
- "bounded": `pipeline.write_parquet`, row groups of about
  ROW_GROUP_BYTES (the port's writers).
The folders are read warm (just written; the page cache is not dropped).
Memory: the process's peak resident set (VmHWM) and, at the end, its
anonymous and file-mapped parts (a memory-mapped reader's pages count as
file-mapped).
Each loader delivers --batches batches of 8 after its first, or fewer
where --max_s runs out (at least --min_batches); the first --min_batches
batches of every run must be the same bits in every tree and loader. A
run that fails (a reader that refuses the folder) is recorded with its
exit code and last error line.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# runs in a fresh process with the tree's package first on sys.path
_CHILD = r'''
import hashlib, json, resource, sys, time
cfg = json.loads(sys.argv[1])
t0 = time.time()
from sd3_torch.data.pipeline import HostDataLoader, ParquetImageText
from sd3_torch.data.ringbuffer import RingDataLoader
if cfg["loader"] == "threads":
    loader = HostDataLoader(ParquetImageText(cfg["folder"]), cfg["batch"],
                            seed=5, num_threads=cfg["workers"])
else:
    loader = RingDataLoader(cfg["folder"], cfg["batch"],
                            num_workers=cfg["workers"], seed=5,
                            slot_mb=cfg["slot_mb"], num_slots=4)
open_s = time.time() - t0
digest = hashlib.sha256()


def take(b):  # the first min_batches enter the digest; none is kept
    if n < cfg["min_batches"]:
        digest.update(b["image"].tobytes())
        digest.update("\n".join(b["caption"]).encode())


def status_gb(key):  # this process's resident memory (VmHWM: its peak)
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith(key + ":"):
                return int(line.split()[1]) * 1024 / 1e9


try:
    n = 0
    take(next(loader))
    t1 = time.time()
    while n < cfg["batches"] and (n + 1 < cfg["min_batches"]
                                  or time.time() - t1 < cfg["max_s"]):
        n += 1
        take(next(loader))
    t2 = time.time()
    rss = {k: status_gb(k) for k in ("VmHWM", "RssAnon", "RssFile")}
finally:
    loader.close()
kb = 1024 / 1e9
print(json.dumps(dict(
    open_s=open_s,  # from the process's first import
    first_batch_s=t1 - t0, batches=n, timed_s=t2 - t1,
    images_per_s=n * cfg["batch"] / (t2 - t1),
    peak_rss_gb=rss["VmHWM"], anon_gb=rss["RssAnon"],
    file_mapped_gb=rss["RssFile"],
    # the largest worker's peak (getrusage folds in its parent's RSS at
    # the fork: an upper bound)
    worker_peak_rss_gb=resource.getrusage(
        resource.RUSAGE_CHILDREN).ru_maxrss * kb,
    digest=digest.hexdigest())))
'''


def png_pool(res: int, n: int = 64, seed: int = 0) -> list[bytes]:
    """n smooth random res x res PNGs (bicubic from a 1/16-size draw)."""
    from PIL import Image
    r = np.random.default_rng(seed)
    pool = []
    for _ in range(n):
        small = (r.random((res // 16 + 2, res // 16 + 2, 3)) * 255).astype(
            np.uint8)
        im = Image.fromarray(small).resize((res, res),
                                           Image.Resampling.BICUBIC)
        buf = io.BytesIO()
        im.save(buf, format="PNG", compress_level=1)
        pool.append(buf.getvalue())
    return pool


def write_folder(folder: str, layout: str, files: int, rows: int, res: int,
                 pool: list[bytes]) -> dict:
    """The folder in `layout` ("one_group" or "bounded"); its sizes."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from sd3_torch.data.pipeline import write_parquet
    os.makedirs(folder)
    t0 = time.time()
    for f in range(files):
        ks = range(f * rows, (f + 1) * rows)
        table = pa.table({
            "image": pa.array([pool[k % len(pool)] + k.to_bytes(8, "little")
                               for k in ks], pa.binary()),
            "recaption": [f"The image shows a smooth pattern number {k}, "
                          f"seen from afar." for k in ks],
            "recaption_short": [f"pattern {k}" for k in ks],
            "height": pa.array([res] * rows, pa.int64()),
            "width": pa.array([res] * rows, pa.int64()),
            "aspect_ratio": pa.array([1.0] * rows, pa.float64()),
            "bucket_size": [f"{res}x{res}"] * rows})
        path = os.path.join(folder, f"part{f:03d}.parquet")
        if layout == "one_group":
            pq.write_table(table, path)
        else:
            write_parquet(table, path)
        del table
    meta = [pq.ParquetFile(os.path.join(folder, n)).metadata
            for n in sorted(os.listdir(folder))]
    return dict(write_s=time.time() - t0,
                bytes=sum(os.path.getsize(os.path.join(folder, n))
                          for n in os.listdir(folder)),
                row_groups=sum(m.num_row_groups for m in meta),
                rows_per_group=max(m.row_group(g).num_rows for m in meta
                                   for g in range(m.num_row_groups)))


def run(tree: str, folder: str, loader: str, args) -> dict:
    cfg = dict(folder=folder, loader=loader, batch=args.batch,
               workers=args.workers, batches=args.batches,
               min_batches=args.min_batches, max_s=args.max_s,
               slot_mb=1 - (-args.batch * 3 * args.res * args.res * 4
                            // 2**20))  # a batch in fp32 and its captions
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=tree)
    p = subprocess.run([sys.executable, "-c", _CHILD, json.dumps(cfg)],
                       cwd=tree, env=env, capture_output=True, text=True,
                       timeout=args.max_s * 4 + 600)
    if p.returncode:  # recorded: a reader may refuse a folder
        return dict(rc=p.returncode,
                    error=p.stderr.strip().splitlines()[-1][:300])
    return json.loads(p.stdout.strip().splitlines()[-1])


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--work_dir", required=True)
    ap.add_argument("--tree", action="append", default=[],
                    help="a checkout to measure, in order (default: this "
                         "one)")
    ap.add_argument("--files", type=int, default=6)
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--res", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--min_batches", type=int, default=5)
    ap.add_argument("--max_s", type=float, default=20.0)
    ap.add_argument("--layouts", default="one_group,bounded")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    sys.path.insert(0, HERE)
    trees = [os.path.abspath(t) for t in args.tree] or [HERE]
    pool = png_pool(args.res)
    out = dict(files=args.files, rows=args.rows, res=args.res,
               batch=args.batch, workers=args.workers,
               png_mb=float(np.mean([len(p) for p in pool]) / 1e6), runs=[])
    digests = set()
    for layout in args.layouts.split(","):
        folder = os.path.join(os.path.abspath(args.work_dir), layout)
        shutil.rmtree(folder, ignore_errors=True)
        out[layout] = write_folder(folder, layout, args.files, args.rows,
                                   args.res, pool)
        print(layout, json.dumps(out[layout]), flush=True)
        for tree in trees:
            for loader in ("threads", "ring"):
                r = dict(layout=layout, tree=tree, loader=loader,
                         **run(tree, folder, loader, args))
                if "digest" in r:
                    digests.add(r["digest"])
                out["runs"].append(r)
                print(json.dumps(r), flush=True)
        shutil.rmtree(folder, ignore_errors=True)
    out["same_stream"] = len(digests) == 1
    print(json.dumps(dict(same_stream=out["same_stream"])), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    if not out["same_stream"]:
        raise SystemExit("the loaders' streams differ between runs")
    return out


if __name__ == "__main__":
    main()
