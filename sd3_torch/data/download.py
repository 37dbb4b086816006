"""Dataset acquisition: resumable fetches + URL-list -> parquet image shards.
(the port's copy of sd3_tpu/data/download.py)

Reference parity (the last data-engineering component; everything downstream
— convert/filter/phase/index/upload — already exists in this package):
  - data/download_cc12m.sh            wget tsv + img2dataset url-list crawl,
                                      then git-clone of two HF caption sets
  - data/download_imagenet_2021.sh    wget winter21_whole.tar.gz + extract
  - data/download.py, download.sh     datasets.load_dataset snapshot
  - data/laion/download.py            threaded url crawl with checkpoint.txt
                                      + failed.txt, 1000 rows per output file
  - data/laion/extract_and_shard.py   re-shard into parquet

Design differences (a resumable data plane, not a translation):
  - One CLI, four subcommands (`fetch`, `urls`, `hf`, `imagenet21k`) instead
    of nine SLURM wrappers; every step is RESUMABLE (byte-range resume for
    single files, per-shard done-markers for crawls) because data staging
    on shared machines gets preempted.
  - The url crawl writes PARQUET shards with the exact columns the rest of
    this package consumes (create_phase.py/filter_dataset.py), skipping the
    reference's webdataset-tar -> extract -> parquet double hop.
  - urllib only (no img2dataset/requests dependency); `file://` URLs work,
    which is also how the hermetic tests exercise every path without network.
    In the zero-egress build environment, real runs fail fast with a clear
    error instead of hanging.

Network use is confined to `_open_url`; everything else is pure local IO.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import os
import sys
import threading
import time
import urllib.error
import urllib.request
from concurrent.futures import ThreadPoolExecutor

from sd3_torch.data.pipeline import write_parquet

# Columns of a crawled image shard — matches what create_phase.py /
# filter_dataset.py expect from the converted-imagenet path.
SHARD_COLUMNS = ("image", "caption", "url", "height", "width")
USER_AGENT = "sd3-torch-data/1.0"

# HTTP statuses the reference treats as permanent (laion/download.py:37):
# don't retry, record in failed log.
PERMANENT_HTTP = {400, 401, 402, 403, 404, 410, 451}


def _log(msg: str) -> None:
    """Progress goes to stderr; stdout carries only the JSON summary (repo
    convention — same split bench.py uses)."""
    print(msg, file=sys.stderr)


def _open_url(url: str, start: int = 0, timeout: float = 30.0):
    """Open a (possibly ranged) URL. file:// is supported for tests/local."""
    req = urllib.request.Request(url, headers={"User-Agent": USER_AGENT})
    if start > 0:
        req.add_header("Range", f"bytes={start}-")
    return urllib.request.urlopen(req, timeout=timeout)


def fetch(url: str, dest: str, sha256: str | None = None, retries: int = 5,
          timeout: float = 30.0, chunk: int = 1 << 20,
          log=_log) -> str:
    """Resumable single-file download (≙ the reference's bare `wget`).

    Appends from the current size of `<dest>.part` via an HTTP Range request,
    renames to `dest` when complete, optionally verifies sha256. Returns dest.
    """
    if os.path.exists(dest):
        log(f"fetch: {dest} already complete")
        return dest
    os.makedirs(os.path.dirname(os.path.abspath(dest)), exist_ok=True)
    part = dest + ".part"
    for attempt in range(retries):
        start = os.path.getsize(part) if os.path.exists(part) else 0
        try:
            with _open_url(url, start=start, timeout=timeout) as r:
                ranged = start > 0 and r.headers.get("Content-Range")
                mode = "ab" if ranged else "wb"
                if start > 0 and not ranged:
                    log("fetch: server ignored Range; restarting from 0")
                with open(part, mode) as f:
                    while True:
                        buf = r.read(chunk)
                        if not buf:
                            break
                        f.write(buf)
            break
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            if attempt == retries - 1:
                raise
            wait = min(2.0 ** attempt * 2, 60)
            log(f"fetch: {e!r}; retry {attempt + 1}/{retries} in {wait:.0f}s")
            time.sleep(wait)
    if sha256 is not None:
        h = hashlib.sha256()
        with open(part, "rb") as f:
            for buf in iter(lambda: f.read(chunk), b""):
                h.update(buf)
        if h.hexdigest() != sha256:
            raise ValueError(
                f"fetch: sha256 mismatch for {dest}: {h.hexdigest()}")
    os.replace(part, dest)
    return dest


def _get_image(url: str, retries: int, timeout: float):
    """One image crawl: bytes + decoded dims, or an error string.

    Permanent HTTP errors (reference laion/download.py:37) fail immediately;
    transient ones retry with backoff. Undecodable payloads are failures —
    the parquet shards must only hold images PIL can open downstream.
    """
    from PIL import Image
    err = "unknown"
    for attempt in range(retries):
        try:
            with _open_url(url, timeout=timeout) as r:
                data = r.read()
            im = Image.open(io.BytesIO(data))
            w, h = im.size
            return data, h, w, None
        except urllib.error.HTTPError as e:
            err = f"http {e.code}"
            if e.code in PERMANENT_HTTP:
                return None, 0, 0, err
        except (urllib.error.URLError, OSError, TimeoutError,
                ValueError) as e:
            err = repr(e)
        time.sleep(min(0.1 * 2 ** attempt, 5))
    return None, 0, 0, err


def _read_url_table(path: str, url_col: str, caption_col: str):
    """(urls, captions) from a .tsv/.csv/.parquet url list (cc12m.tsv style:
    tab-separated url<TAB>caption, header added like download_cc12m.sh)."""
    import pandas as pd
    if path.endswith(".parquet"):
        df = pd.read_parquet(path, columns=[url_col, caption_col])
    else:
        df = pd.read_csv(path, sep="\t" if path.endswith(".tsv") else ",")
    return (df[url_col].astype(str).tolist(),
            df[caption_col].fillna("").astype(str).tolist())


def crawl_urls(url_list: str, out_dir: str, url_col: str = "url",
               caption_col: str = "caption", shard_rows: int = 1000,
               threads: int = 16, retries: int = 5, timeout: float = 30.0,
               log=_log) -> dict:
    """URL-list crawl -> parquet image shards (≙ img2dataset + laion crawl).

    Resumable at shard granularity: `shard_{i:06d}.parquet` is written to a
    tmp name and renamed only when complete, so a restart skips finished
    shards exactly (the reference's checkpoint.txt, made crash-atomic).
    Failures land in failed.jsonl (url, shard, error) and are NOT retried on
    resume — matching the reference's failed.txt semantics.
    Returns {"ok": n_images, "failed": n_failed, "shards": n_shards}.
    """
    import pandas as pd
    os.makedirs(out_dir, exist_ok=True)
    urls, captions = _read_url_table(url_list, url_col, caption_col)
    n_shards = (len(urls) + shard_rows - 1) // shard_rows
    failed_path = os.path.join(out_dir, "failed.jsonl")
    flock = threading.Lock()
    totals = {"ok": 0, "failed": 0, "shards": n_shards}

    def record_failure(url, shard, err):
        with flock:
            totals["failed"] += 1
            with open(failed_path, "a") as f:
                f.write(json.dumps(
                    {"url": url, "shard": shard, "error": err}) + "\n")

    def do_shard(si: int):
        dest = os.path.join(out_dir, f"shard_{si:06d}.parquet")
        if os.path.exists(dest):   # finished on a previous run
            return
        lo, hi = si * shard_rows, min((si + 1) * shard_rows, len(urls))
        rows = []
        with ThreadPoolExecutor(max_workers=threads) as pool:
            results = pool.map(
                lambda u: _get_image(u, retries, timeout), urls[lo:hi])
            for j, (data, h, w, err) in enumerate(results):
                if data is None:
                    record_failure(urls[lo + j], si, err)
                    continue
                rows.append({"image": data, "caption": captions[lo + j],
                             "url": urls[lo + j], "height": h, "width": w})
        totals["ok"] += len(rows)
        df = pd.DataFrame(rows, columns=list(SHARD_COLUMNS))
        tmp = dest + ".tmp"
        write_parquet(df, tmp)
        os.replace(tmp, dest)
        log(f"crawl: shard {si + 1}/{n_shards}: {len(rows)} ok, "
            f"{hi - lo - len(rows)} failed")

    for si in range(n_shards):
        do_shard(si)
    return totals


def hf_snapshot(repo_id: str, dest: str, repo_type: str = "dataset",
                allow_patterns=None, log=_log) -> str:
    """Snapshot an HF hub repo (≙ download.py's load_dataset / the
    git-clones in download_cc12m.sh) via huggingface_hub; resumable by the
    hub client itself. Zero-egress environments fail fast with the command
    to run elsewhere."""
    try:
        from huggingface_hub import snapshot_download
    except ImportError as e:
        raise RuntimeError(
            "huggingface_hub is not installed; run instead: "
            f"git clone https://huggingface.co/{repo_type}s/{repo_id} {dest}"
        ) from e
    log(f"hf: snapshotting {repo_id} -> {dest}")
    return snapshot_download(repo_id=repo_id, repo_type=repo_type,
                             local_dir=dest, allow_patterns=allow_patterns)


IMAGENET21K_URL = "https://www.image-net.org/data/winter21_whole.tar.gz"
CC12M_TSV_URL = "https://storage.googleapis.com/conceptual_12m/cc12m.tsv"
CC12M_RECAP_REPOS = (     # download_cc12m.sh:31-37
    "lmms-lab/LLaVA-ReCap-CC12M",
    "CaptionEmporium/conceptual-captions-cc12m-llavanext",
)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    sub = p.add_subparsers(dest="cmd", required=True)

    f = sub.add_parser("fetch", help="resumable single-file download")
    f.add_argument("url")
    f.add_argument("dest")
    f.add_argument("--sha256", default=None)
    f.add_argument("--retries", type=int, default=5)

    u = sub.add_parser("urls", help="url list -> parquet image shards")
    u.add_argument("url_list", help=".tsv/.csv/.parquet with url+caption")
    u.add_argument("out_dir")
    u.add_argument("--url_col", default="url")
    u.add_argument("--caption_col", default="caption")
    u.add_argument("--shard_rows", type=int, default=1000)
    u.add_argument("--threads", type=int, default=16)
    u.add_argument("--retries", type=int, default=5)
    u.add_argument("--timeout", type=float, default=30.0)

    h = sub.add_parser("hf", help="snapshot a HF hub dataset repo")
    h.add_argument("repo_id")
    h.add_argument("dest")
    h.add_argument("--repo_type", default="dataset")

    i = sub.add_parser("imagenet21k",
                       help="winter21_whole.tar.gz -> ready for "
                            "data/convert_imagenet.py")
    i.add_argument("out_dir")
    i.add_argument("--url", default=IMAGENET21K_URL)

    a = p.parse_args(argv)
    if a.cmd == "fetch":
        fetch(a.url, a.dest, sha256=a.sha256, retries=a.retries)
    elif a.cmd == "urls":
        totals = crawl_urls(a.url_list, a.out_dir, url_col=a.url_col,
                            caption_col=a.caption_col,
                            shard_rows=a.shard_rows, threads=a.threads,
                            retries=a.retries, timeout=a.timeout)
        print(json.dumps(totals))
    elif a.cmd == "hf":
        hf_snapshot(a.repo_id, a.dest, repo_type=a.repo_type)
    elif a.cmd == "imagenet21k":
        tar = fetch(a.url, os.path.join(a.out_dir, "winter21_whole.tar.gz"))
        print(f"downloaded {tar}; next: extract its class tars, then "
              "python -m sd3_torch.data.convert_imagenet --input_dir TARS "
              f"--output_dir {a.out_dir}/parquet --class_map MAP.json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
