"""Resumable sharded dataset upload.
(the port's copy of sd3_tpu/data/upload_dataset.py)

Reference: the reference's data/upload_imagenet2021_and_CC12M.py and
upload_imagenet_2021_Recap.py — reshard a parquet folder and push shard
ranges to the HF hub, resuming after rate-limit/timeout kills. The reference
resumes by HAND-EDITING `num_shards_start` between runs and needs a vendored
6k-LoC patched `datasets` (data/__arrow_dataset.py, `start__` kwarg) to name
shards with the right offsets.

This rebuild keeps the capability and drops the patch-and-hand-edit workflow:

- shards are repacked deterministically to a target row count and named with
  the standard hub layout `train-{i:05d}-of-{n:05d}.parquet`, so a given
  folder always produces the same shard set;
- progress lives in `.upload_progress.json` next to the source parquets;
  a killed run resumes exactly where it stopped by re-running the command;
- each shard push is retried (the reference's bare try/except-retry), and the
  push backend is a pluggable callable `push(local_path, name_in_repo)` —
  `huggingface_hub` when available, anything else (gcs, s3, scp) otherwise.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from pathlib import Path
from typing import Callable, Sequence

import pandas as pd

from sd3_torch.data.pipeline import write_parquet

PROGRESS_FILE = ".upload_progress.json"


def plan_shards(parquet_folder: str, rows_per_shard: int) -> list[dict]:
    """Deterministic repack plan: [{name, parts: [(file, start, stop), ...]}].

    Only row COUNTS are read here (parquet metadata), so planning a huge
    folder is cheap and stable across runs as long as the folder is frozen.
    """
    import pyarrow.parquet as pq

    files = sorted(Path(parquet_folder).glob("*.parquet"))
    counts = [(str(f), pq.ParquetFile(f).metadata.num_rows) for f in files]
    total = sum(c for _, c in counts)
    if total == 0:
        return []
    n_shards = max(1, (total + rows_per_shard - 1) // rows_per_shard)

    plan = []
    fi = 0
    offset = 0  # rows of counts[fi] already consumed
    for si in range(n_shards):
        want = rows_per_shard if si < n_shards - 1 else total - si * rows_per_shard
        parts = []
        got = 0
        while got < want and fi < len(counts):
            path, n = counts[fi]
            take = min(want - got, n - offset)
            parts.append((path, offset, offset + take))
            got += take
            offset += take
            if offset == n:
                fi += 1
                offset = 0
        plan.append({"name": f"train-{si:05d}-of-{n_shards:05d}.parquet",
                     "parts": parts})
    return plan


_read_cache: dict = {}


def _read_source(path: str) -> pd.DataFrame:
    # Consecutive shards usually slice the same source file; cache the most
    # recent one so a large file spanning many shards is decoded once, not
    # once per shard (image-bytes columns make re-reads expensive).
    if path not in _read_cache:
        _read_cache.clear()
        _read_cache[path] = pd.read_parquet(path)
    return _read_cache[path]


def _materialize(shard: dict, out_path: str):
    dfs = [_read_source(path).iloc[start:stop]
           for path, start, stop in shard["parts"]]
    write_parquet(pd.concat(dfs, ignore_index=True), out_path)


def hf_push_fn(repo_id: str, token: str | None = None) -> Callable:
    """Default backend: huggingface_hub.upload_file."""
    from huggingface_hub import HfApi  # optional dependency
    api = HfApi(token=token)
    api.create_repo(repo_id, repo_type="dataset", exist_ok=True)

    def push(local_path: str, name_in_repo: str):
        api.upload_file(path_or_fileobj=local_path,
                        path_in_repo=f"data/{name_in_repo}",
                        repo_id=repo_id, repo_type="dataset")

    return push


def upload_folder(parquet_folder: str, push: Callable,
                  rows_per_shard: int = 5000,
                  work_dir: str | None = None,
                  max_retries: int = 5) -> list[str]:
    """Push all shards of `parquet_folder`, resuming from the progress file.

    Returns the names pushed (or skipped as already done) this call.
    """
    folder = Path(parquet_folder)
    progress_path = folder / PROGRESS_FILE
    done: dict = {}
    if progress_path.exists():
        done = json.loads(progress_path.read_text())
    plan = plan_shards(parquet_folder, rows_per_shard)
    work = Path(work_dir) if work_dir else folder / ".upload_work"
    work.mkdir(parents=True, exist_ok=True)

    out = []
    for shard in plan:
        name = shard["name"]
        if done.get(name) == "pushed":
            out.append(name)
            continue
        local = work / name
        _materialize(shard, str(local))
        last_err = None
        for attempt in range(max_retries + 1):
            try:
                push(str(local), name)
                last_err = None
                break
            except Exception as e:  # rate limits / timeouts: retry
                last_err = e
                if attempt < max_retries:
                    # exponential backoff — rate-limit errors need waiting
                    # out, not an immediate re-push
                    time.sleep(min(2.0 ** attempt * 2, 60))
        if last_err is not None:
            raise RuntimeError(f"shard {name} failed after retries: {last_err}")
        local.unlink()
        done[name] = "pushed"
        progress_path.write_text(json.dumps(done, indent=1))
        print(f"pushed {name}")
        out.append(name)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--parquet_folder", required=True)
    p.add_argument("--repo_id", required=True)
    p.add_argument("--rows_per_shard", type=int, default=5000)
    p.add_argument("--token_file", default=".env",
                   help="file holding the hub token (reference .env layout)")
    a = p.parse_args(argv)
    token = None
    if os.path.exists(a.token_file):
        token = open(a.token_file).read().strip()
    upload_folder(a.parquet_folder, hf_push_fn(a.repo_id, token),
                  a.rows_per_shard)


if __name__ == "__main__":
    main()
