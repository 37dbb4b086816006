"""ImageNet-21K winter21 tar -> parquet conversion.
(the port's copy of sd3_tpu/data/convert_imagenet.py)

Reference: the reference's data/convert_imagenet_parquet.py:15-65 — one
parquet per class tar with columns `image` (RGB PNG bytes), `class` (the
human-readable string for the synset, mapped from the filename prefix), and
`id` (the filename stem). The reference extracts each tar to disk, re-reads
every file, then deletes everything; here members stream straight out of the
tarfile in memory. Deleting the input tars is opt-in (--delete_tars) instead
of always-on.

Downstream, these parquets flow through the recaption -> filter ->
create_phase pipeline (data/filter_dataset.py, data/create_phase.py).

CLI:
    python -m sd3_torch.data.convert_imagenet --input_dir tars/ \
        --output_dir parquet/ --class_map imagenet21_class_to_string.json
"""

from __future__ import annotations

import argparse
import io
import json
import tarfile
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path

import pandas as pd

from sd3_torch.data.pipeline import write_parquet


def _png_bytes(data: bytes) -> bytes:
    from PIL import Image
    img = Image.open(io.BytesIO(data)).convert("RGB")
    buf = io.BytesIO()
    img.save(buf, format="PNG")
    return buf.getvalue()


def convert_tar(tar_path: str | Path, output_dir: str | Path,
                class_mapping: dict[str, str],
                delete_tar: bool = False) -> Path | None:
    """One class tar -> one parquet. Returns the parquet path (None if the
    tar yielded no usable rows). Bad members are skipped, not fatal
    (reference per-file try/except, convert_imagenet_parquet.py:32-42)."""
    tar_path = Path(tar_path)
    rows = []
    with tarfile.open(tar_path) as tar:
        for member in tar:
            if not member.isfile():
                continue
            stem = Path(member.name).stem
            synset = stem.split("_")[0]
            if synset not in class_mapping:
                print(f"{tar_path.name}: no class mapping for {stem}, skipped")
                continue
            try:
                data = tar.extractfile(member).read()
                rows.append({"image": _png_bytes(data),
                             "class": class_mapping[synset],
                             "id": stem})
            except Exception as e:  # corrupt member: skip
                print(f"{tar_path.name}: error on {member.name}: {e}")
    if not rows:
        print(f"{tar_path.name}: no convertible images")
        return None
    out = Path(output_dir) / f"{tar_path.stem}.parquet"
    write_parquet(pd.DataFrame(rows), out)
    if delete_tar:
        tar_path.unlink()
    return out


def convert_all(input_dir: str, output_dir: str, class_map_path: str,
                num_proc: int = 1, delete_tars: bool = False) -> list[Path]:
    out_dir = Path(output_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    with open(class_map_path) as f:
        class_mapping = json.load(f)
    tars = sorted(Path(input_dir).glob("*.tar"))
    if not tars:
        print("No .tar files found in the input directory.")
        return []
    if num_proc <= 1:
        results = [convert_tar(t, out_dir, class_mapping, delete_tars)
                   for t in tars]
    else:
        with ProcessPoolExecutor(max_workers=num_proc) as ex:
            futs = [ex.submit(convert_tar, t, out_dir, class_mapping,
                              delete_tars) for t in tars]
            results = [f.result() for f in futs]
    return [r for r in results if r is not None]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--class_map", required=True,
                   help="JSON {synset_id: class string}")
    p.add_argument("--num_proc", type=int, default=1)
    p.add_argument("--delete_tars", action="store_true")
    a = p.parse_args(argv)
    done = convert_all(a.input_dir, a.output_dir, a.class_map, a.num_proc,
                       a.delete_tars)
    print(f"Converted {len(done)} tars.")


if __name__ == "__main__":
    main()
