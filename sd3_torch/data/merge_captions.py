"""Join LLaVA recaption jsonl onto CC12M image parquets.
(the port's copy of sd3_tpu/data/merge_captions.py)

Port of the reference's caption-merge step (data/merge_cc12m.py:36-84):
for each image parquet, look up the row's `id` in the recaption jsonl
(`key` -> caption_llava / caption_llava_short) and emit
`recaption`, `recaption_short`, and `class` columns, flattening the
`image` struct to raw bytes.

Semantics kept from the reference:
- long-caption miss falls back to the row's original conversation caption
  (`conversations[1]["value"]`) and is logged to the error file;
- short-caption miss falls back to the (already merged) long recaption;
- `class` is a constant dataset tag ("CC12M").

Documented deviation: the reference accidentally swaps its two lookup
dicts (merge_cc12m.py:28-29 builds `caption_dict_short` from caption_llava
and `caption_dict` from caption_llava_short), so its `recaption` column
holds the SHORT caption. Downstream sampling picks 50/50 between the two
columns (VAE_T5_CLIP.py:347-351) so training is unaffected; this port maps
long->recaption, short->recaption_short as the column names intend.
"""

from __future__ import annotations

import argparse
import os

import pandas as pd

from sd3_torch.data.pipeline import write_parquet


def load_caption_maps(captions_jsonl: str) -> tuple[dict, dict]:
    """jsonl with key/caption_llava/caption_llava_short -> (long, short) maps."""
    df = pd.read_json(captions_jsonl, lines=True, dtype={"key": str})
    long_map = df.set_index("key")["caption_llava"].to_dict()
    short_map = df.set_index("key")["caption_llava_short"].to_dict()
    return long_map, short_map


def merge_captions_df(df: pd.DataFrame, long_map: dict, short_map: dict,
                      class_name: str = "CC12M",
                      errors: list | None = None) -> pd.DataFrame:
    """Merge recaptions into one image parquet dataframe.

    Expects columns id/image/conversations; returns
    id/image/recaption/recaption_short/class.
    """
    out = df[["id", "image"]].copy()
    recap, recap_short = [], []
    def missing(v):
        # jsonl rows with absent/null caption fields surface as None or
        # float NaN after pandas — both mean "no caption"
        return v is None or not isinstance(v, str)

    for _, row in df.iterrows():
        rid = str(row["id"])
        cap = long_map.get(rid)
        if missing(cap):
            try:
                cap = row["conversations"][1]["value"]
            except Exception:
                cap = ""
            if errors is not None:
                errors.append(rid)
        cap = (cap or "").strip()
        short = short_map.get(rid)
        if missing(short):
            short = cap
        recap.append(cap)
        recap_short.append((short or cap).strip())
    out["recaption"] = recap
    out["recaption_short"] = recap_short
    out["class"] = class_name
    out["image"] = out["image"].map(
        lambda v: v["bytes"] if isinstance(v, dict) else v)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--captions_jsonl", required=True)
    p.add_argument("--parquet_in_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--class_name", default="CC12M")
    p.add_argument("--errors_file", default=None)
    p.add_argument("--delete_while_merging", action="store_true",
                   help="remove each source parquet after merging (the "
                        "reference's resumability mechanism)")
    args = p.parse_args(argv)

    os.makedirs(args.out_dir, exist_ok=True)
    long_map, short_map = load_caption_maps(args.captions_jsonl)
    files = sorted(f for f in os.listdir(args.parquet_in_dir)
                   if f.endswith(".parquet"))
    all_errors: list[str] = []
    for fn in files:
        src = os.path.join(args.parquet_in_dir, fn)
        df = pd.read_parquet(src)
        errs: list[str] = []
        merged = merge_captions_df(df, long_map, short_map,
                                   class_name=args.class_name, errors=errs)
        write_parquet(merged, os.path.join(args.out_dir, fn),
                      preserve_index=None)
        all_errors.extend(f"{fn}:{rid}" for rid in errs)
        if args.delete_while_merging:
            os.remove(src)
        print(f"merged {fn}: {len(merged)} rows, {len(errs)} caption misses")
    if args.errors_file and all_errors:
        with open(args.errors_file, "a") as f:
            f.write("\n".join(all_errors) + "\n")


if __name__ == "__main__":
    main()
