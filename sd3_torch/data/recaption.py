"""Recaptioning pipeline: VLM long caption + LLM 40-word distillation.
(the port's copy of sd3_tpu/data/recaption.py)

Reference: the reference's data/recaption_parquets.py — per-GPU workers run
LLaVA-Next-8b over each image (with the original caption/class as an alt-text
hint), post-process the output, reject failures, distill a short caption with
Llama-3-8B-Instruct, and write `recaption`/`recaption_short` columns; work is
pre-split across workers via a pickled manifest and resumable because each
parquet is independent.

This rebuild separates the ORCHESTRATION (batching, failure heuristics,
splitting, resume — all testable hermetically) from the MODELS, which are
pluggable callables:

    captioner(images: list[PIL.Image], hints: list[str]) -> list[str]
    distiller(captions: list[str]) -> list[str]

so any backend works: HF transformers on the card, another port, or an API.
The canonical prompts the reference uses are exported as
`LONG_CAPTION_PROMPT` / `DISTILL_PROMPT` for backends to reuse. A worker is
pinned to its share of parquets with --num_splits/--split_idx (the JSON
manifest replacing the reference's parquets_split.pkl).
"""

from __future__ import annotations

import argparse
import io
import json
import os
from pathlib import Path
from typing import Callable, Sequence

import pandas as pd

from sd3_torch.data.pipeline import REPEATED_OPENINGS, write_parquet

# Reference prompt templates (recaption_parquets.py:82-103).
LONG_CAPTION_PROMPT = (
    "Please make a detailed but succinct caption of this image. If you see "
    "text or objects, be sure to describe them in detail along with any "
    "other aspects of the foreground and background. If there is any "
    "important text in the image, include it in the caption. As a hint, "
    "here is the alt-text attribute of the image, which may or may not have "
    "to do with the image:\n\nHint:\n```\n{hint}\n```"
)
DISTILL_PROMPT = (
    "Please take the following image caption and attempt to distill it into "
    "a single sentence. Remove any redundant lines or descriptions and make "
    "it a maximum of 40 words in length.\n\n```\n{caption}\n```\n\n"
    "Please only write the caption and no other text."
)

# Phrases whose heavy repetition marks a failed VLM caption
# (recaption_parquets.py:144 `to_reformats`).
FAILURE_PHRASES = (" no text", " other objects", " additional objects",
                   " no objects ", "alt-text")

# data/pipeline.py keeps the table lowercased for training-time cleanup; the
# raw VLM output is sentence-cased (recaption_parquets.py:105-141).
VLM_OPENINGS = [(a.capitalize(), b.capitalize() if b else b)
                for a, b in REPEATED_OPENINGS]


def postprocess_caption(caption: str) -> str:
    """Strip boilerplate VLM openings (recaption_parquets.py:105-141).

    Reference-parity quirks kept deliberately: `.capitalize()` after a
    replacement lowercases the REST of the caption (proper nouns included),
    and openings match anywhere in the string, not just at the start —
    exactly what the reference's postprocess_caption does, and what its
    published datasets were built with.
    """
    for opening, replacement in VLM_OPENINGS:
        if opening in caption:
            caption = caption.replace(opening, replacement, 1).capitalize()
    return caption.strip()


def caption_failed(caption: str) -> bool:
    """Reference failure heuristics (recaption_parquets.py:229-238):
    >5 occurrences of known degenerate phrases, or <3 unique words."""
    repeats = sum(caption.count(p) for p in FAILURE_PHRASES)
    if repeats > 5:
        return True
    return len(set(caption.split())) < 3


def recaption_dataframe(df: pd.DataFrame,
                        captioner: Callable[[list, list], list],
                        distiller: Callable[[list], list],
                        batch_size: int = 64, img_col: str = "image",
                        hint_col: str = "class",
                        min_rows: int = 10) -> pd.DataFrame:
    """Add recaption/recaption_short columns; drop failed rows.

    Raises if fewer than `min_rows` rows survive (the reference aborts a
    parquet whose captioning collapsed, recaption_parquets.py:317-318).
    """
    from PIL import Image

    long_caps: list[str | None] = []
    short_caps: list[str | None] = []
    for i in range(0, len(df), batch_size):
        chunk = df.iloc[i:i + batch_size]
        images, hints, keep = [], [], []
        for j, (img_bytes, hint) in enumerate(
                zip(chunk[img_col], chunk[hint_col])):
            try:
                images.append(Image.open(io.BytesIO(img_bytes)).convert("RGB"))
                hints.append("" if hint is None else str(hint))
                keep.append(j)
            except Exception as e:  # undecodable image: failed row
                print(f"skipping undecodable image: {e}")
        raw = captioner(images, hints)
        if len(raw) != len(keep):  # a silent zip() truncation would
            raise ValueError(      # misalign captions with rows
                f"captioner returned {len(raw)} captions for {len(keep)} "
                "images — backends must return one caption per image")
        caps: list[str | None] = [None] * len(chunk)
        for j, c in zip(keep, raw):
            c = postprocess_caption(c)
            caps[j] = None if caption_failed(c) else c
        ok = [c for c in caps if c is not None]
        short_list = distiller(ok) if ok else []
        if len(short_list) != len(ok):
            raise ValueError(
                f"distiller returned {len(short_list)} captions for "
                f"{len(ok)} inputs — backends must return one per input")
        shorts = iter(short_list)
        long_caps.extend(caps)
        short_caps.extend(next(shorts) if c is not None else None
                          for c in caps)

    out = df.copy()
    out["recaption"] = long_caps
    out["recaption_short"] = short_caps
    n_failed = out["recaption"].isnull().sum()
    if n_failed:
        print(f"Failed: {n_failed}/{len(out)}")
    out = out.dropna(subset=["recaption"]).reset_index(drop=True)
    if len(out) < min_rows:
        raise RuntimeError(
            f"captioning collapsed: only {len(out)} usable rows")
    return out


def split_manifest(input_dir: str, num_splits: int) -> list[list[str]]:
    """Deterministic round-robin split of the folder's parquets — the JSON
    equivalent of the reference's parquets_split.pkl."""
    names = sorted(p.name for p in Path(input_dir).glob("*.parquet"))
    return [names[i::num_splits] for i in range(num_splits)]


def recaption_folder(input_dir: str, output_dir: str,
                     captioner, distiller, batch_size: int = 64,
                     img_col: str = "image", hint_col: str = "class",
                     num_splits: int = 1, split_idx: int = 0,
                     min_rows: int = 10,
                     delete_during: bool = False) -> list[str]:
    """Recaption this worker's share of parquets. Already-present outputs are
    skipped, so a killed worker resumes by re-running the same command."""
    os.makedirs(output_dir, exist_ok=True)
    mine = split_manifest(input_dir, num_splits)[split_idx]
    done = []
    for name in mine:
        dst = os.path.join(output_dir, name)
        if os.path.exists(dst):
            done.append(name)
            continue
        src = os.path.join(input_dir, name)
        df = recaption_dataframe(pd.read_parquet(src), captioner, distiller,
                                 batch_size, img_col, hint_col, min_rows)
        write_parquet(df, dst)
        if delete_during:
            os.remove(src)
        done.append(name)
        print(f"recaptioned {name}: {len(df)} rows")
    return done


def stub_models():
    """Hermetic captioner/distiller for tests and dry runs."""
    def captioner(images, hints):
        return [f"The image shows a {h or 'scene'} in detail" for h in hints]

    def distiller(captions):
        return [" ".join(c.split()[:40]) for c in captions]

    return captioner, distiller


def hf_models(device: str = "cuda",
              caption_model: str = "llava-hf/llama3-llava-next-8b-hf",
              distill_model: str = "meta-llama/Meta-Llama-3-8B-Instruct",
              max_new_tokens: int = 1024,
              distill_max_new_tokens: int = 80,
              dtype=None, token: str | None = None):
    """The reference's captioning backends via plain HF `transformers`:
    LLaVA-Next-8b (llama3) as the captioner and Llama-3-8B-Instruct as the
    caption distiller (reference data/recaption_parquets.py:43-118 — which
    goes through the `llava` package + a CUDA `pipeline`; this rebuild uses
    the upstream `transformers` ports so it runs on any backend torch has).

    Returns a (captioner, distiller) pair for `recaption_folder`. Weights
    load from the HF cache / local snapshots — `caption_model` /
    `distill_model` may be local paths. Batch generation pads left, mirroring
    the reference's tokenizer_padding_side="left".
    """
    import torch
    from transformers import (AutoModelForCausalLM, AutoTokenizer,
                              LlavaNextForConditionalGeneration,
                              LlavaNextProcessor)

    dtype = dtype or (torch.bfloat16 if torch.cuda.is_available()
                      else torch.float32)
    processor = LlavaNextProcessor.from_pretrained(caption_model, token=token)
    processor.tokenizer.padding_side = "left"
    if processor.tokenizer.pad_token is None:
        processor.tokenizer.pad_token = processor.tokenizer.eos_token
    vlm = LlavaNextForConditionalGeneration.from_pretrained(
        caption_model, torch_dtype=dtype, token=token).to(device).eval()

    lm_tok = AutoTokenizer.from_pretrained(distill_model, token=token)
    lm_tok.padding_side = "left"
    if lm_tok.pad_token is None:
        lm_tok.pad_token = lm_tok.eos_token
    lm = AutoModelForCausalLM.from_pretrained(
        distill_model, torch_dtype=dtype, token=token).to(device).eval()

    @torch.no_grad()
    def captioner(images, hints):
        prompts = []
        for hint in hints:
            conv = [{"role": "user",
                     "content": [{"type": "image"},
                                 {"type": "text",
                                  "text": LONG_CAPTION_PROMPT.format(
                                      hint=hint)}]}]
            prompts.append(processor.apply_chat_template(
                conv, add_generation_prompt=True))
        inputs = processor(images=list(images), text=prompts, padding=True,
                           return_tensors="pt").to(device)
        out = vlm.generate(**inputs, max_new_tokens=max_new_tokens,
                           do_sample=False)
        # left padding: the prompt occupies the first input_len positions
        gen = out[:, inputs["input_ids"].shape[1]:]
        return processor.batch_decode(gen, skip_special_tokens=True)

    @torch.no_grad()
    def distiller(captions):
        convs = [[{"role": "user",
                   "content": DISTILL_PROMPT.format(caption=c)}]
                 for c in captions]
        texts = [lm_tok.apply_chat_template(c, tokenize=False,
                                            add_generation_prompt=True)
                 for c in convs]
        inputs = lm_tok(texts, return_tensors="pt", padding=True,
                        truncation=True, max_length=2048).to(device)
        out = lm.generate(**inputs,
                          max_new_tokens=distill_max_new_tokens,
                          do_sample=False,
                          pad_token_id=lm_tok.pad_token_id)
        gen = out[:, inputs["input_ids"].shape[1]:]
        return [t.strip() for t in
                lm_tok.batch_decode(gen, skip_special_tokens=True)]

    return captioner, distiller


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_dir", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--batch_size", type=int, default=64)
    p.add_argument("--img_col", default="image")
    p.add_argument("--hint_col", default="class")
    p.add_argument("--num_splits", type=int, default=1)
    p.add_argument("--split_idx", type=int, default=0)
    p.add_argument("--delete_during", action="store_true")
    p.add_argument("--stub", action="store_true",
                   help="use the hermetic stub captioner (testing)")
    a = p.parse_args(argv)
    captioner, distiller = stub_models() if a.stub else hf_models()
    recaption_folder(a.input_dir, a.output_dir, captioner, distiller,
                     a.batch_size, a.img_col, a.hint_col, a.num_splits,
                     a.split_idx, delete_during=a.delete_during)


if __name__ == "__main__":
    main()
