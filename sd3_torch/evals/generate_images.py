"""Batch image generation for FID evaluation (JAX counterpart:
sd3_tpu/evals/generate_images.py; reference eval/generate_images.py,
modernized to the text-conditioned API).

Generates N images per prompt (or per class name used as a prompt) into
`out_dir/<prompt_idx>/<k>.png`, with `out_dir/manifest.json` listing
{prompt, dir, count} per prompt:

    python -m sd3_torch.evals.generate_images --loadDir ckpts/run \
        --step 1000 --res 512 --num_per_prompt 8 --batch_size 4 \
        --stub_encoders --out_dir output/generated [--quant int8]

The model is loaded as the infer CLI loads it (`inference/infer.py`:
`load_model` with that CLI's defaults for every flag this one lacks), so
`--quant int8` serves w8a8 through `quantize_model` and the int8 kernels
(at 512px: K2, K3, K4). `--device` defaults to cuda and raises when no card
is there; `--device cpu` runs the kernels' plain versions. The encoders are
the stub (`--stub_encoders`) or the real suite from `--encoder_weights DIR`
(no environment variable is read). Each batch's initial latents are drawn
in turn from one CPU `torch.Generator` seeded with `--seed`. `--trace_dir
DIR` runs the first batch under `utils.profiling.trace` (a Chrome trace of
the host's operators and the card's kernels in DIR); the other batches'
times are summarised at the end (`utils.profiling.StepTimer`).
"""

from __future__ import annotations

import argparse
import json
import os

STOCK_PROMPTS = ["a photo of a dog", "a photo of a cat", "a red car",
                 "a mountain landscape", "a bowl of fruit", "a city at night",
                 "a sailboat on the ocean", "a bird on a branch",
                 "a cup of coffee", "a field of sunflowers"]


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--loadDir", required=True)
    p.add_argument("--step", type=int, required=True)
    p.add_argument("--ema", action="store_true")
    p.add_argument("--prompts_file", default=None,
                   help="text file, one prompt per line (default: 10 stock "
                        "prompts)")
    p.add_argument("--num_per_prompt", type=int, default=8)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--num_steps", type=int, default=20)
    p.add_argument("--guidance", type=float, default=5.0)
    p.add_argument("--res", type=int, default=256)
    p.add_argument("--sampler", default="euler",
                   choices=["euler", "euler_stochastic", "heun"])
    p.add_argument("--out_dir", default="output/generated")
    p.add_argument("--stub_encoders", action="store_true")
    p.add_argument("--encoder_weights", default=None, metavar="DIR",
                   help="the real encoder suite from the snapshots under DIR")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8: generate with the w8a8 serving config — the "
                        "bf16-vs-int8 FID drift gate")
    p.add_argument("--trace_dir", default=None, metavar="DIR",
                   help="profile the first batch into a trace under DIR")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p


def model_args(args):
    """The infer CLI's flags for `infer.load_model`: its defaults, with the
    checkpoint, EMA and quantization given here."""
    from sd3_torch.inference import infer
    margs = infer.build_argparser(prompt=False).parse_args(
        ["--loadDir", args.loadDir])
    margs.step, margs.ema, margs.quant = args.step, args.ema, args.quant
    return margs


def read_prompts(path: str | None) -> list[str]:
    if not path:
        return list(STOCK_PROMPTS)
    with open(path) as f:
        return [ln.strip() for ln in f if ln.strip()]


def main(argv=None):
    args = build_argparser().parse_args(argv)
    import torch
    from sd3_torch import resolve_device
    from sd3_torch.inference.infer import load_model, save_png
    from sd3_torch.inference.sampler import sample_imgs
    from sd3_torch.models.text_encoders import load_text_encoders
    from sd3_torch.utils.profiling import StepTimer, trace

    device = resolve_device(args.device)
    model, cfg = load_model(model_args(args), device)
    encoders = load_text_encoders(device=device, stub=args.stub_encoders,
                                  weights_dir=args.encoder_weights,
                                  model_cfg=cfg)
    prompts = read_prompts(args.prompts_file)
    gen = torch.Generator(device="cpu").manual_seed(args.seed)
    timer = StepTimer()
    to_trace = bool(args.trace_dir)
    manifest = []
    for pi, prompt in enumerate(prompts):
        pdir = os.path.join(args.out_dir, str(pi))
        os.makedirs(pdir, exist_ok=True)
        done = 0
        while done < args.num_per_prompt:
            n = min(args.batch_size, args.num_per_prompt - done)
            with (trace(args.trace_dir) if to_trace else timer):
                imgs = sample_imgs(model, encoders, n, args.num_steps,
                                   prompt, args.guidance, args.res, args.res,
                                   args.sampler, generator=gen)
                imgs = imgs.float().cpu().numpy()
            to_trace = False
            for img in imgs:
                save_png(img, os.path.join(pdir, f"{done}.png"))
                done += 1
        manifest.append({"prompt": prompt, "dir": pdir,
                         "count": args.num_per_prompt})
        print(f"[{pi+1}/{len(prompts)}] {prompt!r} -> {pdir}")

    with open(os.path.join(args.out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=2)
    print("batch s", json.dumps(timer.summary()))
    return manifest, timer.summary()


if __name__ == "__main__":
    main()
