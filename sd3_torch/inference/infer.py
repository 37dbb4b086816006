"""Text-to-image inference CLI (JAX counterpart: sd3_tpu/inference/infer.py).

Example:
  python -m sd3_torch.inference.infer --loadDir ckpts/run --step 1000 \
      --text_input "a red fox" --num_steps 20 --guidance 5 --width 512 \
      --height 512 --sampler euler --seed 7 --stub_encoders --out_imgname fig

Loads a native checkpoint of either package (`--step N`: model_params_Ns.json
and model_Ns.msgpack, or with `--ema` model_ema_Ns.msgpack;
`training/checkpoint.py`) or a reference torch checkpoint (`--torch_ckpt`
state_dict with the `--loadDefFile` params JSON: a JSON without `MLP_type`,
the reference's older checkpoints, means swiglu_old, and their absolute PE's
`pos_enc.pos_embed` buffer is recomputed, not loaded), and samples on
`--device` (default cuda; it raises when no GPU is there rather than run on
the CPU). Every model variant of the checkpoint's config runs; a
`text_loss` model's text prediction is dropped.
`--gif` also writes `<out_imgname>_diffusion.gif`, the first sample decoded
after every step, at `--gif_fps`. `--stub_encoders` runs with the
deterministic stub conditioning stack, `--encoder_weights DIR` with the real
one, Gemma-2, ModernBERT, CLIP and the FLUX VAE (`models/encoder_suite.py`)
from the snapshots under DIR (gemma-2-2b/, modernbert-large/,
metaclip-l14/, flux-vae/); with neither, the stub. `--quant int8` serves
with w8a8 projections and the int8 kernels: the float checkpoint is loaded,
quantized (`--quant_skip` names stay float), cast, then moved to the
device; `--int8_pv` adds int8 P.V in the streaming attention above 2048
joint tokens (1024px: `--width 1024 --height 1024`), the JAX package's
SD3_INT8_PV=1. The int8 block tails follow the JAX package's other opt-in
flags, as the config fields of the same names: `--attn_tail
{none,all,qkv,out}` (SD3_ATTN_TAIL: K10a / K10b), `--mlp_tail_fusion
{2d,3d}` (SD3_MLP_TAIL_FUSION: K9 under 3d), `--no_mlp_tail`
(SD3_NO_MLP_TAIL=1) and `--no_fused_mlp` (SD3_NO_FUSED_MLP=1). Every
option works on either kind of checkpoint.
"""

from __future__ import annotations

import argparse
import json
import os
import pickle

import numpy as np


def build_argparser(prompt: bool = True, description: str = __doc__):
    """The flags of a sampling run; `prompt`: with --text_input (the loop
    reads its prompts from stdin instead)."""
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--loadDir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step suffix (native checkpoints)")
    p.add_argument("--torch_ckpt", default=None,
                   help="reference .pkl state_dict filename inside loadDir")
    p.add_argument("--loadDefFile", default=None,
                   help="model_params JSON filename inside loadDir")
    if prompt:
        p.add_argument("--text_input", required=True)
    p.add_argument("--num_steps", type=int, default=10)
    p.add_argument("--guidance", type=float, default=4.0)
    p.add_argument("--width", type=int, default=256)
    p.add_argument("--height", type=int, default=256)
    p.add_argument("--sampler", default="euler",
                   choices=["euler", "euler_stochastic", "heun"])
    p.add_argument("--seed", type=int, default=-1)
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--out_imgname", default="fig")
    p.add_argument("--gif", action="store_true",
                   help="also save the per-step diffusion gif")
    p.add_argument("--gif_fps", type=int, default=10)
    p.add_argument("--stub_encoders", action="store_true")
    p.add_argument("--encoder_weights", default=None, metavar="DIR",
                   help="the real encoder suite from the snapshots under DIR")
    p.add_argument("--ema", action="store_true",
                   help="load the EMA weights (native checkpoints)")
    p.add_argument("--dtype", default="checkpoint",
                   choices=["checkpoint", "float32", "bfloat16"],
                   help="compute-dtype override")
    p.add_argument("--save_latents", default=None, metavar="PATH.npy",
                   help="also dump the raw pre-VAE latents (fp32 npy)")
    p.add_argument("--quant", default="none", choices=["none", "int8"],
                   help="int8 (w8a8) serving: quantize the checkpoint's "
                        "projections at load")
    p.add_argument("--quant_skip", default="",
                   help="comma-separated layer names kept float under "
                        "--quant int8 (e.g. w12,w3 or attn_qk)")
    p.add_argument("--int8_pv", action="store_true",
                   help="with --quant int8: int8 P.V in the streaming "
                        "attention above 2048 joint tokens (1024px)")
    p.add_argument("--attn_tail", default="none",
                   choices=["none", "all", "qkv", "out"],
                   help="with --quant int8: fold the attention half's AdaLN "
                        "into the image q/k/v projections (all, qkv) and its "
                        "gate + residual into the out-projections (all, out)")
    p.add_argument("--mlp_tail_fusion", default="2d", choices=["2d", "3d"],
                   help="with --quant int8: the MLP block tail's kernel, K2 "
                        "/ K3 (2d) or K9 for every stream (3d)")
    p.add_argument("--no_mlp_tail", action="store_true",
                   help="with --quant int8: run the MLP half unfused around "
                        "the int8 SwiGLU kernel")
    p.add_argument("--no_fused_mlp", action="store_true",
                   help="with --quant int8: no int8 SwiGLU kernel, two int8 "
                        "projections")
    p.add_argument("--allow_unsafe_pickle", action="store_true",
                   help="permit torch.load(weights_only=False) for legacy "
                        "reference .pkl files that the safe loader rejects — "
                        "executes pickle code, only for trusted checkpoints")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda or cpu)")
    return p


def load_state(args):
    """(cfg, state_dict) of the checkpoint the flags name: a native one
    (`--step`, `--ema`) or a reference torch pickle (`--torch_ckpt`)."""
    import torch
    from sd3_torch.config import MMDiTConfig
    from sd3_torch.training import checkpoint as ckpt
    from sd3_torch.weights import state_dict_from_jax

    if not args.torch_ckpt:
        if args.step is None:
            raise ValueError("--step is required for native checkpoints")
        cfg = ckpt.load_config(args.loadDir, f"model_params_{args.step}s.json")
        name = f"{'model_ema' if args.ema else 'model'}_{args.step}s.msgpack"
        return cfg, state_dict_from_jax(ckpt.load_artifact(args.loadDir, name),
                                        cfg.patch_size)
    if not args.loadDefFile:
        raise ValueError("--loadDefFile is required with --torch_ckpt")
    with open(os.path.join(args.loadDir, args.loadDefFile)) as f:
        cfg = MMDiTConfig.from_json_dict(json.load(f))
    path = os.path.join(args.loadDir, args.torch_ckpt)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:  # the safe loader refused it
        if not args.allow_unsafe_pickle:
            raise RuntimeError(
                f"{args.torch_ckpt} is not a plain tensor state_dict "
                f"(weights_only load failed: {e}); re-run with "
                "--allow_unsafe_pickle only if you trust its origin") from e
        sd = torch.load(path, map_location="cpu", weights_only=False)
    return cfg, sd


def load_model(args, device):
    """(model, cfg) from the checkpoint the flags name (`load_state`), on
    `device`, parameters in the compute dtype; quantized first under
    --quant int8."""
    from sd3_torch import torch_dtype
    from sd3_torch.models.mmdit import MMDiT
    from sd3_torch.ops.quant import quantize_model
    from sd3_torch.weights import load_reference_state_dict

    cfg, sd = load_state(args)
    if args.dtype != "checkpoint":
        cfg = cfg.replace(dtype=args.dtype)
    cfg = cfg.replace(int8_pv=args.int8_pv, attn_tail=args.attn_tail,
                      mlp_tail_fusion=args.mlp_tail_fusion,
                      mlp_tail=not args.no_mlp_tail,
                      fused_mlp=not args.no_fused_mlp)
    model = MMDiT(cfg, device="cpu")  # load on the host, then move
    load_reference_state_dict(model, sd)
    if args.quant == "int8":
        skip = tuple(n for n in args.quant_skip.split(",") if n)
        quantize_model(model, skip)
        cfg = model.cfg
    model.cast_params(torch_dtype(cfg.dtype)).to(device).eval()
    return model, cfg


def save_png(arr_chw: np.ndarray, path: str):
    from PIL import Image
    img = np.clip((arr_chw.transpose(1, 2, 0) + 1) / 2 * 255, 0, 255)
    Image.fromarray(img.astype(np.uint8)).save(path)


def main(argv=None):
    parser = build_argparser()
    args = parser.parse_args(argv)
    int8_only = dict(int8_pv=args.int8_pv,
                     attn_tail=args.attn_tail != "none",
                     mlp_tail_fusion=args.mlp_tail_fusion != "2d",
                     no_mlp_tail=args.no_mlp_tail,
                     no_fused_mlp=args.no_fused_mlp)
    for flag, given in int8_only.items():
        if given and args.quant != "int8":
            parser.error(f"--{flag} needs --quant int8")
    if args.gif and args.save_latents:
        parser.error("--save_latents and --gif are exclusive")
    import torch
    from sd3_torch import resolve_device
    from sd3_torch.inference.sampler import sample_imgs
    from sd3_torch.models.text_encoders import load_text_encoders

    device = resolve_device(args.device)
    model, cfg = load_model(args, device)
    encoders = load_text_encoders(device=device, stub=args.stub_encoders,
                                  weights_dir=args.encoder_weights,
                                  model_cfg=cfg)
    # seed -1 means "random" (reference infer.py default)
    seed = args.seed if args.seed != -1 else int.from_bytes(os.urandom(4), "little")
    gen = torch.Generator(device="cpu").manual_seed(seed)

    lat = sample_imgs(model, encoders, args.batch_size, args.num_steps,
                      args.text_input, args.guidance, args.width, args.height,
                      args.sampler, generator=gen, decode=False,
                      save_intermediate=args.gif)
    lat, frames = lat if args.gif else (lat, None)
    if args.save_latents:
        np.save(args.save_latents, lat.float().cpu().numpy())
        print(f"wrote {args.save_latents}")
    out = encoders.vae_decode(lat).float().cpu().numpy()
    for i, img in enumerate(out):
        save_png(img, f"{args.out_imgname}_{i}.png")
        print(f"wrote {args.out_imgname}_{i}.png")
    if frames:
        from PIL import Image
        images = [Image.fromarray(np.clip(
            (f[0].float().cpu().numpy().transpose(1, 2, 0) + 1) / 2 * 255,
            0, 255).astype(np.uint8)) for f in frames]
        images[0].save(f"{args.out_imgname}_diffusion.gif", save_all=True,
                       append_images=images[1:],
                       duration=1000 // args.gif_fps, loop=0)
        print(f"wrote {args.out_imgname}_diffusion.gif")


if __name__ == "__main__":
    main()
