"""Sampling loop: load once, then sample every prompt read from stdin (JAX
counterpart: examples/infer_loop.py, the reference's infer_loop.ipynb).

Example:
  python -m sd3_torch.inference.infer_loop --loadDir ckpts/run --step 1000 \
      --ema --encoder_weights weights/ --width 512 --height 512 --seed 7
then type prompts; an empty line is skipped, `quit` or `exit` (or the end
of stdin) stops. Prompt i writes <out_imgname>_<i>_<j>.png for each of the
--batch_size samples j. The flags are `inference.infer`'s but --text_input:
the checkpoint, --quant and the tails, --dtype, --stub_encoders or
--encoder_weights DIR, --device (default cuda). The initial noise of
every prompt comes from one torch.Generator seeded by --seed.
"""

from __future__ import annotations

import os
import sys


def main(argv=None, stdin=None):
    from sd3_torch.inference import infer

    parser = infer.build_argparser(prompt=False, description=__doc__)
    args = parser.parse_args(argv)
    import torch
    from sd3_torch import resolve_device
    from sd3_torch.inference.sampler import sample_imgs
    from sd3_torch.models.text_encoders import load_text_encoders

    device = resolve_device(args.device)
    model, cfg = infer.load_model(args, device)
    encoders = load_text_encoders(device=device, stub=args.stub_encoders,
                                  weights_dir=args.encoder_weights,
                                  model_cfg=cfg)
    seed = args.seed if args.seed != -1 else int.from_bytes(os.urandom(4), "little")
    gen = torch.Generator(device="cpu").manual_seed(seed)
    print("loaded; type a prompt (or 'quit'):", flush=True)
    i = 0
    for line in stdin or sys.stdin:
        prompt = line.strip()
        if not prompt:
            continue
        if prompt in ("quit", "exit"):
            break
        imgs = sample_imgs(model, encoders, args.batch_size, args.num_steps,
                           prompt, args.guidance, args.width, args.height,
                           args.sampler, generator=gen)
        for j, img in enumerate(imgs.float().cpu().numpy()):
            path = f"{args.out_imgname}_{i}_{j}.png"
            infer.save_png(img, path)
            print(f"-> {path}", flush=True)
        i += 1


if __name__ == "__main__":
    main()
