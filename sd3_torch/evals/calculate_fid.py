"""FID scoring CLI (the port's copy of sd3_tpu/evals/calculate_fid.py;
reference eval/calculate_fid_imagenet.py + calculate_fid_generated.py
combined):

  stats:  compute and cache (mu, Sigma) for an image folder
  score:  FID between a generated folder and cached stats (or two folders);
          --per_class: FID per matching subdirectory, then the mean

    python -m sd3_torch.evals.calculate_fid score --generated_dir GEN \
        --ref_dir REF [--inception_weights W.pth]

Prints the same lines as the JAX CLI (`FID: x.xxxx`, `FID[c]: ...`, `mean
FID over n classes: ...`), and on stderr the same warning when it falls back
to ReducedPixelFeatures. `main` returns the score (the mean under
--per_class).
"""

from __future__ import annotations

import argparse
import sys

from sd3_torch.evals import fid


def main(argv=None):
    p = argparse.ArgumentParser()
    sub = p.add_subparsers(dest="cmd", required=True)

    ps = sub.add_parser("stats")
    ps.add_argument("--image_dir", required=True)
    ps.add_argument("--out", required=True)
    ps.add_argument("--inception_weights", default=None)

    pf = sub.add_parser("score")
    pf.add_argument("--generated_dir", required=True)
    pf.add_argument("--ref_stats", default=None)
    pf.add_argument("--ref_dir", default=None)
    pf.add_argument("--inception_weights", default=None)
    pf.add_argument("--per_class", action="store_true",
                    help="FID per matching subdirectory, then the mean "
                         "(reference calculate_fid_generated.py per-class flow)")

    args = p.parse_args(argv)
    feats = fid.default_features(args.inception_weights)
    if isinstance(feats, fid.ReducedPixelFeatures):
        print("WARNING: inception weights unavailable — using "
              "ReducedPixelFeatures (relative comparisons only)",
              file=sys.stderr)

    if args.cmd == "stats":
        mu, sigma = fid.stats_over_images(
            fid_dir_iter(args.image_dir), feats)
        fid.save_stats(args.out, mu, sigma)
        print(f"saved stats for {args.image_dir} -> {args.out}")
        return

    if args.per_class:
        import os
        assert args.ref_dir, "--per_class needs --ref_dir"
        classes = sorted(d for d in os.listdir(args.generated_dir)
                         if os.path.isdir(os.path.join(args.generated_dir, d)))
        scores = []
        for c in classes:
            g = os.path.join(args.generated_dir, c)
            r = os.path.join(args.ref_dir, c)
            if not os.path.isdir(r):
                continue
            mu1, s1 = fid.stats_over_images(fid_dir_iter(g), feats)
            mu2, s2 = fid.stats_over_images(fid_dir_iter(r), feats)
            score = fid.frechet_distance(mu1, s1, mu2, s2)
            scores.append(score)
            print(f"FID[{c}]: {score:.4f}")
        mean = sum(scores) / max(len(scores), 1)
        print(f"mean FID over {len(scores)} classes: {mean:.4f}")
        return mean

    mu1, s1 = fid.stats_over_images(fid_dir_iter(args.generated_dir), feats)
    if args.ref_stats:
        mu2, s2 = fid.load_stats(args.ref_stats)
    else:
        assert args.ref_dir, "need --ref_stats or --ref_dir"
        mu2, s2 = fid.stats_over_images(fid_dir_iter(args.ref_dir), feats)
    score = fid.frechet_distance(mu1, s1, mu2, s2)
    print(f"FID: {score:.4f}")
    return score


def fid_dir_iter(d, batch_size=32):
    import os
    import numpy as np
    from PIL import Image
    files = []
    for root, _, names in os.walk(d):
        files += [os.path.join(root, n) for n in names
                  if n.lower().endswith((".png", ".jpg", ".jpeg"))]
    files.sort()
    assert files, f"no images under {d}"
    for i in range(0, len(files), batch_size):
        imgs = []
        for fp in files[i:i + batch_size]:
            with Image.open(fp) as im:
                arr = np.asarray(im.convert("RGB"), np.float32) / 255.0
            imgs.append(arr.transpose(2, 0, 1) * 2 - 1)
        yield np.stack(imgs)


if __name__ == "__main__":
    main()
