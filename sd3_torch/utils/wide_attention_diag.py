"""The attention forwards past head dim 128 on one NVIDIA Hopper GPU: the
wgmma kernels' instances at D = 256, 384, 512, 768 and 1024
(ops/fused_attention.py `_D256` .. `_D1024`: K1_256 .. K8B_1024;
ops/flash_attention.py K5_256 .. K5_1024) beside the wide mma.sync
instances of csrc/attention_fp32.cu that took those head dims before them
(K1W .. K8BW, K5W) and bf16 SDPA, on the same inputs in the same process.
From the root of the repository (it takes its shapes, inputs and timing
from chip_smoke.py):

    python3 -m sd3_torch.utils.wide_attention_diag [256] [384] [512] [640] [1024]

(all five head dims by default). Each fused kernel at
chip_smoke.SLICE_WIDE (B 2, the 512px joint sequence of 1178 tokens, 5
heads of 256; the streaming ones forced there), SLICE_WIDE_384,
SLICE_WIDE_512 (the same at 384 and 512), SLICE_WIDE_640 (two heads of
640: the wgmma route pads them to its D = 768 instances, the mma.sync
route runs them at 640) and SLICE_WIDE_1024 (two heads of 1024), and K5 at
the chip_smoke.FLASH_WIDE shape of that head dim (B 4), FLASH_PAST_512
(B 2, two heads of 640) or FLASH_1024: the call time of each route in
turns (wgmma, mma.sync, SDPA, SDPA, mma.sync, wgmma: CUDA events around a
graph of 10 calls, median of 5, chip_smoke.cuda_ms; SDPA on q / k prepped
by the plain version for the fused kernels, as chip_smoke.py's yardstick),
the largest difference of the two kernel routes' outputs (K7 rounds p over
other key tiles: 64 / 32 / 64 keys on the wgmma route at 256 / 384-512 /
768-1024, 128 on the mma.sync one), and the device time of each launch of
one call of each (torch.profiler: the q / k / V preps apart from the
attention). One JSON line per kernel and head dim on stdout, after the
card's name and power limit.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("no CUDA card: this script times kernels on one", flush=True)
        return 1
    import chip_smoke as cs
    from sd3_torch.ops import flash_attention as fl
    from sd3_torch.ops import fused_attention as fa

    dims = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [
        256, 384, 512, 640, 1024]
    slices = {256: cs.SLICE_WIDE, 384: cs.SLICE_WIDE_384,
              512: cs.SLICE_WIDE_512, 640: cs.SLICE_WIDE_640,
              1024: cs.SLICE_WIDE_1024}
    flash_shapes = {**{s[-1]: s for s in cs.FLASH_WIDE},
                    640: cs.FLASH_PAST_512, 1024: cs.FLASH_1024}
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16
    for dim in dims:
        shape = slices[dim]
        for (int8_qk, int8_pv, streaming), name in cs.ATTN_NAMES.items():
            q, k, v, _, _, _, tables = cs.attn_inputs(shape, gen)
            nh, d, b, n = shape["heads"], shape["d"], shape["b"], q.shape[1]
            fold = d ** -0.5 * fa.LOG2E
            tabs = (tables[0] * fold, tables[1] * fold, tables[2], tables[3])
            eps = float(torch.finfo(bf16).eps)
            base = fa._INFERENCE.get((int8_qk, int8_pv, streaming),
                                     (fa.K7 if streaming else fa.K1,))[0]
            routes = {"wgmma": fa.kernel_for(base, q.dtype, d),
                      "mma.sync": fa._WIDE[base][0]}
            runs = {r: (lambda kern=kern: fa._launch(
                base, q, k, v, *tabs, eps, eps, nh, int8_qk, route=kern))
                for r, kern in routes.items()}
            heads = lambda x: x.reshape(b, n, nh, d).transpose(1, 2)
            qh = cs.prep_for_sdpa(heads(q), tables[0], tables[1], eps)
            kh = cs.prep_for_sdpa(heads(k), tables[2], tables[3], eps)
            vh = heads(v).contiguous()
            sdpa = lambda: F.scaled_dot_product_attention(qh, kh, vh,
                                                          scale=d ** -0.5)
            _report(f"{name} D={d}", routes, runs, sdpa)
        fshape = flash_shapes[dim]
        b, h, n, m, d = cs.flash_dims(fshape)
        q, k, v, _ = cs.flash_inputs(fshape, gen, bf16)
        routes = {"wgmma": fl.flash_kernel("fwd", bf16, d),
                  "mma.sync": fl.K5W}

        def flash(kern, q=q, k=k, v=v, b=b, h=h, n=n, m=m, d=d):
            # each route at its instance's head dim: the wgmma one's
            # (forward_dim), the mma.sync one's multiple of 128
            dp = fl.instance_dim(d) if kern is fl.K5W else fl.forward_dim(
                d, bf16)
            qp, kp, vp = (fl._pad(t, dp) for t in (q, k, v))
            out = fl._bnhd(qp.shape, qp)
            lse = torch.empty((b, h, n), dtype=torch.float32,
                              device=q.device)
            fl._launch(kern, (qp, kp, vp, out, lse), (qp, kp, vp, out), b, h,
                       n, m, dp, d ** -0.5)
            return out[..., :d]
        runs = {r: (lambda kern=kern: flash(kern))
                for r, kern in routes.items()}
        sdpa = lambda q=q, k=k, v=v, d=d: F.scaled_dot_product_attention(
            q, k, v, scale=d ** -0.5)
        _report(f"K5 D={d}", routes, runs, sdpa)
    return 0


def _report(name, routes, runs, sdpa):
    """Time the two kernel routes and SDPA in turns, compare the routes'
    outputs, print a line."""
    import chip_smoke as cs

    outs = {r: run().float() for r, run in runs.items()}
    timed = dict(runs, sdpa=sdpa)
    times = {r: [] for r in timed}
    for r in ("wgmma", "mma.sync", "sdpa", "sdpa", "mma.sync", "wgmma"):
        times[r].append(cs.cuda_ms(timed[r]))
    print(json.dumps(dict(
        kernel=name, routes={r: k.name for r, k in routes.items()},
        ms=times,
        max_abs_diff=(outs["wgmma"] - outs["mma.sync"]).abs().max().item(),
        us_per_launch={r: cs.per_launch_us(run) for r, run in runs.items()},
    )), flush=True)


if __name__ == "__main__":
    sys.exit(main())
