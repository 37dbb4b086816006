"""The attention forwards past head dim 128 on one NVIDIA Hopper GPU: the
wgmma kernels' instances at D = 256, 384 and 512 (ops/fused_attention.py
`_D256`, `_D384`, `_D512`: K1_256 .. K8B_512; ops/flash_attention.py
K5_256, K5_384, K5_512) beside the wide mma.sync instances of
csrc/attention_fp32.cu that took those head dims before them (K1W ..
K8BW, K5W), on the same inputs in the same process. From the root of the
repository (it takes its shapes, inputs and timing from chip_smoke.py):

    python3 -m sd3_torch.utils.wide_attention_diag [256] [384] [512]

(all three head dims by default). Each fused kernel at
chip_smoke.SLICE_WIDE (B 2, the 512px joint sequence of 1178 tokens, 5
heads of 256; the streaming ones forced there), SLICE_WIDE_384 and
SLICE_WIDE_512 (the same at 384 and 512), and K5 at the
chip_smoke.FLASH_WIDE shape of that head dim (B 4): the call time of each
route in turns (wgmma, mma.sync, mma.sync, wgmma: CUDA events around a
graph of 10 calls, median of 5, chip_smoke.cuda_ms), the largest
difference of the two routes' outputs (K7 rounds p over other key tiles:
64 / 32 keys on the wgmma route at 256 / past it, 128 on the mma.sync
one), and the device time of each launch of one call of each
(torch.profiler: the q / k / V preps apart from the attention). One JSON
line per kernel and head dim on stdout, after the card's name and power
limit.
"""

from __future__ import annotations

import json
import sys


def main(argv=None) -> int:
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card: this script times kernels on one", flush=True)
        return 1
    import chip_smoke as cs
    from sd3_torch.ops import flash_attention as fl
    from sd3_torch.ops import fused_attention as fa

    dims = [int(a) for a in (sys.argv[1:] if argv is None else argv)] or [
        256, 384, 512]
    slices = {256: cs.SLICE_WIDE, 384: cs.SLICE_WIDE_384,
              512: cs.SLICE_WIDE_512}
    print(cs.nvidia_smi("name,power.limit"), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dim in dims:
        shape = slices[dim]
        for (int8_qk, int8_pv, streaming), name in cs.ATTN_NAMES.items():
            q, k, v, _, _, _, tables = cs.attn_inputs(shape, gen)
            nh, d = shape["heads"], shape["d"]
            fold = d ** -0.5 * fa.LOG2E
            tabs = (tables[0] * fold, tables[1] * fold, tables[2], tables[3])
            eps = float(torch.finfo(torch.bfloat16).eps)
            base = fa._INFERENCE.get((int8_qk, int8_pv, streaming),
                                     (fa.K7 if streaming else fa.K1,))[0]
            routes = {"wgmma": fa.kernel_for(base, q.dtype, d),
                      "mma.sync": fa._WIDE[base][0]}
            runs = {r: (lambda kern=kern: fa._launch(
                base, q, k, v, *tabs, eps, eps, nh, int8_qk, route=kern))
                for r, kern in routes.items()}
            _report(f"{name} D={d}", routes, runs, lambda o: o.float())
        fshape = next(s for s in cs.FLASH_WIDE if s[-1] == dim)
        b, h, n, m, d = cs.flash_dims(fshape)
        q, k, v, _ = cs.flash_inputs(fshape, gen, torch.bfloat16)
        routes = {"wgmma": fl.flash_kernel("fwd", torch.bfloat16, d),
                  "mma.sync": fl.K5W}

        def flash(kern, q=q, k=k, v=v, b=b, h=h, n=n, m=m, d=d):
            out = fl._bnhd(q.shape, q)
            lse = torch.empty((b, h, n), dtype=torch.float32,
                              device=q.device)
            fl._launch(kern, (q, k, v, out, lse), (q, k, v, out), b, h, n,
                       m, d, d ** -0.5)
            return out
        runs = {r: (lambda kern=kern: flash(kern))
                for r, kern in routes.items()}
        _report(f"K5 D={d}", routes, runs, lambda o: o.float())
    return 0


def _report(name, routes, runs, as_float):
    """Time the two routes in turns, compare their outputs, print a line."""
    import chip_smoke as cs

    outs = {r: as_float(run()) for r, run in runs.items()}
    times = {r: [] for r in runs}
    for r in ("wgmma", "mma.sync", "mma.sync", "wgmma"):
        times[r].append(cs.cuda_ms(runs[r]))
    print(json.dumps(dict(
        kernel=name, routes={r: k.name for r, k in routes.items()},
        ms={r: t for r, t in times.items()},
        max_abs_diff=(outs["wgmma"] - outs["mma.sync"]).abs().max().item(),
        us_per_launch={r: cs.per_launch_us(run) for r, run in runs.items()},
    )), flush=True)


if __name__ == "__main__":
    sys.exit(main())
