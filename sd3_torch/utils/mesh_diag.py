"""The trainer over a mesh of several processes, held to the trainer
without a process group (sd3_torch/parallel/, training/trainer.py). One
process a device, under torchrun:

    torchrun --nproc_per_node 4 -m sd3_torch.utils.mesh_diag [--device cpu]

Over a (1, 2, 2) mesh (fsdp 2 x tp 2), phase 11's training flags
(chip_smoke.train_slice_config: fused low-mem AdamW, bf16 gradients,
precast weights, remat), batch 8, STEPS steps on given draws, two models:
the published widths at 4 blocks, 256px (19 heads: tp keeps the attention
whole and splits the MLP), and dim 1024 x 16 heads of 64 at 2 blocks with
8-bit moments (tp splits the heads). On the CPU (gloo) the same at tiny
widths, 64px. Each run's steps (loss, grad norm, s a step), the update (the
gathered masters minus the initial ones), then, on rank 0 after the group
is destroyed, the same steps of the trainer without a group on rank 0's
device, and a control (the draws' rows rolled by one): the relative error
of each step's loss and grad norm and the update's relative L2, for the
mesh and for the control. Rank 0 prints one JSON line; no limit is applied.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import tempfile
import time

STEPS, BATCH = 3, 8


def _configs(cpu: bool, res: int):
    from sd3_torch.config import published_config, tiny_config
    if cpu:
        kw = dict(attn_type="softmax_flash", dtype="bfloat16", max_res=res,
                  max_res_orig=res)
        return [("dim 96 x 3 heads", tiny_config(dim=96, num_heads=3, **kw),
                 {}),
                ("dim 64 x 4 heads, 8-bit", tiny_config(dim=64, num_heads=4,
                                                        **kw),
                 dict(moments_8bit=True))]
    pub = published_config(stage_res=res)
    return [("published widths, 4 blocks", pub.replace(num_blocks=4), {}),
            ("dim 1024 x 16 heads, 2 blocks, 8-bit",
             pub.replace(num_blocks=2, dim=1024, num_heads=16),
             dict(moments_8bit=True))]


def _tcfg(**kw):
    from sd3_torch.training.trainer import TrainConfig
    return TrainConfig(
        batch_size=BATCH, accumulation_steps=1, total_steps=10 ** 9,
        ema_update_freq=10 ** 9, num_save_steps=10 ** 9, log_steps=10 ** 9,
        low_mem_optimizer=True, track_ema=False, remat_policy="nothing",
        bf16_grads=True, bf16_grad_accum=True, precast_params=True,
        fused_optimizer=True, remat_blocks=True, **kw)


def _data(cfg, res, device):
    """A seeded batch and STEPS draws, the same on every rank."""
    import torch
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training.trainer import draw_noise
    batch = {k: torch.as_tensor(v).to(device) for k, v in next(
        synthetic_batch_iter(cfg, BATCH, 1, res, res, seed=3)).items()}
    gen = torch.Generator(device=device).manual_seed(11)
    return batch, [[draw_noise(gen, batch["x0"][0], _tcfg())]
                   for _ in range(STEPS)]


def _run(trainer, batch, noises):
    """(each step's loss, grad norm and s; the update on the host)."""
    p0 = {k: v.detach().float().cpu().clone()
          for k, v in trainer.gather(trainer.params).items()}
    steps = []
    for noise in noises:
        t = time.time()
        m = trainer.train_step(batch, noise)
        steps.append(dict(loss=m["loss"].item(),
                          grad_norm=m["grad_norm"].item(),
                          s=time.time() - t))
    update = {k: v.detach().float().cpu() - p0[k]
              for k, v in trainer.gather(trainer.params).items()}
    return steps, update


def _update_rel_l2(got: dict, want: dict) -> float:
    num = sum(float((got[k] - want[k]).double().norm() ** 2) for k in want)
    den = sum(float(want[k].double().norm() ** 2) for k in want)
    return math.sqrt(num / den)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda")
    p.add_argument("--log_dir", default=None,
                   help="the trainers' metrics files (default: a temporary "
                        "directory, removed at exit)")
    args = p.parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="mesh_diag_") as tmp:
        _measure(args.device, args.log_dir or tmp)


def _measure(device: str, log_dir: str):
    import torch
    import torch.distributed as dist

    from sd3_torch.parallel import MeshConfig, multihost
    from sd3_torch.training.trainer import Noise, Trainer

    cpu = device == "cpu"
    res = 64 if cpu else 256
    t0 = time.time()
    dev = multihost.initialize(device=device, timeout_s=300)
    rank, backend = dist.get_rank(), dist.get_backend()
    nccl = "" if cpu else ".".join(map(str, torch.cuda.nccl.version()))
    kw = dict(device=dev, log_dir=log_dir, use_wandb=False)
    runs = []
    for label, cfg, extra in _configs(cpu, res):
        batch, noises = _data(cfg, res, dev)
        tr = Trainer(cfg, _tcfg(mesh=MeshConfig(1, 2, 2), **extra), **kw)
        plan = tr.mesh.plan
        held = (sum(v.numel() for v in tr.params.values())
                / sum(math.prod(s) for s in plan.shapes.values()))
        steps, update = _run(tr, batch, noises)
        del tr
        runs.append((label, cfg, extra, batch, noises, steps, update,
                     dict(heads_split=plan.heads_split(),
                          masters_share=held)))
    world = dist.get_world_size()
    dist.destroy_process_group()
    if rank != 0:
        return
    rel = lambda a, b: abs(a - b) / abs(b)
    report = dict(backend=backend, nccl=nccl, world=world, mesh=[1, 2, 2],
                  res=res, batch=BATCH, runs=[])
    for label, cfg, extra, batch, noises, steps, update, split in runs:
        ref, ref_update = _run(Trainer(cfg, _tcfg(**extra), **kw), batch,
                               noises)
        rolled = [[Noise(*(None if x is None else torch.roll(x, 1, 0)
                           for x in n[0]))] for n in noises]
        ctl, ctl_update = _run(Trainer(cfg, _tcfg(**extra), **kw), batch,
                               rolled)
        report["runs"].append(dict(
            label=label, extra=extra, **split, mesh_steps=steps,
            one_process_steps=ref,
            errors=[dict(loss=rel(a["loss"], b["loss"]),
                         grad_norm=rel(a["grad_norm"], b["grad_norm"]))
                    for a, b in zip(steps, ref)],
            update_rel_l2=_update_rel_l2(update, ref_update),
            control=dict(loss=rel(ctl[0]["loss"], ref[0]["loss"]),
                         update_rel_l2=_update_rel_l2(ctl_update,
                                                      ref_update))))
    report["seconds"] = time.time() - t0
    if not cpu:
        report["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip().splitlines()
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
