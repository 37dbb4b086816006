"""Training CLI (JAX counterpart: sd3_tpu/training/train.py; the reference
src/train.py, with flags). The same flags and `main(argv)`, plus `--device`
(default cuda).

Modes:
  --synthetic           train on random pre-encoded batches (smoke/bench)
  --data_parquet_folder a bucketed parquet folder (`data/create_phase.py`,
                        `data/create_indices.py`): images decoded on the
                        host (--data_threads threads, or --ring_workers
                        processes through the shared-memory ring), encoded
                        on the device between steps by the stub encoders
                        (--stub_encoders) or the real suite
                        (--encoder_weights DIR), --prefetch_batches groups
                        ahead; each step's latent shape is printed
Resume: --loadDir / --loadStep read the six-artifact checkpoint of either
package (`training/checkpoint.py`): its config, model and EMA, and, unless
--reset_optim, the optimizer state; --reset_wandb starts a new run id.
Every --numSaveSteps steps and at the end the trainer writes a checkpoint
into --saveDir.

--remat_policy (nothing, dots, attn, dots_attn) and --scan_blocks as in
the JAX package (models/mmdit.py). A loaded checkpoint's config may be any
model variant; --text_loss_weight W > 0 trains a `text_loss` model's text
head beside the velocity (a model without it ignores the weight, as the
JAX trainer does).

Multi-process (`--multihost`): one process per device, each running this
same command; `parallel.multihost.initialize` makes the process group
(NCCL on the card, gloo with --device cpu) from --coordinator_address /
--num_processes / --process_id, or from torchrun's environment:
  torchrun --nproc_per_node N -m sd3_torch.training.train --multihost
      --dp D --fsdp F --tp T ...  (the flags continue one line)
and each process trains on cuda:LOCAL_RANK over the dp x fsdp x tp mesh
(parallel/, training/trainer.py). --batchSize is the global micro-batch:
each data rank (dp x fsdp; the tp ranks of a data group load the same rows)
loads batchSize / (dp * fsdp) rows with the data seed seed + data rank, and
the parquet feed shares one bucket sequence (bucket_seed = seed) with each
bucket's rows split by data rank. --dp / --fsdp / --tp that do not cover
the world (a world of one without --multihost) are refused.

Published stage hyperparameters (reference train.py:9-80 / README.md:209-291):
  stage1: 256px  batch 140/chip-equivalent  acc 2
  stage2: 512px  batch 40                   acc 2
  stage3: 1024px batch 13                   acc 2
"""

from __future__ import annotations

import argparse
import dataclasses
import os

def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--preset", choices=["tiny", "published"], default="tiny")
    p.add_argument("--stage_res", type=int, default=256)
    p.add_argument("--batchSize", type=int, default=8)
    p.add_argument("--accumulation_steps", type=int, default=2)
    p.add_argument("--totalSteps", type=int, default=100)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=1000)
    p.add_argument("--use_lr_scheduler", action="store_true")
    p.add_argument("--ema_update_freq", type=int, default=100)
    p.add_argument("--ema_decay", type=float, default=0.99)
    p.add_argument("--ema_on_host", action="store_true",
                   help="keep the fp32 EMA in pinned host RAM, combined on "
                        "a background thread (frees ~5GB of device memory "
                        "at 1.2B)")
    p.add_argument("--null_prob_pooled", type=float, default=0.1)
    p.add_argument("--null_prob_gemma", type=float, default=0.316)
    p.add_argument("--null_prob_bert", type=float, default=0.316)
    p.add_argument("--text_loss_weight", type=float, default=0.0)
    p.add_argument("--bf16_grad_accum", action="store_true",
                   help="carry gradient accumulation in bf16")
    p.add_argument("--bf16_grads", action="store_true",
                   help="bf16 gradient tree at accumulation 1 (needs "
                        "--low_mem_optimizer)")
    p.add_argument("--low_mem_optimizer", action="store_true",
                   help="bf16 Adam moments, the clip folded into the update")
    p.add_argument("--fused_optimizer", action="store_true",
                   help="single-pass AdamW applied in place; implies "
                        "--low_mem_optimizer")
    p.add_argument("--moments_8bit", action="store_true",
                   help="blockwise fp8-e4m3 Adam moments (training/optim.py "
                        "adamw_8bit); checkpoints stay bf16-canonical. "
                        "Implies --low_mem_optimizer")
    p.add_argument("--scan_blocks", action="store_true",
                   help="the non-last blocks' parameters stacked (the JAX "
                        "scan layout); checkpoints stay per-block")
    p.add_argument("--split_accumulation", action="store_true",
                   help="the JAX package's per-micro-batch dispatch; eager "
                        "PyTorch runs it as the accumulation loop. Needs "
                        "--fused_optimizer/--moments_8bit")
    p.add_argument("--remat_policy", default="nothing",
                   choices=["nothing", "dots", "attn", "dots_attn"])
    p.add_argument("--no_remat", action="store_true",
                   help="store block activations instead of recomputing")
    p.add_argument("--numSaveSteps", type=int, default=1000)
    p.add_argument("--saveDir", default="checkpoints/run")
    p.add_argument("--loadDir", default=None)
    p.add_argument("--loadStep", type=int, default=None)
    p.add_argument("--reset_optim", action="store_true",
                   help="do not restore optimizer state on resume "
                        "(stage transitions, reference README.md:296-303)")
    p.add_argument("--reset_wandb", action="store_true")
    p.add_argument("--log_steps", type=int, default=10)
    p.add_argument("--wandb_name", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the kernels' plain versions)")
    # data
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--data_parquet_folder", default=None)
    p.add_argument("--bucket_indices_path", default=None)
    p.add_argument("--stub_encoders", action="store_true")
    p.add_argument("--encoder_weights", default=None)
    p.add_argument("--ring_workers", type=int, default=0)
    p.add_argument("--data_threads", type=int, default=2)
    p.add_argument("--prefetch_batches", type=int, default=1)
    # mesh
    p.add_argument("--dp", type=int, default=1)
    p.add_argument("--fsdp", type=int, default=-1)
    p.add_argument("--tp", type=int, default=1)
    p.add_argument("--multihost", action="store_true")
    p.add_argument("--coordinator_address", default=None)
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    from sd3_torch.parallel import MeshConfig, multihost
    mesh = MeshConfig(args.dp, args.fsdp, args.tp)
    device = args.device
    if args.multihost:
        device = multihost.initialize(args.coordinator_address,
                                      args.num_processes, args.process_id,
                                      device=args.device)
    else:
        mesh.resolve(1)   # a mesh past one device needs --multihost
    from sd3_torch.config import published_config, tiny_config
    from sd3_torch.data.pipeline import synthetic_batch_iter
    from sd3_torch.training import checkpoint as ckpt
    from sd3_torch.training.trainer import Trainer, TrainConfig
    from sd3_torch.weights import state_dict_from_jax

    cfg = (published_config(args.stage_res) if args.preset == "published"
           else tiny_config(max_res=args.stage_res,
                            max_res_orig=args.stage_res))
    params, ema = None, None
    if args.loadDir and args.loadStep:
        s = args.loadStep
        cfg = ckpt.load_config(args.loadDir, f"model_params_{s}s.json",
                               update_max_res=args.stage_res)
        if args.reset_wandb:
            cfg = cfg.replace(wandb_id=None)
        params = state_dict_from_jax(
            ckpt.load_artifact(args.loadDir, f"model_{s}s.msgpack"),
            cfg.patch_size)
        if os.path.exists(os.path.join(args.loadDir,
                                       f"model_ema_{s}s.msgpack")):
            ema = state_dict_from_jax(
                ckpt.load_artifact(args.loadDir, f"model_ema_{s}s.msgpack"),
                cfg.patch_size)

    tcfg = TrainConfig(
        batch_size=args.batchSize,
        accumulation_steps=args.accumulation_steps,
        total_steps=args.totalSteps,
        lr=args.lr, warmup_steps=args.warmup_steps,
        use_lr_scheduler=args.use_lr_scheduler,
        ema_update_freq=args.ema_update_freq, ema_decay=args.ema_decay,
        ema_on_host=args.ema_on_host,
        null_prob_pooled=args.null_prob_pooled,
        null_prob_gemma=args.null_prob_gemma,
        null_prob_bert=args.null_prob_bert,
        text_loss_weight=args.text_loss_weight,
        bf16_grad_accum=args.bf16_grad_accum,
        bf16_grads=args.bf16_grads,
        low_mem_optimizer=(args.low_mem_optimizer or args.fused_optimizer
                           or args.moments_8bit),
        fused_optimizer=args.fused_optimizer,
        moments_8bit=args.moments_8bit,
        split_accumulation=args.split_accumulation,
        scan_blocks=args.scan_blocks,
        remat_policy=args.remat_policy,
        remat_blocks=not args.no_remat,
        log_steps=args.log_steps, num_save_steps=args.numSaveSteps,
        save_dir=args.saveDir, seed=args.seed, mesh=mesh,
    )
    trainer = Trainer(cfg, tcfg, params=params, ema=ema, device=device,
                      wandb_name=args.wandb_name)
    if args.loadDir and args.loadStep and not args.reset_optim:
        if os.path.exists(os.path.join(
                args.loadDir, f"optim_{args.loadStep}s.msgpack")):
            trainer.restore_optimizer(args.loadDir, args.loadStep)

    # each data rank loads its rows of the global batch (the tp ranks of a
    # data group the same ones)
    rank, n_data = ((0, 1) if trainer.mesh is None else
                    (trainer.mesh.data_rank, trainer.mesh.n_data))
    if tcfg.batch_size % n_data:
        raise ValueError(f"--batchSize {tcfg.batch_size} does not split over "
                         f"{n_data} data ranks")
    local_bs, local_seed = tcfg.batch_size // n_data, args.seed + rank
    if args.synthetic or not args.data_parquet_folder:
        it = synthetic_batch_iter(cfg, local_bs, tcfg.accumulation_steps,
                                  args.stage_res, args.stage_res,
                                  seed=local_seed)
    else:
        from sd3_torch.data.encoded import (encoded_batch_iter,
                                            prefetch_iterator)
        # over a mesh one bucket sequence (the same batch shapes on every
        # rank), each bucket's rows split by data rank
        it = encoded_batch_iter(cfg, dataclasses.replace(
                                    tcfg, batch_size=local_bs),
                                args.data_parquet_folder,
                                args.bucket_indices_path,
                                stub=args.stub_encoders,
                                weights_dir=args.encoder_weights,
                                ring_workers=args.ring_workers,
                                seed=local_seed,
                                num_threads=args.data_threads,
                                bucket_seed=(None if trainer.mesh is None
                                             else args.seed),
                                shard_index=rank, shard_count=n_data,
                                device=trainer.device)
        if args.prefetch_batches > 0:
            # decode, the encoders' launches and the placement of group N+1
            # overlap step N
            it = prefetch_iterator(it, depth=args.prefetch_batches,
                                   map_fn=trainer.shard_batch)
        it = _print_shapes(it, trainer)
    try:
        final_step = trainer.train(it)
    finally:
        close = getattr(it, "close", None)
        if close is not None:  # stop the feed's threads and processes
            close()
    if trainer.saved_step != final_step:  # train() saved this step already
        trainer.save()
    print(f"training done at step {final_step}")
    if args.multihost:
        import torch.distributed as dist
        dist.destroy_process_group()
    return trainer


def _print_shapes(it, trainer):
    """`it`, printing each step's batch shape (its bucket) as it passes;
    closing this closes `it`."""
    try:
        for batch in it:
            acc, b, ch, h, w = batch["x0"].shape
            print(f"step {trainer.step + 1}: bucket {h * 8}x{w * 8}, x0 "
                  f"{(acc, b, ch, h, w)}", flush=True)
            yield batch
    finally:
        it.close()


if __name__ == "__main__":
    main()
