"""The rectified-flow trainer (JAX counterpart: sd3_tpu/training/trainer.py;
reference src/model_trainer.py).

One optimizer step: for each of the batch's `accumulation_steps`
micro-batches, the flow noise (t, ε and the null-conditioning masks,
`draw_noise`) is drawn, then the velocity loss and its gradient are taken
through an `MMDiT(..., fused_attn=False)`: the general attention path, whose
flash attention runs kernels K5, K6a and K6b on the card, and with
`remat_blocks` each block recomputed in the backward. The gradients are
summed over the micro-batches, averaged, and one AdamW update follows
(`training/optim.py`); every `ema_update_freq` steps the fp32 EMA on the
device follows. The noise draw is separate from the loss: `train_step`
takes the noise as an argument, so a run can be driven with given draws.

As in the JAX package:
- AdamW lr=1e-4 eps=1e-8 wd=0.01 betas=(0.9, 0.999), global-norm clip 1.0,
  warmup-constant or warmup-cosine schedule (reference
  model_trainer.py:25-41, 260-267);
- `low_mem_optimizer`: bf16 moments with the clip folded in; without it the
  optax chain (outer clip, fp32 moments);
- `bf16_grads` (accumulation 1): the gradient tree in bf16;
- `precast_params` (with `bf16_grads`, `low_mem_optimizer` and a bf16
  model): the model holds a bf16 copy of every parameter, refreshed from the
  fp32 masters once per step, and the gradient is taken with respect to it;
  otherwise the model holds the fp32 masters and casts each weight at use;
- accumulation > 1: gradients summed in fp32, or bf16 with
  `bf16_grad_accum`. `split_accumulation` is the JAX package's way of
  keeping each compiled graph small; eager PyTorch has no graph to split,
  and its math (no precast, a bf16 sum) is this loop's, which takes it;
- `moments_8bit`: `adamw_8bit`, blockwise fp8-e4m3 moments, one in-place
  pass as the fused optimizer;
- `ema_on_host`: the fp32 EMA in pinned host RAM. Every `ema_update_freq`
  steps the fp32 masters are copied to pinned staging buffers on the
  step's stream (ordered before the next step's in-place update), and a
  background thread waits for the copies and combines them, with the same
  arithmetic as the device EMA. The combine is joined before the next one,
  before every save and every read (`ema_state`).
- `save()` writes the six-artifact checkpoint of `training/checkpoint.py`
  (the JAX trees; the 8-bit state in its canonical bf16 form), and
  `restore_optimizer` reads the optim artifact of either package.
- `remat_policy` (with `remat_blocks`): what each block's recompute keeps,
  "nothing", "dots", "attn" or "dots_attn" (models/mmdit.py);
- `scan_blocks`: the model holds the non-last blocks' parameters stacked
  (models/mmdit.py). Everything else stays canonical, as the JAX trainer
  converts at its I/O boundary (sd3_tpu/training/trainer.py:437-452,
  540-560): the optimizer, its state, the EMA, `params`, `save()` and
  `restore_optimizer` see the unrolled model's names over views of the
  stacks (the views share their storage), so a scan run's state and its
  six artifacts are bit for bit an unrolled run's.

- the text loss (a model with `text_loss` and `text_loss_weight` > 0):
  each micro-batch also draws a text mask, the model reads the masked text
  and returns its text prediction, and the loss is the image loss plus the
  weight times the text reconstruction loss; the metrics add `image_loss`
  and `text_loss` (sd3_tpu/training/trainer.py:160-180). A `text_loss` model
  with weight 0 is refused: the JAX step would take its (velocity, text)
  pair for the velocity.

Over a mesh (`TrainConfig.mesh`, a `parallel.MeshConfig`, with a process
group made by `parallel.multihost.initialize`), one process per device, as
the JAX trainer's GSPMD step (sd3_tpu/training/trainer.py:424-468, 563-606,
757-767) but with the layouts of parallel/sharding.py written out:
- the model is built whole and initialized (or loaded) alike on every rank,
  then cut to this rank's tp part (`TrainMesh.apply_tp`);
- under fsdp the fp32 masters, the EMA and the optimizer moments are this
  rank's shards, all-gathered into the model's parameters at the start of
  each step (in bf16 under precast);
- `shard_batch` keeps this data rank's rows of a global batch (a batch of
  `batch_size` rows); every rank draws the whole global micro-batch's noise
  from the shared `seed` generator and keeps its rows, so any mesh gives the
  one-process step's numbers and the generators stay in step (a given
  `noise` is the global draw);
- the gradients are averaged over the data ranks (dp x fsdp) in fp32, the
  clip takes the whole gradient's norm, and the metrics are reduced, so
  every rank returns the global loss and grad norm;
- `save()` gathers whole tensors on every rank and the main process alone
  writes the six artifacts; `restore_optimizer` loads into the shards;
  wandb and the metrics file are the main process's; `ema_on_host` takes a
  world of one (the JAX trainer asserts one process).
Without a process group the default MeshConfig() is the one-device path.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.distributed as dist

from sd3_torch import resolve_device, to_device, torch_dtype
from sd3_torch.config import MMDiTConfig
from sd3_torch.models.mmdit import MMDiT, from_scan_params, to_scan_params
from sd3_torch.parallel.mesh import MeshConfig, make_mesh
from sd3_torch.parallel.multihost import is_main_process
from sd3_torch.parallel.sharding import TrainMesh
from sd3_torch.training import checkpoint, flow
from sd3_torch.training.optim import (Adam8bitState, GradientTransformation,
                                      adamw, adamw_8bit, adamw_low_mem,
                                      apply_updates, dequantize_8bit,
                                      from_artifact, fused_adamw_low_mem,
                                      global_norm_f32, leaf_groups,
                                      to_artifact)
from sd3_torch.utils.logging import MetricsLogger
from sd3_torch.weights import jax_tree_from_state_dict


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's TrainConfig: the same fields and defaults (see
    sd3_tpu/training/trainer.py:43-130 for what each does)."""
    batch_size: int = 16                 # per micro-step, global
    accumulation_steps: int = 2
    total_steps: int = 1_000
    lr: float = 1e-4
    warmup_steps: int = 1000
    use_lr_scheduler: bool = False       # False: constant-after-warmup
    grad_clip: float = 1.0
    ema_update_freq: int = 100
    ema_decay: float = 0.99
    track_ema: bool = True
    ema_on_host: bool = False
    null_prob_pooled: float = 0.1
    null_prob_gemma: float = 0.316
    null_prob_bert: float = 0.316
    text_loss_weight: float = 0.0
    weigh_loss: bool = False
    log_steps: int = 10
    num_save_steps: int = 1000
    low_mem_optimizer: bool = False
    bf16_grad_accum: bool = False
    bf16_grads: bool = False
    precast_params: bool = True
    remat_policy: str = "nothing"
    remat_blocks: bool = True
    fused_optimizer: bool = False
    moments_8bit: bool = False
    split_accumulation: bool = False
    scan_blocks: bool = False
    save_dir: str = "checkpoints/run"
    seed: int = 0
    # over the process group, when there is one (see the module note)
    mesh: MeshConfig = MeshConfig()


# ---- learning-rate schedules: optax's, in fp32 as optax computes them ----

def _linear_schedule(init: float, end: float, steps: int) -> Callable:
    """optax.linear_schedule."""
    if steps <= 0:
        return lambda count: float(np.float32(init))

    def schedule(count):
        c = np.float32(min(max(count, 0), steps))
        frac = np.float32(1.0) - c / np.float32(steps)
        return float(np.float32(init - end) * frac + np.float32(end))
    return schedule


def _cosine_decay_schedule(init: float, decay_steps: int,
                           alpha: float) -> Callable:
    """optax.cosine_decay_schedule, exponent 1."""
    if not decay_steps > 0:
        raise ValueError(f"cosine decay needs decay_steps > 0, got "
                         f"{decay_steps}")

    def schedule(count):
        c = np.float32(min(count, decay_steps))
        cos = np.float32(0.5) * (np.float32(1.0) + np.cos(
            np.float32(np.pi) * c / np.float32(decay_steps)))
        return float(np.float32(init)
                     * (np.float32(1 - alpha) * cos + np.float32(alpha)))
    return schedule


def _join_schedules(schedules, boundaries) -> Callable:
    """optax.join_schedules."""
    def schedule(step):
        out = schedules[0](step)
        for boundary, s in zip(boundaries, schedules[1:]):
            if step >= boundary:
                out = s(step - boundary)
        return out
    return schedule


def make_lr_schedule(cfg: TrainConfig) -> Callable[[int], float]:
    """count -> learning rate: linear warmup from 0 to cfg.lr, then constant,
    or (use_lr_scheduler) cosine decay to 0 at total_steps, as
    optax.warmup_cosine_decay_schedule."""
    warm = _linear_schedule(0.0, cfg.lr, cfg.warmup_steps)
    if cfg.use_lr_scheduler:
        decay_steps = max(cfg.total_steps, cfg.warmup_steps + 1)
        alpha = 0.0  # end value 0 over the peak
        return _join_schedules(
            [warm, _cosine_decay_schedule(cfg.lr, decay_steps - cfg.warmup_steps,
                                          alpha)], [cfg.warmup_steps])
    lr = float(np.float32(cfg.lr))
    return _join_schedules([warm, lambda count: lr], [cfg.warmup_steps])


def make_optimizer(cfg: TrainConfig, norm=global_norm_f32
                   ) -> GradientTransformation:
    """adamw_low_mem with the clip folded in, or the optax chain; `norm`
    the gradient's global norm."""
    if cfg.low_mem_optimizer:
        return adamw_low_mem(make_lr_schedule(cfg), b1=0.9, b2=0.999,
                             eps=1e-8, weight_decay=0.01,
                             clip_norm=cfg.grad_clip, norm=norm)
    return adamw(make_lr_schedule(cfg), b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, clip_norm=cfg.grad_clip, norm=norm)


class Noise(NamedTuple):
    """One micro-batch's flow draws: t (B,), ε like x0, three (B,) masks,
    and under the text loss the drawn (B, S) text mask
    (`flow.text_mask_draw`, before the null flags gate it)."""
    t: torch.Tensor
    eps: torch.Tensor
    null_pooled: torch.Tensor
    null_gemma: torch.Tensor
    null_bert: torch.Tensor
    text_mask: torch.Tensor | None = None

    def to(self, device) -> "Noise":
        """The draws on `device` (no text mask stays None)."""
        return Noise(*(None if t is None else t.to(device) for t in self))


def draw_noise(generator: torch.Generator, x0: torch.Tensor,
               tcfg: TrainConfig, text_shape=None,
               batch: int | None = None) -> Noise:
    """t, ε and the null masks of one micro-batch, in the JAX draw order,
    for `batch` rows (default x0's) shaped like x0's; with `text_shape`
    (B, S) the text mask too."""
    b = x0.shape[0] if batch is None else batch
    t = flow.sample_t(generator, b)
    eps = torch.randn((b, *x0.shape[1:]), generator=generator,
                      device=x0.device, dtype=x0.dtype)
    masks = flow.null_masks(generator, b, tcfg.null_prob_pooled,
                            tcfg.null_prob_gemma, tcfg.null_prob_bert)
    text_mask = (None if text_shape is None
                 else flow.text_mask_draw(generator, *text_shape))
    return Noise(t, eps, *masks, text_mask)


def uses_text_loss(cfg: MMDiTConfig, tcfg: TrainConfig) -> bool:
    """The step takes the text loss (sd3_tpu/training/trainer.py:160); a
    text_loss model without a weight is refused (see the module note)."""
    if cfg.text_loss and not tcfg.text_loss_weight > 0.0:
        raise ValueError("a text_loss model trains with text_loss_weight > 0 "
                         "(it returns (velocity, text prediction))")
    return cfg.text_loss


def make_micro_loss(model: MMDiT, tcfg: TrainConfig) -> Callable:
    """micro_loss(x0, text, pooled, noise) -> (loss, metrics detached:
    "loss", and under the text loss "image_loss" and "text_loss")."""
    cfg = model.cfg
    text_loss = uses_text_loss(cfg, tcfg)

    def micro_loss(x0, text, pooled, noise: Noise):
        x_t = flow.noised(x0, noise.t, noise.eps)
        nulls = (noise.null_pooled, noise.null_gemma, noise.null_bert)
        if not text_loss:
            v_pred = model(x_t, noise.t, text, pooled, *nulls)
            loss = flow.velocity_loss(v_pred, x0, noise.eps, noise.t,
                                      tcfg.weigh_loss)
            return loss, {"loss": loss.detach()}
        if noise.text_mask is None:
            raise ValueError("the text loss needs the noise's text_mask")
        tl = flow.text_loss_batch(text, noise.text_mask, noise.null_gemma,
                                  noise.null_bert, cfg.text_tokens_per_encoder)
        v_pred, txt_pred = model(x_t, noise.t, tl.text_in, pooled, *nulls)
        img_loss = flow.velocity_loss(v_pred, x0, noise.eps, noise.t,
                                      tcfg.weigh_loss)
        txt_loss = flow.text_recon_loss(txt_pred, tl)
        loss = img_loss + tcfg.text_loss_weight * txt_loss
        return loss, {"loss": loss.detach(), "image_loss": img_loss.detach(),
                      "text_loss": txt_loss.detach()}

    return micro_loss


@torch.no_grad()
def ema_update(ema: dict, params: dict, decay: float) -> dict:
    """ema = decay * ema + (1 - decay) * params, in place."""
    for names in leaf_groups(list(ema), ema):
        e = [ema[n] for n in names]
        torch._foreach_mul_(e, decay)
        torch._foreach_add_(e, torch._foreach_mul(
            [params[n].to(ema[n].dtype) for n in names], 1.0 - decay))
    return ema


def _cast_parameters(model: torch.nn.Module, dtype: torch.dtype) -> dict:
    """Give `model` a copy of every parameter in `dtype`; returns the
    original tensors, {name: fp32 master}, detached."""
    owners = {}
    for mod_name, mod in model.named_modules():
        for leaf, _ in mod.named_parameters(recurse=False):
            owners[f"{mod_name}.{leaf}" if mod_name else leaf] = (mod, leaf)
    masters = {}
    for name, p in list(model.named_parameters()):
        mod, leaf = owners[name]
        masters[name] = p.detach()
        setattr(mod, leaf, torch.nn.Parameter(p.detach().to(dtype)))
    return masters


class Trainer:
    """The step loop, the optimizer, the EMA and logging, on one device, or
    on this rank's device of a mesh (see the module note).

    `params`: a state_dict of the model (fp32 masters), or None for seeded
    random weights (`MMDiT.init_weights` from `tcfg.seed`); `opt_state` and
    `ema`: states to start from (dicts keyed like `params`, whole leaves).
    The model lives on `device`, "cuda" unless the caller asks for the
    CPU."""

    def __init__(self, cfg: MMDiTConfig, tcfg: TrainConfig, params=None,
                 device="cuda", log_dir: str | None = None,
                 wandb_name: str | None = None, use_wandb: bool = True,
                 opt_state=None, ema=None):
        grouped = dist.is_available() and dist.is_initialized()
        world = dist.get_world_size() if grouped else 1
        mesh_cfg = tcfg.mesh if tcfg.mesh is not None else MeshConfig()
        mesh_cfg.resolve(world)   # raises when it does not cover the world
        if tcfg.ema_on_host and world > 1:
            raise ValueError("ema_on_host takes one process: the EMA's "
                             "shards are on the devices of a mesh (use the "
                             "device EMA)")
        fused = tcfg.fused_optimizer or tcfg.moments_8bit
        if fused and not tcfg.low_mem_optimizer:
            raise ValueError("fused_optimizer implies bf16-moment AdamW "
                             "(low_mem_optimizer)")
        if tcfg.split_accumulation and not fused:
            raise ValueError("split_accumulation needs the fused optimizer "
                             "path (fused_optimizer)")
        self.cfg, self.tcfg = cfg, tcfg
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            # the index tensors carry, so shard_batch can compare devices
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.model = MMDiT(cfg, device=self.device, fused_attn=False,
                           remat_blocks=tcfg.remat_blocks,
                           remat_policy=tcfg.remat_policy,
                           scan_blocks=tcfg.scan_blocks)
        self._micro_loss = make_micro_loss(self.model, tcfg)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(tcfg.seed)
        self._num_scan = self.model.num_scan
        if params is None:
            self.model.init_weights(self.generator)
        else:
            self.model.load_state_dict(
                to_scan_params(params, self._num_scan, self.model.scan_pair)
                if self._num_scan else params, strict=True)
        self.mesh = None
        if grouped:
            shapes = {k: v.shape for k, v in
                      self.model.canonical_parameters().items()}
            self.mesh = TrainMesh(make_mesh(mesh_cfg, self.device.type),
                                  shapes, cfg.num_heads, self.device)
            self.mesh.apply_tp(self.model)
        # under fsdp the masters are shards, gathered into the model
        self._gather = self.mesh is not None and self.mesh.sharded

        self._split = tcfg.split_accumulation and tcfg.accumulation_steps > 1
        self._precast = (tcfg.precast_params and tcfg.bf16_grads
                         and tcfg.low_mem_optimizer and not self._split
                         and torch_dtype(cfg.dtype) == torch.bfloat16)
        # the fp32 masters in the model's layout, and (_params) by the
        # unrolled model's names, which the optimizer, the EMA and the
        # checkpoints take
        if self._precast:
            self._masters = _cast_parameters(self.model, torch.bfloat16)
        else:
            self._masters = dict(self.model.named_parameters())
        self._params = self._canonical(
            {k: v.detach() for k, v in self._masters.items()}
            if self._num_scan else self._masters)
        self._compute = dict(self.model.named_parameters())
        if self._gather:
            self._params = {k: self.mesh.fsdp_shard(k, v.detach().float())
                            for k, v in self._params.items()}
            self._masters = None
            with torch.no_grad():
                self._compute_views = self._canonical(self._compute)

        self.ema = None
        self._ema_host = None
        self._ema_thread = None
        if tcfg.track_ema:
            init = self._params
            if ema is not None:   # the host EMA takes whole leaves as given
                init = ema if tcfg.ema_on_host else self._local(ema)
            if tcfg.ema_on_host:
                pin = self.device.type == "cuda"
                self._ema_host = {k: _pinned_copy(v, pin)
                                  for k, v in init.items()}
                self._ema_stage = {k: torch.empty(v.shape, pin_memory=pin)
                                   for k, v in self._ema_host.items()}
            else:
                self.ema = {k: torch.as_tensor(v).detach().to(
                    self.device, torch.float32, copy=True)
                    for k, v in init.items()}

        schedule = make_lr_schedule(tcfg)
        self._norm = (global_norm_f32 if self.mesh is None
                      else self.mesh.global_norm)
        if fused:
            kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
                      clip_norm=tcfg.grad_clip, norm=self._norm)
            if tcfg.moments_8bit:
                init_fn, self._fused_update = adamw_8bit(
                    schedule, blocks=self.mesh, **kw)
            else:
                init_fn, self._fused_update = fused_adamw_low_mem(schedule,
                                                                  **kw)
            self.optimizer = None
        else:
            self.optimizer = make_optimizer(tcfg, self._norm)
            init_fn = self.optimizer.init
        self.opt_state = init_fn(self._params)
        if opt_state is not None:
            if tcfg.moments_8bit:
                raise ValueError("an 8-bit trainer resumes through "
                                 "restore_optimizer (the canonical artifact)")
            on_dev = lambda d: {k: v.to(self.opt_state.mu[k].dtype)
                                for k, v in self._local(d).items()}
            self.opt_state = type(self.opt_state)(
                int(opt_state.count), on_dev(opt_state.mu), on_dev(opt_state.nu))

        self.step = cfg.start_step
        self.saved_step = None   # the step of the last save()
        self.logger = MetricsLogger(log_dir or tcfg.save_dir,
                                    run_name=wandb_name, run_id=cfg.wandb_id,
                                    use_wandb=use_wandb,
                                    main=is_main_process())

    @property
    def params(self) -> dict:
        """The fp32 master parameters, {state-dict name of the unrolled
        model: tensor} (under scan_blocks, views of the stacks; over a mesh,
        this rank's shards: `gather` gives whole leaves)."""
        return self._params

    def _local(self, tree: dict) -> dict:
        """This rank's fp32 shards of a dict of whole leaves, on the
        device (the leaves themselves without a mesh)."""
        on_dev = {k: torch.as_tensor(v).detach().to(self.device,
                                                    torch.float32)
                  for k, v in tree.items()}
        if self.mesh is None:
            return on_dev
        return {k: self.mesh.shard(k, v) for k, v in on_dev.items()}

    def gather(self, tree: dict) -> dict:
        """Whole leaves of a dict of this rank's shards (`params`,
        `ema_state()`, a state's moments): a collective over the mesh,
        every rank calling it; the dict itself without a mesh."""
        return tree if self.mesh is None else self.mesh.gather_all(tree)

    def _canonical(self, d: dict) -> dict:
        """A dict in the model's layout by the unrolled model's names."""
        return (from_scan_params(d, self._num_scan, self.model.scan_pair)
                if self._num_scan else d)

    def _global_rows(self, n: int) -> bool:
        """A batch axis of n rows is the global micro-batch, which this data
        rank cuts to its rows (over a mesh of more than one data rank)."""
        return (self.mesh is not None and self.mesh.n_data > 1
                and n == self.tcfg.batch_size)

    def shard_batch(self, batch: dict) -> dict:
        """Place a host batch (numpy arrays or tensors, the batch on axis 1)
        on the trainer's device: through pinned memory, without waiting,
        onto a card. Over a mesh a global batch (`batch_size` rows) is cut
        to this data rank's rows first; a batch of its rows passes, as do
        tensors already on the device."""
        out = {}
        for k, v in batch.items():
            if self._global_rows(v.shape[1]):
                v = self.mesh.rows(torch.as_tensor(v), 1)
            out[k] = to_device(v, self.device)
        return out

    def _noise_rows(self, noise: Noise) -> Noise:
        """This data rank's rows of a global draw (a local one passes)."""
        if not self._global_rows(noise.t.shape[0]):
            return noise
        return Noise(*(None if x is None else self.mesh.rows(x)
                       for x in noise))

    def _micro_grads(self, batch, noise, i):
        for p in self._compute.values():
            p.grad = None
        loss, metrics = self._micro_loss(batch["x0"][i], batch["text"][i],
                                         batch["pooled"][i], noise[i])
        loss.backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in self._compute.items()}
        return grads, metrics

    def gradients(self, batch: dict, noise: list[Noise]):
        """(gradient dict by the unrolled model's names, metrics) of one
        optimizer step on `batch` with the given draws, averaged over the
        micro-batches as the JAX train steps average them; no update is
        made. Over a mesh `batch` and `noise` may be global (`shard_batch`),
        the gradient is this rank's shard of the average over the data
        ranks, in fp32, and the metrics are global."""
        batch = self.shard_batch(batch)
        noise = [self._noise_rows(n) for n in noise]
        g, metrics = self._local_gradients(batch, noise)
        if self.mesh is not None:
            g = self.mesh.reduce_grads(g)
            metrics = self.mesh.reduce_metrics(metrics)
        return g, metrics

    def _local_gradients(self, batch: dict, noise: list[Noise]):
        """`gradients` of this rank's rows and model part."""
        tcfg = self.tcfg
        if self._gather:
            self.mesh.gather_into(self._compute_views, self._params)
        elif self._precast:
            with torch.no_grad():
                torch._foreach_copy_(list(self._compute.values()),
                                     list(self._masters.values()))
        acc = len(noise)
        if acc == 1:
            g, metrics = self._micro_grads(batch, noise, 0)
            if tcfg.bf16_grads and not self._precast:
                if not tcfg.low_mem_optimizer:
                    raise ValueError("bf16_grads requires low_mem_optimizer "
                                     "(per-leaf upcast)")
                g = {k: v.to(torch.bfloat16) for k, v in g.items()}
            return self._canonical(g), metrics
        acc_dtype = (torch.bfloat16 if tcfg.bf16_grad_accum or self._split
                     else torch.float32)
        g_sum, m_sum = None, None
        for i in range(acc):
            g, metrics = self._micro_grads(batch, noise, i)
            # the JAX carry starts at zeros: 0 + g rounds as the cast does
            gi = [v.to(acc_dtype) for v in g.values()]
            if g_sum is None:
                g_sum, m_sum = gi, metrics
            else:
                torch._foreach_add_(g_sum, gi)
                m_sum = {k: m_sum[k] + metrics[k] for k in m_sum}
        keep = (self.optimizer is None
                or (tcfg.bf16_grad_accum and tcfg.low_mem_optimizer))
        g = {n: (x if keep else x.float()) / acc for n, x in zip(g, g_sum)}
        return self._canonical(g), {k: v / acc for k, v in m_sum.items()}

    def train_step(self, batch: dict, noise: list[Noise] | None = None
                   ) -> dict:
        """One optimizer step on `batch` (x0 (acc, B, C, H, W), text
        (acc, B, S, D), pooled (acc, B, P), on the device); `noise`: one
        Noise per micro-batch, drawn from the trainer's generator when None
        (over a mesh the global micro-batch's draw, see the module note).
        Returns {"loss", "grad_norm"} as 0-d tensors on the device."""
        batch = self.shard_batch(batch)
        if noise is None:
            text = uses_text_loss(self.cfg, self.tcfg)
            rows = batch["x0"].shape[1] * (1 if self.mesh is None
                                           else self.mesh.n_data)
            noise = [draw_noise(self.generator, x0, self.tcfg,
                                text_shape=(rows, tx.shape[1]) if text
                                else None, batch=rows)
                     for x0, tx in zip(batch["x0"], batch["text"])]
        g, metrics = self.gradients(batch, noise)
        if self.optimizer is None:
            _, self.opt_state, gnorm = self._fused_update(g, self.opt_state,
                                                          self._params)
        else:
            updates, self.opt_state = self.optimizer.update(
                g, self.opt_state, self._params)
            apply_updates(self._params, updates)
            gnorm = self._norm(g)
        for p in self._compute.values():
            p.grad = None
        metrics["grad_norm"] = gnorm
        self.step += 1
        if self.step % self.tcfg.ema_update_freq == 0:
            if self._ema_host is not None:
                self._ema_host_update()
            elif self.ema is not None:
                ema_update(self.ema, self._params, self.tcfg.ema_decay)
        return metrics

    def _ema_host_update(self):
        """Copy the fp32 masters to the pinned staging buffers on this
        step's stream (the next step's in-place update is ordered after the
        copies), then combine them into the host EMA on a background thread
        once the copies are done. Joins the last combine first."""
        self._ema_join()
        with torch.no_grad():
            for k, p in self._params.items():
                self._ema_stage[k].copy_(p, non_blocking=True)
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        decay = self.tcfg.ema_decay
        errors = []

        def combine():
            try:
                if done is not None:
                    done.synchronize()
                ema_update(self._ema_host, self._ema_stage, decay)
            except Exception as e:  # re-raised by _ema_join
                errors.append(e)

        self._ema_thread = threading.Thread(target=combine, daemon=True)
        self._ema_thread.start()
        self._ema_errors = errors

    def _ema_join(self):
        """Wait for the last host-EMA combine; raise what it raised."""
        if self._ema_thread is not None:
            self._ema_thread.join()
            self._ema_thread = None
            if self._ema_errors:
                raise RuntimeError("the host EMA combine failed") \
                    from self._ema_errors[0]

    def ema_state(self) -> dict | None:
        """The fp32 EMA, {state-dict name: tensor} (on the host under
        ema_on_host, after joining its combine), or None."""
        self._ema_join()
        return self._ema_host if self._ema_host is not None else self.ema

    def train(self, batch_iter, total_steps: int | None = None) -> int:
        """Steps until `total_steps` (default tcfg.total_steps), logging
        every log_steps and saving every num_save_steps."""
        total = total_steps or self.tcfg.total_steps
        t0 = time.time()
        acc_metrics = None
        while self.step < total:
            metrics = self.train_step(self.shard_batch(next(batch_iter)))
            acc_metrics = metrics if acc_metrics is None else {
                k: acc_metrics[k] + v for k, v in metrics.items()}
            if self.step % self.tcfg.log_steps == 0:
                logged = {k: float(v) / self.tcfg.log_steps
                          for k, v in acc_metrics.items()}
                logged["lr"] = make_lr_schedule(self.tcfg)(self.step)
                logged["steps_per_sec"] = (self.tcfg.log_steps
                                           / (time.time() - t0))
                self.logger.log(logged, self.step)
                acc_metrics, t0 = None, time.time()
            if self.step % self.tcfg.num_save_steps == 0:
                self.save()
        return self.step

    def save(self) -> dict[str, str]:
        """Write the six artifacts of this step into tcfg.save_dir (the JAX
        package's checkpoint: the parameter and EMA trees, the optimizer
        artifact, {"step": step}); returns the file names. Over a mesh every
        rank gathers whole tensors and the main process alone writes (the
        others return {})."""
        ema = self.ema_state()
        params, opt = self._params, self.opt_state
        if self.mesh is not None:
            if isinstance(opt, Adam8bitState):
                opt = dequantize_8bit(opt, params, self.mesh)
            opt = type(opt)(opt.count, self.gather(opt.mu),
                            self.gather(opt.nu))
            params = self.gather(params)
            ema = None if ema is None else self.gather(ema)
        self.saved_step = self.step
        if not is_main_process():
            return {}
        names = checkpoint.save_checkpoint(
            self.tcfg.save_dir, self.cfg, jax_tree_from_state_dict(params),
            ema_params=None if ema is None else jax_tree_from_state_dict(ema),
            opt_state=to_artifact(opt, params),
            scheduler_state={"step": self.step}, step=self.step,
            wandb_id=self.logger.run_id)
        print(f"Saving model (step {self.step})")
        return names

    def restore_optimizer(self, load_dir: str, step: int):
        """Load optim_{step}s.msgpack, written by either package for the
        same optimizer (an 8-bit trainer takes the canonical bf16 state),
        into this rank's shards over a mesh."""
        art = checkpoint.load_artifact(load_dir, f"optim_{step}s.msgpack")
        self.opt_state = from_artifact(art, self.opt_state, self._params,
                                       self.cfg.patch_size, mesh=self.mesh)


def _pinned_copy(v, pin: bool) -> torch.Tensor:
    """An fp32 host copy of v, in pinned memory when `pin`."""
    t = torch.as_tensor(v).detach().to("cpu", torch.float32, copy=True)
    return t.pin_memory() if pin else t
