"""The dual-stream MMDiT diffusion transformer (JAX counterpart:
sd3_tpu/models/mmdit.py; reference src/models/diff_model.py:69-346 and
src/blocks/Transformer_Block_Dual.py:14-78):

  y  = t_emb2(sinusoid(t * time_scale)) + cond_MLP(c_pooled)
  c  = [c_proj(s1 * RMSNorm(c[:, :T])) || c_proj2(s2 * RMSNorm(c[:, T:]))]
  x  = patch_emb(PatchEmbed(x_t))
  for each block:
      yb = SiLU(y_proj(y))
      x', c' = JointAttention(AdaLN(x, yb), AdaLN(c, yb))
      x += x' * scale1_x(yb);  c += c' * scale1_c(yb)        (c skipped if last)
      x += MLP(AdaLN(x, yb)) * scale2_x(yb);  c likewise
  out = unpatchify(out_proj(AdaLN(x, y)))                   (fp32)

Kept from the reference: null conditioning zeroes the pooled / Gemma-half /
BERT-half embeddings with independent per-sample masks; the final AdaLN takes
the *unprojected* y; the last block has no text-stream output path.

Every variant of the JAX MMDiT is built from the config: the attention
types, `kv_merge_attn`, `qk_half_dim`, the positional encodings (RoPE1d,
RoPE2d, RoPE2dV2 in the attention, the absolute sin-cos table in `pos_enc`),
the MLP types (`swiglu`, `swiglu_old`, `gelu`). With `text_loss` no block is
`last`, `out_text_proj` maps the text stream back to `text_hidden_dim`, and
the forward returns (velocity, text prediction), both fp32
(sd3_tpu/models/mmdit.py:223, 355, 365-368).

Under quant="int8" the MLP and attention projections are `Int8Linear`s
(ops/quant.py): build the model so to load a quantized state_dict, or
quantize a float model in place with `ops.quant.quantize_model`. The
config's opt-in serving fields, the JAX package's env flags, choose the
block tails' kernels there: `attn_tail` hands the attention half's AdaLN and
gate + residual to JointAttention (K10a / K10b), `mlp_tail_fusion` picks K2
/ K3 ("2d") or K9 ("3d") for the MLP half, `mlp_tail=False` runs the MLP
half unfused around K3, `fused_mlp=False` takes no SwiGLU kernel.

For training, `MMDiT(..., fused_attn=False)` takes the general attention
path (flash attention with its two-kernel backward) as the JAX trainer does,
and `remat_blocks=True` recomputes each block's forward in the backward
(`torch.utils.checkpoint`, the JAX `nn.remat`). `remat_policy` says what the
recompute may keep, as the JAX policies do (sd3_tpu/models/mmdit.py:329-340),
through selective checkpointing at the dispatcher:
- "nothing": keep nothing; the attention forward (K5) runs twice per block;
- "dots" (`dots_with_no_batch_dims_saveable`): keep the outputs of the 2-D
  matmuls, `aten.mm` / `aten.addmm`, which `F.linear` reaches on the
  projections' inputs (not `aten.bmm`, a product with a batch dim);
- "attn" (`save_only_these_names("attn_out")`): keep the outputs of the
  flash op `sd3_torch::flash_fwd`, out and lse, so K5 runs once per block;
  q, k and v are recomputed, as in JAX;
- "dots_attn": both.

`scan_blocks=True` is the JAX scan layout (sd3_tpu/models/mmdit.py:142-227):
the parameters of the first `num_scan_blocks(cfg)` blocks stacked on a
leading axis under `blocks_stack.block.*` (one block module holding the
stacks), the last block unrolled as `blocks.{n-1}.*`. The forward unbinds
each stack once and runs the one block module over the slices
(`torch.func.functional_call`), each block as layer 0, as JAX's scan body
builds them. Under attn_type "both" (softmax on even layers, cosine on odd
ones, two parameter sets) the scan takes blocks in pairs (`scan_pair`):
the even blocks stacked under `blocks_stack.block.*` (layer 0), the odd
ones under `blocks_stack.block_odd.*` (layer 1), `num_scan_blocks` rounded
down to even, a leftover block unrolled. `to_scan_params` /
`from_scan_params` convert state dicts; `canonical_parameters()` gives the
unrolled names over views of the stacks.

The "attn" policies keep the flash op's outputs; the other attention types
are plain PyTorch ops with no single op to keep, so there they recompute
the attention (JAX names their output too): the gradients are the same.

Parameter names are the reference state-dict names (`blocks.3.y_proj.0.weight`,
`blocks.3.attn.query_proj_x.weight`, `pos_enc.proj.weight`, `time_scale`), so
`load_state_dict(strict=True)` takes a reference checkpoint. Parameters may
be stored in fp32 or in the compute dtype; the forward computes in
`cfg.dtype` either way.
"""

from __future__ import annotations

import functools
import math
import re

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from sd3_torch import resolve_device, torch_dtype
from sd3_torch.config import MMDiTConfig
from sd3_torch.ops.attention import JointAttention
from sd3_torch.ops.mlp import MLP
from sd3_torch.ops.norms import AdaLNorm, RMSNorm, linear
from sd3_torch.ops.patch import PatchEmbed, unpatchify
from sd3_torch.ops.quant import Int8Linear
from sd3_torch.ops.time_embed import embed_time


class DualStreamBlock(nn.Module):
    """One MMDiT block (reference Transformer_Block_Dual.py)."""

    def __init__(self, cfg: MMDiTConfig, layer_idx: int, last: bool = False,
                 fused_attn: bool = True, device=None, dtype=None):
        super().__init__()
        dim = cfg.dim
        kw = dict(device=device, dtype=dtype)
        self.last = last
        self.attn_tail, self.mlp_tail = cfg.attn_tail, cfg.mlp_tail
        self.y_proj = nn.Sequential(nn.Linear(dim, dim, bias=True, **kw),
                                    nn.SiLU())
        self.attn = JointAttention(
            dim, cfg.num_heads, attn_type=cfg.attn_type, causal=False,
            positional_encoding=cfg.positional_encoding,
            rope_scale=cfg.rope_scale, kv_merge_attn=cfg.kv_merge_attn,
            qk_half_dim=cfg.qk_half_dim, layer_idx=layer_idx, dual=True,
            last=last, rope2d_interpolate=cfg.rope2d_interpolate,
            quant=cfg.quant, quant_skip=cfg.quant_skip, int8_pv=cfg.int8_pv,
            use_fused=fused_attn, **kw)
        self.norm1_x = AdaLNorm(dim, dim, **kw)
        self.norm1_c = AdaLNorm(dim, dim, **kw)
        self.norm2_x = AdaLNorm(dim, dim, **kw)
        self.scale1_x = nn.Linear(dim, dim, bias=False, **kw)
        self.scale2_x = nn.Linear(dim, dim, bias=False, **kw)
        mlp = dict(act=cfg.MLP_type, quant=cfg.quant,
                   quant_skip=cfg.quant_skip, fused_mlp=cfg.fused_mlp,
                   tail_fusion=cfg.mlp_tail_fusion, **kw)
        self.MLP_x = MLP(dim, cfg.hidden_scale, **mlp)
        if not last:
            self.norm2_c = AdaLNorm(dim, dim, **kw)
            self.scale1_c = nn.Linear(dim, dim, bias=False, **kw)
            self.scale2_c = nn.Linear(dim, dim, bias=False, **kw)
            self.MLP_c = MLP(dim, cfg.hidden_scale, **mlp)

    def forward(self, x, c, y, hw):
        y = F.silu(linear(y, self.y_proj[0]))
        if self.attn_tail != "none" and self.attn.quant == "int8":
            # the attention half's AdaLN and gate + residual owned by the
            # attention, for K10a / K10b (sd3_tpu/models/mmdit.py:80-100)
            sh_x, sc_x = self.norm1_x.modulation(y)
            sh_c, sc_c = self.norm1_c.modulation(y)
            tail = dict(shift_x=sh_x, scale_x=sc_x, shift_c=sh_c, scale_c=sc_c,
                        gate_x=linear(y, self.scale1_x),
                        gate_c=None if self.last else linear(y, self.scale1_c),
                        res_x=x, res_c=c)
            x, c = self.attn(x, c, hw, tail=tail, tail_mode=self.attn_tail)
        else:
            x_a, c_a = self.attn(self.norm1_x(x, y), self.norm1_c(c, y), hw)
            x = x_a * linear(y, self.scale1_x)[:, None, :] + x
            if not self.last:
                c = c_a * linear(y, self.scale1_c)[:, None, :] + c
        if self.mlp_tail and self.MLP_x.fused_ok:
            # the whole MLP half (AdaLN, SwiGLU, gate, residual) through the
            # int8 SwiGLU kernels, as the JAX block does
            # (sd3_tpu/models/mmdit.py:111-135)
            x = self._mlp_tail(self.MLP_x, self.norm2_x, self.scale2_x, x, y)
            if not self.last:
                c = self._mlp_tail(self.MLP_c, self.norm2_c, self.scale2_c,
                                   c, y)
            return x, c
        x = (self.MLP_x(self.norm2_x(x, y)) * linear(y, self.scale2_x)[:, None, :]
             + x)
        if not self.last:
            c = (self.MLP_c(self.norm2_c(c, y))
                 * linear(y, self.scale2_c)[:, None, :] + c)
        return x, c

    @staticmethod
    def _mlp_tail(mlp, norm, gate, t, y):
        shift, scale = norm.modulation(y)
        return mlp(t, shift=shift, scale=scale, gate=linear(y, gate),
                   residual=True)


REMAT_POLICIES = ("nothing", "dots", "attn", "dots_attn")


def remat_saved_ops(policy: str) -> frozenset:
    """The ops whose outputs the remat `policy` keeps for the backward."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r} is not one of "
                         f"{REMAT_POLICIES}")
    dots = {torch.ops.aten.mm.default, torch.ops.aten.addmm.default}
    attn = {torch.ops.sd3_torch.flash_fwd.default}
    return frozenset({"nothing": set(), "dots": dots, "attn": attn,
                      "dots_attn": dots | attn}[policy])


def _keep(saved, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in saved
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_kwargs(policy: str) -> dict:
    """`torch.utils.checkpoint.checkpoint` keyword arguments of `policy`."""
    saved = remat_saved_ops(policy)
    kw = dict(use_reentrant=False)
    if saved:
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, functools.partial(_keep,
                                                                    saved))
    return kw


SCAN_PREFIX = "blocks_stack.block."
SCAN_PREFIX_ODD = "blocks_stack.block_odd."
_BLOCK_NAME = re.compile(r"blocks\.(\d+)\.(.+)")


def scan_pair(cfg: MMDiTConfig) -> bool:
    """attn_type "both" alternates softmax and cosine by layer parity, so
    the scan takes two blocks a step (sd3_tpu/models/mmdit.py:212-215)."""
    return cfg.attn_type == "both"


def num_scan_blocks(cfg: MMDiTConfig) -> int:
    """Blocks in the stacked layout: all but a trailing `last=True` block,
    under the pair scan rounded down to even (sd3_tpu/models/mmdit.py:
    218-226)."""
    n = cfg.num_blocks if cfg.text_loss else cfg.num_blocks - 1
    return n - n % 2 if scan_pair(cfg) else n


def _stack_of(i: int, pair: bool) -> tuple[str, int]:
    """(prefix, slice) of scanned block i."""
    if pair and i % 2:
        return SCAN_PREFIX_ODD, i // 2
    return SCAN_PREFIX, i // 2 if pair else i


def to_scan_params(params: dict, num_scan: int, pair: bool = False) -> dict:
    """Canonical state dict (blocks.i.*) -> scan layout: blocks 0 ..
    num_scan-1 stacked on a leading axis under SCAN_PREFIX (with `pair`,
    the even ones there and the odd ones under SCAN_PREFIX_ODD), where the
    first of them stood; the others as they were. The exact inverse of
    `from_scan_params`."""
    def stacked(k):
        m = _BLOCK_NAME.fullmatch(k)
        return m if m and int(m.group(1)) < num_scan else None
    stacks = {}
    for k, v in params.items():
        if m := stacked(k):
            prefix, j = _stack_of(int(m.group(1)), pair)
            stacks.setdefault(prefix + m.group(2), {})[j] = v
    per_stack = num_scan // 2 if pair else num_scan
    out, placed = {}, False
    for k, v in params.items():
        if not stacked(k):
            out[k] = v
        elif not placed:
            placed = True
            for name, vs in stacks.items():
                if len(vs) != per_stack:
                    raise KeyError(f"{name}: missing in some of blocks 0-"
                                   f"{num_scan - 1}")
                out[name] = torch.stack(
                    [torch.as_tensor(vs[i]) for i in range(per_stack)])
    return out


def from_scan_params(params: dict, num_scan: int, pair: bool = False
                     ) -> dict:
    """Scan layout -> canonical state dict, in the unrolled model's order
    (the blocks where the stacks stood); the blocks' entries are views of
    the stacks (no copy)."""
    stacks = {}
    for k, v in params.items():
        for prefix in (SCAN_PREFIX, SCAN_PREFIX_ODD):
            if k.startswith(prefix):
                stacks.setdefault(prefix, {})[k[len(prefix):]] = v
    out, placed = {}, False
    for k, v in params.items():
        if not k.startswith("blocks_stack."):
            out[k] = v
        elif not placed:
            placed = True
            for i in range(num_scan):
                prefix, j = _stack_of(i, pair)
                out.update((f"blocks.{i}.{name}", st[j])
                           for name, st in stacks[prefix].items())
    return out


class MMDiT(nn.Module):
    """The full diffusion transformer. Latents are NCHW like the reference;
    inside everything is (B, N, D) tokens. Built on `device`, "cuda" unless
    the caller asks for the CPU; raises when asked for a GPU that is not
    there. `fused_attn`, `remat_blocks`, `remat_policy` and `scan_blocks`
    as in sd3_tpu/models/mmdit.py:229-253 (see the module docstring)."""

    def __init__(self, cfg: MMDiTConfig, device="cuda", dtype=None,
                 fused_attn: bool = True, remat_blocks: bool = False,
                 remat_policy: str = "nothing", scan_blocks: bool = False):
        super().__init__()
        device = resolve_device(device)
        self.remat_kwargs = remat_kwargs(remat_policy)
        self.num_scan = num_scan_blocks(cfg) if scan_blocks else 0
        self.scan_pair = bool(self.num_scan) and scan_pair(cfg)
        if self.num_scan and cfg.quant != "none":
            raise ValueError("scan_blocks is a training layout: a quantized "
                             "model is built unrolled")
        self.cfg = cfg
        self.remat_blocks = remat_blocks
        self.compute_dtype = torch_dtype(cfg.dtype)
        kw = dict(device=device, dtype=dtype)
        dim, thd = cfg.dim, cfg.text_hidden_dim
        last = lambda i: i == cfg.num_blocks - 1 and not cfg.text_loss
        if self.num_scan:
            # one block module whose parameters are the stacks (two under
            # the pair scan: layers 0 and 1)
            self.blocks_stack = nn.Module()
            per_stack = self.num_scan // (2 if self.scan_pair else 1)
            self.blocks_stack.block = _stacked(
                DualStreamBlock(cfg, 0, fused_attn=fused_attn, **kw),
                per_stack)
            if self.scan_pair:
                self.blocks_stack.block_odd = _stacked(
                    DualStreamBlock(cfg, 1, fused_attn=fused_attn, **kw),
                    per_stack)
            self.blocks = nn.ModuleDict({
                str(i): DualStreamBlock(cfg, i, last=last(i),
                                        fused_attn=fused_attn, **kw)
                for i in range(self.num_scan, cfg.num_blocks)})
        else:
            self.blocks = nn.ModuleList([
                DualStreamBlock(cfg, i, last=last(i), fused_attn=fused_attn,
                                **kw)
                for i in range(cfg.num_blocks)])
        self.time_scale = nn.Parameter(torch.full((1,), 1000.0, **kw))
        self.t_emb2 = nn.Linear(dim, dim, bias=False, **kw)
        self.cond_MLP = nn.Linear(cfg.class_dim, dim, bias=False, **kw)
        self.learnable_scalar = nn.Parameter(torch.full((1,), 0.01, **kw))
        self.learnable_scalar2 = nn.Parameter(torch.full((1,), 0.01, **kw))
        self.pre_c_norm = RMSNorm(thd, **kw)
        self.pre_c_norm2 = RMSNorm(thd, **kw)
        self.c_proj = nn.Linear(thd, dim, bias=False, **kw)
        self.c_proj2 = nn.Linear(thd, dim, bias=False, **kw)
        self.pos_enc = PatchEmbed(
            cfg.patch_size, cfg.inCh, dim,
            pos_embed_type=cfg.positional_encoding,
            pos_embed_max_size=cfg.pos_embed_max_size,
            base_size=cfg.pos_embed_base_size, **kw)
        self.patch_emb = nn.Linear(dim, dim, bias=True, **kw)
        self.out_norm = AdaLNorm(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, cfg.inCh * cfg.patch_size ** 2,
                                  bias=True, **kw)
        if cfg.text_loss:
            self.out_text_proj = nn.Linear(dim, thd, bias=True, **kw)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator | None = None) -> "MMDiT":
        """Seeded random weights with the JAX package's initializers: every
        projection N(0, 1/fan_in) (lecun normal, untruncated), biases zero,
        RMSNorm weights one, time_scale 1000, learnable scalars 0.01.
        The generator must lie on the parameters' device. A model built
        with quant="int8" has no float weights to draw: initialize the
        float model, then quantize it (`ops.quant.quantize_model`)."""
        if any(isinstance(m, Int8Linear) for m in self.modules()):
            raise ValueError("init_weights draws float weights: call it "
                             "before quantize_model, on a float model")
        # in the unrolled model's order and names, so that a scan model
        # draws the weights an unrolled one does
        for name, p in self.canonical_parameters().items():
            leaf = name.rsplit(".", 1)[-1]
            if name == "time_scale":
                p.fill_(1000.0)
            elif name.startswith("learnable_scalar"):
                p.fill_(0.01)
            elif leaf == "norm_const":
                p.fill_(0.5)
            elif p.ndim == 1 and leaf == "bias":
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)   # RMSNorm weights
            else:
                fan_in = math.prod(p.shape[1:])
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
        return self

    def canonical_parameters(self) -> dict:
        """{state-dict name of the unrolled model: parameter}, in its order;
        under scan_blocks the stacked blocks' entries are views of the
        stacks."""
        params = dict(self.named_parameters())
        return (from_scan_params(params, self.num_scan, self.scan_pair)
                if self.num_scan else params)

    def cast_params(self, dtype: torch.dtype) -> "MMDiT":
        """Store every parameter but `time_scale` (used in fp32) in `dtype`:
        for inference in the compute dtype, halving the weight bytes. The
        int8 weights and their fp32 scales are buffers and stay as they are
        (the JAX package's serving cast, bench.py:103-111)."""
        for name, p in self.named_parameters():
            if name != "time_scale":
                p.data = p.data.to(dtype)
        return self

    def forward(self, x_t, t, c, c_pooled, null_pooled=None, null_gemma=None,
                null_bert=None):
        """x_t: (B, inCh, H, W) noised latents; t: (B,) flow time in [0, 1];
        c: (B, 2*T, text_hidden_dim) Gemma || BERT hiddens; c_pooled:
        (B, class_dim); null_*: optional (B,) bool masks, True zeroes that
        conditioning. Returns the (B, inCh, H, W) fp32 velocity, and with
        `text_loss` also the (B, 2*T, text_hidden_dim) fp32 text
        prediction."""
        cfg = self.cfg
        dt = self.compute_dtype
        b, ch, h, w = x_t.shape
        tt = cfg.text_tokens_per_encoder
        p = cfg.patch_size

        if null_pooled is not None:
            c_pooled = c_pooled.masked_fill(null_pooled[:, None], 0.0)
        if null_gemma is not None:
            keep = (~null_gemma).to(c.dtype)[:, None, None]
            c = torch.cat([c[:, :tt] * keep, c[:, tt:]], dim=1)
        if null_bert is not None:
            keep = (~null_bert).to(c.dtype)[:, None, None]
            c = torch.cat([c[:, :tt], c[:, tt:] * keep], dim=1)

        y = (embed_time(t, self.time_scale, self.t_emb2, dt)
             + linear(c_pooled.to(dt), self.cond_MLP))

        c1 = self.pre_c_norm(c[:, :tt].to(dt))
        c2 = self.pre_c_norm2(c[:, tt:].to(dt))
        c1 = linear(self.learnable_scalar.to(dt) * c1, self.c_proj)
        c2 = linear(self.learnable_scalar2.to(dt) * c2, self.c_proj2)
        c_tok = torch.cat([c1, c2], dim=1)

        x = linear(self.pos_enc(x_t.to(dt)), self.patch_emb)
        hw = (h // p, w // p)
        remat = self.remat_blocks and torch.is_grad_enabled()
        for blk in self._block_fns():
            if remat:
                x, c_tok = checkpoint(blk, x, c_tok, y, hw,
                                      **self.remat_kwargs)
            else:
                x, c_tok = blk(x, c_tok, y, hw)

        x = linear(self.out_norm(x, y), self.out_proj)
        out = unpatchify(x, (p, p), (h, w)).float()
        if self.cfg.text_loss:
            return out, linear(c_tok, self.out_text_proj).float()
        return out

    def _block_fns(self) -> list:
        """The blocks in order, each a callable (x, c, y, hw) -> (x, c).
        Under scan_blocks the stacks are unbound once here, and the stacked
        block module runs over each slice: indexing a stack per block
        instead would make each index's backward a full-size zero gradient
        of the stack."""
        if not self.num_scan:
            return list(self.blocks)

        def calls(body):
            names = [n for n, _ in body.named_parameters()]
            slices = zip(*(p.unbind(0) for p in body.parameters()))
            return [functools.partial(_call_with, body, dict(zip(names, sl)))
                    for sl in slices]
        fns = calls(self.blocks_stack.block)
        if self.scan_pair:   # even and odd blocks in turn
            fns = [f for pair in zip(fns, calls(self.blocks_stack.block_odd))
                   for f in pair]
        return fns + list(self.blocks.values())


def _call_with(module: nn.Module, params: dict, *args):
    return torch.func.functional_call(module, params, args)


def _stacked(block: nn.Module, n: int) -> nn.Module:
    """`block` with each parameter replaced by an uninitialised stack of n
    of its shape (the scan layout's block module)."""
    for mod in block.modules():
        for leaf, p in list(mod.named_parameters(recurse=False)):
            setattr(mod, leaf, nn.Parameter(p.new_empty((n, *p.shape))))
    return block
