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
(`torch.utils.checkpoint`, the JAX `nn.remat` with policy "nothing"), so the
attention forward runs twice per block and step.

Parameter names are the reference state-dict names (`blocks.3.y_proj.0.weight`,
`blocks.3.attn.query_proj_x.weight`, `pos_enc.proj.weight`, `time_scale`), so
`load_state_dict(strict=True)` takes a reference checkpoint. Parameters may
be stored in fp32 or in the compute dtype; the forward computes in
`cfg.dtype` either way.
"""

from __future__ import annotations

import math

import torch
from torch import nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

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


class MMDiT(nn.Module):
    """The full diffusion transformer. Latents are NCHW like the reference;
    inside everything is (B, N, D) tokens. Built on `device`, "cuda" unless
    the caller asks for the CPU; raises when asked for a GPU that is not
    there. `fused_attn`, `remat_blocks` and `remat_policy` as in
    sd3_tpu/models/mmdit.py:229-253 (see the module docstring); only the
    policy "nothing" and the unrolled blocks are ported."""

    def __init__(self, cfg: MMDiTConfig, device="cuda", dtype=None,
                 fused_attn: bool = True, remat_blocks: bool = False,
                 remat_policy: str = "nothing", scan_blocks: bool = False):
        super().__init__()
        device = resolve_device(device)
        if cfg.text_loss:
            raise NotImplementedError(
                "text_loss=True (the text-reconstruction head) is not ported "
                "yet: ROADMAP.md, port queue, 'text_loss'")
        if remat_policy not in REMAT_POLICIES:
            raise ValueError(f"remat_policy {remat_policy!r} is not one of "
                             f"{REMAT_POLICIES}")
        if remat_blocks and remat_policy != "nothing":
            raise NotImplementedError(
                f"remat_policy={remat_policy!r} is not ported yet: ROADMAP.md,"
                " port queue, 'trainer' (remat policies)")
        if scan_blocks:
            raise NotImplementedError(
                "scan_blocks is not ported yet: ROADMAP.md, port queue, "
                "'trainer' (scan over blocks)")
        self.cfg = cfg
        self.remat_blocks = remat_blocks
        self.compute_dtype = torch_dtype(cfg.dtype)
        kw = dict(device=device, dtype=dtype)
        dim, thd = cfg.dim, cfg.text_hidden_dim
        self.blocks = nn.ModuleList([
            DualStreamBlock(cfg, i, last=(i == cfg.num_blocks - 1),
                            fused_attn=fused_attn, **kw)
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
        self.pos_enc = PatchEmbed(cfg.patch_size, cfg.inCh, dim,
                                  pos_embed_type=cfg.positional_encoding, **kw)
        self.patch_emb = nn.Linear(dim, dim, bias=True, **kw)
        self.out_norm = AdaLNorm(dim, dim, **kw)
        self.out_proj = nn.Linear(dim, cfg.inCh * cfg.patch_size ** 2,
                                  bias=True, **kw)

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
        for name, p in self.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if name == "time_scale":
                p.fill_(1000.0)
            elif name.startswith("learnable_scalar"):
                p.fill_(0.01)
            elif p.ndim == 1 and leaf == "bias":
                p.zero_()
            elif p.ndim == 1:
                p.fill_(1.0)   # RMSNorm weights
            else:
                fan_in = math.prod(p.shape[1:])
                p.normal_(0.0, fan_in ** -0.5, generator=generator)
        return self

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
        conditioning. Returns the (B, inCh, H, W) fp32 velocity."""
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
        for blk in self.blocks:
            if remat:
                x, c_tok = checkpoint(blk, x, c_tok, y, hw,
                                      use_reentrant=False)
            else:
                x, c_tok = blk(x, c_tok, y, hw)

        x = linear(self.out_norm(x, y), self.out_proj)
        return unpatchify(x, (p, p), (h, w)).float()
