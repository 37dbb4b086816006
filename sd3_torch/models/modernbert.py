"""The ModernBERT-large encoder (JAX counterpart: sd3_tpu/models/
modernbert.py): the reference's second conditioning, answerdotai/
ModernBERT-large's last hidden state over 77 tokens in bf16
(VAE_T5_CLIP.py:258-268).

transformers ModernBertModel semantics: token embeddings cast to the
compute dtype, then a bias-free LayerNorm (eps 1e-5, fp32 statistics); per
layer attn_norm (the identity on layer 0) -> attention (packed bias-free
Wqkv, NeoX half-split RoPE) -> Wo -> residual, mlp_norm -> GeGLU (Wi packed
as input, gate; exact gelu(input) * gate) -> Wo -> residual; a final
LayerNorm. Every `global_attn_every_n_layers`-th layer (0, 3, 6, ...)
attends globally with rope theta 160000; the others within a window of
local_attention / 2 tokens each side (|i - j| <= 64 at the published size)
with theta 10000; the padding mask everywhere. The caller multiplies the
output by the attention mask (`encoder_suite.RealTextEncoders`), as the
JAX suite does.

Parameter names are transformers' (`layers.0.attn.Wqkv.weight`,
`embeddings.norm.weight`, ...), the names `import_modernbert_state_dict`
reads; `sd3_torch.weights.modernbert_state_dict_from_jax` gives them from
the JAX tree. Linears compute in `dtype` (weights held in it); norms and
the embedding table stay fp32.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from sd3_torch import resolve_device
from sd3_torch.models.encoder_ops import (NEG_INF, attend, cast_dense,
                                          neox_rope, neox_tables, pad_bias)


@dataclasses.dataclass(frozen=True)
class ModernBertConfig:
    vocab_size: int = 50368
    hidden_size: int = 1024
    intermediate_size: int = 2624
    num_hidden_layers: int = 28
    num_attention_heads: int = 16
    norm_eps: float = 1e-5
    global_rope_theta: float = 160000.0
    local_rope_theta: float = 10000.0
    local_attention: int = 128          # the whole window (half each side)
    global_attn_every_n_layers: int = 3

    @classmethod
    def modernbert_large(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=128, hidden_size=32, intermediate_size=48,
                   num_hidden_layers=4, num_attention_heads=4,
                   local_attention=8)


class BiasFreeLayerNorm(nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def forward(self, x):
        return F.layer_norm(x.float(), x.shape[-1:], self.weight.float(), None,
                            self.eps).to(x.dtype)


class ModernBertEmbeddings(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        self.tok_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.norm = BiasFreeLayerNorm(cfg.hidden_size, cfg.norm_eps)


class ModernBertAttention(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        h = cfg.hidden_size
        self.Wqkv = nn.Linear(h, 3 * h, bias=False)
        self.Wo = nn.Linear(h, h, bias=False)


class ModernBertMLP(nn.Module):
    def __init__(self, cfg: ModernBertConfig):
        super().__init__()
        self.Wi = nn.Linear(cfg.hidden_size, 2 * cfg.intermediate_size,
                            bias=False)
        self.Wo = nn.Linear(cfg.intermediate_size, cfg.hidden_size, bias=False)

    def forward(self, x):
        inp, gate = self.Wi(x).chunk(2, dim=-1)
        return self.Wo(F.gelu(inp) * gate)


class ModernBertLayer(nn.Module):
    def __init__(self, cfg: ModernBertConfig, idx: int):
        super().__init__()
        self.cfg, self.idx = cfg, idx
        self.is_global = idx % cfg.global_attn_every_n_layers == 0
        if idx != 0:  # the identity on layer 0
            self.attn_norm = BiasFreeLayerNorm(cfg.hidden_size, cfg.norm_eps)
        self.attn = ModernBertAttention(cfg)
        self.mlp_norm = BiasFreeLayerNorm(cfg.hidden_size, cfg.norm_eps)
        self.mlp = ModernBertMLP(cfg)

    def forward(self, x, bias, tables):
        cfg = self.cfg
        b, t, h = x.shape
        nh = cfg.num_attention_heads
        hd = h // nh
        y = x if self.idx == 0 else self.attn_norm(x)
        qkv = self.attn.Wqkv(y).reshape(b, t, 3, nh, hd)
        cos, sin = tables[self.is_global]
        q = neox_rope(qkv[:, :, 0], cos, sin)
        k = neox_rope(qkv[:, :, 1], cos, sin)
        if not self.is_global:
            i = torch.arange(t, device=x.device)
            win = (i[:, None] - i[None, :]).abs() <= cfg.local_attention // 2
            bias = bias + torch.where(win, 0.0, NEG_INF)[None, None]
        o = attend(q, k, qkv[:, :, 2], bias, 1.0 / math.sqrt(hd))
        x = x + self.attn.Wo(o.reshape(b, t, h))
        return x + self.mlp(self.mlp_norm(x))


class ModernBertEncoder(nn.Module):
    """input_ids (B, T) [, attention_mask] -> last hidden state (B, T,
    hidden) in `dtype` (not yet multiplied by the mask)."""

    def __init__(self, cfg: ModernBertConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg = cfg or ModernBertConfig.modernbert_large()
        self.dtype = dtype
        self.embeddings = ModernBertEmbeddings(cfg)
        self.layers = nn.ModuleList([ModernBertLayer(cfg, i)
                                     for i in range(cfg.num_hidden_layers)])
        self.final_norm = BiasFreeLayerNorm(cfg.hidden_size, cfg.norm_eps)
        cast_dense(self, dtype)
        self.to(resolve_device(device))

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask=None):
        cfg = self.cfg
        dev = self.final_norm.weight.device
        ids = input_ids.to(dev)
        t = ids.shape[1]
        hd = cfg.hidden_size // cfg.num_attention_heads
        x = self.embeddings.norm(
            self.embeddings.tok_embeddings.weight[ids].to(self.dtype))
        bias = pad_bias(attention_mask, t, False, dev)
        tables = {True: neox_tables(t, hd, cfg.global_rope_theta, dev),
                  False: neox_tables(t, hd, cfg.local_rope_theta, dev)}
        for layer in self.layers:
            x = layer(x, bias, tables)
        return self.final_norm(x)
