"""The Gemma-2 text encoder (JAX counterpart: sd3_tpu/models/gemma2.py): the
reference's primary conditioning, google/gemma-2-2b's last hidden state
over 77 tokens in bf16 (VAE_T5_CLIP_inference.py:77-101).

transformers Gemma2Model semantics: embeddings cast to the compute dtype,
then scaled by sqrt(hidden) (in that dtype); RMSNorm scaling by (1 + w)
with fp32 statistics; per layer input norm -> GQA attention (8 heads, 4 KV
heads of 256 at the published size; NeoX half-split RoPE, theta 10000;
query scale query_pre_attn_scalar^-0.5; logits soft-capped at 50) -> post
norm -> residual, pre-FFW norm -> GeGLU (gelu-tanh) -> post-FFW norm ->
residual; a final RMSNorm. The mask is the JAX module's: causal plus
padding, and on the even layers the sliding window |i - j| < window too.

Parameter names are transformers' Gemma2Model ones (`layers.0.self_attn.
q_proj.weight`, ...), the names `import_gemma2_state_dict` reads;
`sd3_torch.weights.gemma2_state_dict_from_jax` gives them from the JAX tree.
Linears compute in `dtype` (weights held in it); norms and the embedding
table stay fp32, as JAX keeps them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from sd3_torch import resolve_device
from sd3_torch.models.encoder_ops import (NEG_INF, attend, cast_dense,
                                          neox_rope, neox_tables, pad_bias)


@dataclasses.dataclass(frozen=True)
class Gemma2Config:
    vocab_size: int = 256000
    hidden_size: int = 2304
    intermediate_size: int = 9216
    num_hidden_layers: int = 26
    num_attention_heads: int = 8
    num_key_value_heads: int = 4
    head_dim: int = 256
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    attn_logit_softcapping: float = 50.0
    query_pre_attn_scalar: float = 256.0
    sliding_window: int = 4096

    @classmethod
    def gemma2_2b(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=128, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   num_key_value_heads=2, head_dim=8,
                   query_pre_attn_scalar=8.0, sliding_window=16)


class RMSNorm(nn.Module):
    """x * rsqrt(mean(x^2) + eps) * (1 + w), fp32 statistics and weight,
    the result in x's dtype."""

    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        xf = x.float()
        y = xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + self.eps)
        return (y * (1.0 + self.weight.float())).to(x.dtype)


class Gemma2Attention(nn.Module):
    def __init__(self, cfg: Gemma2Config):
        super().__init__()
        h, nh, nkv, hd = (cfg.hidden_size, cfg.num_attention_heads,
                          cfg.num_key_value_heads, cfg.head_dim)
        self.q_proj = nn.Linear(h, nh * hd, bias=False)
        self.k_proj = nn.Linear(h, nkv * hd, bias=False)
        self.v_proj = nn.Linear(h, nkv * hd, bias=False)
        self.o_proj = nn.Linear(nh * hd, h, bias=False)


class Gemma2MLP(nn.Module):
    def __init__(self, cfg: Gemma2Config):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(h, i, bias=False)
        self.up_proj = nn.Linear(h, i, bias=False)
        self.down_proj = nn.Linear(i, h, bias=False)

    def forward(self, x):
        return self.down_proj(F.gelu(self.gate_proj(x), approximate="tanh") *
                              self.up_proj(x))


class Gemma2Layer(nn.Module):
    def __init__(self, cfg: Gemma2Config, idx: int):
        super().__init__()
        self.cfg, self.idx = cfg, idx
        eps = cfg.rms_norm_eps
        self.input_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.self_attn = Gemma2Attention(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.pre_feedforward_layernorm = RMSNorm(cfg.hidden_size, eps)
        self.mlp = Gemma2MLP(cfg)
        self.post_feedforward_layernorm = RMSNorm(cfg.hidden_size, eps)

    def forward(self, x, bias, cos, sin):
        cfg, a = self.cfg, self.self_attn
        b, t, _ = x.shape
        nh, nkv, hd = (cfg.num_attention_heads, cfg.num_key_value_heads,
                       cfg.head_dim)
        h = self.input_layernorm(x)
        q = neox_rope(a.q_proj(h).reshape(b, t, nh, hd), cos, sin)
        k = neox_rope(a.k_proj(h).reshape(b, t, nkv, hd), cos, sin)
        v = a.v_proj(h).reshape(b, t, nkv, hd)
        k = k.repeat_interleave(nh // nkv, dim=2)
        v = v.repeat_interleave(nh // nkv, dim=2)
        if self.idx % 2 == 0 and cfg.sliding_window:
            i = torch.arange(t, device=x.device)
            win = (i[:, None] - i[None, :]).abs() < cfg.sliding_window
            bias = bias + torch.where(win, 0.0, NEG_INF)[None, None]
        o = attend(q, k, v, bias, cfg.query_pre_attn_scalar ** -0.5,
                   cfg.attn_logit_softcapping)
        x = x + self.post_attention_layernorm(a.o_proj(o.reshape(b, t, nh * hd)))
        h = self.mlp(self.pre_feedforward_layernorm(x))
        return x + self.post_feedforward_layernorm(h)


class Gemma2Encoder(nn.Module):
    """input_ids (B, T) [, attention_mask] -> last hidden state (B, T,
    hidden) in `dtype`."""

    def __init__(self, cfg: Gemma2Config | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg = cfg or Gemma2Config.gemma2_2b()
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.layers = nn.ModuleList([Gemma2Layer(cfg, i)
                                     for i in range(cfg.num_hidden_layers)])
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        cast_dense(self, dtype)
        self.to(resolve_device(device))

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask=None):
        cfg = self.cfg
        dev = self.norm.weight.device
        ids = input_ids.to(dev)
        t = ids.shape[1]
        x = self.embed_tokens.weight[ids].to(self.dtype)
        x = x * torch.tensor(cfg.hidden_size ** 0.5, dtype=self.dtype)
        bias = pad_bias(attention_mask, t, True, dev)
        cos, sin = neox_tables(t, cfg.head_dim, cfg.rope_theta, dev)
        for layer in self.layers:
            x = layer(x, bias, cos, sin)
        return self.norm(x)
