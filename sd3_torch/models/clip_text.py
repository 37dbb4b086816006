"""The CLIP text tower and its projection (JAX counterpart:
sd3_tpu/models/clip_text.py): the reference's pooled conditioning,
facebook/metaclip-l14-400m's text model in fp16 (VAE_T5_CLIP.py:189-210).

transformers CLIPTextModelWithProjection semantics: token and learned
position embeddings (summed in fp32, then cast); pre-norm layers of
LayerNorm -> attention (biased q / k / v / out, q scaled by head_dim^-0.5
BEFORE the product, causal plus padding mask) -> residual, LayerNorm ->
fc1 -> quick_gelu -> fc2 -> residual; a final LayerNorm; the pooled output
is the hidden state at argmax(input_ids) (EOS, the largest id), then the
bias-free `text_projection` in fp32.

Parameter names are transformers' (`text_model.encoder.layers.0.self_attn.
q_proj.weight`, `text_projection.weight`), the names
`import_clip_text_state_dict` reads; `sd3_torch.weights.
clip_text_state_dict_from_jax` gives them from the JAX tree. Linears compute
in `dtype` (weights held in it); LayerNorms, embeddings and the projection
stay fp32, as JAX keeps them. The masks are added to fp32 logits
(`encoder_ops.attend`).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn
import torch.nn.functional as F

from sd3_torch import resolve_device
from sd3_torch.models.encoder_ops import attend, cast_dense, pad_bias


@dataclasses.dataclass(frozen=True)
class ClipTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    max_position_embeddings: int = 77
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768

    @classmethod
    def metaclip_l14(cls):
        return cls()

    @classmethod
    def tiny(cls):
        return cls(vocab_size=96, hidden_size=32, intermediate_size=64,
                   num_hidden_layers=2, num_attention_heads=4,
                   max_position_embeddings=16, projection_dim=24)


def layer_norm(x, ln: nn.LayerNorm, eps: float) -> torch.Tensor:
    """LayerNorm with fp32 statistics and weights, the result in x's dtype."""
    return F.layer_norm(x.float(), x.shape[-1:], ln.weight.float(),
                        ln.bias.float(), eps).to(x.dtype)


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ClipAttention(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        h = cfg.hidden_size
        self.nh = cfg.num_attention_heads
        self.q_proj = nn.Linear(h, h)
        self.k_proj = nn.Linear(h, h)
        self.v_proj = nn.Linear(h, h)
        self.out_proj = nn.Linear(h, h)

    def forward(self, x, bias):
        b, t, h = x.shape
        hd = h // self.nh
        q = (self.q_proj(x) * hd ** -0.5).reshape(b, t, self.nh, hd)
        k = self.k_proj(x).reshape(b, t, self.nh, hd)
        v = self.v_proj(x).reshape(b, t, self.nh, hd)
        return self.out_proj(attend(q, k, v, bias).reshape(b, t, h))


class ClipMLP(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class ClipLayer(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.eps = cfg.layer_norm_eps
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size)
        self.self_attn = ClipAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size)
        self.mlp = ClipMLP(cfg)

    def forward(self, x, bias):
        x = x + self.self_attn(layer_norm(x, self.layer_norm1, self.eps), bias)
        return x + self.mlp(layer_norm(x, self.layer_norm2, self.eps))


class ClipEmbeddings(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)


class ClipEncoderLayers(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.layers = nn.ModuleList([ClipLayer(cfg)
                                     for _ in range(cfg.num_hidden_layers)])


class ClipTextModel(nn.Module):
    def __init__(self, cfg: ClipTextConfig):
        super().__init__()
        self.embeddings = ClipEmbeddings(cfg)
        self.encoder = ClipEncoderLayers(cfg)
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size)


class ClipTextEncoder(nn.Module):
    """input_ids (B, T) [, attention_mask] -> (last hidden state (B, T, H)
    in `dtype`, projected pooled output (B, projection_dim) fp32)."""

    def __init__(self, cfg: ClipTextConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg = cfg or ClipTextConfig.metaclip_l14()
        self.dtype = dtype
        self.text_model = ClipTextModel(cfg)
        self.text_projection = nn.Linear(cfg.hidden_size, cfg.projection_dim,
                                         bias=False)
        cast_dense(self.text_model, dtype)
        self.to(resolve_device(device))

    @torch.inference_mode()
    def forward(self, input_ids, attention_mask=None):
        cfg, tm = self.cfg, self.text_model
        dev = self.text_projection.weight.device
        ids = input_ids.to(dev)
        b, t = ids.shape
        emb = tm.embeddings
        x = (emb.token_embedding.weight[ids] +
             emb.position_embedding.weight[None, :t]).to(self.dtype)
        bias = pad_bias(attention_mask, t, True, dev)
        for layer in tm.encoder.layers:
            x = layer(x, bias)
        x = layer_norm(x, tm.final_layer_norm, cfg.layer_norm_eps)
        pooled = x[torch.arange(b, device=dev), ids.argmax(-1)]
        return x, pooled.float() @ self.text_projection.weight.float().T
