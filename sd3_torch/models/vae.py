"""The FLUX.1-schnell AutoencoderKL (JAX counterpart: sd3_tpu/models/vae.py),
the frozen VAE of the reference (VAE_T5_CLIP_inference.py:25-43).

Architecture, per the diffusers AutoencoderKL config of FLUX.1-schnell:
block_out_channels (128, 256, 512, 512), 2 resnets a level in the encoder
and 3 in the decoder, GroupNorm(32, eps 1e-6) with its statistics in fp32,
SiLU, a single-head spatial attention in the mid block, 16 latent channels,
no quant / post-quant convs. The encoder downsamples with an asymmetric
(0, 1, 0, 1) pad before a stride-2 valid conv; the decoder upsamples by
nearest x2, then a conv.

PyTorch's NCHW layout throughout. Parameter names are the diffusers ones
(`encoder.down_blocks.0.resnets.0.conv1.weight`, ...), the names
`import_flux_vae_state_dict` of the JAX package reads, so a diffusers
snapshot loads with `load_state_dict(strict=True)`;
`sd3_torch.weights.flux_vae_state_dict_from_jax` gives them from the JAX
tree. Convs and linears compute in the module's `dtype` (their weights held
in it, as JAX casts its fp32 parameters to the compute dtype); the norms'
weights stay fp32, as JAX keeps them.

The mid-block attention is one head of 512 channels over every latent
position (16384 at 128x128 latents). JAX computes it in XLA with fp32
logits and a softmax (no Pallas kernel), so the port computes it with
PyTorch: on the CPU and in fp32 the same fp32 logits and softmax, a block
of query rows at a time; in bf16 or fp16 on the card PyTorch's
`scaled_dot_product_attention` (fp32 scores, p rounded to the input dtype
before P.V, as JAX rounds its probabilities), held to the JAX module
through the fp32 CPU path.

Latent normalisation is the reference's (`text_encoders.normalize_latents`):
z = sample * scaling + shift, inverted by (z - shift) / scaling.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from sd3_torch import resolve_device
from sd3_torch.models.encoder_ops import cast_dense
from sd3_torch.models.text_encoders import (FLUX_LATENT_CHANNELS,
                                            denormalize_latents,
                                            normalize_latents)

GN_EPS = 1e-6
ATTN_ROWS = 4096  # query rows of one fp32 logits block (the CPU / fp32 path)


@dataclasses.dataclass(frozen=True)
class VAEConfig:
    block_out: tuple = (128, 256, 512, 512)
    encoder_layers: int = 2
    decoder_layers: int = 3
    latent_ch: int = FLUX_LATENT_CHANNELS

    @classmethod
    def flux(cls):
        return cls()

    @classmethod
    def tiny(cls):
        """Four levels (8x down / up) of 32 channels; diffusers'
        layers_per_block 1 (the decoder takes one more)."""
        return cls(block_out=(32, 32, 32, 32), encoder_layers=1,
                   decoder_layers=2)


class GroupNorm(nn.Module):
    """GroupNorm(32, eps 1e-6) with fp32 statistics and weights, the result
    in the input dtype."""

    def __init__(self, ch: int, groups: int = 32):
        super().__init__()
        self.groups = groups
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))

    def forward(self, x):
        return F.group_norm(x.float(), self.groups, self.weight.float(),
                            self.bias.float(), GN_EPS).to(x.dtype)


class ResnetBlock(nn.Module):
    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.norm1 = GroupNorm(in_ch)
        self.conv1 = nn.Conv2d(in_ch, out_ch, 3, padding=1)
        self.norm2 = GroupNorm(out_ch)
        self.conv2 = nn.Conv2d(out_ch, out_ch, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_ch, out_ch, 1) if in_ch != out_ch
                              else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def attention_fp32(q, k, v, scale: float) -> torch.Tensor:
    """softmax(q k^T * scale) v over (B, N, C) with fp32 logits and softmax,
    the probabilities rounded to v's dtype, fp32 sums, a block of
    ATTN_ROWS query rows at a time (the JAX module's arithmetic)."""
    kf = k.float().transpose(1, 2)
    vf = v.float()
    out = []
    for r0 in range(0, q.shape[1], ATTN_ROWS):
        logits = torch.matmul(q[:, r0:r0 + ATTN_ROWS].float(), kf) * scale
        p = torch.softmax(logits, dim=-1).to(v.dtype).float()
        out.append(torch.matmul(p, vf).to(v.dtype))
    return torch.cat(out, dim=1)


class AttnBlock(nn.Module):
    """Single-head spatial self-attention of the mid block."""

    def __init__(self, ch: int):
        super().__init__()
        self.group_norm = GroupNorm(ch)
        self.to_q = nn.Linear(ch, ch)
        self.to_k = nn.Linear(ch, ch)
        self.to_v = nn.Linear(ch, ch)
        self.to_out = nn.ModuleList([nn.Linear(ch, ch)])

    def forward(self, x):
        b, c, h, w = x.shape
        y = self.group_norm(x).flatten(2).transpose(1, 2)  # (B, HW, C)
        q, k, v = self.to_q(y), self.to_k(y), self.to_v(y)
        if x.is_cuda and x.dtype != torch.float32:
            y = F.scaled_dot_product_attention(q[:, None], k[:, None],
                                               v[:, None])[:, 0]
        else:
            y = attention_fp32(q, k, v, 1.0 / math.sqrt(c))
        y = self.to_out[0](y)
        return x + y.transpose(1, 2).reshape(b, c, h, w)


class MidBlock(nn.Module):
    def __init__(self, ch: int):
        super().__init__()
        self.resnets = nn.ModuleList([ResnetBlock(ch, ch), ResnetBlock(ch, ch)])
        self.attentions = nn.ModuleList([AttnBlock(ch)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Downsample(nn.Module):
    """The asymmetric (0, 1, 0, 1) pad, then a stride-2 valid conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, stride=2)

    def forward(self, x):
        return self.conv(F.pad(x, (0, 1, 0, 1)))


class Upsample(nn.Module):
    """Nearest x2, then a conv."""

    def __init__(self, ch: int):
        super().__init__()
        self.conv = nn.Conv2d(ch, ch, 3, padding=1)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2.0, mode="nearest"))


class DownBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, layers: int, down: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else ch, ch) for j in range(layers)])
        self.downsamplers = nn.ModuleList([Downsample(ch)] if down else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d(x)
        return x


class UpBlock(nn.Module):
    def __init__(self, in_ch: int, ch: int, layers: int, up: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            [ResnetBlock(in_ch if j == 0 else ch, ch) for j in range(layers)])
        self.upsamplers = nn.ModuleList([Upsample(ch)] if up else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u(x)
        return x


class Encoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        bo = cfg.block_out
        self.conv_in = nn.Conv2d(3, bo[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            [DownBlock(bo[max(i - 1, 0)], ch, cfg.encoder_layers,
                       i < len(bo) - 1) for i, ch in enumerate(bo)])
        self.mid_block = MidBlock(bo[-1])
        self.conv_norm_out = GroupNorm(bo[-1])
        self.conv_out = nn.Conv2d(bo[-1], 2 * cfg.latent_ch, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            h = blk(h)
        h = self.mid_block(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class Decoder(nn.Module):
    def __init__(self, cfg: VAEConfig):
        super().__init__()
        rev = list(reversed(cfg.block_out))
        self.conv_in = nn.Conv2d(cfg.latent_ch, rev[0], 3, padding=1)
        self.mid_block = MidBlock(rev[0])
        self.up_blocks = nn.ModuleList(
            [UpBlock(rev[max(i - 1, 0)], ch, cfg.decoder_layers,
                     i < len(rev) - 1) for i, ch in enumerate(rev)])
        self.conv_norm_out = GroupNorm(rev[-1])
        self.conv_out = nn.Conv2d(rev[-1], 3, 3, padding=1)

    def forward(self, z):
        h = self.mid_block(self.conv_in(z))
        for blk in self.up_blocks:
            h = blk(h)
        return self.conv_out(F.silu(self.conv_norm_out(h)))


class FluxVAE(nn.Module):
    """Encoder and decoder; public tensors NCHW, latents normalised."""

    def __init__(self, cfg: VAEConfig | None = None,
                 dtype: torch.dtype = torch.float32, device="cuda"):
        super().__init__()
        self.cfg = cfg or VAEConfig.flux()
        self.dtype = dtype
        self.encoder = Encoder(self.cfg)
        self.decoder = Decoder(self.cfg)
        cast_dense(self, dtype)
        self.to(resolve_device(device))

    @torch.inference_mode()
    def encode_moments(self, images: torch.Tensor):
        """(B, 3, H, W) in [-1, 1] -> (mean, logvar), each (B, 16, H/8,
        W/8) fp32, logvar clipped to [-30, 20]."""
        x = images.to(self.conv_device(), self.dtype)
        mean, logvar = self.encoder(x).float().chunk(2, dim=1)
        return mean, logvar.clamp(-30.0, 20.0)

    @torch.inference_mode()
    def encode_sample(self, images: torch.Tensor,
                      generator: torch.Generator | None = None):
        """A draw from the posterior (the normal noise from `generator`, on
        its device), normalised as the reference does."""
        mean, logvar = self.encode_moments(images)
        dev = generator.device if generator is not None else mean.device
        eps = torch.randn(mean.shape, generator=generator, device=dev)
        return normalize_latents(mean + torch.exp(0.5 * logvar) *
                                 eps.to(mean.device))

    @torch.inference_mode()
    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Normalised latents -> images in [-1, 1], (B, 3, 8h, 8w) fp32."""
        sample = denormalize_latents(z.to(self.conv_device()).float())
        out = self.decoder(sample.to(self.dtype)).float()
        return out.clamp(-1.0, 1.0)

    def conv_device(self) -> torch.device:
        return self.decoder.conv_in.weight.device
