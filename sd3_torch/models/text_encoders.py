"""Conditioning-stack helpers and the stub encoders (JAX counterpart:
sd3_tpu/models/text_encoders.py).

  text_to_embedding(text) -> (hidden (B, 154, 2304), pooled (B, 768))
    = [Gemma hidden (77x2304) || ModernBERT hidden zero-padded 1024->2304]
  vae latents: z = sample * scaling + shift (the reference's convention,
    VAE_T5_CLIP_inference.py:41), inverted by (z - shift) / scaling.

The real encoders and the FLUX VAE are `encoder_suite.RealTextEncoders`
(`load_text_encoders(weights_dir=...)`); `StubTextEncoders` gives
deterministic pseudo-embeddings and a fixed random projection in place of
the VAE, so the sampler and the CLI run without weights.
"""

from __future__ import annotations

import dataclasses
import math
import zlib

import torch
import torch.nn.functional as F

from sd3_torch import resolve_device, to_device

# FLUX.1-schnell VAE constants (its config.json)
FLUX_SCALING_FACTOR = 0.3611
FLUX_SHIFT_FACTOR = 0.1159
FLUX_LATENT_CHANNELS = 16

TEXT_TOKENS = 77
GEMMA_DIM = 2304
BERT_DIM = 1024
CLIP_DIM = 768


def combine_hidden(gemma_hidden: torch.Tensor,
                   bert_hidden: torch.Tensor) -> torch.Tensor:
    """(B, 77, 2304) + (B, 77, 1024) -> (B, 154, 2304), BERT zero-padded."""
    pad = gemma_hidden.shape[-1] - bert_hidden.shape[-1]
    bert = F.pad(bert_hidden, (0, pad)).to(gemma_hidden.dtype)
    return torch.cat([gemma_hidden, bert], dim=1)


def normalize_latents(sample: torch.Tensor) -> torch.Tensor:
    """VAE sample -> model latent: z = s * scale + shift."""
    return sample * FLUX_SCALING_FACTOR + FLUX_SHIFT_FACTOR


def denormalize_latents(z: torch.Tensor) -> torch.Tensor:
    return (z - FLUX_SHIFT_FACTOR) / FLUX_SCALING_FACTOR


def stub_decode(latents: torch.Tensor, projection: torch.Tensor) -> torch.Tensor:
    """The stub VAE decode: (B, L, h, w) latents -> (B, 3, 8h, 8w) pixels in
    [-1, 1] through `projection` (L, 3*64), the JAX stub's math."""
    z = denormalize_latents(latents.float())
    b, l, h, w = z.shape
    k = projection.to(z.device, torch.float32) / math.sqrt(3 * 64)
    x = torch.einsum("lc,blhw->bchw", k, z)
    x = x.reshape(b, 3, 8, 8, h, w).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, 3, h * 8, w * 8).clamp(-1, 1)


def _stub_generator(seed: int) -> torch.Generator:
    return torch.Generator(device="cpu").manual_seed(seed)


@dataclasses.dataclass
class StubTextEncoders:
    """Deterministic text-hash embeddings + a fixed random projection in
    place of the VAE, at 8x down/upsampling so shapes match the real one.

    The JAX stub seeds from Python's `hash()`, which is randomised per
    process, and draws with jax.random, so its numbers cannot be reproduced
    here. This stub seeds a torch.Generator from zlib.crc32 of the prompt,
    which is stable across processes; the projections come from seed 0.
    Tensors are made on the CPU and moved to `device`.
    """

    latent_channels: int = FLUX_LATENT_CHANNELS
    text_tokens_per_encoder: int = TEXT_TOKENS
    gemma_dim: int = GEMMA_DIM
    bert_dim: int = BERT_DIM
    clip_dim: int = CLIP_DIM
    device: str = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)

    def text_to_embedding(self, text):
        if isinstance(text, str):
            text = [text]
        hiddens, pooleds = [], []
        t = self.text_tokens_per_encoder
        for s in text:
            gen = _stub_generator(zlib.crc32(("sd3_torch_stub:" + s).encode()))
            g = torch.randn((1, t, self.gemma_dim), generator=gen)
            bt = torch.randn((1, t, self.bert_dim), generator=gen)
            hiddens.append(combine_hidden(g, bt))
            pooleds.append(torch.randn((1, self.clip_dim), generator=gen))
        return (to_device(torch.cat(hiddens), self.device),
                to_device(torch.cat(pooleds), self.device))

    def _projection(self, channels: int) -> torch.Tensor:
        return torch.randn((self.latent_channels, channels * 64),
                           generator=_stub_generator(0))

    def vae_encode(self, images: torch.Tensor,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """The stub's latents: a fixed projection of each 8x8 patch (the
        real suite's signature; the stub draws nothing from `generator`)."""
        b, c, h, w = images.shape
        x = images.float().reshape(b, c, h // 8, 8, w // 8, 8)
        x = x.permute(0, 1, 3, 5, 2, 4).reshape(b, c * 64, h // 8, w // 8)
        k = self._projection(c).to(x.device) / math.sqrt(c * 64)
        return normalize_latents(torch.einsum("lc,bchw->blhw", k, x))

    def vae_decode(self, latents: torch.Tensor) -> torch.Tensor:
        return stub_decode(latents, self._projection(3))


def load_text_encoders(device="cuda", stub: bool = False,
                       weights_dir: str | None = None, model_cfg=None):
    """The encoder suite: `RealTextEncoders.from_pretrained(weights_dir)`
    when a weights directory is given and `stub` is not set, else
    StubTextEncoders (sized to `model_cfg` if given, as tiny test
    checkpoints have other conditioning widths)."""
    if not stub and weights_dir is not None:
        from sd3_torch.models.encoder_suite import RealTextEncoders
        return RealTextEncoders.from_pretrained(weights_dir, device=device)
    if model_cfg is None:
        return StubTextEncoders(device=device)
    return StubTextEncoders(
        latent_channels=model_cfg.inCh,
        text_tokens_per_encoder=model_cfg.text_tokens_per_encoder,
        gemma_dim=model_cfg.text_hidden_dim,
        bert_dim=max(1, model_cfg.text_hidden_dim // 2),
        clip_dim=model_cfg.class_dim, device=device)
