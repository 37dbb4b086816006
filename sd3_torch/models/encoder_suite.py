"""RealTextEncoders: the frozen conditioning stack and the FLUX VAE (JAX
counterpart: sd3_tpu/models/encoder_suite.py), behind the reference's
`text_to_embedding` (VAE_T5_CLIP_inference.py:149-165):

  gemma: padding="max_length", truncation, max_length 77
         -> last hidden state                        (B, 77, 2304)
  bert:  padding="max_length", truncation, max_length 77
         -> last hidden state * attention_mask       (B, 77, 1024)
  clip:  padding=True, truncation
         -> text_projection(pooled)                  (B, 768)
  hidden = [gemma || zero-padded bert]               (B, 154, 2304)

The networks are `gemma2.Gemma2Encoder` and `modernbert.ModernBertEncoder`
in bf16, `clip_text.ClipTextEncoder` in fp16 and `vae.FluxVAE` in bf16, the
dtypes of the JAX suite. `embed_ids` takes token ids directly (no
tokenizer: what a run with random weights feeds); `text_to_embedding`
tokenizes first, with the tokenizers given to the constructor.

`from_pretrained(weights_dir, device)` reads a local directory of
snapshots, nothing fetched:
  <weights_dir>/gemma-2-2b/        tokenizer + safetensors (or .bin / .pt)
  <weights_dir>/modernbert-large/
  <weights_dir>/metaclip-l14/
  <weights_dir>/flux-vae/
Tokenizers through `transformers.AutoTokenizer`, weights through
`safetensors` or `torch.load`, both imported there and only there (the
card's machine may lack `transformers`). Keys of a snapshot's wider model
(a causal LM's `model.` prefix and head, CLIP's vision tower) are dropped;
every key of the port's module must be there (`strict=True`). Each
network's config is the one given, else the snapshot's `config.json`
(transformers' and diffusers' field names), else the published one.
"""

from __future__ import annotations

import dataclasses
import json
import os

import torch

from sd3_torch import resolve_device
from sd3_torch.models.clip_text import ClipTextConfig, ClipTextEncoder
from sd3_torch.models.gemma2 import Gemma2Config, Gemma2Encoder
from sd3_torch.models.modernbert import ModernBertConfig, ModernBertEncoder
from sd3_torch.models.text_encoders import (FLUX_LATENT_CHANNELS, TEXT_TOKENS,
                                            combine_hidden)
from sd3_torch.models.vae import FluxVAE, VAEConfig

SNAPSHOTS = ("gemma-2-2b", "modernbert-large", "metaclip-l14", "flux-vae")


def load_torch_dir(path: str) -> dict:
    """Every weight file of a snapshot directory in one state dict."""
    sd = {}
    for fn in sorted(os.listdir(path)):
        fp = os.path.join(path, fn)
        if fn.endswith(".safetensors"):
            from safetensors.torch import load_file
            sd.update(load_file(fp))
        elif fn.endswith((".bin", ".pt", ".pkl")):
            sd.update(torch.load(fp, map_location="cpu", weights_only=True))
    if not sd:
        raise FileNotFoundError(f"no weight files under {path}")
    return sd


def snapshot_config(path: str, cls):
    """`cls` (a config dataclass of the port) from the snapshot's
    config.json, its fields under their transformers / diffusers names; None
    without one."""
    fp = os.path.join(path, "config.json")
    if not os.path.exists(fp):
        return None
    with open(fp) as f:
        raw = json.load(f)
    if cls is ClipTextConfig:  # a CLIPModel's text config, or the tower's
        raw = {**raw.get("text_config", raw),
               "projection_dim": raw.get("projection_dim", 768)}
    if cls is VAEConfig:
        raw = {"block_out": tuple(raw["block_out_channels"]),
               "encoder_layers": raw["layers_per_block"],
               "decoder_layers": raw["layers_per_block"] + 1,
               "latent_ch": raw["latent_channels"]}
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: v for k, v in raw.items() if k in names})


def load_into(module: torch.nn.Module, sd: dict) -> torch.nn.Module:
    """`sd` into `module` strictly, after dropping a `model.` prefix and the
    keys of a wider model's other parts."""
    if not any(k in sd for k in module.state_dict()):
        sd = {k[len("model."):]: v for k, v in sd.items()
              if k.startswith("model.")}
    own = module.state_dict().keys()
    module.load_state_dict({k: v for k, v in sd.items() if k in own},
                           strict=True)
    return module


class RealTextEncoders:
    latent_channels = FLUX_LATENT_CHANNELS

    def __init__(self, gemma: Gemma2Encoder, bert: ModernBertEncoder,
                 clip: ClipTextEncoder, vae: FluxVAE, tokenizers=None):
        self.gemma, self.bert, self.clip, self.vae = gemma, bert, clip, vae
        self.tokenizers = tokenizers  # (gemma, bert, clip) or None
        self.device = vae.conv_device()

    @classmethod
    def build(cls, device="cuda", dtype=torch.bfloat16, gemma_cfg=None,
              bert_cfg=None, clip_cfg=None, vae_cfg=None, tokenizers=None):
        """The four networks at the configs given (the published ones by
        default) with PyTorch's initialisation: random weights, seeded by
        the caller's torch.manual_seed."""
        dev = resolve_device(device)
        return cls(Gemma2Encoder(gemma_cfg or Gemma2Config.gemma2_2b(),
                                 dtype=dtype, device=dev),
                   ModernBertEncoder(bert_cfg or
                                     ModernBertConfig.modernbert_large(),
                                     dtype=dtype, device=dev),
                   ClipTextEncoder(clip_cfg or ClipTextConfig.metaclip_l14(),
                                   dtype=torch.float16, device=dev),
                   FluxVAE(vae_cfg or VAEConfig.flux(), dtype=dtype,
                           device=dev),
                   tokenizers)

    @classmethod
    def from_pretrained(cls, weights_dir: str, device="cuda",
                        dtype=torch.bfloat16, gemma_cfg=None, bert_cfg=None,
                        clip_cfg=None, vae_cfg=None):
        """The suite from the snapshots under `weights_dir` (module
        docstring); built on the CPU, loaded, then moved to `device`."""
        from transformers import AutoTokenizer

        dirs = [os.path.join(weights_dir, s) for s in SNAPSHOTS]
        cfgs = [c or snapshot_config(d, k) for c, d, k in zip(
            (gemma_cfg, bert_cfg, clip_cfg, vae_cfg), dirs,
            (Gemma2Config, ModernBertConfig, ClipTextConfig, VAEConfig))]
        suite = cls.build("cpu", dtype, *cfgs, tokenizers=tuple(
                              AutoTokenizer.from_pretrained(d)
                              for d in dirs[:3]))
        for module, d in zip((suite.gemma, suite.bert, suite.clip, suite.vae),
                             dirs):
            load_into(module, load_torch_dir(d))
        return suite.to(resolve_device(device))

    def to(self, device):
        for m in (self.gemma, self.bert, self.clip, self.vae):
            m.to(device)
        self.device = self.vae.conv_device()
        return self

    def embed_ids(self, gemma_ids, gemma_mask, bert_ids, bert_mask,
                  clip_ids, clip_mask=None):
        """(hidden (B, 154, gemma hidden) in the suite's dtype, pooled (B,
        projection) fp32) from token ids and masks."""
        g = self.gemma(gemma_ids, gemma_mask)
        b = self.bert(bert_ids, bert_mask)
        b = b * bert_mask.to(b.device)[:, :, None].to(b.dtype)
        return combine_hidden(g, b), self.clip(clip_ids, clip_mask)[1]

    def text_to_embedding(self, text):
        if self.tokenizers is None:
            raise ValueError("this suite has no tokenizers: give them to the "
                             "constructor, or call embed_ids with token ids")
        if isinstance(text, str):
            text = [text]
        gt, bt, ct = self.tokenizers
        fixed = dict(return_tensors="pt", padding="max_length",
                     truncation=True, max_length=TEXT_TOKENS)
        g, b = gt(text, **fixed), bt(text, **fixed)
        c = ct(text, return_tensors="pt", padding=True, truncation=True)
        return self.embed_ids(g["input_ids"], g["attention_mask"],
                              b["input_ids"], b["attention_mask"],
                              c["input_ids"], c["attention_mask"])

    def vae_encode(self, images, generator: torch.Generator | None = None):
        return self.vae.encode_sample(images, generator)

    def vae_decode(self, latents):
        return self.vae.decode(latents)
