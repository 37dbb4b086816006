"""Rectified-flow objective and time sampling (JAX counterpart:
sd3_tpu/training/flow.py; reference semantics):

- noising: x_t = (1-t)·x0 + t·ε                     (diff_model.noise_batch:229-241)
- target:  v = ε − x0                                (model_trainer.py:423-429)
- t ~ sigmoid(N(0,1)) ("logit-normal", TimeSampler.py:5-22)
- loss: MSE(v_pred, v), optional SD3 lognorm weighting (model_trainer.py:429-446)
- null-conditioning drops: independent Bernoulli masks for pooled/Gemma/BERT
  with probs 0.1/0.316/0.316 (train.py:50-55)
- the optional text-reconstruction loss (model_trainer.py:399-414): a
  quarter of the text tokens masked (zeroed in the model's input), only in
  the encoder halves whose null flag is set, and the masked tokens' MSE
  against the original embeddings.

Random draws take an explicit `torch.Generator`, which lies on the device
the draws are made on. It gives other numbers than `jax.random` from the
same seed, so the tests feed the same draws to both packages.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


def sample_t(generator: torch.Generator, n: int, weighted: bool = True,
             m: float = 0.0, s: float = 1.0) -> torch.Tensor:
    """Logit-normal (weighted=True) or uniform flow-time samples in (0, 1),
    (n,) fp32 on the generator's device."""
    dev = generator.device
    if weighted:
        u = torch.randn(n, generator=generator, device=dev) * s + m
        return torch.sigmoid(u)
    return torch.rand(n, generator=generator, device=dev)


def noised(x0: torch.Tensor, t: torch.Tensor, eps: torch.Tensor
           ) -> torch.Tensor:
    """x_t = (1-t) x0 + t ε, t broadcast over the sample's dims."""
    tb = t.reshape(-1, *([1] * (x0.ndim - 1))).to(x0.dtype)
    return (1.0 - tb) * x0 + tb * eps


def noise_batch(generator: torch.Generator, x0: torch.Tensor,
                t: torch.Tensor):
    """x_t = (1-t) x0 + t ε with ε ~ N(0, 1) drawn like x0; returns
    (x_t, ε)."""
    eps = torch.randn(x0.shape, generator=generator, device=x0.device,
                      dtype=x0.dtype)
    return noised(x0, t, eps), eps


def null_masks(generator: torch.Generator, n: int, p_pooled: float = 0.1,
               p_gemma: float = 0.316, p_bert: float = 0.316):
    """Independent per-sample null-conditioning masks (True = drop)."""
    dev = generator.device
    return tuple(torch.rand(n, generator=generator, device=dev) < p
                 for p in (p_pooled, p_gemma, p_bert))


def lognorm_weight(t: torch.Tensor, m: float = 0.0, s: float = 1.0
                   ) -> torch.Tensor:
    """SD3 lognorm loss weight (reference model_trainer.py:437-441)."""
    t = t.float()
    ln = (1.0 / (s * math.sqrt(2 * math.pi))) * (1.0 / (t * (1 - t))) * torch.exp(
        -((torch.log(t / (1 - t)) - m) ** 2) / (2 * s * s))
    return (t / (1 - t)) * ln


def velocity_loss(v_pred: torch.Tensor, x0: torch.Tensor, eps: torch.Tensor,
                  t: torch.Tensor | None = None, weigh_loss: bool = False
                  ) -> torch.Tensor:
    """MSE(v_pred, ε − x0) in fp32, optionally lognorm-weighted per
    sample."""
    target = (eps - x0).float()
    err = (v_pred.float() - target).square()
    if weigh_loss:
        if t is None:
            raise ValueError("weigh_loss needs the flow times t")
        per = err.reshape(err.shape[0], -1).mean(1)
        return (per * lognorm_weight(t)).mean()
    return err.mean()


class TextLossBatch(NamedTuple):
    """The text loss's inputs and labels (sd3_tpu/training/flow.py:65-70)."""
    text_in: torch.Tensor     # masked text embeddings fed to the model
    labels: torch.Tensor      # the original embeddings
    loss_mask: torch.Tensor   # (B, S) True where the loss applies


def text_mask_draw(generator: torch.Generator, b: int, s: int,
                   percent_to_mask: float = 0.25) -> torch.Tensor:
    """(B, S) bool: uniform draws below `percent_to_mask`, before the null
    flags gate them."""
    return torch.rand(b, s, generator=generator,
                      device=generator.device) < percent_to_mask


def text_loss_batch(text: torch.Tensor, drawn: torch.Tensor,
                    null_gemma: torch.Tensor, null_bert: torch.Tensor,
                    tokens_per_encoder: int) -> TextLossBatch:
    """The masked batch from the drawn mask: tokens of the Gemma half stay
    masked only where null_gemma is set, of the BERT half where null_bert is
    (sd3_tpu/training/flow.py:79-83)."""
    tt = tokens_per_encoder
    mask = torch.cat([drawn[:, :tt] & null_gemma[:, None],
                      drawn[:, tt:] & null_bert[:, None]], dim=1)
    return TextLossBatch(text * (~mask[:, :, None]), text, mask)


def make_text_loss_batch(generator: torch.Generator, text: torch.Tensor,
                         null_gemma: torch.Tensor, null_bert: torch.Tensor,
                         tokens_per_encoder: int,
                         percent_to_mask: float = 0.25) -> TextLossBatch:
    """`text_loss_batch` of a fresh draw (sd3_tpu/training/flow.py:73-83)."""
    drawn = text_mask_draw(generator, text.shape[0], text.shape[1],
                           percent_to_mask)
    return text_loss_batch(text, drawn, null_gemma, null_bert,
                           tokens_per_encoder)


def text_recon_loss(txt_pred: torch.Tensor, batch: TextLossBatch
                    ) -> torch.Tensor:
    """mean((pred - labels)^2 * mask) in fp32 over every element, masked
    or not (sd3_tpu/training/flow.py:86-89)."""
    err = (txt_pred.float() - batch.labels.float()).square()
    return (err * batch.loss_mask[:, :, None]).mean()
