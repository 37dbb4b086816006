"""CFG flow samplers (JAX counterpart: sd3_tpu/inference/sampler.py;
reference diff_model.sample_imgs, diff_model.py:367-480):

- timesteps = linspace(1, 1/num_steps, num_steps), dt = 1/num_steps;
- CFG as a doubled batch: first half conditional, second half with all three
  null masks set; v = (1+w) v_cond - w v_uncond, with the optional "dynamic"
  scale w t^2;
- euler (x <- x - v dt), euler_stochastic (x <- x - v dt + sigma(t) noise
  sqrt(dt), sigma = t(1-t)/(1-t+0.008)) and heun (two model calls a step).

Latents and the CFG combination stay fp32. The initial latents and the
per-step noise come in as arguments or from a torch.Generator the caller
passes, so a test can hand both packages the same noise. The loop is a
Python loop of eager model calls (JAX scans it in one program).
"""

from __future__ import annotations

from typing import Callable

import torch

SAMPLERS = ("euler", "euler_stochastic", "heun")


def make_velocity_fn(model, text_hidden: torch.Tensor,
                     text_pooled: torch.Tensor) -> Callable:
    """v(x, t, w) with CFG doubling baked in; text_hidden (B, S, D) and
    text_pooled (B, P) belong to the B latents being sampled. A `text_loss`
    model's text prediction is dropped (sd3_tpu/inference/sampler.py:
    44-45)."""
    b = text_hidden.shape[0]
    dev = text_hidden.device
    null = torch.cat([torch.zeros(b, dtype=torch.bool, device=dev),
                      torch.ones(b, dtype=torch.bool, device=dev)])
    th2 = torch.cat([text_hidden, text_hidden])
    tp2 = torch.cat([text_pooled, text_pooled])

    def velocity(x, t: float, w: float):
        x2 = torch.cat([x, x])
        t2 = torch.full((2 * b,), t, dtype=torch.float32, device=x.device)
        out = model(x2, t2, th2, tp2, null, null, null)
        if isinstance(out, tuple):
            out = out[0]
        return (1.0 + w) * out[:b] - w * out[b:]

    return velocity


@torch.inference_mode()
def sample_latents(velocity_fn: Callable, x_init: torch.Tensor, num_steps: int,
                   cfg_scale: float, sampler: str = "euler",
                   dynamic_cfg: bool = False, noise: torch.Tensor | None = None,
                   generator: torch.Generator | None = None,
                   on_step: Callable | None = None) -> torch.Tensor:
    """Run the flow ODE/SDE from t=1 noise to t~0 latents (fp32).

    euler_stochastic draws its per-step noise from `noise` (num_steps, *x
    shape) if given, else from `generator` (on any device). `on_step(x)`,
    when given, sees the latents after every step."""
    if sampler not in SAMPLERS:
        raise ValueError(f"sampler must be one of {SAMPLERS}, got {sampler!r}")
    timesteps = torch.linspace(1.0, 1.0 / num_steps, num_steps,
                               dtype=torch.float32).tolist()
    dt = 1.0 / num_steps
    x = x_init.float()
    for i, t in enumerate(timesteps):
        w = cfg_scale * t ** 2 if dynamic_cfg else cfg_scale
        v = velocity_fn(x, t, w)
        if sampler == "euler":
            x = x - v * dt
        elif sampler == "euler_stochastic":
            sigma = t * (1 - t) / (1 - t + 0.008)
            if noise is not None:
                nz = noise[i].to(x.device, torch.float32)
            else:
                gdev = generator.device if generator is not None else x.device
                nz = torch.randn(x.shape, generator=generator,
                                 device=gdev).to(x.device)
            x = x - v * dt + sigma * nz * dt ** 0.5
        else:  # heun
            v2 = velocity_fn(x - v * dt, t - dt, w)
            x = x - (dt / 2.0) * (v + v2)
        if on_step is not None:
            on_step(x)
    return x


def sample_imgs(model, text_encoders, batch_size: int, num_steps: int,
                text_input, cfg_scale: float = 0.0, width: int = 256,
                height: int = 256, sampler: str = "euler",
                generator: torch.Generator | None = None,
                x_init: torch.Tensor | None = None, decode: bool = True,
                save_intermediate: bool = False):
    """End-to-end text -> image sampling (reference sample_imgs API). The
    initial latents are `x_init` or drawn from `generator` (default: a CPU
    generator seeded 0) and moved to the model's device. With
    `save_intermediate` (the GIF path) it returns (images or latents, the
    decode of the first sample after every step), as the JAX package's
    stepwise loop does."""
    device = next(model.parameters()).device
    if x_init is None:
        if generator is None:
            generator = torch.Generator(device="cpu").manual_seed(0)
        x_init = torch.randn(
            (batch_size, text_encoders.latent_channels, height // 8, width // 8),
            generator=generator, device=generator.device)
    x_init = x_init.to(device, torch.float32)
    text_hidden, text_pooled = text_encoders.text_to_embedding(text_input)
    if text_hidden.shape[0] == 1 and batch_size > 1:
        text_hidden = text_hidden.repeat(batch_size, 1, 1)
        text_pooled = text_pooled.repeat(batch_size, 1)
    vel = make_velocity_fn(model, text_hidden.to(device), text_pooled.to(device))
    frames = []
    on_step = ((lambda x: frames.append(text_encoders.vae_decode(x[:1])))
               if save_intermediate else None)
    lat = sample_latents(vel, x_init, num_steps, cfg_scale, sampler,
                         generator=generator, on_step=on_step)
    out = text_encoders.vae_decode(lat) if decode else lat
    return (out, frames) if save_intermediate else out
