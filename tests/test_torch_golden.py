"""The port's CPU sampling path held to the golden fixtures that hold the
JAX package (tests/test_golden_parity.py), case for case, at its gates.

- tests/fixtures/golden_mid.npz: the fp32 torch oracle
  (tests/torch_ref/mini_mmdit.py through scripts/gen_golden.py: 14 blocks,
  dim 640, 10 heads of 64, 128px, 4 steps at CFG 5). Gate atol 5e-3,
  rtol 1e-3, as for JAX.
- tests/fixtures/golden_ref.npz: the literal reference's sample_imgs, which
  runs its attention in bf16: gate atol 6e-2, as for JAX.

The oracle's weights are regenerated from their seeds
(`scripts.gen_golden.build_model`), loaded strictly through
`sd3_torch.weights.load_reference_state_dict`, and the port's own sampler
(`sd3_torch.inference.sampler`) runs from the fixture's noise in fp32 on the
CPU, through the plain versions of the kernels.
"""

import os

import numpy as np
import pytest
import torch

from scripts.gen_golden import (GOLD, GOLD_EXP, GUIDANCE, NUM_STEPS,
                                WEIGHT_SEED, build_inputs, build_model)
from tests.torch_ref.mini_mmdit import MiniMMDiT

from sd3_torch.config import tiny_config
from sd3_torch.inference.sampler import make_velocity_fn, sample_latents
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.weights import load_reference_state_dict

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "fixtures")
MID_GATE = dict(atol=5e-3, rtol=1e-3)
REF_GATE = dict(atol=6e-2, rtol=0)


def _port(sd, fields, attn="softmax_flash"):
    model = MMDiT(tiny_config(**{**fields, "attn_type": attn}), device="cpu")
    load_reference_state_dict(model, sd)
    return model.eval()


@pytest.fixture(scope="module")
def oracle():
    """The oracle's state dicts (GOLD from WEIGHT_SEED, GOLD_EXP from
    WEIGHT_SEED + 1, as scripts/gen_golden.py draws them) and its inputs."""
    sd = build_model().state_dict()
    torch.manual_seed(WEIGHT_SEED + 1)
    sd_exp = MiniMMDiT(**GOLD_EXP).eval().state_dict()
    noise, text, pooled = build_inputs()
    return sd, sd_exp, noise, text, pooled


def _sample(model, noise, text, pooled, sampler="euler", step_noise=None):
    """(the first step's CFG velocity, the final latents), both fp32 numpy."""
    vel = make_velocity_fn(model, text, pooled)
    first = []

    def velocity(x, t, w):
        v = vel(x, t, w)
        if not first:
            first.append(v)
        return v

    lat = sample_latents(velocity, torch.as_tensor(np.asarray(noise)),
                         NUM_STEPS, GUIDANCE, sampler,
                         noise=None if step_noise is None
                         else torch.as_tensor(np.asarray(step_noise)))
    return first[0].numpy(), lat.numpy()


def _check(got, want, gate):
    np.testing.assert_allclose(got, want, **gate)


@pytest.mark.parametrize("attn", ["softmax", "softmax_flash"])
def test_golden_euler_latents(oracle, attn):
    sd, _, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_mid.npz"))
    v_first, lat = _sample(_port(sd, GOLD, attn), noise, text, pooled)
    _check(v_first, fx["v_first"], MID_GATE)
    _check(lat, fx["latents"], MID_GATE)


@pytest.mark.parametrize("sampler,key", [("euler_stochastic",
                                          "latents_stochastic"),
                                         ("heun", "latents_heun")])
def test_golden_sampler_matrix(oracle, sampler, key):
    sd, _, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_mid.npz"))
    step_noise = fx["step_noise"] if sampler == "euler_stochastic" else None
    _, lat = _sample(_port(sd, GOLD), noise, text, pooled,
                     sampler, step_noise)
    _check(lat, fx[key], MID_GATE)


def test_golden_nonsquare(oracle):
    """h != w token grid (6 x 10): the 2-D RoPE axes and the patch layout."""
    sd, _, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_mid.npz"))
    v_first, lat = _sample(_port(sd, GOLD), fx["nonsq_noise"], text, pooled)
    _check(v_first, fx["v_first_nonsq"], MID_GATE)
    _check(lat, fx["latents_nonsq"], MID_GATE)


def test_golden_kv_merge_qk_half(oracle):
    """kv_merge_attn + qk_half_dim, the oracle's weights of WEIGHT_SEED + 1."""
    _, sd_exp, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_mid.npz"))
    v_first, lat = _sample(_port(sd_exp, GOLD_EXP, "softmax"),
                           noise, text, pooled)
    _check(v_first, fx["v_first_exp"], MID_GATE)
    _check(lat, fx["latents_exp"], MID_GATE)


@pytest.mark.parametrize("attn", ["softmax", "softmax_flash"])
def test_reference_golden_euler(oracle, attn):
    sd, _, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_ref.npz"))
    v_first, lat = _sample(_port(sd, GOLD, attn), fx["init_noise"], text,
                           pooled)
    _check(v_first, fx["v_first"], REF_GATE)
    _check(lat, fx["latents"], REF_GATE)


@pytest.mark.parametrize("sampler,key", [("heun", "latents_heun"),
                                         ("euler_stochastic",
                                          "latents_stochastic")])
def test_reference_golden_sampler_matrix(oracle, sampler, key):
    sd, _, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_ref.npz"))
    step_noise = fx["step_noise"] if sampler == "euler_stochastic" else None
    _, lat = _sample(_port(sd, GOLD), fx["init_noise"], text, pooled,
                     sampler, step_noise)
    _check(lat, fx[key], REF_GATE)


def test_a_perturbed_block_fails_the_gate(oracle):
    """The control: one block's weights moved by 1% fail the golden_mid
    gate, so the gate tells a right model from a nearly right one."""
    sd, _, noise, text, pooled = oracle
    fx = np.load(os.path.join(FIXTURES, "golden_mid.npz"))
    bad = dict(sd)
    name = next(k for k in sd if ".7." in k and k.endswith("weight")
                and sd[k].ndim == 2)
    bad[name] = sd[name] * 1.01
    _, lat = _sample(_port(bad, GOLD), noise, text, pooled)
    with pytest.raises(AssertionError):
        _check(lat, fx["latents"], MID_GATE)
