"""sd3_torch's sampler, stub encoders and inference CLI, held to sd3_tpu on
the CPU in fp32.

Both samplers get the same initial latents (numpy seed) and the same
weights. Tolerance atol 2e-4, rtol 2e-3 on the final latents: the model
parity of test_torch_model.py (1e-4 / 1e-3) compounded over the few Euler /
Heun steps, each of which adds v * dt with CFG weight (1 + w).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.inference.sampler import make_sample_fn
from sd3_tpu.models import text_encoders as jtext
from sd3_tpu.models.mmdit import MMDiT as JMMDiT
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.ops.quant import quantize_params

from sd3_torch.config import MMDiTConfig, tiny_config
from sd3_torch.inference import infer as tinfer
from sd3_torch.inference.sampler import (make_velocity_fn, sample_imgs,
                                         sample_latents)
from sd3_torch.models import text_encoders as ttext
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.ops import fused_dense as tfd
from sd3_torch.weights import state_dict_from_jax

ATOL, RTOL = 2e-4, 2e-3
STEPS = 3


@pytest.fixture(scope="module")
def pair():
    jcfg = j_tiny_config(attn_type="softmax_flash")
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(11), remat_blocks=False)
    model = MMDiT(MMDiTConfig.from_json(jcfg.to_json()),
                  device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    r = np.random.default_rng(12)
    x = r.standard_normal((2, jcfg.inCh, 8, 8)).astype(np.float32)
    th = r.standard_normal((2, jcfg.text_tokens, jcfg.text_hidden_dim)
                           ).astype(np.float32)
    tp = r.standard_normal((2, jcfg.class_dim)).astype(np.float32)
    return jm, params, model, x, th, tp


@pytest.mark.parametrize("sampler,dynamic", [("euler", False),
                                             ("heun", False),
                                             ("euler", True)])
def test_sampler_matches_jax(pair, sampler, dynamic):
    jm, params, model, x, th, tp = pair
    fn = make_sample_fn(jm, STEPS, sampler, dynamic_cfg=dynamic)
    want = fn(params, jnp.asarray(x), jnp.asarray(th), jnp.asarray(tp),
              jax.random.PRNGKey(0), jnp.float32(3.0))
    vel = make_velocity_fn(model, torch.from_numpy(th), torch.from_numpy(tp))
    got = sample_latents(vel, torch.from_numpy(x), STEPS, 3.0, sampler,
                         dynamic_cfg=dynamic)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_euler_stochastic_takes_the_given_noise(pair):
    _, _, model, x, th, tp = pair
    vel = make_velocity_fn(model, torch.from_numpy(th), torch.from_numpy(tp))
    x0 = torch.from_numpy(x)
    zero = torch.zeros((STEPS, *x.shape))
    # with zero noise the SDE step is the Euler step, exactly
    torch.testing.assert_close(
        sample_latents(vel, x0, STEPS, 2.0, "euler_stochastic", noise=zero),
        sample_latents(vel, x0, STEPS, 2.0, "euler"), rtol=0, atol=0)
    g = lambda: torch.Generator().manual_seed(3)
    a = sample_latents(vel, x0, STEPS, 2.0, "euler_stochastic", generator=g())
    b = sample_latents(vel, x0, STEPS, 2.0, "euler_stochastic", generator=g())
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sampler"):
        sample_latents(vel, x0, STEPS, 2.0, "bogus")


def test_stub_decode_matches_jax_given_the_same_projection():
    lat = np.random.default_rng(13).standard_normal((2, 16, 3, 5)
                                                    ).astype(np.float32)
    want = jtext.StubTextEncoders().vae_decode(jnp.asarray(lat))
    proj = np.array(jax.random.normal(jax.random.PRNGKey(0), (16, 3 * 64)))
    got = ttext.stub_decode(torch.from_numpy(lat), torch.from_numpy(proj))
    assert tuple(got.shape) == (2, 3, 24, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def test_text_helpers_match_jax():
    r = np.random.default_rng(14)
    g = r.standard_normal((2, 5, 12)).astype(np.float32)
    b = r.standard_normal((2, 5, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        ttext.combine_hidden(torch.from_numpy(g), torch.from_numpy(b)).numpy(),
        np.asarray(jtext.combine_hidden(jnp.asarray(g), jnp.asarray(b))))
    z = r.standard_normal((2, 4)).astype(np.float32)
    for tf, jf in ((ttext.normalize_latents, jtext.normalize_latents),
                   (ttext.denormalize_latents, jtext.denormalize_latents)):
        np.testing.assert_allclose(tf(torch.from_numpy(z)).numpy(),
                                   np.asarray(jf(jnp.asarray(z))), rtol=1e-6)


def test_stub_encoders_are_deterministic_and_sized():
    enc = ttext.StubTextEncoders(device="cpu")
    h1, p1 = enc.text_to_embedding(["a red fox", "a cat"])
    h2, p2 = enc.text_to_embedding("a red fox")
    assert tuple(h1.shape) == (2, 154, 2304) and tuple(p1.shape) == (2, 768)
    assert torch.equal(h1[:1], h2) and torch.equal(p1[:1], p2)
    assert torch.all(h1[:, 77:, 1024:] == 0)
    img = torch.rand((1, 3, 16, 24)) * 2 - 1
    assert tuple(enc.vae_encode(img).shape) == (1, 16, 2, 3)


def test_sample_imgs_end_to_end_on_cpu(pair):
    _, _, model, *_ = pair
    enc = ttext.load_text_encoders(device="cpu", stub=True,
                                   model_cfg=model.cfg)
    imgs = sample_imgs(model, enc, 2, 2, "a red fox", cfg_scale=4.0,
                       width=64, height=48, sampler="heun",
                       generator=torch.Generator().manual_seed(5))
    assert tuple(imgs.shape) == (2, 3, 48, 64)
    assert torch.isfinite(imgs).all() and imgs.abs().max() <= 1


def _write_reference_checkpoint(tmp_path):
    cfg = tiny_config(attn_type="softmax_flash")
    sd = MMDiT(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(6)).state_dict()
    sd["pos_enc.pos_embed"] = torch.zeros(1)  # a buffer references carry
    torch.save(sd, tmp_path / "model_3s.pkl")
    (tmp_path / "model_params_3s.json").write_text(cfg.to_json())
    return ["--loadDir", str(tmp_path), "--torch_ckpt", "model_3s.pkl",
            "--loadDefFile", "model_params_3s.json", "--text_input", "a fox",
            "--num_steps", "2", "--width", "16", "--height", "16",
            "--batch_size", "2", "--seed", "7", "--stub_encoders"]


def test_infer_cli_on_cpu_writes_pngs_and_latents(tmp_path):
    args = _write_reference_checkpoint(tmp_path)
    out = tmp_path / "fig"
    lat = tmp_path / "lat.npy"
    tinfer.main(args + ["--device", "cpu", "--out_imgname", str(out),
                        "--save_latents", str(lat)])
    assert (tmp_path / "fig_0.png").is_file()
    assert (tmp_path / "fig_1.png").is_file()
    z = np.load(lat)
    assert z.shape == (2, 4, 2, 2) and np.isfinite(z).all()
    # the same seed gives the same latents
    tinfer.main(args + ["--device", "cpu", "--out_imgname", str(out),
                        "--save_latents", str(tmp_path / "lat2.npy")])
    np.testing.assert_array_equal(np.load(tmp_path / "lat2.npy"), z)


def test_int8_sampler_matches_jax():
    # int8 serving, a few Euler steps with CFG: the JAX int8 model and its
    # quantized tree against the port's int8 model with the same weights.
    # 16x16 latents: the CFG batch of 4 x 64 image tokens takes K2's route,
    # the text stream K3's, attention K1's (78 tokens, below K4's gate).
    # Each step feeds the next, so the int8 model parity of
    # test_torch_model.py (rel L2 <= 1e-2, for discontinuous rounding)
    # holds the final latents too.
    jcfg = j_tiny_config(attn_type="softmax_flash", dim=64, hidden_scale=2.0,
                         num_heads=2)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(15), height=16,
                           width=16, remat_blocks=False)
    qparams = quantize_params(params)
    jq = JMMDiT(jcfg.replace(quant="int8"), remat_blocks=False)
    model = MMDiT(MMDiTConfig.from_json(jcfg.to_json(), quant="int8"),
                  device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(qparams), strict=True)
    r = np.random.default_rng(16)
    x = r.standard_normal((2, jcfg.inCh, 16, 16)).astype(np.float32)
    th = r.standard_normal((2, jcfg.text_tokens, jcfg.text_hidden_dim)
                           ).astype(np.float32)
    tp = r.standard_normal((2, jcfg.class_dim)).astype(np.float32)
    want = np.asarray(make_sample_fn(jq, STEPS, "euler")(
        qparams, jnp.asarray(x), jnp.asarray(th), jnp.asarray(tp),
        jax.random.PRNGKey(0), jnp.float32(3.0)))
    vel = make_velocity_fn(model, torch.from_numpy(th), torch.from_numpy(tp))
    got = sample_latents(vel, torch.from_numpy(x), STEPS, 3.0, "euler").numpy()
    assert np.isfinite(got).all()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-2, rel


def test_infer_cli_int8_on_cpu(tmp_path):
    # --quant int8 loads the float checkpoint, quantizes, casts and samples
    # through the plain versions of the int8 kernels; the result is close
    # to, and not the same as, the float run's
    args = _write_reference_checkpoint(tmp_path) + ["--device", "cpu"]
    tinfer.main(args + ["--out_imgname", str(tmp_path / "f"),
                        "--save_latents", str(tmp_path / "f.npy")])
    tinfer.main(args + ["--quant", "int8", "--quant_skip", "attn_qk",
                        "--out_imgname", str(tmp_path / "q"),
                        "--save_latents", str(tmp_path / "q.npy")])
    flt, q8 = np.load(tmp_path / "f.npy"), np.load(tmp_path / "q.npy")
    assert (tmp_path / "q_1.png").is_file() and np.isfinite(q8).all()
    assert not np.array_equal(flt, q8)
    assert np.linalg.norm(q8 - flt) / np.linalg.norm(flt) < 0.1


@pytest.mark.parametrize("extra,err", [
    (["--device", "cuda"], RuntimeError),
    (["--device", "cpu", "--gif", "--save_latents", "x.npy"], SystemExit),
    (["--device", "cpu", "--attn_tail", "all"], SystemExit),
])
def test_infer_cli_refuses_what_it_cannot_do(tmp_path, monkeypatch, extra,
                                             err):
    # no card; --gif with --save_latents (exclusive, as in the JAX CLI); an
    # int8 option without --quant int8; a native checkpoint without --step
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = _write_reference_checkpoint(tmp_path)
    with pytest.raises(err):
        tinfer.main(args + extra)
    native = ["--loadDir", str(tmp_path), "--text_input", "x", "--device",
              "cpu"]
    with pytest.raises(ValueError, match="--step"):
        tinfer.main(native)


def test_sampler_past_2048_tokens_matches_jax():
    # two Euler / CFG steps at a 1024px-stage length (96x96 latents at
    # patch 2: 2304 image + 14 text = 2318 joint tokens, past the single-KV
    # 2048), so both packages take the streaming attention (JAX's fused
    # streaming kernel in interpret mode; K7's plain version here); the
    # sampler tolerance of this file
    jcfg = j_tiny_config(attn_type="softmax_flash")
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(17), height=96,
                            width=96, remat_blocks=False)
    model = MMDiT(MMDiTConfig.from_json(jcfg.to_json()), device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    r = np.random.default_rng(18)
    x = r.standard_normal((1, jcfg.inCh, 96, 96)).astype(np.float32)
    th = r.standard_normal((1, jcfg.text_tokens, jcfg.text_hidden_dim)
                           ).astype(np.float32)
    tp = r.standard_normal((1, jcfg.class_dim)).astype(np.float32)
    want = make_sample_fn(jm, 2, "euler")(
        params, jnp.asarray(x), jnp.asarray(th), jnp.asarray(tp),
        jax.random.PRNGKey(0), jnp.float32(3.0))
    vel = make_velocity_fn(model, torch.from_numpy(th), torch.from_numpy(tp))
    got = sample_latents(vel, torch.from_numpy(x), 2, 3.0, "euler")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=RTOL)


def test_infer_cli_int8_pv_past_2048_tokens(tmp_path):
    # --int8_pv rides --quant int8 only; at 768px (96x96 latents, 2318 joint
    # tokens) it switches the streaming attention to int8 P.V: close to, and
    # not the same as, the int8 run without it
    args = _write_reference_checkpoint(tmp_path) + [
        "--device", "cpu", "--width", "768", "--height", "768",
        "--batch_size", "1", "--quant", "int8"]
    with pytest.raises(SystemExit):
        tinfer.main(_write_reference_checkpoint(tmp_path) + [
            "--device", "cpu", "--int8_pv"])
    tinfer.main(args + ["--out_imgname", str(tmp_path / "a"),
                        "--save_latents", str(tmp_path / "a.npy")])
    tinfer.main(args + ["--int8_pv", "--out_imgname", str(tmp_path / "p"),
                        "--save_latents", str(tmp_path / "p.npy")])
    q8, pv = np.load(tmp_path / "a.npy"), np.load(tmp_path / "p.npy")
    assert pv.shape == (1, 4, 96, 96) and np.isfinite(pv).all()
    assert (tmp_path / "p_0.png").is_file()
    assert not np.array_equal(q8, pv)
    assert np.linalg.norm(pv - q8) / np.linalg.norm(q8) < 0.05


def test_infer_cli_int8_block_tails(tmp_path, monkeypatch):
    # the block-tail flags ride --quant int8 only; at 128px (64 image tokens
    # a sample, CFG batch 4) the image stream takes K10a / K10b's routes.
    # In fp32 the tails' roundings are no-ops, so the latents stay within
    # 1e-4 relative of the int8 run without them (the int8 levels alone
    # could move one of them: their sums are taken in another order)
    args = _write_reference_checkpoint(tmp_path) + [
        "--device", "cpu", "--width", "128", "--height", "128",
        "--quant", "int8"]
    for flag in (["--attn_tail", "all"], ["--mlp_tail_fusion", "3d"],
                 ["--no_mlp_tail"], ["--no_fused_mlp"]):
        with pytest.raises(SystemExit):
            tinfer.main(_write_reference_checkpoint(tmp_path) + [
                "--device", "cpu"] + flag)
    tinfer.main(args + ["--out_imgname", str(tmp_path / "a"),
                        "--save_latents", str(tmp_path / "a.npy")])
    calls = []
    monkeypatch.setattr(tfd, "qkv_adaln_int8",
                        lambda *a, _f=tfd.qkv_adaln_int8: calls.append(1)
                        or _f(*a))
    tinfer.main(args + ["--attn_tail", "all", "--mlp_tail_fusion", "3d",
                        "--no_mlp_tail", "--out_imgname", str(tmp_path / "t"),
                        "--save_latents", str(tmp_path / "t.npy")])
    assert len(calls) == 2 * 2   # 2 blocks x 2 steps
    q8, tl = np.load(tmp_path / "a.npy"), np.load(tmp_path / "t.npy")
    assert (tmp_path / "t_1.png").is_file() and np.isfinite(tl).all()
    assert np.linalg.norm(tl - q8) / np.linalg.norm(q8) < 1e-4
