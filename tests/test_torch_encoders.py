"""The port's frozen networks held to the JAX modules on the CPU: the FLUX
VAE (`models/vae.py`), the CLIP text tower, Gemma-2 and ModernBERT, with the
JAX parameters (seeded init, then numpy noise on the norms and biases)
carried across by `sd3_torch.weights.*_state_dict_from_jax`, and inputs
from numpy seeds.

Limits: fp32 against fp32 within FP32_REL_L2 = 1e-5 rel L2 (the two
frameworks sum in other orders; nothing else differs); the serving dtypes
(bf16 Gemma-2, ModernBERT and VAE, fp16 CLIP) against the JAX module in the
same dtype within SERVING_REL_L2 = 2e-2 (each framework rounds its bf16 /
fp16 activations at other points: XLA rounds each elementwise op of the
GELUs and norms' products to the dtype, PyTorch computes them in fp32 and
rounds once; one bf16 rounding is 2^-9 = 2e-3 relative, and a dozen layers
of such steps stay within 2e-2). Each importer round trip gives back its
state dict bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.models import clip_text as jclip
from sd3_tpu.models import gemma2 as jgemma
from sd3_tpu.models import modernbert as jbert
from sd3_tpu.models import vae as jvae

from sd3_torch import weights as tw
from sd3_torch.models import clip_text as tclip
from sd3_torch.models import gemma2 as tgemma
from sd3_torch.models import modernbert as tbert
from sd3_torch.models import vae as tvae

FP32_REL_L2 = 1e-5
SERVING_REL_L2 = 2e-2


def _np_tree(tree, seed):
    """The JAX params as numpy fp32, 1-D leaves (norms, biases) moved off
    their init (ones, zeros) by seeded noise so that they are seen."""
    r = np.random.default_rng(seed)

    def leaf(x):
        x = np.asarray(x, np.float32)
        if x.ndim == 1:
            x = x + 0.1 * r.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map(leaf, tree)


def _rel_l2(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _jdt(dtype):
    return {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
            torch.float16: jnp.float16}[dtype]


def _ids_mask(vocab, b, t, seed, valid=None):
    r = np.random.default_rng(seed)
    ids = r.integers(0, vocab, (b, t)).astype(np.int32)
    mask = np.ones((b, t), np.int32)
    for i, n in enumerate(valid or []):
        mask[i, n:] = 0
    return ids, mask


# ---- the VAE -------------------------------------------------------------

@pytest.fixture(scope="module")
def vae_case():
    """The published FluxVAE: JAX params and a 32x32 image (4x4 latents)."""
    img = np.random.default_rng(1).uniform(-1, 1, (2, 3, 32, 32)).astype(
        np.float32)
    vae = jvae.FluxVAE()
    params = vae.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(img),
                      jax.random.PRNGKey(1))["params"]
    return _np_tree(params, 2), img


def _port_vae(params, dtype=torch.float32):
    m = tvae.FluxVAE(dtype=dtype, device="cpu")
    m.load_state_dict(tw.flux_vae_state_dict_from_jax(params), strict=True)
    return m


@pytest.mark.parametrize("dtype,limit", [(torch.float32, FP32_REL_L2),
                                         (torch.bfloat16, SERVING_REL_L2)])
def test_vae_matches_jax(vae_case, dtype, limit):
    # encode_moments (mean, clipped logvar), encode_sample's normalisation
    # (the same posterior noise given to both) and decode, at the published
    # widths
    params, img = vae_case
    jv = jvae.FluxVAE(dtype=_jdt(dtype))
    p = {"params": params}
    mean, logvar = jv.apply(p, jnp.asarray(img), method=jvae.FluxVAE.encode_moments)
    m = _port_vae(params, dtype)
    tmean, tlogvar = m.encode_moments(torch.from_numpy(img))
    assert tmean.shape == (2, 16, 4, 4) and tmean.dtype == torch.float32
    assert _rel_l2(tmean, mean) <= limit
    assert _rel_l2(tlogvar, logvar) <= limit
    assert float(tlogvar.min()) >= -30 and float(tlogvar.max()) <= 20
    # the posterior draw: JAX's noise, handed to the port's formula
    noise = jax.random.normal(jax.random.PRNGKey(3), mean.shape)
    z = jv.apply(p, jnp.asarray(img), jax.random.PRNGKey(3),
                 method=jvae.FluxVAE.encode_sample)
    gen = torch.Generator().manual_seed(0)
    tz = m.encode_sample(torch.from_numpy(img), gen)
    eps = torch.randn(tz.shape, generator=torch.Generator().manual_seed(0))
    want_tz = tvae.normalize_latents(tmean + torch.exp(0.5 * tlogvar) * eps)
    assert torch.equal(tz, want_tz)
    port_z = tvae.normalize_latents(tmean + torch.exp(0.5 * tlogvar) *
                                    torch.from_numpy(np.asarray(noise)))
    assert _rel_l2(port_z, z) <= limit
    out = jv.apply(p, z, method=jvae.FluxVAE.decode)
    got = m.decode(torch.from_numpy(np.asarray(z)))
    assert got.shape == (2, 3, 32, 32) and got.dtype == torch.float32
    assert float(got.abs().max()) <= 1.0
    assert _rel_l2(got, out) <= limit


def test_vae_mid_attention_matters(vae_case):
    # the limit has teeth: the decoder without its mid attention is far
    # outside it
    params, img = vae_case
    z = np.random.default_rng(4).standard_normal((2, 16, 4, 4)).astype(
        np.float32)
    m = _port_vae(params)
    want = m.decode(torch.from_numpy(z))
    m.decoder.mid_block.attentions[0].forward = lambda x: x
    assert _rel_l2(m.decode(torch.from_numpy(z)), want) > 100 * FP32_REL_L2


def test_vae_state_dict_round_trips_through_the_jax_importer():
    m = tvae.FluxVAE(device="cpu")
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    back = tw.flux_vae_state_dict_from_jax(jvae.import_flux_vae_state_dict(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)


# ---- the text towers -----------------------------------------------------

def _clip(cfg, params, dtype):
    m = tclip.ClipTextEncoder(cfg, dtype=dtype, device="cpu")
    m.load_state_dict(tw.clip_text_state_dict_from_jax(params), strict=True)
    return m


def _gemma(cfg, params, dtype):
    m = tgemma.Gemma2Encoder(cfg, dtype=dtype, device="cpu")
    m.load_state_dict(tw.gemma2_state_dict_from_jax(params), strict=True)
    return m


def _bert(cfg, params, dtype):
    m = tbert.ModernBertEncoder(cfg, dtype=dtype, device="cpu")
    m.load_state_dict(tw.modernbert_state_dict_from_jax(params), strict=True)
    return m


# (JAX module, its config, the port's config and constructor, token count,
# valid lengths):
# ModernBERT at 24 tokens, three times its window of +-4, so the local
# layers' mask cuts
TOWERS = {
    "clip": (jclip.ClipTextEncoder, jclip.ClipTextConfig.tiny(),
             tclip.ClipTextConfig.tiny(), _clip, 12, [9, 12]),
    "gemma2": (jgemma.Gemma2Encoder, jgemma.Gemma2Config.tiny(),
               tgemma.Gemma2Config.tiny(), _gemma, 11, [7, 11]),
    "modernbert": (jbert.ModernBertEncoder, jbert.ModernBertConfig.tiny(),
                   tbert.ModernBertConfig.tiny(), _bert, 24, [17, 24]),
}
SERVING = {"clip": torch.float16, "gemma2": torch.bfloat16,
           "modernbert": torch.bfloat16}


def _tower_case(name, seed=0):
    jmod, jcfg, tcfg, build, t, valid = TOWERS[name]
    ids, mask = _ids_mask(jcfg.vocab_size, 2, t, seed, valid)
    params = jmod(jcfg).init(jax.random.PRNGKey(seed), jnp.asarray(ids),
                             jnp.asarray(mask))["params"]
    return _np_tree(params, seed + 1), ids, mask


def _jax_out(name, params, ids, mask, dtype):
    jmod, jcfg = TOWERS[name][:2]
    out = jmod(jcfg, dtype=_jdt(dtype)).apply(
        {"params": params}, jnp.asarray(ids), jnp.asarray(mask))
    return out


@pytest.mark.parametrize("serving", [False, True])
@pytest.mark.parametrize("name", sorted(TOWERS))
def test_text_tower_matches_jax(name, serving):
    # every position of the hidden states (padded rows too: both mask the
    # same keys) and, for CLIP, the projected pooled output
    params, ids, mask = _tower_case(name)
    dtype = SERVING[name] if serving else torch.float32
    limit = SERVING_REL_L2 if serving else FP32_REL_L2
    want = _jax_out(name, params, ids, mask, dtype)
    m = TOWERS[name][3](TOWERS[name][2], params, dtype)
    got = m(torch.from_numpy(ids).long(), torch.from_numpy(mask))
    if name == "clip":
        (got, pooled), (want, want_pooled) = got, want
        assert pooled.dtype == torch.float32
        assert _rel_l2(pooled, want_pooled) <= limit
    assert got.dtype == dtype and tuple(got.shape) == want.shape
    assert _rel_l2(got.float(), np.asarray(want, np.float32)) <= limit


def test_modernbert_window_cuts_the_local_layers():
    # with the local window widened past the sequence the output moves far
    # outside the fp32 limit: the test's 24 tokens do reach the +-4 window
    params, ids, mask = _tower_case("modernbert")
    cfg = TOWERS["modernbert"][2]
    got = _bert(cfg, params, torch.float32)(torch.from_numpy(ids).long(),
                                            torch.from_numpy(mask))
    import dataclasses
    wide = _bert(dataclasses.replace(cfg, local_attention=64), params,
                 torch.float32)(torch.from_numpy(ids).long(),
                                torch.from_numpy(mask))
    assert _rel_l2(wide, got) > 100 * FP32_REL_L2


@pytest.mark.parametrize("name,fn,importer", [
    ("clip", tw.clip_text_state_dict_from_jax,
     jclip.import_clip_text_state_dict),
    ("gemma2", tw.gemma2_state_dict_from_jax, jgemma.import_gemma2_state_dict),
    ("modernbert", tw.modernbert_state_dict_from_jax,
     jbert.import_modernbert_state_dict)])
def test_text_tower_state_dict_round_trips_through_the_jax_importer(
        name, fn, importer):
    cls = {"clip": tclip.ClipTextEncoder, "gemma2": tgemma.Gemma2Encoder,
           "modernbert": tbert.ModernBertEncoder}[name]
    torch.manual_seed(0)
    m = cls(TOWERS[name][2], device="cpu")
    sd = {k: v.detach().clone() for k, v in m.state_dict().items()}
    back = fn(importer(sd))
    assert back.keys() == sd.keys()
    assert all(torch.equal(back[k], sd[k]) for k in sd)
