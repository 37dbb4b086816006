"""sd3_torch ops held to their JAX counterparts in sd3_tpu, on the CPU.

Inputs come from numpy seeds and go through both packages; everything is
compared in fp32. Unless a test says otherwise the tolerance is the one the
JAX package's own fp32 tests use (atol 2e-5, rtol 2e-4): the two frameworks
sum in different orders, nothing else differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.ops import norms as jnorms
from sd3_tpu.ops import patch as jpatch
from sd3_tpu.ops import rope as jrope
from sd3_tpu.ops import time_embed as jtime
from sd3_tpu.ops.fused_attention import (
    fused_dual_flash_attention as j_fused_attention)

from sd3_torch.ops import fused_attention as tfa
from sd3_torch.ops import norms as tnorms
from sd3_torch.ops import patch as tpatch
from sd3_torch.ops import rope as trope
from sd3_torch.ops import time_embed as ttime
from sd3_torch.weights import state_dict_from_jax

ATOL, RTOL = 2e-5, 2e-4


def _rng(seed=0):
    return np.random.default_rng(seed)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(got.detach(), np.float32),
                               np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


@pytest.mark.parametrize("eps", [None, 1e-6])
def test_rms_norm_matches_jax(eps):
    r = _rng(1)
    x = r.standard_normal((2, 5, 24)).astype(np.float32) * 3
    w = (1 + 0.1 * r.standard_normal(24)).astype(np.float32)
    want = jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), eps)
    _close(tnorms.rms_norm(_t(x), _t(w), eps), want)


def test_rms_norm_default_eps_is_the_input_dtype_eps():
    # bf16 eps is 2^-7: a tiny row makes the difference to fp32 eps visible
    x = torch.full((1, 4), 1e-2, dtype=torch.bfloat16)
    got = tnorms.rms_norm(x).float()
    want = 1e-2 / np.sqrt(1e-4 + 2.0 ** -7)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-2)


def test_layer_norm_and_adaln_match_jax():
    r = _rng(2)
    x = r.standard_normal((2, 6, 16)).astype(np.float32) * 2 + 1
    y = r.standard_normal((2, 16)).astype(np.float32)
    _close(tnorms.layer_norm(_t(x)), jnorms.layer_norm(jnp.asarray(x)))

    jm = jnorms.AdaLNorm(16, 16)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(y))
    tm = tnorms.AdaLNorm(16, 16)
    p = params["params"]
    tm.load_state_dict({"c_shift.weight": _t(p["c_shift"]["kernel"]).T,
                        "c_scale.weight": _t(p["c_scale"]["kernel"]).T})
    _close(tm(_t(x), _t(y)), want)


def test_time_embedding_matches_jax():
    t = np.array([0.0, 0.25, 0.999], np.float32)
    _close(ttime.timestep_embedding(_t(t) * 1000, 32),
           jtime.timestep_embedding(jnp.asarray(t) * 1000, 32))
    jm = jtime.TimestepEmbedding(32)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(t))["params"]
    want = jm.apply({"params": params}, jnp.asarray(t))
    t_emb2 = torch.nn.Linear(32, 32, bias=False)
    t_emb2.weight.data = _t(params["t_emb2"]["kernel"]).T.contiguous()
    got = ttime.embed_time(_t(t), _t(params["time_scale"]), t_emb2,
                           torch.float32)
    # sin/cos of arguments up to 1000: float32 argument rounding dominates
    _close(got, want, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_patchify_unpatchify_match_jax(hw):
    x = _rng(3).standard_normal((2, 4, *hw)).astype(np.float32)
    want = jpatch.patchify(jnp.asarray(x), (2, 2))
    got = tpatch.patchify(_t(x), (2, 2))
    _close(got, want, atol=0, rtol=0)
    _close(tpatch.unpatchify(got, (2, 2), hw),
           jpatch.unpatchify(want, (2, 2), hw), atol=0, rtol=0)
    _close(tpatch.unpatchify(got, (2, 2), hw), x, atol=0, rtol=0)


def test_patch_embed_matches_jax_through_the_weight_carrier():
    x = _rng(4).standard_normal((2, 4, 8, 8)).astype(np.float32)
    jm = jpatch.PatchEmbed(patch_size=2, in_channels=4, embed_dim=12)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(x))["params"]
    want = jm.apply({"params": params}, jnp.asarray(x))
    sd = state_dict_from_jax({"pos_enc": params})
    assert tuple(sd["pos_enc.proj.weight"].shape) == (12, 4, 2, 2)
    tm = tpatch.PatchEmbed(2, 4, 12)
    tm.load_state_dict({"proj.weight": sd["pos_enc.proj.weight"]})
    _close(tm(_t(x)), want)
    # the (O, C, p, p) weight is the reference's Conv2d weight
    conv = torch.nn.functional.conv2d(_t(x), sd["pos_enc.proj.weight"],
                                      stride=2).flatten(2).transpose(1, 2)
    _close(conv, want)


def test_patch_embed_absolute_is_not_ported():
    # ported since: the absolute PatchEmbed adds the centre-cropped sin-cos
    # table to the patch embedding (held to JAX in
    # tests/test_torch_variants.py::test_cropped_pos_embed_matches_jax)
    x = torch.randn(2, 4, 6, 10, generator=torch.Generator().manual_seed(0))
    flat = tpatch.PatchEmbed(2, 4, 12)
    torch.nn.init.normal_(flat.proj.weight, generator=torch.Generator(
        ).manual_seed(1))
    pe = tpatch.PatchEmbed(2, 4, 12, pos_embed_type="absolute",
                           pos_embed_max_size=16, base_size=8)
    pe.load_state_dict(flat.state_dict())
    table = tpatch.cropped_pos_embed(12, 3, 5, 16, 8)
    _close(pe(x) - flat(x), np.broadcast_to(table, (2, 15, 12)))


@pytest.mark.parametrize("h,w,d,interp", [(4, 4, 64, 1.0), (3, 5, 16, 2.0)])
def test_rope2d_angles_and_apply_match_jax(h, w, d, interp):
    want = jrope.rope2d_axial_angles(h, w, d, interp)
    got = trope.rope2d_axial_angles(h, w, d, interp)
    np.testing.assert_array_equal(got, want)
    x = _rng(5).standard_normal((2, 3, h * w, d)).astype(np.float32)
    a = got.reshape(h * w, d)
    _close(trope.apply_rope(_t(x), a), jrope.apply_rope(jnp.asarray(x), a))


def _attn_case(nh, d, h, w, n_txt, rope2d, seed=0):
    """The inputs of tests/test_fused_attention.py::_case, as numpy (the
    JAX-free twin in test_torch_kernels.py draws the same)."""
    n_img = h * w
    n = n_img + n_txt
    r = _rng(seed)
    f = nh * d
    q, k, v = (r.standard_normal((2, n, f)).astype(np.float32)
               for _ in range(3))
    ws = [(1 + 0.1 * r.standard_normal(d)).astype(np.float32) for _ in range(4)]
    angles = (jrope.rope2d_axial_angles(h, w, d).reshape(n_img, d)
              if rope2d else None)
    return q, k, v, ws, angles, n_img, d ** -0.5


ATTN_SHAPES = [
    (3, 16, 3, 4, 5, True),     # odd heads
    (2, 64, 4, 4, 6, True),     # published head_dim
    (2, 16, 2, 4, 4, False),    # NoPE: fused norm only
]


@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", ATTN_SHAPES)
def test_fused_attention_plain_matches_jax_kernel(nh, d, h, w, n_txt, rope2d):
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             nh, *map(jnp.asarray, ws), angles, n_img, scale)
    before = tfa.K1.launches
    got = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), nh,
                                         *map(_t, ws), angles, n_img, scale)
    _close(got, want)
    assert tfa.K1.launches == before  # CPU tensors take the plain version


INT8_QK_SHAPES = [
    (3, 16, 3, 4, 5, True),     # odd heads, head dim 16 (zero-padded to 32)
    (3, 64, 5, 7, 12, True),    # odd heads, ragged N = 47, head dim 64
    (2, 64, 2, 4, 4, False),    # NoPE
]


@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", INT8_QK_SHAPES)
def test_int8_qk_plain_matches_jax_kernel(nh, d, h, w, n_txt, rope2d):
    # K4's plain version against the JAX kernel's int8_qk branch (Pallas
    # interpret mode). The s32 scores are exact on both sides and q^, k^ are
    # quantized with the same scales, but q^ / k^ come out of RMSNorm and
    # the rotation summed in another order: a last-bit difference can move
    # one element across an int8 rounding boundary, which shifts a score by
    # one level, s_q * s_k * |k_int| <~ 1e-2 in the exp2 domain here, and an
    # output by a fraction of that. atol 2e-4 covers such a flip; a wrong
    # scale (per tensor instead of per row or per head) or a bounded rather
    # than true max is off by orders more.
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d,
                                                   seed=d + h)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             nh, *map(jnp.asarray, ws), angles, n_img, scale,
                             int8_qk=True)
    before = tfa.K4.launches
    got = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), nh,
                                         *map(_t, ws), angles, n_img, scale,
                                         int8_qk=True)
    assert tfa.K4.launches == before
    _close(got, want, atol=2e-4, rtol=0)
    # the int8 scores are not the float ones: the plain K1 result differs
    flt = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), nh,
                                         *map(_t, ws), angles, n_img, scale)
    assert (flt - got).abs().max().item() > 1e-3


def test_int8_qk_gate_follows_the_padded_length():
    from sd3_torch.ops.attention import int8_qk_on
    assert not int8_qk_on("int8", (), 1024 - 128)       # pads to 896
    assert int8_qk_on("int8", (), 897)                  # pads to 1024
    assert int8_qk_on("int8", (), 1178)                 # the 512px slice
    assert int8_qk_on("int8", (), 2048)
    assert not int8_qk_on("int8", (), 2049)             # pads to 2176 (K7)
    assert not int8_qk_on("none", (), 1178)
    assert not int8_qk_on("int8", ("attn_qk",), 1178)
    assert int8_qk_on("int8", ("w12",), 1178)


@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", ATTN_SHAPES[:2])
def test_fused_attention_gradients_match_jax_vjp(nh, d, h, w, n_txt, rope2d):
    # K1's autograd Function (its plain version here) against the JAX
    # fused core's custom VJP: both differentiate the plain prep followed by
    # flash attention (Pallas interpret mode in JAX, the K5 / K6 plain
    # versions here), for q, k, v and the four norm weights, which reach the
    # tables through fold_row_tables
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d,
                                                   seed=3)
    g = _rng(4).standard_normal(q.shape).astype(np.float32)
    fn = lambda *a: j_fused_attention(*a[:3], nh, *a[3:], angles, n_img, scale)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, *ws)))
    want = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (q, k, v, *ws)]
    out = tfa.fused_dual_flash_attention(*ins[:3], nh, *ins[3:], angles,
                                         n_img, scale)
    got = torch.autograd.grad(out, ins, _t(g))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("int8_qk", [False, True])
def test_fused_attention_at_head_dim_8_matches_jax_kernel(int8_qk):
    # JAX's route takes any even head dim dividing 128 into the fused
    # kernel; so does the port's, whose card kernels run 2, 4 and 8 at the
    # D = 16 instance, zero-padded, with the prep's RMSNorm over the true 8
    # values (the tolerances of the tests above)
    q, k, v, ws, angles, n_img, scale = _attn_case(3, 8, 3, 4, 5, True,
                                                   seed=8)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             3, *map(jnp.asarray, ws), angles, n_img, scale,
                             int8_qk=int8_qk)
    got = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), 3,
                                         *map(_t, ws), angles, n_img, scale,
                                         int8_qk=int8_qk)
    _close(got, want, atol=2e-4 if int8_qk else ATOL,
           rtol=0 if int8_qk else RTOL)


def test_fused_attention_api_at_head_dim_256_matches_jax_kernel():
    # JAX's fused_dual_flash_attention takes head dim 256 (one head per
    # lane block; its model route sends only head dims dividing 128); the
    # port's plain version matches it here, and its card kernels run it in
    # bf16 on the wgmma kernels' D = 256 instances, in fp32 on the wide ones
    # (tests/test_torch_kernels.py::
    # test_fused_attention_past_head_dim_128_on_the_card)
    q, k, v, ws, angles, n_img, scale = _attn_case(2, 256, 2, 3, 4, True,
                                                   seed=9)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             2, *map(jnp.asarray, ws), angles, n_img, scale)
    got = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), 2,
                                         *map(_t, ws), angles, n_img, scale)
    _close(got, want)


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("d", [48, 96, 192, 384])
def test_fused_attention_api_past_the_dividers_of_128_matches_jax_kernel(
        d, int8_qk):
    # head dims JAX's fused attention takes with one head per lane block
    # (_pack_factor 1): the port's card kernels run them padded (48 -> 64,
    # 96 -> 128, 192 -> 256: in bf16 the wgmma kernels' D = 256 instances)
    # or on the wide instance (384), and their plain
    # version matches JAX's kernel here. Float: the fp32 tolerance. int8
    # QK^T: atol 2e-3, one int8 level of q^ or k^ crossing a rounding
    # boundary on a last-bit difference of the prep (at d 192 a one-ulp
    # change of q and k moves the port's own output by 1.26e-3, the size of
    # its difference to JAX there; the other head dims stay under 2e-4)
    q, k, v, ws, angles, n_img, scale = _attn_case(2, d, 3, 4, 5, True,
                                                   seed=d)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             2, *map(jnp.asarray, ws), angles, n_img, scale,
                             int8_qk=int8_qk)
    got = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), 2,
                                         *map(_t, ws), angles, n_img, scale,
                                         int8_qk=int8_qk)
    _close(got, want, atol=2e-3 if int8_qk else ATOL,
           rtol=0 if int8_qk else RTOL)


def test_fused_attention_gradients_at_head_dim_8_match_jax_vjp():
    # the backward's flash attention pads the head dim 8 to 16 (the
    # kernels' instance) on the CPU too: the same gradients as JAX's
    q, k, v, ws, angles, n_img, scale = _attn_case(2, 8, 3, 3, 4, True,
                                                   seed=9)
    g = _rng(5).standard_normal(q.shape).astype(np.float32)
    fn = lambda *a: j_fused_attention(*a[:3], 2, *a[3:], angles, n_img, scale)
    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v, *ws)))
    want = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (q, k, v, *ws)]
    out = tfa.fused_dual_flash_attention(*ins[:3], 2, *ins[3:], angles,
                                         n_img, scale)
    got = torch.autograd.grad(out, ins, _t(g))
    for a, b in zip(got, want):
        _close(a, b, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("d", [2, 4, 8])
def test_prep_of_a_padded_head_takes_the_true_head_dim(d):
    # what the card's prep does with a head of d values zero-padded to 16,
    # its tables zero-padded too: the RMSNorm's mean over the d values, the
    # padded lanes zero after the rotation; a mean over all 16 is not it
    # (RoPE2d splits a head into 4 axes' pairs: a head of 2 takes NoPE)
    q, _, _, ws, angles, n_img, _ = _attn_case(2, d, 3, 3, 4, d >= 4, seed=d)
    n = q.shape[1]
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    c, s = tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img)
    x = tfa._heads(_t(q), 2)
    want = tfa._prep(x, c, s, 1e-6)
    pad = lambda t: torch.nn.functional.pad(t, (0, 16 - d))
    got = tfa._prep(pad(x), pad(c), pad(s), 1e-6, dn=d)
    _close(got[..., :d], want, atol=1e-6, rtol=1e-6)
    assert not got[..., d:].any()
    wrong = tfa._prep(pad(x), pad(c), pad(s), 1e-6)
    assert (wrong[..., :d] - want).abs().max().item() > 1e-2
