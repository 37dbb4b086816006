"""The model variants off the published config, held to the JAX package on
the CPU: every attention type (causal or not), `kv_merge_attn`,
`qk_half_dim`, the single stream, RoPE1d / RoPE2dV2, the absolute PE, the
gelu / swiglu_old MLPs (float and int8), the text loss, and the pair scan of
attn_type "both".

The same numpy-seeded inputs and the same weights (JAX's initialisation,
crossed by `state_dict_from_jax` with a strict load) go through both
packages in fp32; conftest pins `jax_default_matmul_precision=highest`.
Pallas kernels run as the JAX package's own CPU tests run them (interpret
mode); the port takes its kernels' plain versions on CPU tensors.
Tolerances, each where it is used:
- modules (attention, RoPE, tables, MLPs): atol 1e-5, rtol 1e-4: fp32 on
  both sides, only the summation order differs;
- the linear attention of silu features: its denominator q . sum(k) is a
  sum of terms of both signs, which nears zero on some rows and there
  amplifies the fp32 summation order by |terms| / |sum|; those rows are
  held to 1e-5 times that condition number;
- whole 2-block models and training steps: the tolerances of
  test_torch_model.py / test_torch_train.py (atol 1e-4, rtol 1e-3; 1e-4
  relative for losses, gradient norms and updates);
- int8: rel L2 <= 1e-2 and at most half of JAX's own float-to-int8 change
  (test_torch_model.py's reasoning: w8a8 is discontinuous).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models import mmdit as jmmdit
from sd3_tpu.models.mmdit import MMDiT as JMMDiT
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.ops import attention as jattn
from sd3_tpu.ops import patch as jpatch
from sd3_tpu.ops import rope as jrope
from sd3_tpu.ops.mlp import MLP as JMLP
from sd3_tpu.ops.quant import quantize_params
from sd3_tpu.training import trainer as jtr

from sd3_torch.config import MMDiTConfig, tiny_config
from sd3_torch.models import mmdit as tmmdit
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.ops import attention as tattn
from sd3_torch.ops import fused_mlp as tfm
from sd3_torch.ops import patch as tpatch
from sd3_torch.ops import rope as trope
from sd3_torch.ops.mlp import MLP
from sd3_torch.ops.quant import quantize_model
from sd3_torch.training.trainer import Noise, TrainConfig, Trainer
from sd3_torch.weights import state_dict_from_jax

ATOL, RTOL = 1e-5, 1e-4
MODEL_ATOL, MODEL_RTOL = 1e-4, 1e-3


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _np(t):
    return t.detach().float().numpy().copy()


def _close(got, want, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=rtol)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# ---- attention_core ---------------------------------------------------------

CORE_TYPES = ["softmax", "softmax_flash", "cosine", "cosine2", "cosine3",
              "cosine4", "cosine_norm", "relu", "silu", "exp"]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("attn_type", CORE_TYPES)
def test_attention_core_matches_jax(attn_type, causal):
    # (B, H, N, D) inputs, N = M (a causal mask is square); "cosine" with a
    # per-head norm_const. causal "softmax_flash" takes the masked plain
    # path on both sides, as JAX's flash runs only when not causal
    r = np.random.default_rng(1)
    q, k, v = (r.standard_normal((2, 3, 24, 16)).astype(np.float32) * 0.5
               for _ in range(3))
    if attn_type in ("cosine", "cosine2"):
        q, k = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (q, k))
    nc = r.standard_normal((1, 3, 1, 1)).astype(np.float32)
    want = jattn.attention_core(*map(jnp.asarray, (q, k, v)), attn_type, 0.25,
                                causal=causal, norm_const=jnp.asarray(nc))
    got = tattn.attention_core(_t(q), _t(k), _t(v), attn_type, 0.25,
                               causal=causal, norm_const=_t(nc))
    if attn_type != "silu":
        _close(got, want)
        return
    fq, fk = (x * (1 / (1 + np.exp(-x))) for x in (q, k))
    ksum = fk.sum(-2)
    den = np.einsum("bhnd,bhd->bhn", fq, ksum)[..., None]
    cond = np.einsum("bhnd,bhd->bhn", np.abs(fq), np.abs(ksum))[..., None] \
        / np.abs(den)
    err = np.abs(_np(got) - np.asarray(want))
    assert (err <= 1e-5 * cond * np.abs(np.asarray(want)) + ATOL).all()


# ---- JointAttention ---------------------------------------------------------

# tests/test_attention.py:36-45's cases, and the single stream, the fused
# path with RoPE1d / NoPE / absolute, causal, and "both" by layer parity
ATTN_CASES = [
    ("softmax", "RoPE2d", False, False),
    ("softmax", "RoPE", False, False),
    ("softmax", "RoPE2dV2", False, False),
    ("softmax", "NoPE", False, False),
    ("softmax", "RoPE2d", True, False),
    ("softmax", "RoPE2d", False, True),
    ("cosine", "RoPE2d", False, False),
    ("cosine2", "NoPE", False, False),
    ("cosine3", "NoPE", False, False),
    ("cosine4", "NoPE", False, False),
    ("cosine4", "NoPE", False, True),
    ("cosine_norm", "NoPE", False, False),
    ("relu", "NoPE", False, False),
    ("silu", "NoPE", False, False),
    ("exp", "NoPE", False, False),
]
EXTRA_CASES = [
    # (attn_type, pe, kv_merge, qk_half, extra JointAttention fields)
    ("softmax", "RoPE", False, False, dict(dual=False)),
    ("cosine", "RoPE2dV2", False, False, dict(dual=False)),
    ("softmax_flash", "RoPE2dV2", True, False, dict(dual=False)),
    ("softmax_flash", "RoPE", False, False, {}),        # fused, RoPE1d tables
    ("softmax_flash", "NoPE", False, False, {}),        # fused, identity
    ("softmax_flash", "absolute", False, False, {}),    # fused, identity
    ("softmax_flash", "RoPE2dV2", True, False, {}),     # flash at M != N
    ("softmax_flash", "RoPE2d", False, False, dict(causal=True)),
    ("cosine", "NoPE", False, False, dict(causal=True)),
    ("cosine3", "RoPE", False, False, dict(causal=True)),
    ("both", "RoPE2d", False, False, dict(layer_idx=2)),
    ("both", "RoPE2d", False, False, dict(layer_idx=3)),
    ("softmax", "RoPE2d", False, False, dict(last=True)),
]


def _attn_pair(attn_type, pe, kv_merge, qk_half, extra, seed=10):
    """(JAX module, its params with a random norm_const, the port's module
    on them, x, c); rope_scale 0.5 (RoPE1d and RoPE2dV2 interpolate)."""
    dim, heads, h, w, m = 32, 2, 4, 4, 6
    kw = dict(attn_type=attn_type, positional_encoding=pe, rope_scale=0.5,
              kv_merge_attn=kv_merge, qk_half_dim=qk_half, **extra)
    kw.setdefault("layer_idx", 0)
    r = np.random.default_rng(seed)
    x = r.standard_normal((2, h * w, dim)).astype(np.float32)
    c = r.standard_normal((2, m, dim)).astype(np.float32)
    jm = jattn.JointAttention(dim=dim, num_heads=heads, **kw)
    dual = kw.get("dual", True)
    jargs = (jnp.asarray(x), jnp.asarray(c) if dual else None, (h, w))
    params = jm.init(jax.random.PRNGKey(seed), *jargs)["params"]
    if "norm_const" in params:
        params = dict(params, norm_const=jnp.asarray(
            r.standard_normal((1, heads, 1, 1)), jnp.float32))
    tm = tattn.JointAttention(dim, heads, **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    return jm, params, tm, jargs, x, c


@pytest.mark.parametrize("case", ATTN_CASES + EXTRA_CASES)
def test_joint_attention_matches_jax(case):
    attn_type, pe, kv_merge, qk_half, *extra = case
    extra = extra[0] if extra else {}
    jm, params, tm, jargs, x, c = _attn_pair(attn_type, pe, kv_merge,
                                             qk_half, extra)
    want = jm.apply({"params": params}, *jargs)
    dual = extra.get("dual", True)
    with torch.no_grad():
        got = tm(_t(x), _t(c) if dual else None, jargs[2])
    fused = (attn_type == "softmax_flash" and dual and not kv_merge
             and not extra.get("causal") and pe != "RoPE2dV2")
    assert tm.fused == fused
    if not dual:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        if attn_type == "silu":
            # the denominator's cancellation (module note): rows whose
            # q . sum(k) nears zero carry the fp32 order ~1e3 times over
            assert _rel_l2(_np(g), w) <= 1e-4
        else:
            _close(g, w)


@pytest.mark.parametrize("case", [
    ("softmax_flash", "RoPE2dV2", True, False, {}),
    ("cosine", "RoPE", False, False, dict(causal=True)),
    ("softmax", "RoPE2d", False, True, {})])
def test_joint_attention_gradients_match_jax(case):
    # the general path's backward: flash at M != N (K5 / K6a / K6b's plain
    # versions) under kv_merge, the causal cosine with its norm_const, and
    # qk_half_dim; every parameter's gradient and x's, c's
    attn_type, pe, kv_merge, qk_half, extra = case
    jm, params, tm, jargs, x, c = _attn_pair(attn_type, pe, kv_merge,
                                             qk_half, extra, seed=12)

    def jloss(p, xx, cc):
        ox, oc = jm.apply({"params": p}, xx, cc, jargs[2])
        return jnp.sum(ox * jnp.cos(ox)) + jnp.sum(oc ** 2)
    jg, jgx, jgc = jax.grad(jloss, argnums=(0, 1, 2))(params, *jargs[:2])
    tx, tc = _t(x, True), _t(c, True)
    ox, oc = tm(tx, tc, jargs[2])
    (torch.sum(ox * torch.cos(ox)) + torch.sum(oc ** 2)).backward()
    _close(tx.grad, jgx)
    _close(tc.grad, jgc)
    want = state_dict_from_jax(jg)
    for name, p in tm.named_parameters():
        _close(p.grad, want[name].numpy())


# ---- RoPE and the absolute table -------------------------------------------

@pytest.mark.parametrize("rope_scale", [1.0, 0.5, 2.0])
def test_rope1d_matches_jax(rope_scale):
    # NTK-style interpolation: positions / (1 / rope_scale); a rotation
    # narrower than the head passes the tail through
    interp = 1.0 / rope_scale
    np.testing.assert_array_equal(trope.rope1d_angles(40, 16, interp),
                                  jrope.rope1d_angles(40, 16, interp))
    x = np.random.default_rng(2).standard_normal((2, 3, 40, 16)).astype(
        np.float32)
    _close(trope.apply_rope1d(_t(x), interp),
           jrope.apply_rope1d(jnp.asarray(x), interp))
    a = jrope.rope1d_angles(40, 10, interp)
    _close(trope.apply_rope(_t(x), a), jrope.apply_rope(jnp.asarray(x), a))


@pytest.mark.parametrize("d,h,w,interp", [(64, 4, 4, 1.0), (64, 3, 5, 2.0),
                                          (16, 5, 3, 0.5), (48, 2, 6, 1.0)])
def test_rope2dv2_matches_jax(d, h, w, interp):
    # triplets over dim3 = (D // 3) * 3 values (63 of 64, 15 of 16), the
    # rest passed through; the output is the groups g1 | g2 | g3 (then the
    # tail), not the triplets re-interleaved
    x = np.random.default_rng(3).standard_normal((2, 2, h * w, d)).astype(
        np.float32)
    for a, b in zip(trope.rope2dv2_trig(h, w, d, interp),
                    jrope._rope2dv2_trig_cached(h, w, d, interp)):
        np.testing.assert_array_equal(a, b)
    got = trope.apply_rope2dv2(_t(x), h, w, interp)
    _close(got, jrope.apply_rope2dv2(jnp.asarray(x), h, w, interp))
    dim3 = (d // 3) * 3
    np.testing.assert_array_equal(_np(got)[..., dim3:], x[..., dim3:])
    # the first output group is g1 of the triplets, not x0 rotated in place
    g1_len = dim3 // 3
    assert not np.allclose(_np(got)[..., 1:g1_len], x[..., 1:g1_len])


@pytest.mark.parametrize("h,w,max_size,base,interp", [
    (3, 5, 16, 8, 1.0), (8, 2, 16, 8, 1.0), (16, 16, 16, 8, 2.0),
    (5, 12, 24, 12, 1.0)])
def test_cropped_pos_embed_matches_jax(h, w, max_size, base, interp):
    # the centre crop of the max_size grid, rows in the first half of the
    # features and columns in the second, at non-square grids; and the
    # absolute PatchEmbed adds it
    want = jpatch.cropped_pos_embed(24, h, w, max_size, base, interp)
    got = tpatch.cropped_pos_embed(24, h, w, max_size, base, interp)
    assert got.dtype == np.float32 and got.shape == (1, h * w, 24)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-7, rtol=0)
    np.testing.assert_allclose(
        tpatch.get_2d_sincos_pos_embed(24, (h, w), base, interp),
        jpatch.get_2d_sincos_pos_embed(24, (h, w), base, interp), rtol=1e-12)
    x = np.random.default_rng(4).standard_normal(
        (2, 4, 2 * h, 2 * w)).astype(np.float32)
    jm = jpatch.PatchEmbed(patch_size=2, in_channels=4, embed_dim=24,
                           pos_embed_type="absolute",
                           pos_embed_max_size=max_size, base_size=base,
                           interpolation_scale=interp)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    tm = tpatch.PatchEmbed(2, 4, 24, pos_embed_type="absolute",
                           pos_embed_max_size=max_size, base_size=base,
                           interpolation_scale=interp)
    tm.load_state_dict({"proj.weight": state_dict_from_jax(
        {"pos_enc": params})["pos_enc.proj.weight"]})
    _close(tm(_t(x)), jm.apply({"params": params}, jnp.asarray(x)))


# ---- MLPs -------------------------------------------------------------------

@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("act", ["gelu", "swiglu_old"])
def test_mlp_matches_jax(act, quant, monkeypatch):
    # gelu: exact erf GELU between biased lin_up / lin_down; swiglu_old:
    # SwiGLU with w12 / w3 flat in the module's scope; under int8 the
    # quantized weights of JAX's quantize_params, swiglu_old through the
    # int8 SwiGLU kernel (K3's plain version here), gelu through two int8
    # projections. int8: one int8 rounding step of the odd element (see the
    # module note), so rel L2 1e-2
    r = np.random.default_rng(5)
    x = r.standard_normal((2, 8, 64)).astype(np.float32)
    jm = JMLP(64, 2.0, act=act)
    params = jm.init(jax.random.PRNGKey(6), jnp.asarray(x))["params"]
    calls = []
    fn = tfm.swiglu_int8
    monkeypatch.setattr(tfm, "swiglu_int8",
                        lambda *a, **k: calls.append(1) or fn(*a, **k))
    tm = MLP(64, 2.0, act=act, quant=quant)
    if quant == "int8":
        params = quantize_params({"m": params})["m"]
        jm = JMLP(64, 2.0, act=act, quant="int8")
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(_t(x))
    names = {"gelu": {"lin_up", "lin_down"}, "swiglu_old": {"w12", "w3"}}[act]
    assert {n.split(".")[0] for n in tm.state_dict()} == names
    assert tm.fused_ok == (act == "swiglu_old" and quant == "int8")
    assert len(calls) == int(tm.fused_ok)
    if quant == "none":
        _close(got, want)
    else:
        assert _rel_l2(_np(got), want) <= 1e-2


# ---- the model --------------------------------------------------------------

# tests/test_mmdit.py:64-76's ids, and swiglu_old, flash with kv_merge and
# RoPE2dV2 (M != N), and the old reference layout (swiglu_old + absolute)
MODEL_CASES = {
    "base": {}, "abs": dict(positional_encoding="absolute"),
    "rope1d": dict(positional_encoding="RoPE"),
    "rope2dv2": dict(positional_encoding="RoPE2dV2"),
    "gelu": dict(MLP_type="gelu"), "cosine": dict(attn_type="cosine"),
    "both": dict(attn_type="both", num_blocks=2),
    "qk_half": dict(qk_half_dim=True), "kv_merge": dict(kv_merge_attn=True),
    "text_loss": dict(text_loss=True),
    "swiglu_old": dict(MLP_type="swiglu_old"),
    "flash_kv_merge": dict(attn_type="softmax_flash", kv_merge_attn=True,
                           positional_encoding="RoPE2dV2"),
    "old_layout": dict(attn_type="softmax_flash", MLP_type="swiglu_old",
                       positional_encoding="absolute"),
}


def _inputs(cfg, b=2, h=8, w=8, seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((b, cfg.inCh, h, w)).astype(np.float32),
            r.uniform(0, 1, (b,)).astype(np.float32),
            r.standard_normal((b, cfg.text_tokens, cfg.text_hidden_dim)
                              ).astype(np.float32),
            r.standard_normal((b, cfg.class_dim)).astype(np.float32))


@pytest.mark.parametrize("name", list(MODEL_CASES))
def test_model_matches_jax(name):
    # 2 blocks in fp32, the JAX MMDiT's weights strict into the port's;
    # max_res 32 against max_res_orig 16: rope_scale 0.5 interpolates
    jcfg = j_tiny_config(max_res=32, **MODEL_CASES[name])
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(3), height=8, width=8,
                            remat_blocks=False)
    x, t, c, cp = _inputs(jcfg, seed=4)
    nulls = [np.array(m) for m in ([True, False], [False, True],
                                   [False, True])]
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, t, c, cp)),
                    *map(jnp.asarray, nulls))
    model = MMDiT(MMDiTConfig.from_json(jcfg.to_json()), device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)), *map(torch.from_numpy, nulls))
    if jcfg.text_loss:
        assert isinstance(got, tuple) and got[1].dtype == torch.float32
        assert got[1].shape == c.shape
    else:
        got, want = (got,), (want,)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        _close(g, w, MODEL_ATOL, MODEL_RTOL)


def test_old_layout_int8_model_matches_jax(monkeypatch):
    # the reference's old checkpoints (swiglu_old, the absolute PE) served
    # in int8: JAX's quantize_params tree into the port's int8 model; the
    # MLP half through the int8 SwiGLU kernels (K2 / K3 plain versions), the
    # attention through K1's. Tolerance: the module note's int8 rule
    kw = dict(attn_type="softmax_flash", MLP_type="swiglu_old",
              positional_encoding="absolute", dim=64, hidden_scale=2.0,
              num_heads=2)
    jcfg = j_tiny_config(**kw)
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(7), height=16,
                            width=16, remat_blocks=False)
    qparams = quantize_params(params)
    jq = JMMDiT(jcfg.replace(quant="int8"), remat_blocks=False)
    model = MMDiT(MMDiTConfig.from_json(jcfg.to_json(), quant="int8"),
                  device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(qparams), strict=True)
    x, t, c, cp = _inputs(jcfg, h=16, w=16, seed=8)
    args = [jnp.asarray(a) for a in (x, t, c, cp)]
    want = np.asarray(jq.apply({"params": qparams}, *args))
    flt = np.asarray(jm.apply({"params": params}, *args))
    counts = dict(tail=0, mlp=0)
    for key, name in (("tail", "swiglu_int8_tail"), ("mlp", "swiglu_int8")):
        fn = getattr(tfm, name)
        monkeypatch.setattr(tfm, name, lambda *a, _fn=fn, _k=key, **k: (
            counts.__setitem__(_k, counts[_k] + 1) or _fn(*a, **k)))
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp))).numpy()
    assert counts == dict(tail=2, mlp=1)
    rel = _rel_l2(got, want)
    assert rel <= 1e-2 and rel <= 0.5 * _rel_l2(flt, want), rel
    # quantize_model on the float model quantizes the flat w12 / w3 as
    # quantize_params does
    fm = MMDiT(MMDiTConfig.from_json(jcfg.to_json()), device="cpu")
    fm.load_state_dict(state_dict_from_jax(params), strict=True)
    quantize_model(fm)
    qsd, want_sd = fm.state_dict(), state_dict_from_jax(qparams)
    assert set(qsd) == set(want_sd)
    for k in ("blocks.0.MLP_x.w12.weight_q", "blocks.1.MLP_x.w3.weight_q"):
        assert torch.equal(qsd[k], want_sd[k].to(torch.int8))


def test_pair_scan_layout_round_trips_and_matches_jax():
    # attn_type "both" scans two blocks a step: the even blocks under
    # blocks_stack.block, the odd under blocks_stack.block_odd, 5 blocks ->
    # 4 scanned (rounded to even) and the last unrolled; the layout's round
    # trip is exact, the scan model's forward equals the unrolled one's and
    # JAX's scan model's
    jcfg = j_tiny_config(attn_type="both", num_blocks=5)
    cfg = MMDiTConfig.from_json(jcfg.to_json())
    assert tmmdit.num_scan_blocks(cfg) == jmmdit.num_scan_blocks(jcfg) == 4
    assert tmmdit.num_scan_blocks(cfg.replace(text_loss=True)) == 4
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(9), height=8, width=8,
                            remat_blocks=False)
    sd = state_dict_from_jax(params)
    scan = tmmdit.to_scan_params(sd, 4, pair=True)
    assert scan["blocks_stack.block.attn.q_norm_x.weight"].shape[0] == 2
    assert scan["blocks_stack.block_odd.attn.norm_const"].shape == (2, 1, 2,
                                                                    1, 1)
    assert not any(k.startswith("blocks.1.") for k in scan)
    back = tmmdit.from_scan_params(scan, 4, pair=True)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    model = MMDiT(cfg, device="cpu", scan_blocks=True).eval()
    model.load_state_dict(scan, strict=True)
    unrolled = MMDiT(cfg, device="cpu").eval()
    unrolled.load_state_dict(sd, strict=True)
    assert list(model.canonical_parameters()) == list(
        dict(unrolled.named_parameters()))
    x, t, c, cp = _inputs(jcfg, seed=10)
    js = JMMDiT(jcfg, remat_blocks=False, scan_blocks=True)
    want = js.apply({"params": jmmdit.to_scan_params(params, 4, pair=True)},
                    *map(jnp.asarray, (x, t, c, cp)))
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)))
        flat = unrolled(*map(_t, (x, t, c, cp)))
    assert torch.equal(got, flat)
    _close(got, want, MODEL_ATOL, MODEL_RTOL)


# ---- training ----------------------------------------------------------------

def _jax_noise(key, x0, text, tcfg) -> Noise:
    """The draws of the JAX micro_loss for `key`, the text mask included
    (sd3_tpu/training/trainer.py:163-174, training/flow.py:78-79)."""
    from sd3_tpu.training import flow as jflow
    k_t, k_eps, k_null, k_txt = jax.random.split(key, 4)
    b = x0.shape[0]
    t = jflow.sample_t(k_t, b)
    _, eps = jflow.noise_batch(k_eps, jnp.asarray(x0), t)
    masks = jflow.null_masks(k_null, b, tcfg.null_prob_pooled,
                             tcfg.null_prob_gemma, tcfg.null_prob_bert)
    drawn = jax.random.uniform(k_txt, text.shape[:2]) < 0.25
    return Noise(_t(t), _t(eps), *(torch.from_numpy(np.array(m))
                                   for m in (*masks, drawn)))


def _batch(jcfg, acc, b=2, hw=8, seed=0):
    r = np.random.default_rng(seed)
    return {"x0": r.standard_normal((acc, b, jcfg.inCh, hw, hw)
                                    ).astype(np.float32),
            "text": r.standard_normal((acc, b, jcfg.text_tokens,
                                       jcfg.text_hidden_dim)).astype(np.float32),
            "pooled": r.standard_normal((acc, b, jcfg.class_dim)
                                        ).astype(np.float32)}


def _flat(d: dict) -> np.ndarray:
    return np.concatenate([np.asarray(d[k], np.float64).ravel()
                           for k in sorted(d)])


STEP_CASES = {
    # (model fields, TrainConfig fields)
    "text_loss": (dict(attn_type="softmax_flash", text_loss=True),
                  dict(text_loss_weight=0.1)),
    "kv_merge": (dict(attn_type="softmax_flash", kv_merge_attn=True),
                 dict(remat_policy="attn")),
    "both_scan": (dict(attn_type="both", num_blocks=3),
                  dict(scan_blocks=True, remat_policy="dots")),
}


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_variant_train_steps_match_jax(name, tmp_path):
    # two optimizer steps of the optax path, accumulation 2, fp32, against
    # JAX's make_train_step on the same draws (the text loss with the same
    # mask); the text loss with weight 0.1, kv_merge through flash at
    # M = N / 2 under the "attn" policy, "both" in the pair scan under
    # "dots". Loss (and the text loss's image_loss and text_loss), gradient
    # norm and the update to 1e-4 relative, as test_torch_train.py's fp32
    # steps (summation order only)
    mkw, tkw = STEP_CASES[name]
    jcfg = j_tiny_config(dtype="float32", **mkw)
    tkw = dict(batch_size=2, accumulation_steps=2, lr=1e-3, warmup_steps=1,
               remat_blocks=True, track_ema=False, **tkw)
    jtc = jtr.TrainConfig(**{k: v for k, v in tkw.items()
                             if k not in ("scan_blocks", "remat_policy")})
    jm = JMMDiT(jcfg, remat_blocks=True, fused_attn=False)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(2), remat_blocks=False)
    opt = jtr.make_optimizer(jtc)
    step = jax.jit(jtr.make_train_step(jm, opt, jtc))
    js = opt.init(params)
    trainer = Trainer(MMDiTConfig.from_json(jcfg.to_json()),
                      TrainConfig(**tkw), params=state_dict_from_jax(params),
                      device="cpu", log_dir=str(tmp_path), use_wandb=False)
    assert trainer.model.num_scan == (2 if name == "both_scan" else 0)
    p0 = {k: _np(v) for k, v in trainer.params.items()}
    jp = params
    for i in range(2):
        batch = _batch(jcfg, 2, seed=50 + i)
        key = jax.random.PRNGKey(60 + i)
        keys = jax.random.split(key, 2)
        noise = [_jax_noise(keys[j], batch["x0"][j], batch["text"][j], jtc)
                 for j in range(2)]
        jp, js, jmet = step(jp, js, key, batch)
        tmet = trainer.train_step({k: _t(v) for k, v in batch.items()},
                                  noise)
        assert set(tmet) == set(jmet)
        for k in jmet:
            assert tmet[k].item() == pytest.approx(float(jmet[k]), rel=1e-4)
    want = state_dict_from_jax(jp)
    dp_t = _flat({k: _np(v) - p0[k] for k, v in trainer.params.items()})
    dp_j = _flat({k: _np(v) - p0[k] for k, v in want.items()})
    assert _rel_l2(dp_t, dp_j) < 1e-4


@pytest.mark.parametrize("policy", ["nothing", "dots", "attn", "dots_attn"])
def test_remat_policies_hold_on_the_variants(policy, tmp_path):
    # each policy gives the gradients of no remat, on kv_merge through flash
    # (its saved op at M != N) and on "both" in the pair scan (plain softmax
    # and cosine blocks): the same bits up to the recompute's rounding
    # (fp32: 1e-6 relative)
    for mkw, scan in ((dict(attn_type="softmax_flash", kv_merge_attn=True), False),
                      (dict(attn_type="both", num_blocks=3), True)):
        cfg = tiny_config(**mkw)
        batch = {k: _t(v) for k, v in _batch(cfg, 1, seed=70).items()}
        grads = []
        for remat, pol in ((False, "nothing"), (True, policy)):
            tr = Trainer(cfg, TrainConfig(batch_size=2, accumulation_steps=1,
                                          remat_blocks=remat,
                                          remat_policy=pol, scan_blocks=scan,
                                          track_ema=False, seed=3),
                         device="cpu", log_dir=str(tmp_path), use_wandb=False)
            from sd3_torch.training.trainer import draw_noise
            noise = [draw_noise(torch.Generator().manual_seed(4),
                                batch["x0"][0], tr.tcfg)]
            g, _ = tr.gradients(batch, noise)
            grads.append({k: _np(v) for k, v in g.items()})
        assert _rel_l2(_flat(grads[1]), _flat(grads[0])) < 1e-6


# ---- what JAX refuses ----------------------------------------------------------

def test_refusals_match_jax(tmp_path):
    # qk_half_dim under softmax_flash: the flash wrapper's head-dim assert;
    # an odd stream under kv_merge_attn: no pairs; a text_loss model with
    # text_loss_weight 0: JAX's step takes its (velocity, text) pair for the
    # velocity. JAX raises (an assertion, a shape error, an attribute error)
    # and the port a ValueError, where neither computes a result
    jcfg = j_tiny_config(attn_type="softmax_flash", qk_half_dim=True)
    x, t, c, cp = _inputs(jcfg)
    with pytest.raises(AssertionError):
        init_mmdit(jcfg, jax.random.PRNGKey(0), height=8, width=8)
    with pytest.raises(ValueError, match="qk_half_dim"):
        MMDiT(MMDiTConfig.from_json(jcfg.to_json()), device="cpu")
    jcfg = j_tiny_config(kv_merge_attn=True, text_tokens_per_encoder=7)
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(0), height=8, width=8,
                            remat_blocks=False)
    odd = (x[:, :, :6], t, c, cp)  # 3 x 4 tokens: 12, pairs; text 14
    model = MMDiT(MMDiTConfig.from_json(jcfg.to_json()), device="cpu")
    model.load_state_dict(state_dict_from_jax(params), strict=True)
    with torch.no_grad():
        model(*map(_t, odd))            # even streams run
    odd = (x[:, :, :6, :6], t, c, cp)   # 3 x 3 = 9 image tokens
    with pytest.raises(Exception):
        jm.apply({"params": params}, *map(jnp.asarray, odd))
    with pytest.raises(ValueError, match="cannot pair"):
        with torch.no_grad():
            model(*map(_t, odd))
    jcfg = j_tiny_config(attn_type="softmax_flash", text_loss=True)
    jtc = jtr.TrainConfig(batch_size=2, accumulation_steps=1)
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(0), remat_blocks=False)
    b = _batch(jcfg, 1)
    with pytest.raises(AttributeError):
        jtr.make_micro_loss(jm, jtc)(params, jax.random.PRNGKey(1),
                                     *(jnp.asarray(b[k][0])
                                       for k in ("x0", "text", "pooled")))
    with pytest.raises(ValueError, match="text_loss_weight"):
        Trainer(MMDiTConfig.from_json(jcfg.to_json()), TrainConfig(),
                device="cpu", log_dir=str(tmp_path), use_wandb=False)


# ---- the CLIs ------------------------------------------------------------------

def test_cli_samples_an_old_layout_reference_checkpoint(tmp_path):
    # the reference's older checkpoints: a torch.save'd state_dict with the
    # absolute PE's recomputed pos_enc.pos_embed buffer, and a params JSON of
    # the reference's keys without MLP_type, which means swiglu_old (the
    # JSON loads in the JAX package the same way)
    from sd3_tpu.config import MMDiTConfig as JConfig
    from sd3_torch.inference import infer

    cfg = tiny_config(positional_encoding="absolute", MLP_type="swiglu_old",
                      text_tokens_per_encoder=77, text_hidden_dim=2304,
                      pos_embed_max_size=256)
    model = MMDiT(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0))
    sd = dict(model.state_dict())
    sd["pos_enc.pos_embed"] = torch.from_numpy(np.array(
        tpatch.cropped_pos_embed(cfg.dim, 256, 256, 256, 128)))
    torch.save(sd, tmp_path / "model_0s.pkl")
    params = {k: v for k, v in cfg.to_json_dict().items()
              if k in MMDiTConfig._JSON_KEYS and k != "MLP_type"}
    (tmp_path / "model_params_0s.json").write_text(
        json.dumps({**params, "device": "cpu"}))
    loaded = MMDiTConfig.from_json((tmp_path / "model_params_0s.json"
                                    ).read_text())
    assert loaded.MLP_type == "swiglu_old"
    assert JConfig.from_json((tmp_path / "model_params_0s.json").read_text()
                             ).MLP_type == "swiglu_old"
    out = tmp_path / "old"
    infer.main(["--device", "cpu", "--loadDir", str(tmp_path), "--torch_ckpt",
                "model_0s.pkl", "--loadDefFile", "model_params_0s.json",
                "--text_input", "a red fox", "--num_steps", "2", "--width",
                "32", "--height", "32", "--batch_size", "2", "--seed", "3",
                "--stub_encoders", "--out_imgname", str(out)])
    assert (tmp_path / "old_0.png").exists() and (tmp_path / "old_1.png"
                                                  ).exists()


def test_cli_trains_a_text_loss_checkpoint(tmp_path):
    # a checkpoint whose config has text_loss, resumed through the train
    # CLI with --text_loss_weight: the step logs image_loss and text_loss;
    # infer samples from it (the text prediction dropped)
    from sd3_torch.inference import infer
    from sd3_torch.training import train

    cfg = tiny_config(attn_type="softmax_flash", text_loss=True)
    tr = Trainer(cfg, TrainConfig(batch_size=2, accumulation_steps=1,
                                  text_loss_weight=0.1, save_dir=str(
                                      tmp_path / "a")),
                 device="cpu", log_dir=str(tmp_path / "a"), use_wandb=False)
    from sd3_torch.data.pipeline import synthetic_batch_iter
    tr.train_step(tr.shard_batch(next(synthetic_batch_iter(cfg, 2, 1, 16,
                                                           16))))
    tr.save()
    tr = train.main(["--device", "cpu", "--loadDir", str(tmp_path / "a"),
                     "--loadStep", "1", "--text_loss_weight", "0.1",
                     "--synthetic", "--batchSize", "2",
                     "--accumulation_steps", "1", "--totalSteps", "2",
                     "--stage_res", "16", "--log_steps", "1",
                     "--saveDir", str(tmp_path / "b")])
    assert tr.step == 2 and tr.cfg.text_loss
    logs = [json.loads(line) for f in (tmp_path / "b").glob("metrics*.jsonl")
            for line in f.read_text().splitlines()]
    assert logs and all({"image_loss", "text_loss"} <= set(r) for r in logs)
    infer.main(["--device", "cpu", "--loadDir", str(tmp_path / "b"),
                "--step", "2", "--text_input", "a red fox", "--num_steps",
                "2", "--width", "16", "--height", "16", "--batch_size", "1",
                "--stub_encoders", "--out_imgname", str(tmp_path / "t")])
    assert (tmp_path / "t_0.png").exists()


def test_text_loss_batch_and_loss_match_jax():
    # the mask JAX draws (uniform < 0.25) applies only in the encoder halves
    # whose null flag is set; the masked text feeds the model, the loss is
    # the masked tokens' MSE over every element; and the port's own draw
    # (make_text_loss_batch, a torch.Generator) masks at that rate, gated
    # the same way (n = 64 x 154: a rate's standard error ~4e-3)
    from sd3_tpu.training import flow as jflow
    from sd3_torch.training import flow as tflow

    r = np.random.default_rng(11)
    text = r.standard_normal((4, 14, 6)).astype(np.float32)
    pred = r.standard_normal((4, 14, 6)).astype(np.float32)
    ng, nb = np.array([True, False, True, False]), np.array(
        [True, True, False, False])
    key = jax.random.PRNGKey(5)
    want = jflow.make_text_loss_batch(key, jnp.asarray(text), jnp.asarray(ng),
                                      jnp.asarray(nb), 7)
    drawn = torch.from_numpy(np.array(jax.random.uniform(key, (4, 14))
                                      < 0.25))
    got = tflow.text_loss_batch(_t(text), drawn, torch.from_numpy(ng),
                                torch.from_numpy(nb), 7)
    np.testing.assert_array_equal(got.loss_mask.numpy(), want.loss_mask)
    np.testing.assert_array_equal(_np(got.text_in), want.text_in)
    assert not got.loss_mask[3].any() and got.loss_mask.any()
    _close(tflow.text_recon_loss(_t(pred), got),
           jflow.text_recon_loss(jnp.asarray(pred), want))
    g = torch.Generator().manual_seed(0)
    big = torch.zeros(64, 154, 3)
    on = torch.ones(64, dtype=torch.bool)
    tl = tflow.make_text_loss_batch(g, big, on, ~on, 77)
    assert abs(tl.loss_mask[:, :77].float().mean().item() - 0.25) < 0.02
    assert not tl.loss_mask[:, 77:].any()
