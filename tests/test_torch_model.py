"""sd3_torch's block and model held to the JAX MMDiT, on the CPU, in fp32.

The same JAX parameters cross into the port through
`sd3_torch.weights.state_dict_from_jax` and a strict load. The JAX fused
attention runs as its own CPU tests run it (Pallas interpret mode); the port
takes K1's plain version on CPU tensors. Tolerance atol 1e-4, rtol 1e-3:
fp32 on both sides, but summation order differs in every matmul, norm and
softmax of a few stacked layers (the JAX package's torch-oracle parity
tests use 5e-4 / 5e-3 for the same reason).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.config import published_config as j_published_config
from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models.mmdit import DualStreamBlock as JBlock
from sd3_tpu.models.mmdit import MMDiT as JMMDiT
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.ops.quant import quantize_params
from sd3_tpu.training.checkpoint import import_torch_state_dict

from sd3_torch.config import MMDiTConfig, published_config, tiny_config
from sd3_torch.models.mmdit import DualStreamBlock, MMDiT
from sd3_torch.ops import fused_attention as tfa
from sd3_torch.ops import fused_dense as tfd
from sd3_torch.ops import fused_mlp as tfm
from sd3_torch.ops.fused_attention import K1
from sd3_torch.weights import load_reference_state_dict, state_dict_from_jax

ATOL, RTOL = 1e-4, 1e-3


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _inputs(cfg, b=2, h=8, w=8, seed=0):
    r = np.random.default_rng(seed)
    x = r.standard_normal((b, cfg.inCh, h, w)).astype(np.float32)
    t = r.uniform(0, 1, (b,)).astype(np.float32)
    c = r.standard_normal((b, cfg.text_tokens, cfg.text_hidden_dim)
                          ).astype(np.float32)
    cp = r.standard_normal((b, cfg.class_dim)).astype(np.float32)
    return x, t, c, cp


def _port_model(jcfg, params):
    cfg = MMDiTConfig.from_json(jcfg.to_json())
    model = MMDiT(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params, jcfg.patch_size),
                          strict=True)
    return model


def test_config_json_round_trips_between_packages():
    for jcfg in (j_tiny_config(attn_type="softmax_flash"),
                 j_published_config(512)):
        cfg = MMDiTConfig.from_json(jcfg.to_json())
        assert cfg.to_json_dict() == jcfg.to_json_dict()
        assert type(jcfg).from_json(cfg.to_json()) == jcfg
    assert published_config(512).to_json() == j_published_config(512).to_json()
    assert tiny_config().to_json() == j_tiny_config().to_json()


@pytest.mark.parametrize("last", [False, True])
def test_dual_stream_block_matches_jax(last):
    jcfg = j_tiny_config(attn_type="softmax_flash")
    r = np.random.default_rng(3)
    x = r.standard_normal((2, 16, jcfg.dim)).astype(np.float32)
    c = r.standard_normal((2, 14, jcfg.dim)).astype(np.float32)
    y = r.standard_normal((2, jcfg.dim)).astype(np.float32)
    jb = JBlock(jcfg, layer_idx=1, last=last)
    params = jb.init(jax.random.PRNGKey(4), jnp.asarray(x), jnp.asarray(c),
                     jnp.asarray(y), (4, 4))["params"]
    wx, wc = jb.apply({"params": params}, jnp.asarray(x), jnp.asarray(c),
                      jnp.asarray(y), (4, 4))
    sd = state_dict_from_jax({"blocks_0": params})
    sd = {k[len("blocks.0."):]: v for k, v in sd.items()}
    tb = DualStreamBlock(tiny_config(attn_type="softmax_flash"), 1, last=last)
    tb.load_state_dict(sd, strict=True)
    assert ("attn.out_proj_c.weight" in sd) == (not last)
    with torch.no_grad():
        gx, gc = tb(_t(x), _t(c), _t(y), (4, 4))
    np.testing.assert_allclose(gx.numpy(), wx, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(gc.numpy(), wc, atol=ATOL, rtol=RTOL)


def test_mmdit_matches_jax_with_null_masks():
    jcfg = j_tiny_config(attn_type="softmax_flash", num_blocks=3)
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(5), remat_blocks=False)
    x, t, c, cp = _inputs(jcfg, seed=6)
    nulls = [np.array(m) for m in ([True, False], [False, True],
                                   [True, True])]
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, t, c, cp)),
                    *map(jnp.asarray, nulls))
    model = _port_model(jcfg, params)
    before = K1.launches
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)), *map(torch.from_numpy, nulls))
    assert got.dtype == torch.float32 and K1.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    # no masks: the plain forward matches too
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, t, c, cp)))
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_one_block_at_published_widths_matches_jax():
    # dim 1216, 19 heads of 64, SwiGLU x4, text width 2304 and 154 text
    # tokens; a 4x4 token grid keeps it small
    jcfg = j_published_config(256).replace(num_blocks=1, dtype="float32")
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(7), height=8, width=8,
                            remat_blocks=False)
    x, t, c, cp = _inputs(jcfg, b=1, seed=8)
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, t, c, cp)))
    model = _port_model(jcfg, params)
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


def test_weight_carrier_round_trip_and_reference_buffers():
    jcfg = j_tiny_config(attn_type="softmax_flash")
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(9), remat_blocks=False)
    model = _port_model(jcfg, params)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    assert tuple(sd["pos_enc.proj.weight"].shape) == (jcfg.dim, jcfg.inCh, 2, 2)
    # the JAX importer reads the port's state_dict back to the same tree
    back = import_torch_state_dict(sd)
    flat_a = jax.tree_util.tree_leaves_with_path(params)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, leaf in flat_a:
        np.testing.assert_array_equal(np.asarray(flat_b[path]),
                                      np.asarray(leaf))
    # reference checkpoints carry recomputed buffers: dropped, then strict
    sd["blocks.0.attn.rotary_emb.freqs"] = torch.zeros(3)
    sd["pos_enc.pos_embed"] = torch.zeros(1, 4, jcfg.dim)
    fresh = MMDiT(tiny_config(attn_type="softmax_flash"), device="cpu")
    load_reference_state_dict(fresh, sd)
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    sd["blocks.0.attn.unexpected"] = torch.zeros(1)
    with pytest.raises(RuntimeError, match="Unexpected"):
        load_reference_state_dict(fresh, sd)


def test_init_weights_is_seeded_and_cast_keeps_time_scale_fp32():
    cfg = tiny_config(attn_type="softmax_flash")
    a, b = (MMDiT(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(0)) for _ in range(2))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert a.time_scale.item() == 1000.0
    assert torch.all(a.blocks[0].attn.q_norm_x.weight == 1)
    a.cast_params(torch.bfloat16)
    assert a.time_scale.dtype == torch.float32
    assert a.blocks[0].attn.query_proj_x.weight.dtype == torch.bfloat16


# ---- int8 (w8a8) serving --------------------------------------------------
# A width at which the int8 kernels' routes are all on: hidden = 64 * 2 is a
# multiple of 128 (the fused SwiGLU), head dim 32 divides 128 (the fused
# attention); 2 samples of 14 text tokens are not sample-alignable (K3).
INT8_CFG = dict(attn_type="softmax_flash", dim=64, hidden_scale=2.0,
                num_heads=2, num_blocks=2)


def _int8_pair(hw, seed, int8_pv=False, port=None, **kw):
    """(JAX int8 model, its quantized params, JAX float model, float params,
    the port's int8 model with the same int8 weights; with int8_pv the
    port's config opts in to int8 P.V; `port` holds further fields of the
    port's config only)."""
    jcfg = j_tiny_config(**{**INT8_CFG, **kw})
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(seed), height=hw,
                            width=hw, remat_blocks=False)
    qparams = quantize_params(params, quant_skip=jcfg.quant_skip)
    jq = JMMDiT(jcfg.replace(quant="int8"), remat_blocks=False)
    cfg = MMDiTConfig.from_json(jcfg.to_json(), quant="int8",
                                quant_skip=jcfg.quant_skip, int8_pv=int8_pv,
                                **(port or {}))
    model = MMDiT(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(qparams), strict=True)
    return jq, qparams, jm, params, model


ROUTES = {"K1": (tfa, "composition"), "K4": (tfa, "composition_int8_qk"),
          "K2": (tfm, "swiglu_int8_tail"), "K3": (tfm, "swiglu_int8"),
          "K9": (tfm, "swiglu_int8_tail3d"),
          "K10a": (tfd, "qkv_adaln_int8"),
          "K10b": (tfd, "out_gate_residual_int8")}


def _count_routes(monkeypatch, keys=("K1", "K2", "K3", "K4")):
    """Count the kernel wrappers (on the CPU: their plain versions) the
    forward takes, by kernel."""
    counts = dict.fromkeys(keys, 0)
    for key in keys:
        mod, name = ROUTES[key]
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _key=key, **k):
            counts[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return counts


def _int8_run_and_check(monkeypatch, hw, seed, int8_pv=False,
                        count=None, port=None, **kw):
    """One forward of the JAX int8 model and the port's on the same inputs;
    returns the port's route counts. Tolerance: w8a8 quantization is
    discontinuous. The two frameworks sum RMSNorm, LayerNorm and the
    dequantization in different orders, a last-bit difference moves the odd
    element across an int8 rounding boundary (one level, 1/127 of its row's
    scale), and attention spreads each such step over every token of the
    next layer, where it moves more. So the port is held by rel L2 <= 1e-2,
    and to at most half of what separates JAX's own float model from its
    int8 one: a port that skipped or misplaced a quantization fails."""
    jq, qparams, jm, params, model = _int8_pair(hw, seed, int8_pv, port,
                                                **kw)
    assert (isinstance(model.blocks[0].MLP_x.MLP.w3, torch.nn.Linear)
            == ("w3" in jq.cfg.quant_skip))
    x, t, c, cp = _inputs(jq.cfg, h=hw, w=hw, seed=seed + 1)
    args = [jnp.asarray(a) for a in (x, t, c, cp)]
    want = np.asarray(jq.apply({"params": qparams}, *args))
    flt = np.asarray(jm.apply({"params": params}, *args))
    counts = (count or _count_routes)(monkeypatch)
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp))).numpy()
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    int8_effect = np.linalg.norm(flt - want) / np.linalg.norm(want)
    assert rel <= 1e-2 and rel <= 0.5 * int8_effect, (rel, int8_effect)
    return counts


def test_int8_mmdit_with_every_kernel_route_on_matches_jax(monkeypatch):
    # 64x64 latents at patch 2: 1024 image + 14 text tokens pad to 1152, in
    # K4's [1024, 2048]; the image stream tiles sample-aligned (K2), the text
    # stream does not (K3, then only in the first block: the last block has
    # no text MLP). Measured: rel L2 3.3e-3, against 1.4e-2 between JAX's
    # float and int8 models.
    counts = _int8_run_and_check(monkeypatch, hw=64, seed=21)
    assert counts == dict(K1=0, K2=2, K3=1, K4=2)


def test_int8_mmdit_below_1024_tokens_takes_k1_and_matches_jax(monkeypatch):
    # 16x16 latents: 64 + 14 tokens pad to 128, below K4's gate, so the
    # attention is K1's (plain) route while the image-stream MLP is still
    # K2's (2 samples of 64 tokens fill one 128-row tile)
    counts = _int8_run_and_check(monkeypatch, hw=16, seed=23)
    assert counts == dict(K1=2, K2=2, K3=1, K4=0)


def test_int8_quant_skip_turns_routes_off(monkeypatch):
    # quant_skip names stay float: w3 float turns the fused SwiGLU off (two
    # projections with silu * mul between them), attn_qk turns K4 off
    counts = _int8_run_and_check(monkeypatch, hw=16, seed=25,
                                 quant_skip=("w3", "attn_qk"))
    assert counts == dict(K1=2, K2=0, K3=0, K4=0)


# The opt-in int8 block tails: the JAX package's env flags against the
# port's config fields, on the int8 model above at 16x16 latents, where the
# image stream (2 samples of 64 tokens, 128 rows) tiles sample-aligned for
# K10a and K10b and the 14-token text stream does not (their fallbacks, and
# K9 under "3d"); the last block has no text MLP and no text
# out-projection. Tolerance: `_int8_run_and_check`'s.
TAIL_ROUTES = ("K1", "K2", "K3", "K4", "K9", "K10a", "K10b")
TAIL_CASES = [
    # (attn_type, port config fields, JAX env, routes other than zero)
    ("softmax_flash", dict(attn_tail="all", mlp_tail_fusion="3d"),
     dict(SD3_ATTN_TAIL="all", SD3_MLP_TAIL_FUSION="3d"),
     dict(K1=2, K9=3, K10a=2, K10b=2)),
    ("softmax_flash", dict(attn_tail="qkv"), dict(SD3_ATTN_TAIL="qkv"),
     dict(K1=2, K2=2, K3=1, K10a=2)),
    ("softmax_flash", dict(attn_tail="out"), dict(SD3_ATTN_TAIL="out"),
     dict(K1=2, K2=2, K3=1, K10b=2)),
    ("softmax_flash", dict(mlp_tail_fusion="3d"),
     dict(SD3_MLP_TAIL_FUSION="3d"), dict(K1=2, K9=3)),
    ("softmax_flash", dict(attn_tail="all", mlp_tail=False),
     dict(SD3_ATTN_TAIL="all", SD3_NO_MLP_TAIL="1"),
     dict(K1=2, K3=3, K10a=2, K10b=2)),
    ("softmax_flash", dict(attn_tail="all", fused_mlp=False),
     dict(SD3_ATTN_TAIL="all", SD3_NO_FUSED_MLP="1"),
     dict(K1=2, K10a=2, K10b=2)),
    ("softmax", dict(attn_tail="all", mlp_tail_fusion="3d"),
     dict(SD3_ATTN_TAIL="all", SD3_MLP_TAIL_FUSION="3d"), dict(K9=3)),
]


@pytest.mark.parametrize("attn_type,port,env,routes", TAIL_CASES, ids=[
    "all-3d", "qkv", "out", "3d", "all-no_mlp_tail", "all-no_fused_mlp",
    "softmax-all-3d"])
def test_int8_block_tails_match_jax(monkeypatch, attn_type, port, env,
                                    routes):
    for name, value in env.items():
        monkeypatch.setenv(name, value)
    counts = _int8_run_and_check(
        monkeypatch, hw=16, seed=27, port=port, attn_type=attn_type,
        count=lambda mp: _count_routes(mp, TAIL_ROUTES))
    assert counts == {**dict.fromkeys(TAIL_ROUTES, 0), **routes}


def test_int8_attn_tail_quant_skip_turns_k10_off(monkeypatch):
    # a skipped image projection keeps its kernel out: "key_proj_x" K10a
    # (the three take one kernel), "out_proj_x" K10b; the text out-projection
    # declines the 14-token stream, so neither kernel runs
    monkeypatch.setenv("SD3_ATTN_TAIL", "all")
    counts = _int8_run_and_check(
        monkeypatch, hw=16, seed=29, port=dict(attn_tail="all"),
        quant_skip=("key_proj_x", "out_proj_x"),
        count=lambda mp: _count_routes(mp, TAIL_ROUTES))
    assert counts == dict(K1=2, K2=2, K3=1, K4=0, K9=0, K10a=0, K10b=0)


def test_block_tail_fields_are_runtime_choices():
    # validated, and, as quant and int8_pv, not written to the params JSON
    for bad in (dict(attn_tail="qv"), dict(mlp_tail_fusion="1d")):
        with pytest.raises(ValueError):
            tiny_config(**bad)
    cfg = tiny_config(attn_tail="all", mlp_tail_fusion="3d", mlp_tail=False,
                      fused_mlp=False)
    back = MMDiTConfig.from_json(cfg.to_json())
    assert (back.attn_tail, back.mlp_tail_fusion, back.mlp_tail,
            back.fused_mlp) == ("none", "2d", True, True)
    assert cfg.to_json() == tiny_config().to_json()


@pytest.mark.parametrize("kw", [dict(text_loss=True), dict(MLP_type="swiglu_old"),
                                dict(attn_type="cosine"),
                                dict(positional_encoding="RoPE2dV2"),
                                dict(MLP_type="gelu"),
                                dict(attn_type="softmax_flash",
                                     positional_encoding="absolute")])
def test_unported_configurations_raise(kw):
    kw = {"attn_type": "softmax_flash", **kw}
    with pytest.raises(NotImplementedError):
        MMDiT(tiny_config(**kw), device="cpu")


# ---- training: the general attention path and K1's gradient ---------------

@pytest.mark.parametrize("attn_type,use_fused,last", [
    ("softmax", False, False), ("softmax", False, True),
    ("softmax_flash", False, False), ("softmax_flash", False, True),
    ("softmax_flash", True, False)])
def test_joint_attention_forward_and_gradients_match_jax(attn_type, use_fused,
                                                         last):
    # the general path (per-stream projections and norms, RoPE in fp32 on
    # the image tokens, then plain softmax or flash attention) and, with
    # use_fused, K1's autograd Function: outputs and the gradients of every
    # parameter and both inputs, held to jax.grad of the same loss
    from sd3_tpu.ops.attention import JointAttention as JAttn
    from sd3_torch.ops.attention import JointAttention
    r = np.random.default_rng(31)
    dim, nh, hw = 48, 3, (3, 4)
    x = r.standard_normal((2, 12, dim)).astype(np.float32)
    c = r.standard_normal((2, 5, dim)).astype(np.float32)
    gx = r.standard_normal((2, 12, dim)).astype(np.float32)
    gc = r.standard_normal((2, 5, dim)).astype(np.float32)
    kw = dict(attn_type=attn_type, positional_encoding="RoPE2d", layer_idx=1,
              dual=True, last=last, use_fused=use_fused)
    ja = JAttn(dim, nh, **kw)
    params = ja.init(jax.random.PRNGKey(32), jnp.asarray(x), jnp.asarray(c),
                     hw)["params"]
    # norm weights away from their init of ones, so their gradients matter
    params = {k: ({"weight": jnp.asarray(1 + 0.1 * r.standard_normal(
        v["weight"].shape).astype(np.float32))} if "norm" in k else v)
        for k, v in params.items()}

    def loss(p, a, b):
        ox, oc = ja.apply({"params": p}, a, b, hw)
        return jnp.sum(ox * gx) + jnp.sum(oc * gc), (ox, oc)

    (_, (wx, wc)), grads = jax.value_and_grad(loss, (0, 1, 2), has_aux=True)(
        params, jnp.asarray(x), jnp.asarray(c))
    ta = JointAttention(dim, nh, **kw)
    ta.load_state_dict(state_dict_from_jax(params), strict=True)
    assert ta.fused == use_fused
    tx, tc = _t(x).requires_grad_(), _t(c).requires_grad_()
    ox, oc = ta(tx, tc, hw)
    np.testing.assert_allclose(ox.detach().numpy(), wx, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(oc.detach().numpy(), wc, atol=ATOL, rtol=RTOL)
    ((ox * _t(gx)).sum() + (oc * _t(gc)).sum()).backward()
    want = state_dict_from_jax(grads[0])
    got = dict(ta.named_parameters())
    assert set(got) == set(want)
    for name, p in got.items():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=ATOL, rtol=RTOL, err_msg=name)
    np.testing.assert_allclose(tx.grad.numpy(), grads[1], atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(tc.grad.numpy(), grads[2], atol=ATOL, rtol=RTOL)


# ---- past 2048 joint tokens: the streaming attention (K7, K8b) -------------
# 96x96 latents at patch 2: 2304 image + 14 text = 2318 joint tokens, padded
# to 2432 > 2048, so the fused attention takes the streaming kernels'
# (plain) routes in both packages, at JAX's default blocking; 2304 image
# rows per sample tile sample-aligned, so the int8 image-stream MLP is K2's
BIG_HW = 96


def test_int8_pv_gate_follows_the_padded_length():
    from sd3_torch.ops.attention import int8_pv_on
    assert not int8_pv_on("int8", (), 2048, True)       # single-KV: never
    assert int8_pv_on("int8", (), 2049, True)           # pads to 2176 (K8b)
    assert int8_pv_on("int8", (), 4250, True)           # the 1024px stage
    assert not int8_pv_on("int8", (), 1178, True)       # 512px
    assert not int8_pv_on("int8", (), 4250, False)      # opt-in only
    assert not int8_pv_on("none", (), 4250, True)
    assert not int8_pv_on("int8", ("attn_pv",), 4250, True)
    assert int8_pv_on("int8", ("attn_qk", "w12"), 4250, True)


def _count_stream_routes(monkeypatch):
    """Count the attention and MLP plain versions the CPU forward takes, by
    kernel: the int8_pv keyword tells K8a / K8b from the float routes."""
    counts = dict.fromkeys(("K1", "K2", "K3", "K4", "K7", "K7q", "K8a",
                            "K8b"), 0)
    for mod, name, keys in (
            (tfa, "composition", ("K1", "K8a")),
            (tfa, "composition_int8_qk", ("K4", "K8a")),
            (tfa, "composition_stream", ("K7", "K8b")),
            (tfa, "composition_stream_int8_qk", ("K7q", "K8b")),
            (tfm, "swiglu_int8_tail", ("K2", "K2")),
            (tfm, "swiglu_int8", ("K3", "K3"))):
        fn = getattr(mod, name)

        def counted(*a, _fn=fn, _keys=keys, **k):
            counts[_keys[bool(k.get("int8_pv"))]] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    return counts


def test_mmdit_past_2048_tokens_matches_jax(monkeypatch):
    # the float model: K7's route in both blocks, within the fp32 model
    # tolerance of the JAX model (fused streaming kernel, interpret mode)
    jcfg = j_tiny_config(**INT8_CFG)
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(41), height=BIG_HW,
                            width=BIG_HW, remat_blocks=False)
    x, t, c, cp = _inputs(jcfg, h=BIG_HW, w=BIG_HW, seed=42)
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, t, c, cp)))
    model = _port_model(jcfg, params)
    counts = _count_stream_routes(monkeypatch)
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)))
    assert counts == dict(K1=0, K2=0, K3=0, K4=0, K7=2, K7q=0, K8a=0, K8b=0)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8_pv", [False, True])
def test_int8_mmdit_past_2048_tokens_matches_jax(monkeypatch, int8_pv):
    # int8 serving at the streaming length: int8 QK^T is gated off above
    # 2048 tokens (K7's route), the MLPs take K2 / K3; with int8_pv the
    # attention takes K8b's route. The JAX side reads SD3_INT8_PV=1 where
    # the port reads its config's int8_pv. Tolerance as for the int8 models
    # above (_int8_run_and_check): rel L2 <= 1e-2 and at most half of the
    # JAX float-to-int8 difference.
    if int8_pv:
        monkeypatch.setenv("SD3_INT8_PV", "1")
    counts = _int8_run_and_check(monkeypatch, hw=BIG_HW, seed=43,
                                 int8_pv=int8_pv, count=_count_stream_routes)
    attn = dict(K7=0, K8b=2) if int8_pv else dict(K7=2, K8b=0)
    assert counts == dict(K1=0, K2=2, K3=1, K4=0, K7q=0, K8a=0, **attn)


def test_fp32_two_block_tiny_forward_matches_jax():
    # the fp32 configuration (JAX's --dtype float32, the bit-match gate; on
    # the card the fp32 instances K1F / K7F take its attention): a 2-block
    # tiny_config model, head dim 16, through the fused attention route,
    # with null masks; fp32 on both sides, the tolerances above
    jcfg = j_tiny_config(attn_type="softmax_flash", num_blocks=2,
                         dtype="float32")
    jm, params = init_mmdit(jcfg, jax.random.PRNGKey(11), remat_blocks=False)
    x, t, c, cp = _inputs(jcfg, seed=12)
    nulls = [np.array(m) for m in ([False, True], [True, False],
                                   [False, False])]
    want = jm.apply({"params": params}, *map(jnp.asarray, (x, t, c, cp)),
                    *map(jnp.asarray, nulls))
    model = _port_model(jcfg, params)
    assert model.cfg.dtype == "float32"
    assert model.cfg.dim // model.cfg.num_heads == 16
    with torch.no_grad():
        got = model(*map(_t, (x, t, c, cp)), *map(torch.from_numpy, nulls))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
