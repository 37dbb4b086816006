"""sd3_torch's int8 (w8a8) weights and projections held to sd3_tpu's, on the
CPU, in fp32.

Weight quantization is compared bit for bit: the same fp32 weights, the same
division and the same round-half-to-even on both sides. Both routes across
must give the same int8 weights and scales: a JAX float tree quantized by
the port (`quantize_model`), and a JAX-quantized tree (`quantize_params`)
carried across. `int8_dense_apply`'s s32 sums are exact on both sides, so it
matches to fp32 rounding of the dequantization (rtol 1e-6).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.ops import quant as jquant

from sd3_torch.config import MMDiTConfig
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.ops import quant as tquant
from sd3_torch.weights import state_dict_from_jax


def _weights(seed, shape=(48, 40)):
    w = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    w[:, 3] = 0.0       # an all-zero output channel: the eps floor
    w[5, 7] = 40.0      # an outlier that sets its channel's scale
    return w


def test_quantize_weight_is_bit_exact_against_jax():
    w = _weights(0)                        # JAX layout (in, out)
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    tq, ts = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq).T)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_quantize_rows_rounds_half_to_even():
    # scale 1: the amax row element 127 sets s = 1; x.5 rounds to even
    x = torch.tensor([[127.0, 2.5, 3.5, -2.5, -0.5, 126.5]])
    q, s = tquant.quantize_rows(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 2, 4, -2, 0, 126]]


@pytest.mark.parametrize("bias", [True, False])
def test_int8_dense_apply_matches_jax(bias):
    r = np.random.default_rng(1)
    w = _weights(2, (40, 24))
    x = (r.standard_normal((3, 5, 40)) * 2).astype(np.float32)
    b = r.standard_normal(24).astype(np.float32) if bias else None
    jq, js = jquant.quantize_weight(jnp.asarray(w))
    want = jquant.int8_dense_apply(jnp.asarray(x), jq, js,
                                   None if b is None else jnp.asarray(b),
                                   jnp.float32)
    tq, ts = tquant.quantize_weight(torch.from_numpy(w.T.copy()))
    got = tquant.int8_dense_apply(torch.from_numpy(x), tq, ts,
                                  None if b is None else torch.from_numpy(b))
    assert got.shape == (3, 5, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_int_mm_is_exact():
    r = np.random.default_rng(3)
    a = r.integers(-127, 128, (20, 64)).astype(np.int8)
    w = r.integers(-127, 128, (24, 64)).astype(np.int8)
    got = tquant.int_mm(torch.from_numpy(a), torch.from_numpy(w))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  a.astype(np.int64) @ w.astype(np.int64).T)


@pytest.mark.parametrize("skip", [(), ("w3", "out_proj_x", "attn_qk")])
def test_both_routes_across_give_identical_int8_weights(skip):
    jcfg = j_tiny_config(attn_type="softmax_flash", quant_skip=skip)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(0), remat_blocks=False)
    cfg = MMDiTConfig.from_json(jcfg.to_json(), quant_skip=skip)
    # route 1: float tree across, quantized by the port
    a = MMDiT(cfg, device="cpu")
    a.load_state_dict(state_dict_from_jax(params), strict=True)
    tquant.quantize_model(a)
    assert a.cfg.quant == "int8" and a.cfg.quant_skip == skip
    # route 2: quantized by JAX, carried across into an int8 model
    jq = jquant.quantize_params(params, quant_skip=skip)
    sd = state_dict_from_jax(jq)
    b = MMDiT(cfg.replace(quant="int8"), device="cpu")
    b.load_state_dict(sd, strict=True)
    sa, sb = a.state_dict(), b.state_dict()
    assert sa.keys() == sb.keys()
    for k in sa:
        assert sa[k].dtype == sb[k].dtype, k
        assert torch.equal(sa[k], sb[k]), k
    # what was and was not quantized, as quantize_params decides
    blk = "blocks.0."
    assert sd[blk + "MLP_x.MLP.w12.weight_q"].dtype == torch.int8
    assert sd[blk + "attn.query_proj_x.weight_scale"].dtype == torch.float32
    assert ("out_proj.weight" in sd) and ("out_proj.weight_q" not in sd)
    assert (blk + "MLP_x.MLP.w3.weight" in sd) == ("w3" in skip)
    assert (blk + "attn.out_proj_x.weight" in sd) == ("out_proj_x" in skip)
    assert all(m.quant == "int8" for m in b.modules() if hasattr(m, "quant"))


def test_cast_keeps_int8_weights_and_fp32_scales():
    jcfg = j_tiny_config(attn_type="softmax_flash")
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(1), remat_blocks=False)
    cfg = MMDiTConfig.from_json(jcfg.to_json(), quant="int8")
    m = MMDiT(cfg, device="cpu")
    m.load_state_dict(state_dict_from_jax(jquant.quantize_params(params)))
    m.cast_params(torch.bfloat16)
    w12 = m.blocks[0].MLP_x.MLP.w12
    assert w12.weight_q.dtype == torch.int8
    assert w12.weight_scale.dtype == torch.float32
    assert w12.bias.dtype == torch.bfloat16
    assert m.time_scale.dtype == torch.float32
    assert m.out_proj.weight.dtype == torch.bfloat16
    with pytest.raises(ValueError, match="quantize_model"):
        m.init_weights()
