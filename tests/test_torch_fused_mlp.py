"""The int8 SwiGLU kernels' plain versions (K2, K3, K9) and their dispatch held
to sd3_tpu/ops/fused_mlp.py, whose Pallas kernels run here in interpret
mode, on the CPU, in fp32.

Both sides get the same int8 weights (quantized once by JAX) and the same
inputs from a numpy seed. The s32 products are exact on both sides, but the
two frameworks sum the LayerNorm statistics and round the fp32 dequant /
silu chain in different orders, and a last-bit difference in h can move one
element of h across an int8 rounding boundary; one step of a per-chunk scale
(max|h| / 127) times a w3 entry is ~1e-3 of the output scale here. Hence
atol 2e-3 (max |y| ~ 1-3), with the rel-L2 error also held under 1e-3.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.ops import fused_mlp as jfm
from sd3_tpu.ops.quant import quantize_weight

from sd3_torch.ops import fused_mlp as tfm

ATOL, REL_L2 = 2e-3, 1e-3


def _case(d, hidden, seed, d_out=None):
    d_out = d if d_out is None else d_out
    r = np.random.default_rng(seed)
    w12 = r.standard_normal((d, 2 * hidden)).astype(np.float32) * 0.08
    b12 = r.standard_normal(2 * hidden).astype(np.float32) * 0.01
    w3 = r.standard_normal((hidden, d_out)).astype(np.float32) * 0.08
    b3 = r.standard_normal(d_out).astype(np.float32) * 0.01
    k12, s12 = quantize_weight(jnp.asarray(w12))
    k3, s3 = quantize_weight(jnp.asarray(w3))
    jw = (k12, s12, jnp.asarray(b12), k3, s3, jnp.asarray(b3))
    tw = (torch.from_numpy(np.asarray(k12).T.copy()),
          torch.from_numpy(np.array(s12)), torch.from_numpy(b12),
          torch.from_numpy(np.asarray(k3).T.copy()),
          torch.from_numpy(np.array(s3)), torch.from_numpy(b3))
    return jw, tw, r


def _cond(r, b, d, d_out):
    sh = r.standard_normal((b, d)).astype(np.float32) * 0.3
    sc = r.standard_normal((b, d)).astype(np.float32) * 0.3
    g = r.standard_normal((b, d_out)).astype(np.float32) * 0.5
    return sh, sc, g


def _check(got, want):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < REL_L2, rel


@pytest.mark.parametrize("m,n_tok,hidden,k", [
    (8 * 1024, 1024, 4864, 1216),   # image stream, 512px
    (8 * 154, 154, 4864, 1216),     # text stream, 512px
    (2 * 256, 256, 4864, 1216),     # image stream, 256px
    (2 * 1024, 1024, 384, 64),      # the int8 model tests' image stream
    (2 * 14, 14, 384, 64),          # ... and text stream
    (300, 300, 640, 96),
])
def test_block_pickers_match_jax(m, n_tok, hidden, k):
    assert (tfm.pick_tail_blocks(m, n_tok, hidden, k, k)
            == jfm._pick_tail_blocks(m, n_tok, hidden, k, k))
    assert (tfm.pick_block_chunk(m, hidden, k, k)
            == jfm._pick_block_chunk(m, hidden, k, k))


def test_published_shapes_use_256_wide_h_groups():
    # 4864 = 19 * 256: both pickers give 256 at the 512px slice
    assert tfm.pick_tail_blocks(8 * 1024, 1024, 4864, 1216, 1216) == (512, 256)
    assert tfm.pick_tail_blocks(8 * 154, 154, 4864, 1216, 1216) is None
    assert tfm.pick_block_chunk(8 * 154, 4864, 1216, 1216)[1] == 256


@pytest.mark.parametrize("m,d,hidden", [
    (37, 64, 128),      # m <= 256: one 128 chunk, rows padded by JAX
    (200, 64, 384),     # m <= 256: three 128 chunks
    (300, 96, 512),     # m > 256: the VMEM picker, one 512 chunk
    (520, 64, 768),     # m > 256: three 256 chunks
])
def test_k3_plain_matches_jax(m, d, hidden):
    jw, tw, r = _case(d, hidden, seed=m)
    x = r.standard_normal((m, d)).astype(np.float32)
    want = jfm.fused_swiglu_int8(jnp.asarray(x), *jw)
    got = tfm.fused_swiglu_int8(torch.from_numpy(x), *tw)
    _check(got, want)
    # the same through the K3 wrapper with JAX's h_group named explicitly
    bc = jfm._pick_block_chunk(m, hidden, d, d)[1]
    _check(tfm.swiglu_int8(torch.from_numpy(x), *tw, h_group=bc), want)


@pytest.mark.parametrize("b,n,d,hidden", [
    (2, 128, 64, 384),   # one sample per 128-row tile
    (4, 64, 64, 256),    # several samples per tile (n | bm)
])
def test_k2_plain_matches_jax(b, n, d, hidden):
    jw, tw, r = _case(d, hidden, seed=b * n)
    assert jfm._pick_tail_blocks(b * n, n, hidden, d, d) is not None
    x = r.standard_normal((b, n, d)).astype(np.float32)
    sh, sc, g = _cond(r, b, d, d)
    want = jfm.fused_swiglu_int8(jnp.asarray(x), *jw, shift=jnp.asarray(sh),
                                 scale=jnp.asarray(sc), gate=jnp.asarray(g),
                                 residual=True)
    got = tfm.fused_swiglu_int8(torch.from_numpy(x), *tw,
                                shift=torch.from_numpy(sh),
                                scale=torch.from_numpy(sc),
                                gate=torch.from_numpy(g), residual=True)
    _check(got, want)
    # a wrong sample index would be a large error: distinct per-sample gates
    bm, bc = tfm.pick_tail_blocks(b * n, n, hidden, d, d)
    direct = tfm.swiglu_int8_tail(torch.from_numpy(x.reshape(b * n, d)),
                                  torch.from_numpy(sh), torch.from_numpy(sc),
                                  torch.from_numpy(g), *tw, n_tok=n,
                                  h_group=bc)
    _check(direct.reshape(b, n, d), want)


@pytest.mark.parametrize("b,n", [(2, 154), (3, 14)])
def test_unaligned_stream_fallback_matches_jax(b, n):
    d, hidden = 64, 256
    jw, tw, r = _case(d, hidden, seed=n)
    assert jfm._pick_tail_blocks(b * n, n, hidden, d, d) is None
    x = r.standard_normal((b, n, d)).astype(np.float32)
    sh, sc, g = _cond(r, b, d, d)
    want = jfm.fused_swiglu_int8(jnp.asarray(x), *jw, shift=jnp.asarray(sh),
                                 scale=jnp.asarray(sc), gate=jnp.asarray(g),
                                 residual=True)
    got = tfm.fused_swiglu_int8(torch.from_numpy(x), *tw,
                                shift=torch.from_numpy(sh),
                                scale=torch.from_numpy(sc),
                                gate=torch.from_numpy(g), residual=True)
    _check(got, want)


# ---- K9: the per-sample-grid block tail (SD3_MLP_TAIL_FUSION=3d) ---------

@pytest.mark.parametrize("n,hidden", [(154, 4864), (1024, 4864), (14, 384),
                                      (100, 640), (700, 256), (1, 128)])
def test_k9_picker_matches_jax(n, hidden):
    assert tfm.pick_blocks(n, hidden) == jfm._pick_blocks(n, hidden)


@pytest.mark.parametrize("b,n,d,hidden", [
    (2, 128, 64, 384),   # sample-alignable: K2's stream under "2d"
    (3, 14, 64, 256),    # not alignable (K3 between PyTorch prologue and
                         # epilogue under "2d"), one tile per sample here
    (2, 100, 96, 512),   # n padded to 112 by JAX's blocking
])
def test_k9_plain_matches_jax(monkeypatch, b, n, d, hidden):
    jw, tw, r = _case(d, hidden, seed=b * n + 1)
    x = r.standard_normal((b, n, d)).astype(np.float32)
    sh, sc, g = _cond(r, b, d, d)
    monkeypatch.setenv("SD3_MLP_TAIL_FUSION", "3d")
    want = jfm.fused_swiglu_int8(jnp.asarray(x), *jw, shift=jnp.asarray(sh),
                                 scale=jnp.asarray(sc), gate=jnp.asarray(g),
                                 residual=True)
    before = tfm.K9.launches
    counted = []
    monkeypatch.setattr(tfm, "swiglu_int8_tail3d",
                        lambda *a, _f=tfm.swiglu_int8_tail3d, **k:
                        counted.append(k["h_group"]) or _f(*a, **k))
    got = tfm.fused_swiglu_int8(torch.from_numpy(x), *tw,
                                shift=torch.from_numpy(sh),
                                scale=torch.from_numpy(sc),
                                gate=torch.from_numpy(g), residual=True,
                                tail_fusion="3d")
    _check(got, want)
    assert counted == [jfm._pick_blocks(n, hidden)[1]]
    assert tfm.K9.launches == before   # the plain version, on the CPU


def test_k9_rounds_the_conditioning_to_x_dtype(monkeypatch):
    # x in bf16 with fp32 shift / scale / gate: the JAX wrapper casts them
    # to bf16 first (sd3_tpu/ops/fused_mlp.py:443-448), so the result is
    # not the one of the fp32 conditioning. Tolerance: both sides write a
    # bf16 output from the same fp32 chain, summed in other orders, so an
    # element whose int8 level moves is off by up to an ulp of the largest
    # output, 4e-2 (measured: 0, bit-equal); rel L2 1e-3, a third of what
    # leaving the conditioning in fp32 moves it (measured 2.9e-3).
    b, n, d, hidden = 2, 14, 64, 256
    jw, tw, r = _case(d, hidden, seed=31)
    x = r.standard_normal((b, n, d)).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    sh, sc, g = _cond(r, b, d, d)
    monkeypatch.setenv("SD3_MLP_TAIL_FUSION", "3d")
    want = jfm.fused_swiglu_int8(jnp.asarray(xb.float().numpy(), jnp.bfloat16),
                                 *jw, shift=jnp.asarray(sh),
                                 scale=jnp.asarray(sc), gate=jnp.asarray(g),
                                 residual=True)
    cond = dict(shift=torch.from_numpy(sh), scale=torch.from_numpy(sc),
                gate=torch.from_numpy(g), residual=True)
    got = tfm.fused_swiglu_int8(xb, *tw, **cond, tail_fusion="3d")
    assert got.dtype == torch.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=4e-2, rtol=0)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 1e-3
    # the fp32 conditioning itself (K2's and K3's routes keep it) is further
    unrounded = tfm.swiglu_int8_tail3d(
        xb.reshape(b * n, d), cond["shift"], cond["scale"], cond["gate"],
        *tw, n_tok=n, h_group=256).float().numpy().reshape(b, n, d)
    assert np.linalg.norm(unrounded - want) / np.linalg.norm(want) > 2e-3


def test_plain_h_group_changes_the_result():
    # h_group is numerics: a different chunk width changes every h scale
    jw, tw, r = _case(64, 512, seed=5)
    x = torch.from_numpy(r.standard_normal((40, 64)).astype(np.float32))
    a = tfm.swiglu_int8(x, *tw, h_group=128)
    b = tfm.swiglu_int8(x, *tw, h_group=512)
    assert not torch.equal(a, b)
    assert ((a - b).norm() / b.norm()).item() < 2e-2


def test_wrappers_take_the_plain_version_on_the_cpu():
    _, tw, r = _case(64, 128, seed=6)
    x = torch.from_numpy(r.standard_normal((4, 16, 64)).astype(np.float32))
    before = (tfm.K2.launches, tfm.K3.launches, tfm.K9.launches)
    tfm.fused_swiglu_int8(x, *tw)
    cond = dict(shift=torch.zeros(4, 64), scale=torch.zeros(4, 64),
                gate=torch.ones(4, 64), residual=True)
    tfm.fused_swiglu_int8(x, *tw, **cond)
    tfm.fused_swiglu_int8(x, *tw, **cond, tail_fusion="3d")
    assert (tfm.K2.launches, tfm.K3.launches, tfm.K9.launches) == before
    with pytest.raises(ValueError, match="device"):
        tfm.swiglu_int8(x.reshape(64, 64).to("meta"), *tw, h_group=128)
    with pytest.raises(ValueError, match="tail_fusion"):
        tfm.fused_swiglu_int8(x, *tw, **cond, tail_fusion="1d")
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfm.fused_swiglu_int8(x.clone().requires_grad_(), *tw, **cond,
                              tail_fusion="3d")
