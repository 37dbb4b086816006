"""The streaming fused attention (K7, K7q) and the int8-P.V attention (K8a,
K8b) held to the JAX package's Pallas kernels, on the CPU, at JAX's blocks
and at the card kernels' key tiles.

The JAX side runs as its own tests run it (Pallas interpret mode); the port
takes the kernels' plain versions on CPU tensors. Inputs come from numpy
seeds, everything is fp32. Tolerances:
- float scores (K7): the JAX package's fp32 attention tolerance, atol
  2e-5 / rtol 2e-4 (only summation order differs);
- int8 QK^T (K7q, and K8a over K4's scores): atol 1e-3. A last-bit
  difference of the fp32 prep moves the odd element of q^ or k^ by one
  int8 level, which moves one score by s_q * s_k * |other int| <= ~2e-2 in
  the exp2 domain at head dim 16 (K7q's per-row k scales are as large as
  K4's per-head one), and its row's outputs by that times ln 2 * p_key *
  |v - o|: measured up to 3.2e-4 (K4's single-KV case: within 2e-4,
  test_torch_ops.py::test_int8_qk_plain_matches_jax_kernel);
- int8 P.V (K8a, K8b): atol 3e-3. p's int8 level is round(pb) with pb =
  127 * 2^(s - m) in [0, 127]; a last-bit difference in a score moves the
  odd pb across a half-integer, one level on one key, which moves each
  output of its row by |v_int * v_scale| / l, l the row's sum of pb
  (>= 127, here over >= 186 keys: >~ 1e3). Measured: up to 1.2e-3, one or
  two such flips on a row. Each int8 result also differs from the float
  one by more than its atol (7.7e-3 or more here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.ops import rope as jrope
from sd3_tpu.ops.fused_attention import _fused_core, _pallas_fused
from sd3_tpu.ops.fused_attention import (
    fused_dual_flash_attention as j_fused_attention)

from sd3_torch import kernels
from sd3_torch.ops import fused_attention as tfa

ATOL, RTOL = 2e-5, 2e-4
INT8_QK_ATOL = 1e-3
INT8_PV_ATOL = 3e-3


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _case(nh, d, h, w, n_txt, rope2d, seed=0, b=2):
    """Seeded raw q, k, v (b, N, nh*d), the four norm weights, the image
    RoPE angles (None: NoPE), n_img and the scale."""
    n_img = h * w
    r = np.random.default_rng(seed)
    q, k, v = (r.standard_normal((b, n_img + n_txt, nh * d)).astype(np.float32)
               for _ in range(3))
    ws = [(1 + 0.1 * r.standard_normal(d)).astype(np.float32)
          for _ in range(4)]
    angles = (jrope.rope2d_axial_angles(h, w, d).reshape(n_img, d)
              if rope2d else None)
    return q, k, v, ws, angles, n_img, d ** -0.5


def _tables(ws, angles, n, d, n_img):
    """The port's folded (N, D) tables: cosq, sinq, cosk, sink."""
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    return (*tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img),
            *tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img))


def _both(case, nh, int8_qk=False, int8_pv=False, streaming=True,
          block_k=128, monkeypatch=None):
    """(port plain version, JAX `_pallas_fused`) on one case; streaming at
    JAX's single_kv_max=128 and SD3_FLASH_BK=block_k (JAX side only), so
    both take blocks of block_k keys."""
    q, k, v, ws, angles, n_img, scale = case
    n, d = q.shape[1], q.shape[2] // nh
    tabs = _tables(ws, angles, n, d, n_img)
    eps = float(np.finfo(np.float32).eps)
    if streaming:
        monkeypatch.setenv("SD3_FLASH_BK", str(block_k))
    want = np.asarray(_pallas_fused(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        *(jnp.asarray(t.numpy()) for t in tabs), scale, eps, eps, nh,
        block_q_cap=128, single_kv_max=128 if streaming else 2048,
        int8_qk=int8_qk, int8_pv=int8_pv))
    args = (_t(q), _t(k), _t(v), *tabs, scale, eps, eps, nh)
    if streaming:
        plain = (tfa.composition_stream_int8_qk if int8_qk
                 else tfa.composition_stream)
        got = plain(*args, block_k=block_k, int8_pv=int8_pv)
        flt = tfa.composition_stream(*args, block_k=block_k)
    else:
        plain = tfa.composition_int8_qk if int8_qk else tfa.composition
        got = plain(*args, int8_pv=int8_pv)
        flt = tfa.composition(*args)
    return got.numpy(), want, flt.numpy()


# odd heads at head dim 16 (3 blocks of 128 keys), the published head dim
# (2 blocks, the last ragged), NoPE (3 blocks)
STREAM_SHAPES = [
    (3, 16, 10, 16, 40, True),
    (2, 64, 12, 13, 30, True),
    (2, 16, 11, 20, 50, False),
]


# blocks of 128 keys, and the card's K7 key tile (the same 128 today: one
# case then)
@pytest.mark.parametrize("block_k", sorted({128, tfa.K7_KEY_TILE}))
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", STREAM_SHAPES)
def test_stream_plain_matches_jax_kernel(monkeypatch, nh, d, h, w, n_txt,
                                         rope2d, block_k):
    # K7's plain version: the online softmax over blocks of block_k keys
    case = _case(nh, d, h, w, n_txt, rope2d, seed=d + h)
    got, want, _ = _both(case, nh, block_k=block_k, monkeypatch=monkeypatch)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("nh,d", [(1, 16), (3, 32)])
def test_stream_plain_at_the_card_tile_matches_jax_kernel(monkeypatch, nh,
                                                          d):
    # the rounding the card's K7 takes: p against the running max of its
    # K7_KEY_TILE-key tiles, at 2100 tokens (45x46 image + 30 text, a
    # ragged last tile), JAX at the same blocks (SD3_FLASH_BK)
    case = _case(nh, d, 45, 46, 30, True, seed=7, b=1)
    got, want, _ = _both(case, nh, block_k=tfa.K7_KEY_TILE,
                         monkeypatch=monkeypatch)
    assert case[0].shape[1] % tfa.K7_KEY_TILE != 0
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_stream_plain_at_the_head_dim_256_tile_matches_jax_kernel(
        monkeypatch):
    # at head dim 256 the card's K7 rounds p against the running max of
    # K7_KEY_TILE_256-key tiles (its accumulator leaves registers for no
    # more): the plain version over those blocks, at 330 tokens (a ragged
    # last tile; JAX's kernel takes keys padded to a multiple of 128),
    # against JAX at the same blocks (SD3_FLASH_BK)
    case = _case(2, 256, 12, 25, 30, True, seed=11, b=1)
    got, want, _ = _both(case, 2, block_k=tfa.K7_KEY_TILE_256,
                         monkeypatch=monkeypatch)
    assert case[0].shape[1] % tfa.K7_KEY_TILE_256 != 0
    assert tfa.stream_key_tile(False, False, 256) == tfa.K7_KEY_TILE_256
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_stream_plain_at_the_head_dim_512_tile_matches_jax_kernel(
        monkeypatch):
    # at head dims 384 and 512 the card's K7 rounds p against the running
    # max of K7_KEY_TILE_512-key tiles (two stages of K tiles of the whole
    # head fit beside q^ only at that size): the plain version over those
    # blocks, at 370 tokens (a ragged last tile; JAX's kernel takes keys
    # padded to a multiple of 128), against JAX at the same blocks
    # (SD3_FLASH_BK)
    case = _case(1, 512, 12, 25, 70, True, seed=12, b=1)
    got, want, _ = _both(case, 1, block_k=tfa.K7_KEY_TILE_512,
                         monkeypatch=monkeypatch)
    assert case[0].shape[1] % tfa.K7_KEY_TILE_512 != 0
    assert (tfa.stream_key_tile(False, False, 384)
            == tfa.stream_key_tile(False, False, 512) == tfa.K7_KEY_TILE_512)
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


def test_stream_plain_at_the_head_dim_1024_tile_matches_jax_kernel(
        monkeypatch):
    # past head dim 512 the card's K7 (K7_768, K7_1024) rounds p against the
    # running max of K7_KEY_TILE_1024-key tiles (64 keys, their K in chunks
    # of 128 values of the head): the plain version over those blocks, at
    # head dim 640 (run at 768 on the card) and 230 tokens (a ragged last
    # tile; JAX's kernel takes keys padded to a multiple of 128), against
    # JAX at the same blocks (SD3_FLASH_BK), tolerance ATOL / RTOL
    case = _case(1, 640, 10, 20, 30, True, seed=13, b=1)
    got, want, _ = _both(case, 1, block_k=tfa.K7_KEY_TILE_1024,
                         monkeypatch=monkeypatch)
    assert case[0].shape[1] % tfa.K7_KEY_TILE_1024 != 0
    assert all(tfa.stream_key_tile(False, False, d) == tfa.K7_KEY_TILE_1024
               for d in (513, 640, 768, 1000, 1024))
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("int8_qk", [False, True])
@pytest.mark.parametrize("nh,d", [(1, 16), (3, 32)])
def test_int8_pv_plain_at_the_card_tile_matches_jax_kernel(monkeypatch, nh,
                                                           d, int8_qk):
    # the rounding the card's K8b takes, over K7's and over K7q's scores:
    # p's int8 levels against the running max of its K8B_KEY_TILE-key
    # tiles, at 2100 tokens (a ragged last tile), JAX at the same blocks
    # (SD3_FLASH_BK)
    case = _case(nh, d, 45, 46, 30, True, seed=8 + d, b=1)
    got, want, flt = _both(case, nh, int8_qk=int8_qk, int8_pv=True,
                           block_k=tfa.K8B_KEY_TILE, monkeypatch=monkeypatch)
    assert case[0].shape[1] % tfa.K8B_KEY_TILE != 0
    np.testing.assert_allclose(got, want, atol=INT8_PV_ATOL, rtol=0)
    assert np.abs(flt - got).max() > INT8_PV_ATOL


def test_default_block_follows_jax():
    # sd3_tpu/ops/fused_attention.py:563: the fewest equal <= ~2176-row
    # chunks of the 128-padded length
    assert tfa.default_block_k(4250) == 2176    # 4352 = 2 x 2176
    assert tfa.default_block_k(2065) == 2176    # one block
    assert tfa.default_block_k(5000) == 1792    # 5120 = 3 x 1707 -> 1792
    assert tfa.default_block_k(200) == 256


# (int8_qk, int8_pv, streaming): K7q, K8b over K7, K8b over K7q, K8a over
# bf16 scores, K8a over K4's
INT8_VARIANTS = [(True, False, True), (False, True, True), (True, True, True),
                 (False, True, False), (True, True, False)]


@pytest.mark.parametrize("int8_qk,int8_pv,streaming", INT8_VARIANTS)
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", STREAM_SHAPES[:2])
def test_int8_branches_plain_match_jax_kernel(monkeypatch, nh, d, h, w, n_txt,
                                              rope2d, int8_qk, int8_pv,
                                              streaming):
    case = _case(nh, d, h, w, n_txt, rope2d, seed=3 * d + w)
    got, want, flt = _both(case, nh, int8_qk, int8_pv, streaming,
                           monkeypatch=monkeypatch)
    atol = INT8_PV_ATOL if int8_pv else INT8_QK_ATOL
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    # the int8 products are not the float ones
    assert np.abs(flt - got).max() > atol


# every fused variant at head dim 384, which the card runs on the wgmma
# kernels' D = 384 instances: (int8_qk, int8_pv, streaming) K1, K7, K4 and
# the int8 branches above
D384_VARIANTS = [(False, False, False), (False, False, True),
                 (True, False, False), *INT8_VARIANTS]


@pytest.mark.parametrize("int8_qk,int8_pv,streaming", D384_VARIANTS)
def test_head_dim_384_plain_versions_match_jax_kernel(monkeypatch, int8_qk,
                                                      int8_pv, streaming):
    # the plain versions the card's D = 384 instances are held to, against
    # JAX's kernels at 248 tokens (two 128-key blocks, the last ragged, and
    # a ragged last 32-key tile), the streaming ones over the card's key
    # tiles (stream_key_tile: K7's 32, K7q's and K8b's 128), in this file's
    # tolerances
    case = _case(2, 384, 12, 19, 20, True, seed=384, b=1)
    block_k = tfa.stream_key_tile(int8_qk, int8_pv, 384)
    got, want, flt = _both(case, 2, int8_qk, int8_pv, streaming,
                           block_k=block_k, monkeypatch=monkeypatch)
    atol = (INT8_PV_ATOL if int8_pv else INT8_QK_ATOL if int8_qk else ATOL)
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=0 if (int8_qk or int8_pv) else RTOL)
    if int8_qk or int8_pv:  # the int8 products are not the float ones
        assert np.abs(flt - got).max() > atol


def _launches():
    return {k.name: k.launches for k in kernels.REGISTRY}


@pytest.mark.parametrize("int8_qk,int8_pv", [(False, False), (True, False),
                                             (False, True)])
def test_public_attention_past_2048_tokens_matches_jax(int8_qk, int8_pv):
    # a true 1024px-stage length at a narrow width: a 45x45 image grid and
    # 40 text tokens, 2065 tokens padded to 2176 > 2048, so both packages
    # take the streaming path with their default (one-block) blocking; on
    # CPU tensors no kernel launches
    q, k, v, ws, angles, n_img, scale = _case(1, 16, 45, 45, 40, True,
                                              seed=11, b=1)
    want = j_fused_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             1, *map(jnp.asarray, ws), angles, n_img, scale,
                             int8_qk=int8_qk, int8_pv=int8_pv)
    before = _launches()
    got = tfa.fused_dual_flash_attention(_t(q), _t(k), _t(v), 1,
                                         *map(_t, ws), angles, n_img, scale,
                                         int8_qk=int8_qk, int8_pv=int8_pv)
    assert _launches() == before
    atol = (INT8_PV_ATOL if int8_pv else INT8_QK_ATOL if int8_qk else ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=0 if (int8_qk or int8_pv) else RTOL)


def test_stream_gradients_match_jax_vjp():
    # K7's autograd Function past 2048 tokens (its plain version here, the
    # backward through the plain prep and flash attention) against the JAX
    # fused core's custom VJP, which recomputes through the same composition
    # at every length: q, k, v and the four tables
    q, k, v, ws, angles, n_img, scale = _case(1, 16, 45, 45, 40, True,
                                              seed=12, b=1)
    n, d = q.shape[1], 16
    tabs = [t.detach() for t in _tables(ws, angles, n, d, n_img)]
    g = np.random.default_rng(13).standard_normal(q.shape).astype(np.float32)
    eps = float(np.finfo(np.float32).eps)
    fn = lambda *a: _fused_core(*a, scale, eps, eps, 1)
    want_out, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)),
                            *(jnp.asarray(t.numpy()) for t in tabs))
    want = vjp(jnp.asarray(g))
    ins = [_t(a).requires_grad_() for a in (q, k, v)] + [
        t.clone().requires_grad_() for t in tabs]
    out = tfa.fused_attention(ins[0], ins[1], ins[2], 1, *ins[3:], scale)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ATOL, rtol=RTOL)
    got = torch.autograd.grad(out, ins, _t(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-3)


@pytest.mark.parametrize("int8_qk,int8_pv,streaming", INT8_VARIANTS)
def test_int8_kernels_refuse_gradients(int8_qk, int8_pv, streaming):
    # K7q, K8a and K8b are serving kernels, as in JAX: an input that
    # requires grad raises; under no_grad they run
    q, k, v, ws, angles, n_img, scale = _case(2, 16, 3, 4, 5, True, seed=14)
    tabs = _tables(ws, angles, q.shape[1], 16, n_img)
    qt = _t(q).requires_grad_()
    kw = dict(int8_qk=int8_qk, int8_pv=int8_pv,
              single_kv_max=0 if streaming else 2048)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfa.fused_attention(qt, _t(k), _t(v), 2, *tabs, scale, **kw)
    with torch.no_grad():
        out = tfa.fused_attention(qt, _t(k), _t(v), 2, *tabs, scale, **kw)
    assert out.shape == qt.shape and torch.isfinite(out).all()


@pytest.mark.parametrize("int8_qk,int8_pv,streaming", D384_VARIANTS)
@pytest.mark.parametrize("d", [640, 1000])
def test_head_dims_past_512_plain_versions_match_jax_kernel(
        monkeypatch, d, int8_qk, int8_pv, streaming):
    # the plain versions the card's D = 768 and 1024 instances are held to
    # (640 and 1000 run there padded), K1, K7, K4, K7q, K8a and K8b over
    # both scores, against JAX's kernels on one head at 230 tokens (past
    # JAX's streaming length here, 128, and padded by its kernel to a
    # multiple of 128 from the card's 64-key tiles; a ragged last key
    # tile), the streaming ones over the card's key tiles (stream_key_tile:
    # K7's 64, K7q's and K8b's 128), in this file's tolerances
    case = _case(1, d, 10, 20, 30, True, seed=d, b=1)
    block_k = tfa.stream_key_tile(int8_qk, int8_pv, d)
    got, want, flt = _both(case, 1, int8_qk, int8_pv, streaming,
                           block_k=block_k, monkeypatch=monkeypatch)
    atol = (INT8_PV_ATOL if int8_pv else INT8_QK_ATOL if int8_qk else ATOL)
    np.testing.assert_allclose(got, want, atol=atol,
                               rtol=0 if (int8_qk or int8_pv) else RTOL)
    if int8_qk or int8_pv:  # the int8 products are not the float ones
        assert np.abs(flt - got).max() > atol
