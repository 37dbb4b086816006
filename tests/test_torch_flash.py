"""The plain versions of kernels K5, K6a and K6b and the flash-attention
autograd Function of sd3_torch, held to the JAX flash attention on the CPU.

The JAX side runs as its own CPU tests run it: its Pallas kernels in
interpret mode, forward and custom VJP. Inputs come from numpy seeds and go
to both packages in fp32. Tolerance atol 2e-5, rtol 2e-4: fp32 on both
sides, and only the summation order differs (JAX pads to 128-row blocks,
sums P.V in its own order and, above 2048 keys, runs an online softmax over
512-key blocks where the plain version takes the true row max in one pass).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.ops import flash_attention as jfa

from sd3_torch.ops import flash_attention as tfl

ATOL, RTOL = 2e-5, 2e-4

# (B, H, N, D): ragged lengths, odd head counts, the two head dims the
# kernels take, and one length above 2048 keys (JAX's multi-block path) at a
# tiny width
SHAPES = [(2, 3, 47, 32), (1, 5, 300, 64), (1, 1, 2100, 8)]
# lengths on either side of the backward kernels' 128-row blocks and 64-row
# query tiles (csrc/flash_bwd_sm90.cu), at both head dims; and at head dim
# 256 (K6A_256, K6B_256: 32-key tiles, 64-row items) and 160 (padded to
# 256 on the card), on either side of 64 and 128, with one key length of
# its own, (B, H, N, M, D); at 384 and 320 (padded to 384: K6A_384,
# K6B_384, 32-key / 32-query tiles, 64-row items) and 512 (K6A_512,
# K6B_512, 16-key / 16-query tiles) on either side of 64 and of their tiles,
# with one key length of its own
TILE_EDGE_SHAPES = ([(1, 2, n, d) for n in (127, 129, 257) for d in (32, 64)]
                    + [(1, 2, n, d) for n in (63, 65, 127, 129)
                       for d in (160, 256)] + [(1, 2, 65, 127, 256)]
                    + [(1, 2, n, d) for n in (31, 33, 63, 65)
                       for d in (320, 384)]
                    + [(1, 2, n, 512) for n in (15, 17, 63, 65)]
                    + [(1, 2, 65, 17, 512)])
# (B, H, N, M, D): a key length of its own. kv_merge_attn's M = N / 2 (the
# 256px training shape's 410 -> 205 at a narrow width, and a ragged one),
# a ragged M against a whole N, M > N, and M past 2048 keys (JAX's
# multi-block path) at a tiny width
KV_SHAPES = [(2, 3, 48, 24, 32), (1, 2, 410, 205, 64), (1, 3, 256, 77, 16),
             (1, 2, 40, 129, 32), (1, 1, 100, 2100, 8)]


def _case(shape, seed=0):
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal(shape).astype(np.float32)
                   for _ in range(4))
    return q, k, v, do, shape[-1] ** -0.5


def _kv_case(shape, seed=0):
    """q, dO (B, H, N, D) and k, v (B, H, M, D) of a KV_SHAPES entry."""
    b, h, n, m, d = shape
    r = np.random.default_rng(seed)
    q, k, v, do = (r.standard_normal((b, h, rows, d)).astype(np.float32)
                   for rows in (n, m, m, n))
    return q, k, v, do, d ** -0.5


def _t(a, grad=False):
    return torch.from_numpy(np.array(a, np.float32)).requires_grad_(grad)


def _jax_lse(q, k, v, scale):
    """The fp32 logsumexp JAX's forward kernel saves, through the padding
    and block choice of `flash_attention` (at these sizes its VMEM budget
    shrinks nothing, which the assert checks)."""
    b, h, n, d = q.shape
    m = k.shape[2]
    n_pad = jfa._round_up(n, 128)
    bq = max(c for c in range(128, min(jfa.DEFAULT_BLOCK_Q, n_pad) + 1, 128)
             if n_pad % c == 0)
    m128 = jfa._round_up(m, 128)
    bk = m128 if m128 <= 2048 else jfa.DEFAULT_BLOCK_K
    d_pad = jfa._round_up(d, 128)
    assert jfa._dkv_vmem(bq, bk, n_pad, d_pad, 4) <= jfa._VMEM_BUDGET
    m_pad = jfa._round_up(m, bk)

    def pad(x, rows):
        x = jnp.asarray(x)
        return jnp.pad(x.reshape(b * h, x.shape[2], d),
                       ((0, 0), (0, rows - x.shape[2]), (0, d_pad - d)))

    _, lse = jfa._fwd(pad(q, n_pad), pad(k, m_pad), pad(v, m_pad), scale, bq,
                      bk, m)
    return np.asarray(lse)[:, :n, 0].reshape(b, h, n)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("shape", SHAPES)
def test_plain_forward_and_lse_match_jax(shape):
    q, k, v, _, scale = _case(shape)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scale)
    out, lse = tfl.flash_fwd_plain(_t(q), _t(k), _t(v), scale)
    _close(out, want)
    _close(lse, _jax_lse(q, k, v, scale))


@pytest.mark.parametrize("shape", SHAPES + TILE_EDGE_SHAPES)
def test_plain_backward_matches_jax_vjp(shape):
    q, k, v, do, scale = (_kv_case if len(shape) == 5 else _case)(shape,
                                                                  seed=1)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
                       *map(jnp.asarray, (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q), _t(k), _t(v)
    _, lse = tfl.flash_fwd_plain(tq, tk, tv, scale)
    got_dq, delta = tfl.flash_dq_plain(tq, tk, tv, _t(out), _t(do), lse, scale)
    got_dk, got_dv = tfl.flash_dkv_plain(tq, tk, tv, _t(do), lse, delta, scale)
    _close(delta, np.sum(np.asarray(out) * do, -1))
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        _close(got, want)


@pytest.mark.parametrize("shape", SHAPES[:2])
def test_autograd_function_matches_jax_and_saves_its_residuals(shape,
                                                               monkeypatch):
    q, k, v, do, scale = _case(shape, seed=2)
    want, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
                        *map(jnp.asarray, (q, k, v)))
    calls = dict.fromkeys(("flash_fwd_plain", "flash_dq_plain",
                           "flash_dkv_plain"), 0)
    for name in calls:
        fn = getattr(tfl, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tfl, name, counted)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfl.flash_attention(tq, tk, tv, scale)
    _close(out, want)
    out.backward(_t(do))
    # the backward reads the saved out and lse: no forward is recomputed
    assert calls == dict(flash_fwd_plain=1, flash_dq_plain=1,
                         flash_dkv_plain=1)
    for got, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        _close(got, w)


def test_plain_rounds_p_and_ds_to_the_input_dtype():
    # bf16 inputs: p is rounded before P.V and p^T dO, ds before its
    # products, results come back in bf16; the fp32 statistics stay fp32
    q, k, v, do, scale = _case((1, 2, 40, 32), seed=3)
    qb, kb, vb, dob = (_t(a).to(torch.bfloat16) for a in (q, k, v, do))
    out, lse = tfl.flash_fwd_plain(qb, kb, vb, scale)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    s = (qb.float() @ kb.float().transpose(-1, -2)) * scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    want = ((e.to(torch.bfloat16).float() @ vb.float())
            / e.sum(-1, keepdim=True)).to(torch.bfloat16)
    assert torch.equal(out, want)
    p = torch.exp(s - lse[..., None])
    dq, delta = tfl.flash_dq_plain(qb, kb, vb, out, dob, lse, scale)
    dk, dv = tfl.flash_dkv_plain(qb, kb, vb, dob, lse, delta, scale)
    assert {t.dtype for t in (dq, dk, dv)} == {torch.bfloat16}
    assert torch.equal(dv, (p.to(torch.bfloat16).float().transpose(-1, -2)
                            @ dob.float()).to(torch.bfloat16))


def test_wrapper_refuses_other_devices_and_shapes():
    # what JAX's wrapper asserts (sd3_tpu/ops/flash_attention.py:378-380):
    # k and v of q's batch, heads and head dim and of one key length; a key
    # length of its own is taken (test_plain_*_at_a_key_length_of_their_own)
    q = torch.zeros(1, 2, 8, 32)
    for k, v in ((q[..., :16], q[..., :16]),          # another head dim
                 (q[..., :16], q),                    # v's head dim
                 (torch.zeros(2, 2, 8, 32),) * 2,     # another batch
                 (q[:, :1], q[:, :1]),                # other heads
                 (q, q[:, :, :4])):                   # k and v lengths
        with pytest.raises(ValueError, match="B, H, M, D"):
            tfl.flash_attention(q, k, v, 0.2)
        with pytest.raises(ValueError, match="B, H, M, D"):
            tfl.check_shapes(q, k, v)
    assert tfl.flash_attention(q, q[:, :, :4], q[:, :, :4], 0.2).shape == \
        q.shape
    m = q.to("meta")
    with pytest.raises(ValueError, match="device"):
        tfl.flash_attention(m, m, m, 0.2)


def test_wrapper_reads_the_general_paths_tensors_in_place(monkeypatch):
    # the general attention path (the trainers': use_fused=False) hands q, k,
    # v to flash_attention as cat((image, text)) results, and the Function's
    # backward gets its saved output and autograd's dO; the kernels'
    # in-place rule (head dim contiguous, start and strides multiples of 16
    # bytes, which TMA needs) takes every one of them, so training copies
    # nothing. A view with a misaligned row stride or start is copied.
    from sd3_torch.ops import attention as tat

    seen = []

    def flash_dq(q, k, v, out, dout, lse, scale):
        seen.extend((q, k, v, out, dout))
        return tfl.flash_dq_plain(q, k, v, out, dout, lse, scale)
    monkeypatch.setattr(tfl, "flash_dq", flash_dq)
    ja = tat.JointAttention(64, 2, attn_type="softmax_flash", use_fused=False)
    r = np.random.default_rng(4)
    x, c = _t(r.standard_normal((2, 16, 64)), True), _t(
        r.standard_normal((2, 5, 64)))
    ox, oc = ja(x, c, (4, 4))
    (ox.sum() + oc.sum()).backward()
    assert len(seen) == 5
    for t in seen:
        assert t.shape == (2, 2, 21, 32)
        assert tfl._readable(t) is t
    bf16 = torch.bfloat16
    rows = torch.zeros(1, 2, 8, 36, dtype=bf16)[..., :32]   # 72-byte rows
    start = torch.zeros(1, 2, 8, 40, dtype=bf16)[..., 4:36]  # 8 bytes in
    for view in (rows, start):
        copy = tfl._readable(view)
        assert copy is not view and copy.is_contiguous()
        assert torch.equal(copy, view)


@pytest.mark.parametrize("shape", [(2, 3, 47, 8), (1, 2, 65, 16),
                                   (2, 3, 47, 48), (1, 2, 129, 128),
                                   (2, 3, 47, 160), (1, 2, 130, 256),
                                   (1, 2, 40, 384), (1, 2, 33, 512)])
def test_wrappers_pad_head_dims_to_the_instances(shape, monkeypatch):
    # the kernels' instances take head dims 16, 32, 64, 128 and every
    # multiple of 128 past it; the wrappers zero-pad any other up to the
    # next (8 -> 16, 48 -> 64, 160 -> 256, where JAX pads to 256 lanes
    # too), run with the
    # caller's scale and slice out, dq, dk, dv back, on the CPU as on the
    # card: forward and gradients of the autograd Function against JAX's
    # flash_attention (which pads D to 128 lanes)
    q, k, v, do, scale = _case(shape, seed=6)
    want, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
                        *map(jnp.asarray, (q, k, v)))
    dims = []
    fwd = tfl.flash_fwd_plain

    def spy(q, k, v, scale):
        dims.append(q.shape[-1])
        return fwd(q, k, v, scale)
    monkeypatch.setattr(tfl, "flash_fwd_plain", spy)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    out = tfl.flash_attention(tq, tk, tv, scale)
    assert out.shape == shape
    assert dims == [tfl.instance_dim(shape[-1])]
    _close(out, want)
    out.backward(_t(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), vjp(jnp.asarray(do))):
        assert got.shape == shape
        _close(got, w)


@pytest.mark.parametrize("shape", KV_SHAPES)
def test_plain_forward_and_lse_at_a_key_length_of_their_own(shape):
    # q (B, H, N, D) against k, v (B, H, M, D): JAX's flash_attention takes
    # M != N (kv_merge_attn halves M), and so do the plain versions
    q, k, v, _, scale = _kv_case(shape)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scale)
    out, lse = tfl.flash_fwd_plain(_t(q), _t(k), _t(v), scale)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    _close(out, want)
    _close(lse, _jax_lse(q, k, v, scale))


@pytest.mark.parametrize("shape", [(1, 2, 150, 75, 384),
                                   (1, 2, 40, 129, 384)])
def test_plain_forward_at_head_dim_384_and_a_key_length_of_its_own(shape):
    # the plain version the card's K5_384 is held to: JAX's flash_attention
    # at head dim 384 (three 128-lane blocks), k and v of M = N / 2 and of M
    # > N keys
    q, k, v, _, scale = _kv_case(shape, seed=384)
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scale)
    out, lse = tfl.flash_fwd_plain(_t(q), _t(k), _t(v), scale)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    _close(out, want)
    _close(lse, _jax_lse(q, k, v, scale))


@pytest.mark.parametrize("shape", [(1, 2, 70, 35, 640),
                                   (1, 1, 40, 90, 640)])
def test_plain_forward_at_head_dim_640_and_a_key_length_of_its_own(shape):
    # the plain version the card's K5_768 is held to (bf16 heads of 640 run
    # padded at 768): JAX's flash_attention at head dim 640 (five 128-lane
    # blocks), k and v of M = N / 2 and of M > N keys; ATOL / RTOL
    q, k, v, _, scale = _kv_case(shape, seed=640)
    assert tfl.flash_kernel("fwd", torch.bfloat16, 640) is tfl.K5_768
    want = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), scale)
    out, lse = tfl.flash_fwd_plain(_t(q), _t(k), _t(v), scale)
    assert out.shape == q.shape and lse.shape == q.shape[:3]
    _close(out, want)
    _close(lse, _jax_lse(q, k, v, scale))


@pytest.mark.parametrize("shape", KV_SHAPES)
def test_plain_backward_at_a_key_length_of_their_own(shape):
    # dq (B, H, N, D) and delta (B, H, N) by query row, dk, dv (B, H, M, D)
    # by key row, against JAX's custom VJP; and the autograd Function
    q, k, v, do, scale = _kv_case(shape, seed=1)
    out, vjp = jax.vjp(lambda a, b, c: jfa.flash_attention(a, b, c, scale),
                       *map(jnp.asarray, (q, k, v)))
    dq, dk, dv = vjp(jnp.asarray(do))
    tq, tk, tv = _t(q), _t(k), _t(v)
    _, lse = tfl.flash_fwd_plain(tq, tk, tv, scale)
    got_dq, delta = tfl.flash_dq_plain(tq, tk, tv, _t(out), _t(do), lse, scale)
    got_dk, got_dv = tfl.flash_dkv_plain(tq, tk, tv, _t(do), lse, delta, scale)
    assert got_dk.shape == got_dv.shape == k.shape
    _close(delta, np.sum(np.asarray(out) * do, -1))
    for got, want in ((got_dq, dq), (got_dk, dk), (got_dv, dv)):
        _close(got, want)
    tq, tk, tv = _t(q, True), _t(k, True), _t(v, True)
    got = tfl.flash_attention(tq, tk, tv, scale)
    _close(got, out)
    got.backward(_t(do))
    for got, want in ((tq.grad, dq), (tk.grad, dk), (tv.grad, dv)):
        _close(got, want)
