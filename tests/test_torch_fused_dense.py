"""The int8 attention-tail kernels' plain versions (K10a, K10b) and their
dispatch held to sd3_tpu/ops/fused_dense.py, whose Pallas kernels run here
in interpret mode, on the CPU, in fp32.

Both sides get the same int8 weights (quantized once by JAX; the port's are
the (out, in) transposes) and the same inputs from a numpy seed, with
strongly distinct per-sample shift / gate, so a row given another sample's
conditioning is a large error. The s32 products are exact on both sides;
only the LayerNorm statistics (K10a) are summed in another order, and a
last-bit difference there moves the odd element across an int8 rounding
boundary: one level of a row scale (max|xn| / 127, ~0.05 here) times a
weight (~0.2) is ~1e-2 at most, and rare. Hence atol 2e-3 with the rel-L2
error under 1e-4 for K10a; K10b repeats JAX's arithmetic on the same values
and is held to 1e-5. The attention's PyTorch fallbacks for a declined shape
are held to JAX's in bf16, where their roundings matter.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sd3_tpu.ops import fused_dense as jfd
from sd3_tpu.ops.quant import quantize_weight

from sd3_torch.ops import fused_dense as tfd

D = 64


def _weights(r, n, k=D, d_out=D):
    """n (JAX (k, d_out) int8, scales) pairs and the port's (d_out, k)."""
    jw, tw = [], []
    for _ in range(n):
        wq, ws = quantize_weight(jnp.asarray(
            r.standard_normal((k, d_out)).astype(np.float32) * 0.08))
        jw += [wq, ws]
        tw += [torch.from_numpy(np.asarray(wq).T.copy()),
               torch.from_numpy(np.array(ws))]
    return jw, tw


def _close(got, want, atol, rel_l2):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= rel_l2, rel


@pytest.mark.parametrize("b,n", [(2, 128), (1, 1024), (3, 256)])
def test_k10a_plain_matches_jax(b, n):
    # the shapes of tests/test_quant.py::test_fused_qkv_adaln_kernel
    r = np.random.default_rng(17 + b)
    x = r.standard_normal((b, n, D)).astype(np.float32)
    sh = (np.arange(b)[:, None] * 2.0
          + r.standard_normal((b, D)) * 0.1).astype(np.float32)
    sc = (r.standard_normal((b, D)) * 0.1).astype(np.float32)
    jw, tw = _weights(r, 3)
    want = jfd.fused_qkv_adaln_int8(jnp.asarray(x), jnp.asarray(sh),
                                    jnp.asarray(sc), *jw)
    got = tfd.fused_qkv_adaln_int8(torch.from_numpy(x), torch.from_numpy(sh),
                                   torch.from_numpy(sc), *tw)
    assert want is not None and got is not None
    for g, w in zip(got, want):
        _close(g, w, 2e-3, 1e-4)


@pytest.mark.parametrize("gated,residual", [(True, True), (False, True),
                                            (True, False), (False, False)])
@pytest.mark.parametrize("b,n", [(2, 128), (1, 1024)])
def test_k10b_plain_matches_jax(b, n, gated, residual):
    # the shapes of tests/test_quant.py::test_fused_out_gate_residual_kernel,
    # with the gate and the residual each left out
    r = np.random.default_rng(19 + b)
    a = r.standard_normal((b, n, D)).astype(np.float32)
    res = r.standard_normal((b, n, D)).astype(np.float32)
    g = ((np.arange(b)[:, None] - 1.0)
         + r.standard_normal((b, D)) * 0.5).astype(np.float32)
    jw, tw = _weights(r, 1)
    pick = lambda t, on, conv: conv(t) if on else None
    want = jfd.fused_out_gate_residual_int8(
        jnp.asarray(a), pick(g, gated, jnp.asarray),
        pick(res, residual, jnp.asarray), *jw)
    got = tfd.fused_out_gate_residual_int8(
        torch.from_numpy(a), pick(g, gated, torch.from_numpy),
        pick(res, residual, torch.from_numpy), *tw)
    _close(got, want, 1e-5, 1e-5)


def test_k10b_reads_a_slice_of_the_joint_sequence():
    # the attention output's image half out[:, :n] is a strided view: the
    # same result as from its contiguous copy
    r = np.random.default_rng(23)
    out = torch.from_numpy(r.standard_normal((2, 128 + 14, D))
                           .astype(np.float32))
    _, (w, s) = _weights(r, 1)
    gate = torch.from_numpy(r.standard_normal((2, D)).astype(np.float32))
    res = torch.from_numpy(r.standard_normal((2, 128, D)).astype(np.float32))
    a = out[:, :128]
    assert not a.is_contiguous()
    torch.testing.assert_close(
        tfd.fused_out_gate_residual_int8(a, gate, res, w, s),
        tfd.fused_out_gate_residual_int8(a.contiguous(), gate, res, w, s),
        rtol=0, atol=0)


# (B, N, k, d_out): the published 512px and 1024px image and text streams
# (CFG batch 8), the model tests' streams, the JAX kernel tests' shapes and
# an unaligned one
BM_SHAPES = [(8, 1024, 1216, 1216), (8, 154, 1216, 1216),
             (8, 4096, 1216, 1216), (4, 4096, 1216, 1216),
             (2, 64, 64, 64), (2, 14, 64, 64), (2, 128, 64, 64),
             (1, 1024, 64, 64), (3, 256, 64, 64), (3, 100, 64, 64),
             (1, 1024, 4096, 4096)]


def _spy_pick_bm(monkeypatch, mod):
    """Record pick_bm's arguments and answers; make the dispatch decline,
    so that no kernel runs."""
    calls = []
    real = mod.pick_bm

    def spy(*args):
        calls.append((args, real(*args)))
        return None
    monkeypatch.setattr(mod, "pick_bm", spy)
    return calls


@pytest.mark.parametrize("b,n,k,d_out", BM_SHAPES)
def test_pick_bm_and_its_estimates_match_jax(monkeypatch, b, n, k, d_out):
    # both dispatches read only shapes before pick_bm
    shaped = lambda *s: SimpleNamespace(shape=s)
    jcalls = _spy_pick_bm(monkeypatch, jfd)
    tcalls = _spy_pick_bm(monkeypatch, tfd)
    x, jw, tw = shaped(b, n, k), shaped(k, d_out), shaped(d_out, k)
    assert jfd.fused_qkv_adaln_int8(x, None, None, *[jw, None] * 3) is None
    assert tfd.fused_qkv_adaln_int8(x, None, None, *[tw, None] * 3) is None
    assert jfd.fused_out_gate_residual_int8(x, None, None, jw, None) is None
    assert tfd.fused_out_gate_residual_int8(x, None, None, tw, None) is None
    assert len(jcalls) == 2 and tcalls == jcalls
    if (b, n) == (8, 1024):     # 512px image stream
        assert [bm for _, bm in tcalls] == [256, 512]
    if n == 154:                # the text stream: both fall back
        assert [bm for _, bm in tcalls] == [None, None]


def test_wrappers_take_the_plain_version_on_the_cpu_and_refuse_grad():
    r = np.random.default_rng(29)
    x = torch.from_numpy(r.standard_normal((2, 128, D)).astype(np.float32))
    cond = torch.from_numpy(r.standard_normal((2, D)).astype(np.float32))
    _, tw = _weights(r, 3)
    before = (tfd.K10A.launches, tfd.K10B.launches)
    q, k, v = tfd.fused_qkv_adaln_int8(x, cond, cond, *tw)
    o = tfd.fused_out_gate_residual_int8(x, cond, x, *tw[:2])
    assert q.shape == k.shape == v.shape == o.shape == x.shape
    assert (tfd.K10A.launches, tfd.K10B.launches) == before
    xg = x.clone().requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfd.fused_qkv_adaln_int8(xg, cond, cond, *tw)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfd.fused_out_gate_residual_int8(xg, None, None, *tw[:2])
    with torch.no_grad():
        assert tfd.fused_out_gate_residual_int8(xg, None, None,
                                                *tw[:2]).shape == x.shape
    meta = x.to("meta")
    with pytest.raises(ValueError, match="device"):
        tfd.fused_qkv_adaln_int8(meta, cond.to("meta"), cond.to("meta"),
                                 *[t.to("meta") for t in tw])
    with pytest.raises(ValueError, match="device"):
        tfd.fused_out_gate_residual_int8(meta, None, None,
                                         *[t.to("meta") for t in tw[:2]])


def test_tail_fallbacks_round_as_jax_in_bf16():
    # where K10a / K10b decline, the attention's `_adaln` and `_gate_res`
    # keep the JAX fallback's roundings (sd3_tpu/ops/attention.py:40-56):
    # the LayerNorm output, the modulated input and the gate product each
    # rounded to bf16. Elementwise in fp32 with the same roundings, so
    # `_gate_res` is bit-equal; `_adaln`'s LayerNorm statistics are summed
    # in another order, which may move the odd element by one bf16 ulp
    from sd3_tpu.ops import attention as jattn
    from sd3_torch.ops import attention as tattn
    r = np.random.default_rng(37)
    f = lambda *s: r.standard_normal(s).astype(np.float32)
    x, o, res = f(2, 24, D), f(2, 24, D), f(2, 24, D)
    sh, sc, g = f(2, D) * 0.5, f(2, D) * 0.3, f(2, D)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    as32 = lambda a: np.asarray(jnp.asarray(a, jnp.float32))
    want = as32(jattn._adaln(jb(x), jb(sh), jb(sc)))
    got = tattn._adaln(tb(x), tb(sh), tb(sc)).float().numpy()
    np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    assert np.mean(got == want) > 0.99
    for gate, r_ in ((g, res), (None, res), (g, None)):
        want = as32(jattn._gate_res(
            jb(o), None if gate is None else jb(gate),
            None if r_ is None else jb(r_)))
        got = tattn._gate_res(
            tb(o), None if gate is None else tb(gate),
            None if r_ is None else tb(r_)).float().numpy()
        np.testing.assert_array_equal(got, want)
