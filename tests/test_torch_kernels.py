"""Kernels K1-K4 and the port's dispatch rules, with no JAX import, so the
file also runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest.py imports JAX). On the CPU the
`cuda`-marked tests skip; the rest check tables, dispatch and refusals.
K1 against its plain version: tolerance atol 1e-2, chip_smoke.py's
ATTN_ATOL (bf16 q^, k^, p and output against fp32); K4, K2 and K3:
chip_smoke.py's K4_ATOL and MLP limits (reasons there).
"""

import numpy as np
import pytest
import torch

import sd3_torch
from sd3_torch import kernels
from sd3_torch.config import tiny_config
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.models.text_encoders import StubTextEncoders
from sd3_torch.ops import fused_attention as tfa
from sd3_torch.ops import fused_mlp as tfm
from sd3_torch.ops.quant import quantize_weight
from sd3_torch.ops.rope import rope2d_axial_angles


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               atol=2e-5, rtol=2e-4)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    return torch.device("cuda")


def _attn_case(nh, d, h, w, n_txt, rope2d, seed=0):
    """The inputs of test_torch_ops.py::_attn_case (numpy seed)."""
    n_img = h * w
    n = n_img + n_txt
    r = np.random.default_rng(seed)
    f = nh * d
    q, k, v = (r.standard_normal((2, n, f)).astype(np.float32)
               for _ in range(3))
    ws = [(1 + 0.1 * r.standard_normal(d)).astype(np.float32) for _ in range(4)]
    angles = rope2d_axial_angles(h, w, d).reshape(n_img, d) if rope2d else None
    return q, k, v, ws, angles, n_img, d ** -0.5


ATTN_SHAPES = [
    (3, 16, 3, 4, 5, True),       # odd heads
    (2, 64, 4, 4, 6, True),       # published head_dim
    (2, 16, 2, 4, 4, False),      # NoPE: fused norm only
    (5, 32, 5, 7, 12, True),      # ragged: 47 tokens, odd heads
    (2, 128, 4, 4, 6, True),      # head_dim 128: > 48 KB shared memory
    (19, 64, 32, 32, 154, True),  # the 512px slice shape
]


def test_row_tables_fold_norm_weights():
    d, n, n_img = 8, 7, 4
    angles = np.random.default_rng(6).uniform(0, 3, (n_img, d)).astype(np.float32)
    cos, sin = tfa.rope_row_tables(angles, n, d)
    np.testing.assert_array_equal(cos[n_img:], 1.0)
    np.testing.assert_array_equal(sin[n_img:], 0.0)
    wi, wt = _t(np.arange(1, d + 1)), _t(-np.arange(1, d + 1))
    cq, sq = tfa.fold_row_tables(_t(cos), _t(sin), wi, wt, n_img)
    _close(cq[:n_img], cos[:n_img] * np.arange(1, d + 1))
    _close(cq[n_img:], np.broadcast_to(-np.arange(1, d + 1.0), (n - n_img, d)))
    _close(sq[:n_img], sin[:n_img] * tfa._swap_pairs(wi).numpy())
    assert tfa._swap_pairs(wi)[:4].tolist() == [2.0, 1.0, 4.0, 3.0]


def test_fused_attention_rejects_unported_variants():
    q = torch.zeros(1, 8, 32)
    tab = torch.zeros(8, 16)
    with pytest.raises(NotImplementedError, match="K8"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25, int8_pv=True)
    big = torch.zeros(1, 2049, 32)
    btab = torch.zeros(2049, 16)
    with pytest.raises(NotImplementedError, match="K7"):
        tfa.fused_attention(big, big, big, 2, btab, btab, btab, btab, 0.25)
    with pytest.raises(ValueError, match="device"):
        m = q.to("meta")
        tfa.fused_attention(m, m, m, 2, tab.to("meta"), tab.to("meta"),
                            tab.to("meta"), tab.to("meta"), 0.25)


def test_entry_points_raise_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        sd3_torch.resolve_device("cuda")
    assert sd3_torch.resolve_device("cpu").type == "cpu"
    # the model and the stub encoders default to the card
    with pytest.raises(RuntimeError, match="CUDA"):
        MMDiT(tiny_config(attn_type="softmax_flash"))
    with pytest.raises(RuntimeError, match="CUDA"):
        StubTextEncoders()


def test_kernel_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(kernels.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        kernels.find_nvcc()
    assert tfa.K1 in kernels.REGISTRY
    assert (kernels.CSRC_DIR / tfa.K1.source).is_file()


def test_every_kernel_symbol_is_in_its_source():
    # no nvcc here: at least the C entry point each wrapper binds exists
    for k in (tfa.K1, tfa.K4, tfm.K2, tfm.K3):
        assert k in kernels.REGISTRY
        src = (kernels.CSRC_DIR / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src, k.name


@pytest.mark.cuda
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", ATTN_SHAPES)
def test_k1_kernel_matches_plain_on_the_card(cuda_device, nh, d, h, w, n_txt,
                                             rope2d):
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d)
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    wt = [_t(a).to(dev) for a in ws]
    before = tfa.K1.launches
    got = tfa.fused_dual_flash_attention(qb, kb, vb, nh, *wt, angles, n_img,
                                         scale)
    torch.cuda.synchronize()
    assert tfa.K1.launches == before + 1
    cos, sin = (torch.as_tensor(t)
                for t in tfa.rope_row_tables(angles, q.shape[1], d))
    cq, sq = tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img)
    eps = float(torch.finfo(torch.bfloat16).eps)
    want = tfa.composition(qb.float().cpu(), kb.float().cpu(), vb.float().cpu(),
                           cq, sq, ck, sk, scale, eps, eps, nh)
    # bf16 operands (q^, k^, p) and a bf16 output against fp32: the same
    # bound as chip_smoke.py's K1_ATOL
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", ATTN_SHAPES)
def test_k4_kernel_matches_plain_on_the_card(cuda_device, nh, d, h, w, n_txt,
                                             rope2d):
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d)
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    wt = [_t(a).to(dev) for a in ws]
    before = (tfa.K1.launches, tfa.K4.launches)
    got = tfa.fused_dual_flash_attention(qb, kb, vb, nh, *wt, angles, n_img,
                                         scale, int8_qk=True)
    torch.cuda.synchronize()
    assert (tfa.K1.launches, tfa.K4.launches) == (before[0], before[1] + 1)
    cos, sin = (torch.as_tensor(t)
                for t in tfa.rope_row_tables(angles, q.shape[1], d))
    cq, sq = tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img)
    eps = float(torch.finfo(torch.bfloat16).eps)
    want = tfa.composition_int8_qk(qb.float().cpu(), kb.float().cpu(),
                                   vb.float().cpu(), cq, sq, ck, sk, scale,
                                   eps, eps, nh)
    # chip_smoke.py's K4_ATOL: K1's roundings, and int8 levels of k^ that
    # its bf16 rounding moves
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=3e-2, rtol=0)


# (rows, tokens per sample, k, hidden, d_out, h_group, K2?)
MLP_SHAPES = [
    (37, 37, 64, 128, 64, 128, False),          # K3, fewer rows than a tile
    (300, 300, 96, 512, 96, 512, False),        # K3, 512-wide h groups
    (1232, 1232, 1216, 4864, 1216, 256, False),  # K3 at the text stream
    (300, 100, 64, 384, 64, 128, True),         # K2, tiles straddle samples
    (2048, 1024, 1216, 4864, 1216, 256, True),  # K2 at the image stream
]


def mlp_case(m, n_tok, k, hidden, d_out, dev, seed=0):
    """Seeded bf16 rows, int8 weights with fp32 scales and biases, and
    per-sample shift / scale / gate on `dev`."""
    r = np.random.default_rng(seed)
    f = lambda *s, sd=1.0: torch.from_numpy(
        (r.standard_normal(s) * sd).astype(np.float32))
    w12_q, s12 = quantize_weight(f(2 * hidden, k, sd=k ** -0.5))
    w3_q, s3 = quantize_weight(f(d_out, hidden, sd=hidden ** -0.5))
    b = m // n_tok
    t = dict(x=f(m, k).to(torch.bfloat16), w12_q=w12_q, w12_scale=s12,
             b12=f(2 * hidden, sd=0.1), w3_q=w3_q, w3_scale=s3,
             b3=f(d_out, sd=0.1), shift=f(b, k, sd=0.3), scale=f(b, k, sd=0.3),
             gate=f(b, d_out, sd=0.5))
    return {key: v.to(dev) for key, v in t.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_tok,k,hidden,d_out,h_group,tail", MLP_SHAPES)
def test_k2_k3_kernels_match_plain_on_the_card(cuda_device, m, n_tok, k,
                                               hidden, d_out, h_group, tail):
    t = mlp_case(m, n_tok, k, hidden, d_out, cuda_device)
    w = [t[n] for n in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale", "b3")]
    before = (tfm.K2.launches, tfm.K3.launches)
    if tail:
        got = tfm.swiglu_int8_tail(t["x"], t["shift"], t["scale"], t["gate"],
                                   *w, n_tok=n_tok, h_group=h_group)
    else:
        got = tfm.swiglu_int8(t["x"], *w, h_group=h_group)
    torch.cuda.synchronize()
    assert (tfm.K2.launches, tfm.K3.launches) == (before[0] + tail,
                                                  before[1] + (not tail))
    cpu = {key: v.cpu() for key, v in t.items()}
    want = tfm.swiglu_int8_plain(
        cpu["x"].float(), *[cpu[n] for n in ("w12_q", "w12_scale", "b12",
                                             "w3_q", "w3_scale", "b3")],
        h_group=h_group, shift=cpu["shift"], scale=cpu["scale"],
        gate=cpu["gate"], n_tok=n_tok, adaln=tail, residual=tail)
    err = (got.float().cpu() - want).abs().max().item()
    rel = ((got.float().cpu() - want).norm() / want.norm()).item()
    assert err <= 1e-2 * want.abs().max().item() and rel <= 5e-3, (err, rel)


@pytest.mark.cuda
def test_k2_k3_refuse_what_they_do_not_take(cuda_device):
    t = mlp_case(32, 32, 64, 128, 64, cuda_device)
    w = [t[n] for n in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale", "b3")]
    with pytest.raises(TypeError, match="bfloat16"):
        tfm.swiglu_int8(t["x"].float(), *w, h_group=128)
    with pytest.raises(NotImplementedError, match="h_group"):
        tfm.swiglu_int8(t["x"], *w, h_group=64)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 32, device=cuda_device)
    tab = torch.zeros(8, 16, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25)
    qb = torch.zeros(1, 8, 48, device=cuda_device, dtype=torch.bfloat16)
    tab = torch.zeros(8, 24, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head dims"):
        tfa.fused_attention(qb, qb, qb, 2, tab, tab, tab, tab, 0.25)
