"""Kernel K1 and the port's dispatch rules, with no JAX import, so the file
also runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest.py imports JAX). On the CPU the
`cuda`-marked tests skip; the rest check tables, dispatch and refusals.
K1 against its plain version: tolerance atol 1e-2, the bound of
chip_smoke.py's K1_ATOL (bf16 q^, k^, p and output against fp32).
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
    with pytest.raises(NotImplementedError, match="K4"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25, int8_qk=True)
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
def test_k1_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 8, 32, device=cuda_device)
    tab = torch.zeros(8, 16, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25)
    qb = torch.zeros(1, 8, 48, device=cuda_device, dtype=torch.bfloat16)
    tab = torch.zeros(8, 24, device=cuda_device)
    with pytest.raises(NotImplementedError, match="head dims"):
        tfa.fused_attention(qb, qb, qb, 2, tab, tab, tab, tab, 0.25)
