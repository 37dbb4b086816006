"""Kernels K1-K10b and the port's dispatch rules, with no JAX import, so the
file also runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest.py imports JAX). On the CPU the
`cuda`-marked tests skip; the rest check tables, dispatch and refusals.
K1 against its plain version: tolerance atol 1e-2, chip_smoke.py's
ATTN_ATOL (bf16 q^, k^, p and output against fp32); K4, K2 and K3:
chip_smoke.py's K4_ATOL and MLP limits (reasons there); K5, K6a and K6b:
chip_smoke.py's FLASH_* limits (reasons there); K7, K7q, K8a and K8b:
chip_smoke.py's ATTN_ATOL and K8_ATOL (reasons there); K9, K10a and K10b:
chip_smoke.py's MLP and K10 limits (reasons there).
"""

import re

import numpy as np
import pytest
import torch

import sd3_torch
from sd3_torch import kernels
from sd3_torch.config import tiny_config
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.models.text_encoders import StubTextEncoders
from sd3_torch.ops import flash_attention as tfl
from sd3_torch.ops import fused_attention as tfa
from sd3_torch.ops import fused_dense as tfd
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
    # every variant (K1, K4, K8a single-KV; K7, K7q, K8b streaming) runs on
    # the CPU through its plain version and on CUDA through its kernel; a
    # device with neither has no path and raises
    m = torch.zeros(1, 8, 32, device="meta")
    tab = torch.zeros(8, 16, device="meta")
    for int8_qk in (False, True):
        for int8_pv in (False, True):
            for single_kv_max in (2048, 0):  # 0: the streaming kernels
                with pytest.raises(ValueError, match="device"):
                    tfa.fused_attention(m, m, m, 2, tab, tab, tab, tab, 0.25,
                                        int8_qk=int8_qk, int8_pv=int8_pv,
                                        single_kv_max=single_kv_max)


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
    for k in (tfa.K1, tfa.K4, tfa.K7, tfa.K7Q, tfa.K8A, tfa.K8B, tfm.K2,
              tfm.K3, tfl.K5, tfl.K6A, tfl.K6B, tfm.K9, tfd.K10A, tfd.K10B):
        assert k in kernels.REGISTRY
        src = (kernels.CSRC_DIR / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src, k.name


def test_flash_backward_is_the_wgmma_source():
    # K6a and K6b are the wgmma + TMA kernels of flash_bwd_sm90.cu; the
    # mma.sync dq / dk-dv kernels are gone, and K5 keeps its source
    assert tfl.K6A.source == tfl.K6B.source == "flash_bwd_sm90.cu"
    assert tfl.K5.source == "flash_attention.cu"
    bwd = (kernels.CSRC_DIR / tfl.K6A.source).read_text()
    fwd = (kernels.CSRC_DIR / tfl.K5.source).read_text()
    assert "wgmma_rs" in bwd and "tma_load_4d" in bwd
    assert "mma_bf16(" not in bwd and "mma.sync" not in bwd
    for gone in ("dq_kernel", "dkv_kernel", "sd3_flash_attention_dq",
                 "sd3_flash_attention_dkv"):
        assert gone not in fwd, gone


@pytest.mark.parametrize("const,source,name", [
    ("K7_KEY_TILE", "attention_sm90.cu", "KEY_TILE"),
    ("INT8_KEY_TILE", "attention_common.cuh", "BK")])
def test_key_tiles_match_their_sources(const, source, name):
    # the plain versions' block_k that the card comparisons take is the
    # kernel's own key tile: K1 / K7's, and that of the mma.sync kernels
    # (K4, K7q, K8a, K8b; K8's int8 V^T is padded to it)
    src = (kernels.CSRC_DIR / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None, (source, name)
    assert getattr(tfa, const) == int(m.group(1))
    assert tfa.K1.source == tfa.K7.source == "attention_sm90.cu"


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


# the streaming (K7, K7q, K8b) and int8-P.V (K8a, K8b) kernels: (int8_qk,
# int8_pv, streaming); streaming is forced at every length by
# single_kv_max=0
STREAM_VARIANTS = [(False, False, True), (True, False, True),
                   (False, True, True), (True, True, True),
                   (False, True, False), (True, True, False)]
STREAM_SHAPES = ATTN_SHAPES[:4] + [ATTN_SHAPES[5]]


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk,int8_pv,streaming", STREAM_VARIANTS)
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", STREAM_SHAPES)
def test_stream_and_int8_pv_kernels_match_plain_on_the_card(
        cuda_device, nh, d, h, w, n_txt, rope2d, int8_qk, int8_pv, streaming):
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d)
    n = q.shape[1]
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    cos, sin = (torch.as_tensor(t)
                for t in tfa.rope_row_tables(angles, n, d))
    cq, sq = tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img)
    kern = tfa._INFERENCE.get((int8_qk, int8_pv, streaming), (tfa.K7,))[0]
    counts = lambda: {kk.name: kk.launches for kk in kernels.REGISTRY}
    before = counts()
    got = tfa.fused_attention(qb, kb, vb, nh, *(t.to(dev) for t in (
        cq, sq, ck, sk)), scale, int8_qk=int8_qk, int8_pv=int8_pv,
        single_kv_max=0 if streaming else 2048)
    torch.cuda.synchronize()
    after = counts()
    assert {nm: after[nm] - before[nm] for nm in after
            if after[nm] != before[nm]} == {kern.name: 1}
    eps = float(torch.finfo(torch.bfloat16).eps)
    ins = [t.float().cpu() for t in (qb, kb, vb)] + [cq, sq, ck, sk, scale,
                                                    eps, eps, nh]
    if streaming:  # the kernel's key tiles
        plain = (tfa.composition_stream_int8_qk if int8_qk
                 else tfa.composition_stream)
        tile = (tfa.INT8_KEY_TILE if int8_qk or int8_pv
                else tfa.K7_KEY_TILE)
        want = plain(*ins, block_k=tile, int8_pv=int8_pv)
    else:
        plain = tfa.composition_int8_qk if int8_qk else tfa.composition
        want = plain(*ins, int8_pv=int8_pv)
    # chip_smoke.py's limits: ATTN_ATOL for bf16 P.V, K8_ATOL for int8 P.V
    atol = 3e-2 if int8_pv else 1e-2
    np.testing.assert_allclose(got.float().cpu().numpy(), want.numpy(),
                               atol=atol, rtol=0)


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


# K9: (rows, tokens per sample, k, hidden): the 512px text stream at CFG
# batch 2 (not sample-alignable), the image stream, and a ragged one whose
# 64-row tiles straddle samples; h_group as K9's picker gives it
K9_SHAPES = [(2 * 154, 154, 1216, 4864), (2 * 1024, 1024, 1216, 4864),
             (300, 100, 64, 384)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,n_tok,k,hidden", K9_SHAPES)
def test_k9_kernel_matches_plain_on_the_card(cuda_device, m, n_tok, k,
                                             hidden):
    t = mlp_case(m, n_tok, k, hidden, k, cuda_device, seed=3)
    w = [t[n] for n in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale", "b3")]
    b = m // n_tok
    counts = lambda: (tfm.K2.launches, tfm.K3.launches, tfm.K9.launches)
    before = counts()
    got = tfm.fused_swiglu_int8(t["x"].reshape(b, n_tok, k), *w,
                                shift=t["shift"], scale=t["scale"],
                                gate=t["gate"], residual=True,
                                tail_fusion="3d").reshape(m, k)
    torch.cuda.synchronize()
    assert counts() == (before[0], before[1], before[2] + 1)
    # the plain version in fp32 on the kernel's inputs: the conditioning
    # rounded to bf16 first, as the dispatch does
    bf = lambda n: t[n].to(torch.bfloat16).float()
    want = tfm.swiglu_int8_plain(
        t["x"].float(), *w, h_group=tfm.pick_blocks(n_tok, hidden)[1],
        shift=bf("shift"), scale=bf("scale"), gate=bf("gate"), n_tok=n_tok,
        adaln=True, residual=True)
    err = (got.float() - want).abs().max().item()
    rel = ((got.float() - want).norm() / want.norm()).item()
    assert err <= 1e-2 * want.abs().max().item() and rel <= 5e-3, (err, rel)


def dense_case(b, n, k, d_out, dev, seed=0):
    """Seeded bf16 activations and residual, three int8 (d_out, k) weights
    with fp32 scales, and per-sample shift / scale / gate far apart."""
    r = np.random.default_rng(seed)
    f = lambda *s, sd=1.0: torch.from_numpy(
        (r.standard_normal(s) * sd).astype(np.float32))
    ws = [quantize_weight(f(d_out, k, sd=k ** -0.5)) for _ in range(3)]
    step = torch.arange(b, dtype=torch.float32)[:, None]
    t = dict(x=f(b, n, k).to(torch.bfloat16),
             res=f(b, n, d_out).to(torch.bfloat16),
             shift=step + f(b, k, sd=0.1), scale=f(b, k, sd=0.3),
             gate=step - 1 + f(b, d_out, sd=0.5))
    t = {key: v.to(dev) for key, v in t.items()}
    return t, [x.to(dev) for wq_s in ws for x in wq_s]


# (B, N, k, d_out): the 512px image stream at CFG batch 2, a ragged one
# (300 rows: a partial 64-row tile), k a multiple of 16 but not of 64
DENSE_SHAPES = [(2, 1024, 1216, 1216), (3, 100, 64, 64), (2, 40, 80, 48)]
# chip_smoke.py's K10 limits: against fp32, a bf16 output and the odd int8
# level moved by the LayerNorm's sum order
K10_MAX_REL, K10_REL_L2 = 1e-2, 5e-3


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,d_out", DENSE_SHAPES)
def test_k10a_kernel_matches_plain_on_the_card(cuda_device, b, n, k, d_out):
    t, ws = dense_case(b, n, k, d_out, cuda_device)
    before = (tfd.K10A.launches, tfd.K10B.launches)
    got = tfd.qkv_adaln_int8(t["x"], t["shift"], t["scale"], *ws)
    torch.cuda.synchronize()
    assert (tfd.K10A.launches, tfd.K10B.launches) == (before[0] + 1,
                                                      before[1])
    want = tfd.qkv_adaln_int8_plain(t["x"].float(), t["shift"], t["scale"],
                                    *ws)
    for g, w in zip(got, want):
        assert g.shape == (b, n, d_out) and g.dtype == torch.bfloat16
        err = (g.float() - w).abs().max().item()
        rel = ((g.float() - w).norm() / w.norm()).item()
        assert (err <= K10_MAX_REL * w.abs().max().item()
                and rel <= K10_REL_L2), (err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("gated,residual", [(True, True), (False, False)])
@pytest.mark.parametrize("b,n,k,d_out", DENSE_SHAPES)
def test_k10b_kernel_matches_plain_on_the_card(cuda_device, b, n, k, d_out,
                                               gated, residual):
    # a is the image half of a longer joint sequence, read in place
    t, ws = dense_case(b, n, k, d_out, cuda_device, seed=1)
    joint = torch.cat([t["x"], t["x"][:, :7]], dim=1)
    a = joint[:, :n]
    gate = t["gate"] if gated else None
    res = t["res"] if residual else None
    before = (tfd.K10A.launches, tfd.K10B.launches)
    got = tfd.out_gate_residual_int8(a, gate, res, *ws[:2])
    torch.cuda.synchronize()
    assert (tfd.K10A.launches, tfd.K10B.launches) == (before[0],
                                                      before[1] + 1)
    want = tfd.out_gate_residual_int8_plain(
        a.float(), gate, None if res is None else res.float(), *ws[:2])
    err = (got.float() - want).abs().max().item()
    rel = ((got.float() - want).norm() / want.norm()).item()
    assert err <= K10_MAX_REL * want.abs().max().item() and rel <= K10_REL_L2
    # on the same bf16 values with a bf16 output it repeats the plain
    # version's arithmetic: only the int8 products' sums are the kernel's
    same = tfd.out_gate_residual_int8_plain(a, gate, res, *ws[:2])
    assert ((got.float() - same.float()).norm() / same.float().norm()
            ).item() <= 1e-3


@pytest.mark.cuda
def test_k9_k10_refuse_what_they_do_not_take(cuda_device):
    t, ws = dense_case(2, 8, 64, 64, cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfd.qkv_adaln_int8(t["x"].float(), t["shift"], t["scale"], *ws)
    with pytest.raises(TypeError, match="int8"):
        tfd.out_gate_residual_int8(t["x"], None, None, ws[0].float(), ws[1])
    with pytest.raises(TypeError, match="int8"):   # k of another width
        tfd.out_gate_residual_int8(t["x"], None, None, ws[0][:, :32], ws[1])
    x = torch.zeros(2, 8, 40, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(64, 40, device=cuda_device, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="multiple of 16"):
        tfd.out_gate_residual_int8(x, None, None, w, ws[1])
    with pytest.raises(ValueError, match="shift"):
        tfd.qkv_adaln_int8(t["x"], t["shift"][:1], t["scale"], *ws)
    m = mlp_case(32, 16, 64, 128, 64, cuda_device)
    mw = [m[n] for n in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale",
                         "b3")]
    with pytest.raises(TypeError, match="bfloat16"):
        tfm.swiglu_int8_tail3d(m["x"].float(), m["shift"], m["scale"],
                               m["gate"], *mw, n_tok=16, h_group=128)


# K1 and K7 at lengths ragged against their 128-key tile: 2100 tokens (16
# tiles and 52 keys; K1 forced past its 2048 by single_kv_max) at odd
# heads, head dims 32 and 128; and a grid of more than one wave of blocks
# (one block per SM: 3 query blocks x 24 heads x 2 samples = 144 > 132)
K1_K7_SHAPES = [(3, 32, 45, 46, 30, True), (2, 128, 45, 46, 30, True),
                (24, 64, 12, 20, 60, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", K1_K7_SHAPES)
def test_k1_k7_at_ragged_tiles_and_many_waves_on_the_card(
        cuda_device, nh, d, h, w, n_txt, rope2d, streaming):
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d)
    n = q.shape[1]
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    tabs = (*tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img),
            *tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img))
    kern = tfa.K7 if streaming else tfa.K1
    counts = lambda: {kk.name: kk.launches for kk in kernels.REGISTRY}
    before = counts()
    got = tfa.fused_attention(qb, kb, vb, nh, *(t.to(dev) for t in tabs),
                              scale, single_kv_max=0 if streaming else 1 << 20)
    torch.cuda.synchronize()
    after = counts()
    assert {nm: after[nm] - before[nm] for nm in after
            if after[nm] != before[nm]} == {kern.name: 1}
    eps = float(torch.finfo(torch.bfloat16).eps)
    ins = [t.float().cpu() for t in (qb, kb, vb)] + [*tabs, scale, eps, eps,
                                                    nh]
    want = (tfa.composition_stream(*ins, block_k=tfa.K7_KEY_TILE)
            if streaming else tfa.composition(*ins))
    # chip_smoke.py's ATTN_ATOL
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


# ---- training: K5, K6a, K6b and the gradient rules ----------------------

# (B, H, N, D): one partial tile with odd heads at D 32, a ragged length
# whose last tile holds 44 rows, a last tile of one row, the 512px training
# shape (4 samples x 19 heads, 1024 + 154 tokens)
FLASH_SHAPES = [(2, 3, 47, 32), (1, 5, 300, 64), (1, 2, 129, 64),
                (4, 19, 1178, 64)]
# lengths around the backward kernels' 128-row blocks and 64-row query tiles
# (csrc/flash_bwd_sm90.cu) at both head dims: one row, a partial tile, whole
# tiles, a tile and one row
FLASH_TILE_SHAPES = [(1, 2, n, d) for d in (32, 64)
                     for n in (1, 63, 64, 65, 127, 128, 129, 255, 257)
                     if (1, 2, n, d) not in FLASH_SHAPES]
# chip_smoke.py's limits: bf16 p, ds and outputs against the fp32 plain
# versions run on the same bf16 values
FLASH_OUT_ATOL, FLASH_LSE_ATOL = 1e-2, 1e-3
FLASH_GRAD_MAX_REL, FLASH_GRAD_REL_L2 = 2e-2, 1e-2
# chip_smoke.py's K1 backward limits: the prep's output is rounded to bf16
# before K5 / K6 (the fp32 composition keeps it), and the bf16 output of K5
# enters delta, whose difference with dO.v^T cancels, on top of the flash
# kernels' roundings
K1_GRAD_MAX_REL, K1_GRAD_REL_L2 = 3e-2, 1.5e-2
# one key: the softmax over it has no gradient, and the plain versions give
# dq = dk = 0 exactly, where a relative error has no meaning; the kernels'
# ds is then p (dp - delta), two fp32 sums of the same D products in two
# orders (~1e-6 here), rounded to bf16 and times k and the scale
FLASH_GRAD_ZERO_ATOL = 1e-4


def _flash_case(shape, dev, seed=0):
    r = np.random.default_rng(seed)
    return [_t(r.standard_normal(shape)).to(dev, torch.bfloat16)
            for _ in range(4)]


def _flash_plain_fp32(q, k, v, do, scale):
    """The plain versions in fp32 on the kernels' bf16 inputs."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    out, lse = tfl.flash_fwd_plain(qf, kf, vf, scale)
    dq, delta = tfl.flash_dq_plain(qf, kf, vf, out, dof, lse, scale)
    dk, dv = tfl.flash_dkv_plain(qf, kf, vf, dof, lse, delta, scale)
    return out, lse, dq, dk, dv


def _assert_grad_close(got, want, name, max_rel_limit=FLASH_GRAD_MAX_REL,
                       rel_l2_limit=FLASH_GRAD_REL_L2):
    d = got.float() - want
    if not want.any():
        assert d.abs().max().item() <= FLASH_GRAD_ZERO_ATOL, name
        return
    max_rel = (d.abs().max() / want.abs().max()).item()
    rel_l2 = (d.norm() / want.norm()).item()
    assert max_rel <= max_rel_limit and rel_l2 <= rel_l2_limit, (
        name, max_rel, rel_l2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES + FLASH_TILE_SHAPES)
def test_k5_k6_kernels_match_plain_on_the_card(cuda_device, shape):
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v, do = _flash_case(shape, cuda_device)
    scale = shape[-1] ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    counts = lambda: (tfl.K5.launches, tfl.K6A.launches, tfl.K6B.launches)
    before = counts()
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert counts() == tuple(c + 1 for c in before)
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert lse.dtype == delta.dtype == torch.float32
    assert (out.float() - want[0]).abs().max().item() <= FLASH_OUT_ATOL
    assert (lse - want[1]).abs().max().item() <= FLASH_LSE_ATOL
    want_delta = (do.float() * out.float()).sum(-1)
    assert (delta - want_delta).abs().max().item() <= 1e-3
    for name, g, w in (("dq", dq, want[2]), ("dk", dk, want[3]),
                       ("dv", dv, want[4])):
        _assert_grad_close(g, w, name)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 257, 32), (4, 19, 1178, 64)])
def test_k6_kernels_give_the_same_bits_twice_on_the_card(cuda_device,
                                                         shape):
    # no atomics: every output element is summed by one thread in one order
    q, k, v, do = _flash_case(shape, cuda_device, seed=3)
    scale = shape[-1] ** -0.5
    out, lse = tfl.flash_fwd(q, k, v, scale)
    runs = []
    for _ in range(2):
        dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
        runs.append((dq, delta, *tfl.flash_dkv(q, k, v, do, lse, delta,
                                                scale)))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 47, 32), (1, 5, 300, 64)])
def test_k6_kernels_read_bnhd_views_in_place_on_the_card(cuda_device, shape,
                                                         monkeypatch):
    # (B, H, N, D) views of (B, N, H, D) buffers, the attention path's
    # layout, go to the tensor maps as they are (no copy) and give the bits
    # of contiguous inputs
    q, k, v, do = _flash_case(shape, cuda_device, seed=4)
    scale = shape[-1] ** -0.5
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v, out, do)]
    readable, in_place = tfl._readable, []

    def spy(t):
        r = readable(t)
        in_place.append(r is t)
        return r
    monkeypatch.setattr(tfl, "_readable", spy)
    vdq, vdelta = tfl.flash_dq(*views, lse, scale)
    vdk, vdv = tfl.flash_dkv(*views[:3], views[4], lse, vdelta, scale)
    torch.cuda.synchronize()
    assert in_place == [True] * 9
    for a, b in ((dq, vdq), (delta, vdelta), (dk, vdk), (dv, vdv)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SHAPES[:2])
def test_flash_autograd_function_on_the_card(cuda_device, shape):
    # the Function launches K5 once forward and K6a, K6b once backward, and
    # reads q, k, v as (B, H, N, D) views of (B, N, H, D) buffers in place
    q, k, v, do = _flash_case(shape, cuda_device, seed=1)
    scale = shape[-1] ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
             for t in (q, k, v)]
    before = (tfl.K5.launches, tfl.K6A.launches, tfl.K6B.launches)
    out = tfl.flash_attention(*views, scale)
    out.backward(do)
    torch.cuda.synchronize()
    assert (tfl.K5.launches, tfl.K6A.launches, tfl.K6B.launches) == (
        before[0] + 1, before[1] + 1, before[2] + 1)
    assert (out.float() - want[0]).abs().max().item() <= FLASH_OUT_ATOL
    for name, t, w in zip(("dq", "dk", "dv"), views, want[2:]):
        _assert_grad_close(t.grad, w, name)


@pytest.mark.cuda
def test_k1_backward_runs_k5_k6_on_the_card(cuda_device):
    # K1's autograd Function: the forward launches K1, the backward
    # recomputes the prep and runs K5, K6a and K6b; its gradients match the
    # plain composition's autograd in fp32
    q, k, v, ws, angles, n_img, scale = _attn_case(3, 64, 5, 7, 12, True)
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16).requires_grad_()
                  for a in (q, k, v))
    wt = [_t(a).to(dev).requires_grad_() for a in ws]
    before = (tfa.K1.launches, tfl.K5.launches, tfl.K6A.launches,
              tfl.K6B.launches)
    out = tfa.fused_dual_flash_attention(qb, kb, vb, 3, *wt, angles, n_img,
                                         scale)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        out.shape).astype(np.float32)).to(dev, torch.bfloat16)
    got = torch.autograd.grad(out, [qb, kb, vb, *wt], g)
    torch.cuda.synchronize()
    assert (tfa.K1.launches, tfl.K5.launches, tfl.K6A.launches,
            tfl.K6B.launches) == tuple(c + 1 for c in before)
    # the plain composition in fp32 on the same values, with the kernel's
    # RMSNorm eps (that of bf16)
    ref = [t.detach().float().cpu().requires_grad_() for t in (qb, kb, vb)]
    wr = [_t(a).requires_grad_() for a in ws]
    cos, sin = (torch.as_tensor(t)
                for t in tfa.rope_row_tables(angles, q.shape[1], 64))
    cq, sq = tfa.fold_row_tables(cos, sin, wr[0], wr[1], n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, wr[2], wr[3], n_img)
    eps = float(torch.finfo(torch.bfloat16).eps)
    want = torch.autograd.grad(
        tfa.composition(*ref, cq, sq, ck, sk, scale, eps, eps, 3),
        ref + wr, g.float().cpu())
    for i, (a, b) in enumerate(zip(got, want)):
        _assert_grad_close(a.cpu(), b, f"input {i}", K1_GRAD_MAX_REL,
                           K1_GRAD_REL_L2)


@pytest.mark.cuda
def test_flash_refuses_what_it_does_not_take(cuda_device):
    q = torch.zeros(1, 2, 8, 32, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfl.flash_attention(q, q, q, 0.2)
    qb = torch.zeros(1, 2, 8, 48, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="D in"):
        tfl.flash_attention(qb, qb, qb, 0.2)


def test_k1_carries_gradients_and_inference_kernels_refuse_them():
    # K1 is an autograd Function (its plain version here); K4, K2, K3, K9,
    # K10a and K10b are serving kernels and raise when an input requires
    # grad, on every device, rather than return a result cut off from
    # autograd
    q, k, v, ws, angles, n_img, scale = _attn_case(2, 16, 2, 4, 4, True)
    qt = _t(q).requires_grad_()
    wt = [_t(a) for a in ws]
    out = tfa.fused_dual_flash_attention(qt, _t(k), _t(v), 2, *wt, angles,
                                         n_img, scale)
    assert out.grad_fn is not None
    out.sum().backward()
    assert qt.grad is not None and torch.isfinite(qt.grad).all()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfa.fused_dual_flash_attention(qt, _t(k), _t(v), 2, *wt, angles,
                                       n_img, scale, int8_qk=True)
    with torch.no_grad():
        tfa.fused_dual_flash_attention(qt, _t(k), _t(v), 2, *wt, angles,
                                       n_img, scale, int8_qk=True)
    t = mlp_case(32, 32, 64, 128, 64, "cpu")
    w = [t[n] for n in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale", "b3")]
    x = t["x"].float().requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfm.swiglu_int8(x, *w, h_group=128)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfm.swiglu_int8_tail(x, t["shift"], t["scale"], t["gate"], *w,
                             n_tok=32, h_group=128)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfm.swiglu_int8_tail3d(x, t["shift"], t["scale"], t["gate"], *w,
                               n_tok=32, h_group=128)
    with torch.no_grad():
        assert tfm.swiglu_int8(x, *w, h_group=128).shape == (32, 64)
    d, ws = dense_case(2, 8, 64, 64, "cpu")
    xg = d["x"].float().requires_grad_()
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfd.qkv_adaln_int8(xg, d["shift"], d["scale"], *ws)
    with pytest.raises(NotImplementedError, match="inference-only"):
        tfd.out_gate_residual_int8(xg, d["gate"], None, *ws[:2])
