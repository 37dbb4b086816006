"""Kernels K1-K10b and the port's dispatch rules, with no JAX import, so the
file also runs on the card's machine:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

(`--noconftest`: the suite's conftest.py imports JAX). On the CPU the
`cuda`-marked tests skip; the rest check tables, dispatch and refusals.
K1 against its plain version: tolerance atol 1e-2, chip_smoke.py's
ATTN_ATOL (bf16 q^, k^, p and output against fp32); K4, K2 and K3:
chip_smoke.py's K4_ATOL and MLP limits (reasons there); the int8 row
max's premise bit for bit; K5, K6a and K6b:
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


@pytest.mark.parametrize("name,family", [
    ("void (anonymous namespace)::attn_int8_sm90_kernel<64, true, false, "
     "true>(CUtensorMap_st, CUtensorMap_st)", "K4"),
    ("attn_int8_sm90_kernel<64, false, true, false>(CUtensorMap_st)", "K8b"),
    ("attn_int8_sm90_kernel<32, true, true, false>(CUtensorMap_st)", "K8b"),
    ("void (anonymous namespace)::prep_q8rows_kernel<64, 4>(bf16 const*)",
     "K4"),
    ("prep_q8rows_kernel<64, 7>(bf16 const*)", "K7q"),
    ("prep_q8rows_kernel<64, 8>(bf16 const*)", "K8b"),
    ("prep_q8rows_kernel<64, 81>(bf16 const*)", "K8a"),
    ("k_prep_kernel<64, true, __nv_bfloat16>(bf16 const*)", "K4"),
    ("k_quant_kernel(bf16 const*)", "K4"),
    ("v_quant_kernel<64>(bf16 const*)", "K8b"),
    ("v_amax_kernel(bf16 const*)", "K8b"),
    ("attn_int8_sm90_kernel<64, true, false, false>(CUtensorMap_st)", "K7q"),
    ("attn_int8_sm90_kernel<64, false, true, true>(CUtensorMap_st)", "K8a"),
    ("attn_int8_sm90_kernel<64, true, true, true>(CUtensorMap_st)", "K8a"),
    ("attn_sm90_kernel<64, (anonymous namespace)::Softmax::Online>", "K7"),
    ("attn_fp32_kernel<64>(float const*)", "fp32 attention"),
    ("dq_fp32_kernel<64>(float const*)", "fp32 attention"),
    ("void (anonymous namespace)::dense_sm90_kernel<10>(CUtensorMap_st, "
     "CUtensorMap_st)", "K10a"),
    ("dense_sm90_kernel<11>(CUtensorMap_st)", "K10b"),
    ("void (anonymous namespace)::dense_sm90_kernel<10, false>(CUtensorMap_st)",
     "K10a"),
    ("dense_sm90_kernel<11, true>(CUtensorMap_st)", "K10b"),
    ("xquant_kernel<9>(bf16 const*)", "K9"),
])
def test_chip_smoke_names_the_kernel_families(name, family):
    # chip_smoke.py's profile breakdown by TPU kernel (it imports only the
    # standard library at module level); the bf16 preps K1, K7 and K8b
    # share go to the caller's family
    import chip_smoke
    assert chip_smoke.kernel_family(name) == family
    for fam in ("K1", "K7", "K8b"):
        assert chip_smoke.kernel_family("q_prep_kernel<64, false>(x)",
                                        fam) == fam
        assert chip_smoke.kernel_family("k_prep_kernel<64, false>(x)",
                                        fam) == fam


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
              tfm.K3, tfl.K5, tfl.K6A, tfl.K6B, tfm.K9, tfd.K10A, tfd.K10B,
              tfa.K1F, tfa.K7F, tfl.K5F, tfl.K6AF, tfl.K6BF):
        assert k in kernels.REGISTRY
        src = (kernels.CSRC_DIR / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src, k.name


def test_flash_backward_is_the_wgmma_source():
    # K6a and K6b are the wgmma + TMA kernels of flash_bwd_sm90.cu; the
    # mma.sync dq / dk-dv kernels are gone, and K5's source holds none of
    # the backward
    assert tfl.K6A.source == tfl.K6B.source == "flash_bwd_sm90.cu"
    assert tfl.K5.source == "attention_sm90.cu"
    bwd = (kernels.CSRC_DIR / tfl.K6A.source).read_text()
    fwd = (kernels.CSRC_DIR / tfl.K5.source).read_text()
    assert "wgmma_rs" in bwd and "tma_load_4d" in bwd
    assert "mma_bf16(" not in bwd and "mma.sync" not in bwd
    for gone in ("dq_kernel", "dkv_kernel", "sd3_flash_attention_dq",
                 "sd3_flash_attention_dkv"):
        assert gone not in fwd, gone


def test_flash_forward_is_the_hopper_attention_source():
    # K5 is the Softmax::Flash instance of K1 / K7's wgmma + TMA kernel, one
    # launch on raw q, k, v through tensor maps of their strided views; the
    # mma.sync source it had is gone
    assert tfl.K5.source == tfa.K1.source == tfa.K7.source
    src = (kernels.CSRC_DIR / tfl.K5.source).read_text()
    entry = src[src.index('extern "C" int sd3_flash_attention_fwd('):]
    for d in tfl.HEAD_DIMS:
        assert f"launch_flash<{d}>" in entry, d
    launch = src[src.index("int launch_flash("):]
    launch = launch[:launch.index("\n}\n")]
    assert "attn_sm90_kernel<D, Softmax::Flash>" in launch
    assert launch.count("encode_view<D,") == 3 and "<<<" in launch
    assert "prep" not in launch
    assert "mma_bf16(" not in src and "cp_async16(" not in src
    assert not (kernels.CSRC_DIR / "flash_attention.cu").exists()


def test_int8_swiglu_is_the_wgmma_source():
    # K2, K3 and K9 run both products on s8 wgmma fed by TMA: no mma.sync
    # or ldmatrix fragment is left in their source
    assert tfm.K2.source == tfm.K3.source == tfm.K9.source == "fused_mlp.cu"
    src = (kernels.CSRC_DIR / tfm.K2.source).read_text()
    hdr = (kernels.CSRC_DIR / "sm90.cuh").read_text()
    assert "wgmma.mma_async.sync.aligned.m64n256k32.s32.s8.s8" in hdr
    assert "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8" in hdr
    for used in ("wgmma_s8<2 * PASS_COLS>", "wgmma_s8<W3_BN>", "tma_load_2d",
                 "encode_s8_2d", "setmaxnreg_inc", "launch_xquant<V>"):
        assert used in src, used
    for gone in ("mma_s8(", "load_b2(", "ldsm_x4(", "swiglu_h_kernel<",
                 "w3_gemm_kernel<"):
        assert gone not in src, gone


def test_int8_attention_is_the_wgmma_source():
    # K4, K8a, K7q and K8b run on s8 / bf16 wgmma fed by TMA in
    # attention_int8_sm90.cu, one kernel with the pass structure its own
    # template parameter: no mma.sync or ldmatrix fragment is left in their
    # source or in the headers, and the mma.sync sources are gone
    assert (tfa.K4.source == tfa.K8B.source == tfa.K7Q.source
            == tfa.K8A.source == "attention_int8_sm90.cu")
    src = (kernels.CSRC_DIR / tfa.K4.source).read_text()
    assert "template <int D, bool QK8, bool PV8, bool TWO_PASS>" in src
    assert "constexpr bool TWO_PASS = " not in src
    for inst in ("dispatch<true, false, true>", "dispatch<true, false, false>",
                 "dispatch<false, true, true>", "dispatch<true, true, true>",
                 "dispatch<false, true, false>", "dispatch<true, true, false>"):
        assert inst in src, inst
    for hdr in ("mma.cuh", "attention_common.cuh"):
        text = (kernels.CSRC_DIR / hdr).read_text()
        for gone in ("mma_s8(", "mma_bf16(", "ldsm_x4(", "constexpr int BK "):
            assert gone not in text, (hdr, gone)
    hdr = (kernels.CSRC_DIR / "sm90.cuh").read_text()
    for n in (16, 32, 64, 128):
        assert f"wgmma.mma_async.sync.aligned.m64n{n}k32.s32.s8.s8" in hdr
    for used in ("wgmma_s8<KEY_TILE>", "wgmma_s8_rs<D>", "wgmma_rs<D>",
                 "wgmma_ss<KEY_TILE>", "tma_load_4d", "tma_load_2d",
                 "encode_heads", "encode_s8_2d", "setmaxnreg_inc"):
        assert used in src, used
    for gone in ("mma_s8(", "mma_bf16(", "ldsm_x4(", "cp_async16(",
                 "mma.sync"):
        assert gone not in src, gone
    assert not (kernels.CSRC_DIR / "fused_attention.cu").exists()
    assert not (kernels.CSRC_DIR / "stream_attention.cu").exists()


def test_int8_dense_is_the_wgmma_source():
    # K10a and K10b are one launch each on s8 wgmma fed by TMA, the row
    # prologue inside it (its int8 rows written into the A tile and handed
    # to the async proxy by a fence): no mma.sync or ldmatrix fragment, no
    # cp.async and no separate prologue launch is left in their source, and
    # the int8 ldmatrix helpers are gone from the shared header
    assert tfd.K10A.source == tfd.K10B.source == "fused_dense.cu"
    src = (kernels.CSRC_DIR / tfd.K10A.source).read_text()
    hdr = (kernels.CSRC_DIR / "sm90.cuh").read_text()
    common = (kernels.CSRC_DIR / "int8_common.cuh").read_text()
    assert "fence.proxy.async.shared::cta" in hdr
    assert "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {" in hdr
    for used in ("wgmma_s8<", "tma_load_2d", "encode_s8_2d", "setmaxnreg_inc",
                 "fence_proxy_async_shared()", "tma_store_2d"):
        assert used in src, used
    for gone in ("mma_s8(", "ldsm_x4(", "load_a(", "load_b2(", "cp_async16(",
                 "launch_xquant<", "mma.sync", "dense_int8_kernel"):
        assert gone not in src, gone
    for gone in ("ldsm_x4(", "load_a(", "load_b2(", "constexpr int BK ",
                 "constexpr int SK "):
        assert gone not in common, gone


def test_k10_k_max_matches_its_source():
    # the kernels' shared-memory A tile holds K_CHUNK values of a row, which
    # must take the published width 1216 in one chunk (no extra pass over x);
    # wider rows run in chunks of it, and no other limit on k is left
    src = (kernels.CSRC_DIR / tfd.K10A.source).read_text()
    m = re.search(r"constexpr int K_CHUNK = (\d+);", src)
    assert m is not None
    assert tfd.K_CHUNK == int(m.group(1)) >= 1216
    assert tfd.K_CHUNK % 128 == 0
    assert "K_MAX" not in src and not hasattr(tfd, "K_MAX")


@pytest.mark.parametrize("const,source,name", [
    ("K7_KEY_TILE", "attention_sm90.cu", "KEY_TILE"),
    ("K8B_KEY_TILE", "attention_int8_sm90.cu", "KEY_TILE"),
    ("K7Q_KEY_TILE", "attention_int8_sm90.cu", "KEY_TILE")])
def test_key_tiles_match_their_sources(const, source, name):
    # the plain versions' block_k that the card comparisons take is the
    # kernel's own key tile: K1 / K7's, and K4 / K8a / K7q / K8b's (the int8
    # V^T of K8a and K8b is padded to it)
    src = (kernels.CSRC_DIR / source).read_text()
    m = re.search(rf"constexpr int {name} = (\d+);", src)
    assert m is not None, (source, name)
    assert getattr(tfa, const) == int(m.group(1))
    assert (tfa.K1.source == tfa.K7.source == tfl.K5.source
            == "attention_sm90.cu")


@pytest.mark.parametrize("d,n", [(16, 47), (64, 1178), (128, 129)])
def test_int8_row_max_of_s32_is_the_max_of_dequantized_scores(d, n):
    # K4's first pass takes the row max as fp32(max s32) * (s_q * s_k): with
    # s_q * s_k > 0 and s32 exact in fp32, rounding the product is monotone,
    # so this is max(fp32(s32) * (s_q * s_k)) bit for bit, as the plain
    # version takes it. q^ and k^ as composition_int8_qk makes them
    # (_int8_scores: q^ per row from fp32, k^ rounded to bf16, one k scale
    # per head), K padded with zero rows to whole 128-key tiles, the padded
    # keys left out of the max
    nh = 3
    q, k, _, ws, angles, n_img, scale = _attn_case(nh, d, 4, 4, n - 16, True,
                                                   seed=d + n)
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    cq, sq = tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img)
    eps = float(torch.finfo(torch.bfloat16).eps)
    fold = scale * tfa.LOG2E
    qb, kb = (_t(a).to(torch.bfloat16) for a in (q, k))
    qf = tfa._prep(tfa._heads(qb, nh), cq * fold, sq * fold, eps)
    kh = tfa._prep(tfa._heads(kb, nh), ck, sk, eps).to(torch.bfloat16).float()
    s_q = tfa.scale_of(qf.abs().amax(-1, keepdim=True), tfa.Q8_EPS)
    s_k = tfa.scale_of(kh.abs().amax((-2, -1), keepdim=True), tfa.Q8_EPS)
    qi, ki, comb = tfa._q8(qf, s_q), tfa._q8(kh, s_k), s_q * s_k
    pad = -(-n // tfa.K8B_KEY_TILE) * tfa.K8B_KEY_TILE - n
    ki = torch.cat([ki, ki.new_zeros(*ki.shape[:2], pad, d)], -2)
    s32 = torch.matmul(qi.double(), ki.double().transpose(-1, -2))[..., :n]
    assert s32.abs().max() < 2 ** 24
    s32 = s32.float()
    want = (s32 * comb).amax(-1, keepdim=True)
    got = s32.amax(-1, keepdim=True) * comb
    assert torch.equal(got, want)
    assert (comb > 0).all()


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
        tile = (tfa.K8B_KEY_TILE if int8_pv else tfa.K7Q_KEY_TILE
                if int8_qk else tfa.K7_KEY_TILE)
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


# (rows, tokens per sample): fewer rows than a wgmma's 64, one tile, one
# row past it, a ragged tile whose samples straddle tiles, the 512px text
# stream at CFG batch 8 and the image stream; at k = d_out = 80 (a K tail of
# 16 past a 32-deep wgmma step and 48 past a 128-byte TMA box, and a partial
# column tile) and hidden 1024 (whole chunks of every h_group)
MLP_EDGE_ROWS = [(1, 1), (63, 63), (64, 64), (65, 65), (300, 100),
                 (1232, 154), (8192, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("h_group", tfm.H_GROUPS)
@pytest.mark.parametrize("m,n_tok", MLP_EDGE_ROWS)
@pytest.mark.parametrize("kind", ["K2", "K3", "K9"])
def test_int8_swiglu_at_ragged_rows_and_chunks_on_the_card(cuda_device, kind,
                                                           m, n_tok, h_group):
    k, hidden = 80, 1024
    t = mlp_case(m, n_tok, k, hidden, k, cuda_device, seed=m + h_group)
    w = [t[n] for n in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale", "b3")]
    tail = kind != "K3"
    kern = {"K2": tfm.K2, "K3": tfm.K3, "K9": tfm.K9}[kind]
    fn = {"K2": tfm.swiglu_int8_tail, "K9": tfm.swiglu_int8_tail3d}.get(kind)
    if tail:
        run = lambda: fn(t["x"], t["shift"], t["scale"], t["gate"], *w,
                         n_tok=n_tok, h_group=h_group)
    else:
        run = lambda: tfm.swiglu_int8(t["x"], *w, h_group=h_group)
    before = kern.launches
    got, again = run(), run()
    torch.cuda.synchronize()
    assert kern.launches == before + 2
    assert torch.equal(got, again)
    # the plain version in fp32 on the kernel's inputs, on the card
    want = tfm.swiglu_int8_plain(
        t["x"].float(), *w, h_group=h_group, shift=t["shift"],
        scale=t["scale"], gate=t["gate"], n_tok=n_tok, adaln=tail,
        residual=tail)
    err = (got.float() - want).abs().max().item()
    rel = ((got.float() - want).norm() / want.norm()).item()
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


# (B, N, k, d_out): the 512px image stream at CFG batch 2 (32 row blocks:
# the columns split into spans), a ragged one (300 rows: a partial 64-row
# tile), k a multiple of 16 but not of 64; the full image stream (B 8: one
# wave of 128 row blocks), the published widths at ragged rows (900 rows,
# 64-row blocks straddling samples; K and d_out not multiples of 128), K at
# one A tile (1536) with blocks spanning three samples and d_out a multiple
# of 8 only; k past one A tile, in chunks: 1600 (two chunks, the second of
# one K tile), 1728 and 2944 (the widths the JAX kernels take at most) and
# 4096 (64 blocks' dim; three chunks), with ragged rows, and a narrow last
# column tile at 1600
DENSE_SHAPES = [(2, 1024, 1216, 1216), (3, 100, 64, 64), (2, 40, 80, 48),
                (8, 1024, 1216, 1216), (3, 300, 1216, 1216),
                (5, 30, 1536, 200),
                (2, 130, 1600, 1600), (2, 70, 1728, 1728), (3, 50, 2944, 2944),
                (2, 40, 4096, 4096), (1, 64, 1600, 200)]
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
@pytest.mark.parametrize("gated,residual", [(True, True), (False, False),
                                            (True, False), (False, True)])
@pytest.mark.parametrize("b,n,k,d_out", DENSE_SHAPES)
def test_k10b_equals_its_plain_version_bit_for_bit_on_the_card(
        cuda_device, b, n, k, d_out, gated, residual):
    # on the same bf16 values K10b repeats the plain version's arithmetic in
    # its order, the rounding of a / s_a to int8 levels included
    t, ws = dense_case(b, n, k, d_out, cuda_device, seed=2)
    a = torch.cat([t["x"], t["x"][:, :5]], dim=1)[:, :n]
    gate = t["gate"] if gated else None
    res = t["res"] if residual else None
    got = tfd.out_gate_residual_int8(a, gate, res, *ws[:2])
    torch.cuda.synchronize()
    same = tfd.out_gate_residual_int8_plain(a, gate, res, *ws[:2])
    assert torch.equal(got, same)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,d_out", [(8, 1024, 1216, 1216),
                                         (3, 300, 1216, 1216)])
def test_k10_kernels_give_the_same_bits_twice_on_the_card(cuda_device, b, n,
                                                          k, d_out):
    t, ws = dense_case(b, n, k, d_out, cuda_device, seed=3)
    first = tfd.qkv_adaln_int8(t["x"], t["shift"], t["scale"], *ws)
    again = tfd.qkv_adaln_int8(t["x"], t["shift"], t["scale"], *ws)
    out = [tfd.out_gate_residual_int8(t["x"], t["gate"], t["res"], *ws[:2])
           for _ in range(2)]
    torch.cuda.synchronize()
    assert all(torch.equal(p, q) for p, q in zip(first, again))
    assert torch.equal(*out)


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
    # no limit on k is left: wider than the A tile holds runs in chunks and
    # launches; an output width the outputs' tensor maps do not take
    wide = tfd.K_CHUNK + 16
    x = torch.zeros(2, 8, wide, device=cuda_device, dtype=torch.bfloat16)
    w = torch.zeros(64, wide, device=cuda_device, dtype=torch.int8)
    before = tfd.K10B.launches
    assert tfd.out_gate_residual_int8(x, None, None, w, ws[1]).shape == (2, 8, 64)
    assert tfd.K10B.launches == before + 1
    w = torch.zeros(36, 64, device=cuda_device, dtype=torch.int8)
    with pytest.raises(NotImplementedError, match="multiple of 8"):
        tfd.out_gate_residual_int8(t["x"], None, None, w, ws[1][:36])
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


# K4 and K8b (over K7's and over K7q's scores) at lengths ragged against
# their 128-key tile: a last tile of one key (129 and 1025 tokens, head dims
# 32, 128 and 64), 2100 tokens (52 keys, head dim 16), and a grid of more
# than one wave of blocks (3 query blocks x 24 heads x 2 samples = 144 >
# 132 SMs); K4 forced past its 2048 by single_kv_max, K8b forced below by 0
INT8_TILE_SHAPES = [(3, 32, 8, 15, 9, True), (2, 128, 8, 16, 1, True),
                    (2, 64, 32, 32, 1, True), (3, 16, 45, 46, 30, True),
                    (24, 64, 12, 20, 60, True)]
# (int8_qk, int8_pv): K4, K8b over K7, K8b over K7q
INT8_SM90_VARIANTS = [(True, False), (False, True), (True, True)]


def _int8_sm90_run(dev, nh, d, q, k, v, tabs, scale, int8_qk, int8_pv):
    """One K4 or K8b launch on the card (launch count checked); its output
    on the CPU."""
    kern = tfa.K8B if int8_pv else tfa.K4
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    counts = lambda: {kk.name: kk.launches for kk in kernels.REGISTRY}
    before = counts()
    got = tfa.fused_attention(qb, kb, vb, nh, *(t.to(dev) for t in tabs),
                              scale, int8_qk=int8_qk, int8_pv=int8_pv,
                              single_kv_max=0 if int8_pv else 1 << 20)
    torch.cuda.synchronize()
    after = counts()
    assert {nm: after[nm] - before[nm] for nm in after
            if after[nm] != before[nm]} == {kern.name: 1}
    return got.cpu()


def _int8_sm90_plain(nh, q, k, v, tabs, scale, int8_qk, int8_pv):
    """The plain version of K4 or K8b in fp32 on the kernels' bf16 inputs,
    over the kernel's key tiles."""
    eps = float(torch.finfo(torch.bfloat16).eps)
    ins = [_t(a).to(torch.bfloat16).float() for a in (q, k, v)] + [
        *tabs, scale, eps, eps, nh]
    if not int8_pv:
        return tfa.composition_int8_qk(*ins)
    plain = (tfa.composition_stream_int8_qk if int8_qk
             else tfa.composition_stream)
    return plain(*ins, block_k=tfa.K8B_KEY_TILE, int8_pv=True)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk,int8_pv", INT8_SM90_VARIANTS)
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d", INT8_TILE_SHAPES)
def test_k4_k8b_at_ragged_tiles_and_many_waves_on_the_card(
        cuda_device, nh, d, h, w, n_txt, rope2d, int8_qk, int8_pv):
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d)
    n = q.shape[1]
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    tabs = (*tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img),
            *tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img))
    run = lambda: _int8_sm90_run(cuda_device, nh, d, q, k, v, tabs, scale,
                                 int8_qk, int8_pv)
    got = run()
    assert torch.equal(run(), got)  # no atomics: the same bits twice
    want = _int8_sm90_plain(nh, q, k, v, tabs, scale, int8_qk, int8_pv)
    # chip_smoke.py's K4_ATOL and K8_ATOL
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2,
                               rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk,int8_pv", INT8_SM90_VARIANTS)
@pytest.mark.parametrize("d", [16, 64])
def test_k4_k8b_rows_of_negative_scores_on_the_card(cuda_device, d, int8_qk,
                                                    int8_pv):
    # Every score of the even rows is far below 0 (q = -u against keys close
    # to u, norm weights of 4: scores ~ -16 sqrt(D) log2 e): a padded key of
    # the ragged last tile (300 keys: 44 in it), which scores 0, let into
    # the row max would underflow every p of the row (l = 0, no finite
    # output). The keys are close to one another, so the softmax of every
    # row is spread over many keys and one int8 level moves no output much.
    nh, n = 2, 300
    r = np.random.default_rng(d)
    u = r.standard_normal(d).astype(np.float32)
    k = (np.tile(u, (2, n, nh)) + 0.01 * r.standard_normal((2, n, nh * d))
         ).astype(np.float32)
    q = r.standard_normal((2, n, nh * d)).astype(np.float32)
    q[:, ::2] = -np.tile(u, nh) + 0.01 * r.standard_normal((n // 2, nh * d))
    v = r.standard_normal((2, n, nh * d)).astype(np.float32)
    ws = [4 * (1 + 0.01 * r.standard_normal(d)).astype(np.float32)
          for _ in range(4)]
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(None, n, d))
    tabs = (*tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n),
            *tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n))
    scale = d ** -0.5
    got = _int8_sm90_run(cuda_device, nh, d, q, k, v, tabs, scale, int8_qk,
                         int8_pv)
    assert torch.isfinite(got).all()
    want = _int8_sm90_plain(nh, q, k, v, tabs, scale, int8_qk, int8_pv)
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2,
                               rtol=0)


@pytest.mark.cuda
def test_k1_refuses_what_it_does_not_take(cuda_device):
    # fp16 (bf16 and fp32 have instances); a head dim of neither an
    # instance nor a padded one; fp32 under the int8 kernels
    q = torch.zeros(1, 8, 32, device=cuda_device, dtype=torch.float16)
    tab = torch.zeros(8, 16, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.fused_attention(q.float(), q.float(), q.float(), 2, tab, tab,
                            tab, tab, 0.25, int8_qk=True)
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
                     for n in (1, 63, 64, 65, 127, 128, 129, 255, 257, 4250)
                     if (1, 2, n, d) not in FLASH_SHAPES]
# the instances at head dims 16 and 128 (K6b's 32-row query tiles and K5's
# 64-key tiles at 128), at ragged lengths and over many tiles, and head dims
# padded to the next instance (48 -> 64, 8 -> 16, 100 -> 128)
FLASH_DIM_SHAPES = [(2, 3, 47, 16), (1, 2, 1025, 16), (2, 3, 47, 128),
                    (1, 2, 65, 128), (1, 2, 257, 128), (1, 3, 1178, 128),
                    (2, 3, 129, 48), (1, 2, 65, 8), (1, 2, 100, 100)]
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
@pytest.mark.parametrize("shape", FLASH_SHAPES + FLASH_TILE_SHAPES
                         + FLASH_DIM_SHAPES)
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
@pytest.mark.parametrize("shape", [(2, 3, 47, 32), (1, 2, 257, 64),
                                   (4, 19, 1178, 64), (1, 2, 257, 128)])
def test_k5_gives_the_same_bits_twice_and_reads_views_on_the_card(
        cuda_device, shape, monkeypatch):
    # no atomics: two runs give the same bits; (B, H, N, D) views of
    # (B, N, H, D) buffers, the training path's layout, go to the tensor
    # maps as they are (no copy) and give the bits of contiguous inputs
    q, k, v, _ = _flash_case(shape, cuda_device, seed=5)
    scale = shape[-1] ** -0.5
    runs = [tfl.flash_fwd(q, k, v, scale) for _ in range(2)]
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v)]
    readable, in_place = tfl._readable, []

    def spy(t):
        r = readable(t)
        in_place.append(r is t)
        return r
    monkeypatch.setattr(tfl, "_readable", spy)
    out_v, lse_v = tfl.flash_fwd(*views, scale)
    torch.cuda.synchronize()
    assert in_place == [True] * 3
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert torch.equal(runs[0][0], out_v) and torch.equal(runs[0][1], lse_v)
    assert out_v.transpose(1, 2).is_contiguous()  # a (B, N, H, D) buffer


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
    # fp16 (bf16 and fp32 have instances), dtypes that differ, a head dim
    # past the largest instance (any below it is padded)
    q = torch.zeros(1, 2, 8, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tfl.flash_attention(q, q, q, 0.2)
    with pytest.raises(TypeError, match="one dtype"):
        tfl.flash_fwd(q.float(), q.bfloat16(), q.float(), 0.2)
    qb = torch.zeros(1, 2, 8, 160, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="up to 128"):
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


# ---- fp32 instances, padded head dims, K7q / K8a ------------------------

# the fp32 kernels against their plain versions run in fp32 with TF32 off
# (cuBLAS's fp32 GEMM): 3xTF32 products keep ~21 bits, exp2f 2 ulp, sums in
# another order; measured well under the limit, which a single TF32 pass
# (~1e-3) or a dropped term exceeds by far
FP32_REL_L2 = 1e-5
# and the bf16 instance's error at the same shape (bf16 inputs, bf16 p and
# output, against the same fp32 plain version) is at least this many times
# larger
FP32_OVER_BF16 = 50


def _rel_l2(got, want):
    return ((got.double() - want.double()).norm() / want.double().norm()).item()


@pytest.fixture
def no_tf32():
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = old


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 47, 32), (1, 2, 300, 64),
                                   (1, 2, 129, 128), (2, 3, 65, 16),
                                   (1, 2, 100, 48), (1, 3, 1178, 64)])
def test_fp32_flash_kernels_match_plain_on_the_card(cuda_device, no_tf32,
                                                    shape):
    # K5F, K6AF, K6BF (3xTF32) against the fp32 plain versions; the bf16
    # kernels' error at the same shape is FP32_OVER_BF16 times larger
    q, k, v, do = (t.float() for t in _flash_case(shape, cuda_device, seed=7))
    q, k, v, do = (t + 1e-3 * torch.randn_like(t) for t in (q, k, v, do))
    scale = shape[-1] ** -0.5
    w_out, w_lse = tfl.flash_fwd_plain(q, k, v, scale)
    w_dq, w_delta = tfl.flash_dq_plain(q, k, v, w_out, do, w_lse, scale)
    w_dk, w_dv = tfl.flash_dkv_plain(q, k, v, do, w_lse, w_delta, scale)
    counts = lambda: [kk.launches for kk in (tfl.K5, tfl.K6A, tfl.K6B,
                                             tfl.K5F, tfl.K6AF, tfl.K6BF)]
    before = counts()
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(counts(), before)] == [0, 0, 0, 1, 1, 1]
    assert all(t.dtype == torch.float32 for t in (out, dq, dk, dv))
    errs = dict(out=_rel_l2(out, w_out), dq=_rel_l2(dq, w_dq),
                dk=_rel_l2(dk, w_dk), dv=_rel_l2(dv, w_dv))
    assert all(e <= FP32_REL_L2 for e in errs.values()), errs
    assert (lse - w_lse).abs().max().item() <= 1e-5
    assert (delta - w_delta).abs().max().item() <= 1e-5 * w_delta.abs().max().item() + 1e-6
    qb, kb, vb, dob = (t.bfloat16() for t in (q, k, v, do))
    bo, bl = tfl.flash_fwd(qb, kb, vb, scale)
    bdq, bdelta = tfl.flash_dq(qb, kb, vb, bo, dob, bl, scale)
    bdk, bdv = tfl.flash_dkv(qb, kb, vb, dob, bl, bdelta, scale)
    bf16 = dict(out=_rel_l2(bo, w_out), dq=_rel_l2(bdq, w_dq),
                dk=_rel_l2(bdk, w_dk), dv=_rel_l2(bdv, w_dv))
    for name in errs:
        assert errs[name] * FP32_OVER_BF16 <= bf16[name], (name, errs, bf16)


@pytest.mark.cuda
@pytest.mark.parametrize("streaming", [False, True])
@pytest.mark.parametrize("nh,d,h,w,n_txt,rope2d",
                         [ATTN_SHAPES[1], ATTN_SHAPES[3], ATTN_SHAPES[4],
                          (3, 8, 4, 5, 7, True)])
def test_fp32_k1_k7_match_plain_on_the_card(cuda_device, no_tf32, nh, d, h,
                                            w, n_txt, rope2d, streaming):
    # K1F / K7F: the fp32 prep and 3xTF32 attention against the fp32 plain
    # composition on the card; the bf16 kernel's error is FP32_OVER_BF16
    # times larger
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, rope2d,
                                                   seed=11)
    dev = cuda_device
    qf, kf, vf = (_t(a).to(dev) for a in (q, k, v))
    wt = [_t(a).to(dev) for a in ws]
    n = qf.shape[1]
    cos, sin = (torch.as_tensor(t, device=dev)
                for t in tfa.rope_row_tables(angles, n, d))
    cq, sq = tfa.fold_row_tables(cos, sin, wt[0], wt[1], n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, wt[2], wt[3], n_img)
    kern = tfa.K7F if streaming else tfa.K1F
    counts = lambda: {kk.name: kk.launches for kk in kernels.REGISTRY}
    before = counts()
    got = tfa.fused_attention(qf, kf, vf, nh, cq, sq, ck, sk, scale,
                              single_kv_max=0 if streaming else 2048)
    torch.cuda.synchronize()
    after = counts()
    assert {nm: after[nm] - before[nm] for nm in after
            if after[nm] != before[nm]} == {kern.name: 1}
    eps = float(torch.finfo(torch.float32).eps)
    want = tfa.composition(qf, kf, vf, cq, sq, ck, sk, scale, eps, eps, nh)
    err = _rel_l2(got, want)
    assert err <= FP32_REL_L2, err
    epsb = float(torch.finfo(torch.bfloat16).eps)
    bf = tfa.fused_attention(qf.bfloat16(), kf.bfloat16(), vf.bfloat16(), nh,
                             cq, sq, ck, sk, scale,
                             single_kv_max=0 if streaming else 2048)
    want_b = tfa.composition(qf, kf, vf, cq, sq, ck, sk, scale, epsb, epsb, nh)
    assert err * FP32_OVER_BF16 <= _rel_l2(bf, want_b), (err, _rel_l2(bf, want_b))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2, 4, 8])
@pytest.mark.parametrize("int8_qk,int8_pv", [(False, False), (True, False),
                                             (False, True)])
def test_head_dims_below_16_run_padded_on_the_card(cuda_device, d, int8_qk,
                                                   int8_pv):
    # the fused route takes every even head dim dividing 128: 2, 4 and 8 run
    # the D = 16 instances zero-padded, the prep's RMSNorm over the true
    # head dim; against the plain version on the same bf16 inputs
    q, k, v, ws, angles, n_img, scale = _attn_case(5, d, 6, 7, 9, d >= 4,
                                                   seed=d)
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    wt = [_t(a).to(dev) for a in ws]
    kern = tfa._INFERENCE.get((int8_qk, int8_pv, False), (tfa.K1,))[0]
    before = kern.launches
    got = tfa.fused_dual_flash_attention(qb, kb, vb, 5, *wt, angles, n_img,
                                         scale, int8_qk=int8_qk,
                                         int8_pv=int8_pv)
    torch.cuda.synchronize()
    assert kern.launches == before + 1
    assert got.shape == qb.shape
    n = q.shape[1]
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    cq, sq = tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img)
    ck, sk = tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img)
    eps = float(torch.finfo(torch.bfloat16).eps)
    plain = tfa.composition_int8_qk if int8_qk else tfa.composition
    kw = dict(int8_pv=True) if int8_pv else {}
    want = plain(*(t.cpu() for t in (qb, kb, vb)), cq, sq, ck, sk, scale, eps,
                 eps, 5, **kw)
    # chip_smoke.py's INT8_SAME_ROUNDING_ATOL: the plain version on the same
    # bf16 inputs; a mean over 16 values in place of d would be far off
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().numpy(), atol=1e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk,int8_pv,streaming", [
    (True, False, True), (False, True, False), (True, True, False)])
def test_k7q_k8a_give_the_same_bits_twice_on_the_card(cuda_device, int8_qk,
                                                      int8_pv, streaming):
    # no atomics: every output element is summed by one thread in one order
    q, k, v, ws, angles, n_img, scale = _attn_case(*ATTN_SHAPES[3], seed=5)
    dev = cuda_device
    qb, kb, vb = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    n = q.shape[1]
    cos, sin = (torch.as_tensor(t, device=dev)
                for t in tfa.rope_row_tables(angles, n, 32))
    wt = [_t(a).to(dev) for a in ws]
    tabs = (*tfa.fold_row_tables(cos, sin, wt[0], wt[1], n_img),
            *tfa.fold_row_tables(cos, sin, wt[2], wt[3], n_img))
    runs = [tfa.fused_attention(qb, kb, vb, 5, *tabs, scale, int8_qk=int8_qk,
                                int8_pv=int8_pv,
                                single_kv_max=0 if streaming else 2048)
            for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(*runs)
