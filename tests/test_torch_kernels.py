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
    ("xquant_kernel<2, __nv_bfloat16>(__nv_bfloat16 const*)", "K2"),
    ("xquant_kernel<3, float>(float const*)", "K3"),
    ("w3_sm90_kernel<256, 9, float>(CUtensorMap_st)", "K9"),
    ("void (anonymous namespace)::w3_sm90_kernel<512, 2, __nv_bfloat16>("
     "CUtensorMap_st)", "K2"),
    ("dense_sm90_kernel<11, false, float>(CUtensorMap_st)", "K10b"),
    ("prep_q8rows_kernel<64, 7, __nv_bfloat16>(__nv_bfloat16 const*)", "K7q"),
    ("prep_q8rows_kernel<64, 4, float>(float const*)", "K4"),
    ("k_prep_kernel<64, true, float>(float const*)", "K4"),
    ("attn_q8_fp32_kernel<64, true, false>(void const*)", "fp32 attention"),
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
              tfa.K1F, tfa.K7F, tfl.K5F, tfl.K6AF, tfl.K6BF, tfa.K4F,
              tfa.K7QF, tfa.K8AF, tfa.K8BF, tfm.K2F, tfm.K3F, tfm.K9F,
              tfd.K10AF, tfd.K10BF, tfl.K5W, tfl.K6AW, tfl.K6BW, tfl.K5WF,
              tfl.K6AWF, tfl.K6BWF, tfa.K1W, tfa.K1WF, tfa.K7W, tfa.K7WF,
              tfa.K4W, tfa.K4WF, tfa.K7QW, tfa.K7QWF, tfa.K8AW, tfa.K8AWF,
              tfa.K8BW, tfa.K8BWF, tfa.K1_256, tfa.K7_256, tfa.K4_256,
              tfa.K7Q_256, tfa.K8A_256, tfa.K8B_256, tfl.K5_256,
              *tfa._D384.values(), *tfa._D512.values(), tfl.K5_384,
              tfl.K5_512, tfl.K6A_256, tfl.K6B_256, *tfa._D768.values(),
              *tfa._D1024.values(), tfl.K5_768, tfl.K5_1024):
        assert k in kernels.REGISTRY
        src = (kernels.CSRC_DIR / k.source).read_text()
        assert f'extern "C" int {k.symbol}(' in src, k.name


def test_wide_kernels_shared_memory_does_not_grow_with_the_head_dim():
    # past head dim 128 one set of instances serves every multiple of 128:
    # no template argument is a head dim, and their shared memory is sized
    # by the 128-wide chunk alone (csrc/attention_fp32.cu)
    src = (kernels.CSRC_DIR / "attention_fp32.cu").read_text()
    for fn, params in (("wide_attn_kernel", "typename T, bool QK8, bool PV8"),
                       ("wide_dq_kernel", "typename T"),
                       ("wide_dkv_kernel", "typename T"),
                       ("wide_prep_kernel", "typename T, bool Q8"),
                       ("wide_v_quant_kernel", "typename T")):
        m = re.search(r"template <([^>]*)>\n__global__ void "
                      rf"__launch_bounds__\([^)]*\)\s*{fn}\(", src)
        assert m and m.group(1) == params, fn
    smem = src[src.index("struct WideSmem"):]
    smem = smem[:smem.index("};")]
    assert "template <bool QK8, bool PV8>" in src[:src.index("struct WideSmem")][-40:]
    assert " D" not in smem.replace("WLDA", "").replace("WLDB", "")
    for name in ("WIDE_DQ_SMEM", "WIDE_DKV_SMEM"):
        line = src[src.index(f"constexpr int {name}"):].splitlines()[0]
        assert "D " not in line and "D)" not in line, line
    for d, want in ((48, 64), (160, 256), (192, 256), (256, 256),
                    (300, 384), (384, 384), (512, 512)):
        assert tfl.instance_dim(d) == want


# ---- the head-dim-256 instances' shared memory, from their sources -------

_C_TOKEN = re.compile(r"\s*(\d+|[A-Za-z_]\w*|::|==|!=|<=|>=|&&|\|\||[-+*/%<>?:()!,])")


class _CSource:
    """The `constexpr int` globals and the `static constexpr int / bool`
    members of the template structs of some csrc/ sources, evaluated as
    their compiler would: a struct instance's members from its template
    arguments, its base's and its `using` aliases'."""

    def __init__(self, *names):
        self.glob, self.structs = {}, {}
        for name in names:
            src = (kernels.CSRC_DIR / name).read_text()
            for m in re.finditer(r"^constexpr int (\w+) = ([^;]+);", src,
                                 re.M):
                self.glob[m.group(1)] = m.group(2)  # evaluated when read
            for m in re.finditer(r"^template <([^>]*)>\nstruct (\w+)"
                                 r"(?: : (\w+)<([^>]*)>)? \{\n(.*?)^\};",
                                 src, re.M | re.S):
                params = [re.sub(r"\s*=.*", "", a).split()[-1]
                          for a in m.group(1).split(",")]
                self.structs[m.group(2)] = (params, m.group(3), m.group(4),
                                            m.group(5))

    def instance(self, name, *args):
        params, base, base_args, body = self.structs[name]
        assert len(args) == len(params), (name, args)
        env = dict(zip(params, args))
        members = {}
        if base:
            members.update(self.instance(base, *(
                self.eval(a, env) for a in base_args.split(","))))
        env.update(members)
        for m in re.finditer(r"(?:using (\w+) = (\w+)<([^>]*)>;)|"
                             r"(?:static constexpr (?:int|bool) (\w+) =\s*"
                             r"([^;]+);)", body):
            if m.group(1):
                inst = self.instance(m.group(2), *(
                    self.eval(a, env) for a in m.group(3).split(",")))
                env.update({f"{m.group(1)}::{k}": v for k, v in inst.items()})
            else:
                env[m.group(4)] = members[m.group(4)] = self.eval(m.group(5),
                                                                  env)
        return members

    def eval(self, text, env):
        toks = _C_TOKEN.findall(text)
        pos = [0]
        peek = lambda: toks[pos[0]] if pos[0] < len(toks) else None

        def take(t=None):
            tok = toks[pos[0]]
            assert t is None or tok == t, (tok, t, text)
            pos[0] += 1
            return tok

        def primary(no_gt):
            tok = take()
            if tok == "(":
                v = expr(False)
                take(")")
                return v
            if tok.isdigit():
                return int(tok)
            if tok in ("true", "false"):
                return tok == "true"
            if tok in self.structs and peek() == "<":
                take("<")
                args = [binary(0, True)]
                while peek() == ",":
                    take(",")
                    args.append(binary(0, True))
                take(">")
                take("::")
                return self.instance(tok, *args)[take()]
            if peek() == "::":
                take("::")
                tok = f"{tok}::{take()}"
            return env[tok] if tok in env else self.eval(self.glob[tok], {})

        def unary(no_gt):
            if peek() == "!":
                take()
                return not unary(no_gt)
            if peek() == "-":
                take()
                return -unary(no_gt)
            return primary(no_gt)

        levels = [("||",), ("&&",), ("==", "!="), ("<", ">", "<=", ">="),
                  ("+", "-"), ("*", "/", "%")]
        ops = {"||": lambda a, b: a or b, "&&": lambda a, b: a and b,
               "==": lambda a, b: a == b, "!=": lambda a, b: a != b,
               "<": lambda a, b: a < b, ">": lambda a, b: a > b,
               "<=": lambda a, b: a <= b, ">=": lambda a, b: a >= b,
               "+": lambda a, b: a + b, "-": lambda a, b: a - b,
               "*": lambda a, b: a * b, "/": lambda a, b: a // b,
               "%": lambda a, b: a % b}

        def binary(level, no_gt):
            if level == len(levels):
                return unary(no_gt)
            v = binary(level + 1, no_gt)
            while peek() in levels[level] and not (no_gt and peek() == ">"):
                op = take()
                v = ops[op](v, binary(level + 1, no_gt))
            return v

        def expr(no_gt):
            cond = binary(0, no_gt)
            if peek() != "?":
                return cond
            take("?")
            a = expr(no_gt)
            take(":")
            b = expr(no_gt)
            return a if cond else b

        v = expr(False)
        assert pos[0] == len(toks), text
        return int(v)


SMEM_PER_BLOCK = 232448  # the H100's opt-in limit of one block (227 KB)
D256_INSTANCES = [
    *[("attention_sm90.cu", "Sm90", sm) for sm in ("Bounded", "Online",
                                                   "Flash")],
    *[("attention_int8_sm90.cu", "SmemI8", flags) for flags in (
        (1, 0, 1), (1, 0, 0), (0, 1, 1), (1, 1, 1), (0, 1, 0), (1, 1, 0))]]


@pytest.mark.parametrize("source,struct,variant", D256_INSTANCES)
def test_head_dim_256_instances_fit_in_shared_memory(source, struct,
                                                     variant):
    # the wgmma kernels' D = 256 instances (K1, K7, K5; K4, K7q, K8a over
    # both scores, K8b over both): the shared memory their launches ask for,
    # from the source's own constants and struct members, within one
    # block's limit, and an instance of each behind its dispatch
    src = (kernels.CSRC_DIR / source).read_text()
    c = _CSource("sm90.cuh", source)
    if struct == "Sm90":
        # every softmax takes WIDE_KEY_TILE-key tiles at D = 256
        assert re.search(r"return D == 256 \? WIDE_KEY_TILE", src)
        kt = c.eval("WIDE_KEY_TILE", {})
        smem = c.instance("Sm90", 256, kt)
        assert smem["STAGES"] >= 2
        assert "case 256: return launch_sm90<256, SM>(a);" in src
        assert "case 256: return launch_flash<256>(" in src
    else:
        smem = c.instance("SmemI8", 256, *map(bool, variant))
        assert smem["KST"] >= 2 and smem["VST"] >= 1
        assert ("case 256: return launch_int8<256, QK8, PV8, TWO_PASS>(a);"
                in src)
    assert smem["BYTES"] <= SMEM_PER_BLOCK, (variant, smem)
    assert "static_assert(BYTES <= 232448" in src
    # the same evaluation gives what the instances up to 128 have run with
    if struct == "Sm90":
        assert c.instance("Sm90", 64, 128)["STAGES"] == 4
        assert c.instance("Sm90", 128, 128)["STAGES"] == 3
    else:
        small = c.instance("SmemI8", 128, *map(bool, variant))
        assert small["KST"] == small["VST"] == 3


@pytest.mark.parametrize("d", [384, 512])
@pytest.mark.parametrize("source,struct,variant", D256_INSTANCES)
def test_head_dim_384_512_instances_fit_in_shared_memory(source, struct,
                                                         variant, d):
    # the wgmma kernels' D = 384 and 512 instances (K1, K7, K5; K4, K7q, K8a
    # over both scores, K8b over both): each consumer one slice of half the
    # output's columns (the registers of one wgmma's accumulator, at most
    # 256), the scores over the whole head; the shared memory their
    # launches ask for, from the source's own constants and struct members,
    # within one block's limit, with K / V rings of two stages or more
    # (the int8 kernel's K ring in sub-tiles where a whole-head bf16 tile
    # does not fit twice: at least a 128-key tile's worth), and an instance
    # of each behind its dispatch
    src = (kernels.CSRC_DIR / source).read_text()
    c = _CSource("sm90.cuh", source)
    if struct == "Sm90":
        kt = c.eval("SLICE_KEY_TILE", {})
        assert re.search(r": D > 256 \? SLICE_KEY_TILE", src)
        # 64-row items whose two consumers share one q^ tile and V tiles of
        # the whole head, each writing one slice of the columns
        smem = c.instance("Sm90", d, kt)
        assert smem["SLICED"] and smem["ROWS"] == 64 and smem["Q_TILES"] == 1
        assert smem["STAGES"] >= 2 and smem["DV"] == d // 2
        assert smem["KV_TILE"] == kt * d * 2
        assert f"case {d}: return launch_sm90<{d}, SM>(a);" in src
        assert f"case {d}: return launch_flash<{d}>(" in src
    else:
        smem = c.instance("SmemI8", d, *map(bool, variant))
        assert smem["DV"] == d // 2
        assert smem["KST"] * smem["KSUB"] >= 64 and smem["KST"] >= 2
        assert smem["VST"] >= 1 and 128 % smem["KSUB"] == 0
        assert (f"case {d}: return launch_int8<{d}, QK8, PV8, TWO_PASS>(a);"
                in src)
    assert smem["BYTES"] <= SMEM_PER_BLOCK, (variant, smem)
    # the D = 256 instances keep their one slice of every column
    assert c.instance(struct, 256, *((c.eval("WIDE_KEY_TILE", {}),)
                                     if struct == "Sm90"
                                     else map(bool, variant)))["DV"] == 256


@pytest.mark.parametrize("d", [768, 1024])
@pytest.mark.parametrize("source,struct,variant", D256_INSTANCES)
def test_head_dim_768_1024_instances_fit_in_shared_memory(source, struct,
                                                          variant, d):
    # the wgmma kernels' D = 768 and 1024 instances (K1, K7, K5; K4, K7q,
    # K8a over both scores, K8b over both): four column slices of D / 4
    # (the registers of one wgmma's accumulator), a CTA's two consumers on
    # the same 64 query rows writing one pair of them, the pair a grid
    # dimension, and the V stages holding the pair's columns; K1 / K7 / K5
    # on 64-key tiles whose K comes in chunks of 128 values of the head (at
    # 768 the scores computed by one consumer and handed over), the
    # int8 kernels on 128-key tiles whose K comes in chunks of 128 bytes of
    # the head (bf16 V in 32-key sub-tiles); the
    # shared memory their launches ask for, from the source's own constants
    # and struct members, within one block's limit, and an instance of each
    # behind its dispatch
    src = (kernels.CSRC_DIR / source).read_text()
    c = _CSource("sm90.cuh", source)
    assert "static_assert(BYTES <= 232448" in src
    if struct == "Sm90":
        kt = c.eval("PAST_512_KEY_TILE", {})
        assert kt == tfa.K7_KEY_TILE_1024 == 64
        assert re.search(r": D > 512 \? PAST_512_KEY_TILE", src)
        smem = c.instance("Sm90", d, kt)
        assert smem["SLICED"] and smem["CHUNKED"] and smem["PAIRS"] == 2
        assert smem["ROWS"] == 64 and smem["Q_TILES"] == 1
        assert smem["DV"] == d // 4 and smem["VCOLS"] == d // 2
        assert smem["KCOLS"] == c.eval("K_CHUNK", {}) == 128
        assert smem["KV_TILE"] == kt * 128 * 2
        assert smem["V_TILE"] == smem["VSUB"] * d // 2 * 2
        assert smem["VSUB"] == 32 and kt // smem["VSUB"] <= smem["V_STAGES"]
        assert smem["STAGES"] >= 2 and smem["V_STAGES"] >= 2
        # at 768 consumer 0 alone computes S and hands p to consumer 1
        # through an exchange in shared memory; at 1024 both compute S
        assert smem["SHARED_S"] == (d == 768)
        assert (smem["X_TILE"] > 0) == (d == 768)
        assert f"case {d}: return launch_sm90<{d}, SM>(a);" in src
        assert f"case {d}: return launch_flash<{d}>(" in src
    else:
        smem = c.instance("SmemI8", d, *map(bool, variant))
        assert smem["PAIRED"] and smem["ROWS"] == 64 and smem["Q_TILES"] == 1
        assert smem["DV"] == d // 4 and smem["VCOLS"] == d // 2
        # whole 128-key tiles, K in chunks of 128 bytes of each row
        assert smem["KSUB"] == 128 and smem["KCOLS"] == 128
        assert smem["KCH"] == d * (1 if variant[0] else 2) // 128
        assert smem["K_TILE"] == 128 * 128
        assert smem["KST"] >= 2 and smem["VST"] >= 1
        assert 128 % smem["VSUB"] == 0
        if smem["VSUB"] < 128:  # V sub-tiles: one read, one landing
            assert smem["VST"] >= 2
        assert (f"case {d}: return launch_int8<{d}, QK8, PV8, TWO_PASS>(a);"
                in src)
    assert smem["BYTES"] <= SMEM_PER_BLOCK, (variant, smem)
    # the instances up to 512 keep their layouts
    if struct == "Sm90":
        assert not c.instance("Sm90", 512, c.eval("SLICE_KEY_TILE", {}))[
            "CHUNKED"]
    else:
        assert not c.instance("SmemI8", 512, *map(bool, variant))["PAIRED"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d", [64, 128, 160, 192, 256, 300, 384, 512, 640,
                               700, 768, 896, 1000, 1024, 1152])
def test_attention_routes_by_dtype_and_head_dim(d, dtype):
    # (dtype, head dim) -> the kernel each entry point launches: up to 128
    # the wgmma kernels (fp32: their F instances); bf16 at 129-256 (padded
    # to 256), 257-384, 385-512, 513-768 and 769-1024 the wgmma kernels' D
    # = 256, 384, 512, 768 and 1024 instances, counted apart, from the same
    # sources and entry points; past 1024 in bf16, and past 128 in fp32, the
    # wide mma.sync instances of attention_fp32.cu; the flash backward in
    # bf16 at 129-256, 257-384 and 385-512 the wgmma backward's D = 256, 384
    # and 512 instances (K6A_256 .. K6B_512), past 512 the wide mma.sync
    # ones
    fp32 = dtype == torch.float32
    dp = tfl.instance_dim(d)
    fwd_dp = tfl.forward_dim(d, dtype)
    assert fwd_dp == (dp if fp32 or not 512 < d <= 1024
                      else 768 if d <= 768 else 1024)
    bases = (tfa.K1, tfa.K7, tfa.K4, tfa.K7Q, tfa.K8A, tfa.K8B)
    sets = {256: tfa._D256, 384: tfa._D384, 512: tfa._D512, 768: tfa._D768,
            1024: tfa._D1024}
    for base in bases:
        kern = tfa.kernel_for(base, dtype, d)
        if dp <= 128:
            assert kern is (tfa._FP32[base] if fp32 else base)
        elif fwd_dp in sets and not fp32:
            dp_k = fwd_dp
            assert kern is sets[dp_k][base]
            assert (kern.source, kern.symbol) == (base.source, base.symbol)
            assert kern.name == f"{base.name}_{dp_k}"
            assert kern.source in ("attention_sm90.cu",
                                   "attention_int8_sm90.cu")
        else:
            assert kern is tfa._WIDE[base][fp32]
            assert kern.source == "attention_fp32.cu"
    fwd, dq, dkv = (tfl.flash_kernel(w, dtype, d) for w in ("fwd", "dq",
                                                            "dkv"))
    if dp <= 128:
        want = (tfl.K5F, tfl.K6AF, tfl.K6BF) if fp32 else (tfl.K5, tfl.K6A,
                                                           tfl.K6B)
    elif fp32:
        want = (tfl.K5WF, tfl.K6AWF, tfl.K6BWF)
    elif dp == 256:
        want = (tfl.K5_256, tfl.K6A_256, tfl.K6B_256)
    elif dp == 384:
        want = (tfl.K5_384, tfl.K6A_384, tfl.K6B_384)
    elif dp == 512:
        want = (tfl.K5_512, tfl.K6A_512, tfl.K6B_512)
    elif fwd_dp == 768:
        want = (tfl.K5_768, tfl.K6AW, tfl.K6BW)
    elif fwd_dp == 1024:
        want = (tfl.K5_1024, tfl.K6AW, tfl.K6BW)
    else:
        want = (tfl.K5W, tfl.K6AW, tfl.K6BW)
    assert (fwd, dq, dkv) == want
    for k5 in (tfl.K5_256, tfl.K5_384, tfl.K5_512, tfl.K5_768,
               tfl.K5_1024):
        assert (k5.source, k5.symbol) == (tfl.K5.source, tfl.K5.symbol)
    for e in tfl.WGMMA_PAST_128:
        for small in (tfl.K6A, tfl.K6B):
            k6 = tfl._WGMMA["dq" if small is tfl.K6A else "dkv"][e]
            assert (k6.source, k6.symbol) == (small.source, small.symbol)
            assert k6.name == f"{small.name}_{e}"
    # the mma.sync backward keeps bf16 past 512 and fp32 only
    assert (dq.source == "attention_fp32.cu") == (fp32 or dp > 512)
    assert tfl.K5.source == "attention_sm90.cu"
    # the key tile the plain version must take to meet the card's K7
    tile = tfa.stream_key_tile(False, False, d)
    assert tile == (tfa.K7_KEY_TILE_256 if dp == 256
                    else tfa.K7_KEY_TILE_512 if dp in (384, 512)
                    else tfa.K7_KEY_TILE_1024 if 512 < d <= 1024
                    else tfa.K7_KEY_TILE)
    assert tfa.stream_key_tile(True, False, d) == tfa.K7Q_KEY_TILE
    assert tfa.stream_key_tile(False, True, d) == tfa.K8B_KEY_TILE


@pytest.mark.parametrize("d", tfl.WGMMA_PAST_128)
@pytest.mark.parametrize("struct", ["DqSmem", "DkvSmem"])
def test_head_dim_256_backward_fits_in_shared_memory(struct, d):
    # K6A_256 / K6B_256 and, past 256, K6A_384 .. K6B_512, the wgmma
    # backward's bf16 instances past head dim 128: the shared memory their
    # launches ask for, from the source's own constants and struct members,
    # within one block's limit, each behind its dispatch; the layouts of the
    # instances up to 128 as they have run
    src = (kernels.CSRC_DIR / tfl.K6A.source).read_text()
    c = _CSource("sm90.cuh", tfl.K6A.source)
    smem = c.instance(struct, d)
    assert smem["BYTES"] <= SMEM_PER_BLOCK, smem
    assert smem["STAGES"] >= 2
    assert "static_assert(BYTES <= 232448" in src
    if struct == "DqSmem":
        assert f"case {d}: return launch_dq<{d}>(" in src
        if d == 256:
            # 32-key tiles; the arithmetic waits for dQ of the tile before
            assert smem["KEY_TILE"] == 32 and not smem["OVERLAP"]
            assert not smem["SLICED"] and smem["X_TILE"] == 0
            assert smem["K_STAGES"] == smem["STAGES"] == 3
        else:
            # 64-row items on both consumers, each summing one of two
            # column slices of dq, with one q and one dO tile, three k and
            # two v stages, and the fp32 tiles they exchange in a v stage
            assert smem["SLICED"] and smem["ITEM"] == 64 and smem["OVERLAP"]
            assert smem["Q_TILES"] == 1 and smem["DV"] == d // 2
            assert smem["KEY_TILE"] == {384: 32, 512: 16}[d]
            assert (smem["K_STAGES"], smem["STAGES"]) == (3, 2)
            assert smem["X_TILE"] == 64 * smem["KEY_TILE"] * 4
            assert 2 * smem["X_TILE"] <= smem["KV_TILE"]
            assert smem["BAR"] == smem["V"] + 2 * smem["KV_TILE"]
        for e, kt in ((16, 64), (32, 64), (64, 64), (128, 32)):
            small = c.instance(struct, e)
            assert (small["KEY_TILE"], small["STAGES"], small["OVERLAP"]) \
                == (kt, 4, True)
            assert small["K_STAGES"] == 4 and small["X_TILE"] == 0
            assert not small["SLICED"] and small["ITEM"] == 128
    else:
        # 64-row items on both consumers, split by gradient, with two p^T
        # buffers of a query tile in fp32; past 256 each item one of two
        # column slices of dk and dv
        cfg = c.instance("DkvCfg", d)
        assert smem["SPLIT"] and cfg["ITEM"] == 64 and smem["KV_TILES"] == 1
        assert smem["P_TILE"] == 64 * smem["Q_TILE"] * 4
        assert (cfg["DV"], cfg["SLICES"]) == ((d, 1) if d == 256
                                              else (d // 2, 2))
        assert smem["Q_TILE"] == {256: 64, 384: 32, 512: 16}[d]
        assert f"case {d}: return launch_dkv<{d}>(" in src
        for e, qt in ((16, 64), (32, 64), (64, 64), (128, 32)):
            small = c.instance(struct, e)
            assert not small["SPLIT"] and small["P_TILE"] == 0
            assert (small["Q_TILE"], small["STAGES"], small["KV_TILES"]) == (
                qt, 4, 2)
            assert c.instance("DkvCfg", e)["ITEM"] == 128
            assert c.instance("DkvCfg", e)["SLICES"] == 1


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
    # mma.sync source it had is gone; head dims 256, 384 and 512 in bf16 are
    # instances of the same kernel (K5_256, K5_384, K5_512); past 512, and
    # fp32 past 128, the shared-memory kernel of attention_fp32.cu (K5W,
    # K5WF)
    assert tfl.K5.source == tfa.K1.source == tfa.K7.source
    src = (kernels.CSRC_DIR / tfl.K5.source).read_text()
    entry = src[src.index('extern "C" int sd3_flash_attention_fwd('):]
    for d in (*tfl.HEAD_DIMS, *tfl.WGMMA_PAST_128, *tfl.WGMMA_PAST_512):
        assert f"launch_flash<{d}>" in entry, d
    assert "launch_flash<640>" not in entry
    for k5 in (tfl.K5_256, tfl.K5_384, tfl.K5_512, tfl.K5_768, tfl.K5_1024):
        assert k5.source == tfl.K5.source
        assert k5.symbol == tfl.K5.symbol
    assert tfl.K5W.source == "attention_fp32.cu"
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
                 "encode_s8_2d", "setmaxnreg_inc", "launch_xquant<V, T>"):
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
    # P.V over one slice's DV columns (192 at D = 384) and S over K
    # sub-tiles of KSUB keys
    assert "wgmma.mma_async.sync.aligned.m64n192k32.s32.s8.s8" in hdr
    assert "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16" in hdr
    for used in ("wgmma_s8<KSUB>", "wgmma_s8_rs<DV>", "wgmma_rs<DV>",
                 "wgmma_ss<KSUB>", "tma_load_4d", "tma_load_2d",
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
    ("K7Q_KEY_TILE", "attention_int8_sm90.cu", "KEY_TILE"),
    ("K7_KEY_TILE_256", "attention_sm90.cu", "WIDE_KEY_TILE"),
    ("K7_KEY_TILE_512", "attention_sm90.cu", "SLICE_KEY_TILE")])
def test_key_tiles_match_their_sources(const, source, name):
    # the plain versions' block_k that the card comparisons take is the
    # kernel's own key tile: K1 / K7's (at head dim 256 WIDE_KEY_TILE, at
    # 384 and 512 SLICE_KEY_TILE), and
    # K4 / K8a / K7q / K8b's at every head dim (the int8 V^T of K8a and K8b
    # is padded to it)
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
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfm.swiglu_int8(t["x"].half(), *w, h_group=128)
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
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfd.qkv_adaln_int8(t["x"].half(), t["shift"], t["scale"], *ws)
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
    with pytest.raises(TypeError, match="bfloat16 or float32"):
        tfm.swiglu_int8_tail3d(m["x"].half(), m["shift"], m["scale"],
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
    # fp16 (bf16 and fp32 have instances, the int8 kernels too); dtypes that
    # differ; heads of an odd head dim (the rotation takes pairs). Every even
    # head dim runs (test_fused_attention_past_head_dim_128_on_the_card)
    q = torch.zeros(1, 8, 32, device=cuda_device, dtype=torch.float16)
    tab = torch.zeros(8, 16, device=cuda_device)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25)
    with pytest.raises(TypeError, match="bfloat16"):
        tfa.fused_attention(q, q, q, 2, tab, tab, tab, tab, 0.25,
                            int8_qk=True)
    with pytest.raises(TypeError, match="one dtype"):
        tfa.fused_attention(q.float(), q.bfloat16(), q.float(), 2, tab, tab,
                            tab, tab, 0.25, int8_qk=True)
    qo = torch.zeros(1, 8, 30, device=cuda_device, dtype=torch.bfloat16)
    tab = torch.zeros(8, 15, device=cuda_device)
    with pytest.raises(ValueError, match="even head dim"):
        tfa.fused_attention(qo, qo, qo, 2, tab, tab, tab, tab, 0.25)


# head dims the fused route pads (48 -> 64, 96 -> 128, 192 -> 256) or runs
# on the instances past 128 (256, 384, 512; 640 past the wgmma ones);
# (heads, head dim, image h, w, text tokens): ragged lengths, a last key
# tile of few keys, at 384 and 512 also two 128-key tiles (176 tokens)
WIDE_ATTN_SHAPES = [(3, 48, 5, 7, 9), (2, 96, 6, 6, 5), (2, 192, 8, 8, 11),
                    (2, 256, 10, 13, 20), (2, 384, 7, 9, 4),
                    (1, 384, 12, 13, 20), (2, 512, 6, 7, 3),
                    (1, 512, 12, 13, 20), (1, 640, 5, 6, 7)]
# (int8_qk, int8_pv, streaming): K1, K7, K4, K7q, K8a over K1 / K4, K8b
# over K7 / K7q
WIDE_VARIANTS = [(False, False, False), (False, False, True),
                 *sorted(tfa._INFERENCE)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("int8_qk,int8_pv,streaming", WIDE_VARIANTS)
@pytest.mark.parametrize("nh,d,h,w,n_txt", WIDE_ATTN_SHAPES)
def test_fused_attention_past_head_dim_128_on_the_card(
        cuda_device, no_tf32, nh, d, h, w, n_txt, int8_qk, int8_pv,
        streaming, dtype):
    # every fused kernel at head dims JAX's fused attention takes past the
    # dividers of 128, against its plain version on the same inputs, in
    # its family's limits: bf16 ATTN_ATOL (float P.V over float scores),
    # K4_ATOL / K8_ATOL (int8 scores or int8 P.V); fp32 FP32_REL_L2 (float)
    # and INT8_FP32_* (int8)
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, True,
                                                   seed=d)
    dev = cuda_device
    n = q.shape[1]
    qd, kd, vd = (_t(a).to(dev, dtype) for a in (q, k, v))
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    tabs = (*tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img),
            *tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img))
    base = tfa._INFERENCE.get((int8_qk, int8_pv, streaming),
                              (tfa.K7 if streaming else tfa.K1,))[0]
    fp32 = dtype == torch.float32
    # bf16 up to 1024: the wgmma kernels (D 256, 384, 512, 768, 1024: their
    # instances there); past it, and fp32 past 128, the wide mma.sync
    # instances
    kern = tfa.kernel_for(base, dtype, d)
    if not fp32 and d <= 1024:
        assert kern.source in ("attention_sm90.cu", "attention_int8_sm90.cu")
    else:
        assert kern.source == "attention_fp32.cu"
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    got = tfa.fused_attention(qd, kd, vd, nh, *(t.to(dev) for t in tabs),
                              scale, int8_qk=int8_qk, int8_pv=int8_pv,
                              single_kv_max=0 if streaming else 2048)
    torch.cuda.synchronize()
    assert _launched(before) == {kern.name: 1}
    assert got.dtype == dtype and got.shape == qd.shape
    eps = float(torch.finfo(dtype).eps)
    ins = [t.float().cpu() for t in (qd, kd, vd)] + [*tabs, scale, eps, eps,
                                                    nh]
    kw = dict(int8_pv=True) if int8_pv else {}
    if streaming:  # the kernels' key tiles
        kw["block_k"] = (tfa.K8B_KEY_TILE if fp32
                         else tfa.stream_key_tile(int8_qk, int8_pv, d))
        plain = (tfa.composition_stream_int8_qk if int8_qk
                 else tfa.composition_stream)
    else:
        plain = tfa.composition_int8_qk if int8_qk else tfa.composition
    want = plain(*ins, **kw)
    got = got.float().cpu()
    if not fp32:
        atol = 3e-2 if (int8_qk or int8_pv) else 1e-2
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=atol,
                                   rtol=0)
    elif int8_qk or int8_pv:
        max_rel = ((got - want).abs().max() / want.abs().max()).item()
        assert max_rel <= INT8_FP32_MAX_REL and _rel_l2(got, want) <= \
            INT8_FP32_REL_L2, (max_rel, _rel_l2(got, want))
    else:
        assert _rel_l2(got, want) <= FP32_REL_L2, _rel_l2(got, want)


# bf16 head dims past 512 on the wgmma kernels' D = 768 and 1024 instances
# (K1_768 .. K8B_1024): 640 and 768 (768), 1000 and 1024 (1024), one head
# each, at ragged lengths (a last key tile of few keys; two 128-key tiles
# past 128 tokens), and past 1024 the wide mma.sync instances (1152)
PAST_512_SHAPES = [(1, 640, 5, 6, 7), (1, 768, 6, 7, 3), (1, 1000, 7, 9, 4),
                   (1, 1024, 12, 13, 20), (1, 1152, 5, 6, 7)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8_qk,int8_pv,streaming", WIDE_VARIANTS)
@pytest.mark.parametrize("nh,d,h,w,n_txt", PAST_512_SHAPES)
def test_fused_attention_past_head_dim_512_on_the_card(
        cuda_device, nh, d, h, w, n_txt, int8_qk, int8_pv, streaming):
    # every fused kernel on bf16 at head dims past 512, padded to the wgmma
    # kernels' D = 768 / 1024 instances (past 1024 the wide ones), against
    # its plain version on the same inputs within its family's limit (bf16
    # 1e-2, int8 3e-2), the same bits from two calls, and the plain version
    # at twice the scale, a control that must miss the limit
    q, k, v, ws, angles, n_img, scale = _attn_case(nh, d, h, w, n_txt, True,
                                                   seed=d)
    dev = cuda_device
    n = q.shape[1]
    qd, kd, vd = (_t(a).to(dev, torch.bfloat16) for a in (q, k, v))
    cos, sin = (torch.as_tensor(t) for t in tfa.rope_row_tables(angles, n, d))
    tabs = (*tfa.fold_row_tables(cos, sin, _t(ws[0]), _t(ws[1]), n_img),
            *tfa.fold_row_tables(cos, sin, _t(ws[2]), _t(ws[3]), n_img))
    base = tfa._INFERENCE.get((int8_qk, int8_pv, streaming),
                              (tfa.K7 if streaming else tfa.K1,))[0]
    kern = tfa.kernel_for(base, torch.bfloat16, d)
    dp = tfl.forward_dim(d, torch.bfloat16)
    if d <= 1024:
        assert kern is tfa._WGMMA_PAST_128[dp][base]
        assert kern.name == f"{base.name}_{dp}" and dp in (768, 1024)
    else:
        assert kern is tfa._WIDE[base][0]
    run = lambda s: tfa.fused_attention(
        qd, kd, vd, nh, *(t.to(dev) for t in tabs), s, int8_qk=int8_qk,
        int8_pv=int8_pv, single_kv_max=0 if streaming else 2048)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    got = run(scale)
    again = run(scale)
    torch.cuda.synchronize()
    assert _launched(before) == {kern.name: 2}
    assert torch.equal(got, again)
    assert got.dtype == torch.bfloat16 and got.shape == qd.shape
    eps = float(torch.finfo(torch.bfloat16).eps)
    ins = [t.float().cpu() for t in (qd, kd, vd)] + [*tabs]
    kw = dict(int8_pv=True) if int8_pv else {}
    if streaming:  # the kernels' key tiles
        kw["block_k"] = tfa.stream_key_tile(int8_qk, int8_pv, d)
        plain = (tfa.composition_stream_int8_qk if int8_qk
                 else tfa.composition_stream)
    else:
        plain = tfa.composition_int8_qk if int8_qk else tfa.composition
    want = plain(*ins, scale, eps, eps, nh, **kw)
    control = plain(*ins, 2 * scale, eps, eps, nh, **kw)
    got = got.float().cpu()
    atol = 3e-2 if (int8_qk or int8_pv) else 1e-2
    assert (got - want).abs().max().item() <= atol
    assert (got - control).abs().max().item() > atol


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
@pytest.mark.parametrize("shape", FLASH_SHAPES[:2])
def test_registered_flash_op_matches_plain_on_the_card(cuda_device, shape):
    # the registered op `sd3_torch::flash_fwd` is K5: one launch, the bits
    # of the wrapper, out and lse within the FLASH limits of the plain
    # version in fp32; its autograd launches K6a and K6b once each
    q, k, v, do = _flash_case(shape, cuda_device, seed=2)
    scale = shape[-1] ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    before = tfl.K5.launches
    out, lse = torch.ops.sd3_torch.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert tfl.K5.launches == before + 1
    w_out, w_lse = tfl.flash_fwd(q, k, v, scale)
    assert torch.equal(out, w_out) and torch.equal(lse, w_lse)
    assert (out.float() - want[0]).abs().max().item() <= FLASH_OUT_ATOL
    assert (lse - want[1]).abs().max().item() <= FLASH_LSE_ATOL
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    before = (tfl.K6A.launches, tfl.K6B.launches)
    torch.ops.sd3_torch.flash_fwd(qg, kg, vg, scale)[0].backward(do)
    torch.cuda.synchronize()
    assert (tfl.K6A.launches, tfl.K6B.launches) == (before[0] + 1,
                                                    before[1] + 1)
    for name, t, w in zip(("dq", "dk", "dv"), (qg, kg, vg), want[2:]):
        _assert_grad_close(t.grad, w, name)


@pytest.fixture(scope="module")
def remat_runs():
    """{(policy, scan): (K5, K6a, K6b launches, gradients)} of one bf16
    forward and backward of a 2-block model of the published widths at
    256px, batch 2, under each remat policy, unrolled and in the scan
    layout, from one seeded init."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (runs on the card)")
    from sd3_torch.config import published_config
    cfg = published_config(stage_res=256).replace(num_blocks=2)
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(2, cfg.inCh, 32, 32, device="cuda", generator=g)
    t = torch.rand(2, device="cuda", generator=g)
    c = torch.randn(2, cfg.text_tokens, cfg.text_hidden_dim, device="cuda",
                    generator=g)
    cp = torch.randn(2, cfg.class_dim, device="cuda", generator=g)
    out = {}
    for scan in (False, True):
        for policy in ("nothing", "dots", "attn", "dots_attn"):
            model = MMDiT(cfg, device="cuda", fused_attn=False,
                          remat_blocks=True, remat_policy=policy,
                          scan_blocks=scan)
            model.init_weights(torch.Generator(device="cuda").manual_seed(1))
            before = (tfl.K5.launches, tfl.K6A.launches, tfl.K6B.launches)
            model(x, t, c, cp).square().mean().backward()
            torch.cuda.synchronize()
            launches = tuple(a - b for a, b in zip(
                (tfl.K5.launches, tfl.K6A.launches, tfl.K6B.launches),
                before))
            grads = {k: v.grad for k, v in model.named_parameters()}
            if scan:
                from sd3_torch.models.mmdit import from_scan_params
                grads = from_scan_params(grads, model.num_scan)
            out[(policy, scan)] = (launches, grads)
            del model
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("policy", ["nothing", "dots", "attn", "dots_attn"])
def test_remat_policies_launch_and_agree_on_the_card(remat_runs, policy,
                                                     scan):
    # K5 twice a block under "nothing" / "dots", once under "attn" /
    # "dots_attn" (the op's outputs kept); K6a and K6b once; every policy
    # and layout the same gradient bits (the recompute repeats the same
    # kernels and GEMMs)
    launches, grads = remat_runs[(policy, scan)]
    k5 = 2 if policy in ("nothing", "dots") else 1
    assert launches == (2 * k5, 2, 2)
    ref = remat_runs[("nothing", False)][1]
    assert list(grads) == list(ref)
    for k in ref:
        assert torch.equal(grads[k], ref[k]), k


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
    # fp16 (bf16 and fp32 have instances), dtypes that differ; every head
    # dim runs (test_flash_past_head_dim_128_matches_plain_on_the_card)
    q = torch.zeros(1, 2, 8, 32, device=cuda_device, dtype=torch.float16)
    with pytest.raises(TypeError, match="bfloat16"):
        tfl.flash_attention(q, q, q, 0.2)
    with pytest.raises(TypeError, match="one dtype"):
        tfl.flash_fwd(q.float(), q.bfloat16(), q.float(), 0.2)


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


# ---- the int8 kernels on fp32 rows; flash past head dim 128 --------------

# the fp32 instances of the int8 attentions against their plain versions on
# the same fp32 rows: the same int8 levels but for the odd value an ulp from
# a rounding boundary (exp2f, the preps' sums in another order), each moving
# an output by a level's share; chip_smoke.py's INT8_FP32 limits
INT8_FP32_MAX_REL, INT8_FP32_REL_L2 = 1e-2, 2e-3


def _launched(before):
    after = {kk.name: kk.launches for kk in kernels.REGISTRY}
    return {nm: after[nm] - before[nm] for nm in after
            if after[nm] != before[nm]}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", sorted(tfa._INFERENCE))
@pytest.mark.parametrize("shape", [ATTN_SHAPES[3], (3, 8, 4, 5, 7, True)])
def test_fp32_int8_attention_matches_plain_on_the_card(cuda_device, no_tf32,
                                                       variant, shape):
    # K4F, K7QF, K8AF, K8BF (and K8a / K8b over int8 scores) on fp32 q / k /
    # v, fp32 out; head dim 8 runs the 16 instance padded
    int8_qk, int8_pv, streaming = variant
    nh, d = shape[0], shape[1]
    q, k, v, ws, angles, n_img, scale = _attn_case(*shape, seed=13)
    dev = cuda_device
    qf, kf, vf = (_t(a).to(dev) for a in (q, k, v))
    wt = [_t(a).to(dev) for a in ws]
    n = qf.shape[1]
    cos, sin = (torch.as_tensor(t, device=dev)
                for t in tfa.rope_row_tables(angles, n, d))
    tabs = (*tfa.fold_row_tables(cos, sin, wt[0], wt[1], n_img),
            *tfa.fold_row_tables(cos, sin, wt[2], wt[3], n_img))
    kern, plain = tfa._INFERENCE[variant]
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    got = tfa.fused_attention(qf, kf, vf, nh, *tabs, scale, int8_qk=int8_qk,
                              int8_pv=int8_pv,
                              single_kv_max=0 if streaming else 2048)
    torch.cuda.synchronize()
    assert _launched(before) == {tfa._FP32[kern].name: 1}
    assert got.dtype == torch.float32 and got.shape == qf.shape
    eps = float(torch.finfo(torch.float32).eps)
    kw = dict(int8_pv=True) if int8_pv else {}
    if streaming:
        kw["block_k"] = tfa.K8B_KEY_TILE
    want = getattr(tfa, plain)(qf.cpu(), kf.cpu(), vf.cpu(),
                               *(t.cpu() for t in tabs), scale, eps, eps, nh,
                               **kw)
    dlt = got.cpu().double() - want.double()
    max_rel = (dlt.abs().max() / want.abs().max()).item()
    assert max_rel <= INT8_FP32_MAX_REL and _rel_l2(got.cpu(), want) <= \
        INT8_FP32_REL_L2, (max_rel, _rel_l2(got.cpu(), want))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["K2", "K3", "K9"])
@pytest.mark.parametrize("m,n_tok,k,hidden,d_out", [
    (2048, 1024, 1216, 4864, 1216), (308, 154, 1216, 4864, 1216),
    (300, 100, 80, 1024, 80)])
def test_fp32_int8_swiglu_matches_plain_on_the_card(cuda_device, kind, m,
                                                    n_tok, k, hidden, d_out):
    # K2F, K3F, K9F on fp32 rows, fp32 out, against the plain version on the
    # same rows (chip_smoke.py's MLP limits)
    t = mlp_case(m, n_tok, k, hidden, d_out, cuda_device)
    x = t["x"].float() + 1e-3 * torch.randn_like(t["x"].float())
    w = [t[nm] for nm in ("w12_q", "w12_scale", "b12", "w3_q", "w3_scale",
                          "b3")]
    tail = kind != "K3"
    h_group = 256
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    if kind == "K3":
        got = tfm.swiglu_int8(x, *w, h_group=h_group)
    else:
        fn = tfm.swiglu_int8_tail if kind == "K2" else tfm.swiglu_int8_tail3d
        got = fn(x, t["shift"], t["scale"], t["gate"], *w, n_tok=n_tok,
                 h_group=h_group)
    torch.cuda.synchronize()
    assert _launched(before) == {tfm._FP32[getattr(tfm, kind)].name: 1}
    assert got.dtype == torch.float32
    want = tfm.swiglu_int8_plain(x, *w, h_group=h_group, shift=t["shift"],
                                 scale=t["scale"], gate=t["gate"],
                                 n_tok=n_tok, adaln=tail, residual=tail)
    err = (got - want).abs().max().item()
    rel = ((got - want).norm() / want.norm()).item()
    assert err <= 1e-2 * want.abs().max().item() and rel <= 5e-3, (err, rel)


@pytest.mark.cuda
@pytest.mark.parametrize("b,n,k,d_out", [
    (2, 1024, 1216, 1216), (3, 300, 1216, 1216), (2, 40, 80, 48),
    (2, 130, 1600, 1600), (2, 40, 4096, 4096), (1, 64, 1600, 200)])
def test_fp32_k10_kernels_match_plain_on_the_card(cuda_device, b, n, k,
                                                  d_out):
    # K10AF (AdaLN + q / k / v) within the K10 limits of its plain version
    # on the same fp32 rows; K10BF, which repeats its plain version's
    # arithmetic in its order, bit for bit, gated or not, with or without
    # the residual, reading a slice of a longer sequence in place
    t, ws = dense_case(b, n, k, d_out, cuda_device)
    x = t["x"].float() + 1e-3 * torch.randn_like(t["x"].float())
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    got = tfd.qkv_adaln_int8(x, t["shift"], t["scale"], *ws)
    torch.cuda.synchronize()
    assert _launched(before) == {tfd.K10AF.name: 1}
    want = tfd.qkv_adaln_int8_plain(x, t["shift"], t["scale"], *ws)
    for g, w in zip(got, want):
        assert g.shape == (b, n, d_out) and g.dtype == torch.float32
        err = (g - w).abs().max().item()
        rel = ((g - w).norm() / w.norm()).item()
        assert (err <= K10_MAX_REL * w.abs().max().item()
                and rel <= K10_REL_L2), (err, rel)
    a = torch.cat([x, x[:, :7]], dim=1)[:, :n]
    res = t["res"].float()
    for gate, r in ((t["gate"], res), (None, None), (t["gate"], None),
                    (None, res)):
        before = {kk.name: kk.launches for kk in kernels.REGISTRY}
        got = tfd.out_gate_residual_int8(a, gate, r, *ws[:2])
        torch.cuda.synchronize()
        assert _launched(before) == {tfd.K10BF.name: 1}
        assert got.dtype == torch.float32
        assert torch.equal(got, tfd.out_gate_residual_int8_plain(
            a, gate, r, *ws[:2]))


# head dims past 128: the wgmma instances in bf16 at 256 (K5_256, K6A_256,
# K6B_256), 384 and 512 (K5_384 .. K6B_512), and 160, 300, 400 padded to
# them, the wide instances at every multiple of 128 (bf16 past 512 and
# fp32 at all): at ragged lengths and over many key tiles
FLASH_WIDE_SHAPES = [(1, 2, 300, 256), (2, 3, 129, 160), (1, 2, 65, 256),
                     (1, 2, 1178, 256), (1, 2, 300, 384), (2, 2, 65, 300),
                     (1, 2, 129, 512), (1, 2, 1178, 512), (1, 2, 65, 640),
                     (2, 3, 410, 384), (1, 2, 17, 512), (1, 3, 97, 400)]


def _wgmma_or_wide(d):
    """(K5, K6a, K6b) of bf16 at head dim d past 128: the wgmma instances
    up to 512, the wide mma.sync ones past it."""
    return tuple(tfl.flash_kernel(w, torch.bfloat16, d)
                 for w in ("fwd", "dq", "dkv"))


def _assert_grad_control_misses(q, k, v, do, scale, dq, dk, cut=None):
    """dq and dk against the plain backward in fp32 at twice the scale,
    which must miss the FLASH_GRAD limits (the failing control of the
    bf16 backward's checks)."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    out, lse = tfl.flash_fwd_plain(qf, kf, vf, scale)
    c_dq, c_delta = tfl.flash_dq_plain(qf, kf, vf, out, dof, lse, 2 * scale)
    c_dk, _ = tfl.flash_dkv_plain(qf, kf, vf, dof, lse, c_delta, 2 * scale)
    for name, got, ctl in (("dq", dq, c_dq), ("dk", dk, c_dk)):
        with pytest.raises(AssertionError):
            _assert_grad_close(got, ctl, f"{name} control")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_WIDE_SHAPES)
def test_flash_past_head_dim_128_matches_plain_on_the_card(cuda_device,
                                                           no_tf32, shape):
    # K5_256, K5_384, K5_512 (up to 512) or K5W, then K6A_256, K6B_256 (up
    # to 256) or K6AW, K6BW on bf16 (the limits of the bf16 flash kernels),
    # K5WF, K6AWF, K6BWF on fp32 (FP32_REL_L2), each against its plain
    # version
    q, k, v, do = _flash_case(shape, cuda_device, seed=3)
    scale = shape[-1] ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    fwd, dq_k, dkv_k = (tfl.flash_kernel(w, torch.bfloat16, shape[-1])
                        for w in ("fwd", "dq", "dkv"))
    assert (fwd.source == "attention_sm90.cu") == (shape[-1] <= 1024)
    assert fwd is tfl._WGMMA["fwd"].get(
        tfl.forward_dim(shape[-1], torch.bfloat16), tfl.K5W)
    dp = tfl.instance_dim(shape[-1])
    assert (dq_k, dkv_k) == (
        (tfl._WGMMA["dq"][dp], tfl._WGMMA["dkv"][dp]) if dp <= 512
        else (tfl.K6AW, tfl.K6BW))
    assert (dq_k.source == "flash_bwd_sm90.cu") == (dp <= 512)
    assert _launched(before) == {kk.name: 1 for kk in (fwd, dq_k, dkv_k)}
    assert out.dtype == dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    assert out.shape == dq.shape == dk.shape == dv.shape == shape
    assert (out.float() - want[0]).abs().max().item() <= FLASH_OUT_ATOL
    assert (lse - want[1]).abs().max().item() <= FLASH_LSE_ATOL
    for name, g, w in (("dq", dq, want[2]), ("dk", dk, want[3]),
                       ("dv", dv, want[4])):
        _assert_grad_close(g, w, name)
    if dp in tfl.WGMMA_SLICED:
        _assert_grad_control_misses(q, k, v, do, scale, dq, dk)
    q, k, v, do = (t.float() + 1e-3 * torch.randn_like(t.float())
                   for t in (q, k, v, do))
    w_out, w_lse = tfl.flash_fwd_plain(q, k, v, scale)
    w_dq, w_delta = tfl.flash_dq_plain(q, k, v, w_out, do, w_lse, scale)
    w_dk, w_dv = tfl.flash_dkv_plain(q, k, v, do, w_lse, w_delta, scale)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert _launched(before) == {kk.name: 1 for kk in (tfl.K5WF, tfl.K6AWF,
                                                       tfl.K6BWF)}
    errs = dict(out=_rel_l2(out, w_out), dq=_rel_l2(dq, w_dq),
                dk=_rel_l2(dk, w_dk), dv=_rel_l2(dv, w_dv))
    assert all(e <= FP32_REL_L2 for e in errs.values()), errs
    assert (lse - w_lse).abs().max().item() <= 1e-5


# K5 on bf16 past head dim 512 (K5_768, K5_1024; past 1024 K5W): 640 and
# 768, 1000 and 1024 at ragged lengths, with keys of a length of their own
# (M < N, M > N), and 1152 (B, H, N, M, D)
FLASH_PAST_512_SHAPES = [(1, 2, 65, 65, 640), (2, 2, 129, 300, 768),
                         (1, 2, 300, 150, 1000), (1, 1, 1178, 1178, 1024),
                         (1, 2, 65, 33, 1152)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_PAST_512_SHAPES)
def test_flash_forward_past_head_dim_512_on_the_card(cuda_device, no_tf32,
                                                     shape):
    # K5_768 / K5_1024 (K5W past 1024) against the plain forward in fp32 on
    # the same bf16 inputs within the FLASH limits, the same bits from two
    # calls, and the plain version at twice the scale, a control that must
    # miss the output's limit
    b, h, n, m, d = shape
    r = np.random.default_rng(11)
    q, k, v = (_t(r.standard_normal((b, h, rows, d))).to(
        cuda_device, torch.bfloat16) for rows in (n, m, m))
    scale = d ** -0.5
    kern = tfl.flash_kernel("fwd", torch.bfloat16, d)
    assert kern is ({768: tfl.K5_768, 1024: tfl.K5_1024}.get(
        tfl.forward_dim(d, torch.bfloat16), tfl.K5W))
    assert (kern.source == "attention_sm90.cu") == (d <= 1024)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    out, lse = tfl.flash_fwd(q, k, v, scale)
    out2, lse2 = tfl.flash_fwd(q, k, v, scale)
    torch.cuda.synchronize()
    assert _launched(before) == {kern.name: 2}
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    assert out.shape == q.shape and lse.shape == (b, h, n)
    qf, kf, vf = (t.float() for t in (q, k, v))
    w_out, w_lse = tfl.flash_fwd_plain(qf, kf, vf, scale)
    c_out, _ = tfl.flash_fwd_plain(qf, kf, vf, 2 * scale)
    assert (out.float() - w_out).abs().max().item() <= FLASH_OUT_ATOL
    assert (lse - w_lse).abs().max().item() <= FLASH_LSE_ATOL
    assert (out.float() - c_out).abs().max().item() > FLASH_OUT_ATOL


# (B, H, N, M, D): k and v with a key length M of their own, as
# kv_merge_attn gives them: the 512px and 256px kv_merge training shapes
# (M = N / 2), a ragged M against a whole N, M > N, the other small
# instances, and the wide ones
FLASH_KV_SHAPES = [(4, 19, 1178, 589, 64), (4, 19, 410, 205, 64),
                   (1, 3, 256, 77, 64), (1, 2, 129, 300, 64),
                   (2, 3, 47, 24, 16), (1, 2, 65, 33, 32),
                   (1, 2, 300, 150, 128), (1, 2, 300, 150, 256),
                   (1, 2, 129, 300, 256), (1, 2, 300, 150, 384),
                   (1, 2, 129, 300, 512), (2, 3, 410, 205, 384),
                   (1, 2, 63, 17, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_KV_SHAPES)
def test_flash_kernels_at_a_key_length_of_their_own_on_the_card(
        cuda_device, no_tf32, shape):
    # K5, K6a, K6b (past 128: their wgmma instances K5_256 .. K6B_512) on
    # bf16 within the FLASH limits, K5F, K6AF, K6BF (K5WF, K6AWF, K6BWF) on
    # fp32 within FP32_REL_L2, each against its plain version at M != N:
    # lse and delta by query row, dk and dv by key row; past 256 the plain
    # backward at twice the scale misses the limits
    b, h, n, m, d = shape
    r = np.random.default_rng(9)
    q, k, v, do = (_t(r.standard_normal((b, h, rows, d))).to(
        cuda_device, torch.bfloat16) for rows in (n, m, m, n))
    scale = d ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    wide = d > 128
    bf16 = _wgmma_or_wide(d)
    assert bf16 == ((tfl._WGMMA["fwd"][d], tfl._WGMMA["dq"][d],
                     tfl._WGMMA["dkv"][d]) if wide else (tfl.K5, tfl.K6A,
                                                         tfl.K6B))
    fp32 = (tfl.K5WF, tfl.K6AWF, tfl.K6BWF) if wide else (tfl.K5F, tfl.K6AF,
                                                          tfl.K6BF)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert _launched(before) == {kk.name: 1 for kk in bf16}
    assert out.shape == dq.shape == q.shape and lse.shape == (b, h, n)
    assert dk.shape == dv.shape == k.shape
    assert (out.float() - want[0]).abs().max().item() <= FLASH_OUT_ATOL
    assert (lse - want[1]).abs().max().item() <= FLASH_LSE_ATOL
    want_delta = (do.float() * out.float()).sum(-1)
    assert (delta - want_delta).abs().max().item() <= 1e-3
    for name, g, w in (("dq", dq, want[2]), ("dk", dk, want[3]),
                       ("dv", dv, want[4])):
        _assert_grad_close(g, w, name)
    if d in tfl.WGMMA_SLICED:
        _assert_grad_control_misses(q, k, v, do, scale, dq, dk)
    q, k, v, do = (t.float() + 1e-3 * torch.randn_like(t.float())
                   for t in (q, k, v, do))
    w_out, w_lse = tfl.flash_fwd_plain(q, k, v, scale)
    w_dq, w_delta = tfl.flash_dq_plain(q, k, v, w_out, do, w_lse, scale)
    w_dk, w_dv = tfl.flash_dkv_plain(q, k, v, do, w_lse, w_delta, scale)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    out, lse = tfl.flash_fwd(q, k, v, scale)
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    assert _launched(before) == {kk.name: 1 for kk in fp32}
    errs = dict(out=_rel_l2(out, w_out), dq=_rel_l2(dq, w_dq),
                dk=_rel_l2(dk, w_dk), dv=_rel_l2(dv, w_dv))
    assert all(e <= FP32_REL_L2 for e in errs.values()), errs
    assert (lse - w_lse).abs().max().item() <= 1e-5


# K6A_256 and K6B_256 (bf16 heads of 129-256): lengths on either side of
# their 32-key tiles, 64-row items and 128-row blocks, 160 padded to 256,
# key lengths of their own (M < N, M > N, a ragged M), and the 512px
# training shape
FLASH_256_SHAPES = [(1, 2, 63, 256), (1, 2, 65, 256), (1, 2, 127, 256),
                    (1, 2, 129, 256), (2, 3, 129, 160), (1, 2, 65, 33, 256),
                    (1, 1, 63, 129, 256), (2, 3, 410, 205, 256),
                    (4, 5, 1178, 256)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_256_SHAPES)
def test_k6_256_matches_plain_reads_views_and_repeats_on_the_card(
        cuda_device, shape, monkeypatch):
    # K6A_256 and K6B_256 against their plain versions in fp32 within the
    # FLASH limits (delta to 1e-3); (B, H, N, D) views of (B, N, H, D)
    # buffers, the training path's layout, go to the tensor maps as they
    # are and give the bits of contiguous inputs; a second run gives the
    # same bits (no atomics)
    _k6_views_and_repeats(cuda_device, shape, monkeypatch)


# K6A_384 / K6B_384 and K6A_512 / K6B_512 (bf16 heads of 257-512): lengths
# on either side of their 64-row items and of their key / query tiles (32
# at 384, 16 at 512), 300 and 400 padded, key lengths of their own, the
# D-384 training step's shape and FLASH_WIDE's
FLASH_SLICED_SHAPES = [(1, 2, 15, 384), (1, 2, 63, 384), (1, 2, 65, 384),
                       (2, 3, 129, 300), (1, 2, 17, 512), (1, 2, 63, 512),
                       (1, 2, 65, 512), (2, 2, 97, 400), (1, 2, 65, 33, 384),
                       (1, 1, 63, 129, 512), (2, 3, 410, 205, 384),
                       (2, 3, 410, 384), (4, 3, 1178, 384),
                       (4, 2, 1178, 512)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", FLASH_SLICED_SHAPES)
def test_k6_sliced_matches_plain_reads_views_and_repeats_on_the_card(
        cuda_device, shape, monkeypatch):
    # the same for the D = 384 and 512 instances, and the plain backward at
    # twice the scale misses the limits
    _k6_views_and_repeats(cuda_device, shape, monkeypatch, control=True)


def _k6_views_and_repeats(cuda_device, shape, monkeypatch, control=False):
    b, h, n, m, d = shape if len(shape) == 5 else (*shape[:3], *shape[2:])
    r = np.random.default_rng(11)
    q, k, v, do = (_t(r.standard_normal((b, h, rows, d))).to(
        cuda_device, torch.bfloat16) for rows in (n, m, m, n))
    scale = d ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    out, lse = tfl.flash_fwd(q, k, v, scale)
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    dq, delta = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk, dv = tfl.flash_dkv(q, k, v, do, lse, delta, scale)
    torch.cuda.synchronize()
    dp = tfl.instance_dim(d)
    assert _launched(before) == {tfl._WGMMA["dq"][dp].name: 1,
                                 tfl._WGMMA["dkv"][dp].name: 1}
    assert dq.shape == q.shape and dk.shape == dv.shape == k.shape
    assert dq.dtype == dk.dtype == dv.dtype == torch.bfloat16
    want_delta = (do.float() * out.float()).sum(-1)
    assert (delta - want_delta).abs().max().item() <= 1e-3
    for name, g, w in (("dq", dq, want[2]), ("dk", dk, want[3]),
                       ("dv", dv, want[4])):
        _assert_grad_close(g, w, name)
    if control:
        _assert_grad_control_misses(q, k, v, do, scale, dq, dk)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2)
             for t in (q, k, v, out, do)]
    readable, in_place = tfl._readable, []

    def spy(t):
        got = readable(t)
        in_place.append(got is t)
        return got
    monkeypatch.setattr(tfl, "_readable", spy)
    vdq, vdelta = tfl.flash_dq(*views, lse, scale)
    vdk, vdv = tfl.flash_dkv(*views[:3], views[4], lse, vdelta, scale)
    dq2, delta2 = tfl.flash_dq(q, k, v, out, do, lse, scale)
    dk2, dv2 = tfl.flash_dkv(q, k, v, do, lse, delta2, scale)
    torch.cuda.synchronize()
    assert in_place[:9] == [True] * 9
    for a, b_, c_ in ((dq, vdq, dq2), (delta, vdelta, delta2),
                      (dk, vdk, dk2), (dv, vdv, dv2)):
        assert torch.equal(a, b_) and torch.equal(a, c_)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(2, 3, 129, 256), (1, 2, 65, 200),
                                   (2, 3, 129, 384), (1, 2, 65, 400)])
def test_flash_autograd_function_at_head_dim_256_on_the_card(cuda_device,
                                                             shape):
    # the Function at a head dim of 129-256 launches K5_256 forward and
    # K6A_256, K6B_256 backward, once each, on views of (B, N, H, D)
    # buffers; at 257-512 K5_384 / K5_512 and K6A_384 .. K6B_512, and the
    # plain backward at twice the scale misses the limits
    q, k, v, do = _flash_case(shape, cuda_device, seed=12)
    scale = shape[-1] ** -0.5
    want = _flash_plain_fp32(q, k, v, do, scale)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2).requires_grad_()
             for t in (q, k, v)]
    before = {kk.name: kk.launches for kk in kernels.REGISTRY}
    out = tfl.flash_attention(*views, scale)
    out.backward(do)
    torch.cuda.synchronize()
    assert _launched(before) == {kk.name: 1 for kk in _wgmma_or_wide(
        shape[-1])}
    assert all(kk.source != "attention_fp32.cu"
               for kk in _wgmma_or_wide(shape[-1]))
    assert (out.float() - want[0]).abs().max().item() <= FLASH_OUT_ATOL
    for name, t, w in zip(("dq", "dk", "dv"), views, want[2:]):
        _assert_grad_close(t.grad, w, name)
    if shape[-1] > 256:
        _assert_grad_control_misses(q, k, v, do, scale, views[0].grad,
                                    views[1].grad)
