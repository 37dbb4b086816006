"""Int8 (w8a8) projections for inference sampling (JAX counterpart:
sd3_tpu/ops/quant.py).

Scheme (dynamic PTQ, no calibration data):
- weights:     symmetric per output channel, scale = max|W[j, :]| / 127
               (eps 1e-8), quantized once (`quantize_weight`,
               `quantize_model`); stored (out, in) int8, K-contiguous, the
               layout the int8 tensor-core product takes its B operand in;
- activations: symmetric per token, scale = max|x| / 127 (eps 1e-8),
               computed at every call;
- product:     s8 x s8 -> s32, dequantized by s_act * s_w in fp32, plus the
               bias in fp32, cast to the input dtype.

The s8 x s8 -> s32 product of the projections is a library call, as XLA
computes it in the JAX package outside any Pallas kernel: `torch._int_mm`
on the card (its shape rules: more than 16 rows, inner and outer widths
multiples of 8; rows are padded here) and on the CPU. It is exact, so the
s32 sums equal JAX's bit for bit. Quantize and dequantize are
plain PyTorch.

Rounding follows JAX: `torch.round` (half to even), a true division by the
scale (not a reciprocal multiply, which flips odd int8 levels), clip to
+-127. The scale itself is max / 127 divided truly too (`scale_of`): on the
card PyTorch multiplies by the reciprocal of a Python-scalar divisor, which
gives a scale one ulp off in ~5% of rows, and each such row then takes
other int8 levels than JAX's and the kernels'.
"""

from __future__ import annotations

import torch
from torch import nn

# Linear layers that get quantized: the MLP names anywhere, the attention
# projections only directly under an `attn` parent (the model's final
# `out_proj` stays float). The port's copy of sd3_tpu/ops/quant.py:38-44.
MLP_QUANT_NAMES = frozenset({"w12", "w3", "lin_up", "lin_down"})
ATTN_QUANT_NAMES = frozenset({
    "query_proj_x", "key_proj_x", "value_proj_x", "out_proj_x",
    "query_proj_c", "key_proj_c", "value_proj_c", "out_proj_c",
    "query_proj", "key_proj", "value_proj", "out_proj",
})
QUANT_LAYER_NAMES = MLP_QUANT_NAMES | ATTN_QUANT_NAMES
ATTN_SCOPE = "attn"
EPS = 1e-8
_INT_MM_MIN_ROWS = 17


_LEVELS: dict = {}  # device -> the 0-d fp32 tensor 127


def scale_of(amax: torch.Tensor, eps: float) -> torch.Tensor:
    """max(amax, eps) / 127 as a true division (see the module note)."""
    levels = _LEVELS.get(amax.device)
    if levels is None:
        levels = _LEVELS[amax.device] = torch.tensor(
            127.0, dtype=torch.float32, device=amax.device)
    return amax.clamp_min(eps) / levels


def quantize_rows(x: torch.Tensor, eps: float = EPS):
    """Per-row symmetric int8 of an fp32 tensor over its last axis:
    (int8 values, fp32 (..., 1) scales)."""
    s = scale_of(x.abs().amax(dim=-1, keepdim=True), eps)
    return torch.clamp(torch.round(x / s), -127, 127).to(torch.int8), s


def quantize_weight(w: torch.Tensor):
    """(out, in) float weight -> ((out, in) int8, (out,) fp32 scales)."""
    wq, s = quantize_rows(w.float())
    return wq, s[:, 0]


def int_mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Exact s8 x s8 -> s32 product a @ w.T: a (M, K) int8, w (N, K) int8.
    `torch._int_mm`: cuBLASLt on the card, with rows padded past 16 as it
    requires; an exact integer product on the CPU, with no shape rules."""
    m = a.shape[0]
    if a.device.type == "cuda" and m < _INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(_INT_MM_MIN_ROWS - m, a.shape[1])])
    return torch._int_mm(a.contiguous(), w.t())[:m]


def int8_dense_apply(x: torch.Tensor, weight_q: torch.Tensor,
                     weight_scale: torch.Tensor,
                     bias: torch.Tensor | None) -> torch.Tensor:
    """y = dequant(quant8(x) @ weight_q.T) + bias in fp32, cast to x.dtype."""
    lead = x.shape[:-1]
    xq, s_act = quantize_rows(x.reshape(-1, x.shape[-1]).float())
    acc = int_mm(xq, weight_q)
    y = acc.float() * s_act * weight_scale.float()
    if bias is not None:
        y = y + bias.float()
    return y.to(x.dtype).reshape(*lead, -1)


class Int8Linear(nn.Module):
    """The quantized counterpart of `nn.Linear` (JAX: Int8Dense). Buffers
    `weight_q` (out, in) int8 and `weight_scale` (out,) fp32, so a cast of
    the parameters leaves them alone; `bias` is a parameter and follows the
    compute dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 device=None, dtype=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.register_buffer("weight_q", torch.zeros(
            out_features, in_features, dtype=torch.int8, device=device))
        self.register_buffer("weight_scale", torch.ones(
            out_features, dtype=torch.float32, device=device))
        self.bias = (nn.Parameter(torch.zeros(out_features, device=device,
                                              dtype=dtype))
                     if bias else None)

    @classmethod
    def from_linear(cls, lin: nn.Linear) -> "Int8Linear":
        out = cls(lin.in_features, lin.out_features, lin.bias is not None,
                  device=lin.weight.device)
        wq, s = quantize_weight(lin.weight.detach())
        out.weight_q.copy_(wq)
        out.weight_scale.copy_(s)
        if lin.bias is not None:
            out.bias = nn.Parameter(lin.bias.detach().float().clone())
        return out

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return int8_dense_apply(x, self.weight_q, self.weight_scale, self.bias)

    def extra_repr(self) -> str:
        return (f"in_features={self.in_features}, out_features="
                f"{self.out_features}, bias={self.bias is not None}")


def make_linear(in_features: int, out_features: int, bias: bool, name: str,
                quant: str = "none", quant_skip: tuple = (), device=None,
                dtype=None) -> nn.Module:
    """Linear factory of the model blocks: `Int8Linear` under quant="int8"
    unless `name` is in quant_skip, else `nn.Linear` (JAX: quant.dense)."""
    if quant == "int8" and name not in quant_skip:
        return Int8Linear(in_features, out_features, bias, device=device,
                          dtype=dtype)
    return nn.Linear(in_features, out_features, bias=bias, device=device,
                     dtype=dtype)


def _is_target(name: str, parent: str, quant_skip) -> bool:
    return name not in quant_skip and (
        name in MLP_QUANT_NAMES
        or (name in ATTN_QUANT_NAMES and parent == ATTN_SCOPE))


@torch.no_grad()
def quantize_model(model: nn.Module, quant_skip: tuple | None = None
                   ) -> nn.Module:
    """Quantize a float model in place, as `quantize_params` does to a JAX
    tree (sd3_tpu/ops/quant.py:124-150): each target `nn.Linear` becomes an
    `Int8Linear` made from its float weight. Every module that carries a
    `quant` setting (attention, MLP, the model's `cfg`) is switched to
    "int8" with the same `quant_skip` (default: the model config's), so
    the kernels' dispatch follows. Returns the model."""
    if getattr(model, "num_scan", 0):
        raise ValueError("quantize_model takes an unrolled model, not the "
                         "scan_blocks layout")
    cfg = getattr(model, "cfg", None)
    if quant_skip is None:
        quant_skip = cfg.quant_skip if cfg is not None else ()
    quant_skip = tuple(quant_skip)
    targets = []
    for path, mod in model.named_modules():
        for name, child in mod.named_children():
            parent = path.rsplit(".", 1)[-1]
            if (isinstance(child, nn.Linear)
                    and _is_target(name, parent, quant_skip)):
                targets.append((mod, name, child))
    for mod, name, child in targets:
        setattr(mod, name, Int8Linear.from_linear(child))
    for mod in model.modules():
        if hasattr(mod, "quant") and hasattr(mod, "quant_skip"):
            mod.quant, mod.quant_skip = "int8", quant_skip
    if cfg is not None:
        model.cfg = cfg.replace(quant="int8", quant_skip=quant_skip)
    return model
