"""Model configuration.

The port's own copy of the MMDiT hyperparameter record: the same fields,
defaults and checkpoint JSON keys as the JAX package's `sd3_tpu/config.py`
(which in turn mirrors the reference `diff_model.py:104-123` defaults), so a
`model_params_*.json` written by either package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any

ATTN_TYPES = (
    "softmax",
    "softmax_flash",
    "both",
    "cosine",
    "cosine2",
    "cosine3",
    "cosine4",
    "cosine_norm",
    "relu",
    "silu",
    "exp",
)
POS_ENCODINGS = ("absolute", "RoPE", "NoPE", "RoPE2d", "RoPE2dV2")
MLP_TYPES = ("gelu", "swiglu", "swiglu_old")
ATTN_TAILS = ("none", "all", "qkv", "out")
MLP_TAIL_FUSIONS = ("2d", "3d")

# Tokens per text encoder stream (Gemma / ModernBERT), and the width both
# streams are padded/projected from (reference diff_model.py:164).
TEXT_TOKENS_PER_ENCODER = 77
TEXT_HIDDEN_DIM = 2304


@dataclasses.dataclass(frozen=True)
class MMDiTConfig:
    """Hyperparameters of the dual-stream MMDiT.

    Field names match the reference checkpoint JSON keys plus a few extras
    (compute dtype, text geometry, absolute-PE table geometry, quantization).
    """

    inCh: int = 16                     # VAE latent channels
    class_dim: int = 768               # pooled (CLIP) conditioning width
    patch_size: int = 2
    dim: int = 1216                    # 64 * num_blocks at the published config
    hidden_scale: float = 4.0
    num_heads: int = 19
    attn_type: str = "softmax_flash"
    MLP_type: str = "swiglu"
    num_blocks: int = 19
    positional_encoding: str = "RoPE2d"
    max_res_orig: int = 256            # resolution of the first training stage
    max_res: int = 256                 # current-stage max resolution (pixels)
    kv_merge_attn: bool = False        # pairwise k/v merging (halves KV length)
    qk_half_dim: bool = False          # q/k projected to dim/2
    text_loss: bool = False            # auxiliary text-reconstruction loss head
    start_step: int = 0
    wandb_id: str | None = None

    # --- extras (not in the reference JSON; defaulted on load) ---
    # Compute dtype of the transformer ("bfloat16" or "float32").
    dtype: str = "bfloat16"
    # Positional interpolation (1/RoPE_Scale) on the 2-D axial RoPE path. The
    # reference applies none there (rotary_embedding.py:269-288 uses raw
    # arange positions); False reproduces it.
    rope2d_interpolate: bool = False
    # Raw text conditioning geometry (reference: 77 tokens/encoder, width
    # 2304). Overridable so tests can run tiny.
    text_tokens_per_encoder: int = TEXT_TOKENS_PER_ENCODER
    text_hidden_dim: int = TEXT_HIDDEN_DIM
    # Absolute-PE table geometry (reference ImagePositionalEncoding.py:128-131).
    pos_embed_max_size: int = 256
    pos_embed_base_size: int = 128
    # Inference-only quantization ("none" or "int8"); runtime choice, not
    # persisted in checkpoint JSON.
    quant: str = "none"
    quant_skip: tuple = ()
    # int8 P.V in the streaming attention (K8b) under quant="int8", above
    # 2048 padded tokens: the JAX package's opt-in SD3_INT8_PV=1 made a
    # field (sd3_tpu/ops/attention.py:334-336). Runtime choice, not
    # persisted.
    int8_pv: bool = False
    # The JAX package's other opt-in serving flags, made fields; runtime
    # choices, not persisted. Under quant="int8", `attn_tail` folds the
    # attention half's AdaLN prologue into the image-stream q/k/v projections
    # (K10a; "all" or "qkv") and the gate + residual epilogue into the out
    # projections (K10b; "all" or "out"): SD3_ATTN_TAIL
    # (sd3_tpu/models/mmdit.py:80-100, ops/attention.py:262).
    attn_tail: str = "none"
    # The int8 MLP block tail's kernel: "2d", K2 for sample-alignable
    # streams and K3 between PyTorch prologue and epilogue otherwise, or
    # "3d", K9 for every stream: SD3_MLP_TAIL_FUSION (ops/fused_mlp.py:515).
    mlp_tail_fusion: str = "2d"
    # False runs the MLP half unfused around the int8 SwiGLU (K3):
    # SD3_NO_MLP_TAIL=1 (models/mmdit.py:112-115).
    mlp_tail: bool = True
    # False takes no int8 SwiGLU kernel at all (two int8 projections):
    # SD3_NO_FUSED_MLP=1 (ops/mlp.py:44-47).
    fused_mlp: bool = True

    def __post_init__(self):
        if self.quant not in ("none", "int8"):
            raise ValueError(f"quant must be 'none' or 'int8', got {self.quant!r}")
        if self.attn_tail not in ATTN_TAILS:
            raise ValueError(f"attn_tail must be one of {ATTN_TAILS}, got "
                             f"{self.attn_tail!r}")
        if self.mlp_tail_fusion not in MLP_TAIL_FUSIONS:
            raise ValueError(f"mlp_tail_fusion must be one of "
                             f"{MLP_TAIL_FUSIONS}, got {self.mlp_tail_fusion!r}")
        if not isinstance(self.quant_skip, tuple):
            object.__setattr__(self, "quant_skip", tuple(self.quant_skip))
        if self.attn_type not in ATTN_TYPES:
            raise ValueError(f"unknown attn_type {self.attn_type!r}")
        if self.positional_encoding not in POS_ENCODINGS:
            raise ValueError(
                f"unknown positional_encoding {self.positional_encoding!r}")
        if self.MLP_type not in MLP_TYPES:
            raise ValueError(f"unknown MLP_type {self.MLP_type!r}")
        if self.dim % self.num_heads:
            raise ValueError("dim must be a multiple of num_heads")
        if self.qk_half_dim and (self.dim // 2) % self.num_heads:
            raise ValueError("dim/2 must be a multiple of num_heads")

    # ---- derived quantities -------------------------------------------------
    @property
    def head_dim(self) -> int:
        return self.dim // self.num_heads

    @property
    def dim_qk(self) -> int:
        return self.dim // 2 if self.qk_half_dim else self.dim

    @property
    def head_dim_qk(self) -> int:
        return self.dim_qk // self.num_heads

    @property
    def rope_scale(self) -> float:
        """RoPE_Scale = max_res_orig / max_res (reference diff_model.py:88)."""
        return self.max_res_orig / self.max_res

    @property
    def text_tokens(self) -> int:
        return 2 * self.text_tokens_per_encoder

    @property
    def hidden_dim(self) -> int:
        return int(self.dim * self.hidden_scale)

    def img_tokens(self, height: int, width: int) -> int:
        """Number of image tokens for a latent of (height, width)."""
        return (height // self.patch_size) * (width // self.patch_size)

    # ---- JSON round-trip (checkpoint `model_params_{step}s.json`) -----------
    _JSON_KEYS = (
        "inCh", "class_dim", "patch_size", "dim", "hidden_scale", "num_heads",
        "attn_type", "MLP_type", "num_blocks", "positional_encoding",
        "max_res_orig", "max_res", "kv_merge_attn", "qk_half_dim", "text_loss",
        "start_step", "wandb_id",
    )
    _EXTRA_JSON_KEYS = ("dtype", "rope2d_interpolate",
                        "text_tokens_per_encoder", "text_hidden_dim",
                        "pos_embed_max_size", "pos_embed_base_size")

    def to_json_dict(self) -> dict[str, Any]:
        d = {k: getattr(self, k) for k in self._JSON_KEYS + self._EXTRA_JSON_KEYS}
        d["device"] = "cpu"  # the reference persists it (diff_model.py:120)
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @classmethod
    def from_json_dict(cls, d: dict[str, Any], **overrides) -> "MMDiTConfig":
        d = dict(d)
        d.pop("device", None)
        # Back-compat defaults, as in reference diff_model.py:562-565.
        d.setdefault("MLP_type", "swiglu_old")
        d.setdefault("text_loss", False)
        known = {f.name for f in dataclasses.fields(cls)}
        d = {k: v for k, v in d.items() if k in known}
        d.update(overrides)
        return cls(**d)

    @classmethod
    def from_json(cls, s: str, **overrides) -> "MMDiTConfig":
        return cls.from_json_dict(json.loads(s), **overrides)

    def replace(self, **kw) -> "MMDiTConfig":
        return dataclasses.replace(self, **kw)


def published_config(stage_res: int = 256) -> MMDiTConfig:
    """The ~1.2B-param published configuration (reference train.py:34-63)."""
    num_blocks = 19
    return MMDiTConfig(
        inCh=16,
        class_dim=768,
        patch_size=2,
        dim=64 * num_blocks,
        hidden_scale=4.0,
        num_heads=num_blocks,
        attn_type="softmax_flash",
        MLP_type="swiglu",
        num_blocks=num_blocks,
        positional_encoding="RoPE2d",
        max_res_orig=256,
        max_res=stage_res,
    )


def tiny_config(**overrides) -> MMDiTConfig:
    """A small config for tests."""
    kw = dict(
        inCh=4,
        class_dim=16,
        patch_size=2,
        dim=32,
        hidden_scale=2.0,
        num_heads=2,
        attn_type="softmax",
        MLP_type="swiglu",
        num_blocks=2,
        positional_encoding="RoPE2d",
        max_res_orig=16,
        max_res=16,
        dtype="float32",
        text_tokens_per_encoder=7,
        text_hidden_dim=24,
        pos_embed_max_size=16,
    )
    kw.update(overrides)
    return MMDiTConfig(**kw)
