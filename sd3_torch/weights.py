"""Weights across the two packages and from reference checkpoints.

- `state_dict_from_jax(params)`: the JAX package's MMDiT parameter tree
  (nested dicts of arrays) -> this port's state_dict. The port's own copy of
  the name mapping of `sd3_tpu/training/checkpoint.py::export_to_torch_state_dict`
  (reference state-dict names), except that the patch-embedding kernel
  (C*p*p, O) becomes the reference's Conv2d weight `pos_enc.proj.weight`
  (O, C, p, p) instead of staying 2-D. A quantized tree (JAX
  `quantize_params`) crosses too: `kernel_q` (in, out) int8 becomes
  `weight_q` (out, in) int8 and `kernel_scale` becomes `weight_scale` fp32,
  the buffers of `ops.quant.Int8Linear`. Every variant's parameters cross
  by their reference names: the cosine attention's `attn.norm_const`
  (1, H, 1, 1), swiglu_old's flat `MLP_x.w12` / `w3`, gelu's `lin_up` /
  `lin_down`, the single stream's `query_proj` ... `out_proj`, `q_norm`,
  `k_norm`, and the text-loss head `out_text_proj`.
- `jax_tree_from_state_dict(sd)`: the exact inverse, the port's state_dict
  (or any dict keyed like it: EMA, optimizer moments) -> the JAX package's
  parameter tree of CPU tensors in the JAX layout, each in its dtype; the
  form the checkpoints hold (`training/checkpoint.py`). `to_jax_layout` /
  `from_jax_layout` are its per-leaf halves.
- `load_reference_state_dict(model, sd)`: drops the recomputed buffers a
  reference checkpoint carries (rotary tables, the absolute sin-cos table)
  and loads the rest strictly.
- The frozen encoders: `flux_vae_state_dict_from_jax`,
  `clip_text_state_dict_from_jax`, `gemma2_state_dict_from_jax` and
  `modernbert_state_dict_from_jax`, each the exact inverse of the JAX
  package's importer (`import_flux_vae_state_dict`, ...): numpy arrays of
  the JAX tree -> the transformers / diffusers names of the port's modules
  (`models/vae.py`, `clip_text.py`, `gemma2.py`, `modernbert.py`), conv
  kernels HWIO -> OIHW, Dense kernels (in, out) -> (out, in), ModernBERT's
  packed Wqkv kept packed; fp32 tensors that `load_state_dict(strict=True)`
  takes.
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

# Buffers of reference checkpoints that the port recomputes (the JAX
# importer skips the same ones: sd3_tpu/training/checkpoint.py:39-43).
_SKIP_PATTERNS = (
    re.compile(r"rotary_emb\.(freqs|inv_freq)$"),
    re.compile(r"rotary_emb\.(cached_freqs|cached_scales|dummy)$"),
    re.compile(r"pos_enc\.pos_embed$"),
)


def _flatten(tree: Mapping, prefix=()) -> dict[tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (str(k),)))
        else:
            out[prefix + (str(k),)] = v
    return out


def state_dict_from_jax(params: Mapping, patch_size: int = 2
                        ) -> dict[str, torch.Tensor]:
    """JAX MMDiT params (nested dicts of numpy-convertible arrays or CPU
    tensors) -> the port's state_dict (reference names; int8 leaves stay
    int8, every other leaf becomes fp32)."""
    out: dict[str, torch.Tensor] = {}
    for path, val in _flatten(params).items():
        if isinstance(val, torch.Tensor):
            val = val.float() if val.is_floating_point() else val
            arr = val.detach().cpu().numpy()
        else:
            arr = np.asarray(val)
        arr = arr if arr.dtype == np.int8 else arr.astype(np.float32)
        parts = list(path)
        if parts[0] == "t_emb":
            if parts[1] == "time_scale":
                out["time_scale"] = torch.tensor(arr)
                continue
            parts = parts[1:]  # t_emb2/...
        m = re.fullmatch(r"blocks_(\d+)", parts[0])
        if m:
            parts = ["blocks", m.group(1)] + parts[1:]
        if parts[-1] == "kernel":
            if parts[:-1] == ["pos_enc"]:
                rows, o = arr.shape  # (C*p*p, O) in (C, ph, pw) order
                arr = arr.T.reshape(o, rows // patch_size ** 2, patch_size,
                                    patch_size)
                parts = ["pos_enc", "proj", "weight"]
            else:
                arr = arr.T
                parts[-1] = "weight"
        elif parts[-1] == "kernel_q":
            arr = arr.T
            parts[-1] = "weight_q"
        elif parts[-1] == "kernel_scale":
            parts[-1] = "weight_scale"
        if len(parts) >= 2 and parts[-2] == "y_proj":
            parts = parts[:-1] + ["0", parts[-1]]
        out[".".join(parts)] = torch.tensor(arr)  # a contiguous copy
    return out


# the torch names that the JAX tree keeps under its `t_emb` module
_T_EMB_CHILDREN = ("time_scale", "t_emb2")


def jax_path(name: str) -> tuple[str, ...]:
    """The JAX tree path of the port's state-dict name (the inverse of
    `state_dict_from_jax`'s renaming)."""
    parts = name.split(".")
    if len(parts) >= 3 and parts[-3] == "y_proj" and parts[-2] == "0":
        parts = parts[:-2] + parts[-1:]
    if parts[0] == "blocks":
        parts = [f"blocks_{parts[1]}"] + parts[2:]
    if parts[0] in _T_EMB_CHILDREN:
        parts = ["t_emb"] + parts
    if parts[-3:] == ["pos_enc", "proj", "weight"]:
        parts = parts[:-2] + ["kernel"]
    elif parts[-1] == "weight" and not _is_norm_weight(parts):
        parts[-1] = "kernel"
    elif parts[-1] == "weight_q":
        parts[-1] = "kernel_q"
    elif parts[-1] == "weight_scale":
        parts[-1] = "kernel_scale"
    return tuple(parts)


def _is_norm_weight(parts) -> bool:
    """A norm's `weight` (q_norm_x, pre_c_norm, ...) keeps its name in the
    JAX tree; every other `weight` is a kernel."""
    return "norm" in parts[-2]


def to_jax_layout(name: str, t: torch.Tensor) -> torch.Tensor:
    """Leaf `name` of the port's state_dict in the JAX layout: a linear
    weight (out, in) as its kernel (in, out), the patch Conv2d weight (O, C,
    p, p) as (C*p*p, O); others as they are."""
    path = jax_path(name)
    if path[-1] not in ("kernel", "kernel_q"):
        return t
    if t.ndim == 4:
        return t.reshape(t.shape[0], -1).T
    return t.T


def from_jax_layout(name: str, t: torch.Tensor, shape) -> torch.Tensor:
    """The inverse of `to_jax_layout`: a JAX-layout leaf back to the port's
    `shape`."""
    if jax_path(name)[-1] not in ("kernel", "kernel_q"):
        return t.reshape(shape)
    return t.T.reshape(shape)


def jax_tree_from_state_dict(sd: Mapping[str, torch.Tensor]) -> dict:
    """The port's state_dict (or a dict keyed like it) -> the JAX parameter
    tree: nested dicts of contiguous CPU tensors in the JAX layout, each in
    its own dtype. `state_dict_from_jax` of it gives `sd` back (in fp32)."""
    tree: dict = {}
    for name, t in sd.items():
        node = tree
        path = jax_path(name)
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = to_jax_layout(name, t.detach()).cpu().contiguous()
    return tree


def load_reference_state_dict(model: torch.nn.Module, sd: Mapping):
    """Load a reference-format state_dict into `model` strictly, after
    dropping the recomputed buffers `_SKIP_PATTERNS` lists."""
    kept = {k: torch.as_tensor(v) for k, v in sd.items()
            if not any(p.search(k) for p in _SKIP_PATTERNS)}
    return model.load_state_dict(kept, strict=True)


# ---- the frozen encoders -------------------------------------------------

def _t32(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _dense(a) -> torch.Tensor:
    """A Dense kernel (in, out) -> a Linear weight (out, in)."""
    return _t32(np.asarray(a).T)


def flux_vae_state_dict_from_jax(params: Mapping) -> dict:
    """FluxVAE params (`import_flux_vae_state_dict`'s tree) -> the diffusers
    AutoencoderKL names of `models.vae.FluxVAE`."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"] = _t32(np.transpose(np.asarray(p["kernel"]),
                                                 (3, 2, 0, 1)))
        sd[f"{name}.bias"] = _t32(p["bias"])

    def norm(name, p):
        sd[f"{name}.weight"] = _t32(p["weight"])
        sd[f"{name}.bias"] = _t32(p["bias"])

    def resnet(name, p):
        norm(f"{name}.norm1", p["norm1"])
        conv(f"{name}.conv1", p["conv1"])
        norm(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv2", p["conv2"])
        if "conv_shortcut" in p:
            conv(f"{name}.conv_shortcut", p["conv_shortcut"])

    def attn(name, p):
        norm(f"{name}.group_norm", p["group_norm"])
        for jn, tn in (("to_q", "to_q"), ("to_k", "to_k"), ("to_v", "to_v"),
                       ("to_out", "to_out.0")):
            sd[f"{name}.{tn}.weight"] = _dense(p[jn]["kernel"])
            sd[f"{name}.{tn}.bias"] = _t32(p[jn]["bias"])

    for side, blocks, res, resample in (
            ("encoder", "down_blocks", "down", "downsamplers"),
            ("decoder", "up_blocks", "up", "upsamplers")):
        p = params[side]
        conv(f"{side}.conv_in", p["conv_in"])
        levels = sorted({int(k.split("_")[1]) for k in p
                         if k.startswith(res + "_")})
        for i in levels:
            j = 0
            while f"{res}_{i}_res_{j}" in p:
                resnet(f"{side}.{blocks}.{i}.resnets.{j}", p[f"{res}_{i}_res_{j}"])
                j += 1
            key = f"{res}_{i}_{'downsample' if side == 'encoder' else 'upsample'}"
            if key in p:
                conv(f"{side}.{blocks}.{i}.{resample}.0.conv", p[key])
        resnet(f"{side}.mid_block.resnets.0", p["mid_res_0"])
        resnet(f"{side}.mid_block.resnets.1", p["mid_res_1"])
        attn(f"{side}.mid_block.attentions.0", p["mid_attn"])
        norm(f"{side}.conv_norm_out", p["conv_norm_out"])
        conv(f"{side}.conv_out", p["conv_out"])
    return sd


def clip_text_state_dict_from_jax(params: Mapping) -> dict:
    """ClipTextEncoder params (`import_clip_text_state_dict`'s tree) -> the
    transformers names of `models.clip_text.ClipTextEncoder`."""
    pre = "text_model."
    sd = {f"{pre}embeddings.token_embedding.weight":
          _t32(params["token_embedding"]),
          f"{pre}embeddings.position_embedding.weight":
          _t32(params["position_embedding"]),
          f"{pre}final_layer_norm.weight": _t32(params["final_layer_norm_w"]),
          f"{pre}final_layer_norm.bias": _t32(params["final_layer_norm_b"]),
          "text_projection.weight": _dense(params["text_projection"])}
    i = 0
    while f"layers_{i}" in params:
        p, lp = params[f"layers_{i}"], f"{pre}encoder.layers.{i}."
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{lp}{ln}.weight"] = _t32(p[f"{ln}_w"])
            sd[f"{lp}{ln}.bias"] = _t32(p[f"{ln}_b"])
        for name, where in (("q_proj", "self_attn"), ("k_proj", "self_attn"),
                            ("v_proj", "self_attn"), ("out_proj", "self_attn"),
                            ("fc1", "mlp"), ("fc2", "mlp")):
            sd[f"{lp}{where}.{name}.weight"] = _dense(p[name]["kernel"])
            sd[f"{lp}{where}.{name}.bias"] = _t32(p[name]["bias"])
        i += 1
    return sd


def gemma2_state_dict_from_jax(params: Mapping) -> dict:
    """Gemma2Encoder params (`import_gemma2_state_dict`'s tree) -> the
    transformers Gemma2Model names of `models.gemma2.Gemma2Encoder`."""
    sd = {"embed_tokens.weight": _t32(params["embed_tokens"]),
          "norm.weight": _t32(params["norm"])}
    i = 0
    while f"layers_{i}" in params:
        p, lp = params[f"layers_{i}"], f"layers.{i}."
        for ln in ("input_layernorm", "post_attention_layernorm",
                   "pre_feedforward_layernorm", "post_feedforward_layernorm"):
            sd[f"{lp}{ln}.weight"] = _t32(p[ln])
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            sd[f"{lp}self_attn.{name}.weight"] = _dense(p[name]["kernel"])
        for name in ("gate_proj", "up_proj", "down_proj"):
            sd[f"{lp}mlp.{name}.weight"] = _dense(p[name]["kernel"])
        i += 1
    return sd


def modernbert_state_dict_from_jax(params: Mapping) -> dict:
    """ModernBertEncoder params (`import_modernbert_state_dict`'s tree) ->
    the transformers ModernBertModel names of
    `models.modernbert.ModernBertEncoder`; Wqkv stays packed."""
    sd = {"embeddings.tok_embeddings.weight": _t32(params["tok_embeddings"]),
          "embeddings.norm.weight": _t32(params["emb_norm"]),
          "final_norm.weight": _t32(params["final_norm"])}
    i = 0
    while f"layers_{i}" in params:
        p, lp = params[f"layers_{i}"], f"layers.{i}."
        sd[f"{lp}attn.Wqkv.weight"] = _dense(p["Wqkv"]["kernel"])
        sd[f"{lp}attn.Wo.weight"] = _dense(p["Wo"]["kernel"])
        sd[f"{lp}mlp.Wi.weight"] = _dense(p["Wi"]["kernel"])
        sd[f"{lp}mlp.Wo.weight"] = _dense(p["Wo_mlp"]["kernel"])
        sd[f"{lp}mlp_norm.weight"] = _t32(p["mlp_norm"])
        if "attn_norm" in p:
            sd[f"{lp}attn_norm.weight"] = _t32(p["attn_norm"])
        i += 1
    return sd
