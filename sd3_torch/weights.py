"""Weights across the two packages and from reference checkpoints.

- `state_dict_from_jax(params)`: the JAX package's MMDiT parameter tree
  (nested dicts of arrays) -> this port's state_dict. The port's own copy of
  the name mapping of `sd3_tpu/training/checkpoint.py::export_to_torch_state_dict`
  (reference state-dict names), except that the patch-embedding kernel
  (C*p*p, O) becomes the reference's Conv2d weight `pos_enc.proj.weight`
  (O, C, p, p) instead of staying 2-D. A quantized tree (JAX
  `quantize_params`) crosses too: `kernel_q` (in, out) int8 becomes
  `weight_q` (out, in) int8 and `kernel_scale` becomes `weight_scale` fp32,
  the buffers of `ops.quant.Int8Linear`.
- `jax_tree_from_state_dict(sd)`: the exact inverse, the port's state_dict
  (or any dict keyed like it: EMA, optimizer moments) -> the JAX package's
  parameter tree of CPU tensors in the JAX layout, each in its dtype; the
  form the checkpoints hold (`training/checkpoint.py`). `to_jax_layout` /
  `from_jax_layout` are its per-leaf halves.
- `load_reference_state_dict(model, sd)`: drops the recomputed buffers a
  reference checkpoint carries (rotary tables, the absolute sin-cos table)
  and loads the rest strictly.
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
