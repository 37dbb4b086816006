"""Native checkpoints (JAX counterpart: sd3_tpu/training/checkpoint.py).

A checkpoint is the reference's six step-suffixed artifacts (`_names`):
model, model_ema, optim, scheduler and scaler as msgpack, and the
model_params JSON (the config, `MMDiTConfig.to_json`). The msgpack payloads
are flax's state-dict layout, written and read here with `msgpack` alone, so
that a checkpoint either package writes loads in the other bit for bit:

- a container is a map: a dict keeps its keys (in sorted order, as a JAX
  tree holds them), a NamedTuple is keyed by its field names, a list or
  tuple by "0", "1", ... (flax's `to_state_dict`);
- an array is `ExtType(1, packb((shape, dtype name, C-order bytes)))`; a
  numpy scalar `ExtType(3, ...)` of a 0-d array; `bfloat16` goes by that
  name, its bytes read through a uint16 view (numpy has no bfloat16);
- an array of more than 2**30 bytes is flax's chunked form, a map
  {"__msgpack_chunked_array__": True, "shape": {...}, "chunks": {...}} of
  flat pieces of at most 2**30 bytes;
- Python ints and floats stay msgpack numbers.

The trees are the JAX package's: the model and EMA artifacts hold the JAX
parameter tree (`weights.jax_tree_from_state_dict`), the optimizer artifact
the JAX trainer's state for the same TrainConfig (`optim.to_artifact`). The
scaler artifact is the reference's vestigial empty stub, as in JAX.
Arrays read back are CPU tensors. An artifact is written a leaf at a
time into a temporary file that is moved into place once whole.
"""

from __future__ import annotations

import io
import json
import os
from typing import Any, Mapping

import msgpack
import numpy as np
import torch

from sd3_torch.config import MMDiTConfig

MAX_CHUNK_SIZE = 2 ** 30      # flax.serialization.MAX_CHUNK_SIZE
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3
_CHUNKED = "__msgpack_chunked_array__"
# dtype names of the arrays without a numpy dtype: read through a view
_VIEWS = {"bfloat16": (np.int16, torch.int16, torch.bfloat16),
          "float8_e4m3fn": (np.uint8, torch.uint8, torch.float8_e4m3fn)}


def _names(step: int | None) -> dict[str, str]:
    suf = f"_{step}s" if step else ""
    return {
        "model": f"model{suf}.msgpack",
        "ema": f"model_ema{suf}.msgpack",
        "optim": f"optim{suf}.msgpack",
        "scheduler": f"scheduler{suf}.msgpack",
        "scaler": f"scaler{suf}.msgpack",
        "defs": f"model_params{suf}.json",
    }


# ---- the msgpack layout ---------------------------------------------------

def _dtype_name(t: torch.Tensor) -> str:
    for name, (_, _, dt) in _VIEWS.items():
        if t.dtype == dt:
            return name
    return str(t.dtype).removeprefix("torch.")


def _array_bytes(shape, dtype_name: str, data: bytes) -> bytes:
    return msgpack.packb((tuple(shape), dtype_name, data), use_bin_type=True)


def _tensor_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    name = _dtype_name(t)
    raw = t.view(_VIEWS[name][1]) if name in _VIEWS else t
    return _array_bytes(t.shape, name, raw.numpy().tobytes())


def _chunk(x: torch.Tensor) -> dict:
    """flax's `_chunk`: a flat array in pieces of at most MAX_CHUNK_SIZE
    bytes."""
    flat = x.reshape(-1)
    size = max(1, MAX_CHUNK_SIZE // x.element_size())
    pieces = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): p for i, p in enumerate(pieces)}}


def to_state_dict(obj) -> Any:
    """flax's `to_state_dict` of the port's trees: maps keyed by str, array
    leaves (tensors, big ones chunked, or small numpy arrays such as an
    optimizer's count), numbers as they are."""
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return {k: to_state_dict(getattr(obj, k)) for k in obj._fields}
    if isinstance(obj, Mapping):  # in key order, as a JAX tree keeps it
        return {str(k): to_state_dict(obj[k]) for k in sorted(obj, key=str)}
    if isinstance(obj, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(obj)}
    if isinstance(obj, torch.Tensor) and \
            obj.numel() * obj.element_size() > MAX_CHUNK_SIZE:
        return _chunk(obj)
    return obj


def _ext_pack(x):
    if isinstance(x, torch.Tensor):
        return msgpack.ExtType(_EXT_NDARRAY, _tensor_bytes(x))
    if isinstance(x, np.ndarray):
        return msgpack.ExtType(_EXT_NDARRAY, _array_bytes(
            x.shape, x.dtype.name, np.ascontiguousarray(x).tobytes()))
    if isinstance(x, np.generic):
        return msgpack.ExtType(_EXT_NPSCALAR, _array_bytes(
            (), x.dtype.name, np.asarray(x).tobytes()))
    raise TypeError(f"no msgpack form for {type(x)}")


def _pack_into(write, packer: msgpack.Packer, obj) -> None:
    """`packer.pack(obj)`'s bytes handed to `write` a map entry at a time,
    so that no more than one leaf's bytes are held at once."""
    if isinstance(obj, dict):
        write(packer.pack_map_header(len(obj)))
        for k, v in obj.items():
            write(packer.pack(k))
            _pack_into(write, packer, v)
    else:
        write(packer.pack(obj))


def _packer() -> msgpack.Packer:
    return msgpack.Packer(default=_ext_pack, strict_types=True)


def to_bytes(tree) -> bytes:
    """The msgpack bytes of `tree` in flax's layout."""
    buf = io.BytesIO()
    _pack_into(buf.write, _packer(), to_state_dict(tree))
    return buf.getvalue()


def write_artifact(path: str, tree) -> None:
    """`to_bytes(tree)` streamed into `path` a leaf at a time: written to
    `path`.tmp and moved into place once whole, so that an interrupted save
    leaves no truncated file under the artifact's name."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            _pack_into(f.write, _packer(), to_state_dict(tree))
    except BaseException:
        os.remove(tmp)
        raise
    os.replace(tmp, path)


def _array_from_bytes(data: bytes) -> torch.Tensor:
    shape, name, buf = msgpack.unpackb(data, raw=True)
    name = name.decode()
    if name in _VIEWS:
        view, _, dtype = _VIEWS[name]
        arr = np.frombuffer(buf, dtype=view).copy()
        return torch.from_numpy(arr).view(dtype).reshape(shape)
    arr = np.frombuffer(buf, dtype=np.dtype(name)).copy()
    return torch.from_numpy(arr).reshape(shape)


def _ext_unpack(code, data):
    if code == _EXT_NDARRAY:
        return _array_from_bytes(data)
    if code == _EXT_NPSCALAR:
        return _array_from_bytes(data).item()
    return msgpack.ExtType(code, data)


def _unchunk(d):
    if isinstance(d, dict):
        if _CHUNKED in d:
            shape = [d["shape"][str(i)] for i in range(len(d["shape"]))]
            chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
            return torch.cat(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in d.items()}
    return d


def from_bytes(data: bytes) -> Any:
    """The state dict of msgpack bytes in flax's layout: maps, CPU tensors,
    numbers."""
    return _unchunk(msgpack.unpackb(data, ext_hook=_ext_unpack, raw=False))


# ---- the artifacts --------------------------------------------------------

def save_checkpoint(save_dir: str, cfg: MMDiTConfig, params,
                    ema_params=None, opt_state=None, scheduler_state=None,
                    step: int | None = None, wandb_id: str | None = None
                    ) -> dict[str, str]:
    """Write the six artifacts (the reference saveModel layout): `params`
    and `ema_params` JAX parameter trees, `opt_state` the optimizer's
    artifact tree, `scheduler_state` a dict. Returns the file names."""
    os.makedirs(save_dir, exist_ok=True)
    names = _names(step)
    if step:
        cfg = cfg.replace(start_step=step)
    if wandb_id is not None:
        cfg = cfg.replace(wandb_id=wandb_id)

    def dump(name, tree):
        write_artifact(os.path.join(save_dir, name), tree)

    dump(names["model"], params)
    if ema_params is not None:
        dump(names["ema"], ema_params)
    if opt_state is not None:
        dump(names["optim"], opt_state)
    if scheduler_state is not None:
        dump(names["scheduler"], scheduler_state)
    dump(names["scaler"], {})  # vestigial, as in the JAX package
    with open(os.path.join(save_dir, names["defs"]), "w") as f:
        f.write(cfg.to_json())
    return names


def load_config(load_dir: str, defs_file: str,
                update_max_res: int | None = None) -> MMDiTConfig:
    with open(os.path.join(load_dir, defs_file)) as f:
        overrides = {}
        if update_max_res is not None:
            overrides["max_res"] = update_max_res
        return MMDiTConfig.from_json_dict(json.load(f), **overrides)


def load_artifact(load_dir: str, name: str) -> Any:
    """One msgpack artifact as a state dict (maps of CPU tensors)."""
    with open(os.path.join(load_dir, name), "rb") as f:
        return from_bytes(f.read())


def load_checkpoint(load_dir: str, step: int,
                    keys=("ema", "optim", "scheduler")) -> dict:
    """The artifacts of `step`: {"cfg", "params"} and each of `keys` whose
    file exists, as state dicts."""
    names = _names(step)
    out = {"cfg": load_config(load_dir, names["defs"]),
           "params": load_artifact(load_dir, names["model"])}
    for key in keys:
        if os.path.exists(os.path.join(load_dir, names[key])):
            out[key] = load_artifact(load_dir, names[key])
    return out
