"""sd3_torch: the PyTorch/CUDA port of sd3_tpu for one NVIDIA H100.

Plain PyTorch modules and functions around hand-written Hopper kernels
(sources in `csrc/`, built at first use by `kernels.py`). Entry points run on
`cuda` unless the caller passes `device="cpu"`; they raise, never fall back,
when asked for a GPU that is not there.
"""

from __future__ import annotations

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and none is there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """Config dtype string ("bfloat16", "float32") -> torch.dtype."""
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return _DTYPES[name]
