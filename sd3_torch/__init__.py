"""sd3_torch: the PyTorch/CUDA port of sd3_tpu for one NVIDIA H100.

Plain PyTorch modules and functions around hand-written Hopper kernels
(sources in `csrc/`, built at first use by `kernels.py`). Entry points run on
`cuda` unless the caller passes `device="cpu"`; they raise, never fall back,
when asked for a GPU that is not there. Importing the package root imports
no torch (the data loader's worker processes decode without it).
"""

from __future__ import annotations

_DTYPES = ("float32", "bfloat16", "float16")


def resolve_device(device="cuda"):
    """torch.device for `device`; raises if it names CUDA and none is there."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def to_device(x, device):
    """x (a tensor or numpy array) on `device`; from the host onto a card
    through pinned memory, without waiting for the work queued there."""
    import torch
    t = torch.as_tensor(x)
    if t.device == device:
        return t
    if device.type == "cuda" and t.device.type == "cpu":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def torch_dtype(name):
    """Config dtype string ("bfloat16", "float32") -> torch.dtype."""
    import torch
    if isinstance(name, torch.dtype):
        return name
    if name not in _DTYPES:
        raise ValueError(f"unsupported dtype {name!r}")
    return getattr(torch, name)
