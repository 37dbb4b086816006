"""Multi-process initialization (JAX counterpart:
sd3_tpu/parallel/multihost.py).

The JAX package calls `jax.distributed.initialize()` once per host, after
which one program spans every device. The port runs one process per device:
`initialize` makes the `torch.distributed` process group, over NCCL on the
card and gloo on the CPU, from an explicit coordinator address, world size
and rank, or from torchrun's environment (RANK, WORLD_SIZE, MASTER_ADDR,
MASTER_PORT, LOCAL_RANK) when none is given. A CUDA run without NCCL raises:
it never drops to gloo.

Each data rank loads its own rows of the global batch (`host_batch_slice`).
`global_batch_from_local` has no counterpart: there is no global array to
assemble, each process keeps its own rows and the trainer averages the
gradients over the data ranks.
"""

from __future__ import annotations

import datetime
import os

DEFAULT_TIMEOUT_S = 600
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               timeout_s: float | None = None):
    """Make the process group: NCCL when `device` is a card (whose index is
    then LOCAL_RANK, or the rank modulo the cards), gloo on the CPU.
    `coordinator_address` ("host:port" of rank 0) with `num_processes` and
    `process_id`, or torchrun's environment; a collective that waits longer
    than `timeout_s` (default DEFAULT_TIMEOUT_S) raises. Returns the device
    this process trains on."""
    import torch
    import torch.distributed as dist

    from sd3_torch import resolve_device

    if dist.is_initialized():
        raise RuntimeError("the process group is already initialized")
    dev = resolve_device(device)
    if coordinator_address:
        if num_processes is None or process_id is None:
            raise ValueError("--coordinator_address needs --num_processes "
                             "and --process_id")
        kw = dict(init_method=f"tcp://{coordinator_address}",
                  world_size=num_processes, rank=process_id)
        rank = process_id
    elif all(k in os.environ for k in _TORCHRUN_ENV):
        kw = dict(init_method="env://")
        rank = int(os.environ["RANK"])
    else:
        raise RuntimeError(
            "multi-process training needs --coordinator_address, "
            "--num_processes and --process_id, or torchrun's environment ("
            + ", ".join(_TORCHRUN_ENV) + "); neither was given")
    timeout = datetime.timedelta(seconds=timeout_s or DEFAULT_TIMEOUT_S)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL: a CUDA run does not "
                               "fall back to gloo")
        local = int(os.environ.get("LOCAL_RANK",
                                   rank % torch.cuda.device_count()))
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl", timeout=timeout, device_id=dev, **kw)
    else:
        dist.init_process_group("gloo", timeout=timeout, **kw)
    return dev


def is_main_process() -> bool:
    """Rank 0, or no process group (reference multi_gpu_helpers
    is_main_process)."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def host_batch_slice(global_batch: int, mesh=None) -> slice:
    """The [start, stop) rows of the global batch this process loads: by
    data rank over `mesh` (the tp ranks of a data group load the same rows),
    else by rank over the process group (one group: every row)."""
    import torch.distributed as dist

    from sd3_torch.parallel.mesh import data_index

    if mesh is not None:
        i, n = data_index(mesh)
    elif dist.is_initialized():
        i, n = dist.get_rank(), dist.get_world_size()
    else:
        i, n = 0, 1
    per = global_batch // n
    if per * n != global_batch:
        raise ValueError(f"global batch {global_batch} does not split over "
                         f"{n} data ranks")
    return slice(i * per, (i + 1) * per)
