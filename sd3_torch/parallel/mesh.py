"""The process mesh (JAX counterpart: sd3_tpu/parallel/mesh.py).

The JAX package lays one `jax.sharding.Mesh` over ("dp", "fsdp", "tp") and
lets GSPMD insert the collectives. The port runs one process per device
(`torch.distributed`, NCCL on the card, gloo on the CPU) and lays a
`DeviceMesh` of the same three named axes over the processes, row-major:
rank = (dp_index * fsdp + fsdp_index) * tp + tp_index.

- "dp"   — data parallelism: parameters replicated, gradients averaged;
- "fsdp" — data parallelism with the fp32 masters, the EMA and the optimizer
           moments sharded (training/trainer.py, parallel/sharding.py);
- "tp"   — tensor parallelism over the attention heads and the MLP hidden.

The data ranks are dp x fsdp: the tp ranks of one data group see the same
rows.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    dp: int = 1
    fsdp: int = -1   # -1: absorb all remaining ranks
    tp: int = 1

    def resolve(self, n_devices: int) -> tuple[int, int, int]:
        """(dp, fsdp, tp) over `n_devices` ranks, -1 taking what the others
        leave; raises ValueError when the product is not `n_devices`."""
        dp, fsdp, tp = self.dp, self.fsdp, self.tp
        known = [d for d in (dp, fsdp, tp) if d != -1]
        rem = n_devices // math.prod(known) if known else n_devices
        dims = tuple(rem if d == -1 else d for d in (dp, fsdp, tp))
        if math.prod(dims) != n_devices:
            raise ValueError(f"mesh {dims} does not cover {n_devices} "
                             "devices")
        return dims


def make_mesh(cfg: MeshConfig | None = None, device_type: str | None = None):
    """The DeviceMesh ("dp", "fsdp", "tp") over the initialised process
    group (`multihost.initialize`), on `device_type` ("cuda" under NCCL,
    "cpu" under gloo, by default from the group's backend)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "sd3_torch.parallel.multihost.initialize first")
    cfg = cfg or MeshConfig()
    dims = cfg.resolve(dist.get_world_size())
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, dims,
                            mesh_dim_names=("dp", "fsdp", "tp"))


def data_index(mesh) -> tuple[int, int]:
    """(this rank's data rank, the number of data ranks): dp x fsdp, the tp
    ranks of a data group sharing one."""
    dp_i, f_i, _ = mesh.get_coordinate()
    fsdp = mesh.size(1)
    return dp_i * fsdp + f_i, mesh.size(0) * fsdp
