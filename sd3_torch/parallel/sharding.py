"""Parameter sharding over the ("dp", "fsdp", "tp") mesh (JAX counterpart:
sd3_tpu/parallel/sharding.py).

The JAX package annotates each leaf with a PartitionSpec and lets GSPMD
insert the collectives. The port's layouts are explicit, and its
collectives are written out (`TrainMesh`):

- tp (megatron style): each tp rank's model holds its part of the q/k/v
  projections (output rows, a run of whole heads), of the attention out-
  projections (input columns), of the packed SwiGLU w12 and its bias (its
  slice of *both* halves, so that the local `chunk(2)` pairs them; the
  checkpoint keeps the packed layout), of w3 (input columns), and of gelu's
  lin_up / lin_down. `to_tp` / `from_tp` are megatron's f and g: identity
  forward and a tp sum backward on the inputs of the split projections, a
  tp sum forward on the outputs of the split out-projections (whose bias
  is added once, after it). Flash attention (K5, K6a, K6b on the card) runs
  on the local heads.
- fsdp (ZeRO style): each rank keeps 1/fsdp of the fp32 masters, the EMA
  and the optimizer moments, on the axis JAX's rules name. Once a step the
  masters are all-gathered over fsdp into the model's parameters (in bf16
  under precast, as FSDP's bf16 param_dtype), so the model holds its
  tp part of every weight whole for the step; the gradients are averaged
  over the data ranks and each rank keeps its fsdp shard.
- dp: replicas; the gradients are averaged over dp x fsdp (the data group).

The rule table is JAX's, over the leaf's JAX path (`weights.jax_path`); a
JAX kernel (in, out) is a torch Linear weight (out, in), so a JAX axis i of
a kernel is torch dim 1 - i (the patch Conv2d (O, C, p, p) shards C where
JAX shards C*p*p). Layout choices JAX does not make:
- head granularity: a local kernel cannot split a head, where GSPMD may
  split 1216 columns mid-head and reshard. So the attention projections are
  tp-split only when tp divides the head count (not the published 19), and
  then cosine attention's `norm_const` (1, H, 1, 1) is split over heads
  too; where tp does not divide it, the attention stays replicated over tp
  and the MLP (hidden 4864) is still split. The numbers are the same.
- the per-head q / k RMSNorm weights of a split attention are replicated,
  and their gradients are summed over the tp ranks (each sees its heads).
- a dim that the mesh axis does not divide stays unsplit (`_shrink_to_fit`
  of JAX), as do 1-D leaves over fsdp.
- under `scan_blocks` the stacked leaves take the unrolled leaf's spec
  shifted one dim right (the stack axis stays whole), as JAX's
  `blocks_stack` rule; the optimizer, masters and EMA are by the unrolled
  names, so only the model's own parameters are stacked.

`constrain_batch` / `constrain_replicated` are GSPMD layout hints inside the
JAX model; under explicit layouts nothing reshards, and they have no
counterpart.
"""

from __future__ import annotations

import dataclasses
import math
import re

import torch
import torch.distributed as dist

from sd3_torch.weights import from_jax_layout, jax_path, to_jax_layout

# (regex over the "/"-joined JAX path, mesh axis of each JAX dim): the JAX
# package's table (sd3_tpu/parallel/sharding.py:30-42); first match wins
_RULES: list[tuple[str, tuple]] = [
    (r".*attn/(query|key|value)_proj_(x|c)/kernel$", ("fsdp", "tp")),
    (r".*attn/(query|key|value)_proj/kernel$", ("fsdp", "tp")),
    (r".*attn/out_proj(_x|_c)?/kernel$", ("tp", "fsdp")),
    (r".*/w12/kernel$", ("fsdp", "tp")),
    (r".*/w3/kernel$", ("tp", "fsdp")),
    (r".*/lin_up/kernel$", ("fsdp", "tp")),
    (r".*/lin_down/kernel$", ("tp", "fsdp")),
    (r".*/w12/bias$", ("tp",)),
    (r".*/lin_up/bias$", ("tp",)),
    (r".*kernel$", ("fsdp", None)),
]
_HEAD_SPLIT = re.compile(r".*attn/(query|key|value|out)_proj(_x|_c)?/kernel$")
_NORM_CONST = re.compile(r"(.*\.)?attn\.norm_const$")
_QK_NORM = re.compile(r"(.*\.)?attn\.(q|k)_norm(_x|_c)?\.weight$")
_STACK = re.compile(r"blocks_stack\.block(_odd)?\.")


@dataclasses.dataclass(frozen=True)
class LeafSpec:
    """Where a leaf is split: `tp` / `fsdp` the torch dim split over that
    axis (None: replicated over it); `pairs`: tp takes its slice of each
    half of the packed w12; `tp_sum`: replicated over tp, the gradient summed
    over the tp ranks."""
    tp: int | None = None
    fsdp: int | None = None
    pairs: bool = False
    tp_sum: bool = False

    def shifted(self) -> "LeafSpec":
        """The spec of a stack of such leaves (a leading stack axis)."""
        up = lambda d: None if d is None else d + 1
        return dataclasses.replace(self, tp=up(self.tp), fsdp=up(self.fsdp))


def heads_split(num_heads: int, tp: int) -> bool:
    """tp splits the attention: it divides the head count."""
    return tp > 1 and num_heads % tp == 0


def leaf_spec(name: str, shape, num_heads: int, fsdp: int, tp: int
              ) -> LeafSpec:
    """The spec of the canonical (unrolled) leaf `name` of `shape` in a
    model of `num_heads` heads, on a mesh of `fsdp` x `tp`."""
    parts = jax_path(name)
    path = "/".join(parts)
    axes = next((ax for pat, ax in _RULES if re.fullmatch(pat, path)), ())
    kernel = parts[-1] == "kernel"
    dims = {a: (1 - i if kernel else i) for i, a in enumerate(axes)
            if a is not None}
    heads = heads_split(num_heads, tp)
    tp_dim, fsdp_dim = dims.get("tp"), dims.get("fsdp")
    pairs = bool(re.fullmatch(r".*/w12/(kernel|bias)$", path))
    if _HEAD_SPLIT.fullmatch(path):
        tp_dim = tp_dim if heads else None
    elif _NORM_CONST.fullmatch(name):
        tp_dim = 1 if heads else None
    elif tp_dim is not None:
        size = shape[tp_dim] // (2 if pairs else 1)
        tp_dim = tp_dim if tp > 1 and size % tp == 0 else None
    if fsdp_dim is not None and not (fsdp > 1 and shape[fsdp_dim] % fsdp == 0):
        fsdp_dim = None
    return LeafSpec(tp_dim, fsdp_dim, pairs and tp_dim is not None,
                    heads and bool(_QK_NORM.fullmatch(name)))


def _canonical_name(name: str) -> tuple[str, bool]:
    """(a canonical name with the rules of model-layout leaf `name`,
    whether `name` is a stack)."""
    m = _STACK.match(name)
    return (f"blocks.0.{name[m.end():]}", True) if m else (name, False)


class ShardPlan:
    """The spec of every canonical leaf of a model on a (dp, fsdp, tp)
    mesh, and the slicing that follows from it (no collectives)."""

    def __init__(self, shapes: dict, num_heads: int, dims: tuple):
        self.dp, self.fsdp, self.tp = dims
        self.num_heads = num_heads
        self.shapes = {n: tuple(s) for n, s in shapes.items()}
        self.specs = {n: leaf_spec(n, s, num_heads, self.fsdp, self.tp)
                      for n, s in self.shapes.items()}

    def model_spec(self, name: str, shape) -> LeafSpec:
        """The spec of model-layout leaf `name` (a scan stack too)."""
        canon, stacked = _canonical_name(name)
        if not stacked:
            return self.specs[canon]
        return leaf_spec(canon, tuple(shape)[1:], self.num_heads, self.fsdp,
                         self.tp).shifted()

    def tp_part(self, spec: LeafSpec, x: torch.Tensor, t: int
                ) -> torch.Tensor:
        """tp rank t's part of the whole leaf x."""
        if spec.tp is None:
            return x
        if spec.pairs:
            return torch.cat([h.chunk(self.tp, spec.tp)[t]
                              for h in x.chunk(2, spec.tp)], spec.tp)
        return x.chunk(self.tp, spec.tp)[t]

    def tp_join(self, spec: LeafSpec, parts: list) -> torch.Tensor:
        """The inverse of `tp_part` over the tp ranks' parts, in order."""
        if spec.tp is None:
            return parts[0]
        if spec.pairs:
            halves = [p.chunk(2, spec.tp) for p in parts]
            return torch.cat([h[0] for h in halves] + [h[1] for h in halves],
                             spec.tp)
        return torch.cat(parts, spec.tp)

    def fsdp_part(self, spec: LeafSpec, x: torch.Tensor, f: int
                  ) -> torch.Tensor:
        """fsdp rank f's shard of the tp part x."""
        return x if spec.fsdp is None else x.chunk(self.fsdp, spec.fsdp)[f]

    def part(self, name: str, x: torch.Tensor, f: int, t: int
             ) -> torch.Tensor:
        """The shard of canonical leaf `name` (whole: x) that the rank at
        fsdp index f, tp index t holds."""
        spec = self.specs[name]
        return self.fsdp_part(spec, self.tp_part(spec, x, t), f)

    def heads_split(self) -> bool:
        return heads_split(self.num_heads, self.tp)


class _ToTP(torch.autograd.Function):
    """Megatron's f: identity forward, the gradient summed over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _FromTP(torch.autograd.Function):
    """Megatron's g: the partial outputs summed over tp, identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """x entering a tp-split projection (no-op without a tp group)."""
    return x if group is None else _ToTP.apply(x, group)


def from_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The tp sum of a split projection's partial output (no-op without a
    tp group)."""
    return x if group is None else _FromTP.apply(x, group)


def _all_gather(x: torch.Tensor, group) -> list:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return parts


class TrainMesh:
    """The trainer's side of the mesh: the DeviceMesh over the process
    group, this rank's coordinates and data rank, the plan of the model's
    canonical leaves (`shapes`), and the collectives of a step."""

    def __init__(self, device_mesh, shapes: dict, num_heads: int, device):
        from sd3_torch.parallel.mesh import data_index

        self.device_mesh = device_mesh
        self.device = device
        dims = tuple(device_mesh.shape)
        self.plan = ShardPlan(shapes, num_heads, dims)
        self.dp_index, self.f, self.t = device_mesh.get_coordinate()
        self.tp_group = device_mesh.get_group("tp")
        self.fsdp_group = device_mesh.get_group("fsdp")
        self.data_rank, self.n_data = data_index(device_mesh)
        tp, world = dims[2], math.prod(dims)
        # the data group: the ranks of this tp index (dp x fsdp)
        self.data_group, _ = dist.new_subgroups_by_enumeration(
            [list(range(t, world, tp)) for t in range(tp)])

    @property
    def sharded(self) -> bool:
        """The masters are fsdp shards, gathered into the model each
        step."""
        return self.plan.fsdp > 1

    def rows(self, x: torch.Tensor, axis: int = 0) -> torch.Tensor:
        """This data rank's rows of x (axis split in n_data equal parts)."""
        from sd3_torch.parallel.multihost import host_batch_slice

        sl = host_batch_slice(x.shape[axis], self.device_mesh)
        return x.narrow(axis, sl.start, sl.stop - sl.start)

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the whole canonical leaf `name`, a copy."""
        return self.plan.part(name, full, self.f, self.t).clone(
            memory_format=torch.contiguous_format)

    def fsdp_shard(self, name: str, tp_local: torch.Tensor) -> torch.Tensor:
        """This rank's fsdp shard of its tp part of leaf `name`, a copy."""
        return self.plan.fsdp_part(self.plan.specs[name], tp_local,
                                   self.f).clone(
            memory_format=torch.contiguous_format)

    @torch.no_grad()
    def apply_tp(self, model: torch.nn.Module):
        """Cut `model` (whole, every rank the same weights) to this tp
        rank's part: the split leaves sliced in place, the split attention
        modules told their local head count and the tp group, the split
        MLPs their local hidden width."""
        from sd3_torch.ops.attention import JointAttention
        from sd3_torch.ops.mlp import SwiGLU

        if self.plan.tp == 1:
            return
        split_mlps = []
        for mod_name, m in model.named_modules():
            prefix = f"{mod_name}." if mod_name else ""
            if isinstance(m, JointAttention) and self.plan.heads_split():
                if m.fused:
                    raise ValueError("tensor parallelism takes the general "
                                     "attention path (use_fused=False)")
                m.num_heads //= self.plan.tp
                m.tp_group = self.tp_group
            for proj in ("w12", "lin_up"):
                lin = m._modules.get(proj) if isinstance(m, SwiGLU) else None
                if lin is not None and self.plan.model_spec(
                        f"{prefix}{proj}.weight", lin.weight.shape
                ).tp is not None:
                    split_mlps.append(m)
        for m in split_mlps:
            if hasattr(m, "w12"):
                m.hidden //= self.plan.tp
            m.tp_group = self.tp_group
        for name, p in model.named_parameters():
            spec = self.plan.model_spec(name, p.shape)
            if spec.tp is not None:
                p.data = self.plan.tp_part(spec, p.data, self.t).clone(
                    memory_format=torch.contiguous_format)

    def gather(self, name: str, local: torch.Tensor) -> torch.Tensor:
        """The whole canonical leaf `name` from every rank's shard `local`
        (a collective: every rank calls it, in the same order)."""
        spec = self.plan.specs[name]
        x = local
        if spec.fsdp is not None:
            x = torch.cat(_all_gather(x, self.fsdp_group), spec.fsdp)
        if spec.tp is not None:
            x = self.plan.tp_join(spec, _all_gather(x, self.tp_group))
        return x

    def gather_all(self, tree: dict) -> dict:
        """`gather` of every leaf of {canonical name: shard}."""
        return {n: self.gather(n, v) for n, v in tree.items()}

    @torch.no_grad()
    def gather_into(self, dst: dict, src: dict):
        """Write the fsdp-gathered masters `src` ({canonical name: shard})
        into the model's parameters `dst` (its tp part, by canonical name,
        in its own dtype): one all-gather per group of leaves."""
        from sd3_torch.training.optim import leaf_groups

        split = [n for n in src if self.plan.specs[n].fsdp is not None]
        for n in src:
            if self.plan.specs[n].fsdp is None:
                dst[n].copy_(src[n])
        for group in leaf_groups(split, src):
            dt = dst[group[0]].dtype
            flat = torch.cat([src[n].to(dt).reshape(-1) for n in group])
            parts = _all_gather(flat, self.fsdp_group)
            off = 0
            for n in group:
                k, shape = src[n].numel(), src[n].shape
                dst[n].copy_(torch.cat([p[off:off + k].view(shape)
                                        for p in parts],
                                       self.plan.specs[n].fsdp))
                off += k

    def _all_reduce(self, tensors: dict, names: list, group, divide=1):
        """Sum `names` of `tensors` (fp32) over `group` in place of the
        dict's entries, one collective per group of leaves; / divide."""
        from sd3_torch.training.optim import leaf_groups

        for grp in leaf_groups(names, tensors):
            flat = torch.cat([tensors[n].reshape(-1) for n in grp])
            dist.all_reduce(flat, group=group)
            if divide != 1:
                flat.div_(divide)
            off = 0
            for n in grp:
                k = tensors[n].numel()
                tensors[n] = flat[off:off + k].view(tensors[n].shape)
                off += k

    @torch.no_grad()
    def reduce_grads(self, grads: dict) -> dict:
        """The step's gradient from this rank's ({canonical name: the tp
        part's gradient on the local rows}): summed over tp where `tp_sum`,
        averaged over the data ranks in fp32, then this rank's fsdp
        shard."""
        g = {n: v.float() for n, v in grads.items()}
        tp_sum = [n for n in g if self.plan.specs[n].tp_sum]
        if tp_sum:
            self._all_reduce(g, tp_sum, self.tp_group)
        self._all_reduce(g, list(g), self.data_group, self.n_data)
        return {n: (self.fsdp_shard(n, v) if self.plan.specs[n].fsdp
                    is not None else v) for n, v in g.items()}

    def reduce_metrics(self, metrics: dict) -> dict:
        """Each metric averaged over the data ranks (every rank returns the
        global numbers)."""
        keys = list(metrics)
        v = torch.stack([metrics[k].float().reshape(()) for k in keys])
        dist.all_reduce(v, group=self.data_group)
        v = v / self.n_data
        return {k: v[i] for i, k in enumerate(keys)}

    def _owns(self, name: str) -> bool:
        """This rank counts leaf `name`'s shard in a sum over the world:
        one copy of each distinct piece."""
        spec = self.plan.specs[name]
        return (self.dp_index == 0
                and (spec.fsdp is not None or self.f == 0)
                and (spec.tp is not None or self.t == 0))

    def global_norm(self, grads: dict) -> torch.Tensor:
        """The L2 norm of the whole gradient ({canonical name: shard}),
        fp32 squares per leaf, summed over the world."""
        owned = [grads[n] for n in grads if self._owns(n)]
        sq = torch.zeros((), device=self.device, dtype=torch.float32)
        if owned:
            norms = torch._foreach_norm(owned, 2, dtype=torch.float32)
            sq = torch.stack(norms).square().sum()
        dist.all_reduce(sq)
        return sq.sqrt()

    # ---- the 8-bit moments' blocks (training/optim.py adamw_8bit) -------

    def numel(self, name: str) -> int:
        """The whole leaf's number of values."""
        return math.prod(self.plan.shapes[name])

    def block_ids(self, name: str, block: int) -> torch.Tensor:
        """For each value of this rank's shard of `name`, its block of
        `block` values in the whole leaf flattened in the JAX layout (the
        blocks of the one-process 8-bit optimizer)."""
        shape = self.plan.shapes[name]
        jshape = to_jax_layout(name, torch.empty(shape, device="meta")).shape
        idx = torch.arange(self.numel(name), device=self.device)
        idx = from_jax_layout(name, idx.reshape(jshape), shape)
        return self.plan.part(name, idx, self.f, self.t) // block

    def block_absmax(self, bid: torch.Tensor, x: torch.Tensor,
                     n_blocks: int) -> torch.Tensor:
        """(n_blocks,) fp32: the largest |x| of each block over every
        rank's shard."""
        m = torch.zeros(n_blocks, device=x.device, dtype=torch.float32)
        m.scatter_reduce_(0, bid.reshape(-1), x.abs().reshape(-1).float(),
                          "amax")
        dist.all_reduce(m, op=dist.ReduceOp.MAX)
        return m
