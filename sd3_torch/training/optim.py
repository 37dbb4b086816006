"""Optimizers (JAX counterpart: sd3_tpu/training/optim.py, and the optax
chain of sd3_tpu/training/trainer.py::make_optimizer).

Parameters, gradients and moments are dicts {state-dict name: tensor}; the
states carry the JAX field names (`count`, `mu`, `nu`), so the canonical
optimizer artifact can be written from them. `count` is a Python int: the
schedule and the bias corrections are host scalars, and no step reads the
device to know them.

- `adamw`: the optax chain `clip_by_global_norm(clip)` then `optax.adamw`
  (fp32 moments). As optax's `scale_by_learning_rate` does, it takes the
  learning rate at the count BEFORE the step, so the first update under a
  warmup from 0 is exactly zero.
- `adamw_low_mem` (updates, then `apply_updates`) and `fused_adamw_low_mem`
  (one in-place pass): AdamW with bf16 moments, fp32 math, the clip folded
  in as min(1, clip / max(‖g‖, 1e-12)) and the learning rate taken at
  count + 1. Both run the same per-leaf arithmetic (`_low_mem_step`).

- `adamw_8bit` (one in-place pass, as `fused_adamw_low_mem`): both moments
  stored blockwise as fp8-e4m3 (`torch.float8_e4m3fn`), blocks of QBLOCK
  values of the leaf flattened in the JAX layout (`weights.to_jax_layout`,
  so that the blocks and their absmax scales are the JAX package's), leaves
  under QMIN values in bf16; `dequantize_8bit` / `quantize_8bit` go to and
  from the canonical bf16 `AdamWLowMemState`.

Over a mesh (parallel/sharding.py) each rank runs the same arithmetic on
its shards: the clip takes the whole gradient's norm (`norm`, the mesh's
`global_norm`), and the 8-bit blocks stay the whole leaf's (`blocks`: each
shard value keeps the id of its JAX-layout block, and a block's absmax is a
max over the ranks), so every mesh gives the one-process moments.

These are XLA in the JAX package, not Pallas kernels, so plain PyTorch is
their port: `torch._foreach_*` passes over groups of leaves, which bound the
fp32 temporaries (the 8-bit update goes a leaf at a time). They update the
parameters in place, where JAX returns new arrays. `torch.optim.AdamW` is
not used: its schedule and clip are not these.

The optimizer artifact of a checkpoint (`to_artifact`, `from_artifact`) is
the JAX trainer's state for the same TrainConfig: the optax chain's nested
state for `AdamWState`, the `AdamWLowMemState` fields otherwise, an 8-bit
state always in its canonical bf16 form (sd3_tpu/training/trainer.py
save()), so the optax, bf16 and 8-bit trainers of either package resume
from it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from sd3_torch.weights import (from_jax_layout, jax_tree_from_state_dict,
                               state_dict_from_jax, to_jax_layout)

GROUP_ELEMS = 1 << 26   # leaves per foreach pass: ~256 MB of each fp32 temporary


class AdamWLowMemState(NamedTuple):
    count: int
    mu: dict
    nu: dict


class AdamWState(NamedTuple):
    """optax's ScaleByAdamState: fp32 moments."""
    count: int
    mu: dict
    nu: dict


class GradientTransformation(NamedTuple):
    """(init(params) -> state, update(grads, state, params) -> (updates,
    state)), as optax's."""
    init: Callable
    update: Callable


def leaf_groups(names, tensors: dict):
    """Consecutive runs of `names` holding at most GROUP_ELEMS elements (a
    larger leaf alone)."""
    group, size = [], 0
    for n in names:
        numel = tensors[n].numel()
        if group and size + numel > GROUP_ELEMS:
            yield group
            group, size = [], 0
        group.append(n)
        size += numel
    if group:
        yield group


def global_norm_f32(grads: dict) -> torch.Tensor:
    """Global L2 norm with a per-leaf fp32 upcast (0-d fp32 tensor): the
    squares are summed in fp32 per leaf, no fp32 copy of a bf16 tree is
    made."""
    norms = torch._foreach_norm(list(grads.values()), 2, dtype=torch.float32)
    return torch.linalg.vector_norm(torch.stack(norms))


def _bias_corrections(b1: float, b2: float, count: int):
    """1 - b1**count and 1 - b2**count in fp32, as JAX computes them."""
    c = np.float32(count)
    one = np.float32(1.0)
    return (float(one - np.float32(b1) ** c), float(one - np.float32(b2) ** c))


def _zeros_like(params: dict, dtype) -> dict:
    return {k: torch.zeros(p.shape, dtype=dtype, device=p.device)
            for k, p in params.items()}


def _clip_scale(gnorm: torch.Tensor, clip_norm) -> torch.Tensor | float:
    """min(1, clip / max(‖g‖, 1e-12)) (optim.py:54-56), a 0-d tensor."""
    if clip_norm is None:
        return 1.0
    return torch.clamp(clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def _low_mem_step(g, mu, nu, p, scale, b1, b2, eps, weight_decay, bc1, bc2):
    """Lists of one group's leaves -> (step, mu_f, nu_f) in fp32, the JAX
    per-leaf arithmetic term by term:
      gf = g * scale;  mu = b1 mu + (1-b1) gf;  nu = b2 nu + (1-b2) gf gf
      step = (mu / bc1) / (sqrt(nu / bc2) + eps) + wd p."""
    f32 = lambda ts: [t.float() for t in ts]
    gf = torch._foreach_mul(f32(g), scale)
    mu_f = torch._foreach_add(torch._foreach_mul(f32(mu), b1),
                              torch._foreach_mul(gf, 1 - b1))
    nu_f = torch._foreach_add(
        torch._foreach_mul(f32(nu), b2),
        torch._foreach_mul(torch._foreach_mul(gf, 1 - b2), gf))
    den = torch._foreach_add(torch._foreach_sqrt(torch._foreach_div(nu_f, bc2)),
                             eps)
    step = torch._foreach_add(
        torch._foreach_div(torch._foreach_div(mu_f, bc1), den),
        torch._foreach_mul(f32(p), weight_decay))
    return step, mu_f, nu_f


def fused_adamw_low_mem(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                        weight_decay=0.01, state_dtype=torch.bfloat16,
                        clip_norm=None, norm=global_norm_f32):
    """Single-pass AdamW over the parameter dict, bf16 moments, fp32 math,
    applied in place. Returns (init, update):
      init(params)                 -> AdamWLowMemState
      update(grads, state, params) -> (params, new state, grad norm)
    `params` are updated in place and returned; the state's moments too.
    `norm`: the gradient's global norm (over a mesh, `TrainMesh.global_norm`
    of the shards)."""

    def init(params):
        return AdamWLowMemState(0, _zeros_like(params, state_dtype),
                                _zeros_like(params, state_dtype))

    @torch.no_grad()
    def update(grads, state, params):
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        gnorm = norm(grads)
        scale = _clip_scale(gnorm, clip_norm)
        bc1, bc2 = _bias_corrections(b1, b2, count)
        for names in leaf_groups(list(params), params):
            pick = lambda d: [d[n] for n in names]
            step, mu_f, nu_f = _low_mem_step(
                pick(grads), pick(state.mu), pick(state.nu), pick(params),
                scale, b1, b2, eps, weight_decay, bc1, bc2)
            new_p = torch._foreach_sub([p.float() for p in pick(params)],
                                       torch._foreach_mul(step, lr))
            torch._foreach_copy_(pick(params), new_p)
            torch._foreach_copy_(pick(state.mu), mu_f)  # round to nearest even
            torch._foreach_copy_(pick(state.nu), nu_f)
        return params, AdamWLowMemState(count, state.mu, state.nu), gnorm

    return init, update


def adamw_low_mem(learning_rate, b1=0.9, b2=0.999, eps=1e-8,
                  weight_decay=0.01, state_dtype=torch.bfloat16,
                  clip_norm=None, norm=global_norm_f32
                  ) -> GradientTransformation:
    """AdamW with bf16 moments as a transformation: update returns the
    updates (-lr * step, in each parameter's dtype) and the new state; the
    moments are replaced in place. `clip_norm` is folded in, as
    `fused_adamw_low_mem` does (an outer clip would promote a bf16 grad tree
    to fp32)."""

    def init(params):
        return AdamWLowMemState(0, _zeros_like(params, state_dtype),
                                _zeros_like(params, state_dtype))

    @torch.no_grad()
    def update(grads, state, params):
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        scale = (_clip_scale(norm(grads), clip_norm)
                 if clip_norm is not None else 1.0)
        bc1, bc2 = _bias_corrections(b1, b2, count)
        updates = {}
        for names in leaf_groups(list(params), params):
            pick = lambda d: [d[n] for n in names]
            step, mu_f, nu_f = _low_mem_step(
                pick(grads), pick(state.mu), pick(state.nu), pick(params),
                scale, b1, b2, eps, weight_decay, bc1, bc2)
            for n, s in zip(names, torch._foreach_mul(step, -lr)):
                updates[n] = s.to(params[n].dtype)
            torch._foreach_copy_(pick(state.mu), mu_f)
            torch._foreach_copy_(pick(state.nu), nu_f)
        return updates, AdamWLowMemState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


def clip_by_global_norm(grads: dict, max_norm: float,
                        norm=global_norm_f32) -> dict:
    """optax.clip_by_global_norm: g where ‖g‖ < max_norm, else
    (g / ‖g‖) * max_norm."""
    g_norm = norm(grads)
    trigger = g_norm < max_norm
    return {k: torch.where(trigger, g, (g / g_norm.to(g.dtype)) * max_norm)
            for k, g in grads.items()}


def adamw(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
          clip_norm=None, norm=global_norm_f32) -> GradientTransformation:
    """`optax.chain(optax.clip_by_global_norm(clip_norm), optax.adamw(...))`
    (no clip when clip_norm is None): fp32 moments; mu, nu and the bias
    corrections at count + 1 as scale_by_adam; the learning rate at the count
    before the step, as scale_by_learning_rate. Moments replaced in place."""

    def init(params):
        return AdamWState(0, _zeros_like(params, torch.float32),
                          _zeros_like(params, torch.float32))

    @torch.no_grad()
    def update(grads, state, params):
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm, norm)
        lr = (learning_rate(state.count) if callable(learning_rate)
              else learning_rate)
        count = state.count + 1
        bc1, bc2 = _bias_corrections(b1, b2, count)
        updates = {}
        for names in leaf_groups(list(params), params):
            pick = lambda d: [d[n] for n in names]
            g = pick(grads)
            # optax: (1 - decay) * g**order + decay * moment
            mu = torch._foreach_add(torch._foreach_mul(g, 1 - b1),
                                    torch._foreach_mul(pick(state.mu), b1))
            nu = torch._foreach_add(
                torch._foreach_mul(torch._foreach_mul(g, g), 1 - b2),
                torch._foreach_mul(pick(state.nu), b2))
            den = torch._foreach_add(
                torch._foreach_sqrt(torch._foreach_div(nu, bc2)), eps)
            u = torch._foreach_add(torch._foreach_div(
                torch._foreach_div(mu, bc1), den),
                torch._foreach_mul(pick(params), weight_decay))
            for n, x in zip(names, torch._foreach_mul(u, -lr)):
                updates[n] = x
            torch._foreach_copy_(pick(state.mu), mu)
            torch._foreach_copy_(pick(state.nu), nu)
        return updates, AdamWState(count, state.mu, state.nu)

    return GradientTransformation(init, update)


@torch.no_grad()
def apply_updates(params: dict, updates: dict) -> dict:
    """optax.apply_updates in place: p = p + u in p's dtype."""
    names = list(params)
    torch._foreach_add_([params[n] for n in names],
                        [updates[n].to(params[n].dtype) for n in names])
    return params


# ---- 8-bit moments ---------------------------------------------------------

QBLOCK = 256     # quantization block (one absmax scale per QBLOCK values)
QMIN = 4096      # leaves below this many values keep bf16 moments
F8MAX = 448.0    # the largest finite float8_e4m3fn


class Adam8bitState(NamedTuple):
    """Per leaf: `*_q` the fp8-e4m3 moments (n_blocks, QBLOCK) and `*_s`
    their fp32 block scales (n_blocks, 1); a leaf under QMIN values keeps
    bf16 moments shaped like it, with an empty (0,) scale. Over a mesh
    (`blocks`) the fp8 moments are shaped like the rank's shard and the
    scales are those of all the leaf's blocks, (n_blocks,)."""
    count: int
    mu_q: dict
    mu_s: dict
    nu_q: dict
    nu_s: dict


def _numel(n: str, p: torch.Tensor, blocks) -> int:
    """The whole leaf's number of values (p may be a shard)."""
    return p.numel() if blocks is None else blocks.numel(n)


def _blockify(name: str, x32: torch.Tensor) -> torch.Tensor:
    """Leaf `name` (the port's layout) flattened in the JAX layout, zero-
    padded to whole blocks: (n_blocks, QBLOCK)."""
    flat = to_jax_layout(name, x32).reshape(-1)
    nb = -(-flat.numel() // QBLOCK)
    return torch.nn.functional.pad(flat, (0, nb * QBLOCK - flat.numel())
                                   ).reshape(nb, QBLOCK)


def _unblockify(name: str, xb: torch.Tensor, like: torch.Tensor
                ) -> torch.Tensor:
    """The inverse of `_blockify`: leaf `name` in the port's layout."""
    jshape = to_jax_layout(name, like).shape
    flat = xb.reshape(-1)[:like.numel()]
    return from_jax_layout(name, flat.reshape(jshape), like.shape)


def _q8(xb: torch.Tensor):
    s = torch.clamp(xb.abs().amax(1, keepdim=True), min=1e-20) / F8MAX
    return (xb / s).to(torch.float8_e4m3fn), s


def _dq8(q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return q.float() * s


class _Blocks:
    """A leaf's moments in its JAX-layout blocks: whole (n_blocks, QBLOCK)
    rows without a mesh; over a mesh (`blocks`, a `TrainMesh`) each value
    of the rank's shard with the id of its block, the block scales taken
    over every rank, so that each block and its scale are the one-process
    optimizer's."""

    def __init__(self, name: str, like: torch.Tensor, blocks):
        self.name, self.like, self.mesh = name, like, blocks
        self.nb = -(-_numel(name, like, blocks) // QBLOCK)
        self.bid = None if blocks is None else blocks.block_ids(name, QBLOCK)

    def to_blocks(self, x32):
        return _blockify(self.name, x32) if self.mesh is None else x32

    def from_blocks(self, xb):
        return (_unblockify(self.name, xb, self.like) if self.mesh is None
                else xb)

    def dq(self, q, s):
        return _dq8(q, s) if self.mesh is None else q.float() * s[self.bid]

    def q(self, xb):
        if self.mesh is None:
            return _q8(xb)
        s = torch.clamp(self.mesh.block_absmax(self.bid, xb, self.nb),
                        min=1e-20) / F8MAX
        return (xb / s[self.bid]).to(torch.float8_e4m3fn), s


def adamw_8bit(learning_rate, b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01,
               clip_norm=None, norm=global_norm_f32, blocks=None):
    """AdamW with blockwise fp8-e4m3 moments (sd3_tpu/training/optim.py
    adamw_8bit), fp32 math, applied in place. Returns (init, update):
      init(params)                 -> Adam8bitState
      update(grads, state, params) -> (params, new state, grad norm)
    `norm` as `fused_adamw_low_mem`'s; `blocks`: the `TrainMesh` whose
    shards `params` are (the blocks and their scales stay those of the
    whole leaf), or None."""

    def init(params):
        zq, zs = {}, {}
        for n, p in params.items():
            if _numel(n, p, blocks) < QMIN:
                zq[n] = torch.zeros(p.shape, dtype=torch.bfloat16,
                                    device=p.device)
                zs[n] = torch.zeros(0, device=p.device)
            else:
                nb = -(-_numel(n, p, blocks) // QBLOCK)
                qshape = (nb, QBLOCK) if blocks is None else p.shape
                zq[n] = torch.zeros(qshape, dtype=torch.float8_e4m3fn,
                                    device=p.device)
                zs[n] = torch.zeros((nb, 1) if blocks is None else nb,
                                    device=p.device)
        clone = lambda d: {k: v.clone() for k, v in d.items()}
        return Adam8bitState(0, zq, zs, clone(zq), clone(zs))

    @torch.no_grad()
    def update(grads, state, params):
        count = state.count + 1
        lr = learning_rate(count) if callable(learning_rate) else learning_rate
        gnorm = norm(grads)
        scale = _clip_scale(gnorm, clip_norm)
        c1, c2 = _bias_corrections(b1, b2, count)
        mu_q, mu_s, nu_q, nu_s = (dict(d) for d in state[1:])
        for n, p in params.items():
            gf = grads[n].float() * scale
            pf = p.float()
            if mu_s[n].numel() == 0:  # small leaf: bf16 moments, same math
                mu = b1 * mu_q[n].float() + (1 - b1) * gf
                nu = b2 * nu_q[n].float() + (1 - b2) * gf * gf
                step = (mu / c1) / (torch.sqrt(nu / c2) + eps) \
                    + weight_decay * pf
                mu_q[n], nu_q[n] = mu.bfloat16(), nu.bfloat16()
            else:
                bk = _Blocks(n, p, blocks)
                gb = bk.to_blocks(gf)
                mu = b1 * bk.dq(mu_q[n], mu_s[n]) + (1 - b1) * gb
                nu = b2 * bk.dq(nu_q[n], nu_s[n]) + (1 - b2) * gb * gb
                step_b = (mu / c1) / (torch.sqrt(nu / c2) + eps)
                step = bk.from_blocks(step_b) + weight_decay * pf
                mu_q[n], mu_s[n] = bk.q(mu)
                nu_q[n], nu_s[n] = bk.q(nu)
            p.copy_(pf - lr * step)
        return params, Adam8bitState(count, mu_q, mu_s, nu_q, nu_s), gnorm

    return init, update


def dequantize_8bit(state: Adam8bitState, params: dict, blocks=None
                    ) -> AdamWLowMemState:
    """Adam8bitState -> the canonical bf16 AdamWLowMemState, leaves shaped
    like `params` (over a mesh, `blocks`, the rank's shards)."""
    def dq(q, s, n):
        if s.numel() == 0:
            return q
        bk = _Blocks(n, params[n], blocks)
        return bk.from_blocks(bk.dq(q, s)).bfloat16()

    return AdamWLowMemState(
        state.count,
        {n: dq(state.mu_q[n], state.mu_s[n], n) for n in params},
        {n: dq(state.nu_q[n], state.nu_s[n], n) for n in params})


def quantize_8bit(state: AdamWLowMemState, params: dict, blocks=None
                  ) -> Adam8bitState:
    """The inverse of `dequantize_8bit` (an 8-bit trainer resuming from the
    canonical artifact)."""
    qs = {}
    for key in ("mu", "nu"):
        tree = getattr(state, key)
        q, s = {}, {}
        for n, p in params.items():
            m = torch.as_tensor(tree[n]).to(p.device)
            if _numel(n, p, blocks) < QMIN:
                q[n], s[n] = m.bfloat16(), torch.zeros(0, device=p.device)
            else:
                bk = _Blocks(n, p, blocks)
                q[n], s[n] = bk.q(bk.to_blocks(m.float()))
        qs[key] = (q, s)
    return Adam8bitState(int(state.count), *qs["mu"], *qs["nu"])


# ---- the checkpoint artifact ----------------------------------------------

def to_artifact(state, params: dict):
    """The optimizer artifact tree of `state` (the JAX trainer's for the
    same TrainConfig): the optax chain `clip_by_global_norm` -> `adamw`
    state for AdamWState, ((), (ScaleByAdamState(count, mu, nu),
    EmptyState(), ScaleByScheduleState(count)))); the AdamWLowMemState
    fields otherwise, an Adam8bitState dequantized first. Moments as JAX
    trees on the CPU; count an int32 scalar array, as JAX keeps it."""
    if isinstance(state, Adam8bitState):
        state = dequantize_8bit(state, params)
    count = np.asarray(state.count, np.int32)
    moments = {"count": count, "mu": jax_tree_from_state_dict(state.mu),
               "nu": jax_tree_from_state_dict(state.nu)}
    if isinstance(state, AdamWState):
        return ((), (moments, (), {"count": count}))
    return moments


def from_artifact(art: dict, live, params: dict, patch_size: int = 2,
                  mesh=None):
    """The optimizer state of the artifact `art` (a state dict,
    `checkpoint.load_artifact`) in the form of `live`, the trainer's own
    state: AdamWState from the optax form; AdamWLowMemState or (quantized)
    Adam8bitState from the canonical bf16 form. The moments go to `live`'s
    devices and dtypes; over a `mesh` (a `TrainMesh`), this rank's shards
    of them."""
    optax_form = "count" not in art
    if optax_form != isinstance(live, AdamWState):
        raise ValueError(
            "the optimizer artifact is the " + ("optax AdamW" if optax_form
                                                else "low-memory AdamW")
            + f" state; this trainer's optimizer keeps {type(live).__name__}"
            " (set low_mem_optimizer as the run that wrote it did, or resume"
            " with reset_optim)")
    moments = art["1"]["0"] if optax_form else art
    count = int(moments["count"])
    mu, nu = (state_dict_from_jax(moments[k], patch_size)
              for k in ("mu", "nu"))
    if mesh is not None:
        mu, nu = ({k: mesh.shard(k, v) for k, v in d.items()}
                  for d in (mu, nu))
    if isinstance(live, Adam8bitState):
        return quantize_8bit(AdamWLowMemState(count, mu, nu), params, mesh)
    place = lambda d, like: {k: d[k].to(like[k].device, like[k].dtype)
                             for k in like}
    return type(live)(count, place(mu, live.mu), place(nu, live.nu))
