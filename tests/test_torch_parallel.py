"""sd3_torch/parallel/ held to sd3_tpu/parallel/, and the trainer over a
mesh of processes (gloo on the CPU) held to the one-process trainer and to
the JAX step.

The mesh and the plan are pure functions: `MeshConfig.resolve` and
`host_batch_slice` against JAX's; every leaf of a tiny model (unrolled and
scan) cut into each rank's shard and put back together, each split on the
axis JAX's rules name (with the head-granularity rule of
parallel/sharding.py).

The trainer runs in worker processes, a world of 2 and one of 4, started
together with a free port each; every process group has a timeout and every
launch a deadline (`LAUNCH_TIMEOUT_S`), past which its processes are killed.
Each run trains a 2-block model (dim 64, 4 heads: tp 2 splits them) for 2
steps at accumulation 2 on the same weights, batches and noise (the JAX
step's draws, as tests/test_torch_train.py builds them) as the one-process
port trainer and the jitted JAX step in this process. fp32 throughout: a
mesh only changes the order of sums. The limits (PORT_LIMITS, JAX_LIMITS;
measured in brackets): the first step's loss and grad norm 1e-5 of the
port (<= 1.6e-7) and 1e-4 of JAX (<= 3.2e-7); the update (the gathered
parameters minus the initial ones) 1e-2 relative L2 (<= 1.5e-3): Adam's
first step divides g by |g| + eps, so an element whose gradient is a
cancellation near eps (7e-8 in "both"'s y_proj) may flip its first update
by a rounding; the later steps start from that update, so their loss is
held to 1e-3 (<= 1.4e-4); the final moments 1e-3 (<= 4.6e-4), in bf16
4e-3 (one bf16 step; 1.1e-4), in fp8 1e-2 (2.1e-4); the EMA 1e-4. The
control, the one-process trainer on the noise rolled by one row, is off
by 2.1e-2 on the first loss, 1.28 on the update, 1.10 on the moments.
"""

import json
import os
import socket
import subprocess
import sys
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models.mmdit import MMDiT as JMMDiT
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.parallel import mesh as jmesh
from sd3_tpu.parallel import multihost as jmultihost
from sd3_tpu.parallel import sharding as jsharding
from sd3_tpu.training import checkpoint as jck
from sd3_tpu.training import flow as jflow
from sd3_tpu.training import optim as joptim
from sd3_tpu.training import trainer as jtr

from sd3_torch.config import MMDiTConfig
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.parallel import MeshConfig, ShardPlan, multihost
from sd3_torch.training import checkpoint as tck
from sd3_torch.training.optim import dequantize_8bit
from sd3_torch.training.trainer import Noise, TrainConfig, Trainer
from sd3_torch.weights import jax_path, state_dict_from_jax, to_jax_layout

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120
GROUP_TIMEOUT_S = 60
STEPS, ACC, BATCH = 2, 2, 4
NOISE_FIELDS = ("t", "eps", "null_pooled", "null_gemma", "null_bert")


# ---- the mesh and the batch slice ------------------------------------------

@pytest.mark.parametrize("dims,n", [
    ((1, -1, 1), 8), ((2, -1, 1), 8), ((2, 2, 2), 8), ((1, 1, 1), 1),
    ((-1, 2, 2), 8), ((1, -1, 4), 4), ((2, -1, 1), 6), ((3, -1, 1), 8),
    ((2, 2, 1), 8), ((1, 1, 2), 1)])
def test_mesh_config_resolves_as_jax(dims, n):
    want = None
    try:
        want = jmesh.MeshConfig(*dims).resolve(n)
    except AssertionError as e:
        assert "does not cover" in str(e)
    if want is None:
        with pytest.raises(ValueError, match="does not cover"):
            MeshConfig(*dims).resolve(n)
    else:
        assert MeshConfig(*dims).resolve(n) == want


@pytest.mark.parametrize("batch,index,count", [
    (8, 0, 1), (8, 0, 2), (8, 1, 2), (12, 2, 4), (6, 1, 3)])
def test_host_batch_slice_is_jaxs(batch, index, count, monkeypatch):
    # JAX slices by process; the port by data rank (one process per device:
    # here a group of `count` processes and no mesh)
    monkeypatch.setattr(jax, "process_index", lambda: index)
    monkeypatch.setattr(jax, "process_count", lambda: count)
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda *a: index)
    monkeypatch.setattr(dist, "get_world_size", lambda *a: count)
    assert multihost.host_batch_slice(batch) == \
        jmultihost.host_batch_slice(batch)
    mesh = types.SimpleNamespace(get_coordinate=lambda: (index, 0, 0),
                                 size=lambda i: (count, 1, 2)[i])
    assert multihost.host_batch_slice(batch, mesh) == \
        jmultihost.host_batch_slice(batch)


def test_initialize_without_an_address_or_torchrun_raises(monkeypatch):
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="coordinator_address"):
        multihost.initialize(device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        multihost.initialize("localhost:1", device="cpu")


# ---- the plan of every leaf --------------------------------------------------

def _jax_axes(name, shape, fsdp, tp):
    """JAX's mesh axis of each torch dim of canonical leaf `name`."""
    jshape = to_jax_layout(name, torch.empty(shape, device="meta")).shape
    mesh = types.SimpleNamespace(shape={"dp": 1, "fsdp": fsdp, "tp": tp})
    spec = jsharding._spec_for("/".join(jax_path(name)), tuple(jshape), mesh)
    kernel = jax_path(name)[-1] == "kernel"
    return {a: (1 - i if kernel else i) for i, a in enumerate(spec)
            if a is not None}


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("dims", [(1, 2, 1), (1, 1, 2), (1, 2, 2),
                                  (2, 2, 2), (1, 4, 2)])
@pytest.mark.parametrize("heads", [4, 3])
def test_every_leaf_splits_on_jaxs_axis_and_gathers_whole(dims, scan, heads):
    # dim 48 x 3 heads: tp 2 cannot split a head, so the attention stays
    # replicated over tp and only the MLP (hidden 96) is split
    cfg = MMDiTConfig.from_json(j_tiny_config(
        dim=16 * heads, num_heads=heads, attn_type="both",
        num_blocks=3).to_json())
    model = MMDiT(cfg, device="cpu", fused_attn=False, scan_blocks=scan)
    full = {k: torch.randn(v.shape, generator=torch.Generator().manual_seed(i))
            for i, (k, v) in enumerate(model.canonical_parameters().items())}
    plan = ShardPlan({k: v.shape for k, v in full.items()}, heads, dims)
    _, fsdp, tp = dims
    head_split = tp > 1 and heads % tp == 0
    held, total, one_d = 0, 0, 0
    for name, x in full.items():
        spec = plan.specs[name]
        jax_axes = _jax_axes(name, x.shape, fsdp, tp)
        if name.endswith("norm_const"):   # JAX replicates it; GSPMD reshards
            assert spec.tp == (1 if head_split else None), name
        elif ".attn." in name and not head_split:
            assert spec.tp is None, name   # the head-granularity rule
        else:
            assert spec.tp == jax_axes.get("tp"), name
        assert spec.fsdp == jax_axes.get("fsdp"), name
        assert spec.tp_sum == (head_split and "_norm" in name
                               and ".attn." in name), name
        parts = [[plan.part(name, x, f, t) for f in range(fsdp)]
                 for t in range(tp)]
        tp_parts = [torch.cat(p, spec.fsdp) if spec.fsdp is not None
                    else p[0] for p in parts]
        assert torch.equal(plan.tp_join(spec, tp_parts), x), name
        split = ((fsdp if spec.fsdp is not None else 1)
                 * (tp if spec.tp is not None else 1))
        assert all(q.numel() * split == x.numel() for p in parts for q in p)
        held += parts[0][0].numel()
        total += x.numel()
        one_d += x.numel() if x.ndim == 1 else 0
    # about 1/fsdp of the values on a rank: every leaf of 2 or more dims is
    # split over fsdp, the 1-D ones (here under 5%) stay whole
    assert one_d < 0.05 * total
    assert held <= total / fsdp + one_d
    # model-layout specs of the scan stacks: the unrolled spec shifted
    if scan:
        for name, p in model.named_parameters():
            if name.startswith("blocks_stack."):
                stack, leaf = name.split(".", 2)[1:]
                one = plan.specs[f"blocks.{int(stack == 'block_odd')}.{leaf}"]
                st = plan.model_spec(name, p.shape)
                assert st.tp == (None if one.tp is None else one.tp + 1)
                assert st.fsdp == (None if one.fsdp is None
                                   else one.fsdp + 1)


def test_the_packed_w12_splits_both_halves():
    cfg = MMDiTConfig.from_json(j_tiny_config(dim=32, num_heads=2,
                                              num_blocks=2).to_json())
    model = MMDiT(cfg, device="cpu", fused_attn=False)
    shapes = {k: v.shape for k, v in model.canonical_parameters().items()}
    plan = ShardPlan(shapes, 2, (1, 1, 2))
    name = "blocks.0.MLP_x.MLP.w12.weight"
    h = shapes[name][0] // 2
    w = torch.arange(2 * h * 32, dtype=torch.float32).reshape(2 * h, 32)
    part = plan.part(name, w, 0, 1)
    # tp rank 1: rows h/2..h of the first half and of the second, so that
    # its chunk(2) pairs x1 and x2 of the same hidden units
    assert torch.equal(part, torch.cat([w[h // 2:h], w[h + h // 2:]]))
    assert plan.specs[name].pairs
    assert plan.specs["blocks.0.attn.q_norm_x.weight"].tp_sum


# ---- the trainer over gloo worlds -------------------------------------------

WORKER = r"""
import json, os, sys, time
import numpy as np
import torch
torch.set_num_threads(1)
from sd3_torch.config import MMDiTConfig
from sd3_torch.parallel import MeshConfig, multihost
from sd3_torch.training.optim import Adam8bitState, dequantize_8bit
from sd3_torch.training.trainer import Noise, TrainConfig, Trainer

rank, world, port, job = (int(sys.argv[1]), int(sys.argv[2]), sys.argv[3],
                          sys.argv[4])
multihost.initialize(f"localhost:{port}", world, rank, device="cpu",
                     timeout_s=float(sys.argv[5]))
import torch.distributed as dist
for run in json.load(open(os.path.join(job, "runs.json"))):
    name = run["name"]
    cfg = MMDiTConfig.from_json(run["cfg"])
    tc = TrainConfig(mesh=MeshConfig(*run["mesh"]),
                     save_dir=os.path.join(job, name), **run["tkw"])
    data = np.load(run["data"])
    params = {k[2:]: torch.from_numpy(data[k]) for k in data.files
              if k.startswith("p/")}
    if run.get("raises"):
        try:
            Trainer(cfg, tc, params=params, device="cpu", use_wandb=False)
            res = "no error"
        except ValueError as e:
            res = str(e)
        json.dump({"error": res}, open(os.path.join(
            job, f"{name}.r{rank}.json"), "w"))
        continue
    tr = Trainer(cfg, tc, params=params, device="cpu", use_wandb=False,
                 log_dir=os.path.join(job, name))
    out = {}
    for i in range(run["steps"]):
        batch = {k: torch.from_numpy(data[f"b{i}/{k}"])
                 for k in ("x0", "text", "pooled")}
        noise = [Noise(*(torch.from_numpy(data[f"n{i}/{j}/{f}"])
                         for f in %(fields)r)) for j in range(run["acc"])]
        m = tr.train_step(batch, noise)
        out[f"loss{i}"] = m["loss"].item()
        out[f"gnorm{i}"] = m["grad_norm"].item()
        for k, v in tr.gather(tr.params).items():
            out[f"p{i}/{k}"] = v.detach().numpy().copy()
    if tr.ema_state() is not None:
        out.update((f"e/{k}", v.detach().numpy())
                   for k, v in tr.gather(tr.ema_state()).items())
    st = tr.opt_state
    plan = tr.mesh.plan
    split = lambda s: ((plan.fsdp if s.fsdp is not None else 1)
                       * (plan.tp if s.tp is not None else 1))
    local = {"masters": sum(v.numel() for v in tr.params.values()),
             "planned": sum(int(np.prod(plan.shapes[k])) // split(s)
                            for k, s in plan.specs.items()),
             "whole": sum(int(np.prod(v)) for v in
                          tr.mesh.plan.shapes.values()),
             "moments": sum(v.numel() for v in (st.mu_q if isinstance(
                 st, Adam8bitState) else st.mu).values()),
             "model": sum(p.numel() for p in tr.model.parameters())}
    if isinstance(st, Adam8bitState):
        st = dequantize_8bit(st, tr.params, tr.mesh)
    out.update((f"mu/{k}", v.float().numpy())
               for k, v in tr.gather(st.mu).items())
    if run.get("save"):
        tr.save()
    json.dump(local, open(os.path.join(job, f"{name}.r{rank}.json"), "w"))
    if rank == 0:
        np.savez(os.path.join(job, f"{name}.out.npz"), **out)
dist.barrier()
dist.destroy_process_group()
print(f"WORKER_OK_{rank}", flush=True)
""" % {"fields": NOISE_FIELDS}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _start(world: int, job: str, script: str = WORKER,
           group_timeout: float = GROUP_TIMEOUT_S):
    """`world` worker processes on a free port (one thread each)."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    return [subprocess.Popen(
        [sys.executable, "-c", script, str(r), str(world), str(port), job,
         str(group_timeout)], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _wait(procs, timeout: float = LAUNCH_TIMEOUT_S) -> list:
    """Each process's (return code, output) within one deadline; past it
    every process still running is killed (return code None)."""
    deadline = time.monotonic() + timeout
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=max(0.1, deadline - time.monotonic()))
            outs.append((p.returncode, out))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            out, _ = p.communicate()
            outs.append((None, out))
    return outs


def _jax_noise(key, x0, tcfg) -> dict:
    """The draws of the JAX micro_loss for `key` (trainer.py:163-169)."""
    k_t, k_eps, k_null, _ = jax.random.split(key, 4)
    b = x0.shape[0]
    t = jflow.sample_t(k_t, b)
    _, eps = jflow.noise_batch(k_eps, jnp.asarray(x0), t)
    masks = jflow.null_masks(k_null, b, tcfg.null_prob_pooled,
                             tcfg.null_prob_gemma, tcfg.null_prob_bert)
    return dict(zip(NOISE_FIELDS, [np.array(t, np.float32),
                                   np.array(eps, np.float32),
                                   *(np.array(m) for m in masks)]))


BASE_TKW = dict(batch_size=BATCH, accumulation_steps=ACC, lr=1e-3,
                warmup_steps=0, ema_update_freq=1, ema_decay=0.9,
                remat_blocks=True)
LOW_MEM = dict(BASE_TKW, low_mem_optimizer=True, fused_optimizer=True,
               track_ema=False)
# name: (model fields, TrainConfig fields, mesh, world, extra)
RUNS = {
    "dp2": ({}, BASE_TKW, (2, 1, 1), 2, {}),
    "fsdp2": ({}, BASE_TKW, (1, 2, 1), 2, {"save": True}),
    "tp2": ({}, BASE_TKW, (1, 1, 2), 2, {}),
    "fused_fsdp2": ({}, LOW_MEM, (1, 2, 1), 2, {}),
    "m8_fsdp2": ({}, dict(LOW_MEM, moments_8bit=True), (1, 2, 1), 2, {}),
    "heads3_tp2": ({"dim": 48, "num_heads": 3}, BASE_TKW, (1, 1, 2), 2, {}),
    "ema_host": ({}, dict(BASE_TKW, ema_on_host=True), (1, 2, 1), 2,
                 {"raises": "ema_on_host"}),
    "fsdp2_tp2": ({}, BASE_TKW, (1, 2, 2), 4, {}),
    "scan_both": ({"attn_type": "both"}, dict(BASE_TKW, scan_blocks=True),
                  (1, 2, 2), 4, {}),
}
JAX_CHECKED = ("dp2", "fsdp2", "tp2", "fused_fsdp2", "m8_fsdp2", "fsdp2_tp2",
               "scan_both")


def _model_cfg(fields):
    kw = dict(dim=64, num_heads=4, attn_type="softmax_flash", num_blocks=2)
    kw.update(fields)
    return j_tiny_config(**kw)


def _data(jcfg, seed):
    """(full params, per-step batches, per-step JAX keys and draws)."""
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(seed), remat_blocks=False)
    r = np.random.default_rng(seed)
    steps = []
    for i in range(STEPS):
        b = {"x0": r.standard_normal((ACC, BATCH, jcfg.inCh, 8, 8)),
             "text": r.standard_normal((ACC, BATCH, jcfg.text_tokens,
                                        jcfg.text_hidden_dim)),
             "pooled": r.standard_normal((ACC, BATCH, jcfg.class_dim))}
        b = {k: v.astype(np.float32) for k, v in b.items()}
        key = jax.random.PRNGKey(100 * seed + i)
        keys = jax.random.split(key, ACC)
        steps.append((b, key, [_jax_noise(keys[j], b["x0"][j],
                                          jtr.TrainConfig())
                               for j in range(ACC)]))
    return params, steps


def _jax_run(jcfg, tkw, params, steps):
    """The jitted JAX step's (losses, grad norms, params after each step)."""
    jtc = jtr.TrainConfig(**{k: v for k, v in tkw.items()
                             if k != "scan_blocks"})
    jm = JMMDiT(jcfg, remat_blocks=True, remat_policy="nothing",
                fused_attn=False)
    if jtc.moments_8bit or jtc.fused_optimizer:
        make = (joptim.adamw_8bit if jtc.moments_8bit
                else joptim.fused_adamw_low_mem)
        init, upd = make(jtr.make_lr_schedule(jtc), b1=0.9, b2=0.999,
                         eps=1e-8, weight_decay=0.01, clip_norm=jtc.grad_clip)
        step = jax.jit(jtr.make_fused_train_step(jm, jtc, upd))
    else:
        opt = jtr.make_optimizer(jtc)
        init = opt.init
        step = jax.jit(jtr.make_train_step(jm, opt, jtc))
    p, st = params, init(params)
    losses, gnorms, ps = [], [], []
    for b, key, _ in steps:
        p, st, m = step(p, st, key, b)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
        ps.append(state_dict_from_jax(p))
    return losses, gnorms, ps


def _port_run(cfg, tkw, params, steps, tmp):
    """The one-process port trainer on the same weights and draws."""
    tr = Trainer(cfg, TrainConfig(**tkw, save_dir=tmp), params=params,
                 device="cpu", log_dir=tmp, use_wandb=False)
    losses, gnorms, ps = [], [], []
    for b, _, noise in steps:
        m = tr.train_step({k: torch.from_numpy(v) for k, v in b.items()},
                          [Noise(*(torch.from_numpy(n[f])
                                   for f in NOISE_FIELDS)) for n in noise])
        losses.append(m["loss"].item())
        gnorms.append(m["grad_norm"].item())
        ps.append({k: v.detach().clone() for k, v in tr.params.items()})
    st = tr.opt_state
    if hasattr(st, "mu_q"):
        st = dequantize_8bit(st, tr.params)
    ema = tr.ema_state()
    return dict(loss=losses, gnorm=gnorms, params=ps,
                mu={k: v.float() for k, v in st.mu.items()},
                ema=None if ema is None else {k: v.detach().clone()
                                              for k, v in ema.items()})


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every run of RUNS in two launches (worlds 2 and 4, started together),
    beside the one-process port trainer and the JAX step on the same data."""
    job = str(tmp_path_factory.mktemp("mesh"))
    data = {}
    for name, (fields, tkw, mesh, world, extra) in RUNS.items():
        jcfg = _model_cfg(fields)
        seed = 7 if fields else 3
        key = json.dumps(fields, sort_keys=True)
        if key not in data:
            data[key] = (f"data{len(data)}", jcfg, *_data(jcfg, seed))
        fname, _, params, steps = data[key]
        arrays = {f"p/{k}": v.numpy() for k, v in
                  state_dict_from_jax(params).items()}
        for i, (b, _, noise) in enumerate(steps):
            arrays.update((f"b{i}/{k}", v) for k, v in b.items())
            for j, n in enumerate(noise):
                arrays.update((f"n{i}/{j}/{f}", n[f]) for f in NOISE_FIELDS)
        np.savez(os.path.join(job, fname + ".npz"), **arrays)
    procs = {}
    for world in (2, 4):
        sub = os.path.join(job, f"w{world}")
        os.makedirs(sub)
        runs = []
        for name, (fields, tkw, mesh, w, extra) in RUNS.items():
            if w != world:
                continue
            fname = data[json.dumps(fields, sort_keys=True)][0]
            runs.append(dict(name=name, cfg=_model_cfg(fields).to_json(),
                             tkw=tkw, mesh=mesh,
                             data=os.path.join(job, fname + ".npz"),
                             steps=STEPS,
                             acc=ACC, **extra))
        json.dump(runs, open(os.path.join(sub, "runs.json"), "w"))
        procs[world] = _start(world, sub)
    try:
        refs, done = {}, {}   # runs of one model and TrainConfig share them
        for name, (fields, tkw, mesh, world, extra) in RUNS.items():
            if "raises" in extra:
                continue
            key = json.dumps([fields, tkw], sort_keys=True)
            _, jcfg, params, steps = data[json.dumps(fields, sort_keys=True)]
            if key not in done:
                cfg = MMDiTConfig.from_json(jcfg.to_json())
                done[key] = _port_run(cfg, tkw, state_dict_from_jax(params),
                                      steps,
                                      str(tmp_path_factory.mktemp(name)))
                done[key]["p0"] = state_dict_from_jax(params)
            if name in JAX_CHECKED and "jax" not in done[key]:
                done[key]["jax"] = _jax_run(jcfg, tkw, params, steps)
            refs[name] = done[key]
    finally:
        outs = {w: _wait(p) for w, p in procs.items()}
    for world, res in outs.items():
        for rank, (rc, out) in enumerate(res):
            assert rc == 0 and f"WORKER_OK_{rank}" in out, \
                f"world {world} rank {rank} rc {rc}:\n{out[-4000:]}"
    return job, refs, data


def _rel_l2(got, want) -> float:
    got = np.concatenate([np.asarray(got[k], np.float64).ravel()
                          for k in sorted(want)])
    want = np.concatenate([np.asarray(want[k], np.float64).ravel()
                           for k in sorted(want)])
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _out(job, name):
    world = RUNS[name][3]
    return np.load(os.path.join(job, f"w{world}", f"{name}.out.npz"))


def _step_params(out, i) -> dict:
    return {k[len(f"p{i}/"):]: out[k] for k in out.files
            if k.startswith(f"p{i}/")}


# Against the one-process port trainer and JAX: the first step's loss and
# grad norm (relative), the later steps' (which start from the first
# update), the update's relative L2, the final moments' and EMA's. See the
# module note; bf16 moments may round a step the other way (2^-8).
PORT_LIMITS = dict(loss=1e-5, later_loss=1e-3, update=1e-2, moments=1e-3,
                   ema=1e-4)
JAX_LIMITS = dict(loss=1e-4, later_loss=1e-3, update=1e-2)
LOW_MEM_LIMITS = dict(moments=4e-3)
M8_LIMITS = dict(moments=1e-2)


def _errors(out, losses, gnorms, params, p0, mu=None, ema=None) -> dict:
    """The largest error over the steps of a mesh run's output `out`
    against a reference's losses, grad norms, parameters after each step
    (and final moments and EMA)."""
    rel = lambda a, b: abs(a - b) / abs(b)
    update = lambda d: {k: np.asarray(v, np.float64) - p0[k]
                        for k, v in d.items()}
    err = dict(loss=0.0, later_loss=0.0, update=0.0)
    for i in range(STEPS):
        key = "later_loss" if i else "loss"
        err[key] = max(err[key], rel(out[f"loss{i}"], losses[i]),
                       rel(out[f"gnorm{i}"], gnorms[i]))
        got = _step_params(out, i)
        assert got.keys() == params[i].keys()
        err["update"] = max(err["update"], _rel_l2(update(got),
                                                   update(params[i])))
    for key, ref in (("mu", mu), ("e", ema)):
        if ref is not None:
            got = {k[len(key) + 1:]: out[k] for k in out.files
                   if k.startswith(key + "/")}
            err["moments" if key == "mu" else "ema"] = _rel_l2(got, ref)
    return err


def _np_tree(d):
    return {k: v.numpy() for k, v in d.items()}


def _port_errors(out, ref) -> dict:
    return _errors(out, ref["loss"], ref["gnorm"],
                   [_np_tree(p) for p in ref["params"]], _np_tree(ref["p0"]),
                   _np_tree(ref["mu"]),
                   None if ref["ema"] is None else _np_tree(ref["ema"]))


def _limits(name, base) -> dict:
    tkw = RUNS[name][1]
    more = (M8_LIMITS if tkw.get("moments_8bit") else
            LOW_MEM_LIMITS if tkw.get("low_mem_optimizer") else {})
    return dict(base, **{k: v for k, v in more.items() if k in base})


@pytest.mark.parametrize("name", [n for n in RUNS
                                  if "raises" not in RUNS[n][4]])
def test_mesh_steps_match_the_one_process_trainer(mesh_runs, name):
    job, refs, _ = mesh_runs
    err = _port_errors(_out(job, name), refs[name])
    lim = _limits(name, PORT_LIMITS)
    for k, v in err.items():
        assert v < lim[k], (k, v, err)


@pytest.mark.parametrize("name", JAX_CHECKED)
def test_mesh_steps_match_the_jax_step(mesh_runs, name):
    job, refs, _ = mesh_runs
    ref = refs[name]
    losses, gnorms, ps = ref["jax"]
    err = _errors(_out(job, name), losses, gnorms,
                  [_np_tree(p) for p in ps], _np_tree(ref["p0"]))
    lim = _limits(name, JAX_LIMITS)
    for k, v in err.items():
        assert v < lim[k], (k, v, err)


def test_a_wrong_row_of_noise_fails_the_limits(mesh_runs, tmp_path):
    # the control: the one-process trainer given each micro-batch's draws
    # rolled by one row (what a rank keeping another rank's rows would
    # train on), against the dp 2 run: past every limit
    job, refs, data = mesh_runs
    fname, jcfg, params, steps = data[json.dumps({}, sort_keys=True)]
    rolled = [(b, key, [{f: np.roll(n[f], 1, axis=0) for f in NOISE_FIELDS}
                        for n in noise]) for b, key, noise in steps]
    ref = _port_run(MMDiTConfig.from_json(jcfg.to_json()), BASE_TKW,
                    state_dict_from_jax(params), rolled, str(tmp_path))
    ref["p0"] = refs["dp2"]["p0"]
    err = _port_errors(_out(job, "dp2"), ref)
    for k in ("loss", "update", "moments"):
        assert err[k] > 10 * PORT_LIMITS[k], (k, err)


@pytest.mark.parametrize("name", ["fsdp2", "fused_fsdp2", "m8_fsdp2",
                                  "fsdp2_tp2", "tp2"])
def test_fsdp_and_tp_shard_the_masters_and_moments(mesh_runs, name):
    # each rank holds about 1/fsdp of the masters and the moments (the 1-D
    # leaves whole: under 3% of this model's values) and, under tp, its tp
    # part of the model's own weights
    job, _, _ = mesh_runs
    _, tkw, (dp, fsdp, tp), world, _ = RUNS[name]
    for r in range(world):
        loc = json.load(open(os.path.join(job, f"w{world}",
                                          f"{name}.r{r}.json")))
        assert loc["masters"] == loc["moments"] == loc["planned"], (r, loc)
        if fsdp > 1:
            assert loc["masters"] / loc["whole"] < 1 / fsdp * 1.05, (r, loc)
        if tp > 1:
            assert loc["model"] < loc["whole"] * 0.8, (r, loc)


def test_tp_keeps_an_undivided_attention_whole(mesh_runs):
    # 3 heads over tp 2: the attention replicated, the MLP split; the
    # numbers are the one-process trainer's (held above)
    job, _, _ = mesh_runs
    loc = json.load(open(os.path.join(job, "w2", "heads3_tp2.r0.json")))
    cfg = MMDiTConfig.from_json(_model_cfg(RUNS["heads3_tp2"][0]).to_json())
    mlp = sum(p.numel() for n, p in MMDiT(cfg, device="cpu").named_parameters()
              if ".MLP_" in n and n.endswith((".w12.weight", ".w3.weight",
                                             ".w12.bias")))
    assert loc["model"] == loc["whole"] - mlp // 2


def test_the_main_process_alone_writes_a_checkpoint_either_package_loads(
        mesh_runs, tmp_path):
    job, refs, _ = mesh_runs
    save = os.path.join(job, "w2", "fsdp2")
    names = sorted(os.listdir(save))
    assert "model_2s.msgpack" in names and "optim_2s.msgpack" in names
    # one metrics file: rank 0's (rank 1 writes none)
    assert sum(n.startswith("metrics_") for n in names) == 1
    out = _out(job, "fsdp2")
    want = _step_params(out, STEPS - 1)
    params = state_dict_from_jax(tck.load_artifact(save, "model_2s.msgpack"))
    for k, v in want.items():
        np.testing.assert_array_equal(params[k].numpy(), v, err_msg=k)
    cfg = tck.load_config(save, "model_params_2s.json")
    tc = TrainConfig(**RUNS["fsdp2"][1], save_dir=str(tmp_path))
    one = Trainer(cfg, tc, params=params, device="cpu", use_wandb=False,
                  log_dir=str(tmp_path))
    one.restore_optimizer(save, 2)
    mu = {k[3:]: out[k] for k in out.files if k.startswith("mu/")}
    for k, v in one.opt_state.mu.items():
        np.testing.assert_array_equal(v.numpy(), mu[k], err_msg=k)
    # the JAX package's loader takes it onto its own tree (its Trainer
    # makes a mesh of every device, so the tree is what is held)
    _, tmpl = init_mmdit(_model_cfg({}), jax.random.PRNGKey(0),
                         remat_blocks=False)
    back = jck.load_checkpoint(save, 2, tmpl)
    for k, v in state_dict_from_jax(back["params"]).items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)


def test_ema_on_host_over_two_processes_raises(mesh_runs):
    job, _, _ = mesh_runs
    for r in range(2):
        err = json.load(open(os.path.join(job, "w2", f"ema_host.r{r}.json")))
        assert "ema_on_host" in err["error"]


FAILING = r"""
import sys
from sd3_torch.parallel import multihost
rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if rank == 1:
    raise SystemExit("rank 1 fails before joining")
multihost.initialize(f"localhost:{port}", world, rank, device="cpu",
                     timeout_s=float(sys.argv[5]))
"""


def test_a_failing_rank_ends_the_launch_within_its_timeout(tmp_path):
    # rank 0 waits for a rank that never joins: its group's timeout (3 s)
    # ends it with an error, well inside the launch's deadline
    t0 = time.monotonic()
    outs = _wait(_start(2, str(tmp_path), FAILING, group_timeout=3),
                 timeout=LAUNCH_TIMEOUT_S)
    assert time.monotonic() - t0 < 60
    assert all(rc not in (0, None) for rc, _ in outs), outs
