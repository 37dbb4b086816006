"""sd3_torch's training path held to the JAX package's, on the CPU.

Flow objective, optimizers and schedules on given inputs; whole train steps
of a 2-block tiny model with the same initial weights (crossed by
`state_dict_from_jax`) and the same noise. The JAX `Trainer` is not built
(it makes a mesh of every device); its step functions are, under `jax.jit`
with no mesh. Each JAX step draws its noise from a key with the split of
`make_micro_loss`; the test draws the same arrays and hands them to the
port's `train_step`. Flash attention runs as the JAX package's own CPU tests
run it (Pallas interpret mode); the port takes the plain versions of K5,
K6a and K6b. Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.data.pipeline import synthetic_batch_iter as j_synthetic_batch_iter
from sd3_tpu.models.mmdit import MMDiT as JMMDiT
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.training import flow as jflow
from sd3_tpu.training import optim as joptim
from sd3_tpu.training import trainer as jtr

from sd3_torch.config import MMDiTConfig
from sd3_torch.data.pipeline import synthetic_batch_iter
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.ops import flash_attention as tfl
from sd3_torch.parallel import MeshConfig
from sd3_torch.training import flow, optim
from sd3_torch.training import trainer as ttr
from sd3_torch.training.trainer import Noise, TrainConfig, Trainer
from sd3_torch.weights import state_dict_from_jax


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np(t):
    return t.detach().float().numpy().copy()


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _flat(d: dict) -> np.ndarray:
    return np.concatenate([np.asarray(d[k], np.float64).ravel()
                           for k in sorted(d)])


# ---- flow -----------------------------------------------------------------

def test_flow_noising_losses_and_weights_match_jax():
    # same inputs, fp32 on both sides: only rounding order differs (1e-6)
    r = np.random.default_rng(0)
    x0 = r.standard_normal((3, 4, 8, 8)).astype(np.float32)
    t = r.uniform(0.05, 0.95, 3).astype(np.float32)
    v = r.standard_normal(x0.shape).astype(np.float32)
    x_t, eps = jflow.noise_batch(jax.random.PRNGKey(1), jnp.asarray(x0),
                                 jnp.asarray(t))
    np.testing.assert_allclose(_np(flow.noised(_t(x0), _t(t), _t(eps))),
                               x_t, rtol=1e-6, atol=1e-6)
    for weigh in (False, True):
        want = jflow.velocity_loss(jnp.asarray(v), jnp.asarray(x0), eps,
                                   jnp.asarray(t), weigh_loss=weigh)
        got = flow.velocity_loss(_t(v), _t(x0), _t(eps), _t(t),
                                 weigh_loss=weigh)
        np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    np.testing.assert_allclose(_np(flow.lognorm_weight(_t(t))),
                               jflow.lognorm_weight(jnp.asarray(t)), rtol=1e-6)
    with pytest.raises(ValueError, match="weigh_loss"):
        flow.velocity_loss(_t(v), _t(x0), _t(eps), None, weigh_loss=True)


def test_flow_draws_have_the_jax_distributions():
    # torch.Generator and jax.random give other numbers: hold the port's
    # draws to the distributions (n = 40000: a rate's standard error is
    # <= 2.5e-3, a mean's 5e-3; limits are ~4 standard errors)
    g = torch.Generator().manual_seed(0)
    n = 40000
    t = flow.sample_t(g, n)
    assert t.dtype == torch.float32 and bool(((t > 0) & (t < 1)).all())
    logit = torch.log(t / (1 - t))
    assert abs(logit.mean().item()) < 0.02 and abs(logit.std().item() - 1) < 0.02
    u = flow.sample_t(g, n, weighted=False)
    assert abs(u.mean().item() - 0.5) < 0.006 and bool(((u >= 0) & (u < 1)).all())
    masks = flow.null_masks(g, n)
    for m, p in zip(masks, (0.1, 0.316, 0.316)):
        assert m.dtype == torch.bool and abs(m.float().mean().item() - p) < 0.01
    # independent masks: the joint rate is the product
    both = (masks[1] & masks[2]).float().mean().item()
    assert abs(both - 0.316 ** 2) < 0.01
    x0 = torch.randn(4, 16, 16, 16, generator=g)
    x_t, eps = flow.noise_batch(g, x0, t[:4])
    assert torch.equal(x_t, flow.noised(x0, t[:4], eps))
    assert abs(eps.mean().item()) < 0.02 and abs(eps.std().item() - 1) < 0.02
    a = flow.sample_t(torch.Generator().manual_seed(5), 8)
    assert torch.equal(a, flow.sample_t(torch.Generator().manual_seed(5), 8))


def test_synthetic_batches_are_the_jax_packages():
    cfg = j_tiny_config()
    for a, b in zip(j_synthetic_batch_iter(cfg, 2, 3, 64, 48, seed=4),
                    synthetic_batch_iter(cfg, 2, 3, 64, 48, seed=4)):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        break


# ---- schedules and optimizers ----------------------------------------------

@pytest.mark.parametrize("cosine", [False, True])
def test_lr_schedules_match_optax(cosine):
    # both evaluate in fp32; numpy's and XLA's cos may differ in the last bit
    kw = dict(lr=3e-4, warmup_steps=5, total_steps=20, use_lr_scheduler=cosine)
    want = jtr.make_lr_schedule(jtr.TrainConfig(**kw))
    got = ttr.make_lr_schedule(TrainConfig(**kw))
    for count in range(26):
        np.testing.assert_allclose(got(count), float(want(count)), rtol=1e-6,
                                   atol=1e-12, err_msg=str(count))
    assert got(0) == 0.0 and got(5) == pytest.approx(3e-4)


PARAM_SHAPES = {"a.weight": (8, 16), "a.bias": (16,), "b.weight": (3, 4, 5)}
# gradient scales by step: global norms ~0.3, 2.9, 0.7, 4.3, 0.14, so a clip
# of 1.0 bites on steps 2 and 4 only
GRAD_SCALES = (0.02, 0.2, 0.05, 0.3, 0.01)


def _params(seed=0):
    r = np.random.default_rng(seed)
    return {k: r.standard_normal(s).astype(np.float32)
            for k, s in PARAM_SHAPES.items()}


def _grads(step):
    r = np.random.default_rng(100 + step)
    return {k: (r.standard_normal(s) * GRAD_SCALES[step]).astype(np.float32)
            for k, s in PARAM_SHAPES.items()}


def _assert_bf16_within_one_ulp(got: torch.Tensor, want):
    """bf16 moments: equal, or one bf16 ulp apart where an fp32 last-bit
    difference before the rounding tipped it."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)
    assert np.all(np.abs(g - w) <= ulp), np.max(np.abs(g - w) / ulp)


def test_adamw_matches_the_optax_chain():
    # make_optimizer(TrainConfig()) without low_mem: clip_by_global_norm then
    # optax.adamw, fp32 moments, the learning rate at the count before the
    # step. fp32 on both sides: updates within 1e-4 relative (the bias
    # corrections 1 - b2^c are fp32 powers computed by numpy and XLA)
    kw = dict(lr=1e-3, warmup_steps=3)
    jopt = jtr.make_optimizer(jtr.TrainConfig(**kw))
    topt = ttr.make_optimizer(TrainConfig(**kw))
    p0 = _params()
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    js, ts = jopt.init(jp), topt.init(tp)
    for step in range(5):
        g = _grads(step)
        ju, js = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, ju)
        tu, ts = topt.update({k: _t(v) for k, v in g.items()}, ts, tp)
        optim.apply_updates(tp, tu)
        if step == 0:  # warmup from 0: the first update is exactly zero
            assert all(bool((u == 0).all()) for u in tu.values())
            assert all(np.array_equal(_np(tp[k]), p0[k]) for k in p0)
        for k in p0:
            np.testing.assert_allclose(_np(tp[k]) - p0[k],
                                       np.asarray(jp[k]) - p0[k], rtol=1e-4,
                                       atol=1e-9, err_msg=f"{step} {k}")
    adam = [s for s in jax.tree_util.tree_leaves(
        js, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    assert ts.count == int(adam.count) == 5
    for k in p0:
        np.testing.assert_allclose(_np(ts.mu[k]), adam.mu[k], rtol=1e-4,
                                   atol=1e-9)
        np.testing.assert_allclose(_np(ts.nu[k]), adam.nu[k], rtol=1e-4,
                                   atol=1e-12)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("grad_dtype", ["bfloat16", "float32"])
def test_low_mem_adamw_matches_jax(fused, grad_dtype):
    # bf16 moments, the clip folded in, the learning rate at count + 1, in
    # place; fp32 math on both sides, but the global norms are summed in
    # another order, so the clip scale differs in its last bit and a moment
    # may round to the neighbouring bf16 value: moments equal or one bf16
    # ulp apart, the update vector within 1e-3 relative L2 (an element
    # whose moment moved by an ulp moves by <= 1%), grad norm 1e-6
    sched = jtr.make_lr_schedule(jtr.TrainConfig(lr=1e-3, warmup_steps=3))
    tsched = ttr.make_lr_schedule(TrainConfig(lr=1e-3, warmup_steps=3))
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.01, clip_norm=1.0)
    p0 = _params(1)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: _t(v) for k, v in p0.items()}
    if fused:
        jinit, jupd = joptim.fused_adamw_low_mem(sched, **kw)
        tinit, tupd = optim.fused_adamw_low_mem(tsched, **kw)
    else:
        jinit, jupd = joptim.adamw_low_mem(sched, **kw)
        tinit, tupd = optim.adamw_low_mem(tsched, **kw)
    js, ts = jinit(jp), tinit(tp)
    jdt, tdt = jnp.dtype(grad_dtype), getattr(torch, grad_dtype)
    for step in range(5):
        g = _grads(step)
        jg = {k: jnp.asarray(v).astype(jdt) for k, v in g.items()}
        tg = {k: _t(v).to(tdt) for k, v in g.items()}
        if fused:
            jp, js, jn = jupd(jg, js, jp)
            out, ts, tn = tupd(tg, ts, tp)
            assert out is tp
            np.testing.assert_allclose(tn.item(), float(jn), rtol=1e-6)
        else:
            ju, js = jupd(jg, js, jp)
            jp = optax.apply_updates(jp, ju)
            tu, ts = tupd(tg, ts, tp)
            optim.apply_updates(tp, tu)
        dp_t = _flat({k: _np(v) - p0[k] for k, v in tp.items()})
        dp_j = _flat({k: np.asarray(v) - p0[k] for k, v in jp.items()})
        assert _rel_l2(dp_t, dp_j) < 1e-3, step
        np.testing.assert_allclose(dp_t, dp_j, rtol=1e-2, atol=1e-9)
        for k in p0:
            assert ts.mu[k].dtype == ts.nu[k].dtype == torch.bfloat16
            _assert_bf16_within_one_ulp(ts.mu[k], js.mu[k])
            _assert_bf16_within_one_ulp(ts.nu[k], js.nu[k])
    assert ts.count == int(js.count) == 5
    # the clip bit: with it off, step 4's update is another
    gn = optim.global_norm_f32({k: _t(v) for k, v in _grads(3).items()})
    assert gn.item() > 1.0


def test_gradient_and_moment_trees_cross_by_state_dict_names(tmp_path):
    # a JAX gradient tree (here: random leaves of the parameters' shapes)
    # maps to the port's parameter names with the kernels transposed and the
    # patch kernel as the Conv2d weight; bf16 moments cross the same way
    jcfg = j_tiny_config(attn_type="softmax_flash")
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(0), remat_blocks=False)
    r = np.random.default_rng(2)
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(r.standard_normal(p.shape).astype(np.float32)),
        params)
    sd = state_dict_from_jax(grads)
    cfg = MMDiTConfig.from_json(jcfg.to_json())
    model = MMDiT(cfg, device="cpu")
    assert {k: tuple(v.shape) for k, v in sd.items()} == {
        k: tuple(p.shape) for k, p in model.named_parameters()}
    q = np.asarray(grads["blocks_1"]["attn"]["query_proj_x"]["kernel"])
    np.testing.assert_array_equal(_np(sd["blocks.1.attn.query_proj_x.weight"]),
                                  q.T)
    pk = np.asarray(grads["pos_enc"]["kernel"])  # (C*p*p, O)
    np.testing.assert_array_equal(
        _np(sd["pos_enc.proj.weight"]),
        pk.T.reshape(jcfg.dim, jcfg.inCh, 2, 2))
    np.testing.assert_array_equal(_np(sd["time_scale"]),
                                  np.asarray(grads["t_emb"]["time_scale"]))
    # a JAX low-mem optimizer state starts the port's trainer
    jinit, _ = joptim.fused_adamw_low_mem(1e-3)
    js = jinit(params)
    js = joptim.AdamWLowMemState(
        jnp.asarray(7, jnp.int32),
        jax.tree_util.tree_map(lambda g: g.astype(jnp.bfloat16), grads),
        jax.tree_util.tree_map(lambda g: (g * g).astype(jnp.bfloat16), grads))
    tc = TrainConfig(low_mem_optimizer=True, fused_optimizer=True,
                     track_ema=False)
    tr = Trainer(cfg, tc, params=state_dict_from_jax(params), device="cpu",
                 log_dir=str(tmp_path), use_wandb=False,
                 opt_state=optim.AdamWLowMemState(
                     int(js.count), state_dict_from_jax(js.mu),
                     state_dict_from_jax(js.nu)))
    assert tr.opt_state.count == 7
    want_mu = state_dict_from_jax(js.mu)
    for k, m in tr.opt_state.mu.items():
        assert m.dtype == torch.bfloat16 and torch.equal(m.float(), want_mu[k])


# ---- whole train steps ------------------------------------------------------

def _jax_noise(key, x0, tcfg) -> Noise:
    """The draws of the JAX micro_loss for `key` (trainer.py:163-169)."""
    k_t, k_eps, k_null, _ = jax.random.split(key, 4)
    b = x0.shape[0]
    t = jflow.sample_t(k_t, b)
    _, eps = jflow.noise_batch(k_eps, jnp.asarray(x0), t)
    masks = jflow.null_masks(k_null, b, tcfg.null_prob_pooled,
                             tcfg.null_prob_gemma, tcfg.null_prob_bert)
    return Noise(_t(t), _t(eps), *(torch.from_numpy(np.array(m))
                                   for m in masks))


def _step_noise(key, batch, tcfg, acc):
    """One Noise per micro-batch, as make_train_step keys them."""
    if acc == 1:
        return [_jax_noise(key, batch["x0"][0], tcfg)]
    keys = jax.random.split(key, acc)
    return [_jax_noise(keys[i], batch["x0"][i], tcfg) for i in range(acc)]


def _batch(jcfg, acc, b=2, hw=8, seed=0):
    r = np.random.default_rng(seed)
    return {"x0": r.standard_normal((acc, b, jcfg.inCh, hw, hw)
                                    ).astype(np.float32),
            "text": r.standard_normal((acc, b, jcfg.text_tokens,
                                       jcfg.text_hidden_dim)).astype(np.float32),
            "pooled": r.standard_normal((acc, b, jcfg.class_dim)
                                        ).astype(np.float32)}


def _pair(jcfg, tkw, tmp_path, seed=0):
    """(jitted JAX step, its params and optimizer state, the port's
    Trainer on the same weights)."""
    jtc, tc = jtr.TrainConfig(**tkw), TrainConfig(**tkw)
    jm = JMMDiT(jcfg, remat_blocks=jtc.remat_blocks, remat_policy="nothing",
                fused_attn=False)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(seed), remat_blocks=False)
    if jtc.fused_optimizer:
        init, upd = joptim.fused_adamw_low_mem(
            jtr.make_lr_schedule(jtc), b1=0.9, b2=0.999, eps=1e-8,
            weight_decay=0.01, clip_norm=jtc.grad_clip)
        step = jax.jit(jtr.make_fused_train_step(jm, jtc, upd))
    else:
        opt = jtr.make_optimizer(jtc)
        init = opt.init
        step = jax.jit(jtr.make_train_step(jm, opt, jtc))
    cfg = MMDiTConfig.from_json(jcfg.to_json())
    trainer = Trainer(cfg, tc, params=state_dict_from_jax(params),
                      device="cpu", log_dir=str(tmp_path), use_wandb=False)
    return jm, jtc, step, params, init(params), trainer


def test_three_fused_bf16_steps_match_jax(tmp_path):
    # the slice's flags: acc 1, low-mem fused AdamW, bf16 grads, precast
    # params, remat, in bf16 compute. Both sides round at other places in
    # bf16 (matmul outputs, norms, the flash p and ds), so the whole
    # gradient vector is held by its relative L2 error (measured 1.3e-2;
    # limit 3e-2), the loss and the gradient norm to 1e-2 relative (measured
    # <= 3.5e-3). Adam's first steps move each weight by about lr * sign(g),
    # so where bf16 noise flips the sign of a small gradient the update
    # differs by 2 lr: the update vector after 3 steps is held to a relative
    # L2 of 0.25 (measured 6.2e-2), a wrong path is ~1.4. The port keeps bf16
    # copies of the weights as the JAX precast does, so every weight
    # gradient is taken against the same bf16 values.
    jcfg = j_tiny_config(attn_type="softmax_flash", dtype="bfloat16")
    tkw = dict(batch_size=2, accumulation_steps=1, lr=1e-3, warmup_steps=2,
               low_mem_optimizer=True, fused_optimizer=True, bf16_grads=True,
               precast_params=True, remat_blocks=True, track_ema=False)
    jm, jtc, step, jp, js, trainer = _pair(jcfg, tkw, tmp_path)
    assert trainer.model.blocks[0].attn.query_proj_x.weight.dtype == \
        torch.bfloat16
    assert trainer.params["time_scale"].dtype == torch.float32
    p0 = {k: _np(v) for k, v in trainer.params.items()}
    for i in range(3):
        batch = _batch(jcfg, 1, seed=10 + i)
        key = jax.random.PRNGKey(20 + i)
        tb = {k: _t(v) for k, v in batch.items()}
        noise = _step_noise(key, batch, jtc, 1)
        if i == 0:
            cp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
            jg, _ = jax.jit(jax.grad(jtr.make_micro_loss(jm, jtc),
                                     has_aux=True))(
                cp, key, *(jnp.asarray(batch[k][0])
                           for k in ("x0", "text", "pooled")))
            tg, _ = trainer.gradients(tb, noise)
            assert all(g.dtype == torch.bfloat16 for g in tg.values())
            want = state_dict_from_jax(jg)
            assert _rel_l2(_flat({k: _np(v) for k, v in tg.items()}),
                           _flat({k: _np(v) for k, v in want.items()})) < 3e-2
        jp, js, jmet = step(jp, js, key, batch)
        tmet = trainer.train_step(tb, noise)
        assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-2)
        assert tmet["grad_norm"].item() == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-2)
    want = state_dict_from_jax(jp)
    dp_t = _flat({k: _np(v) - p0[k] for k, v in trainer.params.items()})
    dp_j = _flat({k: _np(v) - p0[k] for k, v in want.items()})
    assert _rel_l2(dp_t, dp_j) < 0.25
    assert trainer.opt_state.count == int(js.count) == 3


@pytest.mark.parametrize("dim", [512, 768])
def test_one_fused_bf16_step_at_head_dim_256_matches_jax(tmp_path, dim):
    # test_three_fused_bf16_steps_match_jax's flags and tolerances for one
    # step of a model of two heads of 256 (dim 512), whose flash attention
    # runs the D = 256 instances on the card (K5_256, K6A_256, K6B_256) and
    # their plain versions here, and of two heads of 384 (dim 768: K5_384,
    # K6A_384, K6B_384 on the card); JAX's Pallas kernels in interpret mode
    # on two or three 128-lane blocks of the head. The JAX step at acc 1 is
    # its
    # gradient function on the precast weights and the fused AdamW tail
    # (make_fused_train_step), taken here in those two parts so that the
    # model compiles once. No warmup, so that the step moves the weights:
    # the gradients to a relative L2 of 3e-2, loss and gradient norm to
    # 1e-2 relative, the update to a relative L2 of 0.25
    jcfg = j_tiny_config(attn_type="softmax_flash", dtype="bfloat16",
                         dim=dim, num_heads=2)
    hd = jcfg.dim // jcfg.num_heads
    assert hd in (256, 384)
    assert [tfl.flash_kernel(w, torch.bfloat16, hd) for w in (
        "fwd", "dq", "dkv")] == [tfl._WGMMA[w][hd] for w in (
            "fwd", "dq", "dkv")]
    tkw = dict(batch_size=2, accumulation_steps=1, lr=1e-3, warmup_steps=0,
               low_mem_optimizer=True, fused_optimizer=True, bf16_grads=True,
               precast_params=True, remat_blocks=True, track_ema=False)
    jm, jtc, _, jp, js, trainer = _pair(jcfg, tkw, tmp_path, seed=3)
    _, fused_update = joptim.fused_adamw_low_mem(
        jtr.make_lr_schedule(jtc), b1=0.9, b2=0.999, eps=1e-8,
        weight_decay=0.01, clip_norm=jtc.grad_clip)
    p0 = {k: _np(v) for k, v in trainer.params.items()}
    batch = _batch(jcfg, 1, seed=50)
    key = jax.random.PRNGKey(60)
    tb = {k: _t(v) for k, v in batch.items()}
    noise = _step_noise(key, batch, jtc, 1)
    cp = jax.tree_util.tree_map(lambda x: x.astype(jnp.bfloat16), jp)
    jg, jmet = jax.jit(jax.grad(jtr.make_micro_loss(jm, jtc), has_aux=True))(
        cp, key, *(jnp.asarray(batch[k][0]) for k in ("x0", "text", "pooled")))
    jp, js, jnorm = jax.jit(fused_update)(jg, js, jp)
    tg, _ = trainer.gradients(tb, noise)
    want = state_dict_from_jax(jg)
    assert _rel_l2(_flat({k: _np(v) for k, v in tg.items()}),
                   _flat({k: _np(v) for k, v in want.items()})) < 3e-2
    tmet = trainer.train_step(tb, noise)
    assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]), rel=1e-2)
    assert tmet["grad_norm"].item() == pytest.approx(float(jnorm), rel=1e-2)
    want = state_dict_from_jax(jp)
    dp_t = _flat({k: _np(v) - p0[k] for k, v in trainer.params.items()})
    dp_j = _flat({k: _np(v) - p0[k] for k, v in want.items()})
    assert np.abs(dp_j).max() > 0
    assert _rel_l2(dp_t, dp_j) < 0.25


def test_three_optax_acc2_fp32_steps_match_jax(tmp_path):
    # the TrainConfig default path: the optax chain (outer clip, fp32
    # moments), fp32 gradients summed over 2 micro-batches, the device EMA
    # every step; fp32 compute. Loss, gradient norm, the update and the
    # moments to 1e-4 relative (summation order only; measured <= 3.2e-6),
    # the EMA to 1e-6.
    # Under warmup the first update is zero on both sides.
    jcfg = j_tiny_config(attn_type="softmax_flash", dtype="float32")
    tkw = dict(batch_size=2, accumulation_steps=2, lr=1e-3, warmup_steps=2,
               ema_update_freq=1, ema_decay=0.9, remat_blocks=True)
    _, jtc, step, jp, js, trainer = _pair(jcfg, tkw, tmp_path, seed=1)
    assert trainer.optimizer is not None and trainer.ema is not None
    p0 = {k: _np(v) for k, v in trainer.params.items()}
    ema = jax.tree_util.tree_map(lambda p: p, jp)
    for i in range(3):
        batch = _batch(jcfg, 2, seed=30 + i)
        key = jax.random.PRNGKey(40 + i)
        jp, js, jmet = step(jp, js, key, batch)
        ema = jtr.ema_update(ema, jp, 0.9)
        tmet = trainer.train_step({k: _t(v) for k, v in batch.items()},
                                  _step_noise(key, batch, jtc, 2))
        if i == 0:
            assert all(np.array_equal(_np(v), p0[k])
                       for k, v in trainer.params.items())
        assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]),
                                                    rel=1e-4)
        assert tmet["grad_norm"].item() == pytest.approx(
            float(jmet["grad_norm"]), rel=1e-4)
    want = state_dict_from_jax(jp)
    dp_t = _flat({k: _np(v) - p0[k] for k, v in trainer.params.items()})
    dp_j = _flat({k: _np(v) - p0[k] for k, v in want.items()})
    assert _rel_l2(dp_t, dp_j) < 1e-4
    adam = [s for s in jax.tree_util.tree_leaves(
        js, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState)][0]
    for name, tree, got in (("mu", adam.mu, trainer.opt_state.mu),
                            ("nu", adam.nu, trainer.opt_state.nu)):
        w = state_dict_from_jax(tree)
        assert _rel_l2(_flat({k: _np(v) for k, v in got.items()}),
                       _flat({k: _np(v) for k, v in w.items()})) < 1e-4, name
    want_ema = state_dict_from_jax(ema)
    for k, v in trainer.ema.items():
        np.testing.assert_allclose(_np(v), _np(want_ema[k]), rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_remat_gives_the_same_gradients_and_reruns_the_attention(
        tmp_path, monkeypatch):
    # remat (torch.utils.checkpoint) recomputes each block in the backward:
    # the same fp32 gradients, and flash attention's forward runs twice per
    # block (K5 38 times for the 19 blocks of the published model), its
    # backward once
    cfg = MMDiTConfig.from_json(j_tiny_config(
        attn_type="softmax_flash").to_json())
    tc = TrainConfig(batch_size=2, accumulation_steps=1, track_ema=False)
    trainer = Trainer(cfg, tc, device="cpu", log_dir=str(tmp_path),
                      use_wandb=False)
    calls = dict.fromkeys(("flash_fwd_plain", "flash_dq_plain",
                           "flash_dkv_plain"), 0)
    for name in calls:
        fn = getattr(tfl, name)

        def counted(*a, _fn=fn, _name=name):
            calls[_name] += 1
            return _fn(*a)
        monkeypatch.setattr(tfl, name, counted)
    batch = {k: _t(v) for k, v in _batch(j_tiny_config(), 1, seed=5).items()}
    noise = [ttr.draw_noise(torch.Generator().manual_seed(6), batch["x0"][0],
                            tc)]
    grads = {}
    for remat in (True, False):
        trainer.model.remat_blocks = remat
        for k in calls:
            calls[k] = 0
        g, _ = trainer.gradients(batch, noise)
        grads[remat] = {k: v.clone() for k, v in g.items()}
        nb = cfg.num_blocks
        assert calls == dict(flash_fwd_plain=nb * (2 if remat else 1),
                             flash_dq_plain=nb, flash_dkv_plain=nb)
    for k, v in grads[True].items():
        np.testing.assert_allclose(_np(v), _np(grads[False][k]), rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_trainer_trains_logs_and_keeps_the_ema(tmp_path):
    cfg = MMDiTConfig.from_json(j_tiny_config(
        attn_type="softmax_flash").to_json())
    tc = TrainConfig(batch_size=2, accumulation_steps=1, total_steps=4,
                     log_steps=2, ema_update_freq=2, ema_decay=0.5,
                     warmup_steps=1, lr=1e-3, save_dir=str(tmp_path))
    trainer = Trainer(cfg, tc, device="cpu", log_dir=str(tmp_path),
                      use_wandb=False)
    batches = synthetic_batch_iter(cfg, 2, 1, 64, 64, seed=0)
    p0 = {k: v.clone() for k, v in trainer.params.items()}
    assert all(torch.equal(trainer.ema[k], p0[k]) for k in p0)
    assert trainer.train(batches, total_steps=2) == 2
    p2 = {k: v.clone() for k, v in trainer.params.items()}
    assert any(not torch.equal(p2[k], p0[k]) for k in p0)
    for k in p0:  # ema = d * ema + (1 - d) * params at step 2
        torch.testing.assert_close(trainer.ema[k], 0.5 * p0[k] + 0.5 * p2[k])
    assert trainer.train(batches) == 4
    for k in p0:
        torch.testing.assert_close(
            trainer.ema[k], 0.5 * (0.5 * p0[k] + 0.5 * p2[k])
            + 0.5 * trainer.params[k])
    lines = [__import__("json").loads(s) for s in open(
        trainer.logger._path).read().splitlines()]
    assert [r["step"] for r in lines] == [2, 4]
    for r in lines:
        assert np.isfinite([r["loss"], r["grad_norm"], r["lr"],
                            r["steps_per_sec"]]).all()
    assert lines[-1]["lr"] == pytest.approx(1e-3)
    # the checkpoint of step 4 (tests/test_torch_checkpoint.py holds it to
    # the JAX package's); a fresh trainer restores its optimizer from it
    names = trainer.save()
    assert sorted(names) == ["defs", "ema", "model", "optim", "scaler",
                             "scheduler"]
    assert all((tmp_path / n).is_file() for n in names.values())
    fresh = Trainer(cfg, tc, device="cpu", log_dir=str(tmp_path / "f"),
                    use_wandb=False)
    fresh.restore_optimizer(str(tmp_path), 4)
    assert fresh.opt_state.count == trainer.opt_state.count == 4
    for k in p0:
        assert torch.equal(fresh.opt_state.mu[k], trainer.opt_state.mu[k])


@pytest.mark.parametrize("kw", [
    dict(scan_blocks=True, qk_half_dim=True), dict(mesh=MeshConfig(dp=2)),
    dict(text_loss=True)])
def test_unported_training_options_raise(kw, tmp_path):
    # the remat policies, scan_blocks (over "both" too), the text loss and
    # meshes are ported (tests/test_torch_remat_scan.py,
    # test_torch_variants.py, test_torch_parallel.py); what JAX refuses
    # raises a ValueError: a mesh that does not cover the world (here no
    # process group: a world of one), qk_half_dim under softmax_flash (its
    # flash wrapper's head-dim assert) and a text_loss model with
    # text_loss_weight 0 (its step takes the model's (velocity, text) pair
    # for the velocity)
    kw = dict(kw)
    model = {k: kw.pop(k) for k in ("qk_half_dim", "text_loss") if k in kw}
    cfg = MMDiTConfig.from_json(j_tiny_config(
        attn_type="softmax_flash", **model).to_json())
    match = "does not cover" if "mesh" in kw else "qk_half_dim|text_loss_weight"
    with pytest.raises(ValueError, match=match):
        Trainer(cfg, TrainConfig(**kw), device="cpu", log_dir=str(tmp_path),
                use_wandb=False)


def test_one_fp32_fused_step_matches_jax(tmp_path):
    # one step in fp32 (the configuration a Trainer(dtype="float32") runs,
    # on the card through the fp32 flash instances K5F / K6AF / K6BF): the
    # fused low-mem AdamW, fp32 gradients, remat, against JAX's fused step
    # function in fp32. Loss, gradient norm and the update to 1e-4 relative
    # (summation order only, as the fp32 optax test above)
    jcfg = j_tiny_config(attn_type="softmax_flash", dtype="float32")
    tkw = dict(batch_size=2, accumulation_steps=1, lr=1e-3, warmup_steps=0,
               low_mem_optimizer=True, fused_optimizer=True,
               remat_blocks=True, track_ema=False)
    _, jtc, step, jp, js, trainer = _pair(jcfg, tkw, tmp_path, seed=2)
    assert trainer.model.blocks[0].attn.query_proj_x.weight.dtype == \
        torch.float32
    p0 = {k: _np(v) for k, v in trainer.params.items()}
    batch = _batch(jcfg, 1, seed=50)
    key = jax.random.PRNGKey(51)
    jp, js, jmet = step(jp, js, key, batch)
    tmet = trainer.train_step({k: _t(v) for k, v in batch.items()},
                              _step_noise(key, batch, jtc, 1))
    assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]), rel=1e-4)
    assert tmet["grad_norm"].item() == pytest.approx(float(jmet["grad_norm"]),
                                                     rel=1e-4)
    want = state_dict_from_jax(jp)
    dp_t = _flat({k: _np(v) - p0[k] for k, v in trainer.params.items()})
    dp_j = _flat({k: _np(v) - p0[k] for k, v in want.items()})
    assert _rel_l2(dp_t, dp_j) < 1e-4
