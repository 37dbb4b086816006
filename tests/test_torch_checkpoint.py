"""Checkpoints across the two packages, on the CPU.

A checkpoint that the JAX package writes (`sd3_tpu.training.checkpoint`
`save_checkpoint` of `init_mmdit` parameters, an EMA, and the optimizer
state after the JAX optimizer's `init` and one update) loads in the port bit
for bit, and the port writes it back in the same bytes, which JAX's
`load_checkpoint` reads: for optax AdamW, the bf16 low-memory AdamW and the
8-bit AdamW (its canonical bf16 form). The JAX `Trainer` is not built: under
the test run's 8-device virtual mesh it fails, as its own tests do; its
optimizers are.

`adamw_8bit` is held to JAX's on the same gradients: the parameters within
atol 1e-7 / rtol 1e-6 (fp32 on both sides, the same blocks and the same
order of operations; the last bit of a square root or a quotient may
differ), the moments to one fp8-e4m3 level (1/8 of a value, relative) where
a block scale differs in its last bit; the re-quantization of a canonical
state bit for bit. The host EMA equals the device EMA bit for bit (the same
arithmetic on the same values).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.training import checkpoint as jck
from sd3_tpu.training import optim as jopt
from sd3_tpu.training.trainer import TrainConfig as JTrainConfig
from sd3_tpu.training.trainer import make_optimizer as j_make_optimizer

from sd3_torch.config import MMDiTConfig
from sd3_torch.training import checkpoint as tck
from sd3_torch.training import optim as topt
from sd3_torch.training.trainer import Trainer, TrainConfig, make_lr_schedule
from sd3_torch.weights import (jax_path, jax_tree_from_state_dict,
                               state_dict_from_jax)

# torch's intra-op threads: one share of the cores a pytest-xdist worker
# (each would otherwise run torch on every core beside the others and
# XLA's pool). Every worker imports every test file, so this one setting
# reaches all of them; a run without xdist keeps every core.
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _params(seed=0):
    jcfg = j_tiny_config(num_blocks=2)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(seed), remat_blocks=False)
    return jcfg, params


def _grads(params, seed):
    r = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: jnp.asarray(r.standard_normal(p.shape).astype(np.float32)
                              * 1e-2), params)


def _equal_trees(a, b):
    fa, fb = (jax.tree_util.tree_flatten_with_path(t)[0] for t in (a, b))
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (path, x), (_, y) in zip(fa, fb):
        x, y = np.asarray(x), np.asarray(y)
        assert x.dtype == y.dtype and x.shape == y.shape, path
        assert np.array_equal(np.atleast_1d(x).view(np.uint8),
                              np.atleast_1d(y).view(np.uint8)), path


def _sd_equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


def _jax_opt_state(kind, params, grads):
    """The JAX optimizer's state after init and one update, as the JAX
    trainer saves it (8-bit: dequantized to the canonical form)."""
    tc = JTrainConfig(low_mem_optimizer=kind != "optax", warmup_steps=2,
                      lr=1e-3)
    if kind == "8bit":
        init, update = jopt.adamw_8bit(1e-3, clip_norm=1.0)
        _, st, _ = update(grads, init(params), params)
        return jax.device_get(jopt.dequantize_8bit(st, params))
    opt = j_make_optimizer(tc)
    _, st = opt.update(grads, opt.init(params), params)
    return jax.device_get(st)


@pytest.mark.parametrize("kind", ["optax", "lowmem", "8bit"])
def test_jax_checkpoint_loads_in_the_port_and_writes_back(tmp_path, kind):
    jcfg, params = _params(3)
    ema = jax.tree_util.tree_map(lambda p: p * 0.5, params)
    opt = _jax_opt_state(kind, params, _grads(params, 4))
    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save_checkpoint(jdir, jcfg, params, ema_params=ema, opt_state=opt,
                        scheduler_state={"step": 7}, step=7, wandb_id="abc")

    # the port reads every artifact bit for bit
    got = tck.load_checkpoint(jdir, 7)
    cfg = got["cfg"]
    assert isinstance(cfg, MMDiTConfig) and cfg.start_step == 7
    assert cfg.wandb_id == "abc" and got["scheduler"] == {"step": 7}
    _sd_equal(state_dict_from_jax(got["params"]), state_dict_from_jax(params))
    _sd_equal(state_dict_from_jax(got["ema"]), state_dict_from_jax(ema))
    moments = got["optim"]["1"]["0"] if kind == "optax" else got["optim"]
    want = opt[1][0] if kind == "optax" else opt
    assert int(moments["count"]) == int(want.count) == 1
    for key in ("mu", "nu"):
        leaves = jax.tree_util.tree_leaves(moments[key])
        dtype = torch.float32 if kind == "optax" else torch.bfloat16
        assert {t.dtype for t in leaves} == {dtype}
        _sd_equal(state_dict_from_jax(moments[key]),
                  state_dict_from_jax(getattr(want, key)))

    # the port writes the same bytes back from its own forms, and JAX reads
    # them
    sd, sd_ema = (state_dict_from_jax(t) for t in (params, ema))
    mu, nu = (state_dict_from_jax(getattr(want, k)) for k in ("mu", "nu"))
    mdt = torch.float32 if kind == "optax" else torch.bfloat16
    state_type = topt.AdamWState if kind == "optax" else topt.AdamWLowMemState
    state = state_type(1, {k: v.to(mdt) for k, v in mu.items()},
                       {k: v.to(mdt) for k, v in nu.items()})
    if kind == "8bit":
        state = topt.quantize_8bit(state, sd)
        state = topt.dequantize_8bit(state, sd)  # what save() writes
    tck.save_checkpoint(tdir, MMDiTConfig.from_json(jcfg.to_json()),
                        jax_tree_from_state_dict(sd),
                        ema_params=jax_tree_from_state_dict(sd_ema),
                        opt_state=topt.to_artifact(state, sd),
                        scheduler_state={"step": 7}, step=7, wandb_id="abc")
    for name in tck._names(7).values():
        with open(os.path.join(jdir, name), "rb") as f:
            a = f.read()
        with open(os.path.join(tdir, name), "rb") as f:
            b = f.read()
        if kind == "8bit" and name.startswith("optim"):
            continue   # a re-quantized moment may move (checked below)
        assert a == b, name
    back = jck.load_checkpoint(tdir, 7, params, ema=params, optim=opt,
                               scheduler={"step": 0})
    _equal_trees(back["params"], params)
    _equal_trees(back["ema"], ema)
    assert back["scheduler"] == {"step": 7}
    if kind != "8bit":
        _equal_trees(back["optim"], opt)
    else:
        assert int(back["optim"].count) == 1
        for key in ("mu", "nu"):
            for x, y in zip(jax.tree_util.tree_leaves(getattr(back["optim"], key)),
                            jax.tree_util.tree_leaves(getattr(opt, key))):
                np.testing.assert_allclose(np.asarray(x, np.float32),
                                           np.asarray(y, np.float32),
                                           rtol=2 ** -3, atol=0)


def test_config_json_holds_the_jax_keys(tmp_path):
    jcfg, params = _params()
    jck.save_checkpoint(str(tmp_path / "j"), jcfg, params, step=2)
    tck.save_checkpoint(str(tmp_path / "t"), MMDiTConfig.from_json(
        jcfg.to_json()), jax_tree_from_state_dict(state_dict_from_jax(params)),
        step=2)
    with open(tmp_path / "j" / "model_params_2s.json") as f:
        a = f.read()
    with open(tmp_path / "t" / "model_params_2s.json") as f:
        b = f.read()
    assert a == b


def test_big_arrays_take_flax_chunked_form(monkeypatch):
    # arrays past MAX_CHUNK_SIZE bytes split as flax splits them (a small
    # limit here on both sides), bf16 and fp32 alike
    monkeypatch.setattr(tck, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    r = np.random.default_rng(0)
    a = r.standard_normal((5, 9)).astype(np.float32)
    jtree = {"a": jnp.asarray(a), "b": jnp.asarray(a, jnp.bfloat16),
             "n": {"c": jnp.zeros((), jnp.int32)}}
    ttree = {"a": torch.from_numpy(a),
             "b": torch.from_numpy(a).bfloat16(),
             "n": {"c": np.zeros((), np.int32)}}
    data = serialization.to_bytes(jax.device_get(jtree))
    assert tck.to_bytes(ttree) == data
    back = tck.from_bytes(data)
    assert torch.equal(back["a"], ttree["a"])
    assert torch.equal(back["b"], ttree["b"])
    assert back["n"]["c"].dtype == torch.int32


def test_save_streams_flax_bytes_and_moves_them_into_place(tmp_path,
                                                         monkeypatch):
    # the artifact written a leaf at a time holds flax's bytes of the tree;
    # a save cut part of the way leaves the earlier file whole and no
    # partial one under its name
    _, params = _params(3)
    data = serialization.to_bytes(jax.device_get(params))
    tree = jax_tree_from_state_dict(state_dict_from_jax(params))
    path = str(tmp_path / "model_1s.msgpack")
    tck.write_artifact(path, tree)
    with open(path, "rb") as f:
        assert f.read() == data
    assert os.listdir(tmp_path) == ["model_1s.msgpack"]
    packed = []

    def cut(x):
        if packed:
            raise OSError("disk full")
        packed.append(x)
        return tck_ext_pack(x)

    tck_ext_pack = tck._ext_pack
    monkeypatch.setattr(tck, "_ext_pack", cut)
    with pytest.raises(OSError, match="disk full"):
        tck.write_artifact(path, tree)
    with open(path, "rb") as f:
        assert f.read() == data
    assert os.listdir(tmp_path) == ["model_1s.msgpack"]


def test_jax_tree_is_the_inverse_of_state_dict_from_jax():
    _, params = _params(5)
    sd = state_dict_from_jax(params)
    tree = jax_tree_from_state_dict(sd)
    _equal_trees(jax.tree_util.tree_map(np.asarray, tree), params)
    _sd_equal(state_dict_from_jax(tree), sd)
    assert jax_path("blocks.1.y_proj.0.weight") == ("blocks_1", "y_proj",
                                                    "kernel")
    assert jax_path("time_scale") == ("t_emb", "time_scale")


def test_adamw_8bit_matches_jax_on_the_same_grads():
    _, params = _params(7)
    g1, g2 = _grads(params, 8), _grads(params, 9)
    sched = lambda c: 1e-3 * jnp.minimum(1.0, c / 2.0)
    init, update = jopt.adamw_8bit(sched, clip_norm=0.05)
    jp, st = params, init(params)
    for g in (g1, g2):
        jp, st, _ = update(g, st, jp)
    canon = jopt.dequantize_8bit(st, jp)

    sd = state_dict_from_jax(params)
    tinit, tupdate = topt.adamw_8bit(
        lambda c: float(np.float32(1e-3) * np.float32(min(1.0, c / 2.0))),
        clip_norm=0.05)
    tst = tinit(sd)
    for g in (g1, g2):
        _, tst, _ = tupdate(state_dict_from_jax(g), tst, sd)
    assert tst.count == 2
    assert {v.dtype for n, v in tst.mu_q.items()
            if tst.mu_s[n].numel()} == {torch.float8_e4m3fn}
    want = state_dict_from_jax(jp)
    for k in sd:
        np.testing.assert_allclose(sd[k].numpy(), want[k].numpy(),
                                   atol=1e-7, rtol=1e-6, err_msg=k)
    tcanon = topt.dequantize_8bit(tst, sd)
    for key in ("mu", "nu"):
        w = state_dict_from_jax(getattr(canon, key))
        for k, v in getattr(tcanon, key).items():
            assert v.dtype == torch.bfloat16
            np.testing.assert_allclose(v.float().numpy(), w[k].numpy(),
                                       rtol=2 ** -3, atol=1e-30, err_msg=k)
    # resuming re-quantizes the canonical form (one absmax round trip, as
    # in JAX): the port's re-quantization of JAX's canonical state is JAX's,
    # bit for bit
    jback = jopt.dequantize_8bit(jopt.quantize_8bit(canon, jp), jp)
    jsd = {key: state_dict_from_jax(getattr(canon, key)) for key in ("mu", "nu")}
    back = topt.dequantize_8bit(topt.quantize_8bit(topt.AdamWLowMemState(
        2, *({k: v.bfloat16() for k, v in jsd[key].items()}
             for key in ("mu", "nu"))), sd), sd)
    for key in ("mu", "nu"):
        w = state_dict_from_jax(getattr(jback, key))
        for k, v in getattr(back, key).items():
            assert torch.equal(v.float(), w[k]), k


def _tiny_trainer(tmp_path, **kw):
    cfg = MMDiTConfig.from_json(j_tiny_config(num_blocks=2).to_json())
    tc = TrainConfig(batch_size=2, accumulation_steps=1, warmup_steps=1,
                     ema_update_freq=1, save_dir=str(tmp_path), **kw)
    return cfg, tc, Trainer(cfg, tc, device="cpu", use_wandb=False)


def _batch(cfg, seed):
    r = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(r.standard_normal(s).astype(np.float32))
    return {"x0": f(1, 2, cfg.inCh, 8, 8),
            "text": f(1, 2, cfg.text_tokens, cfg.text_hidden_dim),
            "pooled": f(1, 2, cfg.class_dim)}


def test_ema_on_host_equals_the_device_ema(tmp_path):
    _, _, dev = _tiny_trainer(tmp_path / "a", low_mem_optimizer=True)
    cfg, _, host = _tiny_trainer(tmp_path / "b", low_mem_optimizer=True,
                                 ema_on_host=True)
    assert host.ema is None
    for step in range(3):
        b = _batch(cfg, step)
        gen = [torch.Generator().manual_seed(step) for _ in range(2)]
        from sd3_torch.training.trainer import draw_noise
        nz = [draw_noise(gen[0], b["x0"][0], dev.tcfg)]
        nz2 = [draw_noise(gen[1], b["x0"][0], host.tcfg)]
        dev.train_step(b, nz)
        host.train_step(b, nz2)
    _sd_equal(host.ema_state(), dev.ema_state())
    names = host.save()
    saved = tck.load_artifact(str(tmp_path / "b"), names["ema"])
    _sd_equal(state_dict_from_jax(saved), dev.ema_state())


@pytest.mark.parametrize("kind", ["optax", "lowmem", "8bit"])
def test_trainer_restores_its_optimizer_bit_for_bit(tmp_path, kind):
    kw = dict(low_mem_optimizer=kind != "optax", moments_8bit=kind == "8bit")
    cfg, tc, tr = _tiny_trainer(tmp_path, **kw)
    tr.train_step(_batch(cfg, 1))
    names = tr.save()
    _, _, fresh = _tiny_trainer(tmp_path / "fresh", **kw)
    fresh.restore_optimizer(str(tmp_path), tr.step)
    assert fresh.opt_state.count == tr.opt_state.count == 1
    want = tr.opt_state
    if kind == "8bit":  # the artifact is canonical bf16: re-quantized
        want = topt.quantize_8bit(topt.dequantize_8bit(want, tr.params),
                                  tr.params)
    for key, a in want._asdict().items():
        if isinstance(a, dict):
            _sd_equal(getattr(fresh.opt_state, key), a)
    # a trainer of another optimizer family refuses the artifact
    other = dict(low_mem_optimizer=kind == "optax")
    _, _, wrong = _tiny_trainer(tmp_path / "wrong", **other)
    with pytest.raises(ValueError, match="optimizer artifact"):
        wrong.restore_optimizer(str(tmp_path), tr.step)
    assert os.path.exists(tmp_path / names["scaler"])


def test_lr_schedule_matches_jax():
    from sd3_tpu.training.trainer import make_lr_schedule as j_sched
    for kw in (dict(warmup_steps=3), dict(warmup_steps=3,
                                         use_lr_scheduler=True,
                                         total_steps=10)):
        a, b = j_sched(JTrainConfig(**kw)), make_lr_schedule(TrainConfig(**kw))
        for c in range(12):
            assert np.float32(a(c)) == np.float32(b(c)), (kw, c)
