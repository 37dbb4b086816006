"""The remat policies and the scan_blocks layout of sd3_torch's MMDiT and
Trainer, held to the JAX package's on the CPU, and the train CLI fed from a
parquet folder end to end.

- The policies "nothing", "dots", "attn" and "dots_attn" give bit-identical
  gradients (each recompute repeats the same plain arithmetic); K5's plain
  version runs twice per block under "nothing" and "dots" and once under
  "attn" and "dots_attn" (counted as tests/test_torch_train.py counts it),
  K6a's and K6b's once; the registered flash op is what "attn" saves.
- One fp32 step under each policy, and one in the scan layout, against
  JAX's `make_train_step` with the same `remat_policy` (and
  `scan_blocks=True` with `to_scan_params`) on the same weights and noise
  (the JAX noise draws): loss, gradient norm and the update within 1e-4
  relative, the tolerance tests/test_torch_train.py holds the fp32 steps
  to (the order of fp32 sums only).
- `to_scan_params` / `from_scan_params` round-trip exactly; a scan run's
  six artifacts after 3 steps are an unrolled run's, byte for byte (but
  the random run id in the config).
"""

import filecmp
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import create_selective_checkpoint_contexts

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models import mmdit as jmmdit
from sd3_tpu.models.mmdit import MMDiT as JMMDiT
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.training import flow as jflow
from sd3_tpu.training import trainer as jtr

from sd3_torch.config import MMDiTConfig, tiny_config
from sd3_torch.data.pipeline import synthetic_batch_iter
from sd3_torch.models import mmdit
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.ops import flash_attention as tfl
from sd3_torch.training import train
from sd3_torch.training.trainer import Noise, TrainConfig, Trainer, draw_noise
from sd3_torch.weights import state_dict_from_jax

POLICIES = ("nothing", "dots", "attn", "dots_attn")
K5_PER_BLOCK = {"nothing": 2, "dots": 2, "attn": 1, "dots_attn": 1}


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


def _batch(jcfg, acc=1, b=2, hw=8, seed=0):
    r = np.random.default_rng(seed)
    return {"x0": r.standard_normal((acc, b, jcfg.inCh, hw, hw)
                                    ).astype(np.float32),
            "text": r.standard_normal((acc, b, jcfg.text_tokens,
                                       jcfg.text_hidden_dim)).astype(np.float32),
            "pooled": r.standard_normal((acc, b, jcfg.class_dim)
                                        ).astype(np.float32)}


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


# ---- the policies on the CPU ------------------------------------------------

@pytest.fixture(scope="module")
def policy_grads(tmp_path_factory):
    """{(policy, scan): (gradients by canonical name, plain-version calls)}
    of one fp32 step of a 3-block tiny model from one init."""
    cfg = MMDiTConfig.from_json(j_tiny_config(
        attn_type="softmax_flash", num_blocks=3).to_json())
    batch = {k: _t(v) for k, v in _batch(j_tiny_config(), seed=5).items()}
    out = {}
    for scan in (False, True):
        for pol in POLICIES:
            tc = TrainConfig(batch_size=2, accumulation_steps=1,
                             track_ema=False, remat_policy=pol,
                             scan_blocks=scan)
            tr = Trainer(cfg, tc, device="cpu",
                         log_dir=str(tmp_path_factory.mktemp("logs")),
                         use_wandb=False)
            noise = [draw_noise(torch.Generator().manual_seed(6),
                                batch["x0"][0], tc)]
            calls = dict.fromkeys(("flash_fwd_plain", "flash_dq_plain",
                                   "flash_dkv_plain"), 0)
            saved = {n: getattr(tfl, n) for n in calls}

            def counted(*a, _name, _fn):
                calls[_name] += 1
                return _fn(*a)
            try:
                for n, fn in saved.items():
                    setattr(tfl, n, functools.partial(counted, _name=n,
                                                      _fn=fn))
                g, m = tr.gradients(batch, noise)
            finally:
                for n, fn in saved.items():
                    setattr(tfl, n, fn)
            out[(pol, scan)] = ({k: v.clone() for k, v in g.items()},
                                m["loss"].item(), dict(calls),
                                cfg.num_blocks)
    return out


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("policy", POLICIES)
def test_policies_give_the_same_gradients_and_their_launches(policy_grads,
                                                             policy, scan):
    g, loss, calls, nb = policy_grads[(policy, scan)]
    ref, ref_loss, _, _ = policy_grads[("nothing", False)]
    assert list(g) == list(ref)   # canonical names in the unrolled order
    assert loss == ref_loss
    for k in ref:
        assert torch.equal(g[k], ref[k]), k
    assert calls == dict(flash_fwd_plain=K5_PER_BLOCK[policy] * nb,
                         flash_dq_plain=nb, flash_dkv_plain=nb)


def test_dots_saves_the_2d_products_and_attn_the_flash_op():
    # one block at tiny widths under a recording copy of each policy
    cfg = tiny_config(attn_type="softmax_flash")
    blk = mmdit.DualStreamBlock(cfg, 0, fused_attn=False)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 16, cfg.dim, generator=g, requires_grad=True)
    c = torch.randn(2, cfg.text_tokens, cfg.dim, generator=g)
    y = torch.randn(2, cfg.dim, generator=g)
    for pol in POLICIES:
        ops = []
        keep = mmdit.remat_saved_ops(pol)

        def record(ctx, op, *a, **kw):
            if op in keep and not ctx.is_recompute:
                ops.append(str(op))
            return mmdit._keep(keep, ctx, op, *a, **kw)
        out = torch.utils.checkpoint.checkpoint(
            blk, x, c, y, (4, 4), use_reentrant=False,
            context_fn=functools.partial(create_selective_checkpoint_contexts,
                                         record))
        (out[0].sum() + out[1].sum()).backward()
        n_linear = sum(isinstance(m, torch.nn.Linear) for m in blk.modules())
        dots = sum(o in ("aten.mm.default", "aten.addmm.default")
                   for o in ops)
        assert dots == (n_linear if "dots" in pol else 0), (pol, ops)
        assert ops.count("sd3_torch.flash_fwd.default") == (
            1 if "attn" in pol else 0)
        assert "aten.bmm.default" not in ops


def test_flash_op_is_registered_with_a_fake_and_autograd():
    from torch._subclasses.fake_tensor import FakeTensorMode
    op = torch.ops.sd3_torch.flash_fwd.default
    with FakeTensorMode():
        q = torch.empty(2, 3, 10, 48, dtype=torch.bfloat16)
        out, lse = op(q, q, q, 0.5)
    assert out.shape == (2, 3, 10, 48) and out.dtype == torch.bfloat16
    assert lse.shape == (2, 3, 10) and lse.dtype == torch.float32
    r = np.random.default_rng(0)
    q, k, v = (_t(r.standard_normal((1, 2, 9, 16))).requires_grad_()
               for _ in range(3))
    out, lse = op(q, k, v, 0.25)
    want, want_lse = tfl.flash_fwd_plain(q, k, v, 0.25)
    assert torch.equal(out, want) and torch.equal(lse, want_lse)
    assert not lse.requires_grad
    out.sum().backward()
    assert q.grad is not None and k.grad is not None and v.grad is not None


# ---- held to JAX's step functions ----------------------------------------------

def _jax_step(jcfg, jtc, policy, scan):
    jm = JMMDiT(jcfg, remat_blocks=True, remat_policy=policy,
                fused_attn=False, scan_blocks=scan)
    opt = jtr.make_optimizer(jtc)
    return jm, opt, jax.jit(jtr.make_train_step(jm, opt, jtc))


@pytest.mark.parametrize("policy,scan", [(p, False) for p in POLICIES]
                         + [("attn", True)])
def test_one_fp32_step_matches_jax(tmp_path, policy, scan):
    jcfg = j_tiny_config(attn_type="softmax_flash", dtype="float32")
    tkw = dict(batch_size=2, accumulation_steps=1, lr=1e-3, warmup_steps=0,
               track_ema=False, remat_policy=policy, scan_blocks=scan)
    jtc = jtr.TrainConfig(**tkw)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(3), remat_blocks=False)
    trainer = Trainer(MMDiTConfig.from_json(jcfg.to_json()),
                      TrainConfig(**tkw), params=state_dict_from_jax(params),
                      device="cpu", log_dir=str(tmp_path), use_wandb=False)
    assert trainer.model.num_scan == (jcfg.num_blocks - 1 if scan else 0)
    jm, opt, step = _jax_step(jcfg, jtc, policy, scan)
    n_scan = jmmdit.num_scan_blocks(jcfg)
    jp = jmmdit.to_scan_params(params, n_scan) if scan else params
    js = opt.init(jp)
    p0 = {k: _np(v) for k, v in trainer.params.items()}
    batch = _batch(jcfg, seed=60)
    key = jax.random.PRNGKey(61)
    jp, js, jmet = step(jp, js, key, batch)
    tmet = trainer.train_step({k: _t(v) for k, v in batch.items()},
                              [_jax_noise(key, batch["x0"][0], jtc)])
    assert tmet["loss"].item() == pytest.approx(float(jmet["loss"]), rel=1e-4)
    assert tmet["grad_norm"].item() == pytest.approx(
        float(jmet["grad_norm"]), rel=1e-4)
    want = state_dict_from_jax(jmmdit.from_scan_params(jp, n_scan) if scan
                               else jp)
    dp_t = _flat({k: _np(v) - p0[k] for k, v in trainer.params.items()})
    dp_j = _flat({k: _np(v) - p0[k] for k, v in want.items()})
    assert _rel_l2(dp_t, dp_j) < 1e-4


# ---- the scan layout ---------------------------------------------------------

def test_scan_params_round_trip_and_stack_the_blocks():
    cfg = tiny_config(attn_type="softmax_flash", num_blocks=4)
    sd = MMDiT(cfg, device="cpu").init_weights(
        torch.Generator().manual_seed(1)).state_dict()
    n = mmdit.num_scan_blocks(cfg)
    assert n == 3
    scan = mmdit.to_scan_params(sd, n)
    model = MMDiT(cfg, device="cpu", scan_blocks=True)
    assert list(scan) == list(model.state_dict())
    model.load_state_dict(scan, strict=True)
    w = scan["blocks_stack.block.attn.query_proj_x.weight"]
    assert w.shape == (3, *sd["blocks.0.attn.query_proj_x.weight"].shape)
    for i in range(3):
        assert torch.equal(w[i], sd[f"blocks.{i}.attn.query_proj_x.weight"])
    back = mmdit.from_scan_params(scan, n)
    assert list(back) == list(sd)
    assert all(torch.equal(back[k], sd[k]) for k in sd)
    assert list(model.canonical_parameters()) == list(
        dict(MMDiT(cfg, device="cpu").named_parameters()))
    # an unrolled model's seeded init equals the scan model's
    scan_init = MMDiT(cfg, device="cpu", scan_blocks=True).init_weights(
        torch.Generator().manual_seed(1)).canonical_parameters()
    assert all(torch.equal(scan_init[k], sd[k]) for k in sd)


def test_scan_refusals():
    # attn_type "both" scans in pairs (tests/test_torch_variants.py)
    assert MMDiT(tiny_config(attn_type="both", num_blocks=3), device="cpu",
                 scan_blocks=True).scan_pair
    with pytest.raises(ValueError, match="unrolled"):
        MMDiT(tiny_config(attn_type="softmax_flash", quant="int8"),
              device="cpu", scan_blocks=True)
    from sd3_torch.ops.quant import quantize_model
    with pytest.raises(ValueError, match="unrolled"):
        quantize_model(MMDiT(tiny_config(attn_type="softmax_flash"),
                             device="cpu", scan_blocks=True))
    with pytest.raises(ValueError, match="remat_policy"):
        MMDiT(tiny_config(attn_type="softmax_flash"), device="cpu",
              remat_policy="everything")


@pytest.mark.parametrize("tkw", [
    dict(), dict(low_mem_optimizer=True, fused_optimizer=True,
                 bf16_grads=True, accumulation_steps=1, dtype="bfloat16"),
    dict(moments_8bit=True, low_mem_optimizer=True, ema_on_host=True)])
def test_a_scan_run_writes_an_unrolled_runs_checkpoint(tmp_path, tkw):
    tkw = dict(tkw)
    cfg = tiny_config(attn_type="softmax_flash",
                      dtype=tkw.pop("dtype", "float32"))
    dirs = []
    for scan in (False, True):
        d = str(tmp_path / ("scan" if scan else "unrolled"))
        tc = TrainConfig(batch_size=2, total_steps=3, warmup_steps=1,
                         lr=1e-3, ema_update_freq=1, log_steps=100,
                         num_save_steps=3, save_dir=d, scan_blocks=scan,
                         remat_policy="dots_attn", **tkw)
        tr = Trainer(cfg, tc, device="cpu", log_dir=d, use_wandb=False)
        tr.train(synthetic_batch_iter(cfg, 2, tc.accumulation_steps, 32, 32,
                                      seed=1))
        dirs.append(d)
    names = sorted(f for f in os.listdir(dirs[0])
                   if not f.startswith("metrics"))
    assert len(names) == 6
    for f in names:
        a, b = (os.path.join(d, f) for d in dirs)
        if f.endswith(".json"):
            ja, jb = json.load(open(a)), json.load(open(b))
            ja.pop("wandb_id"), jb.pop("wandb_id")
            assert ja == jb
        else:
            assert filecmp.cmp(a, b, shallow=False), f


# ---- the train CLI from a parquet folder ---------------------------------------

@pytest.fixture(scope="module")
def phase_folder(tmp_path_factory):
    """raw parquet (two files, three aspect families) -> filter -> phase
    (max 48) -> bucket index, through the port's CLIs."""
    import io
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image
    from sd3_torch.data import create_indices, create_phase, filter_dataset
    root = tmp_path_factory.mktemp("cli")
    raw = root / "raw"
    raw.mkdir()
    r = np.random.default_rng(0)
    fam = ((40, 40), (32, 48), (48, 32))
    for f in range(2):
        rows = []
        for i in range(18):
            h, w = fam[(i + f) % 3]
            buf = io.BytesIO()
            Image.fromarray((r.random((h, w, 3)) * 255).astype(np.uint8)
                            ).save(buf, format="PNG")
            rows.append({"image": {"bytes": buf.getvalue(), "path": None},
                         "recaption": f"a long caption number {f}-{i}",
                         "recaption_short": f"short caption {f}-{i}"})
        pq.write_table(pa.Table.from_pylist(rows), str(raw / f"p{f}.parquet"))
    filter_dataset.main(["--input_dir", str(raw), "--output_dir",
                         str(root / "filt"), "--min_resolution", "16"])
    create_phase.main(["--input_dir", str(root / "filt"), "--output_dir",
                       str(root / "phase"), "--max_resolution", "48"])
    create_indices.main(["--data_parquet_folder", str(root / "phase"),
                         "--bucket_indices_path", str(root / "idx.npy")])
    return str(root / "phase"), str(root / "idx.npy")


@pytest.mark.parametrize("extra", [
    ["--data_threads", "2"],
    ["--ring_workers", "1", "--scan_blocks", "--remat_policy", "dots_attn"]])
def test_train_cli_trains_from_a_parquet_folder(tmp_path, phase_folder,
                                                extra, capsys):
    folder, idx = phase_folder
    tr = train.main([
        "--device", "cpu", "--preset", "tiny", "--stage_res", "48",
        "--data_parquet_folder", folder, "--bucket_indices_path", idx,
        "--stub_encoders", "--batchSize", "2", "--accumulation_steps", "2",
        "--totalSteps", "3", "--warmup_steps", "1", "--log_steps", "1",
        "--saveDir", str(tmp_path), *extra])
    assert tr.step == 3 and tr.saved_step == 3
    out = capsys.readouterr().out
    shapes = [line.split("bucket ")[1].split(",")[0]
              for line in out.splitlines() if line.startswith("step ")]
    assert len(shapes) == 3
    assert set(shapes) <= {"32x48", "48x32", "32x32", "48x48"}
    assert os.path.isfile(tmp_path / "model_3s.msgpack")
    logs = [json.loads(s) for f in os.listdir(tmp_path)
            if f.startswith("metrics_")
            for s in open(tmp_path / f).read().splitlines()]
    assert [r["step"] for r in logs] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) for r in logs)
