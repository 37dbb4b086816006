"""The port's train and infer CLIs end to end on the CPU (`--device cpu
--preset tiny --synthetic`): train -> six-artifact checkpoint -> resume ->
sample -> PNG / GIF, as the JAX package's drive does.

Resume is checked bit for bit: a run resumed at its checkpoint's step and
saved again writes the same model, EMA, optimizer and scheduler bytes. An
8-bit run resumes from a bf16 run's canonical artifact, its moments within
one fp8-e4m3 level of it (1/8 relative, or for a value far under its
block's largest the subnormal step of the block's scale). Sampling from a
checkpoint the JAX package wrote equals, bit for bit, sampling from the
same tree carried in by `state_dict_from_jax` (the same seed; the same
plain arithmetic).
"""

import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.models.mmdit import init_mmdit
from sd3_tpu.training import checkpoint as jck

from sd3_torch.config import MMDiTConfig
from sd3_torch.inference import infer
from sd3_torch.inference.sampler import sample_imgs
from sd3_torch.models.mmdit import MMDiT
from sd3_torch.models.text_encoders import load_text_encoders
from sd3_torch.training import checkpoint as tck
from sd3_torch.training import train
from sd3_torch.weights import state_dict_from_jax

ARTIFACTS = ("model", "ema", "optim", "scheduler", "scaler", "defs")
# the smallest fp8-e4m3 step, 2^-9, times a block's scale (its absmax / 448),
# over the absmax: the error of a moment far under its block's largest
FP8_SUBNORMAL = 2.0 ** -9 / 448


def _train(save_dir, *extra):
    return train.main([
        "--device", "cpu", "--preset", "tiny", "--synthetic",
        "--stage_res", "32", "--batchSize", "2", "--accumulation_steps", "2",
        "--warmup_steps", "1", "--ema_update_freq", "1", "--log_steps", "1",
        "--saveDir", str(save_dir), *extra])


def _bytes(d, step, key):
    with open(os.path.join(d, tck._names(step)[key]), "rb") as f:
        return f.read()


def test_train_cli_writes_six_artifacts_at_each_save(tmp_path):
    tr = _train(tmp_path, "--totalSteps", "4", "--numSaveSteps", "2",
                "--low_mem_optimizer")
    assert tr.step == 4 and tr.saved_step == 4
    for step in (2, 4):
        for key in ARTIFACTS:
            assert os.path.isfile(tmp_path / tck._names(step)[key]), (step, key)
    cfg = tck.load_config(str(tmp_path), "model_params_4s.json")
    assert cfg.start_step == 4 and cfg.max_res == 32
    assert tck.load_artifact(str(tmp_path), "scheduler_4s.msgpack") == {
        "step": 4}
    logs = [f for f in os.listdir(tmp_path) if f.startswith("metrics_")]
    assert len(logs) == 1


@pytest.mark.parametrize("opt", [[], ["--low_mem_optimizer"],
                                 ["--moments_8bit", "--ema_on_host"]])
def test_train_cli_resumes_step_ema_and_optimizer_bit_for_bit(tmp_path, opt):
    a, b = tmp_path / "a", tmp_path / "b"
    _train(a, "--totalSteps", "2", "--numSaveSteps", "2", *opt)
    tr = _train(b, "--totalSteps", "2", "--loadDir", str(a), "--loadStep",
                "2", *opt)
    assert tr.step == 2 and tr.saved_step == 2
    for key in ("model", "ema", "scheduler"):
        assert _bytes(a, 2, key) == _bytes(b, 2, key), key
    if "--moments_8bit" not in opt:
        assert _bytes(a, 2, "optim") == _bytes(b, 2, "optim")
    # and it trains on from there
    tr = _train(tmp_path / "c", "--totalSteps", "3", "--loadDir", str(b),
                "--loadStep", "2", *opt)
    assert tr.step == 3


def test_train_cli_resets_the_optimizer_on_request(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    _train(a, "--totalSteps", "2", "--numSaveSteps", "2")
    tr = _train(b, "--totalSteps", "2", "--loadDir", str(a), "--loadStep",
                "2", "--reset_optim", "--reset_wandb")
    assert tr.opt_state.count == 0
    assert tck.load_config(str(b), "model_params_2s.json").wandb_id != \
        tck.load_config(str(a), "model_params_2s.json").wandb_id


def test_moments_8bit_resumes_from_a_bf16_run(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    _train(a, "--totalSteps", "2", "--numSaveSteps", "2",
           "--low_mem_optimizer")
    tr = _train(b, "--totalSteps", "2", "--loadDir", str(a), "--loadStep",
                "2", "--moments_8bit")
    assert type(tr.opt_state).__name__ == "Adam8bitState"
    assert tr.opt_state.count == 2
    wa, wb = (tck.load_artifact(str(d), "optim_2s.msgpack") for d in (a, b))
    assert int(wa["count"]) == int(wb["count"]) == 2
    for key in ("mu", "nu"):
        x, y = (state_dict_from_jax(w[key]) for w in (wa, wb))
        for k in x:
            np.testing.assert_allclose(
                y[k].numpy(), x[k].numpy(), rtol=2 ** -3,
                atol=FP8_SUBNORMAL * x[k].abs().max().item(), err_msg=k)
    assert _train(tmp_path / "c", "--totalSteps", "3", "--loadDir", str(b),
                  "--loadStep", "2", "--moments_8bit").step == 3


def test_train_cli_refuses_the_queued_options(tmp_path, monkeypatch):
    # --scan_blocks, --remat_policy, --data_parquet_folder and the mesh are
    # ported (tests/test_torch_remat_scan.py, test_torch_parallel.py,
    # test_torch_multihost.py); a mesh that does not cover the world (one
    # process without --multihost) is refused as the trainer refuses it,
    # --multihost without an address or torchrun's environment raises, and
    # the feed refuses real encoders without a weights directory
    for extra in (["--dp", "2"], ["--tp", "2"]):
        with pytest.raises(ValueError, match="does not cover 1 devices"):
            train.main(["--device", "cpu", *extra])
    for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="--coordinator_address.*torchrun"):
        train.main(["--device", "cpu", "--multihost"])
    with pytest.raises(RuntimeError, match="--encoder_weights"):
        train.main(["--device", "cpu", "--data_parquet_folder",
                    str(tmp_path), "--saveDir", str(tmp_path)])


def _infer(ckpt_dir, step, out, *extra):
    infer.main(["--loadDir", str(ckpt_dir), "--step", str(step),
                "--text_input", "a red fox", "--num_steps", "3",
                "--guidance", "5", "--width", "32", "--height", "32",
                "--seed", "7", "--batch_size", "2", "--stub_encoders",
                "--device", "cpu", "--out_imgname", str(out), *extra])


def test_infer_cli_samples_a_trained_checkpoint_to_png_and_gif(tmp_path):
    _train(tmp_path, "--totalSteps", "2", "--numSaveSteps", "2")
    out = tmp_path / "fig"
    _infer(tmp_path, 2, out, "--ema", "--gif", "--gif_fps", "5")
    for i in range(2):
        with Image.open(f"{out}_{i}.png") as im:
            assert im.size == (32, 32)
    with Image.open(f"{out}_diffusion.gif") as gif:
        assert gif.n_frames == 3
    _infer(tmp_path, 2, tmp_path / "q", "--quant", "int8", "--dtype",
           "float32", "--attn_tail", "all", "--mlp_tail_fusion", "3d")
    assert os.path.isfile(f"{tmp_path / 'q'}_1.png")


def test_sampling_a_jax_checkpoint_equals_the_carried_tree(tmp_path):
    jcfg = j_tiny_config(num_blocks=2)
    _, params = init_mmdit(jcfg, jax.random.PRNGKey(13), remat_blocks=False)
    jck.save_checkpoint(str(tmp_path), jcfg, params, step=5)
    lat_path = str(tmp_path / "lat.npy")
    _infer(tmp_path, 5, tmp_path / "j", "--save_latents", lat_path)
    got = np.load(lat_path)

    cfg = MMDiTConfig.from_json(jcfg.to_json())
    model = MMDiT(cfg, device="cpu").eval()
    model.load_state_dict(state_dict_from_jax(params, jcfg.patch_size),
                          strict=True)
    enc = load_text_encoders(device="cpu", stub=True, model_cfg=cfg)
    want = sample_imgs(model, enc, 2, 3, "a red fox", 5.0, 32, 32, "euler",
                       generator=torch.Generator().manual_seed(7),
                       decode=False)
    assert np.array_equal(got, want.float().numpy())
