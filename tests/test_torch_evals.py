"""The port's eval path (sd3_torch/evals/) held to the JAX package's on the
CPU: the FID maths and the hermetic features on the same numpy-seeded
inputs (features bit for bit, FID to rtol 1e-9), the calculate_fid CLI's
printed lines on the same PNG folders, and the generate_images CLI on a
tiny checkpoint the port's train CLI writes (JAX's test_eval_cli.py flow at
res 16, 2 steps, stub encoders): the layout and manifest JAX's CLI
writes, the images `sample_imgs` gives with the same generator, and
`--quant int8`.
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from sd3_tpu.evals import calculate_fid as jcalc
from sd3_tpu.evals import fid as jfid

from sd3_torch.evals import calculate_fid, fid, generate_images
from sd3_torch.inference import infer
from sd3_torch.inference.sampler import sample_imgs
from sd3_torch.models.text_encoders import load_text_encoders
from sd3_torch.training import train


@pytest.fixture
def narrow_features(monkeypatch):
    """ReducedPixelFeatures of 64 dimensions in both packages (the same
    seeded draws of that shape): the Fréchet distance's sqrtm of 2048 x
    2048 takes ~10 s a score on the CPU; the printed lines do not depend on
    the width."""
    for mod in (fid, jfid):
        monkeypatch.setattr(mod.ReducedPixelFeatures, "dim", 64)


def _write_images(d, seed, n=12, bright=0.0, size=24):
    rng = np.random.default_rng(seed)
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        arr = np.clip(rng.random((size, size, 3)) * 255 * (1 - bright)
                      + bright * 255, 0, 255).astype(np.uint8)
        Image.fromarray(arr).save(os.path.join(d, f"{i}.png"))
    return str(d)


# ---- the FID maths ---------------------------------------------------------

@pytest.mark.parametrize("n,d", [(64, 8), (40, 32), (300, 256)])
def test_frechet_distance_equals_the_jax_packages(n, d):
    rng = np.random.default_rng(n + d)
    a = rng.standard_normal((n, d))
    b = rng.standard_normal((n, d)) * 1.3 + 0.2
    got = [fid.activation_stats(x) for x in (a, b)]
    want = [jfid.activation_stats(x) for x in (a, b)]
    for (gm, gs), (wm, ws) in zip(got, want):
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_array_equal(gs, ws)
    score = fid.frechet_distance(*got[0], *got[1])
    np.testing.assert_allclose(score, jfid.frechet_distance(*want[0],
                                                            *want[1]),
                               rtol=1e-9)
    assert abs(fid.frechet_distance(*got[0], *got[0])) < 1e-6 * max(1, d)


def test_frechet_distance_on_a_scipy_without_disp(monkeypatch, capsys):
    """scipy 1.18 dropped sqrtm's `disp` argument, which the JAX package
    passes: the port's FID gives the same score either way, and prints
    nothing for a singular product (6 samples in 16 dimensions)."""
    import scipy.linalg
    rng = np.random.default_rng(7)
    a, b = rng.standard_normal((6, 16)), rng.standard_normal((6, 16)) + 0.5
    stats = [fid.activation_stats(x) for x in (a, b)]
    want = jfid.frechet_distance(*stats[0], *stats[1])
    capsys.readouterr()
    assert fid.frechet_distance(*stats[0], *stats[1]) == want
    real = scipy.linalg.sqrtm
    monkeypatch.setattr(scipy.linalg, "sqrtm",
                        lambda m: real(m, disp=False)[0])
    np.testing.assert_allclose(fid.frechet_distance(*stats[0], *stats[1]),
                               want, rtol=1e-9)
    assert capsys.readouterr().out == ""


def test_frechet_known_gaussians():
    mu1, mu2, s = np.zeros(4), np.full(4, 2.0), np.eye(4)
    assert abs(fid.frechet_distance(mu1, s, mu2, s) - 16.0) < 1e-6


@pytest.mark.parametrize("seed", [0, 3])
def test_reduced_pixel_features_are_the_jax_packages_bit_for_bit(seed):
    images = np.random.default_rng(seed).uniform(-1, 1, (5, 3, 40, 28))
    got = fid.ReducedPixelFeatures(seed)(images)
    want = jfid.ReducedPixelFeatures(seed)(images)
    assert got.shape == (5, 2048) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_default_features_fall_back_as_the_jax_packages(tmp_path):
    try:
        import torchvision  # noqa: F401
        pytest.skip("torchvision is installed: no fallback to show")
    except ImportError:
        pass
    assert isinstance(fid.default_features(None), fid.ReducedPixelFeatures)
    assert isinstance(jfid.default_features(None), jfid.ReducedPixelFeatures)


def test_fid_between_dirs_and_the_stats_round_trip(tmp_path,
                                                   narrow_features):
    d1 = _write_images(tmp_path / "a", seed=0)
    d2 = _write_images(tmp_path / "b", seed=1)
    d3 = _write_images(tmp_path / "c", seed=2, bright=0.9)
    f, jf = fid.ReducedPixelFeatures(), jfid.ReducedPixelFeatures()
    same, diff = fid.fid_between_dirs(d1, d2, f), fid.fid_between_dirs(d1,
                                                                      d3, f)
    assert diff > same >= 0.0
    np.testing.assert_allclose(same, jfid.fid_between_dirs(d1, d2, jf),
                               rtol=1e-9)
    mu, s = fid.activation_stats(np.random.default_rng(3).standard_normal(
        (32, 6)))
    p = str(tmp_path / "stats" / "s.npz")
    fid.save_stats(p, mu, s)
    for load in (fid.load_stats, jfid.load_stats):
        mu2, s2 = load(p)
        np.testing.assert_array_equal(mu, mu2)
        np.testing.assert_array_equal(s, s2)


# ---- calculate_fid ----------------------------------------------------------

@pytest.fixture(scope="module")
def image_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("fid")
    for c, (seed, bright) in enumerate(((0, 0.0), (1, 0.3), (2, 0.8))):
        _write_images(root / "gen" / f"c{c}", seed, n=6)
        _write_images(root / "ref" / f"c{c}", seed + 10, n=6, bright=bright)
    return str(root)


def _run(main, argv, capsys):
    main(argv)
    cap = capsys.readouterr()
    return cap.out.replace(os.sep + "jax" + os.sep, os.sep), cap.err


@pytest.mark.parametrize("argv", [
    ["score", "--generated_dir", "{r}/gen/c0", "--ref_dir", "{r}/ref/c2"],
    ["score", "--per_class", "--generated_dir", "{r}/gen",
     "--ref_dir", "{r}/ref"],
    ["score", "--generated_dir", "{r}/gen", "--ref_dir", "{r}/ref"]])
def test_calculate_fid_prints_the_jax_packages_lines(image_dirs, capsys,
                                                     argv, narrow_features):
    argv = [a.format(r=image_dirs) for a in argv]
    got = _run(calculate_fid.main, argv, capsys)
    want = _run(jcalc.main, argv, capsys)
    assert got == want
    assert "ReducedPixelFeatures" in got[1]
    assert ("mean FID over 3 classes" if "--per_class" in argv
            else "FID: ") in got[0]


def test_calculate_fid_stats_then_score(image_dirs, tmp_path, capsys,
                                        narrow_features):
    printed = {}
    for name, mod in (("port", calculate_fid), ("jax", jcalc)):
        out = str(tmp_path / name / "ref.npz")
        mod.main(["stats", "--image_dir", f"{image_dirs}/ref", "--out", out])
        mod.main(["score", "--generated_dir", f"{image_dirs}/gen",
                  "--ref_stats", out])
        printed[name] = capsys.readouterr().out.splitlines()[-1]
    assert printed["port"] == printed["jax"]
    score = calculate_fid.main(["score", "--generated_dir",
                                f"{image_dirs}/gen", "--ref_stats",
                                str(tmp_path / "port" / "ref.npz")])
    assert printed["port"] == f"FID: {score:.4f}"
    for a, b in zip(np.load(tmp_path / "port" / "ref.npz").values(),
                    np.load(tmp_path / "jax" / "ref.npz").values()):
        np.testing.assert_array_equal(a, b)


# ---- generate_images ---------------------------------------------------------

@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    ck = str(tmp_path_factory.mktemp("ck"))
    train.main(["--device", "cpu", "--preset", "tiny", "--synthetic",
                "--stage_res", "16", "--batchSize", "2",
                "--accumulation_steps", "1", "--totalSteps", "2",
                "--numSaveSteps", "2", "--warmup_steps", "1",
                "--log_steps", "1", "--saveDir", ck])
    prompts = os.path.join(ck, "prompts.txt")
    with open(prompts, "w") as f:
        f.write("a fox\n\na cat\n")
    return ck, prompts


def _generate(mod, ck, prompts, out, *extra):
    argv = ["--loadDir", ck, "--step", "2", "--prompts_file", prompts,
            "--num_per_prompt", "3", "--batch_size", "2", "--num_steps", "2",
            "--res", "16", "--out_dir", out, "--stub_encoders", *extra]
    if mod is generate_images:
        argv += ["--device", "cpu"]
    return mod.main(argv)


def _layout(out):
    files = sorted(os.path.relpath(os.path.join(r, n), out)
                   for r, _, names in os.walk(out) for n in names)
    with open(os.path.join(out, "manifest.json")) as f:
        manifest = [{**m, "dir": os.path.relpath(m["dir"], out)}
                    for m in json.load(f)]
    return files, manifest


def test_generate_images_writes_the_jax_clis_layout(checkpoint, tmp_path):
    from sd3_tpu.evals import generate_images as jgen
    ck, prompts = checkpoint
    _generate(generate_images, ck, prompts, str(tmp_path / "port"))
    _generate(jgen, ck, prompts, str(tmp_path / "jax"))
    got, want = _layout(str(tmp_path / "port")), _layout(str(tmp_path / "jax"))
    assert got == want
    assert got[1] == [{"prompt": "a fox", "dir": "0", "count": 3},
                      {"prompt": "a cat", "dir": "1", "count": 3}]
    with Image.open(tmp_path / "port" / "1" / "2.png") as im:
        assert im.size == (16, 16)


def test_generate_images_draws_each_batch_from_one_generator(checkpoint,
                                                             tmp_path):
    ck, prompts = checkpoint
    out = str(tmp_path / "gen")
    trace_dir = str(tmp_path / "trace")
    manifest, batch_s = _generate(generate_images, ck, prompts, out,
                                  "--seed", "5", "--trace_dir", trace_dir)
    assert len(manifest) == 2 and batch_s["n"] == 3  # 4 batches, 1 traced
    assert os.listdir(trace_dir)
    args = generate_images.build_argparser().parse_args(
        ["--loadDir", ck, "--step", "2"])
    model, cfg = infer.load_model(generate_images.model_args(args), "cpu")
    enc = load_text_encoders(device="cpu", stub=True, model_cfg=cfg)
    gen = torch.Generator(device="cpu").manual_seed(5)
    for n, prompt, files in ((2, "a fox", ("0/0", "0/1")),
                             (1, "a fox", ("0/2",))):
        imgs = sample_imgs(model, enc, n, 2, prompt, 5.0, 16, 16, "euler",
                           generator=gen).float().numpy()
        for img, name in zip(imgs, files):
            want = os.path.join(str(tmp_path), "want.png")
            infer.save_png(img, want)
            with Image.open(want) as a, \
                    Image.open(os.path.join(out, name + ".png")) as b:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_generate_images_int8_runs_and_builds_from_the_infer_defaults(
        checkpoint, tmp_path):
    ck, prompts = checkpoint
    args = generate_images.build_argparser().parse_args(
        ["--loadDir", ck, "--step", "2", "--quant", "int8", "--ema"])
    margs = generate_images.model_args(args)
    defaults = infer.build_argparser(prompt=False).parse_args(
        ["--loadDir", ck])
    assert (margs.quant, margs.ema, margs.step) == ("int8", True, 2)
    for k in ("dtype", "int8_pv", "attn_tail", "mlp_tail_fusion",
              "no_mlp_tail", "no_fused_mlp", "quant_skip", "torch_ckpt"):
        assert getattr(margs, k) == getattr(defaults, k), k
    out = str(tmp_path / "int8")
    _generate(generate_images, ck, prompts, out, "--quant", "int8")
    bf = str(tmp_path / "bf")
    _generate(generate_images, ck, prompts, bf)
    for name in ("0/0.png", "1/2.png"):
        with Image.open(os.path.join(out, name)) as a, \
                Image.open(os.path.join(bf, name)) as b:
            a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
            assert a.shape == b.shape == (16, 16, 3)
            assert np.abs(a - b).mean() < 8.0  # int8 drift, not another image


def test_generate_images_refuses_a_missing_card(checkpoint, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is there")
    ck, prompts = checkpoint
    with pytest.raises(RuntimeError, match="CUDA"):
        generate_images.main(["--loadDir", ck, "--step", "2", "--out_dir",
                              str(tmp_path), "--stub_encoders"])
