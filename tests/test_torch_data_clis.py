"""The port's five dataset-prep CLIs (sd3_torch/data/{merge_captions,
convert_imagenet,download,recaption,upload_dataset}.py) held to the JAX
package's on the fixtures of that package's own tests: the same inputs
through both modules, every output table equal (`assert_frame_equal`) and
every output file named alike. No network: URLs are `file://`, the
captioner and distiller are the stub models, the push is a callable.
"""

import io
import json
import os
import tarfile

import numpy as np
import pandas as pd
import pytest
from pandas.testing import assert_frame_equal
from PIL import Image

from sd3_tpu.data import convert_imagenet as jconvert
from sd3_tpu.data import download as jdownload
from sd3_tpu.data import merge_captions as jmerge
from sd3_tpu.data import recaption as jrecap
from sd3_tpu.data import upload_dataset as jupload

from sd3_torch.data import (convert_imagenet, download, merge_captions,
                            recaption, upload_dataset)


def _files(d):
    return sorted(p for p in os.listdir(d) if not p.startswith("."))


def _same_parquet_folders(got_dir, want_dir):
    assert _files(got_dir) == _files(want_dir)
    for name in _files(got_dir):
        if name.endswith(".parquet"):
            assert_frame_equal(pd.read_parquet(os.path.join(got_dir, name)),
                               pd.read_parquet(os.path.join(want_dir, name)))


def _png(seed, size=(8, 6), fmt="PNG"):
    rng = np.random.default_rng(seed)
    arr = rng.integers(0, 255, (size[1], size[0], 3), dtype=np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format=fmt)
    return buf.getvalue()


# ---- merge_captions ----------------------------------------------------------

def _merge_fixtures(d):
    """tests/test_merge_captions.py's fixture, and a row whose caption
    fields are null."""
    caps = [{"key": "1", "caption_llava": " A long cap one. ",
             "caption_llava_short": "short one"},
            {"key": "2", "caption_llava": "A long cap two",
             "caption_llava_short": " short two "},
            {"key": "4", "caption_llava": None,
             "caption_llava_short": "short four"}]
    d.mkdir()
    jl = d / "train.jsonl"
    jl.write_text("\n".join(json.dumps(c) for c in caps))
    rows = [{"id": str(i), "image": {"bytes": f"img{i}".encode()},
             "conversations": [{"value": "q"}, {"value": f"orig {i}"}]}
            for i in (1, 2, 3, 4)]
    src = d / "in"
    src.mkdir()
    pd.DataFrame(rows[:2]).to_parquet(src / "p0.parquet")
    pd.DataFrame(rows[2:]).to_parquet(src / "p1.parquet")
    return str(jl), str(src)


def test_merge_captions_writes_the_jax_packages_tables(tmp_path):
    outs = {}
    for name, mod in (("port", merge_captions), ("jax", jmerge)):
        jl, src = _merge_fixtures(tmp_path / name)
        out, err = tmp_path / name / "out", tmp_path / name / "errors.txt"
        mod.main(["--captions_jsonl", jl, "--parquet_in_dir", src,
                  "--out_dir", str(out), "--errors_file", str(err),
                  "--class_name", "CC12M", "--delete_while_merging"])
        assert not os.listdir(src)  # consumed
        outs[name] = (str(out), err.read_text())
    _same_parquet_folders(outs["port"][0], outs["jax"][0])
    assert outs["port"][1] == outs["jax"][1] == "p1.parquet:3\np1.parquet:4\n"


def test_merge_captions_df_equals_the_jax_packages(tmp_path):
    jl, src = _merge_fixtures(tmp_path / "d")
    df = pd.read_parquet(os.path.join(src, "p0.parquet"))
    df.loc[1, "image"] = b"img2"  # a flat bytes value passes through
    got_err, want_err = [], []
    got = merge_captions.merge_captions_df(
        df, *merge_captions.load_caption_maps(jl), errors=got_err)
    want = jmerge.merge_captions_df(df, *jmerge.load_caption_maps(jl),
                                    errors=want_err)
    assert_frame_equal(got, want)
    assert got_err == want_err


# ---- convert_imagenet ---------------------------------------------------------

def _make_tar(path, names):
    with tarfile.open(path, "w") as tar:
        for i, name in enumerate(names):
            data = _png(i, fmt="JPEG") if name != "n001_bad.JPEG" else b"no"
            info = tarfile.TarInfo(name=name)
            info.size = len(data)
            tar.addfile(info, io.BytesIO(data))


@pytest.mark.parametrize("delete_tars", [False, True])
def test_convert_imagenet_writes_the_jax_packages_tables(tmp_path,
                                                         delete_tars):
    outs = {}
    for name, mod in (("port", convert_imagenet), ("jax", jconvert)):
        tars = tmp_path / name / "tars"
        tars.mkdir(parents=True)
        _make_tar(tars / "n001.tar", ["n001_1.JPEG", "n001_2.JPEG",
                                      "n999_3.JPEG", "n001_bad.JPEG"])
        _make_tar(tars / "n002.tar", ["n002_1.JPEG"])
        cmap = tmp_path / name / "classes.json"
        cmap.write_text(json.dumps({"n001": "goldfish", "n002": "tench"}))
        out = tmp_path / name / "pq"
        if mod is convert_imagenet:
            mod.main(["--input_dir", str(tars), "--output_dir", str(out),
                      "--class_map", str(cmap)]
                     + ["--delete_tars"] * delete_tars)
        else:
            mod.convert_all(str(tars), str(out), str(cmap),
                            delete_tars=delete_tars)
        assert len(list(tars.glob("*.tar"))) == 2 * (not delete_tars)
        outs[name] = str(out)
    _same_parquet_folders(outs["port"], outs["jax"])
    df = pd.read_parquet(os.path.join(outs["port"], "n001.parquet"))
    assert list(df["id"]) == ["n001_1", "n001_2"]
    assert Image.open(io.BytesIO(df["image"][0])).format == "PNG"


# ---- download -----------------------------------------------------------------

def _url_list(d, n=5):
    d.mkdir(parents=True)
    urls, caps = [], []
    for i in range(n):
        png = d / f"im{i}.png"
        png.write_bytes(_png(i, size=(8 + i, 6)))
        urls.append(png.as_uri())
        caps.append(f"caption {i}")
    urls.insert(2, (d / "missing1.png").as_uri())
    caps.insert(2, "dead")
    table = d / "list.tsv"
    pd.DataFrame({"url": urls, "caption": caps}).to_csv(
        table, sep="\t", index=False)
    return str(table)


def test_crawl_writes_the_jax_packages_shards(tmp_path, capsys):
    table = _url_list(tmp_path / "src")
    assert download.main(["urls", table, str(tmp_path / "port"),
                          "--shard_rows", "3", "--threads", "2",
                          "--retries", "1"]) == 0
    got = json.loads(capsys.readouterr().out)
    want = jdownload.crawl_urls(table, str(tmp_path / "jax"), shard_rows=3,
                                threads=2, retries=1, log=lambda *_: None)
    assert got == want == {"ok": 5, "failed": 1, "shards": 2}
    _same_parquet_folders(str(tmp_path / "port"), str(tmp_path / "jax"))
    for d in ("port", "jax"):
        failed = [json.loads(ln) for ln in open(tmp_path / d / "failed.jsonl")]
        assert [f["url"].rsplit("/", 1)[-1] for f in failed] == [
            "missing1.png"]
    # a second run resumes: every shard is there, nothing is fetched
    again = download.crawl_urls(table, str(tmp_path / "port"), shard_rows=3,
                                log=lambda *_: None)
    assert again == {"ok": 0, "failed": 0, "shards": 2}


def test_fetch_resumes_and_checks_like_the_jax_package(tmp_path):
    import hashlib
    src = tmp_path / "src.bin"
    payload = bytes(range(256)) * 512
    src.write_bytes(payload)
    for name, mod in (("port", download), ("jax", jdownload)):
        dest = str(tmp_path / name / "dst.bin")
        os.makedirs(os.path.dirname(dest))
        with open(dest + ".part", "wb") as f:  # file:// ignores Range
            f.write(b"garbage")
        mod.fetch(src.as_uri(), dest, log=lambda *_: None,
                  sha256=hashlib.sha256(payload).hexdigest())
        assert open(dest, "rb").read() == payload
        with pytest.raises(ValueError, match="sha256"):
            mod.fetch(src.as_uri(), str(tmp_path / name / "bad.bin"),
                      sha256="0" * 64, log=lambda *_: None)
    assert download.PERMANENT_HTTP == jdownload.PERMANENT_HTTP
    assert download.SHARD_COLUMNS == jdownload.SHARD_COLUMNS


# ---- recaption ----------------------------------------------------------------

def _recap_df(n=12):
    return pd.DataFrame({"image": [_png(i) for i in range(n)] + [b"broken"],
                         "class": [f"thing{i}" for i in range(n)] + ["x"]})


@pytest.mark.parametrize("caption", [
    "The image shows a red fox.", "In this artwork, a boat.",
    "A plain caption.", "the image shows The Image Shows twice",
    " no text" * 6 + " filler blah", "word word word"])
def test_caption_rules_equal_the_jax_packages(caption):
    assert recaption.postprocess_caption(caption) == \
        jrecap.postprocess_caption(caption)
    assert recaption.caption_failed(caption) == jrecap.caption_failed(caption)


def test_recaption_folder_writes_the_jax_packages_tables(tmp_path):
    def flaky(mod):
        captioner, _ = mod.stub_models()

        def run(images, hints):
            caps = captioner(images, hints)
            return ["blah blah blah" if h == "thing3" else c
                    for h, c in zip(hints, caps)]
        return run

    src = tmp_path / "in"
    src.mkdir()
    for i in range(3):
        _recap_df().to_parquet(src / f"part{i}.parquet", index=False)
    assert recaption.split_manifest(str(src), 2) == \
        jrecap.split_manifest(str(src), 2)
    for name, mod in (("port", recaption), ("jax", jrecap)):
        done = mod.recaption_folder(
            str(src), str(tmp_path / name), flaky(mod), mod.stub_models()[1],
            batch_size=5, num_splits=2, split_idx=0, min_rows=5)
        assert done == ["part0.parquet", "part2.parquet"]
    _same_parquet_folders(str(tmp_path / "port"), str(tmp_path / "jax"))
    assert len(pd.read_parquet(tmp_path / "port" / "part0.parquet")) == 11


def test_recaption_cli_runs_the_stub_models(tmp_path):
    src = tmp_path / "in"
    src.mkdir()
    _recap_df().to_parquet(src / "part0.parquet", index=False)
    recaption.main(["--input_dir", str(src), "--output_dir",
                    str(tmp_path / "port"), "--batch_size", "4", "--stub"])
    jrecap.recaption_folder(str(src), str(tmp_path / "jax"),
                            *jrecap.stub_models(), batch_size=4)
    _same_parquet_folders(str(tmp_path / "port"), str(tmp_path / "jax"))
    with pytest.raises(RuntimeError, match="collapsed"):
        recaption.recaption_dataframe(
            _recap_df(), lambda ims, hs: ["x x x"] * len(ims),
            recaption.stub_models()[1])


def test_hf_models_default_to_the_card():
    import inspect
    assert inspect.signature(recaption.hf_models).parameters[
        "device"].default == "cuda"
    assert recaption.LONG_CAPTION_PROMPT == jrecap.LONG_CAPTION_PROMPT
    assert recaption.DISTILL_PROMPT == jrecap.DISTILL_PROMPT
    assert recaption.VLM_OPENINGS == jrecap.VLM_OPENINGS


# ---- upload_dataset ----------------------------------------------------------

def _upload_folder(d, sizes=(7, 5, 8)):
    d.mkdir(parents=True)
    base = 0
    for i, n in enumerate(sizes):
        pd.DataFrame({"x": range(base, base + n),
                      "image": [_png(base + k) for k in range(n)]}
                     ).to_parquet(d / f"part{i}.parquet", index=False)
        base += n
    return str(d)


@pytest.mark.parametrize("rows_per_shard", [6, 20, 50])
def test_upload_pushes_the_jax_packages_shards(tmp_path, monkeypatch,
                                               rows_per_shard):
    monkeypatch.setattr(upload_dataset.time, "sleep", lambda s: None)
    monkeypatch.setattr(jupload.time, "sleep", lambda s: None)
    pushed = {}
    for name, mod in (("port", upload_dataset), ("jax", jupload)):
        src = _upload_folder(tmp_path / name / "pq")
        assert mod.plan_shards(src, rows_per_shard) == [
            {**s, "parts": [(p.replace(os.sep + "port" + os.sep,
                                       os.sep + name + os.sep), a, b)
                            for p, a, b in s["parts"]]}
            for s in upload_dataset.plan_shards(
                str(tmp_path / "port" / "pq"), rows_per_shard)]
        fails = {"train-00000-of-00004.parquet": 1}
        got = pushed[name] = {}

        def push(local, shard):
            if fails.get(shard, 0):
                fails[shard] -= 1
                raise IOError("rate limited")
            got[shard] = pd.read_parquet(local)

        names = mod.upload_folder(src, push, rows_per_shard=rows_per_shard)
        assert names == list(got)
        assert mod.upload_folder(src, push, rows_per_shard) == names
        assert json.loads(open(os.path.join(src, mod.PROGRESS_FILE)).read()) \
            == {n: "pushed" for n in names}
    assert list(pushed["port"]) == list(pushed["jax"])
    for shard in pushed["port"]:
        assert_frame_equal(pushed["port"][shard], pushed["jax"][shard])
    rows = pd.concat(pushed["port"].values())["x"].tolist()
    assert rows == list(range(20))


def test_upload_gives_up_after_retries(tmp_path, monkeypatch):
    monkeypatch.setattr(upload_dataset.time, "sleep", lambda s: None)
    src = _upload_folder(tmp_path / "pq")

    def push(local, name):
        raise IOError("always down")

    with pytest.raises(RuntimeError, match="failed after retries"):
        upload_dataset.upload_folder(src, push, rows_per_shard=50,
                                     max_retries=1)
    assert not os.path.exists(os.path.join(src, upload_dataset.PROGRESS_FILE))
