"""sd3_torch's data feed (buckets, the parquet loader, captions, the
dataset-prep CLIs) held to the JAX package's on the same inputs, on the
CPU: every comparison is exact (the same numpy generators, the same
random.Random draws, the same PIL decode; the port reads parquet with
pyarrow where the JAX package goes through HF `datasets`). The fixtures are
tiny parquet folders written here with pyarrow and PIL: two files and three
buckets.
"""

import io
import itertools
import os
import random
import warnings

import numpy as np
import pytest

from sd3_tpu.data import buckets as jbuckets
from sd3_tpu.data import create_indices as jindices
from sd3_tpu.data import create_phase as jphase
from sd3_tpu.data import filter_dataset as jfilter
from sd3_tpu.data import pipeline as jpipe

from sd3_torch.data import buckets, create_indices, create_phase, \
    filter_dataset, pipeline

pa = pytest.importorskip("pyarrow")
pq = pytest.importorskip("pyarrow.parquet")

BUCKETS = ((16, 16), (16, 8), (8, 16))


def _png(h, w, seed, mode="RGB"):
    from PIL import Image
    r = np.random.default_rng(seed)
    arr = (r.random((h, w, 3)) * 255).astype(np.uint8)
    buf = io.BytesIO()
    Image.fromarray(arr).convert(mode).save(buf, format="PNG")
    return buf.getvalue()


def _write_folder(d, n_per_file=(14, 13), struct_images=False):
    """Two parquet files, rows cycling over BUCKETS, two captions each."""
    os.makedirs(d, exist_ok=True)
    k = 0
    for f, n in enumerate(n_per_file):
        rows = []
        for _ in range(n):
            h, w = BUCKETS[k % 3]
            img = _png(h, w, k)
            rows.append({
                "image": {"bytes": img, "path": None} if struct_images
                else img,
                "recaption": f"The image shows a long caption number {k}.",
                "recaption_short": f"short {k}",
                "bucket_size": f"{h}x{w}"})
            k += 1
        pq.write_table(pa.Table.from_pylist(rows), os.path.join(
            d, f"part{f}.parquet"))
    return str(d)


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return _write_folder(tmp_path_factory.mktemp("pq") / "data")


# ---- buckets ---------------------------------------------------------------

def test_bucket_index_files_cross_between_the_packages(tmp_path):
    sizes = ["16x16", "16x8", "16x16", "8x16", "16x16", "16x8"]
    ours, theirs = str(tmp_path / "t.npy"), str(tmp_path / "j.npy")
    want = {"16x16": [0, 2, 4], "16x8": [1, 5], "8x16": [3]}
    assert buckets.build_bucket_indices(sizes, ours) == want
    assert jbuckets.build_bucket_indices(sizes, theirs) == want
    assert jbuckets.load_bucket_indices(ours) == want
    assert buckets.load_bucket_indices(theirs) == want
    # an existing file is loaded, not rebuilt
    assert buckets.build_bucket_indices(["1x1"], theirs) == want


SAMPLER_CASES = [
    dict(seed=0), dict(seed=3, first_n_largest=2),
    dict(seed=1, bucket_seed=7), dict(seed=1, bucket_seed=7, shard_index=0,
                                      shard_count=2),
    dict(seed=2, bucket_seed=7, shard_index=1, shard_count=2)]


@pytest.mark.parametrize("kw", SAMPLER_CASES)
def test_bucket_sampler_draws_equal_the_jax_packages(kw):
    rows = {"16x16": list(range(100)), "24x16": list(range(100, 220)),
            "32x32": list(range(220, 400)), "8x8": [400, 401]}
    ours = buckets.RandomBucketSampler(rows, batch_size=4, **kw)
    theirs = jbuckets.RandomBucketSampler(rows, batch_size=4, **kw)
    assert [k for k, _ in ours.buckets] == [k for k, _ in theirs.buckets]
    np.testing.assert_array_equal(ours.probs, theirs.probs)
    assert ours.bucket_shapes() == theirs.bucket_shapes()
    assert list(itertools.islice(iter(ours), 60)) == list(
        itertools.islice(iter(theirs), 60))


def test_bucket_sampler_refusals():
    with pytest.raises(ValueError, match="shard"):
        buckets.RandomBucketSampler({"8x8": list(range(40))}, 4,
                                    shard_index=2, shard_count=2)
    with pytest.raises(ValueError, match="enough samples"):
        buckets.RandomBucketSampler({"8x8": [0, 1]}, 4)


# ---- captions and images -----------------------------------------------------

def test_captions_take_the_jax_packages_draws():
    caps = ["The image shows a red fox.", "In this artwork, a cat!",
            "A dog on a hill,", "this image depicts An owl?", "", "A ", "x"]
    rows = [{"recaption": " long ", "recaption_short": " short "},
            {"recaption": None, "recaption_short": " only short "},
            {"recaption": " only long ", "recaption_short": ""}, {}]
    a, b = random.Random(5), random.Random(5)
    for _ in range(40):
        for c in caps + [None]:
            assert pipeline.clean_caption(c, a) == jpipe.clean_caption(c, b)
        for r in rows:
            assert pipeline.pick_caption(r, a) == jpipe.pick_caption(r, b)
    assert a.random() == b.random()   # the same number of draws


@pytest.mark.parametrize("mode", ["RGB", "L", "RGBA", "P"])
def test_decode_image_equals_the_jax_packages(mode):
    img = _png(9, 7, 3, mode)
    got, want = pipeline.decode_image(img), jpipe.decode_image(img)
    assert got.dtype == np.float32 and got.shape == (3, 9, 7)
    np.testing.assert_array_equal(got, want)


# ---- the parquet dataset and the threaded loader -----------------------------

@pytest.mark.parametrize("struct_images", [False, True])
def test_rows_are_numbered_as_the_jax_package_numbers_them(tmp_path,
                                                           struct_images):
    d = _write_folder(tmp_path / "d", struct_images=struct_images)
    ours, theirs = (pipeline.ParquetImageText(d),
                    jpipe.ParquetImageText(d))
    assert len(ours) == len(theirs) == 27
    assert ours.buckets == theirs.buckets
    idx = [26, 0, 13, 14, 5]
    for a, b in zip(ours.rows(idx), theirs.rows(idx)):
        for k in ("recaption", "recaption_short", "bucket_size"):
            assert a[k] == b[k]
        assert pipeline.image_bytes(a["image"]) == (
            b["image"]["bytes"] if isinstance(b["image"], dict)
            else b["image"])


def _stream(mod, folder, n, **kw):
    loader = mod.HostDataLoader(mod.ParquetImageText(folder), batch_size=4,
                                seed=3, prefetch=4, **kw)
    try:
        return [next(loader) for _ in range(n)]
    finally:
        loader.close()


def _assert_same_batches(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g["bucket"] == w["bucket"] and g["seq"] == w["seq"]
        assert g["caption"] == w["caption"]
        np.testing.assert_array_equal(g["image"], w["image"])


@pytest.mark.parametrize("kw", [
    dict(num_threads=1), dict(num_threads=3, bucket_seed=11),
    dict(num_threads=1, stride=2, stride_offset=0),
    dict(num_threads=2, stride=2, stride_offset=1, clean_captions=True)])
def test_host_loader_streams_equal_the_jax_packages(folder, kw):
    _assert_same_batches(_stream(pipeline, folder, 6, **kw),
                         _stream(jpipe, folder, 6, **kw))


def test_strided_loaders_together_give_the_one_loader_stream(folder):
    one = _stream(pipeline, folder, 6, num_threads=2)
    even = _stream(pipeline, folder, 3, num_threads=1, stride=2,
                   stride_offset=0)
    odd = _stream(pipeline, folder, 3, num_threads=1, stride=2,
                  stride_offset=1)
    merged = sorted(even + odd, key=lambda b: b["seq"])
    _assert_same_batches(merged, one)
    h, w = (int(s) for s in one[0]["bucket"].split("x"))
    assert one[0]["image"].shape == (4, 3, h, w)


def test_host_loader_raises_a_decode_error_and_closes(tmp_path):
    d = tmp_path / "bad"
    d.mkdir()
    rows = [{"image": b"not an image", "recaption": "caption text",
             "recaption_short": "c", "bucket_size": "8x8"}] * 8
    pq.write_table(pa.Table.from_pylist(rows), str(d / "p.parquet"))
    loader = pipeline.HostDataLoader(pipeline.ParquetImageText(str(d)), 4,
                                     num_threads=2)
    try:
        with pytest.raises(OSError):
            next(loader)
    finally:
        loader.close(timeout=10.0)
    assert not any(t.is_alive() for t in loader._threads)


def test_loader_refusals(tmp_path):
    d = tmp_path / "nob"
    d.mkdir()
    pq.write_table(pa.Table.from_pylist([{"image": b"x"}]),
                   str(d / "p.parquet"))
    with pytest.raises(ValueError, match="bucket_size"):
        pipeline.HostDataLoader(pipeline.ParquetImageText(str(d)), 1)
    with pytest.raises(FileNotFoundError):
        pipeline.ParquetImageText(str(tmp_path / "empty"))


# ---- the memory-mapped reader ------------------------------------------------

def _write_row_groups(d, n_per_file=(14, 13), row_group_size=4):
    """_write_folder's rows, each file in row groups of `row_group_size`."""
    src = _write_folder(d / "src", n_per_file)
    os.makedirs(d / "rg")
    for name in sorted(os.listdir(src)):
        pq.write_table(pq.read_table(os.path.join(src, name)),
                       str(d / "rg" / name), row_group_size=row_group_size)
    return str(d / "rg")


def _group_bytes(d):
    """The Arrow bytes of each row group of the folder's files."""
    return [pq.ParquetFile(f).read_row_group(g).nbytes
            for f in pipeline.parquet_files(d)
            for g in range(pq.ParquetFile(f).metadata.num_row_groups)]


@pytest.mark.parametrize("row_group_size,groups_cached",
                         [(4, 0), (5, 1), (5, 2), (64, 4)])
def test_mmap_rows_equal_the_eager_readers_across_boundaries(
        tmp_path, row_group_size, groups_cached):
    d = _write_row_groups(tmp_path, row_group_size=row_group_size)
    ds = pipeline.ParquetImageText(d)
    ds.cache_bytes = sum(sorted(_group_bytes(d))[::-1][:groups_cached])
    eager = pa.concat_tables([pq.read_table(f)
                              for f in pipeline.parquet_files(d)])
    assert len(ds) == eager.num_rows == 27
    assert len(ds._groups) == sum(-(-n // row_group_size) for n in (14, 13))
    # rows on either side of every row-group and file boundary, repeated,
    # out of order, and the whole folder backwards
    idx = [3, 4, 13, 14, 26, 0, 15, 12, 4, 9, 26]
    assert ds.rows(idx) == eager.take(idx).to_pylist()
    every = list(range(26, -1, -1))
    assert ds.rows(every) == eager.take(every).to_pylist()
    assert sum(t.nbytes for t in ds._cache.values()) <= ds.cache_bytes
    assert len(ds._cache) <= groups_cached
    assert ds.rows([]) == []
    with pytest.raises(IndexError):
        ds.rows([27])
    want = jpipe.ParquetImageText(d)
    assert ds.buckets == want.buckets
    for a, b in zip(ds.rows(idx), want.rows(idx)):
        assert a["recaption"] == b["recaption"]
        assert a["image"] == b["image"]


def test_mmap_reader_opens_with_the_bucket_column_alone(tmp_path,
                                                        monkeypatch):
    d = _write_row_groups(tmp_path)
    reads = []
    for name in ("read", "read_row_group", "read_row_groups", "iter_batches"):
        real = getattr(pq.ParquetFile, name)

        def spy(self, *a, _real=real, _name=name, **kw):
            reads.append((_name, kw.get("columns")))
            return _real(self, *a, **kw)
        monkeypatch.setattr(pq.ParquetFile, name, spy)
    monkeypatch.setattr(pq, "read_table", lambda *a, **k: pytest.fail(
        "the reader read a whole table"))
    ds = pipeline.ParquetImageText(d)
    assert reads == [("read", ["bucket_size"])] * 2
    assert sorted(ds.buckets) == ["16x16", "16x8", "8x16"]
    reads.clear()
    ds.rows([1, 2])  # one row group, decoded whole, then cached
    ds.rows([0, 3])
    assert reads == [("read_row_group", None)]


def test_mmap_reader_serves_threads_and_the_loader(folder):
    import concurrent.futures as cf
    ds = pipeline.ParquetImageText(folder)
    ds.cache_bytes = max(_group_bytes(folder))
    eager = pa.concat_tables([pq.read_table(f)
                              for f in pipeline.parquet_files(folder)])
    picks = [list(np.random.default_rng(s).integers(0, 27, 6))
             for s in range(24)]
    with cf.ThreadPoolExecutor(4) as ex:
        got = list(ex.map(ds.rows, picks))
    assert got == [eager.take(p).to_pylist() for p in picks]
    _assert_same_batches(_stream(pipeline, folder, 4, num_threads=3),
                         _stream(jpipe, folder, 4, num_threads=1))


def test_mmap_reader_decodes_outside_its_lock_on_per_thread_files(
        tmp_path, monkeypatch):
    """A thread decoding a row group holds up no other thread's rows, and
    each thread reads through file handles of its own."""
    import threading
    d = _write_row_groups(tmp_path)
    ds = pipeline.ParquetImageText(d)
    release, entered = threading.Event(), threading.Event()
    handles = {}
    real = pq.ParquetFile.read_row_group

    def slow(self, i, *a, **kw):
        handles.setdefault(threading.get_ident(), set()).add(id(self))
        if i == 1 and not release.is_set():
            entered.set()
            assert release.wait(10)
        return real(self, i, *a, **kw)
    monkeypatch.setattr(pq.ParquetFile, "read_row_group", slow)
    got = {}
    t = threading.Thread(target=lambda: got.setdefault("a", ds.rows([5])))
    t.start()
    assert entered.wait(10)
    assert ds.rows([0, 9]) == ds.rows([0, 9])  # groups 0 and 2, unblocked
    release.set()
    t.join(10)
    eager = pa.concat_tables([pq.read_table(f)
                              for f in pipeline.parquet_files(d)])
    assert got["a"] == eager.take([5]).to_pylist()
    assert len(handles) == 2
    a, b = handles.values()
    assert not a & b


@pytest.mark.parametrize("nbytes", [1 << 10, 1 << 12])
def test_write_parquet_bounds_the_row_groups_it_writes(tmp_path, monkeypatch,
                                                       nbytes):
    """Row groups of about ROW_GROUP_BYTES whatever the writer (pyarrow's
    own default is one group of up to 1Mi rows), a DataFrame as pandas'
    to_parquet converts it, and the same rows for the reader."""
    import pandas as pd
    monkeypatch.setattr(pipeline, "ROW_GROUP_BYTES", nbytes)
    src = _write_folder(tmp_path / "src")
    table = pa.concat_tables([pq.read_table(f)
                              for f in pipeline.parquet_files(src)])
    rows = pipeline.row_group_rows(table)
    assert rows == max(1, nbytes * 27 // table.nbytes)
    os.makedirs(tmp_path / "out")
    out = str(tmp_path / "out" / "t.parquet")
    pipeline.write_parquet(table, out)
    meta = pq.ParquetFile(out).metadata
    assert meta.num_row_groups == -(-27 // rows) > 1
    assert max(_group_bytes(str(tmp_path / "out"))) <= 2 * nbytes
    assert pq.read_table(out).equals(table)
    df = table.to_pandas()
    for index in (False, None):
        pipeline.write_parquet(df, out, preserve_index=index)
        ref = str(tmp_path / "ref.parquet")
        df.to_parquet(ref, index=index)
        assert pq.read_table(out).equals(pq.read_table(ref))
        assert pq.ParquetFile(out).metadata.num_row_groups > 1
    ds = pipeline.ParquetImageText(str(tmp_path / "out"))
    assert ds.rows(list(range(27))) == table.to_pylist()


def test_mmap_reader_takes_no_column_whole(tmp_path, monkeypatch):
    """Rows come from a slice of their row group, never from `take`, which
    concatenates a column's chunks: past 2 GiB of image bytes that
    overflows binary offsets (the in-memory reader it replaced refused
    such a folder on its first batch)."""
    d = _write_row_groups(tmp_path)
    ds = pipeline.ParquetImageText(d)
    eager = pa.concat_tables([pq.read_table(f)
                              for f in pipeline.parquet_files(d)])
    want = eager.take([26, 0, 13, 5]).to_pylist()
    import pyarrow.compute as pc
    monkeypatch.setattr(pc, "take", lambda *a, **k: pytest.fail(
        "the reader called take"))
    with pytest.raises(pytest.fail.Exception):  # the spy sees Table.take
        eager.take([0])
    assert ds.rows([26, 0, 13, 5]) == want


def test_mmap_reader_warns_of_large_row_groups(tmp_path, monkeypatch):
    d = _write_row_groups(tmp_path, row_group_size=64)  # a group a file
    big = max(pq.ParquetFile(f).metadata.row_group(0).total_byte_size
              for f in pipeline.parquet_files(d))
    monkeypatch.setattr(pipeline, "ROW_GROUP_BYTES", 1 << 10)
    monkeypatch.setattr(pipeline, "LARGE_ROW_GROUP", big // 1024 - 1)
    with pytest.warns(UserWarning, match="decodes its whole group"):
        pipeline.ParquetImageText(d)
    monkeypatch.setattr(pipeline, "LARGE_ROW_GROUP", big // 1024 + 1)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        pipeline.ParquetImageText(d)


def test_prep_clis_write_bounded_row_groups(tmp_path, monkeypatch):
    """filter_dataset and create_phase write through write_parquet: their
    files hold several row groups at a small ROW_GROUP_BYTES, and the same
    tables as the JAX package's."""
    monkeypatch.setattr(pipeline, "ROW_GROUP_BYTES", 1 << 12)
    raw = _raw(tmp_path / "raw")
    out = {}
    for name, (filt, phase) in (("t", (filter_dataset, create_phase)),
                                ("j", (jfilter, jphase))):
        f, p = str(tmp_path / f"{name}_filt"), str(tmp_path / f"{name}_phase")
        filt.main(["--input_dir", raw, "--output_dir", f])
        phase.main(["--input_dir", f, "--output_dir", p,
                    "--max_resolution", "256"])
        out[name] = (f, p)
    for (got, want) in zip(out["t"], out["j"]):
        _assert_tables_equal(_tables(got), _tables(want))
        for f in pipeline.parquet_files(got):
            assert pq.ParquetFile(f).metadata.num_row_groups > 1, f


# ---- the dataset-prep CLIs -----------------------------------------------------

def _raw(d):
    """A raw folder in two files: rows the filter keeps (three aspect
    families), low-resolution rows, a short caption, a broken image."""
    d.mkdir()
    fam = ((300, 300), (250, 400), (400, 250))
    for f in range(2):
        rows = []
        for i in range(6):
            h, w = fam[(i + f) % 3]
            rows.append({"image": {"bytes": _png(h + i, w + i, 10 * f + i),
                                   "path": None},
                         "recaption": f"a nice long caption {f}-{i}",
                         "recaption_short": f"short {f}-{i}"})
        rows.append({"image": {"bytes": _png(100, 90, 7), "path": None},
                     "recaption": "low resolution, filtered out",
                     "recaption_short": "s"})
        rows.append({"image": {"bytes": _png(640, 480, 8), "path": None},
                     "recaption": "x", "recaption_short": ""})
        rows.append({"image": {"bytes": b"notanimage", "path": None},
                     "recaption": "a broken image row",
                     "recaption_short": "s5"})
        pq.write_table(pa.Table.from_pylist(rows), str(d / f"p{f}.parquet"))
    return str(d)


def _tables(folder):
    return {f: pq.read_table(os.path.join(folder, f))
            for f in sorted(os.listdir(folder))}


def _assert_tables_equal(got, want):
    assert list(got) == list(want)
    for f in got:
        assert got[f].column_names == want[f].column_names, f
        assert got[f].to_pylist() == want[f].to_pylist(), f


def test_prep_clis_write_the_jax_packages_tables(tmp_path, capsys):
    raw = _raw(tmp_path / "raw")
    out = {}
    for name, (filt, phase, idx) in (
            ("t", (filter_dataset, create_phase, create_indices)),
            ("j", (jfilter, jphase, jindices))):
        f, p = str(tmp_path / f"{name}_filt"), str(tmp_path / f"{name}_phase")
        i = str(tmp_path / f"{name}_idx.npy")
        filt.main(["--input_dir", raw, "--output_dir", f,
                   "--min_resolution", "256", "--min_caption_chars", "8"])
        phase.main(["--input_dir", f, "--output_dir", p,
                    "--max_resolution", "256"])
        idx.main(["--data_parquet_folder", p, "--bucket_indices_path", i])
        out[name] = (_tables(f), _tables(p), np.load(
            i, allow_pickle=True).item())
    for got, want in zip(out["t"][:2], out["j"][:2]):
        _assert_tables_equal(got, want)
    assert out["t"][2] == out["j"][2]
    filt_rows = sum(t.num_rows for t in out["t"][0].values())
    assert filt_rows == 12   # low-res, short-caption and broken rows gone
    assert set(out["t"][2]) == {"256x256", "160x256", "256x160"}
    for t in out["t"][1].values():
        for h, w, b in zip(*(t.column(c).to_pylist()
                             for c in ("height", "width", "bucket_size"))):
            assert b == f"{h}x{w}" and h % 16 == 0 and w % 16 == 0
            assert max(h, w) <= 256


def test_prep_clis_resume_and_phase_rules(tmp_path):
    raw = _raw(tmp_path / "raw")
    filt = str(tmp_path / "filt")
    filter_dataset.main(["--input_dir", raw, "--output_dir", filt])
    stamp = {f: os.path.getmtime(os.path.join(filt, f))
             for f in os.listdir(filt)}
    os.remove(os.path.join(filt, "p1.parquet"))
    filter_dataset.main(["--input_dir", raw, "--output_dir", filt])
    # the file that was there is skipped, the missing one written again
    assert os.path.getmtime(os.path.join(filt, "p0.parquet")) == \
        stamp["p0.parquet"]
    assert os.path.exists(os.path.join(filt, "p1.parquet"))
    for x in range(1, 80):
        assert create_phase.nearest_multiple(x, 16) == \
            jphase.nearest_multiple(x, 16)
    for w, h in itertools.product((90, 255, 300, 900, 2100), repeat=2):
        assert create_phase.phase_size(w, h, 1024) == \
            jphase.phase_size(w, h, 1024)
        assert create_phase.phase_size(w, h, 256) == \
            jphase.phase_size(w, h, 256)
