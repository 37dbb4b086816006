"""sd3_torch's encoded feed (`data/encoded.py`) held to the JAX package's on
the CPU: with the same deterministic encoder double (each caption's id
threaded through `pooled`, zero latents of the bucket's shape, as
tests/test_encoded_pipeline.py's `_IdEncoders`), both packages emit the same
accumulation groups in the same order from the same loader stream, discard
no decoded batch, and give each bucket its latent shape. Also: the stub
encoders' shapes and signature, the ring path equal to the threaded one,
`prefetch_iterator` (order, errors, the worker thread, shutdown) and
`resolve_encoders`' refusals. Comparisons are exact.
"""

import io
import threading

import numpy as np
import pytest
import torch

from sd3_tpu.config import tiny_config as j_tiny_config
from sd3_tpu.data import encoded as jencoded
from sd3_tpu.training.trainer import TrainConfig as JTrainConfig

from sd3_torch.config import tiny_config
from sd3_torch.data import encoded
from sd3_torch.models.text_encoders import StubTextEncoders
from sd3_torch.training.trainer import TrainConfig

BUCKETS = ["16x16", "24x16", "16x24"]


class _IdEncoders:
    """Zero latents of the bucket's shape; each caption's trailing number
    as its pooled embedding. `numpy=True`: the JAX package's double."""
    latent_channels = 4

    def __init__(self, numpy=False):
        self.numpy = numpy
        self.device = None if numpy else torch.device("cpu")

    def vae_encode(self, images, rng=None):
        b, _, h, w = images.shape
        z = np.zeros((b, 4, h // 8, w // 8), np.float32)
        return z if self.numpy else torch.from_numpy(z)

    def text_to_embedding(self, captions):
        ids = np.array([[float(c.split()[-1])] for c in captions], np.float32)
        hid = np.zeros((len(captions), 2, 8), np.float32)
        return (hid, ids) if self.numpy else (torch.from_numpy(hid),
                                              torch.from_numpy(ids))


class _FakeLoader:
    """n batches round robin over BUCKETS, caption ids 0 .. n-1."""

    def __init__(self, n):
        self.i, self.n, self.closed = 0, n, False

    def __next__(self):
        i = self.i
        self.i += 1
        if i >= self.n:
            raise StopIteration
        h, w = map(int, BUCKETS[i % 3].split("x"))
        return {"image": np.zeros((2, 3, h, w), np.float32),
                "caption": [f"id {i}", f"id {i}"], "bucket": BUCKETS[i % 3]}

    def close(self):
        self.closed = True


def _groups(it):
    return [(g["x0"].shape, np.asarray(g["pooled"][:, :, 0]).tolist())
            for g in it]


@pytest.mark.parametrize("acc", [1, 2, 3])
def test_groups_equal_the_jax_packages_and_nothing_is_discarded(acc):
    n = 36   # 12 batches a bucket: whole groups at accumulation 1, 2, 3
    got = _groups(encoded.encoded_batch_iter(
        tiny_config(), TrainConfig(batch_size=2, accumulation_steps=acc),
        "", encoders=_IdEncoders(), loader=_FakeLoader(n), device="cpu"))
    want = _groups(jencoded.encoded_batch_iter(
        j_tiny_config(), JTrainConfig(batch_size=2, accumulation_steps=acc),
        "", encoders=_IdEncoders(numpy=True), loader=_FakeLoader(n)))
    assert [(tuple(s), i) for s, i in got] == [(tuple(s), i)
                                              for s, i in want]
    assert len(got) == n // acc
    ids = [i for _, g in got for row in g for i in row]
    assert sorted(set(ids)) == list(range(n))   # every batch in one group
    for shape, g in got:
        bucket = BUCKETS[int(g[0][0]) % 3]
        assert {BUCKETS[int(row[0]) % 3] for row in g} == {bucket}
        h, w = map(int, bucket.split("x"))
        assert tuple(shape) == (acc, 2, 4, h // 8, w // 8)


def test_an_injected_loader_is_left_open():
    loader = _FakeLoader(4)
    list(encoded.encoded_batch_iter(
        tiny_config(), TrainConfig(batch_size=2, accumulation_steps=1), "",
        encoders=_IdEncoders(), loader=loader, device="cpu"))
    assert not loader.closed


def _png(h, w, v):
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(np.full((h, w, 3), v, np.uint8)).save(buf, format="PNG")
    return buf.getvalue()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    import pyarrow as pa
    import pyarrow.parquet as pq
    d = tmp_path_factory.mktemp("encpq")
    k = 0
    for f, n in enumerate((16, 14)):
        rows = []
        for _ in range(n):
            h, w = map(int, BUCKETS[k % 3].split("x"))
            rows.append({"image": _png(h, w, 7 * (k % 30)),
                         "recaption": f"caption {k}",
                         "recaption_short": f"c {k}",
                         "bucket_size": f"{h}x{w}"})
            k += 1
        pq.write_table(pa.Table.from_pylist(rows), str(d / f"p{f}.parquet"))
    return str(d)


def test_folder_groups_equal_the_jax_packages(folder):
    tc, jtc = (TrainConfig(batch_size=2, accumulation_steps=2),
               JTrainConfig(batch_size=2, accumulation_steps=2))
    it = encoded.encoded_batch_iter(tiny_config(), tc, folder, seed=4,
                                    encoders=_IdEncoders(), num_threads=3,
                                    device="cpu")
    jit = jencoded.encoded_batch_iter(j_tiny_config(), jtc, folder, seed=4,
                                      encoders=_IdEncoders(numpy=True),
                                      num_threads=3)
    got = [next(it) for _ in range(6)]
    want = [next(jit) for _ in range(6)]
    it.close()
    assert _groups(got) == _groups(want)


def test_stub_groups_on_threads_and_ring_workers(folder):
    cfg = tiny_config(inCh=16)
    tc = TrainConfig(batch_size=2, accumulation_steps=2)
    enc = encoded.resolve_encoders(cfg, stub=True, device="cpu")
    streams = []
    for ring_workers in (0, 1):
        it = encoded.encoded_batch_iter(cfg, tc, folder, encoders=enc, seed=2,
                                        ring_workers=ring_workers,
                                        device="cpu")
        try:
            streams.append([next(it) for _ in range(4)])
        finally:
            it.close()
    for a, b in zip(*streams):
        assert a["x0"].dtype == torch.float32 and a["x0"].device.type == "cpu"
        acc, bs, ch, lh, lw = a["x0"].shape
        assert (acc, bs, ch) == (2, 2, 16) and f"{lh * 8}x{lw * 8}" in BUCKETS
        assert a["text"].shape == (2, 2, cfg.text_tokens, cfg.text_hidden_dim)
        assert a["pooled"].shape == (2, 2, cfg.class_dim)
        for k in a:
            assert torch.equal(a[k], b[k]), k


def test_stub_vae_encode_takes_the_suites_signature():
    enc = StubTextEncoders(device="cpu")
    img = torch.rand(1, 3, 16, 24) * 2 - 1
    a = enc.vae_encode(img)
    b = enc.vae_encode(img, torch.Generator().manual_seed(3))
    assert a.shape == (1, 16, 2, 3) and torch.equal(a, b)


def test_prefetch_iterator_order_errors_and_thread():
    assert list(encoded.prefetch_iterator(iter(range(7)), depth=2)) == \
        list(range(7))

    def boom():
        yield 1
        raise RuntimeError("decode failed")
    it = encoded.prefetch_iterator(boom(), depth=1)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="decode failed"):
        next(it)

    threads = []

    def tag(x):
        threads.append(threading.current_thread())
        return x * 10
    assert list(encoded.prefetch_iterator(iter(range(5)), depth=2,
                                          map_fn=tag)) == [0, 10, 20, 30, 40]
    assert threads and all(t is not threading.main_thread() for t in threads)

    def bad(_):
        raise ValueError("map failed")
    with pytest.raises(ValueError, match="map failed"):
        next(encoded.prefetch_iterator(iter(range(3)), depth=1, map_fn=bad))


def test_closing_the_prefetch_stops_its_thread_and_the_source():
    closed = threading.Event()

    def source():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.set()
    before = threading.active_count()
    it = encoded.prefetch_iterator(source(), depth=2)
    assert [next(it) for _ in range(3)] == [0, 1, 2]
    it.close()
    assert closed.wait(10.0)
    assert threading.active_count() == before


def test_resolve_encoders_is_explicit(tmp_path, monkeypatch):
    cfg = tiny_config()
    assert isinstance(encoded.resolve_encoders(cfg, stub=True, device="cpu"),
                      StubTextEncoders)
    with pytest.raises(RuntimeError, match="--encoder_weights"):
        encoded.resolve_encoders(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="not found"):
        encoded.resolve_encoders(cfg, weights_dir=str(tmp_path / "none"),
                                 device="cpu")
    # the environment variable the JAX package reads is not read here
    monkeypatch.setenv("SD3_ENCODER_WEIGHTS", str(tmp_path))
    with pytest.raises(RuntimeError, match="--encoder_weights"):
        encoded.resolve_encoders(cfg, device="cpu")
    calls = {}

    def fake_load(device="cuda", stub=False, weights_dir=None,
                  model_cfg=None):
        calls.update(stub=stub, weights_dir=weights_dir, device=device)
        return "suite"
    monkeypatch.setattr(encoded, "load_text_encoders", fake_load)
    assert encoded.resolve_encoders(cfg, weights_dir=str(tmp_path),
                                    device="cpu") == "suite"
    assert calls == {"stub": False, "weights_dir": str(tmp_path),
                     "device": "cpu"}
