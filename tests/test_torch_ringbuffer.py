"""sd3_torch's shared-memory ring (`native/ringbuffer.cpp`, built with g++
into sd3_torch/_build/) and its multi-process loader, on the CPU: the
packed bytes are the JAX package's in both directions; FIFO order, close,
oversized records refused, several producer processes without loss or
reordering, backpressure across processes, names unique per process and
unlinked; a 2-worker `RingDataLoader` emits exactly `HostDataLoader`'s
stream, and a worker's failure is raised, not waited on. Every wait has a
deadline.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from sd3_tpu.data import ringbuffer as jring

from sd3_torch.data import ringbuffer as rb
from sd3_torch.data.pipeline import HostDataLoader, ParquetImageText

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 60.0


def _pop(ring, deadline_s=DEADLINE_S):
    """ring.pop_batch() once a record is there, or fail at the deadline."""
    end = time.time() + deadline_s
    while ring.peek() < 0:
        assert time.time() < end, "no record arrived before the deadline"
        time.sleep(0.001)
    return ring.pop_batch()


def test_packed_bytes_equal_the_jax_packages_both_ways():
    b = {"image": np.arange(24, dtype=np.float32).reshape(2, 3, 4),
         "caption": ["a", "b"], "bucket": "8x8", "seq": 3,
         "ids": np.array([1, 2, 3], np.int64)}
    data = rb.pack_batch(b)
    assert data == jring.pack_batch(b)
    for got in (rb.unpack_batch(data), jring.unpack_batch(data),
                rb.unpack_batch(bytearray(data))):
        np.testing.assert_array_equal(got["image"], b["image"])
        np.testing.assert_array_equal(got["ids"], b["ids"])
        assert got["image"].dtype == np.float32
        assert (got["caption"], got["bucket"], got["seq"]) == (
            ["a", "b"], "8x8", 3)


def test_library_builds_into_the_port_build_dir():
    path = rb.build_library()
    assert os.path.dirname(path) == str(rb.BUILD_DIR)
    assert os.path.basename(path).startswith("libsd3ring-")
    assert rb.build_library() == path   # built once


def test_ring_fifo_close_and_unlink():
    ring = rb.Ring.create(rb.unique_name(), 1 << 16, 4)
    shm = "/dev/shm" + ring.name
    try:
        for i in range(4):
            ring.push_batch({"x": np.full((8,), i, np.int32)})
        assert len(ring) == 4
        reader = rb.Ring.open(ring.name)
        assert [int(reader.pop_batch()["x"][0]) for _ in range(4)] == \
            [0, 1, 2, 3]
        ring.close()
        assert ring.pop_batch() is None
        with pytest.raises(BrokenPipeError):
            ring.push(b"y")
    finally:
        ring.unlink()
    if os.path.isdir("/dev/shm"):
        assert not os.path.exists(shm)
    ring.unlink()   # a second unlink does nothing


def test_ring_refuses_oversized_records_and_bad_names():
    ring = rb.Ring.create(rb.unique_name(), 64, 2)
    try:
        with pytest.raises(ValueError, match="exceeds slot size"):
            ring.push(b"x" * 100)
    finally:
        ring.unlink()
    with pytest.raises(OSError):
        rb.Ring.open(rb.unique_name())
    names = {rb.unique_name() for _ in range(100)}
    assert len(names) == 100 and all(f"_{os.getpid()}_" in n for n in names)


PRODUCER = r"""
import sys, numpy as np
from sd3_torch.data.ringbuffer import Ring
ring = Ring.open(sys.argv[1])
wid, n, size = int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4])
for i in range(n):
    ring.push_batch({"v": np.full((size,), wid * 1000 + i, np.int64)})
print("PRODUCED")
"""


def _producers(name, n_workers, n, size):
    return [subprocess.Popen(
        [sys.executable, "-c", PRODUCER, name, str(w), str(n), str(size)],
        cwd=REPO, stdout=subprocess.PIPE, text=True)
        for w in range(n_workers)]


def _finish(procs):
    for p in procs:
        out, _ = p.communicate(timeout=DEADLINE_S)
        assert p.returncode == 0 and "PRODUCED" in out


def test_several_producers_lose_and_reorder_nothing():
    # a tiny ring: heavy contention on the claim protocol
    ring = rb.Ring.create(rb.unique_name(), 1 << 12, 4)
    procs = _producers(ring.name, 3, 50, 1)
    try:
        got = [int(_pop(ring)["v"][0]) for _ in range(150)]
        _finish(procs)
    finally:
        ring.close()
        for p in procs:
            p.kill()
            p.wait(timeout=DEADLINE_S)
        ring.unlink()
    for w in range(3):
        assert [v % 1000 for v in got if v // 1000 == w] == list(range(50))


def test_a_slow_consumer_holds_the_producer_back():
    # 2 slots of ~8 KB records: the producer blocks until records are taken
    ring = rb.Ring.create(rb.unique_name(), 1 << 13, 2)
    procs = _producers(ring.name, 1, 20, 1000)
    try:
        end = time.time() + DEADLINE_S
        while len(ring) < 2:
            assert time.time() < end, "the producer pushed nothing"
            time.sleep(0.01)
        time.sleep(0.3)   # a producer not held back would push on
        assert len(ring) == 2 and procs[0].poll() is None
        got = [int(_pop(ring)["v"][0]) for _ in range(20)]
        _finish(procs)
    finally:
        ring.close()
        ring.unlink()
    assert got == list(range(20))


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    import io
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image
    d = tmp_path_factory.mktemp("ringpq")
    k = 0
    for f, n in enumerate((13, 12)):
        rows = []
        for _ in range(n):
            h, w = ((16, 16), (16, 8), (8, 16))[k % 3]
            arr = (np.random.default_rng(k).random((h, w, 3)) * 255
                   ).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(arr).save(buf, format="PNG")
            rows.append({"image": buf.getvalue(), "recaption": f"caption {k}",
                         "recaption_short": f"c{k}", "bucket_size": f"{h}x{w}"})
            k += 1
        pq.write_table(pa.Table.from_pylist(rows), str(d / f"p{f}.parquet"))
    return str(d)


@pytest.mark.parametrize("workers", [1, 2])
def test_ring_loader_emits_the_host_loaders_stream(folder, workers):
    host = HostDataLoader(ParquetImageText(folder), batch_size=4, seed=9,
                          num_threads=1, bucket_seed=21)
    ring = rb.RingDataLoader(folder, batch_size=4, num_workers=workers,
                             slot_mb=1, num_slots=4, seed=9, bucket_seed=21)
    try:
        for _ in range(7):
            want, got = next(host), next(ring)
            assert want["bucket"] == got["bucket"]
            assert want["caption"] == got["caption"]
            np.testing.assert_array_equal(want["image"], got["image"])
            assert got["image"].flags.writeable
    finally:
        host.close()
        ring.close()
    assert all(p.poll() is not None for p in ring._procs)
    if os.path.isdir("/dev/shm"):
        assert not os.path.exists("/dev/shm" + ring.ring.name)


def test_ring_loader_raises_when_a_worker_fails(tmp_path):
    ring = rb.RingDataLoader(str(tmp_path / "missing"), batch_size=2,
                             num_workers=2, slot_mb=1, num_slots=2)
    try:
        with pytest.raises(RuntimeError, match="exited with code"):
            next(ring)
    finally:
        ring.close()
