"""ctypes binding for the shared-memory ring buffer (`native/ringbuffer.cpp`,
the port's copy of sd3_tpu/native/ringbuffer.cpp) and a multi-process
loader on it (the port's copy of sd3_tpu/data/ringbuffer.py).

Decode and collate run in separate OS processes that push packed batches
into shared memory, blocking when the trainer falls behind (backpressure);
the trainer pops them (reference VAE_T5_CLIP.py:65-84, 399-478, its loader
GPUs' NCCL stream with per-consumer sender processes).

The library is built with g++ at first use into `sd3_torch/_build/`
(`libsd3ring-<hash>.so`, keyed by the source and the flags); a failed build
raises. Batches are packed as a JSON header with a 4-byte length prefix,
then the arrays' bytes (`pack_batch` / `unpack_batch`, the same bytes as
the JAX package's).
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import shutil
import struct
import subprocess
import sys
import tempfile
import threading
import time
import uuid
import weakref
from typing import Mapping

import numpy as np

from sd3_torch.kernels import BUILD_DIR, PKG_DIR

SOURCE = PKG_DIR / "native" / "ringbuffer.cpp"
CXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-shared")


def library_path():
    """The built library of SOURCE under the current flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libsd3ring-{h.hexdigest()[:16]}.so"


def build_library() -> str:
    """Compile SOURCE with g++ unless its library exists; returns
    the library's path. Raises RuntimeError with the compiler's output."""
    path = library_path()
    if path.exists():
        return str(path)
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("no g++ on PATH to build the ring buffer's "
                           "library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, str(SOURCE), "-o", tmp, "-lrt"],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"building {SOURCE.name} failed:\n{proc.stdout}"
                           f"{proc.stderr}")
    os.replace(tmp, path)  # atomic: no half-written library
    return str(path)


def _load_lib():
    lib = ctypes.CDLL(build_library())
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint64]
    lib.ring_open.restype = ctypes.c_void_p
    lib.ring_open.argtypes = [ctypes.c_char_p]
    lib.ring_slot_size.restype = ctypes.c_uint64
    lib.ring_slot_size.argtypes = [ctypes.c_void_p]
    lib.ring_push.restype = ctypes.c_int
    lib.ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                              ctypes.c_uint64]
    lib.ring_pop.restype = ctypes.c_int64
    lib.ring_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                             ctypes.c_uint64]
    lib.ring_peek.restype = ctypes.c_int64
    lib.ring_peek.argtypes = [ctypes.c_void_p]
    lib.ring_size.restype = ctypes.c_uint64
    lib.ring_size.argtypes = [ctypes.c_void_p]
    lib.ring_close.restype = None
    lib.ring_close.argtypes = [ctypes.c_void_p]
    lib.ring_unlink.restype = None
    lib.ring_unlink.argtypes = [ctypes.c_char_p]
    return lib


_LIB = []
_LIB_LOCK = threading.Lock()


def get_lib():
    """The loaded library (built at the first call)."""
    with _LIB_LOCK:
        if not _LIB:
            _LIB.append(_load_lib())
        return _LIB[0]


# ---- batch (de)serialization ------------------------------------------------

def pack_batch(batch: Mapping) -> bytes:
    """dict of numpy arrays / JSON values -> bytes."""
    header = {}
    blobs = []
    offset = 0
    for key, val in batch.items():
        if isinstance(val, np.ndarray):
            b = np.ascontiguousarray(val).tobytes()
            header[key] = {"kind": "array", "dtype": str(val.dtype),
                           "shape": list(val.shape), "offset": offset,
                           "nbytes": len(b)}
            blobs.append(b)
            offset += len(b)
        else:
            header[key] = {"kind": "json", "value": val}
    hb = json.dumps(header).encode()
    return struct.pack("<I", len(hb)) + hb + b"".join(blobs)


def unpack_batch(data) -> dict:
    """bytes (or a writable buffer) -> dict; arrays are views of `data`."""
    hlen = struct.unpack_from("<I", data, 0)[0]
    header = json.loads(bytes(data[4:4 + hlen]).decode())
    base = 4 + hlen
    out = {}
    for key, meta in header.items():
        if meta["kind"] == "array":
            arr = np.frombuffer(data, dtype=np.dtype(meta["dtype"]),
                                count=int(np.prod(meta["shape"])),
                                offset=base + meta["offset"])
            out[key] = arr.reshape(meta["shape"])
        else:
            out[key] = meta["value"]
    return out


# ---- the ring ----------------------------------------------------------------

def unique_name() -> str:
    """A shared-memory name no other process or ring uses."""
    return f"/sd3ring_{os.getpid()}_{uuid.uuid4().hex[:12]}"


def _unlink(name: str):
    get_lib().ring_unlink(name.encode())


class Ring:
    """One POSIX shared-memory ring: many producers, one consumer. The
    creating side owns the name and unlinks it (`unlink`, or at garbage
    collection or exit)."""

    def __init__(self, handle, name: str, owner: bool):
        self._h = handle
        self.name = name
        self._unlinker = weakref.finalize(self, _unlink, name) if owner \
            else None

    @classmethod
    def create(cls, name: str, slot_bytes: int, num_slots: int) -> "Ring":
        h = get_lib().ring_create(name.encode(), slot_bytes, num_slots)
        if not h:
            raise OSError(f"ring_create({name}) failed")
        return cls(h, name, owner=True)

    @classmethod
    def open(cls, name: str) -> "Ring":
        h = get_lib().ring_open(name.encode())
        if not h:
            raise OSError(f"ring_open({name}) failed")
        return cls(h, name, owner=False)

    def push(self, data: bytes):
        rc = get_lib().ring_push(self._h, data, len(data))
        if rc == -1:
            raise BrokenPipeError("ring closed")
        if rc == -2:
            raise ValueError(f"record {len(data)}B exceeds slot size")

    def peek(self) -> int:
        """The length of the next record, -1 if there is none yet."""
        return int(get_lib().ring_peek(self._h))

    def pop(self) -> bytearray | None:
        """Blocking; None when closed and drained."""
        n = get_lib().ring_peek(self._h)
        cap = n if n >= 0 else get_lib().ring_slot_size(self._h)
        buf = bytearray(cap)
        got = get_lib().ring_pop(
            self._h, (ctypes.c_char * cap).from_buffer(buf), cap)
        if got == -1:
            return None
        if got < 0:
            raise RuntimeError(f"ring_pop returned {got}")
        return buf if got == cap else buf[:got]

    def push_batch(self, batch: Mapping):
        self.push(pack_batch(batch))

    def pop_batch(self) -> dict | None:
        data = self.pop()
        return None if data is None else unpack_batch(data)

    def __len__(self):
        return int(get_lib().ring_size(self._h))

    def close(self):
        get_lib().ring_close(self._h)

    def unlink(self):
        if self._unlinker is not None:
            self._unlinker()


# ---- the multi-process loader -------------------------------------------------

def worker_main(cfg: dict):
    """A loader process: the one sampler stream (the same seeds in every
    worker), decoding only its stride residue into the ring; the parent
    reorders by sequence. Exits when the ring closes or its parent dies."""
    from sd3_torch.data.pipeline import HostDataLoader, ParquetImageText

    parent = os.getppid()

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(0)
    threading.Thread(target=watch, daemon=True).start()
    ds = ParquetImageText(cfg["parquet_folder"],
                          cfg.get("bucket_indices_path"))
    loader = HostDataLoader(ds, batch_size=cfg["batch_size"],
                            seed=cfg["seed"], num_threads=1,
                            first_n_largest=cfg.get("first_n_largest", 1),
                            bucket_seed=cfg.get("bucket_seed"),
                            shard_index=cfg.get("shard_index", 0),
                            shard_count=cfg.get("shard_count", 1),
                            stride=cfg.get("stride", 1),
                            stride_offset=cfg.get("stride_offset", 0))
    ring = Ring.open(cfg["ring_name"])
    try:
        for batch in loader:
            ring.push_batch({"image": batch["image"],
                             "caption": batch["caption"],
                             "bucket": batch["bucket"],
                             "seq": batch["seq"]})
    except BrokenPipeError:
        pass
    finally:
        loader.close()


_WORKER = ("import json, sys; from sd3_torch.data.ringbuffer import "
           "worker_main; worker_main(json.loads(sys.argv[1]))")


class RingDataLoader:
    """Loader processes -> shared-memory ring -> this iterator.

    `num_workers` fresh processes (no CUDA: they see no device) decode the
    sampler's draws by stride; emission is strictly in the sampler's order
    (each batch carries its sequence number, pops are reordered here), so
    the stream equals `HostDataLoader`'s for the same seeds, and a shared
    `bucket_seed` with `shard_index` / `shard_count` keeps the multi-host
    contract. A worker that exits with an error raises here; `close()`
    stops the workers and unlinks the ring."""

    def __init__(self, parquet_folder: str, batch_size: int,
                 num_workers: int = 1, slot_mb: int = 64, num_slots: int = 8,
                 seed: int = 0, bucket_indices_path: str | None = None,
                 bucket_seed: int | None = None,
                 shard_index: int = 0, shard_count: int = 1):
        if num_workers < 1:
            raise ValueError(f"num_workers {num_workers}")
        self.ring = Ring.create(unique_name(), slot_mb * 1024 * 1024,
                                num_slots)
        self._reorder: dict[int, dict] = {}
        self._emit = 0
        self._procs = []
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
        root = str(PKG_DIR.parent)
        env["PYTHONPATH"] = os.pathsep.join(
            [root] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        for w in range(num_workers):
            cfg = {"parquet_folder": parquet_folder,
                   "bucket_indices_path": bucket_indices_path,
                   "batch_size": batch_size, "seed": seed,
                   "ring_name": self.ring.name,
                   "bucket_seed": bucket_seed,
                   "shard_index": shard_index, "shard_count": shard_count,
                   "stride": num_workers, "stride_offset": w}
            self._procs.append(subprocess.Popen(
                [sys.executable, "-c", _WORKER, json.dumps(cfg)], env=env,
                cwd=root))

    def __iter__(self):
        return self

    def _pop(self) -> dict | None:
        """The next record, polling the workers while the ring is empty."""
        while self.ring.peek() < 0:
            for p in self._procs:
                rc = p.poll()
                if rc not in (None, 0):
                    raise RuntimeError(f"ring loader worker {p.pid} exited "
                                       f"with code {rc}")
            if all(p.poll() is not None for p in self._procs) \
                    and self.ring.peek() < 0:
                return None
            time.sleep(0.0005)
        return self.ring.pop_batch()

    def __next__(self):
        while self._emit not in self._reorder:
            batch = self._pop()
            if batch is None:
                raise StopIteration
            self._reorder[batch.pop("seq")] = batch
        out = self._reorder.pop(self._emit)
        self._emit += 1
        return out

    def close(self, timeout: float = 10.0):
        """Close the ring, stop the workers, unlink the ring."""
        self.ring.close()
        for p in self._procs:
            p.terminate()
        for p in self._procs:
            try:
                p.wait(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        self.ring.unlink()
