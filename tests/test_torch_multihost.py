"""The port's multi-process training through the real train CLI
(`sd3_torch.training.train.main([... "--multihost", "--device", "cpu"])`),
two gloo processes: the counterpart of tests/test_multihost.py, where two
JAX processes share one 8-device mesh. Here each process is one device of
the mesh, loads its data rank's rows, and the main process alone gathers
and writes the checkpoint.

Each launch uses a free port and a process-group timeout of 60 s
(`multihost.DEFAULT_TIMEOUT_S`, set in the child); the test waits at most
LAUNCH_TIMEOUT_S for both processes and kills them past it.
"""

import io
import json
import os
import re
import socket
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LAUNCH_TIMEOUT_S = 120

CHILD = r"""
import os, sys
import torch
torch.set_num_threads(1)
from sd3_torch.parallel import multihost
multihost.DEFAULT_TIMEOUT_S = 60
from sd3_torch.training import train
pid, port, save, extra = sys.argv[1], sys.argv[2], sys.argv[3], sys.argv[4:]
train.main([
    "--multihost", "--coordinator_address", f"localhost:{port}",
    "--num_processes", "2", "--process_id", pid, "--device", "cpu",
    "--preset", "tiny", "--batchSize", "8", "--accumulation_steps", "2",
    "--numSaveSteps", "1000000", "--warmup_steps", "1", "--log_steps", "1",
    "--ema_update_freq", "2", "--saveDir", os.path.join(save, f"r{pid}"),
    *extra])
print(f"MULTIHOST_OK_{pid}", flush=True)
# the data path's decode threads are daemons parked on queues: end here,
# as the JAX package's test does, once the contract above has passed
os._exit(0)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _launch(save, *extra) -> list:
    """Both processes' outputs; past LAUNCH_TIMEOUT_S both are killed."""
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen(
        [sys.executable, "-c", CHILD, str(i), str(port), str(save), *extra],
        cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for i in range(2)]
    deadline = time.monotonic() + LAUNCH_TIMEOUT_S
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(0.1, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i}:\n{out[-4000:]}"
        assert f"MULTIHOST_OK_{i}" in out, out[-4000:]
    return outs


def _check_checkpoint(save, step):
    # only the main process wrote the (gathered) checkpoint and the metrics
    r0, r1 = os.path.join(save, "r0"), os.path.join(save, "r1")
    assert os.path.exists(os.path.join(r0, f"model_{step}s.msgpack"))
    assert not os.path.exists(r1) or not os.listdir(r1), os.listdir(r1)
    metrics = [f for f in os.listdir(r0) if f.startswith("metrics_")]
    assert len(metrics) == 1
    with open(os.path.join(r0, metrics[0])) as f:
        recs = [json.loads(line) for line in f]
    assert recs and all(np.isfinite(r["loss"]) for r in recs)


def test_two_process_train(tmp_path):
    _launch(tmp_path, "--synthetic", "--totalSteps", "4", "--stage_res",
            "32", "--fsdp", "2", "--low_mem_optimizer")
    _check_checkpoint(tmp_path, 4)


def test_two_process_train_real_data(tmp_path):
    # two processes on a parquet folder with the stub encoders, a shared
    # bucket sequence and each bucket's rows split by data rank: every
    # step's bucket shape is the same on both ranks (anything else would
    # hang a collective until the group's timeout)
    import pyarrow as pa
    import pyarrow.parquet as pq
    from PIL import Image

    def png(h, w, v):
        buf = io.BytesIO()
        Image.fromarray(np.full((h, w, 3), v, np.uint8)).save(buf, "PNG")
        return buf.getvalue()

    d = tmp_path / "pq"
    d.mkdir()
    rows = []
    for i in range(48):
        h, w = (16, 16) if i % 2 else (32, 16)
        rows.append({"image": png(h, w, 5 * (i % 40)),
                     "recaption": f"caption {i}", "recaption_short": f"c{i}",
                     "bucket_size": f"{h}x{w}"})
    pq.write_table(pa.Table.from_pylist(rows), str(d / "p.parquet"))
    outs = _launch(tmp_path / "ck", "--data_parquet_folder", str(d),
                   "--stub_encoders", "--data_threads", "2",
                   "--prefetch_batches", "1", "--totalSteps", "3",
                   "--seed", "5", "--dp", "2")
    shapes = [re.findall(r"step (\d+): bucket (\d+x\d+)", o) for o in outs]
    assert len(shapes[0]) == 3 and shapes[0] == shapes[1], shapes
    _check_checkpoint(tmp_path / "ck", 3)
