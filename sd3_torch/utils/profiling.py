"""Profiling utilities (JAX counterpart: sd3_tpu/utils/profiling.py).

- `trace(log_dir)`: a context manager around `torch.profiler.profile`. It
  records the host's operators, and the card's kernels when a card is there
  (CUDA activity), and writes one Chrome trace (`trace_<time>.json`,
  readable in Perfetto or chrome://tracing) into `log_dir` at exit. It
  yields the profiler, so a caller can also read `key_averages()`;
- `annotate(name)`: `torch.profiler.record_function`, a named region of the
  trace inside a step;
- `StepTimer`: host-side step timing with a percentile summary and an
  optional JSONL sink (copied as it is).
"""

from __future__ import annotations

import contextlib
import json
import os
import time

import numpy as np


@contextlib.contextmanager
def trace(log_dir: str):
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(
            log_dir, f"trace_{time.strftime('%Y%m%d_%H%M%S')}_"
                     f"{os.getpid()}.json"))


def annotate(name: str):
    from torch.profiler import record_function
    return record_function(name)


class StepTimer:
    def __init__(self, sink_path: str | None = None):
        self.times: list[float] = []
        self._t0 = None
        self._sink = open(sink_path, "a") if sink_path else None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        self.times.append(dt)
        if self._sink:
            self._sink.write(json.dumps({"step_time": dt}) + "\n")
            self._sink.flush()

    def summary(self) -> dict:
        if not self.times:
            return {}
        a = np.asarray(self.times)
        return {"mean": float(a.mean()), "p50": float(np.percentile(a, 50)),
                "p90": float(np.percentile(a, 90)),
                "p99": float(np.percentile(a, 99)), "n": len(a)}
