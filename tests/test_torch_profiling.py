"""The port's profiling utilities (sd3_torch/utils/profiling.py) against
the JAX package's: StepTimer's summary on the same recorded times, its
JSONL sink, and a trace on the CPU that names an annotated region."""

import json
import os
import time

import numpy as np
import pytest
import torch

from sd3_tpu.utils import profiling as jprof

from sd3_torch.utils import profiling


@pytest.mark.parametrize("times", [[0.5], [0.1, 0.3, 0.2, 0.9, 0.05],
                                   list(np.random.default_rng(0).random(37))])
def test_step_timer_summary_equals_the_jax_packages(times):
    ours, theirs = profiling.StepTimer(), jprof.StepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert profiling.StepTimer().summary() == {}


def test_step_timer_times_and_sinks(tmp_path):
    sink = str(tmp_path / "t.jsonl")
    timer = profiling.StepTimer(sink)
    for _ in range(3):
        with timer:
            time.sleep(0.01)
    s = timer.summary()
    assert s["n"] == 3 and s["mean"] >= 0.01
    recs = [json.loads(ln) for ln in open(sink)]
    assert [r["step_time"] for r in recs] == timer.times


def test_trace_writes_a_file_that_names_the_annotation(tmp_path):
    log_dir = str(tmp_path / "trace")
    x = torch.randn(64, 64)
    with profiling.trace(log_dir) as prof:
        with profiling.annotate("sd3_region_under_test"):
            (x @ x).sum()
    names = os.listdir(log_dir)
    assert len(names) == 1 and names[0].endswith(".json")
    with open(os.path.join(log_dir, names[0])) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name") == "sd3_region_under_test" for e in events)
    assert any("mm" in k.key for k in prof.key_averages())
