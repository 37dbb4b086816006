"""Training metrics logging (the port's copy of sd3_tpu/utils/logging.py).

wandb-compatible (project "Stable_Diffusion_3", resumable run ids riding in
the checkpoint — reference model_trainer.py:321-338) when wandb is installed,
with a JSONL file sink always on so runs are inspectable without any service.
Over a mesh only the main process logs (`main`): the others open no file
and no run, and `log` does nothing there.
"""

from __future__ import annotations

import json
import os
import time
import uuid
from typing import Mapping


class MetricsLogger:
    def __init__(self, log_dir: str, run_name: str | None = None,
                 run_id: str | None = None, project: str = "Stable_Diffusion_3",
                 use_wandb: bool = True, main: bool = True):
        self.run_id = run_id or uuid.uuid4().hex[:8]
        self._file = self._wandb = None
        if not main:
            return
        os.makedirs(log_dir, exist_ok=True)
        self._path = os.path.join(log_dir, f"metrics_{self.run_id}.jsonl")
        self._file = open(self._path, "a")
        if use_wandb:
            try:
                import wandb  # optional
                self._wandb = wandb
                wandb.init(project=project, name=run_name,
                           resume="must" if run_id else None, id=run_id)
                self.run_id = wandb.run.id
            except Exception:
                self._wandb = None

    def log(self, metrics: Mapping[str, float], step: int):
        if self._file is None:
            return
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._file.write(json.dumps(rec) + "\n")
        self._file.flush()
        if self._wandb is not None:
            self._wandb.log(dict(metrics), step=step)

    def close(self):
        if self._file is None:
            return
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()
