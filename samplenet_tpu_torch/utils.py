"""Run logging: a copy of samplenet_tpu/utils/logging.py::Logger (the port
cannot import the JAX package). Lines go to stdout and log_{name}.txt,
metrics as JSON lines to metrics_{name}.jsonl in the log directory."""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any


class Logger:
    def __init__(self, log_dir: str | None = None, name: str = "train"):
        self.log_dir = log_dir
        self._fh = None
        self._metrics_fh = None
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self._fh = open(os.path.join(log_dir, f"log_{name}.txt"), "a")
            self._metrics_fh = open(
                os.path.join(log_dir, f"metrics_{name}.jsonl"), "a")

    def log(self, msg: str) -> None:
        line = f"[{time.strftime('%H:%M:%S')}] {msg}"
        print(line, file=sys.stdout, flush=True)
        if self._fh:
            self._fh.write(line + "\n")
            self._fh.flush()

    def metrics(self, step: int, **kwargs: Any) -> None:
        if self._metrics_fh:
            rec = {"step": int(step), "time": time.time()}
            rec.update({k: float(v) for k, v in kwargs.items()})
            self._metrics_fh.write(json.dumps(rec) + "\n")
            self._metrics_fh.flush()

    def close(self) -> None:
        for fh in (self._fh, self._metrics_fh):
            if fh:
                fh.close()
