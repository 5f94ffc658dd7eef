"""Training metrics: one JSON line per logged step in metrics.jsonl.

Counterpart of the JSONL backend of open_pandora_tpu/utils/loggers.py
(`MetricsLogger`, `JSONLWriter`); its TensorBoard, CSV and wandb backends
wait for a later slice.
"""

from __future__ import annotations

import json
import os
from typing import Dict


class MetricsLogger:
    """Appends {"step": n, **metrics} to {loginfo_dir}/metrics.jsonl,
    flushed after every line."""

    def __init__(self, loginfo_dir: str):
        os.makedirs(loginfo_dir, exist_ok=True)
        self.path = os.path.join(loginfo_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, **{k: float(v) for k, v in metrics.items()}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()
