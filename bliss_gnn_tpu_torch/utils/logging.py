"""Metric logging: CSV always, TensorBoard when it is installed (counterpart
of ``MetricLogger`` and ``next_version_dir`` in
``bliss_gnn_tpu/utils/logging.py``).

The series names are the comparison interface with the reference package:
train_acc, train_loss, iter_time, forward_backward_time, num_nodes/{i},
num_edges/{i}, val_acc, val_loss, Final Accuracy/{split}.
"""
from __future__ import annotations

import csv
import os
import time
from typing import Dict


class MetricLogger:
    """Append-only scalar logger: ``<run_dir>/metrics.csv`` with the header
    step,name,value,wall_time, plus TensorBoard events when
    ``torch.utils.tensorboard`` imports."""

    def __init__(self, run_dir: str, use_tensorboard: bool = True):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._csv_path = os.path.join(run_dir, "metrics.csv")
        self._csv_file = open(self._csv_path, "a", newline="")
        self._writer = csv.writer(self._csv_file)
        if os.path.getsize(self._csv_path) == 0:
            self._writer.writerow(["step", "name", "value", "wall_time"])
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(log_dir=run_dir)
            except Exception:
                self._tb = None

    def log(self, step: int, scalars: Dict[str, float]):
        t = time.time()
        for name, value in scalars.items():
            self._writer.writerow([step, name, float(value), t])
            if self._tb is not None:
                self._tb.add_scalar(name, float(value), step)

    def flush(self):
        self._csv_file.flush()
        if self._tb is not None:
            self._tb.flush()

    def close(self):
        self.flush()
        self._csv_file.close()
        if self._tb is not None:
            self._tb.close()


def next_version_dir(base: str) -> str:
    """Creates and returns ``<base>/version_<k>``, k one past the largest
    existing version (0 for the first run)."""
    os.makedirs(base, exist_ok=True)
    existing = [
        int(d.split("_")[-1])
        for d in os.listdir(base)
        if d.startswith("version_") and d.split("_")[-1].isdigit()
    ]
    v = max(existing) + 1 if existing else 0
    path = os.path.join(base, f"version_{v}")
    os.makedirs(path, exist_ok=True)
    return path
