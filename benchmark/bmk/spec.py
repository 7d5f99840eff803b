"""What a cell is, read from ``BENCHMARK.json`` and the files it names:
the configuration (``configs/<name>.json``), the traffic mix
(``traffic/<name>.json``) and a reader module per per-layer metric
(``metrics/<metric name>.py``, with a ``read(ctx)`` that returns a number
or None). Adding a cell, a configuration, a traffic mix or a per-layer
metric is new files and new entries; no file here changes."""
from __future__ import annotations

import importlib.util
import json
import os


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    and metrics."""

    def __init__(self, root, name):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if name not in cells:
            raise SystemExit(f"unknown workload {name!r}; the cells are "
                             f"{sorted(cells)}")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        with open(os.path.join(root, self.config_entry["file"])) as f:
            self.cfg = json.load(f)
        self.dir = os.path.join(root, self.bench["paths"][0])
        with open(os.path.join(self.dir, "traffic",
                               f"{self.entry['traffic']}.json")) as f:
            self.traffic = json.load(f)
        self.mode = self.traffic["mode"]

    def _reported(self, metric):
        return "workloads" not in metric or self.name in metric["workloads"]

    def end_to_end(self):
        return [m for m in self.bench["end_to_end"] if self._reported(m)]

    def per_layer(self):
        """[(metric entry, its reader module)] of the metrics this cell
        reports."""
        out = []
        for m in self.bench["per_layer"]:
            if not self._reported(m):
                continue
            path = os.path.join(self.dir, "metrics", f"{m['name']}.py")
            out.append((m, load_module(path, "metric_" + m["name"].replace(
                ".", "_").replace("-", "_"))))
        return out

    def limits(self):
        """{number: limit} that decide ``correct`` in this mode."""
        return self.cfg["limits"][self.mode]

    def reference(self):
        """The plain reference of this mode that the configuration names
        (a file under the checkout's root)."""
        return load_module(os.path.join(self.root, self.cfg["reference"][
            self.mode]), "reference_" + self.mode)

    def costs(self):
        """The FLOP and byte counts (``metrics/costs.py``)."""
        return load_module(os.path.join(self.dir, "metrics", "costs.py"),
                           "bench_costs")
