"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric with new files and new entries only: the files already
there stay byte for byte as they were, and the new cell runs and reports
the new metric."""
import hashlib
import json
import os

from conftest import run_cell


def _digest(root):
    out = {}
    for d, _, files in os.walk(os.path.join(root, "benchmark")):
        for f in files:
            p = os.path.join(d, f)
            out[p] = hashlib.sha256(open(p, "rb").read()).hexdigest()
    return out


def test_add_cell_with_files_and_entries(tiny_root):
    before = _digest(tiny_root)
    b = os.path.join(tiny_root, "benchmark")
    cfg = json.load(open(os.path.join(b, "configs", "tiny-gat.json")))
    cfg.update(name="tiny-sage-infer")
    cfg["model"] = {**cfg["model"], "name": "gat", "heads": [1, 1, 1]}
    with open(os.path.join(b, "configs", "tiny-sage-infer.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "infer-one-variant.json"), "w") as f:
        json.dump({"mode": "infer", "why": "one weight set", "variants": 1,
                   "nominal_pass_s": 0.2, "traced_passes": 1}, f)
    with open(os.path.join(b, "metrics", "infer.passes.py"), "w") as f:
        f.write("def read(ctx):\n    return float(ctx.run.passes)\n")
    path = os.path.join(tiny_root, "BENCHMARK.json")
    bench = json.load(open(path))
    bench["configs"].append({"name": "tiny-sage-infer", "source": "toy",
                             "file": "benchmark/configs/tiny-sage-infer.json",
                             "reduced": [], "why": "toy"})
    bench["workloads"].append({"name": "new-cell", "config":
                               "tiny-sage-infer", "traffic":
                               "infer-one-variant", "chips": 1, "why": "toy"})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_nodes_per_s":
            m["workloads"].append("new-cell")
    bench["per_layer"].append({
        "name": "infer.passes", "unit": "passes", "better": "higher",
        "source": "program_counter", "layer": "inference",
        "moves": "infer_nodes_per_s", "workloads": ["new-cell"]})
    with open(path, "w") as f:
        json.dump(bench, f)
    after = _digest(tiny_root)
    assert all(after[p] == h for p, h in before.items())
    rc, line, err = run_cell(tiny_root, "new-cell", trace=1)
    assert rc == 0, err
    assert line["correct"] is True
    assert line["metrics"]["infer.passes"]["value"] == line["attempted"]
