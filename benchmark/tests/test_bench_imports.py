"""What a run may load: no module whose top-level name, compared whole, is
JAX's or the JAX package's; the benchmark imports none of the repo's
older harnesses, and the reference nothing of the program."""
import ast
import os

import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_whole_top_level_names():
    assert run.forbidden_modules({"bliss_gnn_tpu_torch",
                                  "bliss_gnn_tpu_torch.ops", "jaxtyping",
                                  "flaxen", "numpy"}) == []
    assert run.forbidden_modules({"bliss_gnn_tpu.ops.spmm", "jax.numpy",
                                  "jaxlib", "flax"}) == [
        "bliss_gnn_tpu", "flax", "jax", "jaxlib"]


def test_sources():
    older = {"harness_torch", "bench_torch", "chip_smoke", "bench"}
    for d, _, files in os.walk(BENCH):
        for f in files:
            if not f.endswith(".py"):
                continue
            names = _imports(os.path.join(d, f))
            assert not names & (older | set(run.FORBIDDEN)), (f, names)
            if os.path.basename(d) == "reference":
                assert "bliss_gnn_tpu_torch" not in names, f
