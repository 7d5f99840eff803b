"""The benchmark of the PyTorch and CUDA port (``bliss_gnn_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, on
the card(s) of the machine it starts on, and prints one JSON line last on
standard output: ``correct``, ``attempted``, ``failed``, ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each number that decided ``correct`` beside its limit. The
set-up's breakdown, the card's power limit and the peak memory go to
standard error first, the checks last.

It exits non-zero and prints no result without enough cards, or when a
module of JAX or of the JAX package was loaded.
"""
import os
import time

T_START = time.time()
# one process with few threads: the host's share of a step stays steady
os.environ.setdefault("OMP_NUM_THREADS", "1")

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, os.path.join(HERE, "reference")]
sys.path.append(ROOT)

FORBIDDEN = ("jax", "jaxlib", "flax", "bliss_gnn_tpu")


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name (before the first dot, compared
    whole) is JAX's or the JAX package's."""
    names = {m.split(".")[0] for m in (sys.modules if modules is None
                                       else modules)}
    return sorted(names & set(FORBIDDEN))


class CardNote:
    """The cards' name and power limit from ``nvidia-smi``, asked at the
    start and read at the end, so that set-up does not wait for it."""

    def __init__(self):
        try:
            self.proc = subprocess.Popen(
                ["nvidia-smi", "--query-gpu=name,power.limit",
                 "--format=csv,noheader"], stdout=subprocess.PIPE,
                stderr=subprocess.DEVNULL, text=True)
        except OSError:
            self.proc = None

    def read(self):
        if self.proc is None:
            return "not read"
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        return out.strip() or "not read"


def _say(log, tag, obj):
    print(f"bench: {tag} {json.dumps(obj, default=str)}", file=log,
          flush=True)


def main(argv=None, chip_check=True, device="cuda", root=ROOT,
         out=sys.stdout, log=sys.stderr):
    args = parse(argv)
    import torch

    torch.set_num_threads(1)

    from bmk.spec import Cell

    cell = Cell(root, args.workload)
    if chip_check:
        if not torch.cuda.is_available() or (
                torch.cuda.device_count() < cell.chips):
            print(f"bench: {cell.name} needs {cell.chips} CUDA card(s); "
                  f"{torch.cuda.device_count()} visible", file=log)
            return 2
    dev = torch.device(device)
    note = CardNote() if dev.type == "cuda" else None
    if cell.mode == "train":
        from bmk import train as mode
    else:
        from bmk import infer as mode
    before_s = time.time() - T_START  # the interpreter, imports, the card
    try:
        res = mode.run(cell, args.seed, args.seconds, bool(args.trace), dev,
                       T_START)
    finally:
        card = note.read() if note is not None else None
    res["setup"]["imports_and_card"] = before_s
    if card is not None:
        _say(log, "card", card)
    bad = forbidden_modules()
    if bad:
        print(f"bench: modules of JAX or the JAX package were loaded: {bad}",
              file=log)
        return 3

    _say(log, "setup", {"setup_s": res["setup_s"], **res["setup"]})
    _say(log, "window", {"window_s": res["window_s"], **res["notes"],
                         "reference_s": res["ref_s"]})
    _say(log, "memory_peak_bytes", res["memory_peak_bytes"])
    metrics = {}
    if not args.trace:
        values = {"setup_s": res["setup_s"], **res["e2e"]}
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        ctx = Context(cell, res, cell.costs())
        for m, reader in cell.per_layer():
            v = reader.read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(0) if dev.type == "cuda"
                 else dev.type),
        "count": cell.chips,
        "memory_peak_bytes": res["memory_peak_bytes"]}
    line = {"correct": res["correct"], "attempted": res["attempted"],
            "failed": res["failed"], "metrics": metrics,
            "device": device_info}
    tr = res["trace"]
    if args.trace and tr is not None:
        device_info["busy_s"] = tr["busy_s"]
        device_info["window_s"] = tr["window_s"]
        line["breakdown"] = {"device_ops": tr["device_ops"],
                             "idle_gaps": tr["idle_gaps"]}
    line["checks"] = res["checks"]
    for name, c in res["checks"].items():
        print(f"bench: check {name} {c['value']!r} limit {c['limit']!r}",
              file=log)
    log.flush()
    print(json.dumps(line), file=out, flush=True)
    return 0


class Context:
    """What a per-layer metric's reader reads: the cell, the run (its
    spans and counts), the reduced trace, and the FLOP and byte counts."""

    def __init__(self, cell, res, costs_mod):
        self.cell, self.cfg, self.chips = cell, cell.cfg, cell.chips
        self.run = res["ctx"]["run"]
        self.trace = res["trace"]
        self.window_s = res["window_s"]
        self.sampler_ms = res["ctx"].get("sampler_ms")
        self.costs = costs_mod


if __name__ == "__main__":
    sys.exit(main())
