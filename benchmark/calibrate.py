"""The readings that the limits of ``correct`` are set from, for one cell
at its own size: the program's numbers on many seeds (the lower
readings), the control's (the reference at the next precision below the
configuration's, in the program's place) and the planted faults' on a
few (the upper readings). One process, the graph built once.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 1,2] [--fault half_batch --fault-seeds 4,5,6] \
        [--seconds 51]

A control seed that is also a program seed is read from the same run.
``--seconds`` runs the cell's window before the check, as a run does (the
replayed training steps are then checked in the state the window leaves);
without it there is no window. Prints one JSON line per reading and a
summary line: each number's largest program reading and smallest control
and fault readings.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.join(HERE, "reference")]
sys.path.append(os.path.dirname(HERE))


def _seeds(s):
    return [int(x) for x in s.split(",") if x]


def readings(cell, seed, dev, roundings=(None,), fault=None, seconds=0.0):
    """The check's numbers after one run of ``seed`` without its timed
    metrics, once for each of ``roundings`` (None: the program's; a
    ``Rounding``: the control's)."""
    import contextlib

    import faults
    from bmk import infer, train

    plant = (faults.plant(cell.mode, fault) if fault
             else contextlib.nullcontext())
    with plant:
        if cell.mode == "train":
            r = train.Run(cell, seed, dev)
            r.build()
            r.warm()
            if seconds > 0:
                r.window(seconds)
            r.replay_check()
            r.free()
        else:
            r = infer.Run(cell, seed, dev)
            r.build()
            r.window(seconds)
            r.free()
    return [r.check(rounding)[0] for rounding in roundings]


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    import torch

    from bmk.spec import Cell
    from precision import lowered

    cell = Cell(os.path.dirname(HERE), args.workload)
    dev = torch.device(args.device)
    ctl = lowered(cell.cfg)
    seeds, controls = _seeds(args.seeds), _seeds(args.control_seeds)
    runs = ([(s, [("program", None)] + ([("control", ctl)]
                                         if s in controls else []), None)
             for s in seeds]
            + [(s, [("control", ctl)], None) for s in controls
               if s not in seeds]
            + [(s, [(f"fault:{args.fault}", None)], args.fault)
               for s in _seeds(args.fault_seeds)])
    summary = {}
    for seed, kinds, fault in runs:
        t0 = time.perf_counter()
        got = readings(cell, seed, dev, [r for _, r in kinds], fault,
                       args.seconds)
        for (kind, _), nums in zip(kinds, got):
            print(json.dumps({"kind": kind, "seed": seed, "numbers": nums,
                              "s": time.perf_counter() - t0}), flush=True)
            agg = summary.setdefault(kind, {})
            for k, v in nums.items():
                agg[k] = (max(agg.get(k, v), v) if kind == "program"
                          else min(agg.get(k, v), v))
    print(json.dumps({"summary": summary}), flush=True)


if __name__ == "__main__":
    main()
