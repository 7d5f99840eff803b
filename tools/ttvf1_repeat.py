#!/usr/bin/env python3
"""Repeats the time-to-validation-F1 run of ``chip_smoke.py`` (``bench.py``'s
protocol: synth-pubmed-hard, SAGE-256 x3, poisson-bandit, fan-outs
256/128/64, batch 1024, chains of 8, target 0.90, at most 25 chains), to
show how far one run's count of steps can move:

    python3 tools/ttvf1_repeat.py [N] [--frozen]         # the port, N times
    python3 tools/ttvf1_repeat.py --seeds S [S ...]      # the port, per seed
    python3 tools/ttvf1_repeat.py --jax --seeds S [S ...]

Without ``--seeds`` the port runs N times (default 5) from the same seeds,
on the card (where the unsorted K1 and K3 sums add with atomics, so two
runs need not sample the same blocks). With ``--seeds`` each run moves the
weights' and the draws' seeds by 1000 times S: the port on the card, or on
the CPU when there is none; with ``--jax`` the JAX package's own
``bench._bench_time_to_val_f1`` on the CPU, its weight and state keys (1
and 2) moved alike. ``--frozen``: the bandit ablation arm. Each run prints
one JSON line; the port's last line is the card's name and power limit."""
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def jax_run(seed_offset, frozen):
    import jax

    key = jax.random.PRNGKey
    jax.random.PRNGKey = lambda k: key(k + 1000 * seed_offset
                                       if k in (1, 2) else k)
    import bench

    try:
        return bench._bench_time_to_val_f1(freeze=frozen)
    finally:
        jax.random.PRNGKey = key


def main():
    argv = sys.argv[1:]
    frozen = "--frozen" in argv
    seeds = None
    if "--seeds" in argv:
        seeds = [int(a) for a in argv[argv.index("--seeds") + 1:]]
    if "--jax" in argv:
        for s in seeds or [0]:
            print(json.dumps({"package": "jax", "seed_offset": s,
                              "frozen": frozen, **jax_run(s, frozen)}),
                  flush=True)
        return
    import torch

    import harness_torch

    cuda = torch.cuda.is_available()
    if seeds is None and not cuda:
        sys.exit("ttvf1_repeat: repeating one seed needs a CUDA card")
    dev = torch.device("cuda" if cuda else "cpu")
    plain = [a for a in argv if not a.startswith("--")]
    runs = seeds if seeds is not None else [0] * (int(plain[0]) if plain
                                                  else 5)
    for i, s in enumerate(runs):
        r = harness_torch.time_to_val_f1(dev, freeze=frozen,
                                      seed_offset=s)
        print(json.dumps({"package": "torch", "device": str(dev), "run": i,
                          "seed_offset": s, "frozen": frozen, **r}),
              flush=True)
    if cuda:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True)
        print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
