"""Experiment CLI (counterpart of ``bliss_gnn_tpu/train/cli.py``), with
its flags and defaults:

    python -m bliss_gnn_tpu_torch.train.cli --dataset synth-pubmed \
        --model sage --sampler poisson-bandit --num-layers 3 \
        --fan-out 512,256,128 --batch-size 32 --num-steps 1000

Runs on the CUDA card (which must exist), or with ``--platform cpu`` on
the plain PyTorch path. ``--gpu``, ``--num-workers``, ``--data-cpu`` and
``--download`` are accepted and ignored (nothing is downloaded: the on-disk
datasets are read from ``BLISS_DATA_ROOT``). ``--use-uva`` keeps the
features in host memory behind a device cache of ``--cache-size`` rows.
``--inference-backend`` named the reference's TPU layouts; every value runs
the CSC kernels here. ``--precision highest`` computes in f32 (features,
activations and final inference; the parameters stay f32 and the arm
weights bf16, as in the reference).

``--dp N`` trains over N ranks (``parallel/dp.py``; ``--shard-graph``
range-shards the graph over them). With no process group running the CLI
starts the N ranks itself, processes of this host joined through a
``FileStore``; under torchrun (``torchrun --nproc-per-node N -m
bliss_gnn_tpu_torch.train.cli --dp N ...``) each rank joins the launcher's
group. Both run the same code, one rank per process; rank 0 logs and
returns the results.
"""
from __future__ import annotations

import argparse
import csv
import glob
import os
import sys
from collections import defaultdict

import numpy as np
import torch
import torch.distributed as dist

from bliss_gnn_tpu_torch._device import resolve_device


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--model", type=str, default="sage",
                   choices=["sage", "gcn", "gat"])
    p.add_argument("--dataset", type=str, default="cora")
    p.add_argument("--num-epochs", type=int, default=-1)
    p.add_argument("--num-steps", type=int, default=-1)
    p.add_argument("--min-steps", type=int, default=0)
    p.add_argument("--num-hidden", type=int, default=256)
    p.add_argument("--num-layers", type=int, default=3)
    p.add_argument("--num-in-heads", type=int, default=4)
    p.add_argument("--num-out-heads", type=int, default=1)
    p.add_argument("--attn-dropout", type=float, default=0.1)
    p.add_argument("--negative-slope", type=float, default=0.2)
    p.add_argument("--residual", action="store_true", default=False)
    # accepted and ignored, as in the reference: canonicalisation adds
    # self-loops, so no node has zero in-degree
    p.add_argument("--allow-zero-in-degree", action="store_true", default=False)
    p.add_argument("--fan-out", type=str, default="16384,8192,4096")
    p.add_argument("--eta", type=float, default=0.1)
    p.add_argument("--batch-size", type=int, default=1024)
    p.add_argument("--lr", type=float, default=0.002)
    p.add_argument("--dropout", type=float, default=0.1)
    p.add_argument("--sampler", type=str, default="poisson-bandit",
                   choices=["full", "neighbor", "bandit", "poisson-bandit",
                            "ladies", "poisson-ladies"])
    p.add_argument("--importance-sampling", type=int, default=1)
    p.add_argument("--logdir", type=str, default="tb_logs")
    p.add_argument("--vertex-limit", type=int, default=-1)
    p.add_argument("--undirected", action="store_true")
    p.add_argument("--val-acc-target", type=float, default=1.0)
    p.add_argument("--early-stopping-patience", type=int, default=1000)
    p.add_argument("--disable-checkpoint", action="store_true")
    p.add_argument("--precision", type=str, default="medium",
                   help="medium = bf16 compute; highest = f32")
    p.add_argument("--k-runs", type=int, default=1)
    p.add_argument("--seed", type=int, default=0)
    # accepted and ignored: sampling runs on the device, and nothing is
    # downloaded
    p.add_argument("--gpu", type=int, default=0)
    p.add_argument("--num-workers", type=int, default=0)
    p.add_argument("--data-cpu", action="store_true")
    p.add_argument("--download", action="store_true",
                   help="accepted and ignored")
    p.add_argument("--use-uva", action="store_true",
                   help="host-resident features behind a device cache")
    p.add_argument("--cache-size", type=int, default=0,
                   help="device feature-cache rows under --use-uva")
    # surfaced constants
    p.add_argument("--ema-w", type=float, default=0.99)
    p.add_argument("--exp3-delta", type=float, default=0.01)
    p.add_argument("--exp3-delta-formula", action="store_true",
                   help="use the paper's per-dst delta formula (commented "
                        "out in the reference, bandit_sampler.py:226-233) "
                        "instead of the constant --exp3-delta; T = "
                        "--num-steps")
    p.add_argument("--exp3-renorm-every", type=int, default=64,
                   help="steps between deferred EXP3 L1 row normalizations (1 = reference's normalize-every-step)")
    p.add_argument("--poisson-eps", type=float, default=0.9999)
    p.add_argument("--lr-gamma", type=float, default=0.01)
    p.add_argument("--lr-step-size", type=int, default=5)
    # capacity knobs
    p.add_argument("--frontier-slack", type=float, default=8.0)
    p.add_argument("--block-edge-slack", type=float, default=4.0)
    p.add_argument("--max-frontier-edges", type=int, default=-1)
    p.add_argument("--refit-after", type=int, default=3,
                   help="steps before tightening the static capacities to "
                        "measured maxima and re-jitting (0 disables)")
    p.add_argument("--refit-block-edge-slack", type=float, default=1.6)
    p.add_argument("--refit-frontier-slack", type=float, default=1.25)
    p.add_argument("--inference-backend", type=str, default="auto",
                   choices=["auto", "xla", "pallas", "hybrid"],
                   help="the reference's final-eval layouts; every value "
                        "runs the CSC kernels (K6, K7) on the card")
    p.add_argument("--resume", type=str, default="",
                   help="checkpoint file to restore (parameters, Adam "
                        "state, schedule, EXP3 weights, generator, step) "
                        "before training")
    p.add_argument("--profile-steps", type=int, default=0,
                   help="write a torch.profiler trace of N training steps "
                        "from the first replayed one (after the pilot steps "
                        "and the capture), with the trainer's spans, to "
                        "<run_dir>/profile")
    p.add_argument("--steps-per-call", type=int, default=1,
                   help="chain K fused steps per call (on the card: "
                        "replays of one captured CUDA graph after the "
                        "pilot steps, K = 1 too)")
    p.add_argument("--eval-steps-per-call", type=int, default=8,
                   help="chain K sampled-validation batches per dispatch "
                        "(exactly equal metrics to the per-batch loop; on "
                        "the card replayed, K = 1 too; on the CPU 1 "
                        "disables)")
    p.add_argument("--platform", type=str, default="",
                   help="empty (or cuda) = the CUDA card, which must "
                        "exist; cpu = the plain PyTorch path")
    p.add_argument("--dp", type=int, default=1,
                   help="data-parallel ranks: the global batch split over "
                        "N ranks, gradients averaged, the EXP3 deltas "
                        "all-gathered; with no process group running the "
                        "CLI starts the N ranks itself; 0 = every rank the "
                        "launcher placed; 1 = one device")
    p.add_argument("--shard-graph", action="store_true", default=False,
                   help="range-shard the graph, features and EXP3 state "
                        "over the dp ranks (requires --dp N, N > 1)")
    p.add_argument("--shard-indptr", type=int, choices=(0, 1), default=None,
                   help="also shard the csc_indptr under --shard-graph "
                        "(default: on past 32M nodes)")
    return p


def config_from_args(args) -> "TrainConfig":
    from bliss_gnn_tpu_torch.train.trainer import TrainConfig

    return TrainConfig(
        dataset=args.dataset,
        model=args.model,
        sampler=args.sampler,
        fan_out=tuple(int(x) for x in args.fan_out.split(",")),
        batch_size=args.batch_size,
        num_hidden=args.num_hidden,
        num_layers=args.num_layers,
        lr=args.lr,
        dropout=args.dropout,
        eta=args.eta,
        importance_sampling=bool(args.importance_sampling),
        num_epochs=args.num_epochs,
        num_steps=args.num_steps,
        min_steps=args.min_steps,
        num_in_heads=args.num_in_heads,
        num_out_heads=args.num_out_heads,
        attn_dropout=args.attn_dropout,
        negative_slope=args.negative_slope,
        residual=args.residual,
        undirected=args.undirected,
        val_acc_target=args.val_acc_target,
        early_stopping_patience=args.early_stopping_patience,
        disable_checkpoint=args.disable_checkpoint,
        logdir=args.logdir,
        vertex_limit=args.vertex_limit,
        seed=args.seed,
        ema_w=args.ema_w,
        exp3_delta=args.exp3_delta,
        exp3_delta_formula=args.exp3_delta_formula,
        exp3_renorm_every=args.exp3_renorm_every,
        poisson_eps=args.poisson_eps,
        lr_gamma=args.lr_gamma,
        lr_step_size=args.lr_step_size,
        frontier_slack=args.frontier_slack,
        block_edge_slack=args.block_edge_slack,
        max_frontier_edges=(
            None if args.max_frontier_edges <= 0 else args.max_frontier_edges
        ),
        refit_after=args.refit_after,
        refit_block_edge_slack=args.refit_block_edge_slack,
        refit_frontier_slack=args.refit_frontier_slack,
        profile_steps=args.profile_steps,
        resume=args.resume,
        inference_backend=args.inference_backend,
        use_uva=args.use_uva,
        cache_size=args.cache_size,
        steps_per_call=args.steps_per_call,
        eval_steps_per_call=args.eval_steps_per_call,
        dp=args.dp,
        shard_graph=args.shard_graph,
        shard_indptr=(None if args.shard_indptr is None
                      else bool(args.shard_indptr)),
        compute_dtype="float32" if args.precision == "highest" else "bfloat16",
    )


def reduce_runs(logdir: str, run_name: str, k: int):
    """Mean and std over the last k runs' ``metrics.csv``, per series and
    step: ``<logdir>_reduced/<run_name>_<k>.csv``, plus mean and std
    TensorBoard event streams (``<run_name>_<k>-{mean,std}/``) when
    TensorBoard is installed."""
    base = os.path.join(logdir, run_name)
    version_dirs = sorted(
        glob.glob(os.path.join(base, "version_*")),
        key=lambda x: int(x.split("_")[-1]),
    )[-k:]
    print(f"Found {len(version_dirs)} run dirs for reduction")
    series = defaultdict(lambda: defaultdict(list))  # name -> step -> [values]
    for vd in version_dirs:
        path = os.path.join(vd, "metrics.csv")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for row in csv.DictReader(f):
                series[row["name"]][int(row["step"])].append(float(row["value"]))
    out_dir = f"{logdir}_reduced"
    os.makedirs(out_dir, exist_ok=True)
    out_path = os.path.join(out_dir, f"{run_name}_{len(version_dirs)}.csv")
    with open(out_path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "step", "mean", "std", "n"])
        for name, steps in sorted(series.items()):
            for step, vals in sorted(steps.items()):
                w.writerow([
                    name, step, float(np.mean(vals)),
                    float(np.std(vals)), len(vals),
                ])
    print(f"Wrote reduction to {out_path}")
    try:
        from torch.utils.tensorboard import SummaryWriter
    except Exception:
        return
    for op, fn in (("mean", np.mean), ("std", np.std)):
        d = os.path.join(out_dir, f"{run_name}_{len(version_dirs)}-{op}")
        tb = SummaryWriter(log_dir=d)
        for name, steps in sorted(series.items()):
            for step, vals in sorted(steps.items()):
                tb.add_scalar(name, float(fn(vals)), step)
        tb.close()
        print(f"Wrote {op} TB events to {d}")


def _rank_main(argv):
    """One rank of the CLI's own launch: the group is joined, so ``main``
    trains."""
    return main(argv)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    args = build_argparser().parse_args(argv)
    platform = args.platform.lower()
    if platform not in ("", "cuda", "gpu", "cpu"):
        raise ValueError(f"--platform {args.platform!r}: use cpu, or leave "
                         f"it empty for the CUDA card")
    device = resolve_device("cpu" if platform == "cpu" else "cuda")
    if (args.dp > 1 and not dist.is_initialized()
            and int(os.environ.get("WORLD_SIZE", "1")) <= 1):
        from bliss_gnn_tpu_torch.parallel.multihost import run_ranks

        threads = (max(1, torch.get_num_threads() // args.dp)
                   if device.type == "cpu" else None)
        return run_ranks(_rank_main, args.dp, (argv,), device=device,
                         threads=threads)[0]
    from bliss_gnn_tpu_torch.train.trainer import Trainer

    cfg = config_from_args(args)
    main_rank = not dist.is_initialized() or dist.get_rank() == 0
    results = []
    for run in range(args.k_runs):
        if main_rank:
            print("=" * 20 + f"run_{run + 1} for eta_{args.eta}" + "=" * 20)
        run_cfg = dataclasses_replace_seed(cfg, cfg.seed + run)
        trainer = Trainer(run_cfg, device=device)
        trainer.fit()
        trainer.restore_best()
        results.append(trainer.final_eval())
    if args.k_runs > 1 and main_rank:
        reduce_runs(args.logdir, cfg.run_name, args.k_runs)
        for split in ["Train", "Validation", "Test"]:
            vals = [r[split] for r in results]
            print(
                f"{split}: mean {np.mean(vals):.4f} std {np.std(vals):.4f} "
                f"over {len(vals)} runs"
            )
    return results


def dataclasses_replace_seed(cfg, seed):
    import dataclasses

    return dataclasses.replace(cfg, seed=seed)


if __name__ == "__main__":
    main()
