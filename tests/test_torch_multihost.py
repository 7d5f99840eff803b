"""The port's CLI run reduction and flag surface, and its multi-process
layer (``parallel/multihost.py``): the mirror of
``test_cli_and_multihost.py``.

The JAX test runs two processes of two CPU devices each against one
process of four. The port has one rank per process, so its two launch
paths are held against each other: ranks started by ``run_ranks`` (a
``FileStore``, what the CLI's ``--dp`` does with no group running) and
ranks started as separate processes from torchrun's environment
(``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``/``MASTER_PORT``, joined by
``multihost.initialize``), running the same DP and sharded workloads: the
same results, bit for bit. The workers import the port only."""
import csv
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from bliss_gnn_tpu_torch.graph import datasets as tdata
from bliss_gnn_tpu_torch.graph import structure as tstruct
from bliss_gnn_tpu_torch.models import gnn as tgnn
from bliss_gnn_tpu_torch.parallel import dp as tdp
from bliss_gnn_tpu_torch.parallel import multihost
from bliss_gnn_tpu_torch.parallel import shardedstep as tss
from bliss_gnn_tpu_torch.sampling import block as tblock
from bliss_gnn_tpu_torch.sampling import samplers as tsamp
from bliss_gnn_tpu_torch.train import steps as tsteps
from bliss_gnn_tpu_torch.train.cli import (
    build_argparser,
    config_from_args,
    reduce_runs,
)

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL_BATCH = 32


def _write_run(base, version, series):
    d = os.path.join(base, f"version_{version}")
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "metrics.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["step", "name", "value", "wall_time"])
        for name, step, value in series:
            w.writerow([step, name, value, 0.0])


def test_reduce_runs_mean_std(tmp_path):
    base = os.path.join(tmp_path, "runX")
    _write_run(base, 0, [("train_loss", 1, 2.0), ("train_loss", 2, 1.0)])
    _write_run(base, 1, [("train_loss", 1, 4.0), ("train_loss", 2, 3.0)])
    reduce_runs(str(tmp_path), "runX", 2)
    out = os.path.join(f"{tmp_path}_reduced", "runX_2.csv")
    with open(out) as f:
        rows = {(r["name"], int(r["step"])): r for r in csv.DictReader(f)}
    r1 = rows[("train_loss", 1)]
    assert float(r1["mean"]) == 3.0
    assert float(r1["std"]) == 1.0
    assert int(r1["n"]) == 2
    assert float(rows[("train_loss", 2)]["mean"]) == 2.0


def test_cli_full_flag_surface_parses():
    argv = [
        "--model", "gat", "--dataset", "synth-small", "--num-epochs", "2",
        "--num-steps", "10", "--num-hidden", "16", "--num-layers", "2",
        "--num-in-heads", "2", "--num-out-heads", "1",
        "--attn-dropout", "0.2", "--negative-slope", "0.1", "--residual",
        "--fan-out", "8,4", "--eta", "0.3", "--batch-size", "8",
        "--lr", "0.01", "--dropout", "0.2", "--sampler", "poisson-bandit",
        "--importance-sampling", "1", "--logdir", "/tmp/x",
        "--vertex-limit", "1000", "--undirected",
        "--val-acc-target", "0.9", "--early-stopping-patience", "5",
        "--disable-checkpoint", "--k-runs", "2", "--seed", "7",
        "--gpu", "0", "--num-workers", "2", "--data-cpu", "--download",
        "--use-uva", "--cache-size", "100", "--ema-w", "0.9",
        "--exp3-delta", "0.02", "--exp3-renorm-every", "8",
        "--poisson-eps", "0.999", "--lr-gamma", "0.1",
        "--lr-step-size", "3", "--frontier-slack", "4.0",
        "--refit-after", "2", "--steps-per-call", "2",
        "--inference-backend", "hybrid", "--resume", "",
        "--dp", "4", "--shard-graph", "--shard-indptr", "1",
    ]
    cfg = config_from_args(build_argparser().parse_args(argv))
    assert cfg.model == "gat" and cfg.fan_out == (8, 4)
    assert cfg.eta == 0.3 and cfg.exp3_delta == 0.02
    assert cfg.inference_backend == "hybrid"
    assert cfg.dp == 4 and cfg.shard_graph and cfg.shard_indptr is True


def _workload():
    """Three DP steps and three sharded steps over every rank of the
    group, from the same seeded state and the same host batches; the
    host helpers' slices too."""
    mesh = multihost.global_mesh(device="cpu")
    g, nc, ml = tdata.load_dataset("synth-small")
    g = tstruct.Graph.canonicalize(g)
    g.edata["w"] = tstruct.normalized_edata(g)
    local = GLOBAL_BATCH // mesh.size
    cfg = tsamp.SamplerConfig(kind="poisson-bandit", fanouts=(16, 8))
    plan = tblock.CapacityPlan.build(local, cfg.fanouts, g.n_nodes,
                                     g.n_edges, kind=cfg.kind)
    rng = np.random.default_rng(0)
    train_ids = np.where(g.ndata["train_mask"])[0]
    batches = [rng.choice(train_ids, GLOBAL_BATCH).astype(np.int32)
               for _ in range(3)]
    out = {"n_ranks": mesh.size,
           "slice": multihost.local_batch_slice(GLOBAL_BATCH),
           "seed_batch": multihost.global_seed_batch(mesh, batches[0]),
           "tree": multihost.global_tree(
               mesh, {"a": np.arange(8).reshape(2, 4), "b": [np.arange(4)]},
               {"a": (1,), "b": (0,)})}
    dg = tstruct.DeviceGraph.from_graph(g, device="cpu")
    sg = tss.ShardedDeviceGraph.build(g, mesh)
    for name, step, exp3 in (
            ("dp", tdp.make_dp_train_step(mesh, dg, cfg, plan, ml,
                                          exp3_normalize=False),
             tsamp.init_exp3_weights(2, g.n_edges, device="cpu")),
            ("shard", tss.make_sharded_train_step(mesh, sg, cfg, plan, ml),
             tss.init_exp3_shard(2, g.n_edges, mesh))):
        model = tgnn.build_model("sage", g.ndata["features"].shape[1], 16,
                                 nc, 2, device="cpu")
        opt, sched = tsteps.make_optimizer(model.parameters(), 0.01, 10)
        st = tsteps.TrainState(model, opt, sched, exp3, mesh.generator(0))
        losses = []
        for b in batches:
            st, m = step(st, torch.from_numpy(b),
                         torch.ones(GLOBAL_BATCH, dtype=torch.bool))
            losses.append(float(m["train_loss"]))
        exp3_all = mesh.all_gather(st.exp3_weights)
        out[name] = dict(
            step=st.step, losses=losses,
            params={k: v.detach().clone()
                    for k, v in model.state_dict().items()},
            exp3=(tss.unshard_exp3(exp3_all, 2, g.n_edges) if name == "shard"
                  else st.exp3_weights))
    return out


def _env_main():
    """A rank started from torchrun's environment (see ``_env_launch``)."""
    torch.set_num_threads(1)
    assert multihost.initialize("cpu")
    out = _workload()
    torch.save(out, os.environ["BLISS_TEST_OUT"] + f".{out['slice'].start}")
    torch.distributed.destroy_process_group()


def _env_launch(tmp_path, n):
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(n):
        env = dict(os.environ, WORLD_SIZE=str(n), RANK=str(r),
                   LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(n),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   PYTHONPATH=os.pathsep.join([ROOT, os.path.dirname(
                       os.path.abspath(__file__))]),
                   BLISS_TEST_OUT=str(tmp_path / "env"))
        procs.append(subprocess.Popen(
            [sys.executable, "-c",
             "import test_torch_multihost as m; m._env_main()"],
            env=env, cwd=str(tmp_path), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()  # a child this test started
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o.decode()[-4000:]
    per = GLOBAL_BATCH // n
    return [torch.load(str(tmp_path / "env") + f".{r * per}",
                       weights_only=False) for r in range(n)]


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("launch")
    filestore = multihost.run_ranks(_workload, 2, device="cpu",
                                    workdir=str(tmp / "filestore"))
    return filestore, _env_launch(tmp, 2)


def _same(a, b, key):
    assert a[key]["step"] == b[key]["step"] == 3
    assert a[key]["losses"] == b[key]["losses"]
    for k, v in a[key]["params"].items():
        assert torch.equal(v, b[key]["params"][k]), k
    assert torch.equal(a[key]["exp3"], b[key]["exp3"])


def test_multiprocess_distributed_dp(launches):
    """The DP step over ranks from a FileStore and over ranks from
    torchrun's environment: the same losses, parameters and arm weights;
    every rank the same."""
    filestore, env = launches
    for a, b in zip(filestore, env):
        assert a["n_ranks"] == b["n_ranks"] == 2
        _same(a, b, "dp")
        _same(a, filestore[0], "dp")
    assert all(np.isfinite(filestore[0]["dp"]["losses"]))


def test_multihost_single_process_degradation(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.initialize("cpu") is False  # single-process no-op
    assert not torch.distributed.is_initialized()
    sl = multihost.local_batch_slice(64)
    assert (sl.start, sl.stop) == (0, 64)  # one process owns everything
    mesh = multihost.global_mesh(device="cpu")
    try:
        assert mesh.size == 1 and mesh.rank == 0
        x = np.arange(12).reshape(3, 4)
        assert torch.equal(multihost.global_array(mesh, x, (1,)),
                           torch.from_numpy(x))
    finally:
        mesh.close()
    assert not torch.distributed.is_initialized()


def test_multiprocess_distributed_shard_graph(launches):
    """The sharded step (the distributed row gather and the owned EXP3
    update across real process boundaries), both launch paths; the host
    helpers give each rank its contiguous slice."""
    filestore, env = launches
    for r, (a, b) in enumerate(zip(filestore, env)):
        _same(a, b, "shard")
        _same(a, filestore[0], "shard")
        per = GLOBAL_BATCH // 2
        assert (a["slice"].start, a["slice"].stop) == (r * per,
                                                       (r + 1) * per)
        assert torch.equal(a["seed_batch"], b["seed_batch"])
        assert a["seed_batch"].shape == (per,)
        assert a["tree"]["a"].tolist() == np.arange(8).reshape(2, 4)[
            :, 2 * r:2 * r + 2].tolist()
        assert a["tree"]["b"][0].tolist() == [2 * r, 2 * r + 1]


def _teardown_worker():
    """A ``batch_isend_irecv`` ring (``Mesh.ppermute``) and the first Adam
    after the group exists, as a trainer rank runs them; at interpreter
    exit, after ``run_ranks``' teardown, the group must be held by nothing
    but this check, else the rank exits 3: a group left alive keeps gloo's
    threads running into exit, where the rank can abort."""
    import atexit

    import torch.distributed as dist

    from bliss_gnn_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(None, device="cpu")
    x = torch.arange(4.0) + 10 * mesh.rank
    for _ in range(mesh.size + 1):
        x = mesh.ppermute(x)
    torch.optim.Adam([torch.nn.Parameter(torch.ones(2))])
    world = [dist.group.WORLD]

    def held():
        # the list's reference and getrefcount's own argument
        if sys.getrefcount(world[0]) > 2:
            os._exit(3)

    atexit.register(held)
    return x


def test_gloo_teardown_releases_the_group(tmp_path):
    """``run_ranks``' teardown leaves no reference to the process group
    (so ``destroy_process_group`` joins gloo's threads) after a ring and an
    optimizer built inside the rank; each rank got its left neighbour's
    tensor."""
    out = multihost.run_ranks(_teardown_worker, 2, device="cpu",
                              workdir=str(tmp_path))
    for r, x in enumerate(out):
        assert torch.equal(x, torch.arange(4.0) + 10 * ((r + 1) % 2))


def test_cli_dp_starts_its_own_ranks(tmp_path):
    """``cli.main(["--dp", "2", ...])`` with no group running starts two
    ranks itself and returns rank 0's final F1s (graph sharding on)."""
    from bliss_gnn_tpu_torch.train import cli

    res = cli.main(["--platform", "cpu", "--dataset", "synth-small",
                    "--num-layers", "2", "--fan-out", "8,4",
                    "--batch-size", "16", "--num-steps", "3",
                    "--num-hidden", "8", "--logdir", str(tmp_path),
                    "--dp", "2", "--shard-graph", "--disable-checkpoint"])
    assert len(res) == 1
    for split in ("Train", "Validation", "Test"):
        assert 0.0 <= res[0][split] <= 1.0
    assert not torch.distributed.is_initialized()
