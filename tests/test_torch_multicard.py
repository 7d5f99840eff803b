"""The multi-card mode of ``chip_smoke.py`` (``--cards 4``) and the parallel
layer's choice of card and backend, on the CPU.

- the backend and card of a rank: NCCL and ``cuda:r`` for four ranks on
  four cards, gloo for two ranks on one card (``torch.cuda.device_count``
  patched); ``initialize`` makes the rank's card current before the NCCL
  group exists and hands it the card;
- ``multicard_phases``, the ``--cards`` worker, on gloo CPU ranks at a
  small size (groups of 1, 2 and 4 spawned ranks, 2 layers, narrow widths,
  2 counted steps): parameters, Adam state and DP arm weights bit-equal
  across the ranks after every step, K4 on the gathered list against its
  plain version, the sharded step's blocks equal to the DP step's, the
  ring inference within its bound of the one-device pass, and a scaling
  summary with finite values for S = 1, 2 and 4;
- ``--cards 4`` refusing before any work with fewer cards visible.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from bliss_gnn_tpu_torch.parallel import mesh as pmesh
from bliss_gnn_tpu_torch.parallel import multihost

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL_CFG = dict(n_feats=16, hidden=16, n_classes=4, gat_heads=(2, 1),
                 fanouts=(16, 8), batch=8, pilot_steps=2, counts=(2, 2, 1),
                 gat_counts=(1, 1, 1), gate=True)


@pytest.mark.parametrize("cards,ranks,backend,devices", [
    (4, 4, "nccl", ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]),
    (4, 2, "nccl", ["cuda:0", "cuda:1"]),
    (4, 1, "nccl", ["cuda:0"]),
    (1, 2, "gloo", ["cuda:0", "cuda:0"]),
    (1, 1, "nccl", ["cuda:0"]),
])
def test_backend_and_card_of_each_rank(monkeypatch, cards, ranks, backend,
                                       devices):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    dev = torch.device("cuda")
    per_card = pmesh.ranks_per_card(dev, ranks)
    assert pmesh.pick_backend(dev, per_card) == backend
    assert [str(pmesh.rank_device(dev, r, ranks))
            for r in range(ranks)] == devices


def test_cpu_ranks_run_gloo(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cpu = torch.device("cpu")
    assert pmesh.pick_backend(cpu, pmesh.ranks_per_card(cpu, 4)) == "gloo"
    assert pmesh.rank_device(cpu, 3, 4) == cpu


@pytest.mark.parametrize("cards,backend,set_first", [(4, "nccl", True),
                                                     (1, "gloo", False)])
def test_initialize_sets_the_card_before_the_group(monkeypatch, cards,
                                                   backend, set_first):
    """Rank 2 of 4: under NCCL its card is made current before
    ``init_process_group`` and handed to it as ``device_id``; under gloo
    (four ranks on one card) neither."""
    calls = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: calls.append(("set_device", str(d))))
    monkeypatch.setattr(
        multihost.dist, "init_process_group",
        lambda b, **kw: calls.append(("init", b, str(kw.get("device_id")))))
    monkeypatch.setattr(multihost.dist, "is_initialized", lambda: False)
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert multihost.initialize("cuda", store=object(), rank=2, world_size=4)
    if set_first:
        assert calls == [("set_device", "cuda:2"), ("init", backend, "cuda:2")]
    else:
        assert calls == [("init", backend, "None")]


def _small_csc(n=240, seed=3):
    """A skewed CSC: each dst's random in-edges, then its self-loop."""
    rng = np.random.default_rng(seed)
    deg = np.minimum(rng.zipf(1.7, n), 60)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg + 1, out=indptr[1:])
    src = rng.integers(0, n, int(indptr[-1])).astype(np.int32)
    src[indptr[1:] - 1] = np.arange(n, dtype=np.int32)
    return indptr, src


@pytest.fixture(scope="module")
def multicard_runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("multicard")
    indptr, src = _small_csc()
    np.save(d / "indptr.npy", indptr)
    np.save(d / "csc_src.npy", src)
    runs = chip_smoke.multicard_phases(torch, SMALL_CFG, str(d), "cpu")
    return runs, chip_smoke.multicard_scaling(torch, runs, "cpu")


def test_multicard_groups_run_gloo_ranks(multicard_runs):
    runs, _ = multicard_runs
    assert sorted(runs) == [1, 2, 4]
    for S, ranks in runs.items():
        assert [r["rank"] for r in ranks] == list(range(S))
        assert {r["backend"] for r in ranks} == {"gloo"}
        # the plan of the first group's pilot, handed to every group
        assert all(r["plan"] == runs[1][0]["plan"] for r in ranks)


def test_multicard_states_bit_equal_across_ranks(multicard_runs):
    """After every step (eager, replayed, the chain) the parameters and
    Adam's state, and the DP arm weights, are the same bits on every
    rank; the sharded step's replicated state too."""
    runs, _ = multicard_runs
    for S, ranks in runs.items():
        for r in ranks:
            for kind in ("dp", "sharded") + (("gat",) if S == 4 else ()):
                rec = r[kind]
                assert rec["replica_checks"] >= sum(SMALL_CFG["counts"])
                assert rec["replicas_unequal"] == []


def test_multicard_k4_against_plain_on_the_gathered_list(multicard_runs):
    """K4's update of the DP arm weights against ``exp3_apply_plain`` on
    the same gathered list; at S > 1 the list goes to the repeats route."""
    runs, _ = multicard_runs
    for S, ranks in runs.items():
        for r in ranks:
            plain = r["dp"]["k4_vs_plain"]
            assert len(plain) == SMALL_CFG["counts"][2]
            for p in plain:
                assert p["bitwise"] and p["max_ulps"] == 0.0
                assert p["distinct"] == (S == 1)
                assert p["slots"] == S * (p["slots"] // S)


def test_multicard_sharded_blocks_equal_dp_blocks(multicard_runs):
    runs, _ = multicard_runs
    for ranks in runs.values():
        for r in ranks:
            assert all(e["blocks_equal"]
                       for e in r["sharded"]["eager_vs_dp"])
            assert all(e["counts_equal"]
                       for e in r["sharded"]["replayed_vs_dp"])


def test_multicard_ring_inference_within_bound(multicard_runs):
    runs, _ = multicard_runs
    for r in runs[4]:
        assert [m["model"] for m in r["inference"]] == ["sage", "gat"]
        for m in r["inference"]:
            assert m["finite"] and m["ranks"] == 4
            assert m["max_abs_err"] <= 1e-2 * m["max_abs_logit"]


def test_multicard_scaling_summary_is_finite(multicard_runs):
    _, summary = multicard_runs
    for kind in ("dp", "sharded"):
        s = summary[kind]
        assert sorted(s["replayed_step_ms"]) == [1, 2, 4]
        assert sorted(s["dp_weak_scaling_pct"]) == [2, 4]
        for key in ("replayed_step_ms", "chained_step_ms",
                    "dp_weak_scaling_pct", "sampled_edges_per_s"):
            assert all(np.isfinite(v) and v > 0 for v in s[key].values())
        # one all-gather and two all-reduces at least at every S
        assert all(n >= 3 for n in
                   s["collectives_per_step_per_rank"].values())
    # a rank's range shards shrink with S; the DP step's replicas do not
    sharded = summary["sharded"]["storage_bytes_per_rank"]
    assert sharded[4] < sharded[2] < sharded[1]
    assert len(set(summary["dp"]["storage_bytes_per_rank"].values())) == 1


def test_cards_4_refuses_without_a_card():
    """The script with no card: exits non-zero and prints no result."""
    res = subprocess.run([sys.executable, "chip_smoke.py", "--cards", "4"],
                         cwd=ROOT, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_cards_4_refuses_on_one_card_before_any_work(monkeypatch, capsys):
    """One card visible: ``--cards 4`` fails before it builds, queries or
    spawns anything."""
    from bliss_gnn_tpu_torch.ops import _build

    def work(*a, **k):
        raise AssertionError("work started on too few cards")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(_build, "build_all", work)
    monkeypatch.setattr(chip_smoke.subprocess, "run", work)
    monkeypatch.setattr(chip_smoke, "reddit_shaped_csc", work)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(["--cards", "4"])
    assert exc.value.code != 0
    assert "1 card(s) visible" in capsys.readouterr().err
