#!/usr/bin/env python3
"""Times or probes the hand-written kernels of the ``bliss_gnn_tpu_torch``
that Python finds on its path, so that two checkouts of the port can be
compared on one NVIDIA GPU, each in a process of its own:

    PYTHONPATH=<checkout> python3 tools/kernel_probe.py KERNEL [KERNEL ...]

KERNEL is one of:

    k1  K1 (``scatter_add``) at chip_smoke.py's main-path call sites on an
        H100: the importance sum (unsorted: 3,279,616 random keys, 80%
        valid, into 233,088), and, on the ids of one sampled layer-0 block
        and its frontier, the per-dst block sums (sorted ``e_dst``) and the
        frontier chunk sums (sorted chunk owners); a checkout whose K1 has
        the sorted route (``ids_sorted``) takes it. Beside them the atomic
        ceiling of the unsorted shape (``tools/k1_atomic_ceiling.cu``: the
        same red.global.add.f32s with no payload loads, to K1's addresses
        and to hashed ones) and ``index_add_``.
    k3  K3 (``segment_sum``) at the main path's shapes on the same sampled
        blocks: the aggregations by dst (sorted) at F = 256 (layer 0) and
        F = 41 (the output layer), the gather backwards by src (unsorted)
        into the src caps, and run M's uniform sorted ids (150,016 rows,
        90,009 valid, into 3,712); beside each ``index_add_``.
    k5  K5 (``row_scatter_add``) at the GATv2 layer-0 shapes: 150,016 x
        1024 bf16 rows into the 3,712-row dst cap by sorted ids and into
        the 8,064-row src cap by unsorted ids, on run M's uniform ids
        (90,009 valid) and on the sampled block's ``e_dst``/``e_src``; bf16
        and f32 outputs (a checkout without ``out_dtype`` returns f32, cast
        after the call as its ``masked_segment_sum`` did), K3's sorted route
        on the sorted inputs and ``index_add_`` beside them. Where the
        checkout's K5 has a sorted route it takes it; where it has
        ``TILE_ROWS`` the probe also times tiles of 32 to 256 rows, and the
        unsorted route at F = 8 (the counting sort with almost no payload).
    k6-hub  K6 on the inputs of ``tests/test_torch_cuda.py``'s
        ``test_spmm_kernel`` cases and the column-slice test (a hub row of
        30,000 edges): over 50 calls of the plain version, how often and
        by how much the kernel misses the test's tolerance, with the
        payload drawn as before the test's repair (``randn``) and after it
        (``exact``: multiples of 1/64, weights of 1/8).
    gat-step  the fused GATv2 step of ``chip_smoke.py``'s ``gat_path``
        (hidden 256, heads 4/4/1) on the Reddit-shaped graph and the caps
        below, fresh weights and arm weights from fixed seeds, so that two
        checkouts sample the same blocks: the median wall time of 10 steps
        after 3, then ``torch.profiler`` over 3 more: the device time per
        step, K5's kernels' share of it (by kernel name) and the largest
        kernels; then one step profiled with Python stacks, which names
        the op, the autograd node and the forward frames in the package
        that launch each ``indexing_backward`` kernel.
    k2  K2 (``lut_gather``), the keep-mask lookup of the input-most layer
        of ``chip_smoke.py``'s SAGE main path on an H100: 3,279,616 ids
        (80% valid) into a 233,088-entry bool table; beside it
        ``torch.take``.
    k4  K4 (``exp3_apply``), one step's arm-weight update: 186,496 slots of
        distinct indices (30% no-op) into 3 x (114,848,857 + EDGE_PAD) bf16
        weights; beside it ``scatter_reduce_`` and the host time of K4's C
        entry called straight through ctypes with its arguments ready, the
        floor under any wrapper that launches through ctypes.
    k6  K6 (``spmm``) at F = 256 and 41 on ``chip_smoke.py``'s
        Reddit-shaped graph (232,965 nodes, 114.8M edges; its arrays are
        kept in ``build/`` after the first run).
    k6-602  K6 at ``bench_torch.py``'s headline shape (F = 602 f32 with
        edge weights) on that graph, beside it unweighted, padded to 608
        columns and at F = 256 f32 weighted.
    k7  K7 (``gat_attention``) at (H, O) = (4, 256) and (1, 41) on that
        graph.
    k4-repeats  K4 on the inputs of ``tests/test_torch_cuda.py``'s
        ``test_exp3_apply_kernel`` (the same seed and draws): how often
        each index repeats, and over 200 calls which entries differ from
        the plain version by more than the test's rtol of 2^-7, by how many
        bf16 ulps, and how often each index repeats there. For each entry
        updated m = 2 to 4 times it also applies the m factors in every
        order with one bf16 rounding after each, as the kernel does in
        whatever order the card takes them, and counts the entries for
        which some order lands more than 2^-7 from the plain version.
        Then the repeats route at the DP step's S = 4 size (four ranks'
        lists of one step's caps gathered; ``repeats_routes``): ``ms``,
        ``device_ms`` and ``host_us`` of the checkout's route, and of the
        sorted route it replaced where the checkout keeps it, with their
        bits compared.

The K1/K3/K5 inputs come from one ``sample_blocks`` step on the final plan of
chip_smoke.py's runs (the caps below) with fresh arm weights, cached in
``build/`` by the first process so that every process times the same ids.
K1 and K3 print ``ms`` and ``device_ms``. K2 and K4 print ``ms`` (CUDA events around 20 back-to-back calls),
``device_ms`` (20 calls captured in a CUDA graph, replayed 10 times) and
``host_us`` (1,000 calls with no sync). K6 and K7 print ``ms`` and
``device_ms`` (fewer calls: they take milliseconds), the kernel launches per
wrapper call (the wrapper's launch count before and after one call), and
the largest difference from the plain version on a CSC prefix of >= 4M
edges. Their L2 probe times K6 at F = 256 and K7 at (4, 256) again with
every src id taken modulo 16,384, so the rows they read (8 MB and 32 MB)
fit in the 50 MB L2. Where the checkout's K6 cuts columns into L2 slices
(``spmm_plan``) the probe also times slices of 32 to 256 columns, and where
its K7 splits a dst's edges over warps (``gat_plan``) 1 to 8 splits per
head, as many as the block's 8 warps hold. The timing functions are
``chip_smoke.py``'s. One JSON line.
"""
import ctypes
import dataclasses
import importlib.util
import inspect
import itertools
import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
M, N_CAND, N_NODES = 3_279_616, 233_088, 232_965
BLOCK_E_CAPS, N_EDGES = (150_016, 31_872, 4_608), 114_848_857
FRONTIER_CAPS = (3_279_616, 1_291_648, 243_456)


def smoke_module():
    """``chip_smoke.py`` of the checkout this script lies in, imported as
    a module for its graph and timing functions. Its ``harness_torch``
    is found after the path's entries, so the package stays the path's."""
    if str(ROOT) not in sys.path:
        sys.path.append(str(ROOT))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def small_times(smoke, fn, host=True):
    t = {"ms": smoke.time_ms(fn, 20, torch),
         "device_ms": smoke.device_time_ms(fn, torch)}
    if host:
        t["host_us"] = smoke.host_us(fn, torch)
    return t


def large_times(smoke, fn, reps):
    return {"ms": smoke.time_ms(fn, reps, torch, warmup=1),
            "device_ms": smoke.device_time_ms(fn, torch, reps=reps,
                                              replays=2)}


def probe_k2(smoke, dev):
    from bliss_gnn_tpu_torch.ops.gather import lut_gather

    g = torch.Generator(device=dev).manual_seed(7)
    nv = torch.tensor(int(0.8 * M), dtype=torch.int32, device=dev)
    keys = torch.randint(0, N_NODES, (M,), generator=g, device=dev,
                         dtype=torch.int32)
    lut = torch.rand(N_CAND, generator=g, device=dev) < 0.3
    keys64 = keys.long()
    return {"lut_gather": small_times(smoke, lambda: lut_gather(lut, keys, nv)),
            "torch.take": small_times(smoke,
                                      lambda: torch.take(lut, keys64))}


def probe_k4(smoke, dev):
    from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD
    from bliss_gnn_tpu_torch.ops import _build
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply

    g = torch.Generator(device=dev).manual_seed(7)
    span = N_EDGES + EDGE_PAD
    limit = len(BLOCK_E_CAPS) * span
    u = sum(BLOCK_E_CAPS)
    idx = torch.cat([
        torch.randperm(N_EDGES, generator=g, device=dev)[:c] + l * span
        for l, c in enumerate(BLOCK_E_CAPS)]).to(torch.int32)
    idx = torch.where(torch.rand(u, generator=g, device=dev) < 0.3,
                      torch.full_like(idx, limit), idx)
    mult = torch.exp(torch.rand(u, generator=g, device=dev) * 0.5)
    state = (torch.rand(limit, generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    valid = idx < limit
    idx_v, mult_v = idx[valid].long(), mult[valid].to(torch.bfloat16)
    c_entry = _build.load("exp3_apply").bliss_exp3_apply
    c_args = (state.data_ptr(), idx.data_ptr(), mult.data_ptr(), u, limit,
              torch.cuda.current_stream().cuda_stream)
    return {
        "exp3_apply": small_times(
            smoke, lambda: exp3_apply(state, idx, mult, limit)),
        "scatter_reduce_": small_times(
            smoke, lambda: state.scatter_reduce_(0, idx_v, mult_v, "prod")),
        "exp3_apply_c_entry_host_us": smoke.host_us(
            lambda: c_entry(*c_args), torch),
    }


def bf16_ulp(x):
    """One bf16 ulp at each value of the bf16 tensor ``x``."""
    _, e = torch.frexp(x.float())  # |x| in [2^(e-1), 2^e)
    return torch.ldexp(torch.ones_like(x, dtype=torch.float32), e - 8)


def probe_k4_repeats(smoke, dev, calls=200):
    from bliss_gnn_tpu_torch.ops.exp3 import exp3_apply, exp3_apply_plain

    # test_exp3_apply_kernel's inputs, drawn in its order from its seed
    gen = torch.Generator(device=dev).manual_seed(0)
    limit = 1 << 20
    idx = torch.randint(0, limit, (30_000,), generator=gen, device=dev,
                        dtype=torch.int32)
    idx[:5000] = idx[5000:10_000]
    idx[-3000:] = limit
    mult = torch.exp(torch.rand(30_000, generator=gen, device=dev) * 0.5)
    state0 = (torch.rand(limit, generator=gen, device=dev) + 0.5).to(
        torch.bfloat16)
    ref = state0.clone()
    exp3_apply_plain(ref, idx, mult, limit)
    live = idx < limit
    m = torch.zeros(limit, dtype=torch.int64, device=dev)
    m.index_add_(0, idx[live].long(), torch.ones_like(idx[live].long()))
    hist = torch.bincount(m)
    ulp = bf16_ulp(ref)

    def fails(got):  # the test's criterion: |got - ref| > 2^-7 |ref|
        return (got.float() - ref.float()).abs() > 2.0 ** -7 * ref.float().abs()

    fail_calls, fail_m, gaps, examples = 0, {}, {}, []
    for _ in range(calls):
        st = state0.clone()
        exp3_apply(st, idx, mult, limit)
        bad = fails(st).nonzero().flatten()
        gap = ((st.float() - ref.float()).abs() / ulp).round().long()
        for k in m.unique().tolist():
            if k > 0:
                sel = m == k
                gaps[k] = max(gaps.get(k, 0), int(gap[sel].max()))
        if bad.numel():
            fail_calls += 1
            for e in bad.tolist():
                fail_m[int(m[e])] = fail_m.get(int(m[e]), 0) + 1
                if len(examples) < 5:
                    examples.append({
                        "entry": e, "m": int(m[e]),
                        "state": float(state0[e]),
                        "factors": mult[idx == e].tolist(),
                        "kernel": float(st[e]), "plain": float(ref[e]),
                        "ulp_gap": int(gap[e])})

    # every order of each entry's m factors, one bf16 rounding after each
    idx_l = idx[live].long()
    mult_l = mult[live]
    order_fail, order_gap = {}, {}
    for k in (2, 3, 4):
        entries = (m == k).nonzero().flatten()
        if not entries.numel():
            continue
        # the factors of each entry, in slot order: [entries, k]
        pos = torch.searchsorted(entries, idx_l)
        hit = (pos < entries.numel()) & (
            entries[pos.clamp(max=entries.numel() - 1)] == idx_l)
        ent_of = pos[hit]
        fac = mult_l[hit]
        order = torch.sort(ent_of, stable=True).indices
        fac = fac[order].reshape(-1, k)
        start = state0[entries]
        want = ref[entries]
        worst = torch.zeros(entries.numel(), dtype=torch.bool, device=dev)
        gmax = torch.zeros(entries.numel(), device=dev)
        for perm in itertools.permutations(range(k)):
            v = start
            for j in perm:
                v = (v.float() * fac[:, j]).to(torch.bfloat16)
            d = (v.float() - want.float()).abs()
            worst |= d > 2.0 ** -7 * want.float().abs()
            gmax = torch.maximum(gmax, d / bf16_ulp(want))
        order_fail[k] = f"{int(worst.sum())} of {entries.numel()}"
        order_gap[k] = int(gmax.round().max())
    return {
        "repeats_routes": repeats_routes(smoke, dev),
        "entries_by_times_updated": {str(k): int(c) for k, c in
                                     enumerate(hist.tolist()) if k > 0},
        "calls": calls, "calls_failing_the_test": fail_calls,
        "failing_entries_by_m": {str(k): v for k, v in
                                 sorted(fail_m.items())},
        "max_ulp_gap_by_m": {str(k): v for k, v in sorted(gaps.items())},
        "examples": examples,
        "entries_some_order_fails_by_m": {str(k): v for k, v in
                                          order_fail.items()},
        "max_ulp_gap_any_order_by_m": {str(k): v for k, v in
                                       order_gap.items()},
    }


def repeats_routes(smoke, dev, n_ranks=4):
    """K4's repeats route at the DP step's S = 4 size: four ranks' lists
    of one step's caps (each rank's live ids distinct, 30% no-op), drawn
    from a shared pool so that an id repeats up to 4 times, gathered layer
    by layer in rank order. Times the checkout's repeats route (the
    group-by with ``max_repeats``; a tree without it: ``distinct=False``,
    the sorted route) and, where the checkout keeps it, the sorted route
    beside it, with their bits compared."""
    from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD
    from bliss_gnn_tpu_torch.ops import exp3 as k4

    g = torch.Generator(device=dev).manual_seed(9)
    span = N_EDGES + EDGE_PAD
    limit = len(BLOCK_E_CAPS) * span
    parts = []
    for l, c in enumerate(BLOCK_E_CAPS):
        pool = torch.randperm(N_EDGES, generator=g, device=dev)[:2 * c]
        for _ in range(n_ranks):
            ids = pool[torch.randperm(2 * c, generator=g, device=dev)[:c]]
            ids = torch.where(torch.rand(c, generator=g, device=dev) < 0.3,
                              limit - l * span, ids)
            parts.append(ids + l * span)
    idx = torch.cat(parts).to(torch.int32)
    u = idx.numel()
    mult = torch.exp(torch.rand(u, generator=g, device=dev) * 0.5)
    state0 = (torch.rand(limit, generator=g, device=dev) + 0.5).to(
        torch.bfloat16)
    live = idx[idx < limit].long()
    cnt = torch.unique(live, return_counts=True)[1]
    if "max_repeats" in inspect.signature(k4.exp3_apply).parameters:
        kw = {"max_repeats": n_ranks}
    else:
        kw = {"distinct": False}
    st = state0.clone()
    out = {"slots": u, "valid": int(live.numel()),
           "entries": int(cnt.numel()), "max_repeats": int(cnt.max()),
           "route": kw, "repeats_route": small_times(
               smoke, lambda: k4.exp3_apply(st, idx, mult, limit, **kw)),
           "repeats_route_device_us": smoke.device_breakdown(
               lambda: k4.exp3_apply(st, idx, mult, limit, **kw), torch)}
    if hasattr(k4, "exp3_apply_sorted_runs"):
        a, b = state0.clone(), state0.clone()
        k4.exp3_apply(a, idx, mult, limit, **kw)
        k4.exp3_apply_sorted_runs(b, idx, mult, limit)
        out["bitwise_equal_to_sorted_route"] = torch.equal(a, b)
        out["sorted_route"] = small_times(
            smoke, lambda: k4.exp3_apply_sorted_runs(st, idx, mult, limit))
        out["sorted_route_device_us"] = smoke.device_breakdown(
            lambda: k4.exp3_apply_sorted_runs(st, idx, mult, limit), torch)
    return out


def graph_arrays(smoke):
    cache = ROOT / "build" / "reddit_shaped_csc_seed0.npz"
    if cache.exists():
        z = np.load(cache)
        return z["indptr"], z["src"]
    indptr, src = smoke.reddit_shaped_csc()
    cache.parent.mkdir(parents=True, exist_ok=True)
    np.savez(cache, indptr=indptr, src=src)
    return indptr, src


class FullGraph:
    """The Reddit-shaped CSC arrays on the card, the same with src ids
    modulo 16,384 (the L2 probe), and a >= 4M-edge CSC prefix."""

    def __init__(self, smoke, dev):
        indptr_np, src_np = graph_arrays(smoke)
        self.n = indptr_np.shape[0] - 1
        self.n_edges = n_edges = int(src_np.shape[0])
        self.ip = torch.from_numpy(indptr_np.astype(np.int32)).to(dev)
        self.src = torch.zeros(n_edges + 128, dtype=torch.int32, device=dev)
        self.src[:n_edges] = torch.from_numpy(src_np).to(dev)
        self.src_l2 = self.src % 16384
        self.k = int(np.searchsorted(indptr_np, smoke.PREFIX_EDGES))
        self.pip = self.ip.clone()
        self.pip[self.k:] = int(indptr_np[self.k])


def call_sites(smoke, dev, fg):
    """chip_smoke.py's ``call_site_inputs`` on the Reddit-shaped graph and
    the final plan of its runs, fresh arm weights, from the first process's
    cache when there is one."""
    cache = ROOT / "build" / "k1_k3_call_sites.pt"
    if not cache.exists():
        from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD, DeviceGraph
        from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
        from bliss_gnn_tpu_torch.sampling.samplers import (
            SamplerConfig,
            init_exp3_weights,
        )

        deg = (fg.ip[1:] - fg.ip[:-1]).long()
        w = torch.zeros(fg.n_edges + EDGE_PAD, dtype=torch.bfloat16,
                        device=dev)
        w[:fg.n_edges] = (1.0 / deg.clamp(min=1).float()).repeat_interleave(
            deg, output_size=fg.n_edges).to(torch.bfloat16)
        dummy = torch.zeros(1, dtype=torch.int32, device=dev)
        graph = DeviceGraph(csc_indptr=fg.ip, csc_src=fg.src,
                            csr_indptr=dummy, csr_dst=dummy, csr_eid=dummy,
                            ndata={}, edata={"w": w}, n_nodes=fg.n,
                            n_edges=fg.n_edges)
        cfg = SamplerConfig(kind="poisson-bandit", fanouts=smoke.FANOUTS)
        plan = dataclasses.replace(
            CapacityPlan.build(smoke.BATCH, smoke.FANOUTS, fg.n, fg.n_edges,
                               kind=cfg.kind, dense_candidates=True),
            frontier_caps=FRONTIER_CAPS, block_e_caps=BLOCK_E_CAPS)
        seeds = torch.from_numpy(np.random.default_rng(0).integers(
            0, fg.n, smoke.BATCH).astype(np.int32)).to(dev)
        smask = torch.ones(smoke.BATCH, dtype=torch.bool, device=dev)
        sites = smoke.call_site_inputs(
            torch, graph, cfg, plan,
            init_exp3_weights(len(smoke.FANOUTS), fg.n_edges, device=dev),
            seeds, smask)
        torch.save({k: v.cpu() if isinstance(v, torch.Tensor) else v
                    for k, v in sites.items()}, cache)
        del graph, w
    sites = torch.load(cache)
    return {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in sites.items()}


def sorted_kw(wrapper):
    """``ids_sorted=True`` where the checkout's wrapper has that route."""
    return ({"ids_sorted": True}
            if "ids_sorted" in inspect.signature(wrapper).parameters else {})


def prefix_vals(g, dev, n, nv):
    return torch.where(torch.arange(n, device=dev) < nv,
                       torch.rand(n, generator=g, device=dev), 0.0)


def ceiling_lib():
    """``tools/k1_atomic_ceiling.cu``, built once per checkout of the tools
    with the package's nvcc and flags."""
    from bliss_gnn_tpu_torch.ops import _build

    src = ROOT / "tools" / "k1_atomic_ceiling.cu"
    out = ROOT / "build" / "libk1_atomic_ceiling.so"
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                        str(out), str(src)], check=True)
    lib = ctypes.CDLL(str(out))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.k1_atomic_ceiling.argtypes = [i, p, p, ctypes.c_longlong, p, i, p]
    lib.k1_atomic_ceiling.restype = i
    return lib


def probe_k1(smoke, dev, sites):
    from bliss_gnn_tpu_torch.ops.scatter import scatter_add

    g = torch.Generator(device=dev).manual_seed(7)
    nv = int(0.8 * M)
    nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
    keys = torch.randint(0, N_NODES, (M,), generator=g, device=dev,
                         dtype=torch.int32)
    vals = prefix_vals(g, dev, M, nv)
    lib_out = torch.zeros(N_CAND, device=dev)
    keys64 = keys.long()
    rec = {"scatter_add[unsorted: importance sum]": {
        **small_times(smoke, lambda: scatter_add(keys, vals, N_CAND, nv_d),
                      host=False),
        "index_add_device_ms": smoke.device_time_ms(
            lambda: lib_out.index_add_(0, keys64, vals), torch)}}
    lib = ceiling_lib()
    for kind, name in ((0, "keys"), (1, "hash")):
        def ceiling(kind=kind):
            err = lib.k1_atomic_ceiling(
                kind, keys.data_ptr(), lib_out.data_ptr(), M, nv_d.data_ptr(),
                N_CAND, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"k1_atomic_ceiling: CUDA error {err}")
        rec[f"atomic_ceiling[{name}]"] = {
            "device_ms": smoke.device_time_ms(ceiling, torch)}
    kw = sorted_kw(scatter_add)
    for site, k, n_out, nvs in (
            ("block e_dst", sites["e_dst0"], sites["n_dst0"], sites["nv0"]),
            ("chunk owners", sites["owner0"], sites["n_dst0"],
             sites["n_chunks0"])):
        v = prefix_vals(g, dev, k.shape[0], nvs)
        nvs_d = torch.tensor(nvs, dtype=torch.int32, device=dev)
        k64 = k.long()
        out = torch.zeros(n_out, device=dev)
        rec[f"scatter_add[sorted: {site}]"] = {
            **small_times(smoke,
                          lambda: scatter_add(k, v, n_out, nvs_d, **kw),
                          host=False),
            "index_add_device_ms": smoke.device_time_ms(
                lambda: out.index_add_(0, k64, v), torch),
            "sorted_route": bool(kw),
            "shape": f"{k.shape[0]} keys ({nvs} valid) into {n_out}"}
    return rec


def probe_k3(smoke, dev, sites):
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum

    g = torch.Generator(device=dev).manual_seed(8)
    kw = sorted_kw(segment_sum)
    e0 = BLOCK_E_CAPS[0]
    uniform = torch.sort(torch.randint(0, sites["n_dst0"], (e0,), generator=g,
                                       device=dev, dtype=torch.int32)).values
    cases = [("sorted, F=256: uniform ids, run M's inputs", uniform,
              sites["n_dst0"], int(0.6 * e0), 256)]
    for tag, f in (("0", 256), ("out", 41)):
        where = "layer 0" if tag == "0" else "output layer"
        cases += [
            (f"sorted, F={f}: aggregation {where}", sites[f"e_dst{tag}"],
             sites[f"n_dst{tag}"], sites[f"nv{tag}"], f),
            (f"unsorted, F={f}: gather backward {where}", sites[f"e_src{tag}"],
             sites[f"n_src{tag}"], sites[f"nv{tag}"], f)]
    rec = {}
    for name, ids, n_out, nv, f in cases:
        e = ids.shape[0]
        data = torch.randn((e, f), generator=g, device=dev).to(torch.bfloat16)
        data[nv:] = 0
        nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
        extra = kw if name.startswith("sorted") else {}
        out = torch.zeros((n_out, f), device=dev, dtype=torch.bfloat16)
        ids64 = ids.long()
        rec[f"segment_sum[{name}]"] = {
            **small_times(smoke,
                          lambda: segment_sum(data, ids, n_out, nv_d, **extra),
                          host=False),
            "index_add_device_ms": smoke.device_time_ms(
                lambda: out.index_add_(0, ids64, data), torch),
            "sorted_route": bool(extra),
            "shape": f"{e} x {f} bf16 ({nv} valid) into {n_out}"}
        del data, out
    return rec


def probe_k5(smoke, dev, sites):
    from bliss_gnn_tpu_torch.ops import rowscatter
    from bliss_gnn_tpu_torch.ops.rowscatter import row_scatter_add
    from bliss_gnn_tpu_torch.ops.segsum import segment_sum

    g = torch.Generator(device=dev).manual_seed(8)
    params = inspect.signature(row_scatter_add).parameters
    has_sorted, has_dtype = "ids_sorted" in params, "out_dtype" in params
    e0, f = BLOCK_E_CAPS[0], 1024
    n_dst, n_src = sites["n_dst0"], sites["n_src0"]
    uni = int(0.6 * e0)
    cases = [
        ("sorted: uniform ids, run M's inputs", torch.sort(torch.randint(
            0, n_dst, (e0,), generator=g, device=dev,
            dtype=torch.int32)).values, n_dst, uni, True),
        ("sorted: block e_dst", sites["e_dst0"], n_dst, sites["nv0"], True),
        ("unsorted: uniform ids, run M's inputs", torch.randint(
            0, n_src, (e0,), generator=g, device=dev, dtype=torch.int32),
         n_src, uni, False),
        ("unsorted: block e_src", sites["e_src0"], n_src, sites["nv0"],
         False)]
    rec = {}
    for name, ids, n_out, nv, ordered in cases:
        e = ids.shape[0]
        data = torch.randn((e, f), generator=g, device=dev).to(torch.bfloat16)
        data[nv:] = 0
        nv_d = torch.tensor(nv, dtype=torch.int32, device=dev)
        kw = {"ids_sorted": True} if ordered and has_sorted else {}

        def call(out_dtype, kw=kw):
            if has_dtype:
                return row_scatter_add(data, ids, n_out, nv_d,
                                       out_dtype=out_dtype, **kw)
            out = row_scatter_add(data, ids, n_out, nv_d, **kw)
            return out if out_dtype == torch.float32 else out.to(out_dtype)

        before = row_scatter_add.launches
        call(torch.bfloat16)
        r = {"launches_per_call": row_scatter_add.launches - before,
             "sorted_route": bool(kw), "out_dtype_arg": has_dtype,
             "shape": f"{e} x {f} bf16 ({nv} valid) into {n_out}"}
        for tag, dt in (("bf16_out", torch.bfloat16),
                        ("f32_out", torch.float32)):
            r[tag] = small_times(smoke, lambda dt=dt: call(dt), host=False)
        if has_dtype and ordered:
            r["repeat_bitwise"] = bool(torch.equal(call(torch.bfloat16),
                                                   call(torch.bfloat16)))
        if hasattr(rowscatter, "TILE_ROWS"):
            kept = rowscatter.TILE_ROWS
            for rows in (r for r in (32, 64, 128, 256) if r != kept):
                rowscatter.TILE_ROWS = rows
                r[f"bf16_out_tile_{rows}"] = small_times(
                    smoke, lambda: call(torch.bfloat16), host=False)
            rowscatter.TILE_ROWS = kept
        if ordered:
            r["segment_sum_sorted_device_ms"] = smoke.device_time_ms(
                lambda: segment_sum(data, ids, n_out, nv_d,
                                    **sorted_kw(segment_sum)), torch)
        else:
            d8 = torch.zeros((e, 8), device=dev, dtype=torch.bfloat16)
            if has_dtype:
                r["f8_device_ms"] = smoke.device_time_ms(
                    lambda: row_scatter_add(d8, ids, n_out, nv_d,
                                            out_dtype=torch.bfloat16), torch)
            del d8
        out = torch.zeros((n_out, f), device=dev, dtype=torch.bfloat16)
        ids64 = ids.long()
        r["index_add_device_ms"] = smoke.device_time_ms(
            lambda: out.index_add_(0, ids64, data), torch)
        if not ordered:  # how often the busiest key repeats
            live = ids[:nv].long()
            r["max_key_repeats"] = int(torch.bincount(
                live[(live >= 0) & (live < n_out)], minlength=1).max())
        rec[f"row_scatter_add[{name}]"] = r
        del data, out
    return rec


# K5's kernels by name: this design's and the first one's (an earlier tree)
K5_KERNELS = ("rowsum_tiles_kernel", "rowsum_fold_kernel", "count_scan_kernel",
              "place_kernel", "order_kernel", "row_scatter_kernel")


def probe_gat_step(smoke, dev, fg, n=3):
    from torch.profiler import ProfilerActivity, profile

    from bliss_gnn_tpu_torch.graph.structure import EDGE_PAD, DeviceGraph
    from bliss_gnn_tpu_torch.models.gnn import build_model
    from bliss_gnn_tpu_torch.sampling.block import CapacityPlan
    from bliss_gnn_tpu_torch.sampling.samplers import (
        SamplerConfig,
        init_exp3_weights,
    )
    from bliss_gnn_tpu_torch.train.steps import (
        TrainState,
        make_optimizer,
        make_train_step,
    )

    gen = torch.Generator(device=dev).manual_seed(0)
    deg = (fg.ip[1:] - fg.ip[:-1]).long()
    w = torch.zeros(fg.n_edges + EDGE_PAD, dtype=torch.bfloat16, device=dev)
    w[:fg.n_edges] = (1.0 / deg.clamp(min=1).float()).repeat_interleave(
        deg, output_size=fg.n_edges).to(torch.bfloat16)
    graph = DeviceGraph(
        csc_indptr=fg.ip, csc_src=fg.src,
        csr_indptr=smoke.out_indptr(fg.src[:fg.n_edges], fg.n),
        csr_dst=fg.ip[:1], csr_eid=fg.ip[:1],
        ndata={"features": torch.randn((fg.n, smoke.N_FEATS), generator=gen,
                                       device=dev, dtype=torch.bfloat16),
               "labels": torch.randint(0, smoke.N_CLASSES, (fg.n,),
                                       generator=gen, device=dev)},
        edata={"w": w}, n_nodes=fg.n, n_edges=fg.n_edges)
    cfg = SamplerConfig(kind="poisson-bandit", fanouts=smoke.FANOUTS,
                        model="gat")
    plan = dataclasses.replace(
        CapacityPlan.build(smoke.BATCH, smoke.FANOUTS, fg.n, fg.n_edges,
                           kind=cfg.kind, dense_candidates=True),
        frontier_caps=FRONTIER_CAPS, block_e_caps=BLOCK_E_CAPS)
    model = build_model("gat", smoke.N_FEATS, smoke.HIDDEN, smoke.N_CLASSES,
                        len(smoke.FANOUTS), num_in_heads=smoke.GAT_HEADS[0],
                        num_out_heads=smoke.GAT_HEADS[1], device=dev, seed=2)
    opt, sched = make_optimizer(model.parameters(), 2e-3, 100)
    state = TrainState(model, opt, sched,
                       init_exp3_weights(len(smoke.FANOUTS), fg.n_edges,
                                         device=dev),
                       torch.Generator(device=dev).manual_seed(2))
    step = make_train_step(graph, cfg, plan, False, device=dev)
    seeds = torch.from_numpy(np.random.default_rng(0).integers(
        0, fg.n, smoke.BATCH).astype(np.int32)).to(dev)
    smask = torch.ones(smoke.BATCH, dtype=torch.bool, device=dev)
    times = []
    for _ in range(13):
        t0 = time.perf_counter()
        state, m = step(state, seeds, smask)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            state, m = step(state, seeds, smask)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        if (not str(evt.device_type).endswith("CUDA")
                or getattr(evt, "is_user_annotation", False)):
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = evt.self_cuda_time_total
        rows.append((us / n / 1e3, evt.count / n, evt.key))
    rows.sort(reverse=True)
    k5 = [r for r in rows if any(k in r[2] for k in K5_KERNELS)]
    # one more step with Python stacks: which ops launch the index backwards
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=True, record_shapes=True) as prof:
        state, _ = step(state, seeds, smask)
        torch.cuda.synchronize()
    idx = [r for r in rows if "indexing_backward" in r[2]]
    return {"gat_step": {
        "gat_step_ms": statistics.median(times[3:]),
        "loss": float(m["train_loss"]),
        "device_ms_per_step": sum(r[0] for r in rows),
        "device_ops_per_step": sum(r[1] for r in rows),
        "k5_device_ms_per_step": sum(r[0] for r in k5),
        "k5_kernels_per_step": sum(r[1] for r in k5),
        "k5": [{"ms": a, "calls": c, "name": k[:80]} for a, c, k in k5],
        "top": [{"ms": a, "calls": c, "name": k[:80]}
                for a, c, k in rows[:8]],
        "indexing_backward_device_ms_per_step": sum(r[0] for r in idx),
        "indexing_backward_origins": smoke.kernel_origins(
            prof, "indexing_backward")}}


def launches_per_call(wrapper, fn):
    before = wrapper.launches
    fn()
    return wrapper.launches - before


def probe_k6(smoke, dev, fg):
    import bliss_gnn_tpu_torch.ops.spmm as k6

    g = torch.Generator(device=dev).manual_seed(9)
    n, ip, src, pip, k = fg.n, fg.ip, fg.src, fg.pip, fg.k
    rec = {}
    for f in (256, 41):
        x = torch.randn((n, f), generator=g, device=dev).to(torch.bfloat16)
        err = (k6.spmm(x, pip, src)[:k]
               - k6.spmm_plain(x, pip, src)[:k]).abs().max().item()
        r = {"max_abs_err_prefix": err,
             "kernel_launches_per_call": launches_per_call(
                 k6.spmm, lambda: k6.spmm(x, ip, src)),
             **large_times(smoke, lambda: k6.spmm(x, ip, src), 5)}
        if f == 256:
            r["l2_probe_src_mod_16384"] = large_times(
                smoke, lambda: k6.spmm(x, ip, fg.src_l2), 5)
            if hasattr(k6, "spmm_plan"):
                keep = k6.L2_SLICE_BYTES
                for cols in (32, 64, 128, 256):
                    k6.L2_SLICE_BYTES = n * 2 * cols
                    r[f"slice_{cols}"] = large_times(
                        smoke, lambda: k6.spmm(x, ip, src), 5)
                k6.L2_SLICE_BYTES = keep
        rec[f"spmm[F={f}]"] = r
        del x
    return rec


def probe_k6_602(smoke, dev, fg):
    """K6 at ``bench_torch.py``'s headline shape (x [N, 602] f32 from
    ``headline_inputs``, weighted) beside the same call unweighted, the
    same rows padded to 608 columns (rows of whole 128-byte lines), and
    the first 256 columns weighted."""
    import bliss_gnn_tpu_torch.ops.spmm as k6
    from bench_torch import headline_inputs

    w_np, x_np = headline_inputs(fg.n, fg.n_edges)
    w, x = torch.from_numpy(w_np).to(dev), torch.from_numpy(x_np).to(dev)
    del w_np, x_np
    rec = {}
    for name, xs, ws in (("f602_weighted", x, w), ("f602_unweighted", x, None),
                         ("f608_weighted", torch.nn.functional.pad(x, (0, 6)),
                          w),
                         ("f256_weighted", x[:, :256].contiguous(), w)):
        ld, cols, launches = k6.spmm_plan(fg.n, xs.shape[1], xs.dtype)
        rec[name] = {"padded_cols": ld, "slice_cols": cols,
                     "kernel_launches_per_call": launches,
                     **large_times(smoke, lambda: k6.spmm(xs, fg.ip, fg.src,
                                                          ws), 3)}
        del xs
    return {"spmm[F=602,f32,weighted] variants": rec}


def hub_csc(gen, dev, n, hub):
    """``tests/test_torch_cuda.py``'s ``_csc``: in-degrees 0-39, every
    97th row empty, row 5 a hub, srcs uniform, 128 zeros past the end."""
    deg = torch.randint(0, 40, (n,), generator=gen, device=dev)
    deg[::97] = 0
    deg[5] = hub
    indptr = torch.zeros(n + 1, dtype=torch.int32, device=dev)
    indptr[1:] = torch.cumsum(deg, 0)
    e = int(indptr[-1])
    src = torch.randint(0, n, (e + 128,), generator=gen, device=dev,
                        dtype=torch.int32)
    src[e:] = 0
    return indptr, src, e


K6_TEST_CASES = ((256, "bfloat16", False), (41, "bfloat16", False),
                 (41, "float32", True), (128, "float32", False),
                 (300, "bfloat16", True), (300, "float32", False))


def probe_k6_hub(dev, calls=50):
    """K6 on the inputs of ``test_spmm_kernel``'s cases and of
    ``test_spmm_kernel_column_slices``' F = 256 (a fresh generator seeded 0
    each, a hub row of 30,000 edges): the kernel once, its plain version
    (``index_add_``, whose order changes between calls) ``calls`` times,
    and for each call the entries outside the test's rtol 1e-4 + atol
    1e-3. ``randn`` draws the payload as the test did before its repair;
    ``exact`` as after it: integers in [-64, 64] over 64, weights integers
    in [0, 8] over 8, so every partial sum is exact in f32."""
    import bliss_gnn_tpu_torch.ops.spmm as k6

    def payload(gen, shape, dtype, draw):
        if draw == "randn":
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        return (torch.randint(-64, 65, shape, generator=gen, device=dev)
                / 64).to(dtype)

    def weights(gen, e, draw):
        if draw == "randn":
            return torch.rand(e, generator=gen, device=dev)
        return torch.randint(0, 9, (e,), generator=gen, device=dev) / 8

    rec = {}
    cases = [(f, getattr(torch, d), w, f"test_spmm_kernel[{f}-{d}-{w}]")
             for f, d, w in K6_TEST_CASES]
    cases.append((256, torch.bfloat16, False,
                  "test_spmm_kernel_column_slices (F = 256)"))
    for draw in ("randn", "exact"):
        for f, dtype, weighted, label in cases:
            gen = torch.Generator(device=dev).manual_seed(0)
            indptr, src, e = hub_csc(gen, dev, 3000, 30_000)
            x = payload(gen, (3000, f), dtype, draw)
            w = weights(gen, e, draw) if weighted else None
            got = k6.spmm(x, indptr, src, w)
            missed, worst, hub_diff = [], 0.0, 0.0
            for _ in range(calls):
                want = k6.spmm_plain(x, indptr, src, w)
                diff = (got - want).abs()
                over = diff / (1e-3 + 1e-4 * want.abs())
                missed.append(int((over > 1).sum().item()))
                worst = max(worst, over.max().item())
                hub_diff = max(hub_diff, diff[5].max().item())
            rec[f"{draw}: {label}"] = {
                "calls": calls, "calls_missed": sum(m > 0 for m in missed),
                "entries_missed": sum(missed),
                "max_diff_over_tolerance": worst,
                "max_abs_diff_hub_row": hub_diff,
                "hub_row_max_abs": got[5].abs().max().item()}
    return rec


def probe_k7(smoke, dev, fg):
    import bliss_gnn_tpu_torch.ops.gat_attention as k7

    g = torch.Generator(device=dev).manual_seed(10)
    n, ip, src, pip, k = fg.n, fg.ip, fg.src, fg.pip, fg.k
    rec = {}
    for h, o in ((4, 256), (1, 41)):
        feat = torch.randn((n, h, o), generator=g, device=dev).to(
            torch.bfloat16)
        attn = torch.randn((1, h, o), generator=g, device=dev) / o ** 0.5

        def call(s=src):
            return k7.gat_attention(feat, attn, 0.2, ip, s)

        err = (k7.gat_attention(feat, attn, 0.2, pip, src)[:k]
               - k7.gat_attention_plain(feat, attn, 0.2, pip, src)[:k]
               ).abs().max().item()
        r = {"max_abs_err_prefix": err,
             "kernel_launches_per_call": launches_per_call(
                 k7.gat_attention, call),
             **large_times(smoke, call, 3)}
        if h == 4:
            r["l2_probe_src_mod_16384"] = large_times(
                smoke, lambda: call(fg.src_l2), 3)
        if hasattr(k7, "gat_plan"):
            r["splits_per_head"] = k7.gat_plan(h, o, feat.dtype)[1]
            plan = k7.gat_plan
            for splits in (1, 2, 4, 8):
                if min(h, 8) * splits <= 8:
                    k7.gat_plan = lambda hh, oo, dt, s=splits: (
                        plan(hh, oo, dt)[0], s)
                    r[f"splits_{splits}"] = large_times(smoke, call, 3)
            k7.gat_plan = plan
        rec[f"gat_attention[H={h},O={o}]"] = r
        del feat
    return rec


def main():
    kernels = sys.argv[1:]
    known = ("k1", "k2", "k3", "k4", "k5", "k6", "k7", "k4-repeats",
             "k6-hub", "k6-602", "gat-step")
    if not kernels or any(k not in known for k in kernels):
        sys.exit(f"usage: kernel_probe.py KERNEL [KERNEL ...], KERNEL in "
                 f"{', '.join(known)}")
    if not torch.cuda.is_available():
        sys.exit("kernel_probe: torch.cuda.is_available() is false")
    import bliss_gnn_tpu_torch

    smoke = smoke_module()
    dev = torch.device("cuda")
    rec = {"package": bliss_gnn_tpu_torch.__file__,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    fg = (FullGraph(smoke, dev) if {"k1", "k3", "k5", "k6", "k6-602", "k7",
                                    "gat-step"} & set(kernels) else None)
    sites = (call_sites(smoke, dev, fg) if {"k1", "k3", "k5"} & set(kernels)
             else None)
    for name in kernels:
        if name == "k1":
            rec.update(probe_k1(smoke, dev, sites))
        elif name == "k3":
            rec.update(probe_k3(smoke, dev, sites))
        elif name == "k5":
            rec.update(probe_k5(smoke, dev, sites))
        elif name == "gat-step":
            rec.update(probe_gat_step(smoke, dev, fg))
        elif name == "k2":
            rec.update(probe_k2(smoke, dev))
        elif name == "k4":
            rec.update(probe_k4(smoke, dev))
        elif name == "k6-hub":
            rec["spmm_test_inputs"] = probe_k6_hub(dev)
        elif name == "k4-repeats":
            rec["exp3_apply_test_inputs"] = probe_k4_repeats(smoke, dev)
        elif name == "k6":
            rec.update(probe_k6(smoke, dev, fg))
        elif name == "k6-602":
            rec.update(probe_k6_602(smoke, dev, fg))
        else:
            rec.update(probe_k7(smoke, dev, fg))
    print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
