"""The Poisson fixed point on the card: the kernel's build report, its
time against the plain version's, and the node count of the train step's
CUDA graph at a benchmark cell.

    python scripts/probe_poisson_torch.py kernel
    python scripts/probe_poisson_torch.py graph [--root DIR] [--cell NAME]

``kernel``: ``nvcc -Xptxas -v`` on ``csrc/poisson_scale.cu``, then at each
candidate capacity of the three routes (4,096, 233,088, 2,500,000) and in
two cases (a heavy-tailed probability that converges, and too few
candidates, which never does and runs every iteration) the kernel's time
(CUDA events over 100 back-to-back launches) and the plain version's, both
replayed from a CUDA graph, with each one's iteration count.

``graph``: builds the trainer of a training cell of ``benchmark/`` at its
configuration and seed 1, runs the set-up's ``fit`` (pilot, refit,
captures, an epoch) and counts the nodes of each captured graph by type
and the kernel nodes by name (where ``cuFuncGetName`` gives one). ``--root``
imports the port and the benchmark from another checkout (the parent
commit's, say), so that both are counted by the same code. One JSON line
per section on standard output.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def _card():
    import torch

    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        smi = "not read"
    return {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
            "torch": torch.__version__, "cuda": torch.version.cuda}


def _say(tag, obj):
    print(json.dumps({"section": tag, **obj}, default=str), flush=True)


# -- kernel ----------------------------------------------------------------
def _ptxas(root):
    from bliss_gnn_tpu_torch.ops import _build

    out = os.path.join(root, "build", "ptxas_probe.so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           str(_build.CSRC / "poisson_scale.cu")]
    r = subprocess.run(cmd, capture_output=True, text=True)
    return [ln for ln in (r.stdout + r.stderr).splitlines()
            if "registers" in ln or "smem" in ln or "error" in ln
            or "spill" in ln]


def _case(dev, c_cap, case):
    import torch
    from types import SimpleNamespace

    g = torch.Generator(device=dev).manual_seed(0)
    num = 4096 if c_cap > 100_000 else 256
    prob = 1e-4 / (torch.rand(c_cap, generator=g, device=dev) + 1e-4)
    pick = torch.rand(c_cap, generator=g, device=dev)
    prob = torch.where(pick < 0.3, prob, 0.0)
    is_seed = pick < 0.003
    mask = (prob > 0) | is_seed
    if case == "few_candidates":
        mask &= torch.arange(c_cap, device=dev) < num // 2
        prob = torch.where(mask, prob, 0.0)
    cand = SimpleNamespace(mask=mask, is_seed=is_seed & mask,
                           n=mask.sum(dtype=torch.int32))
    return prob, cand, num


def _replayed_ms(fn, reps):
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = fn()
    g.replay()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        g.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps, out


def kernel(args):
    import torch

    from bliss_gnn_tpu_torch.ops.poisson import (
        poisson_route, poisson_scale, poisson_scale_plain)

    dev = torch.device("cuda")
    _say("card", _card())
    t0 = time.perf_counter()
    _say("ptxas", {"lines": _ptxas(args.root),
                   "s": time.perf_counter() - t0})
    for c_cap in (4_096, 233_088, 900_000, 2_500_000):
        for case in ("converges", "few_candidates"):
            prob, cand, num = _case(dev, c_cap, case)
            eps, iters = 0.9999, 50
            k_ms, (pk, ik) = _replayed_ms(
                lambda: poisson_scale(prob, cand, num, eps, iters), 100)
            p_ms, (pp, ip) = _replayed_ms(
                lambda: poisson_scale_plain(prob, cand, num, eps, iters), 10)
            # the kernel back to back, eagerly: its device time a launch
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            for _ in range(100):
                poisson_scale(prob, cand, num, eps, iters)
            b.record()
            torch.cuda.synchronize()
            rel = ((pk - pp).abs() / pp.abs().clamp(min=1e-30)).max()
            sizes = {}
            if c_cap == 233_088 and case == "converges":
                sizes = {ctas: _cluster_ms(prob, cand, num, eps, iters, ctas)
                         for ctas in (8, 16)}
            _say("kernel", {
                "c_cap": c_cap, "case": case,
                "route": poisson_route(c_cap), "n": int(cand.n),
                "iters_kernel": int(ik), "iters_plain": int(ip),
                "kernel_replayed_ms": k_ms,
                "kernel_eager_ms": a.elapsed_time(b) / 100,
                "plain_replayed_ms": p_ms,
                "max_rel_gap": float(rel), "cluster_ms": sizes})


def _cluster_ms(prob, cand, num, eps, iters, ctas):
    """The shared-memory route's eager time a launch at another cluster
    size than the route's, through the C entry."""
    import torch

    from bliss_gnn_tpu_torch.ops import _build

    lib = _build.load("poisson_scale")
    p = torch.empty_like(prob)
    it = torch.empty((), dtype=torch.int32, device=prob.device)
    n = cand.n.reshape(1)

    def call():
        _build.check(lib.bliss_poisson_scale(
            prob.data_ptr(), cand.mask.data_ptr(), cand.is_seed.data_ptr(),
            n.data_ptr(), p.data_ptr(), it.data_ptr(), prob.shape[0], ctas,
            0, num, eps, iters, _build.stream_of(prob)), "poisson_scale")

    call()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(100):
        call()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / 100


# -- graph -----------------------------------------------------------------
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
              5: "empty", 6: "wait_event", 7: "event_record",
              10: "mem_alloc", 11: "mem_free", 12: "batch_mem_op",
              13: "conditional"}


def _count_nodes(raw_graph):
    """Nodes of a cudaGraph_t by type, and the kernel nodes by name where
    ``libcuda`` gives one."""
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    g = ctypes.c_void_p(raw_graph)
    assert cu.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cu.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    by_type, by_name = {}, {}
    params = (ctypes.c_char * 256)()
    for node in nodes:
        t = ctypes.c_int(0)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(t))
        kind = NODE_TYPES.get(t.value, str(t.value))
        by_type[kind] = by_type.get(kind, 0) + 1
        if kind != "kernel":
            continue
        name = None
        if cu.cuGraphKernelNodeGetParams_v2(ctypes.c_void_p(node),
                                            params) == 0:
            # CUDA_KERNEL_NODE_PARAMS_v2: func, 7 uints, 2 pointers, kern
            func = ctypes.c_void_p.from_buffer(params, 0).value
            kern = ctypes.c_void_p.from_buffer(params, 56).value
            s = ctypes.c_char_p()
            for handle, getter in ((func, "cuFuncGetName"),
                                   (kern, "cuKernelGetName")):
                get = getattr(cu, getter, None)
                if handle and get is not None and get(
                        ctypes.byref(s), ctypes.c_void_p(handle)) == 0:
                    name = s.value.decode(errors="replace")
                    break
        name = name or "unnamed"
        by_name[name] = by_name.get(name, 0) + 1
    return n.value, by_type, by_name


def graph(args):
    root = os.path.abspath(args.root)
    bench = os.path.join(root, "benchmark")
    sys.path[:0] = [bench, os.path.join(bench, "reference"), root]
    import torch

    import bliss_gnn_tpu_torch.train.steps as steps
    from bmk import train as btrain
    from bmk.spec import Cell

    _say("card", {**_card(), "root": root,
                  "package": os.path.dirname(steps.__file__)})
    kept, role = [], [None]
    make = torch.cuda.CUDAGraph

    def keep(*a, **k):
        g = make(keep_graph=True)
        kept.append((role[0], g))
        return g

    run = steps._Replay.run

    def tagged(self, *a, **k):
        role[0] = self.counts[1].split("/", 1)[1]
        return run(self, *a, **k)

    torch.cuda.CUDAGraph = keep
    steps._Replay.run = tagged
    try:
        import bliss_gnn_tpu_torch.ops.poisson as poisson
    except ImportError:
        poisson = None
    launches0 = poisson.poisson_scale.launches if poisson else None
    r = btrain.Run(Cell(root, args.cell), 1, torch.device("cuda"))
    t0 = time.perf_counter()
    r.build()
    r.warm()
    torch.cuda.synchronize()
    out = {"setup_s": time.perf_counter() - t0,
           "poisson_launches": (None if poisson is None else
                                poisson.poisson_scale.launches - launches0),
           "graphs": []}
    for name, g in kept:
        n, by_type, by_name = _count_nodes(g.raw_cuda_graph())
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
        fixed = sum(v for k, v in by_name.items() if "poisson_scale" in k)
        out["graphs"].append({"role": name, "nodes": n, "by_type": by_type,
                              "poisson_scale_nodes": fixed,
                              "kernel_names": len(by_name), "top": top})
    _say("graph", out)
    r.free()


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("what", choices=("kernel", "graph"))
    p.add_argument("--root", default=os.path.dirname(HERE))
    p.add_argument("--cell", default="sage-reddit-train")
    args = p.parse_args()
    if args.what == "kernel":
        sys.path.insert(0, os.path.abspath(args.root))
        kernel(args)
    else:
        graph(args)


if __name__ == "__main__":
    main()
