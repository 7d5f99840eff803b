"""Graph generators and the dataset dispatch (counterpart of ``toy_graph``,
``synthetic_graph``, ``sbm_graph``, ``bandit_bench_graph``,
``DATASET_STATS`` and ``load_dataset`` in ``bliss_gnn_tpu/graph/datasets.py``).
For one seed every generator gives the same arrays as the reference
package. The on-disk readers are not ported yet (ROADMAP Queue 1 item 4):
their names raise ``NotImplementedError``."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from bliss_gnn_tpu_torch.graph.structure import Graph

# (n_nodes, n_edges (directed, no self-loops), n_feats, n_classes,
# multilabel) of the reference's datasets, for the synthetic stand-ins
DATASET_STATS = {
    "cora": (2708, 10556, 1433, 7, False),
    "citeseer": (3327, 9104, 3703, 6, False),
    "pubmed": (19717, 88648, 500, 3, False),
    "flickr": (89250, 899756, 500, 7, False),
    "reddit": (232965, 114615892, 602, 41, False),
    "yelp": (716847, 13954819, 300, 100, True),
    "ogbn-arxiv": (169343, 1166243, 128, 40, False),
    "ogbn-products": (2449029, 123718280, 100, 47, False),
    "ogbn-papers100m": (111059956, 1615685872, 128, 172, False),
}

ON_DISK = ("cora", "citeseer", "pubmed", "reddit", "yelp", "flickr")


def toy_graph() -> Tuple[Graph, int, bool]:
    """5-node/4-edge fixture: edges [2,3,3,4] -> [0,0,1,1], one-hot-ish
    features, binary labels, all-train masks, weights [.5, .5, .3, .7]."""
    src = np.array([2, 3, 3, 4])
    dst = np.array([0, 0, 1, 1])
    ndata = {
        "features": np.array(
            [[0, 1, 0, 0], [0, 0, 1, 0], [0, 0, 1, 0], [0, 0, 0, 1],
             [1, 0, 0, 0]], dtype=np.float32),
        "labels": np.array([0, 0, 1, 1, 1], dtype=np.int64),
        "train_mask": np.ones(5, dtype=bool),
        "val_mask": np.zeros(5, dtype=bool),
        "test_mask": np.zeros(5, dtype=bool),
    }
    edata = {"weight": np.array([0.5, 0.5, 0.3, 0.7], dtype=np.float32)}
    return Graph(src, dst, 5, ndata=ndata, edata=edata), 2, False


def synthetic_graph(
    n_nodes: int,
    n_edges: int,
    n_feats: int,
    n_classes: int,
    multilabel: bool = False,
    seed: int = 0,
    power: float = 0.8,
    homophily: float = 0.0,
    feature_noise: float = 2.0,
    beacon_frac: float = 1.0,
    beacon_scale: float = 1.0,
) -> Tuple[Graph, int, bool]:
    """Power-law random graph with noisy class-prototype features.

    Dst endpoints follow a Zipf popularity, src endpoints are uniform.
    ``homophily`` redraws that fraction of srcs from the dst's class;
    ``feature_noise`` scales the per-node noise; ``beacon_frac`` < 1 gives
    only that fraction of nodes the prototype at ``beacon_scale``."""
    rng = np.random.default_rng(seed)
    pop = rng.zipf(1.0 + power, size=n_nodes).astype(np.float64)
    pop /= pop.sum()
    dst = rng.choice(n_nodes, size=n_edges, p=pop)
    src = rng.integers(0, n_nodes, size=n_edges)
    labels_int = rng.integers(0, n_classes, size=n_nodes)
    if homophily > 0.0:
        by_class = [np.flatnonzero(labels_int == c) for c in range(n_classes)]
        ridx = np.flatnonzero(rng.random(n_edges) < homophily)
        cls = labels_int[dst[ridx]]
        pick = rng.integers(0, 1 << 62, size=len(ridx))
        src[ridx] = np.array(
            [by_class[c][p % len(by_class[c])] if len(by_class[c]) else s
             for c, p, s in zip(cls, pick, src[ridx])], dtype=src.dtype)
    protos = rng.normal(size=(n_classes, n_feats)).astype(np.float32)
    amp = np.ones((n_nodes, 1), np.float32)
    if beacon_frac < 1.0:
        amp[rng.random(n_nodes) < beacon_frac] = beacon_scale
    feats = protos[labels_int] * amp + rng.normal(
        scale=feature_noise, size=(n_nodes, n_feats)).astype(np.float32)
    if multilabel:
        labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
        labels[np.arange(n_nodes), labels_int] = 1.0
        extra = rng.integers(0, n_classes, size=n_nodes)
        labels[np.arange(n_nodes), extra] = 1.0
    else:
        labels = labels_int.astype(np.int64)
    ndata = {"features": feats, "labels": labels,
             **_split_masks(rng, n_nodes)}
    return Graph(src, dst, n_nodes, ndata=ndata), n_classes, multilabel


def _split_masks(rng: np.random.Generator, n_nodes: int):
    """65/10/25 train/val/test masks over a random permutation."""
    perm = rng.permutation(n_nodes)
    n_train = int(0.65 * n_nodes)
    n_val = int(0.1 * n_nodes)
    masks = {name: np.zeros(n_nodes, dtype=bool)
             for name in ("train_mask", "val_mask", "test_mask")}
    masks["train_mask"][perm[:n_train]] = True
    masks["val_mask"][perm[n_train:n_train + n_val]] = True
    masks["test_mask"][perm[n_train + n_val:]] = True
    return masks


def sbm_graph(
    n_nodes: int,
    n_edges: int,
    n_feats: int,
    n_classes: int,
    multilabel: bool = False,
    seed: int = 0,
    n_blocks: int = 50,
    intra: float = 0.8,
    power: float = 0.8,
    block_power: float = 1.2,
    feature_noise: float = 2.0,
) -> Tuple[Graph, int, bool]:
    """Degree-corrected stochastic block model: ``n_blocks`` communities of
    Zipf-skewed sizes (``block_power``), a Zipf degree propensity per node
    (``power``, capped at Reddit's 21k / 114.8M share of the edges),
    ``intra`` of the edges inside their community, labels the community
    mod ``n_classes``, and node ids shuffled at the end so the communities
    are latent."""
    rng = np.random.default_rng(seed)
    bw = 1.0 / np.arange(1, n_blocks + 1) ** block_power
    bw /= bw.sum()
    node_comm = rng.choice(n_blocks, size=n_nodes, p=bw)
    theta = rng.zipf(1.0 + power, size=n_nodes).astype(np.float64)
    max_frac = 21_000.0 / 114_848_857.0
    for _ in range(8):  # clipping shifts the sum; iterate to a fixed point
        cap = max_frac * theta.sum()
        if theta.max() <= cap:
            break
        theta = np.minimum(theta, cap)
    order = np.argsort(node_comm, kind="stable")
    comm_sorted = node_comm[order]
    starts = np.searchsorted(comm_sorted, np.arange(n_blocks))
    ends = np.searchsorted(comm_sorted, np.arange(n_blocks), side="right")
    comm_mass = np.array([theta[order[s:e]].sum() if e > s else 0.0
                          for s, e in zip(starts, ends)])
    n_intra = int(round(intra * n_edges))
    intra_counts = rng.multinomial(n_intra, comm_mass / comm_mass.sum())
    src_parts, dst_parts = [], []
    for c in range(n_blocks):
        m = intra_counts[c]
        if m == 0 or ends[c] <= starts[c]:
            continue
        nodes_c = order[starts[c]:ends[c]]
        p_c = theta[nodes_c] / theta[nodes_c].sum()
        src_parts.append(rng.choice(nodes_c, size=m, p=p_c))
        dst_parts.append(rng.choice(nodes_c, size=m, p=p_c))
    n_inter = n_edges - sum(len(p) for p in src_parts)
    if n_inter > 0:
        pg = theta / theta.sum()
        src_parts.append(rng.choice(n_nodes, size=n_inter, p=pg))
        dst_parts.append(rng.choice(n_nodes, size=n_inter, p=pg))
    relabel = rng.permutation(n_nodes)
    src = relabel[np.concatenate(src_parts)]
    dst = relabel[np.concatenate(dst_parts)]
    labels_int = np.empty(n_nodes, dtype=np.int64)
    labels_int[relabel] = node_comm % n_classes
    protos = rng.normal(size=(n_classes, n_feats)).astype(np.float32)
    feats = protos[labels_int] + rng.normal(
        scale=feature_noise, size=(n_nodes, n_feats)).astype(np.float32)
    if multilabel:
        labels = np.zeros((n_nodes, n_classes), dtype=np.float32)
        labels[np.arange(n_nodes), labels_int] = 1.0
        extra = rng.integers(0, n_classes, size=n_nodes)
        labels[np.arange(n_nodes), extra] = 1.0
    else:
        labels = labels_int
    ndata = {"features": feats, "labels": labels,
             **_split_masks(rng, n_nodes)}
    return Graph(src, dst, n_nodes, ndata=ndata), n_classes, multilabel


def bandit_bench_graph(
    n_nodes: int = 19717,
    n_edges: int = 240_000,
    n_feats: int = 24,
    n_classes: int = 3,
    dead_frac: float = 0.75,
    n_dead: int = 2000,
    seed: int = 0,
) -> Tuple[Graph, int, bool]:
    """A Pubmed-sized graph where the bandit matters: ``dead_frac`` of the
    in-edges are rerouted to ``n_dead`` featureless distractor nodes, whose
    near-zero embedding norms the EXP3 reward learns to avoid."""
    g, n_classes, ml = synthetic_graph(n_nodes, n_edges, n_feats, n_classes,
                                       seed=seed)
    rng = np.random.default_rng(seed + 1)
    dst = np.repeat(np.arange(g.n_nodes), np.diff(g.csc_indptr))
    src = np.asarray(g.csc_src)
    reroute = rng.random(len(src)) < dead_frac
    src = np.where(reroute, n_nodes + rng.integers(0, n_dead, len(src)), src)
    feats = np.concatenate([
        np.asarray(g.ndata["features"]),
        rng.normal(scale=0.02, size=(n_dead, n_feats)).astype(np.float32),
    ])
    labels = np.concatenate([
        np.asarray(g.ndata["labels"]),
        rng.integers(0, n_classes, n_dead).astype(np.int64),
    ])
    masks = {k: np.concatenate([np.asarray(g.ndata[k]),
                                np.zeros(n_dead, bool)])
             for k in ("train_mask", "val_mask", "test_mask")}
    ndata = {"features": feats, "labels": labels, **masks}
    return Graph(src, dst, n_nodes + n_dead, ndata=ndata), n_classes, ml


def load_dataset(name: str, seed: int = 0) -> Tuple[Graph, int, bool]:
    """``(graph, n_classes, multilabel)`` by name: ``toy``; ``synth-small``;
    ``synth-<dataset>`` and ``synth-<dataset>-hard`` (a random graph of that
    dataset's size from ``DATASET_STATS``; ``-hard`` homophilous, with
    noisy features and a beacon minority carrying the signal);
    ``synth-sbm-small`` and ``synth-sbm-<dataset>``; and
    ``synth-papers100m-small`` (1.4% of the nodes labelled). The on-disk
    datasets raise ``NotImplementedError``."""
    name = name.lower()
    if name == "toy":
        return toy_graph()
    if name.startswith("synth-"):
        base = name[len("synth-"):]
        if base == "small":
            return synthetic_graph(2000, 20000, 64, 7, seed=seed)
        if base == "papers100m-small":
            g, c, ml = synthetic_graph(500_000, 8_000_000, 128, 172,
                                       seed=seed)
            labeled = np.random.default_rng(seed).random(g.n_nodes) < 0.014
            g.ndata["labels"] = np.where(labeled, g.ndata["labels"], -1)
            for m in ("train_mask", "val_mask", "test_mask"):
                g.ndata[m] &= labeled
            return g, c, ml
        if base.startswith("sbm-"):
            sub = base[len("sbm-"):]
            if sub == "small":
                return sbm_graph(2000, 20000, 64, 7, seed=seed)
            if sub in DATASET_STATS:
                n, e, f, c, ml = DATASET_STATS[sub]
                return sbm_graph(n, e, f, c, multilabel=ml, seed=seed)
            raise ValueError(f"unknown sbm synthetic dataset '{name}'")
        hard = base.endswith("-hard")
        if hard:
            base = base[:-len("-hard")]
        if base in DATASET_STATS:
            n, e, f, c, ml = DATASET_STATS[base]
            if hard:
                return synthetic_graph(n, e, f, c, multilabel=ml, seed=seed,
                                       homophily=0.6, feature_noise=10.0,
                                       beacon_frac=0.25, beacon_scale=8.0)
            return synthetic_graph(n, e, f, c, multilabel=ml, seed=seed)
        raise ValueError(f"unknown synthetic dataset '{name}'")
    if name in ON_DISK or name.startswith("ogbn-"):
        raise NotImplementedError(
            f"dataset '{name}' is read from disk; the on-disk readers are "
            f"not ported yet (ROADMAP Queue 1 item 4): use "
            f"'synth-{name}' for a stand-in of its size")
    raise ValueError(f"unknown dataset '{name}'")
