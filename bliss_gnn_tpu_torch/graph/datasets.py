"""Graph generators, the on-disk readers and the dataset dispatch
(counterpart of ``bliss_gnn_tpu/graph/datasets.py``). For one seed every
generator gives the same arrays as the reference package, and every reader
the same arrays from the same files.

The readers take pre-downloaded files under ``DATA_ROOT``
(``BLISS_DATA_ROOT``, default ``~/datasets``), in the public formats:

- planetoid (cora, citeseer, pubmed): the ``ind.<name>.*`` pickles;
- GraphSAINT (reddit, yelp, flickr): ``adj_full.npz``, ``feats.npy``,
  ``class_map.json``, ``role.json``;
- DGL's Reddit: ``reddit_data.npz`` and ``reddit_graph.npz``;
- OGB (``ogbn-*``): ``<root>/ogbn_<name>/raw/*.csv.gz`` with
  ``split/<rule>/*.csv.gz``, read with ``gzip`` and numpy; or papers100M's
  binary ``raw/data.npz`` and ``raw/node-label.npz``, whose features and
  edges are served memory-mapped from ``.npy`` sidecars streamed out of the
  archive once.

A missing file raises ``FileNotFoundError`` naming the path looked for.
Nothing is downloaded: the reference's fetchers are left out for good.
"""
from __future__ import annotations

import gzip
import json
import os
import pickle
import shutil
import zipfile
from typing import Tuple

import numpy as np

from bliss_gnn_tpu_torch.graph.structure import Graph

DATA_ROOT = os.environ.get("BLISS_DATA_ROOT", os.path.expanduser("~/datasets"))

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

# OGB's split directory per dataset (the split rule's name)
_OGB_SPLIT_DIR = {
    "ogbn-arxiv": "time",
    "ogbn-papers100m": "time",
    "ogbn-products": "sales_ranking",
}


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
    ``synth-papers100m-small`` (1.4% of the nodes labelled); and the
    on-disk datasets ``cora``, ``citeseer``, ``pubmed``, ``reddit``,
    ``yelp``, ``flickr`` and ``ogbn-*`` under ``DATA_ROOT``."""
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
    if name in ("cora", "citeseer", "pubmed"):
        return _load_planetoid(name)
    if name in ("reddit", "yelp", "flickr"):
        d = os.path.join(DATA_ROOT, name)
        if not _saint_or_reddit_present(name):
            also = (f" or {os.path.join(d, 'reddit_data.npz')}"
                    if name == "reddit" else "")
            raise FileNotFoundError(
                f"no {os.path.join(d, 'adj_full.npz')}{also}; set "
                f"BLISS_DATA_ROOT or use load_dataset('synth-{name}')")
        if not os.path.exists(os.path.join(d, "adj_full.npz")):
            return _load_reddit_dgl(d)
        return _load_saint_npz(name)
    if name.startswith("ogbn-"):
        return _load_ogb(name)
    raise ValueError(f"unknown dataset '{name}'")


def _saint_or_reddit_present(name: str) -> bool:
    d = os.path.join(DATA_ROOT, name)
    return os.path.exists(os.path.join(d, "adj_full.npz")) or (
        name == "reddit"
        and os.path.exists(os.path.join(d, "reddit_data.npz")))


def _planetoid_dir(name: str) -> str:
    cands = (os.path.join(DATA_ROOT, name),
             os.path.join(DATA_ROOT, "planetoid"), DATA_ROOT)
    for cand in cands:
        if os.path.exists(os.path.join(cand, f"ind.{name}.graph")):
            return cand
    raise FileNotFoundError(
        f"planetoid files 'ind.{name}.*' not found in any of {list(cands)}; "
        f"set BLISS_DATA_ROOT or use load_dataset('synth-{name}')")


def _load_planetoid(name: str) -> Tuple[Graph, int, bool]:
    """The ``ind.<name>.{x,y,tx,ty,allx,ally,graph,test.index}`` family:
    the test rows moved to their shuffled ``test.index`` ids, citeseer's
    isolated test nodes as zero rows, the adjacency dict symmetrised, the
    standard 140/120/60 train and 500 val nodes."""
    import scipy.sparse as sp

    d = _planetoid_dir(name)

    def _pkl(suffix):
        with open(os.path.join(d, f"ind.{name}.{suffix}"), "rb") as f:
            return pickle.load(f, encoding="latin1")

    x, y, tx, ty, allx, ally, graph = (
        _pkl(s) for s in ("x", "y", "tx", "ty", "allx", "ally", "graph"))
    test_idx = np.loadtxt(os.path.join(d, f"ind.{name}.test.index"),
                          dtype=np.int64)
    test_range = np.arange(test_idx.min(), test_idx.max() + 1)
    test_sorted = np.sort(test_idx)
    if name == "citeseer":
        # isolated test nodes are missing from tx/ty: place the rows at
        # their SORTED positions (the standard loader); the reorder below
        # then moves each to its shuffled id
        tx_ext = np.zeros((len(test_range), x.shape[1]), dtype=np.float32)
        tx_ext[test_sorted - test_idx.min(), :] = np.asarray(tx.todense())
        tx = sp.csr_matrix(tx_ext)
        ty_ext = np.zeros((len(test_range), y.shape[1]))
        ty_ext[test_sorted - test_idx.min(), :] = ty
        ty = ty_ext
    # position test_idx[i] gets the i-th test row, which vstack placed at
    # sorted position test_sorted[i]
    features = sp.vstack((allx, tx)).tolil()
    features[test_idx, :] = features[test_sorted, :]
    labels_oh = np.vstack((ally, ty))
    labels_oh[test_idx, :] = labels_oh[test_sorted, :]
    labels = labels_oh.argmax(axis=1)
    n = features.shape[0]
    src = np.asarray([u for u, nbrs in graph.items() for _ in nbrs])
    dst = np.asarray([v for nbrs in graph.values() for v in nbrs])
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    n_train = {"cora": 140, "citeseer": 120, "pubmed": 60}[name]
    masks = {k: np.zeros(n, dtype=bool)
             for k in ("train_mask", "val_mask", "test_mask")}
    masks["train_mask"][:n_train] = True
    masks["val_mask"][n_train:n_train + 500] = True
    masks["test_mask"][test_idx] = True
    ndata = {"features": np.asarray(features.todense(), dtype=np.float32),
             "labels": labels.astype(np.int64), **masks}
    return Graph(src, dst, n, ndata=ndata), labels_oh.shape[1], False


def _load_saint_npz(name: str) -> Tuple[Graph, int, bool]:
    """GraphSAINT's layout: ``adj_full.npz``, ``feats.npy``,
    ``class_map.json`` (a list per node: multilabel) and ``role.json``."""
    import scipy.sparse as sp

    d = os.path.join(DATA_ROOT, name)
    adj = sp.load_npz(os.path.join(d, "adj_full.npz")).tocoo()
    feats = np.load(os.path.join(d, "feats.npy")).astype(np.float32)
    with open(os.path.join(d, "class_map.json")) as f:
        class_map = json.load(f)
    with open(os.path.join(d, "role.json")) as f:
        role = json.load(f)
    n = feats.shape[0]
    first = next(iter(class_map.values()))
    multilabel = isinstance(first, list)
    if multilabel:
        n_classes = len(first)
        labels = np.zeros((n, n_classes), dtype=np.float32)
    else:
        labels = np.zeros(n, dtype=np.int64)
    for k, v in class_map.items():
        labels[int(k)] = v
    if not multilabel:
        n_classes = int(labels.max()) + 1
    masks = {}
    for split, key in (("train_mask", "tr"), ("val_mask", "va"),
                       ("test_mask", "te")):
        masks[split] = np.zeros(n, dtype=bool)
        masks[split][np.asarray(role[key])] = True
    ndata = {"features": feats, "labels": labels, **masks}
    return Graph(adj.row, adj.col, n, ndata=ndata), n_classes, multilabel


def _load_reddit_dgl(d: str) -> Tuple[Graph, int, bool]:
    """DGL's Reddit layout: ``reddit_data.npz`` (feature, label, node_types
    1 train, 2 val, 3 test) and ``reddit_graph.npz`` (a scipy matrix)."""
    import scipy.sparse as sp

    data = np.load(os.path.join(d, "reddit_data.npz"))
    adj = sp.load_npz(os.path.join(d, "reddit_graph.npz")).tocoo()
    feats = data["feature"].astype(np.float32)
    labels = data["label"].reshape(-1).astype(np.int64)
    types = data["node_types"].reshape(-1)
    ndata = {"features": feats, "labels": labels, "train_mask": types == 1,
             "val_mask": types == 2, "test_mask": types == 3}
    n = feats.shape[0]
    return (Graph(adj.row, adj.col, n, ndata=ndata), int(labels.max()) + 1,
            False)


def _npz_member_memmap(npz_path: str, member: str) -> np.ndarray:
    """One member of an ``.npz``, memory-mapped. numpy ignores ``mmap_mode``
    for archives, so the member is streamed out once (16 MB at a time)
    into a ``<archive>.<member>.npy`` sidecar beside the archive, and
    every load maps the sidecar."""
    sidecar = f"{npz_path}.{member}.npy"
    if not os.path.exists(sidecar):
        with zipfile.ZipFile(npz_path) as zf:
            fname = f"{member}.npy"
            if fname not in zf.namelist():
                raise KeyError(f"{member} not in {npz_path}")
            tmp = sidecar + ".tmp"
            with zf.open(fname) as src, open(tmp, "wb") as dst:
                shutil.copyfileobj(src, dst, length=1 << 24)
            os.replace(tmp, sidecar)
    return np.load(sidecar, mmap_mode="r")


def _read_csv_gz(path: str, dtype) -> np.ndarray:
    """A headerless numeric ``.csv.gz`` as a 2-D array of ``dtype``: the
    values parsed as float64 or int64 (as the reference's CSV reader
    parses them), blank lines skipped, then cast."""
    parse = np.int64 if np.issubdtype(dtype, np.integer) else np.float64
    with gzip.open(path, "rt") as f:
        return np.loadtxt(f, delimiter=",", dtype=parse,
                          ndmin=2).astype(dtype)


def _load_ogb(name: str) -> Tuple[Graph, int, bool]:
    """OGB's node-property layouts under ``<root>/ogbn_<name>``: ``raw/``
    ``edge.csv.gz``, ``node-feat.csv.gz``, ``node-label.csv.gz``; or
    papers100M's ``raw/data.npz`` (edge_index [2, E], node_feat [N, F],
    served memory-mapped) and ``raw/node-label.npz``. The splits are
    ``split/<rule>/{train,valid,test}.csv.gz``. A NaN label (an unlabelled
    node) becomes -1; ``n_classes`` counts the distinct other labels."""
    under = name.replace("-", "_")
    # OGB's directory keeps its capitalisation (ogbn_papers100M)
    cands = [os.path.join(DATA_ROOT, under),
             os.path.join(DATA_ROOT, under.replace("100m", "100M"))]
    d = next((c for c in cands if os.path.exists(os.path.join(c, "raw"))),
             cands[0])
    raw = os.path.join(d, "raw")
    if not os.path.exists(raw):
        raise FileNotFoundError(
            f"OGB raw directory for '{name}' not found at {raw}; set "
            f"BLISS_DATA_ROOT or use load_dataset('synth-{name}')")
    if os.path.exists(os.path.join(raw, "data.npz")):
        feats = _npz_member_memmap(os.path.join(raw, "data.npz"),
                                   "node_feat")
        edges = _npz_member_memmap(os.path.join(raw, "data.npz"),
                                   "edge_index").T
        labels_f = np.load(os.path.join(raw, "node-label.npz"))[
            "node_label"].reshape(-1).astype(np.float64)
    else:
        edges = _read_csv_gz(os.path.join(raw, "edge.csv.gz"), np.int64)
        feats = _read_csv_gz(os.path.join(raw, "node-feat.csv.gz"),
                             np.float32)
        labels_f = _read_csv_gz(os.path.join(raw, "node-label.csv.gz"),
                                np.float64).reshape(-1)
    labeled = ~np.isnan(labels_f)
    labels = np.where(labeled, labels_f, -1).astype(np.int64)
    n = feats.shape[0]
    split_dir = os.path.join(d, "split", _OGB_SPLIT_DIR.get(name, "time"))
    masks = {}
    for split, fname in (("train_mask", "train.csv.gz"),
                         ("val_mask", "valid.csv.gz"),
                         ("test_mask", "test.csv.gz")):
        idx = _read_csv_gz(os.path.join(split_dir, fname),
                           np.int64).reshape(-1)
        masks[split] = np.zeros(n, dtype=bool)
        masks[split][idx] = True
    n_classes = len(np.unique(labels[labeled]))
    ndata = {"features": feats, "labels": labels, **masks}
    return Graph(edges[:, 0], edges[:, 1], n, ndata=ndata), n_classes, False
