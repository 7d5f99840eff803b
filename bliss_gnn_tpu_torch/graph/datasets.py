"""Graph generators (counterpart of ``toy_graph`` and ``synthetic_graph`` in
``bliss_gnn_tpu/graph/datasets.py``). For one seed they give the same
arrays as the reference package. On-disk loaders are not ported yet."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from bliss_gnn_tpu_torch.graph.structure import Graph


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
    perm = rng.permutation(n_nodes)
    n_train = int(0.65 * n_nodes)
    n_val = int(0.1 * n_nodes)
    masks = {name: np.zeros(n_nodes, dtype=bool)
             for name in ("train_mask", "val_mask", "test_mask")}
    masks["train_mask"][perm[:n_train]] = True
    masks["val_mask"][perm[n_train:n_train + n_val]] = True
    masks["test_mask"][perm[n_train + n_val:]] = True
    ndata = {"features": feats, "labels": labels, **masks}
    return Graph(src, dst, n_nodes, ndata=ndata), n_classes, multilabel
