"""Evaluation helpers beyond the training loop (counterpart of
``bliss_gnn_tpu/train/evaluation.py``): a logistic-regression probe on
frozen embeddings, and the inductive train/val/test graph split.
scikit-learn is imported only when the probe runs."""
from __future__ import annotations

from typing import Tuple

import numpy as np

from bliss_gnn_tpu_torch.graph.structure import Graph


def compute_acc_unsupervised(
    emb: np.ndarray,
    labels: np.ndarray,
    train_nids: np.ndarray,
    val_nids: np.ndarray,
    test_nids: np.ndarray,
) -> Tuple[float, float]:
    """Standardise the embeddings, fit a multinomial logistic regression on
    the train split, and return the micro-F1 on val and test."""
    import sklearn.linear_model as lm
    import sklearn.metrics as skm

    emb = np.asarray(emb, np.float64)
    emb = (emb - emb.mean(0, keepdims=True)) / (emb.std(0, keepdims=True)
                                                + 1e-12)
    lr = lm.LogisticRegression(max_iter=10000)
    lr.fit(emb[train_nids], labels[train_nids])
    pred = lr.predict(emb)
    f1_val = skm.f1_score(labels[val_nids], pred[val_nids], average="micro")
    f1_test = skm.f1_score(labels[test_nids], pred[test_nids],
                           average="micro")
    return float(f1_val), float(f1_test)


def _node_subgraph(g: Graph, node_mask: np.ndarray) -> Graph:
    """The subgraph induced by ``node_mask``, ids relabelled in order, node
    and edge data sliced."""
    nids = np.where(node_mask)[0]
    relabel = -np.ones(g.n_nodes, np.int64)
    relabel[nids] = np.arange(len(nids))
    src, dst = g.edges()
    keep = node_mask[src] & node_mask[dst]
    ndata = {k: np.asarray(v)[nids] for k, v in g.ndata.items()}
    edata = {k: np.asarray(v)[keep] for k, v in g.edata.items()}
    return Graph(relabel[src[keep]], relabel[dst[keep]], len(nids),
                 ndata=ndata, edata=edata)


def inductive_split(g: Graph) -> Tuple[Graph, Graph, Graph]:
    """(train graph, val graph, test graph): the train nodes' subgraph, the
    train and val nodes' subgraph, and the whole graph."""
    train_g = _node_subgraph(g, g.ndata["train_mask"])
    val_g = _node_subgraph(g, g.ndata["train_mask"] | g.ndata["val_mask"])
    return train_g, val_g, g
