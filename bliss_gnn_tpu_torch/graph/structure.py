"""Graph containers: host-side numpy construction, device-side torch tensors
(counterpart of ``bliss_gnn_tpu/graph/structure.py``).

- CSC (in-edges): ``csc_indptr[N+1]``, ``csc_src[E]``, edges grouped by dst.
  An edge's canonical id is its position in CSC order; all edge data is
  indexed by it.
- CSR (out-edges): ``csr_indptr[N+1]``, ``csr_dst[E]``, ``csr_eid[E]``, the
  same edges grouped by src, with ``csr_eid`` mapping back to canonical ids.

Both are built by the native graph core (``graph/native.py``: counting
sorts in C++), which gives the same arrays as numpy's stable argsort
(``_build_csc``, ``_build_csr_from_csc``, the plain versions) and as the
reference package's CSC/CSR construction. Node data is kept as given: a
memory-mapped feature matrix stays a memmap.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from bliss_gnn_tpu_torch._device import resolve_device
from bliss_gnn_tpu_torch.graph import native

# trailing zeros carried by edge-indexed device arrays, so the sampler's
# chunk-granular gathers (sampling/frontier.py) never read past the end
EDGE_PAD = 128


def _build_csc(src: np.ndarray, dst: np.ndarray, n_nodes: int):
    """Group edges by dst: (indptr, src_sorted, perm), perm mapping a CSC
    position to its input edge position (stable within a dst)."""
    order = np.argsort(dst, kind="stable")
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(dst, minlength=n_nodes), out=indptr[1:])
    return indptr, src[order], order


def _build_csr_from_csc(csc_indptr, csc_src, n_nodes: int):
    """CSR (grouped by src) with the eid map back to canonical ids."""
    dst_of_eid = np.repeat(np.arange(n_nodes, dtype=np.int64),
                           np.diff(csc_indptr))
    order = np.argsort(csc_src, kind="stable")
    indptr = np.zeros(n_nodes + 1, dtype=np.int64)
    np.cumsum(np.bincount(csc_src, minlength=n_nodes), out=indptr[1:])
    return indptr, dst_of_eid[order], order


class Graph:
    """Host-side graph in canonical CSC/CSR form with node/edge data dicts
    (``ndata``: features, labels, masks; ``edata``: e.g. the normalised
    weight ``w``, in canonical eid order)."""

    def __init__(self, src, dst, n_nodes: int,
                 ndata: Optional[Dict[str, np.ndarray]] = None,
                 edata: Optional[Dict[str, np.ndarray]] = None):
        src = np.asarray(src, dtype=np.int64)
        dst = np.asarray(dst, dtype=np.int64)
        if src.shape != dst.shape:
            raise ValueError("src and dst must have one shape")
        self.n_nodes = int(n_nodes)
        self.n_edges = int(src.shape[0])
        self.csc_indptr, self.csc_src, perm = native.build_csc(
            src, dst, self.n_nodes)
        self.csr_indptr, self.csr_dst, self.csr_eid = (
            native.build_csr_from_csc(self.csc_indptr, self.csc_src,
                                      self.n_nodes))
        self.ndata: Dict[str, np.ndarray] = dict(ndata or {})
        self.edata: Dict[str, np.ndarray] = {
            k: np.asarray(v)[perm] for k, v in (edata or {}).items()}
        self.input_to_canonical_eid = np.argsort(perm, kind="stable")

    @staticmethod
    def from_csc(indptr, csc_src, n_nodes: int,
                 ndata: Optional[Dict[str, np.ndarray]] = None,
                 edata: Optional[Dict[str, np.ndarray]] = None,
                 csr=None) -> "Graph":
        """A graph given in canonical CSC order, its edge data in that
        order. ``csr``: its (indptr, dst, eid) arrays, as ``Graph`` builds
        them (a stable sort of ``csc_src``), when the caller has them."""
        g = Graph.__new__(Graph)
        g.n_nodes, g.n_edges = int(n_nodes), int(len(csc_src))
        g.csc_indptr = np.asarray(indptr, dtype=np.int64)
        g.csc_src = np.asarray(csc_src)
        if csr is None:
            csr = native.build_csr_from_csc(g.csc_indptr, g.csc_src,
                                            g.n_nodes)
        g.csr_indptr, g.csr_dst, g.csr_eid = (np.asarray(a) for a in csr)
        g.ndata = dict(ndata or {})
        g.edata = {k: np.asarray(v) for k, v in (edata or {}).items()}
        g.input_to_canonical_eid = np.arange(g.n_edges)
        return g

    def in_degrees(self) -> np.ndarray:
        return np.diff(self.csc_indptr)

    def out_degrees(self) -> np.ndarray:
        return np.diff(self.csr_indptr)

    def edges(self):
        """(src, dst) in canonical eid order."""
        dst = np.repeat(np.arange(self.n_nodes, dtype=np.int64),
                        np.diff(self.csc_indptr))
        return self.csc_src.copy(), dst

    def remove_self_loops(self) -> "Graph":
        src, dst = self.edges()
        keep = src != dst
        return self._rebuild(src[keep], dst[keep],
                             {k: v[keep] for k, v in self.edata.items()})

    def add_self_loops(self) -> "Graph":
        src, dst = self.edges()
        loop = np.arange(self.n_nodes, dtype=np.int64)
        edata = {
            k: np.concatenate(
                [v, np.zeros((self.n_nodes,) + v.shape[1:], dtype=v.dtype)])
            for k, v in self.edata.items()
        }
        return self._rebuild(np.concatenate([src, loop]),
                             np.concatenate([dst, loop]), edata)

    def to_undirected(self) -> "Graph":
        """Double every edge with its reverse (duplicates allowed)."""
        src, dst = self.edges()
        edata = {k: np.concatenate([v, v]) for k, v in self.edata.items()}
        return self._rebuild(np.concatenate([src, dst]),
                             np.concatenate([dst, src]), edata)

    def _rebuild(self, src, dst, edata) -> "Graph":
        return Graph(src, dst, self.n_nodes, ndata=self.ndata, edata=edata)

    @staticmethod
    def canonicalize(g: "Graph", undirected: bool = False) -> "Graph":
        """remove_self_loops + add_self_loops (+ optional undirected
        doubling), in the reference's preprocessing order."""
        g = g.remove_self_loops().add_self_loops()
        return g.to_undirected() if undirected else g


def _pad_edges(a: np.ndarray) -> np.ndarray:
    return np.concatenate(
        [a, np.zeros((EDGE_PAD,) + a.shape[1:], dtype=a.dtype)])


@dataclasses.dataclass(frozen=True)
class DeviceGraph:
    """Device-resident graph: int32 CSC/CSR index tensors plus node and
    edge data. Edge-indexed tensors (``csc_src`` and every ``edata`` entry)
    carry EDGE_PAD trailing zeros."""

    csc_indptr: torch.Tensor
    csc_src: torch.Tensor
    csr_indptr: torch.Tensor
    csr_dst: torch.Tensor
    csr_eid: torch.Tensor
    ndata: Dict[str, torch.Tensor]
    edata: Dict[str, torch.Tensor]
    n_nodes: int = 0
    n_edges: int = 0

    @staticmethod
    def from_graph(g: Graph, device="cuda", feature_dtype=torch.bfloat16,
                   exclude: Sequence[str] = ()) -> "DeviceGraph":
        """Upload ``g`` but its ndata keys in ``exclude`` (host-resident
        features: ``exclude=("features",)``); raises when ``device`` is
        CUDA and no card exists."""
        dev = resolve_device(device)
        if max(g.n_nodes, g.n_edges) >= 2 ** 31:
            raise ValueError("graphs past int32 indices are not supported")

        def idx(a):
            return torch.from_numpy(np.asarray(a, dtype=np.int32)).to(dev)

        nd = {}
        for k, v in g.ndata.items():
            if k in exclude:
                continue
            t = torch.from_numpy(np.ascontiguousarray(v))
            nd[k] = t.to(dev, feature_dtype if k == "features" else None)
        ed = {k: torch.from_numpy(_pad_edges(np.asarray(v))).to(dev)
              for k, v in g.edata.items()}
        return DeviceGraph(
            csc_indptr=idx(g.csc_indptr),
            csc_src=idx(_pad_edges(np.asarray(g.csc_src))),
            csr_indptr=idx(g.csr_indptr),
            csr_dst=idx(g.csr_dst),
            csr_eid=idx(g.csr_eid),
            ndata=nd, edata=ed, n_nodes=g.n_nodes, n_edges=g.n_edges,
        )

    @property
    def device(self) -> torch.device:
        return self.csc_indptr.device

    def in_degrees(self) -> torch.Tensor:
        return self.csc_indptr[1:] - self.csc_indptr[:-1]

    @property
    def k7_ranges(self):
        """K7's range plans of this graph's CSC (``ops.gat_attention.
        RangePlans``), made at first use and kept with the graph, so that
        full-graph passes build each plan once."""
        plans = self.__dict__.get("_k7_ranges")
        if plans is None:
            from bliss_gnn_tpu_torch.ops.gat_attention import RangePlans

            plans = RangePlans(self.csc_indptr, self.csc_src)
            object.__setattr__(self, "_k7_ranges", plans)
        return plans

    def out_degrees(self) -> torch.Tensor:
        return self.csr_indptr[1:] - self.csr_indptr[:-1]


def normalized_edata(g: Graph, weight: Optional[str] = None,
                     multiply_weight: bool = True) -> np.ndarray:
    """Per-dst-normalised edge weights in canonical eid order, f32:
    w_e = W_e / sum_{e' into dst(e)} W_e' (``multiply_weight``) or
    1 / sum_{e' into dst(e)} W_e'. With W = 1 both are 1 / in_deg(dst).
    The first is one pass of the native core over the CSC ranges (sums in
    double), as in the reference."""
    if multiply_weight:
        return native.normalized_edata(
            g.csc_indptr, None if weight is None else g.edata[weight],
            g.n_edges)
    if weight is None:
        W = np.ones(g.n_edges, dtype=np.float32)
    else:
        W = np.asarray(g.edata[weight], dtype=np.float32)
    dst = np.repeat(np.arange(g.n_nodes), np.diff(g.csc_indptr))
    sums = np.zeros(g.n_nodes, dtype=np.float32)
    np.add.at(sums, dst, W)
    denom = sums[dst]
    safe = np.where(denom > 0, denom, 1.0)
    out = np.where(denom > 0, (W if multiply_weight else 1.0) / safe, 0.0)
    return out.astype(np.float32)
