"""Sparse ops over padded edge lists and full graphs, and the seven CUDA
kernels under them.

- ``scatter``:       K1, 1-D f32 scatter-add (``csrc/scatter_add.cu``)
- ``gather``:        K2, table lookup, up to eight tables sharing one index
  list in one launch (``csrc/lut_gather.cu``)
- ``segsum``:        K3, 2-D row segment-sum (``csrc/segment_sum.cu``)
- ``exp3``:          K4, EXP3 arm-weight update, one launch and no sort
  (``csrc/exp3_apply.cu``)
- ``rowscatter``:    K5, wide-row scatter-add (``csrc/row_scatter.cu``)
- ``spmm``:          K6, full-graph CSC SpMM, one launch per column slice
  that fits in L2 (``csrc/spmm_csr.cu``)
- ``gat_attention``: K7, full-graph GATv2 attention, one pass per src range
  that fits in L2, src rows streamed through a ``cp.async`` ring
  (``csrc/gat_attention.cu``)
- ``poisson``:       the sampler's Poisson fixed point and its epilogue,
  one launch of a thread-block cluster a layer (``csrc/poisson_scale.cu``;
  no TPU counterpart)
- ``gat_edge``:      GATv2's per-edge attention on a sampled block and its
  backward, over the valid prefix (``csrc/gat_edge.cu``; no TPU
  counterpart)

``fullgraph`` holds the chunked plain versions of K6 and K7.

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version, in the same module, for a CPU tensor.
"""
