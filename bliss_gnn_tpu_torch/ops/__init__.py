"""Sparse ops over padded edge lists, and the four CUDA kernels under them.

- ``scatter``: K1, 1-D f32 scatter-add (``csrc/scatter_add.cu``)
- ``gather``:  K2, table lookup (``csrc/lut_gather.cu``)
- ``segsum``:  K3, 2-D row segment-sum (``csrc/segment_sum.cu``)
- ``exp3``:    K4, EXP3 arm-weight update (``csrc/exp3_apply.cu``)

Each wrapper launches its kernel for a CUDA tensor and runs its plain
PyTorch version, in the same module, for a CPU tensor.
"""
