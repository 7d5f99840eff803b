"""PyTorch/CUDA port of bliss_gnn_tpu: bandit layer-wise importance
sampling with EXP3 arm weights and SAGE training over capacity-padded
blocks, for one NVIDIA H100.

Layout mirrors the reference package: ``graph/``, ``ops/`` (with the CUDA
kernels under ``csrc/``), ``sampling/``, ``models/``, ``train/``, plus
``convert.py``. Entry points take a ``device`` that defaults to ``"cuda"``
and raise when no card exists; pass ``device="cpu"`` for the plain PyTorch
path.
"""
