"""Device resolution for the package's entry points.

Entry points run on the card unless the caller asks for the CPU: without a
CUDA device, a ``"cuda"`` request raises instead of moving to the CPU.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device was requested but none is available; pass "
            "device='cpu' to run the plain PyTorch path"
        )
    return dev
