"""Where a computation rounds, and to what: the plain references run in
float32 with TF32 off (``Rounding()``), and their controls at the next
precision below each one that a configuration states (``lowered``).

Float8 is e4m3 (the format a later change would reach for), saturated at
its largest finite value, 448, since a cast past it gives NaN.
"""
from __future__ import annotations

import torch

FP8_MAX = 448.0

# the next precision below each stated one
BELOW = {"float32": "bfloat16", "bfloat16": "float8_e4m3fn",
         "float16": "float8_e4m3fn"}


def exact_f32():
    """Matrix products in true float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rounder(name):
    if name in (None, "float32"):
        return lambda t: t
    if name == "float8_e4m3fn":
        return lambda t: t.clamp(-FP8_MAX, FP8_MAX).to(
            torch.float8_e4m3fn).to(torch.float32)
    dtype = getattr(torch, name)
    return lambda t: t.to(dtype).to(torch.float32)


class Rounding:
    """``compute``: activations and the weights as they are used;
    ``param``: the stored parameters and Adam's moments; ``arms``: the
    stored EXP3 arm weights. Each a dtype name, or None for float32."""

    def __init__(self, compute=None, param=None, arms=None):
        self.names = (compute, param, arms)
        self.c, self.p, self.a = (_rounder(n) for n in self.names)

    @property
    def exact(self):
        return all(n in (None, "float32") for n in self.names)


def lowered(cfg):
    """The control's rounding: each precision the configuration states,
    one step down."""
    m = cfg["model"]
    return Rounding(BELOW[m["compute_dtype"]], BELOW[m["param_dtype"]],
                    BELOW[m.get("exp3_dtype", "float32")])
