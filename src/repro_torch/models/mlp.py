"""Dense gated MLP (GLU family)."""
from __future__ import annotations

import torch

from .common import activation, dense_init


def init_mlp(generator, d_model, d_ff, dtype=torch.float32, device=None):
    kw = {"generator": generator, "in_axis": 0, "dtype": dtype,
          "device": device}
    return {
        "gate": dense_init(shape=(d_model, d_ff), **kw),
        "up": dense_init(shape=(d_model, d_ff), **kw),
        "down": dense_init(shape=(d_ff, d_model), **kw),
    }


def apply_mlp(params, x, act="silu"):
    """x: (W, B, S, D); params leaves (W, ...)."""
    f = activation(act)
    h = f(torch.einsum("wbsd,wdf->wbsf", x, params["gate"])) \
        * torch.einsum("wbsd,wdf->wbsf", x, params["up"])
    return torch.einsum("wbsf,wfd->wbsd", h, params["down"])
