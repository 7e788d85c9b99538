"""Dense MLPs: the gated one (GLU family) and the plain two-matrix one with
biases (whisper)."""
from __future__ import annotations

import torch

from .common import activation, dense_init, per_worker


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


def init_mlp_nonglu(generator, d_model, d_ff, dtype=torch.float32,
                    device=None):
    """Plain 2-matrix FFN (whisper-style), with biases."""
    kw = {"generator": generator, "in_axis": 0, "dtype": dtype,
          "device": device}
    return {
        "up": dense_init(shape=(d_model, d_ff), **kw),
        "up_b": torch.zeros((d_ff,), dtype=dtype, device=device),
        "down": dense_init(shape=(d_ff, d_model), **kw),
        "down_b": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def apply_mlp_nonglu(params, x, act="gelu"):
    """x: (W, B, S, D); params leaves (W, ...), the biases broadcast per
    worker: down(act(up(x) + up_b)) + down_b."""
    f = activation(act)
    h = f(torch.einsum("wbsd,wdf->wbsf", x, params["up"])
          + per_worker(params["up_b"], x.ndim))
    return (torch.einsum("wbsf,wfd->wbsd", h, params["down"])
            + per_worker(params["down_b"], x.ndim))
