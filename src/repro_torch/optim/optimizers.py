"""Inner optimizers under the ASGD gossip (the paper's is plain SGD).

The gossip blends params only, never optimizer state.  Every function
takes a tensor or a nested dict of tensors (state leaves mirror param
leaves); the packed engines pass the packed (W, R, LANE) ensemble.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core.tree import tree_map


def sgd_update(params, grads, lr):
    return tree_map(lambda w, g: w - lr * g.to(w.dtype), params, grads)


def momentum_init(params):
    return tree_map(lambda w: torch.zeros_like(w, dtype=torch.float32),
                    params)


def momentum_update(params, grads, state, lr, beta=0.9):
    new_state = tree_map(lambda m, g: beta * m + g.float(), state, grads)
    new_params = tree_map(lambda w, m: w - lr * m.to(w.dtype), params,
                          new_state)
    return new_params, new_state


def adam_init(params):
    return {"m": momentum_init(params), "v": momentum_init(params), "t": 0}


def adam_update(params, grads, state, lr, b1=0.9, b2=0.95, eps=1e-8):
    t = state["t"] + 1
    m = tree_map(lambda m, g: b1 * m + (1 - b1) * g.float(), state["m"],
                 grads)
    v = tree_map(lambda v, g: b2 * v + (1 - b2) * g.float().square(),
                 state["v"], grads)
    # bias corrections in f32, as the reference computes them
    bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(t))
    bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(t))
    new_params = tree_map(
        lambda w, m_, v_: w - (lr * (m_ / bc1)
                               / ((v_ / bc2).sqrt() + eps)).to(w.dtype),
        params, m, v)
    return new_params, {"m": m, "v": v, "t": t}


def lr_schedule(kind, base_lr, warmup=100, total=10_000):
    """Returns step -> lr (a float, computed in f32). 'const' | 'cosine' |
    'linear'."""
    f32 = np.float32

    def f(step):
        s = f32(step)
        w = min(s / f32(max(warmup, 1)), f32(1.0))
        if kind == "const":
            return float(f32(base_lr) * w)
        frac = min(max((s - f32(warmup)) / f32(max(total - warmup, 1)),
                       f32(0.0)), f32(1.0))
        if kind == "cosine":
            return float(f32(base_lr) * w * f32(0.5)
                         * (f32(1) + f32(math.cos(f32(math.pi) * frac))))
        return float(f32(base_lr) * w * (f32(1) - frac))
    return f
