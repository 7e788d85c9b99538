"""Weights across the package boundary, as numpy arrays.

:func:`params_from_numpy` takes the reference's ``init_model`` output —
converted to numpy arrays (``jax.tree.map(np.asarray, params)`` on the
reference side) — into the port's param dict on a given device and dtype.
Both packages use the same nested-dict layout, leaf for leaf, so the
conversion is one array per leaf.  :func:`params_to_numpy` is the inverse.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.tree import tree_map


def params_from_numpy(tree, device="cpu", dtype=torch.float32):
    return tree_map(
        lambda x: torch.tensor(np.asarray(x), dtype=dtype, device=device),
        tree)


def params_to_numpy(tree):
    return tree_map(lambda x: x.detach().cpu().numpy(), tree)
