"""Nested-dict ("tree") helpers used throughout the ASGD core.

The reference's states are JAX pytrees; here they are nested dicts of
tensors, or a bare tensor.  :func:`flatten_sorted` visits dict keys in
SORTED order at every level — the order ``jax.tree.flatten`` uses — so a
packed array built from a flattened tree is bitwise the reference's.
"""
from __future__ import annotations

import torch

# a leaf's place in a treedef; a dict node is ("dict", ((key, sub), ...))
LEAF = None


def flatten_sorted(tree):
    """(leaves, treedef): leaves in sorted-key order; treedef is hashable
    and records empty dicts, so :func:`unflatten` restores the structure."""
    leaves = []

    def walk(node):
        if isinstance(node, dict):
            return ("dict", tuple((k, walk(node[k])) for k in sorted(node)))
        leaves.append(node)
        return LEAF

    treedef = walk(tree)
    return leaves, treedef


def tree_leaves(tree) -> list:
    return flatten_sorted(tree)[0]


def unflatten(treedef, leaves):
    it = iter(leaves)

    def build(d):
        if d is LEAF:
            return next(it)
        return {k: build(sub) for k, sub in d[1]}

    out = build(treedef)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the treedef holds")
    return out


def tree_map(fn, tree, *rest):
    """Apply ``fn`` leaf-wise over trees of one structure."""
    leaves, treedef = flatten_sorted(tree)
    others = [flatten_sorted(t)[0] for t in rest]
    return unflatten(treedef, [fn(*xs) for xs in zip(leaves, *others)])


def tree_sub(a, b):
    return tree_map(torch.sub, a, b)


def tree_scale(a, s):
    return tree_map(lambda x: x * s, a)


def tree_axpy(alpha, x, y):
    """alpha * x + y."""
    return tree_map(lambda xi, yi: alpha * xi + yi, x, y)


def tree_zeros_like(a):
    return tree_map(torch.zeros_like, a)


def _sum_f32(values):
    total = torch.zeros((), dtype=torch.float32)
    for v in values:
        total = total.to(v.device) + v
    return total


def tree_sq_dist(a, b):
    """Global squared L2 distance between two states, in f32 — the quantity
    the Parzen-window gate (paper eq. 4) compares."""
    return _sum_f32(tree_leaves(tree_map(
        lambda x, y: torch.sum((x.float() - y.float()) ** 2), a, b)))


def tree_sq_norm(a):
    return _sum_f32(tree_leaves(tree_map(
        lambda x: torch.sum(x.float() ** 2), a)))
