"""Parzen-window gate — paper eq. (4).

An external state ``w_j`` is admitted to the local blend only if stepping
the local state by its own gradient update brings it closer to ``w_j``:

    delta(i, j) = 1  iff  || (w_i - eps * dw_i) - w_j ||^2  <  || w_i - w_j ||^2

which expands to  2*eps*<dw_i, w_i - w_j> > eps^2*||dw_i||^2 : three inner
products, the identity the gossip-blend reduce kernel evaluates.
"""
from __future__ import annotations

import torch

from .tree import tree_axpy, tree_leaves, tree_map, tree_sq_dist, tree_sq_norm


def parzen_gate(w_i, dw_i, w_j, eps):
    """Paper eq. (4) on whole states: f32 scalar 1.0 if w_j improves the
    update, else 0.0."""
    stepped = tree_axpy(-eps, dw_i, w_i)           # w_i - eps * dw_i
    d_after = tree_sq_dist(stepped, w_j)
    d_before = tree_sq_dist(w_i, w_j)
    return (d_after < d_before).float()


def parzen_gate_inner(w_i, dw_i, w_j, eps):
    """Eq. (4) in its expanded form, one fewer state traversal:
    ``2 <dw, w_i - w_j> > eps ||dw||^2``.  f32 scalar 1.0 or 0.0."""
    dots = tree_leaves(tree_map(
        lambda dw, wi, wj: torch.sum(dw.float() * (wi.float() - wj.float())),
        dw_i, w_i, w_j))
    sqn = tree_leaves(tree_map(lambda dw: torch.sum(dw.float() ** 2), dw_i))
    lhs = 2.0 * sum(dots, torch.zeros((), dtype=torch.float32))
    rhs = eps * sum(sqn, torch.zeros((), dtype=torch.float32))
    return (lhs > rhs).float()


def gate_from_terms(dot, sq_dw, sq_ext, eps, use_parzen: bool = True):
    """Admission gate (eq. 3 x eq. 4) from pre-reduced inner products.

    dot = <dw, w - ext>, sq_dw = ||dw||^2, sq_ext = ||ext||^2 — tensors of
    broadcast-compatible shapes.  Returns f32 gates in {0., 1.}.  The
    threshold is a hard comparison of a difference of sums, so a gate whose
    margin is near zero can flip with the summation order.
    """
    nonempty = sq_ext > 0.0
    if use_parzen:
        improves = (2.0 * eps * dot - eps * eps * sq_dw) > 0.0
        return (improves & nonempty).float()
    return nonempty.float()


def empty_state_mask(w_j):
    """Paper eq. (3) lambda: an all-zero buffer means 'no message received'.
    Returns 1.0 if ||w_j||_2 > 0, else 0.0."""
    return (tree_sq_norm(w_j) > 0.0).float()
