"""ASGD update equations — paper section 4, eqs. (2)-(7).

Notation (paper -> code):
    w_t^i                 w_i        local state of worker i
    Delta_M(w_{t+1}^i)    dw_i       local mini-batch gradient step
    w_{t'}^j              externals  received (stale) remote states
    delta(i, j)           gate       Parzen-window admission, eq. (4)
    lambda(w)             nonempty   empty-buffer mask, eq. (3)

States are tensors or nested dicts of tensors.  The fused single-worker
update (``asgd_update_fused`` / ``asgd_update_packed``) needs kernel B3
and is not ported yet (ROADMAP.md queue A).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from .parzen import empty_state_mask, parzen_gate
from .tree import tree_axpy, tree_map, tree_scale, tree_sub, tree_zeros_like


@dataclasses.dataclass(frozen=True)
class ASGDConfig:
    """Hyper-parameters of the ASGD numeric core (paper §4 'Parameters').

    eps: gradient step size (paper epsilon).
    batch: mini-batch size b — also sets the communication frequency 1/b.
    use_parzen: if False, every non-empty external state is admitted.
    silent: no communication — ASGD degrades to SimuParallelSGD.
    elastic: apply the attraction directly to the state (EASGD-style)
      instead of scaling it by eps inside the gradient step.
    elastic_alpha: blend strength of the elastic variant.
    use_fused: the reference's fused single-worker path; not ported yet.
    """

    eps: float = 0.05
    batch: int = 500
    use_parzen: bool = True
    silent: bool = False
    elastic: bool = False
    elastic_alpha: float = 0.5
    use_fused: bool = False


def blend_externals(w_i, dw_i, externals: Sequence[Any], eps,
                    use_parzen: bool = True):
    """Gated mean of {admitted externals} ∪ {w_i} — the bracket of eq. (6).

    Returns (attraction, n_good):
      attraction = w_i - (sum_n g_n w_n + w_i) / (sum_n g_n + 1)
      n_good     = number of admitted external states (f32 scalar).
    """
    if not externals:
        return tree_zeros_like(w_i), torch.zeros((), dtype=torch.float32)

    gates = []
    for w_j in externals:
        g = empty_state_mask(w_j)
        if use_parzen:
            g = g * parzen_gate(w_i, dw_i, w_j, eps)
        gates.append(g)

    denom = torch.ones((), dtype=torch.float32)
    for g in gates:
        denom = denom + g                                 # sum g_n + 1
    acc = w_i
    for g, w_j in zip(gates, externals):
        acc = tree_map(lambda a, x, g=g: a + g * x.to(a.dtype), acc, w_j)
    mean = tree_scale(acc, 1.0 / denom)
    attraction = tree_sub(w_i, mean)
    n_good = torch.stack(gates).sum()
    return attraction, n_good


def asgd_update(w_i, dw_i, externals: Sequence[Any], cfg: ASGDConfig):
    """One full ASGD state update (paper alg. 5 line 8 + fig. 4 step IV).

    Paper-faithful:   w <- w - eps * (attraction + Delta_M)
    Elastic variant:  w <- (w - eps * Delta_M) - alpha * attraction

    Returns (w_next, n_good).
    """
    if cfg.use_fused:
        raise NotImplementedError(
            "ASGDConfig.use_fused needs the single-worker gossip-blend "
            "kernel (B3), not ported yet — ROADMAP.md queue A")
    if cfg.silent or not externals:
        return (tree_axpy(-cfg.eps, dw_i, w_i),
                torch.zeros((), dtype=torch.float32))
    attraction, n_good = blend_externals(
        w_i, dw_i, externals, cfg.eps, use_parzen=cfg.use_parzen)
    if cfg.elastic:
        stepped = tree_axpy(-cfg.eps, dw_i, w_i)
        w_next = tree_axpy(-cfg.elastic_alpha, attraction, stepped)
    else:
        delta_bar = tree_axpy(1.0, attraction, dw_i)
        w_next = tree_axpy(-cfg.eps, delta_bar, w_i)
    return w_next, n_good
