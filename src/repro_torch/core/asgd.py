"""ASGD update equations — paper section 4, eqs. (2)-(7).

Notation (paper -> code):
    w_t^i                 w_i        local state of worker i
    Delta_M(w_{t+1}^i)    dw_i       local mini-batch gradient step
    w_{t'}^j              externals  received (stale) remote states
    delta(i, j)           gate       Parzen-window admission, eq. (4)
    lambda(w)             nonempty   empty-buffer mask, eq. (3)

States are tensors or nested dicts of tensors.  ``ASGDConfig.use_fused``
routes the update through the single-worker gossip-blend kernels (B3) on
the pack-once ``(R, LANE)`` layout (``asgd_update_fused``;
``asgd_update_packed`` for callers that keep the state packed).
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
    use_fused: route the update through the fused gossip-blend kernels:
      all P gates and the gated mean in two passes over the packed state
      (B3 in ``asgd_update``; B2 in the pytree gossip engine).
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


def asgd_delta_bar(w_i, dw_i, externals: Sequence[Any], cfg: ASGDConfig):
    """Paper eq. (6): the externally modified step
    Delta_bar = [w_i - mean(admitted ∪ {w_i})] + Delta_M(w_i).
    Returns (delta_bar, n_good)."""
    if cfg.silent or not externals:
        return dw_i, torch.zeros((), dtype=torch.float32)
    attraction, n_good = blend_externals(
        w_i, dw_i, externals, cfg.eps, use_parzen=cfg.use_parzen)
    return tree_axpy(1.0, attraction, dw_i), n_good


def asgd_update(w_i, dw_i, externals: Sequence[Any], cfg: ASGDConfig):
    """One full ASGD state update (paper alg. 5 line 8 + fig. 4 step IV).

    Paper-faithful:   w <- w - eps * (attraction + Delta_M)
    Elastic variant:  w <- (w - eps * Delta_M) - alpha * attraction

    With cfg.use_fused the update goes to :func:`asgd_update_fused`.
    Returns (w_next, n_good).
    """
    if cfg.silent or not externals:
        return (tree_axpy(-cfg.eps, dw_i, w_i),
                torch.zeros((), dtype=torch.float32))
    if cfg.use_fused:
        return asgd_update_fused(w_i, dw_i, externals, cfg)
    attraction, n_good = blend_externals(
        w_i, dw_i, externals, cfg.eps, use_parzen=cfg.use_parzen)
    if cfg.elastic:
        stepped = tree_axpy(-cfg.eps, dw_i, w_i)
        w_next = tree_axpy(-cfg.elastic_alpha, attraction, stepped)
    else:
        delta_bar = tree_axpy(1.0, attraction, dw_i)
        w_next = tree_axpy(-cfg.eps, delta_bar, w_i)
    return w_next, n_good


def asgd_update_fused(w_i, dw_i, externals: Sequence[Any], cfg: ASGDConfig,
                      *, block_rows: int = 64):
    """:func:`asgd_update` through the single-worker kernels (B3r, B3a):
    the state, its step and the P externals are each packed once into the
    padded ``(R, LANE)`` layout, both kernel passes run on the packed
    arrays, and only the result is unpacked (in the state's dtypes).
    Returns (w_next, n_good)."""
    from ..kernels.gossip_blend import gossip_blend_packed
    from .packing import pack, pack_spec, unpack

    if cfg.silent or not externals:
        return (tree_axpy(-cfg.eps, dw_i, w_i),
                torch.zeros((), dtype=torch.float32))
    spec = pack_spec(w_i, block_rows=block_rows)
    ext3 = torch.stack([pack(e, spec) for e in externals])
    out2, gates = gossip_blend_packed(
        pack(w_i, spec), pack(dw_i, spec), ext3, cfg.eps,
        use_parzen=cfg.use_parzen, elastic=cfg.elastic,
        elastic_alpha=cfg.elastic_alpha)
    return unpack(out2, spec), gates.sum()


def asgd_update_packed(w2d, dw2d, ext3d, cfg: ASGDConfig):
    """:func:`asgd_update` for callers that keep the packed layout: w2d,
    dw2d (R, LANE) f32, ext3d (P, R, LANE) f32 in, (w2d_next, n_good) out
    — the two kernel passes and nothing else."""
    from ..kernels.gossip_blend import gossip_blend_packed

    if cfg.silent or ext3d.shape[0] == 0:
        return (w2d - cfg.eps * dw2d,
                torch.zeros((), dtype=torch.float32, device=w2d.device))
    out2, gates = gossip_blend_packed(
        w2d, dw2d, ext3d, cfg.eps, use_parzen=cfg.use_parzen,
        elastic=cfg.elastic, elastic_alpha=cfg.elastic_alpha)
    return out2, gates.sum()
