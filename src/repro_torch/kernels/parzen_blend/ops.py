"""Public wrapper of the fused P=1 Parzen gate + blend (B6r, B6a)."""
from __future__ import annotations

from ...core.parzen import gate_from_terms
from ..gossip_blend.ops import _to_2d
from .kernel import parzen_apply, parzen_reduce


def parzen_blend(w, ext, dw, eps, *, block_rows: int = 64):
    """Fused ASGD update for a flat state (eqs. 4-6, one external).

    w, ext, dw: (N,) float.  Returns (w_next (N,) in w's dtype, gate f32
    scalar tensor).  Two kernel passes; the gate is formed on the device
    between them (no host read).  Zero padding is exact: pads add 0 to
    every reduction and the blend maps 0 -> 0 there."""
    n = w.shape[0]
    w2, e2, d2 = (_to_2d(t.float(), block_rows) for t in (w, ext, dw))
    acc = parzen_reduce(w2, e2, d2)
    gate = gate_from_terms(acc[0], acc[1], acc[2], eps)
    out2 = parzen_apply(w2, e2, d2, gate, eps=float(eps))
    return out2.reshape(-1)[:n].to(w.dtype), gate
