"""Public wrapper of the packed-resident gossip blend.

:func:`gossip_blend_w_resident` — the packed-resident engines' blend: W
worker replicas on the group-contiguous ``(W, R, LANE)`` layout, the
exchanged partition a host row range, two kernel passes (reduce, then the
gated mean with the fused eq.-1 step), the gates formed in between on the
tiny (W, P, 3) accumulator.
"""
from __future__ import annotations

import torch

from ...core.parzen import gate_from_terms
from .kernel import gossip_apply_w_resident, gossip_reduce_w_resident

_DEFAULT_BLOCK_ROWS = 64


def choose_block_rows(rows: int | None = None) -> int:
    """Default ``block_rows`` of the resident kernels: the largest
    power-of-two divisor of ``rows`` up to 64.  The reference ranks
    TPU-measured block-size records; the port keeps this fixed default
    until it has block-size sweeps of its own on the GPU."""
    br = _DEFAULT_BLOCK_ROWS
    if rows is None:
        return br
    while br > 1 and rows % br:
        br //= 2
    return br


def gossip_gates(acc, eps, *, use_parzen: bool = True):
    """Admission gates (eq. 3 x eq. 4) from the pass-1 accumulator
    (..., 3) = [dot, ||ext||^2, ||dw||^2].  Returns f32 gates in {0, 1}."""
    return gate_from_terms(acc[..., 0], acc[..., 2], acc[..., 1], eps,
                           use_parzen=use_parzen)


def _scale_gates(gates, gate_scale):
    """Multiply the gates by a validity scalar or per-worker (W,) vector
    (the warm-up staleness guard) BEFORE the gated-mean denominator."""
    if gate_scale is None:
        return gates
    if not torch.is_tensor(gate_scale):
        return gates * float(gate_scale)
    gs = gate_scale.to(device=gates.device, dtype=torch.float32)
    return gates * (gs if gs.ndim == 0 else gs[:, None])


def gossip_blend_w_resident(w3d, dw3d, ext4d, row_range, eps, *, lr=None,
                            ext_scales=None, use_parzen: bool = True,
                            elastic: bool = False,
                            elastic_alpha: float = 0.5,
                            block_rows: int | None = None, gate_scale=None):
    """Packed-resident fused ASGD update for W worker replicas.

    w3d, dw3d: (W, R, LANE) f32; ext4d: (W, P, R, LANE) f32, or int8 with
    ext_scales (W, P, R // block_rows) f32 — the int8 wire, dequantized
    inside both passes.  row_range: host ints (r0, r1) of the partition
    blended this round; an empty range closes every gate and leaves the
    plain SGD step.  lr: the eq.-1 step size (float or device scalar;
    defaults to eps; the Parzen threshold always uses eps).  gate_scale:
    optional scalar or (W,) validity multiplier on the gates.  block_rows:
    None resolves to the quantization tile under int8 (R //
    ext_scales.shape[-1]), else :func:`choose_block_rows`.

    Returns (w_next (W, R, LANE), gates (W, P) f32).
    """
    wn, rows = w3d.shape[:2]
    p = ext4d.shape[1]
    if lr is None:
        lr = eps
    if block_rows is None:
        block_rows = (rows // ext_scales.shape[-1] if ext_scales is not None
                      else choose_block_rows(rows))
    if p == 0:
        return (w3d - lr * dw3d,
                torch.zeros((wn, 0), dtype=torch.float32, device=w3d.device))
    acc = gossip_reduce_w_resident(w3d, dw3d, ext4d, row_range, ext_scales,
                                   block_rows=block_rows)
    gates = _scale_gates(gossip_gates(acc, eps, use_parzen=use_parzen),
                         gate_scale)
    inv_denom = 1.0 / (gates.sum(dim=1) + 1.0)
    out = gossip_apply_w_resident(
        w3d, dw3d, ext4d, gates, inv_denom, lr, row_range, ext_scales,
        elastic=elastic, elastic_alpha=float(elastic_alpha),
        block_rows=block_rows)
    return out, gates
