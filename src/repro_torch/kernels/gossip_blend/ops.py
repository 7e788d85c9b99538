"""Public wrappers of the gossip blend.  Each is two kernel passes
(reduce, then the gated mean with the step) with the gates formed in
between on the tiny (..., P, 3) accumulator.

  * :func:`gossip_blend_packed` — one state on the pack-once ``(R, LANE)``
    layout, P externals (B3); the path of ``core.asgd.asgd_update_fused``.
  * :func:`gossip_blend` — the same on a flat ``(N,)`` state (pads per
    call), for tests.
  * :func:`gossip_blend_worker_batched` — W worker replicas on
    ``(W, R, LANE)`` with an optional worker-shared partition mask (B2);
    the pytree engine's fused blend (``core.gossip._fused_blend``).
  * :func:`gossip_blend_w` — the same on flat ``(W, N)`` states.
  * :func:`gossip_blend_w_resident` — the packed-resident engines' blend
    (B1): the exchanged partition a host row range, the eq.-1 step size a
    runtime operand, the int8 wire dequantized in-kernel.
"""
from __future__ import annotations

import torch

from ...core.parzen import gate_from_terms
from .. import LANE
from .kernel import (gossip_apply, gossip_apply_w, gossip_apply_w_resident,
                     gossip_reduce, gossip_reduce_w,
                     gossip_reduce_w_resident)

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


def _to_2d(x, rows_mult: int):
    """(..., N) -> (..., rows, LANE) zero-padded, rows a multiple of
    ``rows_mult``."""
    n = x.shape[-1]
    rows = -(-n // LANE)
    rows_p = -(-rows // rows_mult) * rows_mult
    x2 = torch.nn.functional.pad(x, (0, rows_p * LANE - n))
    return x2.reshape(tuple(x.shape[:-1]) + (rows_p, LANE))


def gossip_gates(acc, eps, *, use_parzen: bool = True):
    """Admission gates (eq. 3 x eq. 4) from the pass-1 accumulator
    (..., 3) = [dot, ||ext||^2, ||dw||^2].  Returns f32 gates in {0, 1}."""
    return gate_from_terms(acc[..., 0], acc[..., 2], acc[..., 1], eps,
                           use_parzen=use_parzen)


def _sum_over_mesh(acc, psum_axes, mesh):
    """The (W, P, 3) accumulator summed over the ranks of the mesh dims
    ``psum_axes``, in rank order (launch.mesh.psum_rank_order) — for
    states whose non-worker dims are sharded too, where each rank reduces
    only its rows."""
    if mesh is None:
        raise ValueError(
            f"psum_axes={psum_axes!r} names mesh dims, but no mesh was "
            "given: pass mesh= (the regions of launch/mesh.py pass theirs)")
    # imported here: launch.mesh imports this module
    from ...launch.mesh import psum_rank_order
    return psum_rank_order(acc, mesh, psum_axes)


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
                            block_rows: int | None = None, psum_axes=None,
                            mesh=None, gate_scale=None):
    """Packed-resident fused ASGD update for W worker replicas.

    w3d, dw3d: (W, R, LANE) f32; ext4d: (W, P, R, LANE) f32, or int8 with
    ext_scales (W, P, R // block_rows) f32 — the int8 wire, dequantized
    inside both passes.  row_range: host ints (r0, r1) of the partition
    blended this round; an empty range closes every gate and leaves the
    plain SGD step.  lr: the eq.-1 step size (float or device scalar;
    defaults to eps; the Parzen threshold always uses eps).  gate_scale:
    optional scalar or (W,) validity multiplier on the gates.  block_rows:
    None resolves to the quantization tile under int8 (R //
    ext_scales.shape[-1]), else :func:`choose_block_rows`.  psum_axes,
    mesh: as in :func:`gossip_blend_worker_batched`.

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
    if psum_axes:
        acc = _sum_over_mesh(acc, psum_axes, mesh)
    gates = _scale_gates(gossip_gates(acc, eps, use_parzen=use_parzen),
                         gate_scale)
    inv_denom = 1.0 / (gates.sum(dim=1) + 1.0)
    out = gossip_apply_w_resident(
        w3d, dw3d, ext4d, gates, inv_denom, lr, row_range, ext_scales,
        elastic=elastic, elastic_alpha=float(elastic_alpha),
        block_rows=block_rows)
    return out, gates


def gossip_blend_packed(w2d, dw2d, ext3d, eps, *, use_parzen: bool = True,
                        elastic: bool = False, elastic_alpha: float = 0.5):
    """Fused multi-external ASGD update of one pre-packed state.

    w2d, dw2d: (R, LANE) f32; ext3d: (P, R, LANE) f32.  Returns (w_next
    (R, LANE), gates (P,) f32): two passes over the stacked externals,
    whatever P (up to the kernel's limit on CUDA)."""
    p = ext3d.shape[0]
    if p == 0:
        return (w2d - eps * dw2d,
                torch.zeros((0,), dtype=torch.float32, device=w2d.device))
    acc = gossip_reduce(w2d, dw2d, ext3d)
    gates = gossip_gates(acc, eps, use_parzen=use_parzen)
    inv_denom = 1.0 / (gates.sum() + 1.0)
    out = gossip_apply(w2d, dw2d, ext3d, gates, inv_denom, eps=float(eps),
                       elastic=elastic, elastic_alpha=float(elastic_alpha))
    return out, gates


def gossip_blend(w, exts, dw, eps, *, use_parzen: bool = True,
                 elastic: bool = False, elastic_alpha: float = 0.5,
                 block_rows: int = 64):
    """Fused ASGD update of a flat state with P externals (eqs. 4-6).

    w, dw: (N,); exts: (P, N).  Returns (w_next (N,) in w's dtype, gates
    (P,)).  Zero padding is exact: pads add 0 to every reduction and the
    blend maps 0 -> 0 there."""
    n = w.shape[0]
    out2, gates = gossip_blend_packed(
        _to_2d(w.float(), block_rows), _to_2d(dw.float(), block_rows),
        _to_2d(exts.float(), block_rows), eps, use_parzen=use_parzen,
        elastic=elastic, elastic_alpha=elastic_alpha)
    return out2.reshape(-1)[:n].to(w.dtype), gates


def gossip_blend_worker_batched(w3d, dw3d, ext4d, eps, *, mask2d=None,
                                reduce_mask2d=None,
                                use_parzen: bool = True,
                                elastic: bool = False,
                                elastic_alpha: float = 0.5, psum_axes=None,
                                mesh=None, gate_scale=None):
    """Fused ASGD update of W worker replicas on pre-packed states.

    w3d, dw3d: (W, R, LANE) f32; ext4d: (W, P, R, LANE) f32; mask2d:
    optional (R, LANE) 0/1 partition mask shared by every worker — masked
    positions take the plain SGD step and add nothing to any gate term.
    reduce_mask2d: optional (R, LANE) mask the gate sums (B2r) take in
    place of ``mask2d`` — positions whose terms another rank of
    ``psum_axes`` already adds (a leaf held whole on every ``model``
    rank, launch/tensor_parallel.py) are 0 in it.  gate_scale: optional scalar or (W,) validity multiplier on the gates
    (the staleness guard).  psum_axes: mesh dim name(s) of ``mesh`` (a
    DeviceMesh, launch/mesh.py) to sum the (W, P, 3) gate accumulator
    over, in rank order — when the state's non-worker dims are sharded
    over those dims too, each rank then reduces only its rows; without a
    mesh it raises ValueError.

    Returns (w_next (W, R, LANE), gates (W, P) f32)."""
    wn, p = w3d.shape[0], ext4d.shape[1]
    if p == 0:
        return (w3d - eps * dw3d,
                torch.zeros((wn, 0), dtype=torch.float32, device=w3d.device))
    acc = gossip_reduce_w(w3d, dw3d, ext4d,
                          mask2d if reduce_mask2d is None else reduce_mask2d)
    if psum_axes:
        acc = _sum_over_mesh(acc, psum_axes, mesh)
    gates = _scale_gates(gossip_gates(acc, eps, use_parzen=use_parzen),
                         gate_scale)
    inv_denom = 1.0 / (gates.sum(dim=1) + 1.0)
    out = gossip_apply_w(w3d, dw3d, ext4d, gates, inv_denom, mask2d,
                         eps=float(eps), elastic=elastic,
                         elastic_alpha=float(elastic_alpha))
    return out, gates


def gossip_blend_w(w, exts, dw, eps, *, mask=None, use_parzen: bool = True,
                   elastic: bool = False, elastic_alpha: float = 0.5,
                   block_rows: int = 64):
    """Worker-batched fused update of flat states.

    w, dw: (W, N); exts: (W, P, N); mask: optional (N,) in {0, 1}.
    Returns (w_next (W, N) in w's dtype, gates (W, P))."""
    wn, n = w.shape
    m2 = None if mask is None else _to_2d(mask.float(), block_rows)
    out3, gates = gossip_blend_worker_batched(
        _to_2d(w.float(), block_rows), _to_2d(dw.float(), block_rows),
        _to_2d(exts.float(), block_rows), eps, mask2d=m2,
        use_parzen=use_parzen, elastic=elastic, elastic_alpha=elastic_alpha)
    return out3.reshape(wn, -1)[:, :n].to(w.dtype), gates
