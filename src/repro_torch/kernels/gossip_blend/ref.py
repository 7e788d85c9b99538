"""Plain-torch versions of the gossip-blend kernels (eqs. 4-6), and the
port of the reference's jnp oracles.

Each ``*_plain`` function computes what one CUDA kernel computes, pass for
pass; the wrappers in kernel.py run it for CPU tensors, and chip_smoke.py
holds the kernel against it on the card:

  gossip_reduce_w_resident_plain / gossip_apply_w_resident_plain  B1r / B1a
  gossip_reduce_w_plain          / gossip_apply_w_plain           B2r / B2a
  gossip_reduce_plain            / gossip_apply_plain             B3r / B3a

The oracles write the whole blend directly, for the tests:
``gossip_blend_ref``/``gossip_blend_batched`` (one state, P externals),
``gossip_blend_w_ref``/``gossip_blend_w_batched`` (W workers, optional
partition mask) and ``gossip_blend_w_resident_ref`` (the int8 wire and a
row range).
"""
from __future__ import annotations

import torch

from ...core.packing import dequantize_rows


def clamp_row_range(row_range, rows: int) -> tuple[int, int]:
    """(r0, r1) as host ints inside [0, rows]; r1 <= r0 is an empty range
    (the reference's ``row_start <= row < row_end`` mask)."""
    r0, r1 = (int(r) for r in row_range)
    r0 = min(max(r0, 0), rows)
    return r0, min(max(r1, r0), rows)


def _dequant_rows(ext4d, ext_scales, r0: int, r1: int, block_rows: int):
    """ext4d[:, :, r0:r1] in f32, dequantized with the scale of each row's
    block_rows tile when ext_scales is given."""
    ext = ext4d[:, :, r0:r1].float()
    if ext_scales is None:
        return ext
    tiles = torch.arange(r0, r1, device=ext4d.device) // block_rows
    return ext * ext_scales[:, :, tiles][..., None]


def gossip_reduce_w_resident_plain(w3d, dw3d, ext4d, row_range,
                                   ext_scales=None, *, block_rows: int):
    """(W, P, 3) f32: per worker and external
    [<dw, w - ext_p>, ||ext_p||^2, ||dw||^2] over rows [r0, r1) — every term
    is zero outside the range, so only those rows are read."""
    r0, r1 = clamp_row_range(row_range, w3d.shape[1])
    w = w3d[:, None, r0:r1].float()                    # (W, 1, n, LANE)
    dw = dw3d[:, None, r0:r1].float()
    ext = _dequant_rows(ext4d, ext_scales, r0, r1, block_rows)
    dot = (dw * (w - ext)).sum(dim=(2, 3))             # (W, P)
    sq_ext = (ext * ext).sum(dim=(2, 3))
    sq_dw = (dw * dw).sum(dim=(2, 3)).expand_as(dot)
    return torch.stack([dot, sq_ext, sq_dw], dim=-1)


def gossip_apply_w_resident_plain(w3d, dw3d, ext4d, gates, inv_denom, lr,
                                  row_range, ext_scales=None, *,
                                  elastic: bool = False,
                                  elastic_alpha: float = 0.5,
                                  block_rows: int):
    """Per-worker gated mean plus the fused eq.-1 step, the attraction
    restricted to rows [r0, r1); rows outside take the plain SGD step
    ``w - lr*dw``.  gates (W, P), inv_denom (W,), lr a float or a
    one-element tensor.  Returns the updated (W, R, LANE) f32 states."""
    wn, rows, _ = w3d.shape
    r0, r1 = clamp_row_range(row_range, rows)
    w = w3d.float()
    dw = dw3d.float()
    ext = _dequant_rows(ext4d, ext_scales, 0, rows, block_rows)
    lr = torch.as_tensor(lr, dtype=torch.float32,
                         device=w.device).reshape(())
    idx = torch.arange(rows, device=w.device)
    m = ((idx >= r0) & (idx < r1)).float()[:, None]    # (R, 1)
    mean = inv_denom[:, None, None] * (
        w + (gates[:, :, None, None] * ext).sum(dim=1))
    attraction = (w - mean) * m
    if elastic:
        return (w - lr * dw) - elastic_alpha * attraction
    return w - lr * (attraction + dw)


def gossip_blend_w_resident_ref(w3d, dw3d, ext4d, row_range, eps, *,
                                lr=None, ext_scales=None,
                                block_rows: int = 64,
                                use_parzen: bool = True,
                                elastic: bool = False,
                                elastic_alpha: float = 0.5):
    """The whole packed-resident blend written directly, int8 wire
    included: dequantize (core.packing.dequantize_rows), mask the row
    range, then :func:`gossip_blend_w_batched`.  ``lr`` defaults to eps;
    the Parzen threshold always uses eps.
    Returns (w_next (W, R, LANE), gates (W, P))."""
    wn, rows, lane = w3d.shape
    if ext_scales is not None:
        ext4d = dequantize_rows(ext4d, ext_scales, block_rows)
    r0, r1 = clamp_row_range(row_range, rows)
    idx = torch.arange(rows, device=w3d.device)
    mask = ((idx >= r0) & (idx < r1)).float()[:, None].expand(rows, lane)
    out, gates = gossip_blend_w_batched(
        w3d.reshape(wn, -1), ext4d.reshape(wn, ext4d.shape[1], -1),
        dw3d.reshape(wn, -1), eps, lr=lr, mask=mask.reshape(-1),
        use_parzen=use_parzen, elastic=elastic, elastic_alpha=elastic_alpha)
    return out.reshape(w3d.shape), gates


# ---------------------------------------------------------------------------
# B2 (worker-batched, optional worker-shared partition mask) and B3 (one
# worker): what the CUDA kernels gossip_reduce_w/gossip_apply_w and
# gossip_reduce/gossip_apply of csrc/gossip_blend.cu compute
# ---------------------------------------------------------------------------

def gossip_reduce_w_plain(w3d, dw3d, ext4d, mask2d=None):
    """(W, P, 3) f32: per worker and external
    [<dw, w - ext_p>, ||ext_p||^2, ||dw||^2], with dw and ext multiplied by
    the (R, LANE) 0/1 mask first when one is given (m^2 = m, so every term
    is restricted to the partition)."""
    w = w3d[:, None].float()                            # (W, 1, R, LANE)
    dw = dw3d[:, None].float()
    ext = ext4d.float()
    if mask2d is not None:
        m = mask2d.float()
        dw = dw * m
        ext = ext * m
    dot = (dw * (w - ext)).sum(dim=(2, 3))              # (W, P)
    sq_ext = (ext * ext).sum(dim=(2, 3))
    sq_dw = (dw * dw).sum(dim=(2, 3)).expand_as(dot)
    return torch.stack([dot, sq_ext, sq_dw], dim=-1)


def gossip_apply_w_plain(w3d, dw3d, ext4d, gates, inv_denom, mask2d=None, *,
                         eps: float, elastic: bool = False,
                         elastic_alpha: float = 0.5):
    """Per-worker gated mean plus the step, gates (W, P), inv_denom (W,);
    eps a static float.  Positions where the mask is 0 take the plain step
    ``w - eps*dw``.  Returns the updated (W, R, LANE) f32 states."""
    w = w3d.float()
    dw = dw3d.float()
    mean = inv_denom[:, None, None] * (
        w + (gates[:, :, None, None] * ext4d.float()).sum(dim=1))
    attraction = w - mean
    if mask2d is not None:
        attraction = attraction * mask2d.float()
    if elastic:
        return (w - eps * dw) - elastic_alpha * attraction
    return w - eps * (attraction + dw)


def gossip_reduce_plain(w2d, dw2d, ext3d):
    """(P, 3) f32 gate terms of one worker: B2's reduce at W = 1."""
    return gossip_reduce_w_plain(w2d[None], dw2d[None], ext3d[None])[0]


def gossip_apply_plain(w2d, dw2d, ext3d, gates, inv_denom, *, eps: float,
                       elastic: bool = False, elastic_alpha: float = 0.5):
    """One worker's gated mean plus step, P scalar gates and a scalar
    inv_denom: B2's apply at W = 1.  Returns the (R, LANE) state."""
    inv = torch.as_tensor(inv_denom, dtype=torch.float32,
                          device=w2d.device).reshape(1)
    return gossip_apply_w_plain(
        w2d[None], dw2d[None], ext3d[None], gates.reshape(1, -1), inv,
        eps=eps, elastic=elastic, elastic_alpha=elastic_alpha)[0]


# ---------------------------------------------------------------------------
# oracles (ports of the reference's kernels/gossip_blend/ref.py)
# ---------------------------------------------------------------------------

def _step(w, dw, attraction, lr, elastic, elastic_alpha):
    if elastic:
        return (w - lr * dw) - elastic_alpha * attraction
    return w - lr * (attraction + dw)


def gossip_blend_ref(w, exts, dw, eps, *, use_parzen: bool = True,
                     elastic: bool = False, elastic_alpha: float = 0.5):
    """Multi-external ASGD update in the direct (unexpanded) form.

    w, dw: (N,); exts: (P, N).  Returns (w_next (N,), gates (P,)):

      gate_p = [||(w - eps*dw) - ext_p||^2 < ||w - ext_p||^2] * [||ext_p|| > 0]
      mean   = (w + sum_p gate_p * ext_p) / (sum_p gate_p + 1)
      w_next = w - eps * ((w - mean) + dw)          (paper mode)
      w_next = (w - eps*dw) - alpha * (w - mean)    (elastic variant)
    """
    w, dw, exts = w.float(), dw.float(), exts.float()
    stepped = w - eps * dw
    d_after = ((stepped[None] - exts) ** 2).sum(dim=1)
    d_before = ((w[None] - exts) ** 2).sum(dim=1)
    nonempty = (exts * exts).sum(dim=1) > 0.0
    if use_parzen:
        gates = ((d_after < d_before) & nonempty).float()
    else:
        gates = nonempty.float()
    mean = (w + (gates[:, None] * exts).sum(dim=0)) / (gates.sum() + 1.0)
    return _step(w, dw, w - mean, eps, elastic, elastic_alpha), gates


def gossip_blend_batched(w, exts, dw, eps, *, use_parzen: bool = True,
                         elastic: bool = False, elastic_alpha: float = 0.5):
    """The kernels' two-pass dataflow for one state, through the expanded
    eq.-4 identity: (P,) matvec reductions plus one elementwise pass."""
    out, gates = gossip_blend_w_batched(
        w[None], exts[None], dw[None], eps, use_parzen=use_parzen,
        elastic=elastic, elastic_alpha=elastic_alpha)
    return out[0], gates[0]


def gossip_blend_w_ref(w, exts, dw, eps, *, mask=None,
                       use_parzen: bool = True, elastic: bool = False,
                       elastic_alpha: float = 0.5):
    """Per-worker multi-external ASGD update, direct (unexpanded) form.

    w, dw: (W, N); exts: (W, P, N); mask: optional (N,) in {0, 1} — every
    gate term and the attraction are restricted to mask==1 positions;
    masked-out positions take the plain SGD step.
    Returns (w_next (W, N), gates (W, P))."""
    w, dw, exts = w.float(), dw.float(), exts.float()

    def sq(x):
        if mask is not None:
            x = x * mask
        return (x * x).sum(dim=-1)

    stepped = w - eps * dw
    d_after = sq(stepped[:, None] - exts)              # (W, P)
    d_before = sq(w[:, None] - exts)
    nonempty = sq(exts) > 0.0
    if use_parzen:
        gates = ((d_after < d_before) & nonempty).float()
    else:
        gates = nonempty.float()
    mean = ((w + torch.einsum("wp,wpn->wn", gates, exts))
            / (gates.sum(dim=1) + 1.0)[:, None])
    attraction = w - mean
    if mask is not None:
        attraction = attraction * mask
    return _step(w, dw, attraction, eps, elastic, elastic_alpha), gates


def gossip_blend_w_batched(w, exts, dw, eps, *, lr=None, mask=None,
                           use_parzen: bool = True, elastic: bool = False,
                           elastic_alpha: float = 0.5):
    """The worker-batched kernels' two-pass dataflow (einsum form): (W, P)
    reductions through the expanded eq.-4 identity, then one elementwise
    pass.  ``lr`` is the eq.-1 step size (defaults to eps; the gate
    threshold always uses eps).  Returns (w_next (W, N), gates (W, P))."""
    if lr is None:
        lr = eps
    w, dw, exts = w.float(), dw.float(), exts.float()
    dwm = dw * mask if mask is not None else dw
    extm = exts * mask if mask is not None else exts
    dot = (torch.einsum("wn,wn->w", dwm, w)[:, None]
           - torch.einsum("wn,wpn->wp", dwm, extm))
    sq_ext = torch.einsum("wpn,wpn->wp", extm, extm)
    nonempty = sq_ext > 0.0
    if use_parzen:
        sq_dw = torch.einsum("wn,wn->w", dwm, dwm)
        improves = (2.0 * eps * dot - eps * eps * sq_dw[:, None]) > 0.0
        gates = (improves & nonempty).float()
    else:
        gates = nonempty.float()
    mean = ((w + torch.einsum("wp,wpn->wn", gates, exts))
            / (gates.sum(dim=1) + 1.0)[:, None])
    attraction = w - mean
    if mask is not None:
        attraction = attraction * mask
    return _step(w, dw, attraction, lr, elastic, elastic_alpha), gates
