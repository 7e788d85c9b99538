"""Plain-torch versions of the packed-resident gossip blend (eqs. 4-6).

``gossip_reduce_w_resident_plain`` and ``gossip_apply_w_resident_plain``
compute what the two CUDA kernels compute, pass for pass; the wrappers in
kernel.py run them for CPU tensors, and chip_smoke.py holds the kernels
against them on the card.  ``gossip_blend_w_resident_ref`` is the whole
blend written directly (the port of the reference's jnp oracle of the same
name), for the tests.
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
    range, gate by the expanded eq.-4 identity, blend.  ``lr`` defaults to
    eps; the Parzen threshold always uses eps.
    Returns (w_next (W, R, LANE), gates (W, P))."""
    if lr is None:
        lr = eps
    wn, rows, lane = w3d.shape
    if ext_scales is not None:
        ext4d = dequantize_rows(ext4d, ext_scales, block_rows)
    r0, r1 = clamp_row_range(row_range, rows)
    idx = torch.arange(rows, device=w3d.device)
    mask = ((idx >= r0) & (idx < r1)).float()[:, None].expand(rows, lane)
    mask = mask.reshape(-1)
    w = w3d.reshape(wn, -1).float()
    dw = dw3d.reshape(wn, -1).float()
    exts = ext4d.reshape(wn, ext4d.shape[1], -1).float()
    dwm = dw * mask
    extm = exts * mask
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
    denom = gates.sum(dim=1) + 1.0
    mean = (w + torch.einsum("wp,wpn->wn", gates, exts)) / denom[:, None]
    attraction = (w - mean) * mask
    if elastic:
        w_next = (w - lr * dw) - elastic_alpha * attraction
    else:
        w_next = w - lr * (attraction + dw)
    return w_next.reshape(w3d.shape), gates
