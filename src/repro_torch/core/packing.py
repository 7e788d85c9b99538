"""Pack-once state layout for the gossip-blend kernels.

The kernels operate on the state viewed as a padded ``(R, LANE)`` f32
matrix — ``(W, R, LANE)`` for W worker replicas.  The packed ensemble is
the carried training state; the forward pass reads :func:`unpack_w` VIEWS
of it, so autograd delivers the gradient already packed.

Zero padding is exact for every fused op: pads contribute 0 to all
reduction terms and the blend maps 0 -> 0 in padded positions.  Leaf order
is :func:`core.tree.flatten_sorted`'s (jax.tree.flatten's), so the same
tree packs to a bitwise-equal array in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels import LANE
from .tree import flatten_sorted, unflatten


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static layout of a tree state in the packed ``(rows, LANE)`` view."""

    treedef: Any
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    n: int            # total real elements
    rows: int         # padded row count, a multiple of block_rows
    block_rows: int

    @property
    def padded(self) -> int:
        return self.rows * LANE


def pack_spec(tree, block_rows: int = 64) -> PackSpec:
    leaves, treedef = flatten_sorted(tree)
    sizes = tuple(int(l.numel()) for l in leaves)
    n = sum(sizes)
    rows = -(-max(n, 1) // LANE)
    rows = -(-rows // block_rows) * block_rows
    return PackSpec(treedef=treedef,
                    shapes=tuple(tuple(l.shape) for l in leaves),
                    dtypes=tuple(_dtype_name(l.dtype) for l in leaves),
                    sizes=sizes, n=n, rows=rows, block_rows=block_rows)


def pack(tree, spec: PackSpec):
    """Ravel ``tree`` into the padded ``(rows, LANE)`` f32 layout."""
    leaves = flatten_sorted(tree)[0]
    flat = torch.cat([l.float().reshape(-1) for l in leaves])
    flat = torch.nn.functional.pad(flat, (0, spec.padded - spec.n))
    return flat.reshape(spec.rows, LANE)


def unpack(arr2d, spec: PackSpec):
    """Inverse of :func:`pack`: restore shapes and dtypes."""
    flat = arr2d.reshape(-1)
    out, off = [], 0
    for shape, dtype, size in zip(spec.shapes, spec.dtypes, spec.sizes):
        out.append(flat[off:off + size].reshape(shape)
                   .to(getattr(torch, dtype)))
        off += size
    return unflatten(spec.treedef, out)


# ---------------------------------------------------------------------------
# worker-batched layout: trees whose leaves carry a leading worker axis
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class WPackSpec:
    """Static layout of a leading-worker-axis tree in the packed
    ``(n_workers, rows, LANE)`` view.

    ``shapes``/``sizes`` describe ONE worker's slice.  Group-contiguous
    variant (``pack_spec_w(..., groups=)``): each 'leaves'-mode group
    occupies a contiguous, block_rows-aligned row range
    ``group_row_ranges[g] = (row_start, row_end)`` holding the leaves
    ``group_leaves[g]`` (flatten-order indices, layout order) — the
    partial exchange is then a slice of packed rows and the kernels'
    partition mask a row-range comparison.  Both are None for the plain
    concatenated layout.
    """

    treedef: Any
    shapes: tuple
    dtypes: tuple
    sizes: tuple
    n: int
    rows: int
    block_rows: int
    n_workers: int
    group_leaves: tuple | None = None
    group_row_ranges: tuple | None = None

    @property
    def padded(self) -> int:
        return self.rows * LANE

    @property
    def segments(self) -> tuple:
        """The flat per-worker row-major layout as (leaf index or None for
        padding, element count) pairs, in storage order."""
        if self.group_leaves is None:
            segs = [(i, s) for i, s in enumerate(self.sizes)]
            used = self.n
        else:
            segs, used = [], 0
            for idxs, (r0, r1) in zip(self.group_leaves,
                                      self.group_row_ranges):
                segs += [(i, self.sizes[i]) for i in idxs]
                pad = (r1 - r0) * LANE - sum(self.sizes[i] for i in idxs)
                if pad:
                    segs.append((None, pad))
                used = r1 * LANE
        if self.padded > used:
            segs.append((None, self.padded - used))
        return tuple(segs)


def _w_leaf_meta(tree):
    leaves, treedef = flatten_sorted(tree)
    if not leaves:
        raise ValueError("pack_spec_w: empty tree")
    wn = int(leaves[0].shape[0])
    for l in leaves:
        if l.ndim < 1 or int(l.shape[0]) != wn:
            raise ValueError(
                f"pack_spec_w: every leaf needs leading worker axis {wn}, "
                f"got shape {tuple(l.shape)}")
    shapes = tuple(tuple(l.shape[1:]) for l in leaves)
    dtypes = tuple(_dtype_name(l.dtype) for l in leaves)
    sizes = tuple(int(l.numel()) // wn for l in leaves)
    return treedef, wn, shapes, dtypes, sizes


def pack_spec_w(tree, block_rows: int = 64, groups=None,
                n_groups: int | None = None) -> WPackSpec:
    """Worker-batched packed layout of ``tree`` (every leaf has the same
    leading worker axis W).  ``tree`` may hold tensors of any device —
    including ``meta`` — since only shapes are read.

    groups: optional tree of static leaf group ids (core.gossip.leaf_groups)
      selecting the group-contiguous layout; n_groups defaults to
      ``max(group ids) + 1``.
    """
    treedef, wn, shapes, dtypes, sizes = _w_leaf_meta(tree)
    n = sum(sizes)
    if groups is None:
        rows = -(-max(n, 1) // LANE)
        rows = -(-rows // block_rows) * block_rows
        return WPackSpec(treedef=treedef, shapes=shapes, dtypes=dtypes,
                         sizes=sizes, n=n, rows=rows, block_rows=block_rows,
                         n_workers=wn)
    gids = [int(g) for g in flatten_sorted(groups)[0]]
    if len(gids) != len(sizes):
        raise ValueError("pack_spec_w: groups tree does not match tree")
    p = (max(gids) + 1) if n_groups is None else int(n_groups)
    if any(g < 0 or g >= p for g in gids):
        raise ValueError(f"pack_spec_w: group id out of range [0, {p})")
    group_leaves, ranges = [], []
    row = 0
    for g in range(p):
        idxs = tuple(i for i, gi in enumerate(gids) if gi == g)
        size_g = sum(sizes[i] for i in idxs)
        rows_g = -(-size_g // LANE)
        rows_g = -(-rows_g // block_rows) * block_rows
        group_leaves.append(idxs)
        ranges.append((row, row + rows_g))
        row += rows_g
    return WPackSpec(treedef=treedef, shapes=shapes, dtypes=dtypes,
                     sizes=sizes, n=n, rows=max(row, block_rows),
                     block_rows=block_rows, n_workers=wn,
                     group_leaves=tuple(group_leaves),
                     group_row_ranges=tuple(ranges))


def pack_w(tree, spec: WPackSpec):
    """Ravel a leading-worker-axis ``tree`` into the padded
    ``(n_workers, rows, LANE)`` f32 layout (one copy)."""
    leaves = flatten_sorted(tree)[0]
    wn = spec.n_workers
    ref = leaves[0]
    cols = []
    for i, size in spec.segments:
        if i is None:
            cols.append(torch.zeros((wn, size), dtype=torch.float32,
                                    device=ref.device))
        else:
            cols.append(leaves[i].float().reshape(wn, -1))
    return torch.cat(cols, dim=1).reshape(wn, spec.rows, LANE)


def unpack_rows(arr2d, spec: WPackSpec):
    """ONE worker's ``(rows, LANE)`` slice of the worker-batched layout as a
    tree of VIEWS (tail shapes; f32 leaves are views, other dtypes copies).

    The views come from one ``split`` of the flat slice, so differentiating
    a loss through them w.r.t. the packed slice yields the gradient already
    in the packed layout: split's backward concatenates the leaf gradients
    with zeros for the padding — bitwise what ``pack_w`` of the gradient
    tree computes — and no per-leaf full-size buffer is ever built."""
    parts = arr2d.reshape(-1).split([s for _, s in spec.segments])
    out = [None] * len(spec.sizes)
    for (i, _), part in zip(spec.segments, parts):
        if i is not None:
            out[i] = (part.view(spec.shapes[i])
                      .to(getattr(torch, spec.dtypes[i])))
    return unflatten(spec.treedef, out)


def unpack_w(arr3d, spec: WPackSpec):
    """Inverse of :func:`pack_w`: the (W, ...) tree as VIEWS of ``arr3d``
    (f32 leaves; other dtypes are copies).  Like :func:`unpack_rows` the
    views come from one ``split`` (along the flat per-worker axis), so a
    gradient taken through them is born packed."""
    wn = spec.n_workers
    parts = arr3d.reshape(wn, -1).split([s for _, s in spec.segments],
                                        dim=1)
    out = [None] * len(spec.sizes)
    for (i, _), part in zip(spec.segments, parts):
        if i is not None:
            out[i] = (part.view((wn,) + spec.shapes[i])
                      .to(getattr(torch, spec.dtypes[i])))
    return unflatten(spec.treedef, out)


# ---------------------------------------------------------------------------
# int8 wire quantization (GossipConfig.wire_format="int8"): the exchanged
# packed row slice is quantized to int8 with one f32 scale per block_rows
# row tile and dequantized in-register inside the resident kernel passes
# ---------------------------------------------------------------------------

def scale_blocks(rows: int, block_rows: int) -> int:
    """Number of per-``block_rows`` quantization scales covering ``rows``."""
    if rows % block_rows:
        raise ValueError(
            f"quantize_rows: rows={rows} not a multiple of "
            f"block_rows={block_rows}")
    return rows // block_rows


def quantize_rows(blk, block_rows: int):
    """int8-quantize packed rows with per-``block_rows`` f32 absmax scales.

    blk: ``(..., rows, LANE)`` float, rows a multiple of block_rows.
    Returns ``(q, scales)``: q int8 of blk's shape, scales f32
    ``(..., rows // block_rows)``:

        scale = absmax(tile) / 127        q = round(x * (1 / scale))

    Bitwise the reference's quantize_rows as its engines run it (jitted):
    the same multiplies and reciprocals, round half to even in both.  An
    all-zero tile gets scale 0 and exact zeros (eq. 3's 'no message'
    survives the wire).
    """
    lead = tuple(blk.shape[:-2])
    rows, lane = blk.shape[-2:]
    nb = scale_blocks(rows, block_rows)
    t = blk.float().reshape(lead + (nb, block_rows * lane))
    # absmax / 127 as XLA compiles the reference under jit — a multiply by
    # the f32 reciprocal — so the wire is bitwise the reference engines'
    scales = t.abs().amax(dim=-1) * (1.0 / 127.0)
    pos = scales > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, scales,
                                             torch.ones_like(scales)),
                      torch.zeros_like(scales))
    q = torch.clamp(torch.round(t * inv[..., None]), -127.0, 127.0)
    return q.to(torch.int8).reshape(blk.shape), scales


def dequantize_rows(q, scales, block_rows: int):
    """Inverse of :func:`quantize_rows`: ``q * scale`` per row tile, f32 —
    the same single multiply per element as the kernels' dequantization."""
    lead = tuple(q.shape[:-2])
    rows, lane = q.shape[-2:]
    nb = scale_blocks(rows, block_rows)
    t = q.float().reshape(lead + (nb, block_rows * lane))
    return (t * scales[..., None]).reshape(q.shape)


def fake_quant_rows(blk, block_rows: int):
    """The wire round-trip as a value map: dequantize(quantize(blk))."""
    q, scales = quantize_rows(blk, block_rows)
    return dequantize_rows(q, scales, block_rows)


def group_ranges_array(spec: WPackSpec, device=None):
    """The static ``group_row_ranges`` table as a (p, 2) int32 tensor."""
    if spec.group_row_ranges is None:
        raise ValueError("group_ranges_array: spec has no group layout "
                         "(pack_spec_w was called without groups=)")
    return torch.tensor(spec.group_row_ranges, dtype=torch.int32,
                        device=device)


def pack_group_mask(groups, block_idx: int, spec: WPackSpec, device=None):
    """(rows, LANE) f32 0/1 partial-update mask for the worker-batched
    kernels (B2): 1.0 at every position of a leaf in partition
    ``block_idx``, 0.0 elsewhere (padding included).  Shared by all W
    workers — the partition is drawn once per round.

    groups: tree of static leaf group ids (core.gossip.leaf_groups);
    block_idx: a host int.  On a group-contiguous spec the mask is the
    partition's row range; otherwise each leaf's segment of the flat
    layout is set."""
    if spec.group_row_ranges is not None:
        r0, r1 = spec.group_row_ranges[block_idx]
        rows = torch.arange(spec.rows, device=device)
        m = ((rows >= r0) & (rows < r1)).float()
        return m[:, None].expand(spec.rows, LANE).contiguous()
    gids = flatten_sorted(groups)[0]
    flat = torch.zeros(spec.padded, dtype=torch.float32, device=device)
    off = 0
    for gid, size in zip(gids, spec.sizes):
        if int(gid) == block_idx:
            flat[off:off + size] = 1.0
        off += size
    return flat.reshape(spec.rows, LANE)
