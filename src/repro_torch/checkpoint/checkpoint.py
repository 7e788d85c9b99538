"""Checkpoints of the train state, in the reference's file format.

The paper's early-termination workflow (§1: "computation can be stopped at
any time and continued later"): save and restore round-trip the whole
train state — params with their worker axis, the inner optimizer's state,
the gossip staleness buffer, the step counters.

Format: a msgpack map ``{"treedef": str, "leaves": [{"dtype", "shape",
"data"}, ...]}``, each leaf's raw C-order bytes under numpy's dtype string
(``"<f4"``, ``"<i4"``, ``"|i1"``), bf16 as ``"bfloat16"`` over its uint16
bits.  The file is streamed leaf by leaf and read through ``mmap``
(:mod:`.codec`), with no ``msgpack`` package.

What must match the reference leaf for leaf is the LEAF LIST — the
reference reads its ``treedef`` string back nowhere, it flattens the
``like`` state instead — so files of either package restore into the
other.  :func:`canonical_leaves` gives that list: dict keys sorted at every
level, lists in order, a :class:`GossipState` as (buf, buf_idx, step)
with ``buf_live`` dropped, and host ints (step counters, ``buf_idx``, the
sgd placeholder, adam's ``t``) as 0-d int32 leaves, as the reference's
``jnp.int32`` scalars.

Packed runs save in the canonical pytree layout (:func:`save_checkpoint_
packed`): the ensemble unpacked, an int8 staleness buffer dequantized, a
FIFO of depth D >= 2 as a list of D trees, oldest first, with a (D,)
int32 ``buf_idx``.  So packed, pipelined and pytree runs restore each
other, in both packages.
"""
from __future__ import annotations

import dataclasses
import mmap
import pathlib

import numpy as np
import torch

from ..core.gossip import GossipState, PackedGossipState
from ..core.packing import (dequantize_rows, pack_w, resize_worker_axis,
                            scale_blocks, unpack_w)
from .codec import unpackb, write_payload


# ---------------------------------------------------------------------------
# the canonical leaf list
# ---------------------------------------------------------------------------

def canonical_leaves(tree):
    """(leaves, treedef) of a train state in the reference's flatten order:
    tensors, and host ints (written as 0-d int32).  ``treedef`` rebuilds
    the structure (:func:`_unflatten`); ``str`` of it is the file's
    treedef string.  None subtrees hold no leaf, as in JAX."""
    leaves = []
    return leaves, _walk(tree, leaves)


# module functions taking their accumulator, as core/tree.py's: a nested
# function that calls itself is a reference cycle that keeps the leaves
# alive until the cyclic garbage collector runs

def _walk(node, leaves):
    if node is None:
        return ("none",)
    if isinstance(node, dict):
        return ("dict", tuple((k, _walk(node[k], leaves))
                              for k in sorted(node)))
    if isinstance(node, (list, tuple)):
        return (type(node).__name__, tuple(_walk(x, leaves) for x in node))
    if isinstance(node, GossipState):
        return ("GossipState", tuple(_walk(x, leaves) for x in (
            node.buf, node.buf_idx, node.step)))
    if isinstance(node, PackedGossipState):
        raise TypeError("a packed train state saves through "
                        "save_checkpoint_packed (the canonical layout)")
    if isinstance(node, bool) or not isinstance(node, (int, torch.Tensor)):
        raise TypeError(f"checkpoint: cannot store a "
                        f"{type(node).__name__} leaf")
    leaves.append(node)
    return ("int",) if isinstance(node, int) else ("*",)


def _build(d, it):
    kind = d[0]
    if kind == "none":
        return None
    if kind in ("*", "int"):
        return next(it)
    if kind == "dict":
        return {k: _build(sub, it) for k, sub in d[1]}
    if kind == "GossipState":
        return GossipState(*(_build(sub, it) for sub in d[1]))
    return (list if kind == "list" else tuple)(_build(x, it) for x in d[1])


def _unflatten(treedef, leaves):
    return _build(treedef, iter(leaves))


def _strip_live(tree):
    """The on-disk view of a train state: ``buf_live`` dropped from every
    GossipState, so elastic and legacy runs write the same file, and a
    restored run re-enters the join window at whatever mask its ``like``
    state carries (zeros for an elastic init)."""
    if isinstance(tree, GossipState):
        return dataclasses.replace(tree, buf_live=None)
    if isinstance(tree, dict):
        return {k: _strip_live(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_strip_live(x) for x in tree)
    return tree


def _reattach_live(restored, like):
    """Re-seat ``like``'s transient ``buf_live`` onto the restored state."""
    if isinstance(like, GossipState):
        return dataclasses.replace(restored, buf_live=like.buf_live)
    if isinstance(like, dict):
        return {k: _reattach_live(restored[k], like[k]) for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_reattach_live(r, l)
                          for r, l in zip(restored, like))
    return restored


# ---------------------------------------------------------------------------
# leaves to and from the file
# ---------------------------------------------------------------------------

def _encode_leaf(x):
    """(dtype string, shape, C-order bytes as a numpy array) of one leaf;
    a device tensor is copied to the host here, one leaf at a time."""
    if isinstance(x, int):
        arr = np.asarray(x, np.int32)
        return arr.dtype.str, [], arr.reshape(-1)
    t = x.detach().contiguous().cpu()
    shape = list(t.shape)
    if t.dtype == torch.bfloat16:
        return "bfloat16", shape, t.view(torch.int16).numpy().view(
            np.uint16).reshape(-1)
    arr = t.numpy()
    return arr.dtype.str, shape, arr.reshape(-1)


def _decode_leaf(d, want, resize_workers: bool):
    """One file leaf as ``want``'s kind: a host int, or a tensor of
    ``want``'s dtype on ``want``'s device (its worker axis re-seated when
    ``resize_workers`` allows it)."""
    shape = tuple(d["shape"])
    if d["dtype"] == "bfloat16":
        raw = np.frombuffer(d["data"], np.uint16).reshape(shape)
        t = torch.from_numpy(raw.view(np.int16).copy()).view(torch.bfloat16)
    else:
        raw = np.frombuffer(d["data"], np.dtype(d["dtype"])).reshape(shape)
        t = torch.from_numpy(raw.copy())
    del raw
    want_shape = () if isinstance(want, int) else tuple(want.shape)
    if shape != want_shape:
        if (resize_workers and t.ndim >= 1 and t.ndim == len(want_shape)
                and shape[1:] == want_shape[1:]):
            t = resize_worker_axis(t, want_shape[0])
        else:
            raise ValueError(f"shape mismatch {shape} vs {want_shape}")
    if isinstance(want, int):
        return int(t)
    return t.to(device=want.device, dtype=want.dtype)


def save_checkpoint(path, tree) -> None:
    """Write ``tree`` (nested dicts, lists, GossipStates, tensors and host
    ints) to ``path``: streamed into ``<path>.tmp``, then renamed over
    ``path`` (an atomic publish)."""
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    leaves, treedef = canonical_leaves(_strip_live(tree))
    tmp = path.with_suffix(".tmp")
    with open(tmp, "wb") as f:
        write_payload(f, str(treedef), len(leaves),
                      (_encode_leaf(x) for x in leaves))
    tmp.rename(path)


def _read_leaves(path, want, resize_workers: bool):
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0,
                                          access=mmap.ACCESS_READ) as mm:
        got = unpackb(mm)["leaves"]
        try:
            if len(got) != len(want):
                raise ValueError(f"checkpoint has {len(got)} leaves, "
                                 f"expected {len(want)}")
            return [_decode_leaf(d, w, resize_workers)
                    for d, w in zip(got, want)]
        finally:   # the map closes only once no slice of it is exported
            for d in got:
                if isinstance(d, dict) and isinstance(d.get("data"),
                                                      memoryview):
                    d["data"].release()


def load_checkpoint(path, like, resize_workers: bool = False):
    """Restore ``path`` into the structure of ``like``: the leaf count and
    every shape are checked, each leaf cast to ``like``'s dtype and placed
    on ``like``'s device.  ``resize_workers=True`` (the elastic restore)
    also accepts leaves whose leading axis differs while the rest of the
    shape matches, and re-seats them onto ``like``'s worker count
    (core.packing.resize_worker_axis).  ``like``'s ``buf_live`` masks are
    carried over."""
    want, treedef = canonical_leaves(_strip_live(like))
    out = _read_leaves(path, want, resize_workers)
    return _reattach_live(_unflatten(treedef, out), like)


# ---------------------------------------------------------------------------
# packed-resident states, in the canonical layout
# ---------------------------------------------------------------------------

def _packed_state_to_tree(state, spec):
    """The canonical layout of a packed train state: params unpacked (in
    their dtypes), the staleness FIFO dequantized and unpacked — one tree
    at depth 1, a list of trees (oldest first) with a (D,) int32
    ``buf_idx`` at depth D >= 2; everything else passes through (the
    optimizer state in whatever layout the run carries)."""
    out = dict(state)
    out["params"] = unpack_w(state["params"], spec)
    g = state["gossip"]
    slots = g.buf
    if g.buf_scales is not None:
        slots = tuple(dequantize_rows(q, s, spec.block_rows)
                      for q, s in zip(g.buf, g.buf_scales))
    if len(slots) >= 2:
        buf = [unpack_w(b, spec) for b in slots]
        buf_idx = torch.tensor(g.buf_idx, dtype=torch.int32)
    else:
        buf, buf_idx = unpack_w(slots[0], spec), g.buf_idx[0]
    out["gossip"] = GossipState(buf=buf, buf_idx=buf_idx, step=g.step)
    return out


def save_checkpoint_packed(path, state, spec) -> None:
    """Save a packed train state ({"params": (W, R, LANE), "gossip":
    PackedGossipState, ...}) in the canonical pytree layout — the file a
    pytree-engine run of the same model writes, at FIFO depth 1."""
    save_checkpoint(path, _packed_state_to_tree(state, spec))


def _requantize(buf, block_rows: int):
    """int8-quantize a dequantized staleness slot, recovering the scales
    it was saved with.  Each tile's scale is the first of absmax / 127 and
    its two neighbouring floats under which every element dequantizes
    back to exactly its saved value; the reference's division alone
    misses the saved scale by one ulp in some tiles."""
    wn, rows, lane = buf.shape
    t = buf.reshape(wn, scale_blocks(rows, block_rows), block_rows * lane)
    base = t.abs().amax(dim=-1) / 127.0

    def quantize(scales):
        pos = scales > 0.0
        inv = torch.where(pos, 1.0 / torch.where(pos, scales,
                                                 torch.ones_like(scales)),
                          torch.zeros_like(scales))
        return torch.clamp(torch.round(t * inv[..., None]), -127.0, 127.0)

    scales, found = base, torch.zeros_like(base, dtype=torch.bool)
    for cand in (base, torch.nextafter(base, torch.full_like(base, 1.0)),
                 torch.nextafter(base, torch.zeros_like(base))):
        exact = (quantize(cand) * cand[..., None] == t).all(dim=-1)
        scales = torch.where(exact & ~found, cand, scales)
        found |= exact
    return quantize(scales).to(torch.int8).reshape(buf.shape), scales


def load_checkpoint_packed(path, like_state, spec, elastic: bool = False):
    """Inverse of :func:`save_checkpoint_packed`: restore a canonical file
    into ``like_state``'s packed layout (params and the FIFO re-packed
    with ``spec``; an int8 FIFO re-quantized onto its saved scales, see
    :func:`_requantize`).  ``elastic=True`` restores a file saved at
    another worker count: the leaves are re-seated onto ``spec``'s
    (cyclic tiling when growing).  ``buf_live`` comes from
    ``like_state`` — zeros on an elastic init: the join window."""
    tree = load_checkpoint(path, _packed_state_to_tree(like_state, spec),
                           resize_workers=elastic)
    out = dict(tree)
    out["params"] = pack_w(tree["params"], spec)
    g = tree["gossip"]
    if isinstance(g.buf, list):
        slots = tuple(pack_w(b, spec) for b in g.buf)
        buf_idx = tuple(int(i) for i in g.buf_idx.tolist())
    else:
        slots, buf_idx = (pack_w(g.buf, spec),), (g.buf_idx,)
    like_g = like_state["gossip"]
    scales = None
    if like_g.buf_scales is not None:
        slots, scales = map(tuple, zip(*(_requantize(b, spec.block_rows)
                                         for b in slots)))
    out["gossip"] = PackedGossipState(buf=slots, buf_idx=buf_idx,
                                      step=g.step, buf_scales=scales,
                                      buf_live=like_g.buf_live)
    return out
