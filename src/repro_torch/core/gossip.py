"""ASGD gossip rounds (paper eqs. 4-7): the pytree engine, and the
packed-resident and pipelined engines.

Every state carries a leading worker axis W: W worker replicas on one
device.  One round: draw a (shift, partition) pair; exchange the
partition with a ring peer (``torch.roll`` along W, which is the
collective permute when one device holds all workers); blend a past
round's received block through the Parzen gate.

  * pytree engine (:func:`asgd_gossip_apply`): the state is a tree of
    (W, ...) leaves; the partition is a static leaf group ('leaves') or a
    1/p slice of every leaf along dim 1 ('rows').  The blend is plain
    torch, or — with ``ASGDConfig.use_fused`` — the worker-batched
    kernels B2r/B2a on the state packed once per round (``_fused_blend``).
  * packed-resident engines: the packed ``(W, R, LANE)`` ensemble
    (core/packing.py pack_w on a group-contiguous spec) is the carried
    state, the partition a packed row range, the blend kernels B1r/B1a.

Randomness: the reference draws (shift_idx, block_idx) with ``jax.random``
inside the round.  Here they are explicit host-int arguments of every
engine function — :func:`draw_gossip_indices` draws them from a
``torch.Generator`` — so the partition's row range reaches the kernels by
value with no device sync, and the tests can replay the reference's draws.

The staleness FIFO (``PackedGossipState.buf``) is a tuple of D slots,
oldest first, where the reference stacks a leading depth axis: a push is
then a tuple shift, not a copy of the whole FIFO.

Elastic per-peer liveness: every engine takes ``live=``, a (W,) f32 0/1
device tensor of the workers alive this round, on a state initialized
with ``elastic=True`` (which carries ``buf_live``, the liveness of each
buffered payload's rows).  A dead worker's local step is masked (it
freezes), payloads from or to a dead worker are dropped on the wire (the
eq.-3 all-zero 'no message'), and both masks fold into the blend's
existing ``gate_scale`` operand — no kernel changes.  ``live=None`` on a
non-elastic state is the legacy computation; ``live`` = ones on an
elastic state is bitwise the same.  No host value is read from ``live``.

The multi-device form of the packed rounds — each rank holding a slice of
W, the roll a ring of P2P sends — is launch/mesh.py's regions.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels.gossip_blend import (gossip_blend_w_resident,
                                    gossip_blend_worker_batched)
from .asgd import ASGDConfig
from .packing import (pack_group_mask, pack_spec_w, pack_w, quantize_rows,
                      scale_blocks, unpack_w)
from .parzen import gate_from_terms
from .tree import flatten_sorted, tree_map, unflatten


@dataclasses.dataclass(frozen=True)
class GossipConfig:
    """Gossip parameters.

    shifts: static ring shifts; one is drawn per round.
    partial_blocks: p — each round exchanges ~1/p of the state.
    partial_mode: 'leaves' (static leaf groups) or 'rows' (contiguous
      chunks of the packed rows).
    delay: staleness in rounds (0 blends the block received this round).
    wire_format: None (carrier dtype), "dtype" (cast to payload_dtype and
      back) or "int8" (per-block_rows absmax quantization; the FIFO stays
      int8 and the kernels dequantize in-register).
    payload_dtype: wire dtype (a torch dtype) for wire_format="dtype".
    gossip_every: gossip every k-th step (1 == every step).
    fused_block_rows: row-block size of the packed layout, and the int8
      quantization tile.
    gate_psum_axes: mesh dim name(s) to sum the blends' (W, P, 3) gate
      accumulator over, when the state's non-worker dims are sharded over
      them too (launch/mesh.py's regions); () == no sum.  The
      single-device engines hold no mesh and raise if it is set.
    """

    shifts: tuple = (1, 2, 4, 8)
    partial_blocks: int = 4
    partial_mode: str = "leaves"
    delay: int = 1
    wire_format: Any = None
    payload_dtype: Any = None
    gossip_every: int = 1
    fused_block_rows: int = 64
    gate_psum_axes: tuple = ()


def resolved_wire_format(cfg: GossipConfig):
    """GossipConfig.wire_format as None | "dtype" | "int8"."""
    wf = cfg.wire_format
    if wf is None:
        return "dtype" if cfg.payload_dtype is not None else None
    if wf == "dtype":
        if cfg.payload_dtype is None:
            raise ValueError('wire_format="dtype" requires payload_dtype')
        return "dtype"
    if wf == "int8":
        if cfg.payload_dtype is not None:
            raise ValueError(
                'wire_format="int8" ignores payload_dtype — remove '
                "payload_dtype or use wire_format=\"dtype\"")
        return "int8"
    raise ValueError(f"unknown wire_format {wf!r} "
                     '(expected None, "dtype" or "int8")')


def int8_scale(absmax):
    """(scale, inv) of the pytree engine's int8 wire from f32 absmaxes:
    ``absmax / 127`` as the reference's jitted engines compute it (a
    multiply by the f32 reciprocal, as in packing.quantize_rows), and its
    reciprocal, 0 where the scale is (an all-zero leaf stays zero)."""
    scale = absmax * (1.0 / 127.0)
    pos = scale > 0.0
    inv = torch.where(pos, 1.0 / torch.where(pos, scale,
                                             torch.ones_like(scale)),
                      torch.zeros_like(scale))
    return scale, inv


def int8_codes(x32, inv):
    """The int8 wire's codes of f32 values, as f32: round(x / scale)."""
    return torch.clamp(torch.round(x32 * inv), -127.0, 127.0)


def _fake_quant_leaf(x):
    """Per-worker int8 fake-quant round-trip of one (W, ...) leaf — the
    pytree engine's stand-in for the int8 wire: one absmax scale per
    worker per leaf, zeros stay exactly zero (eq. 3).  Bitwise the
    reference as its engines run it (:func:`int8_scale`)."""
    x32 = x.float()
    if x.ndim > 1:
        absmax = x32.abs().amax(dim=tuple(range(1, x.ndim)), keepdim=True)
    else:
        absmax = x32.abs()
    scale, inv = int8_scale(absmax)
    return (int8_codes(x32, inv) * scale).to(x.dtype)


def wire_roundtrip(tree, cfg: GossipConfig):
    """The wire's value map on every leaf of a tree (or one tensor): the
    identity, a cast to payload_dtype and back ("dtype"), or the int8
    fake-quant (:func:`_fake_quant_leaf`).  The packed-resident engines'
    int8 wire is a real format instead (quantized_exchange_body)."""
    wf = resolved_wire_format(cfg)
    if wf is None:
        return tree
    if wf == "dtype":
        return tree_map(lambda x: x.to(cfg.payload_dtype).to(x.dtype), tree)
    return tree_map(_fake_quant_leaf, tree)


def draw_gossip_indices(generator: torch.Generator,
                        cfg: GossipConfig) -> tuple[int, int]:
    """(shift_idx, block_idx) for one round, as host ints, from a CPU
    ``torch.Generator``."""
    shift_idx = int(torch.randint(len(cfg.shifts), (), generator=generator))
    block_idx = int(torch.randint(cfg.partial_blocks, (),
                                  generator=generator))
    return shift_idx, block_idx


# ---------------------------------------------------------------------------
# per-peer liveness (elastic mode)
# ---------------------------------------------------------------------------

def roll_live(live, shift_idx: int, cfg: GossipConfig):
    """Receiver-side validity of this round's payload: worker w's slot is
    real iff its sender (w - shift) is alive and w itself is — the same
    ``torch.roll`` as the payload's, so both travel one permutation."""
    return torch.roll(live, cfg.shifts[shift_idx], dims=0) * live


def mask_live_rows(x, live):
    """Zero the worker rows whose liveness is 0 (an all-zero block is
    'no message').  ``torch.where``, not a multiply: live rows pass
    through bitwise and an int8 payload stays int8."""
    if live is None:
        return x
    cond = live.reshape((-1,) + (1,) * (x.ndim - 1)) > 0.0
    return torch.where(cond, x, torch.zeros((), dtype=x.dtype,
                                            device=x.device))


def mask_live_tree(tree, live):
    """:func:`mask_live_rows` over every (W, ...) leaf of a tree."""
    if live is None:
        return tree
    return tree_map(lambda x: mask_live_rows(x, live), tree)


def combine_gate_scale(valid, *lives):
    """Fold the staleness guard (a host float or None) and per-peer
    liveness vectors into the one ``gate_scale`` operand of the blends;
    None entries are skipped, all None gives None."""
    out = valid
    for lv in lives:
        if lv is None:
            continue
        out = lv if out is None else out * lv
    return out


def _resolve_live(state_is_elastic: bool, live, n_workers: int, device,
                  engine: str):
    """This round's liveness: all alive on an elastic state when the
    caller passes nothing; ``live=`` on a non-elastic state raises (its
    carried structure has no ``buf_live``)."""
    if state_is_elastic:
        if live is None:
            return torch.ones((n_workers,), dtype=torch.float32,
                              device=device)
        return live.to(dtype=torch.float32)
    if live is not None:
        raise ValueError(
            f"{engine}: live= requires a state initialized with "
            "elastic=True (the carried buf_live mask cannot appear mid-run)")
    return None


def staleness_valid(step: int, cfg: GossipConfig, *, extra: int = 0,
                    depth: int | None = None):
    """Warm-up staleness guard: with FIFO depth D (default ``cfg.delay +
    extra``; ``extra=1`` is the pipelined engine's in-flight round) the
    blocks blended on the first D gossip rounds are zero placeholders, not
    received blocks — gate them out explicitly.  Returns None when D == 0,
    else 1.0 or 0.0 (a host float: the step counter lives on the host)."""
    if depth is None:
        depth = cfg.delay + extra
    if depth == 0:
        return None
    return 1.0 if step >= depth * max(1, cfg.gossip_every) else 0.0


def leaf_groups(params, p: int):
    """Assign each leaf a static group id in [0, p) — greedy size balancing
    over the sorted-key leaf order (the reference's, so both packages build
    the same layout).  Returns a tree of Python ints."""
    leaves, treedef = flatten_sorted(params)
    sizes = [int(l.numel()) for l in leaves]
    order = sorted(range(len(leaves)), key=lambda i: -sizes[i])
    loads = [0] * p
    gid = [0] * len(leaves)
    for i in order:
        g = min(range(p), key=lambda j: loads[j])
        gid[i] = g
        loads[g] += sizes[i]
    return unflatten(treedef, gid)


# ---------------------------------------------------------------------------
# pytree engine: exchange ('leaves' groups or 'rows' slices)
# ---------------------------------------------------------------------------

def exchange_leaves(params, groups, shift_idx: int, block_idx: int,
                    cfg: GossipConfig):
    """This round's peer block in 'leaves' mode, full-tree shaped: the
    leaves of group ``block_idx`` through the wire, rolled by
    ``cfg.shifts[shift_idx]`` along the worker axis; every other leaf is a
    local zero (never sent, untouched by the wire)."""
    shift = cfg.shifts[shift_idx]

    def f(x, gi):
        if gi != block_idx:
            return torch.zeros_like(x)
        return torch.roll(wire_roundtrip(x, cfg), shift, dims=0)
    return tree_map(f, params, groups)


def _block_size(dim: int, p: int) -> int:
    return max(1, -(-dim // p))


def _block_start(x, block_idx: int, p: int) -> tuple[int, int]:
    """(start, size) of block ``block_idx`` along dim 1; the last block is
    clamped inside the leaf, so blocks may overlap."""
    blk = _block_size(x.shape[1], p)
    return min(block_idx * blk, x.shape[1] - blk), blk


def slice_rows(tree, block_idx: int, p: int):
    """A 1/p block of every leaf along dim 1 (the first non-worker dim), as
    views; leaves with fewer than 2 dims are passed whole."""
    def f(x):
        if x.ndim < 2:
            return x
        start, blk = _block_start(x, block_idx, p)
        return x[:, start:start + blk]
    return tree_map(f, tree)


def update_rows(tree, block_tree, block_idx: int, p: int):
    """Inverse of :func:`slice_rows`: write the blocks back into ``tree``'s
    leaves IN PLACE (its callers pass freshly computed states) and return
    the tree; a leaf with fewer than 2 dims is replaced by its block."""
    def f(x, b):
        if x.ndim < 2:
            return b.to(x.dtype)
        start, blk = _block_start(x, block_idx, p)
        x[:, start:start + blk] = b.to(x.dtype)
        return x
    return tree_map(f, tree, block_tree)


def exchange_rows(tree, shift_idx: int, cfg: GossipConfig):
    """Ring exchange of a row-block tree: every leaf rolled by
    ``cfg.shifts[shift_idx]`` along the worker axis."""
    shift = cfg.shifts[shift_idx]
    return tree_map(lambda x: torch.roll(x, shift, dims=0), tree)


# ---------------------------------------------------------------------------
# pytree engine: gate and blend
# ---------------------------------------------------------------------------

def _sum_rest(x):
    """Sum over every axis but the worker axis: (W, ...) -> (W,)."""
    return x.sum(dim=tuple(range(1, x.ndim))) if x.ndim > 1 else x


def _selected(groups, block_idx, n):
    """Per leaf: does it take part?  All leaves without a group tree, else
    those of group ``block_idx``."""
    if groups is None:
        return [True] * n
    return [gi == block_idx for gi in flatten_sorted(groups)[0]]


def _worker_zeros(leaf):
    return torch.zeros((leaf.shape[0],), dtype=torch.float32,
                       device=leaf.device)


def _per_worker_sq_dist(a, b, mask_tree=None, block_idx=None):
    """sum over leaves and non-worker axes of (a - b)^2 -> (W,); with a
    group tree only the leaves of group ``block_idx`` contribute."""
    al, bl = flatten_sorted(a)[0], flatten_sorted(b)[0]
    total = _worker_zeros(al[0])
    for x, y, sel in zip(al, bl, _selected(mask_tree, block_idx, len(al))):
        if sel:
            total = total + _sum_rest((x.float() - y.float()) ** 2)
    return total


def _per_worker_reduce3(params, grads, ext, mask_tree=None, block_idx=None):
    """All three eq.-4 terms in one traversal, each (W,):
    dot = <dw, w - ext>, sq_dw = ||dw||^2, sq_ext = ||ext||^2, summed leaf
    by leaf and then across leaves; with a group tree only the leaves of
    group ``block_idx`` contribute (to every term)."""
    wl, gl, el = (flatten_sorted(t)[0] for t in (params, grads, ext))
    dot = sq_dw = sq_ext = _worker_zeros(wl[0])
    for x, d, e, sel in zip(wl, gl, el,
                            _selected(mask_tree, block_idx, len(wl))):
        if not sel:
            continue
        x32, d32, e32 = x.float(), d.float(), e.float()
        dot = dot + _sum_rest(d32 * (x32 - e32))
        sq_dw = sq_dw + _sum_rest(d32 * d32)
        sq_ext = sq_ext + _sum_rest(e32 * e32)
    return dot, sq_dw, sq_ext


def _gossip_gate(params, grads, ext, acfg: ASGDConfig, mask_tree=None,
                 block_idx=None, *, single_sweep: bool = True):
    """Per-worker admission gate (eq. 3 x eq. 4) -> (W,) f32, in plain
    torch (the ``use_fused=False`` path).  single_sweep=True evaluates the
    expanded identity from :func:`_per_worker_reduce3`; False the direct
    four-traversal form (stepped state, two distances, the zero test)."""
    if single_sweep:
        dot, sq_dw, sq_ext = _per_worker_reduce3(
            params, grads, ext, mask_tree, block_idx)
        return gate_from_terms(dot, sq_dw, sq_ext, acfg.eps,
                               use_parzen=acfg.use_parzen)
    stepped = tree_map(lambda w, g: w.float() - acfg.eps * g.float(),
                       params, grads)
    d_after = _per_worker_sq_dist(stepped, ext, mask_tree, block_idx)
    d_before = _per_worker_sq_dist(params, ext, mask_tree, block_idx)
    nonempty = _per_worker_sq_dist(ext, tree_map(torch.zeros_like, ext),
                                   mask_tree, block_idx) > 0.0
    if acfg.use_parzen:
        return ((d_after < d_before) & nonempty).float()
    return nonempty.float()


def _blend(w_blk, ext_blk, g_blk, gate, acfg: ASGDConfig):
    """Eq. (5)/(6) with one external on one leaf:
    attraction = gate * (w - ext) / 2;
    paper: w - eps*(attraction + dw); elastic: (w - eps*dw) - alpha*att."""
    gexp = gate.reshape((-1,) + (1,) * (w_blk.ndim - 1))
    w32 = w_blk.float()
    attraction = gexp * 0.5 * (w32 - ext_blk.float())
    if acfg.elastic:
        out = (w32 - acfg.eps * g_blk.float()
               - acfg.elastic_alpha * attraction)
    else:
        out = w32 - acfg.eps * (attraction + g_blk.float())
    return out.to(w_blk.dtype)


def blend_group(params, grads, ext, groups, ext_idx, gate,
                acfg: ASGDConfig):
    """'leaves' mode's plain update: every leaf of group ``ext_idx``
    blended with its external under ``gate`` (:func:`_blend`), the rest
    stepped ``w - eps*dw``."""
    def upd(w, g, e, gi):
        if gi == ext_idx:
            return _blend(w, e, g, gate, acfg)
        return (w.float() - acfg.eps * g.float()).to(w.dtype)
    return tree_map(upd, params, grads, ext, groups)


def _fused_blend(params, grads, ext, cfg: GossipConfig, acfg: ASGDConfig,
                 groups=None, ext_idx=None, gate_scale=None, *, mesh=None,
                 reduce_groups=None):
    """Gate + blend through the worker-batched kernels B2r/B2a (both modes).

    Each round packs params, grads and ext once into the plain
    ``(W, R, LANE)`` layout (no group-contiguous spec: the reference's
    dataflow), runs both kernel passes, and unpacks the result as views of
    one buffer.  'leaves' mode (groups given, p > 1) restricts the blend to
    partition ``ext_idx`` with one worker-shared (R, LANE) mask
    (packing.pack_group_mask); 'rows' mode passes block trees and no mask.
    ``mesh``: the DeviceMesh ``cfg.gate_psum_axes`` name dims of.
    ``reduce_groups``: group ids for the gate sums alone, where they differ
    from ``groups`` (a leaf whose terms another rank adds has an id no
    round draws).  Returns (blended tree, gate (W,))."""
    spec = pack_spec_w(params, block_rows=cfg.fused_block_rows)
    w3 = pack_w(params, spec)
    mask2 = (pack_group_mask(groups, ext_idx, spec, device=w3.device)
             if groups is not None and cfg.partial_blocks > 1 else None)
    reduce2 = (None if reduce_groups is None else
               pack_group_mask(reduce_groups, ext_idx, spec, device=w3.device))
    out3, gates = gossip_blend_worker_batched(
        w3, pack_w(grads, spec), pack_w(ext, spec)[:, None], acfg.eps,
        mask2d=mask2, reduce_mask2d=reduce2, use_parzen=acfg.use_parzen,
        elastic=acfg.elastic, elastic_alpha=acfg.elastic_alpha,
        psum_axes=cfg.gate_psum_axes or None, mesh=mesh,
        gate_scale=gate_scale)
    return unpack_w(out3, spec), gates[:, 0]


# ---------------------------------------------------------------------------
# pytree engine: the round
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GossipState:
    """Carried between pytree-engine rounds.

    buf: the block received last round ('leaves' mode: full-tree shaped,
      zeros outside the group; 'rows' mode: the block tree), in the
      carrier dtype after the wire round-trip.
    buf_idx: which partition index buf holds (host int).
    step: round counter (host int).
    buf_live: (W,) f32 liveness of buf's worker rows on an elastic state,
      else None.  Transient: checkpoints drop it.
    """

    buf: Any
    buf_idx: int
    step: int
    buf_live: Any = None


def init_gossip_state(params, cfg: GossipConfig,
                      elastic: bool = False) -> GossipState:
    """Zero staleness buffer (eq. 3: all-zero == 'no message yet'; the
    first delayed round is also closed by the staleness guard).
    ``elastic=True`` carries ``buf_live`` at zeros: the buffered slot
    reads as dropped until a real exchange fills it (the join window)."""
    if cfg.partial_mode == "rows":
        buf = tree_map(torch.zeros_like,
                       slice_rows(params, 0, cfg.partial_blocks))
    else:
        buf = tree_map(torch.zeros_like, params)
    live = None
    if elastic:
        live = _worker_zeros(flatten_sorted(params)[0][0])
    return GossipState(buf=buf, buf_idx=0, step=0, buf_live=live)


def _local_round(params, grads, state: GossipState, eps, live=None):
    """Plain local SGD step (dead workers frozen), buffer untouched, step
    bumped, zero gates."""
    zero = _worker_zeros(flatten_sorted(params)[0][0])
    return (local_sgd_apply(params, mask_live_tree(grads, live), eps),
            dataclasses.replace(state, step=state.step + 1),
            {"gate": zero, "n_good": zero.sum()})


def _drop_dead_tree(sent, grads, live, shift_idx: int, cfg: GossipConfig):
    """(sent, grads, sent_live): this round's payload tree with the blocks
    of dead senders and receivers dropped on the wire, the dead workers'
    steps masked (they freeze), and the payload's validity; unchanged,
    with validity None, when ``live`` is None."""
    if live is None:
        return sent, grads, None
    sent_live = roll_live(live, shift_idx, cfg)
    return (mask_live_tree(sent, sent_live), mask_live_tree(grads, live),
            sent_live)


def _apply_leaves(params, grads, state: GossipState, shift_idx: int,
                  block_idx: int, cfg: GossipConfig, acfg: ASGDConfig,
                  live=None):
    groups = leaf_groups(params, cfg.partial_blocks)
    sent, grads, sent_live = _drop_dead_tree(
        exchange_leaves(params, groups, shift_idx, block_idx, cfg), grads,
        live, shift_idx, cfg)
    if cfg.delay == 0:
        ext, ext_idx, valid, ext_live = sent, block_idx, None, sent_live
    else:
        # single-slot buffer: the staleness is one round whatever
        # cfg.delay says, so the guard's depth is 1
        ext, ext_idx, ext_live = state.buf, state.buf_idx, state.buf_live
        valid = staleness_valid(state.step, cfg, depth=1)
    gate_scale = combine_gate_scale(valid, ext_live, live)
    if acfg.use_fused:
        new_params, gate = _fused_blend(params, grads, ext, cfg, acfg,
                                        groups, ext_idx,
                                        gate_scale=gate_scale)
    else:
        gate = _gossip_gate(params, grads, ext, acfg, groups, ext_idx)
        if gate_scale is not None:
            gate = gate * gate_scale
        new_params = blend_group(params, grads, ext, groups, ext_idx, gate,
                                 acfg)
    new_state = GossipState(buf=sent, buf_idx=block_idx,
                            step=state.step + 1, buf_live=sent_live)
    return new_params, new_state, {"gate": gate, "n_good": gate.sum()}


def _apply_rows(params, grads, state: GossipState, shift_idx: int,
                block_idx: int, cfg: GossipConfig, acfg: ASGDConfig,
                live=None):
    p = cfg.partial_blocks
    # the wire round-trip before the roll, as in 'leaves' mode
    sent, grads, sent_live = _drop_dead_tree(
        exchange_rows(wire_roundtrip(slice_rows(params, block_idx, p), cfg),
                      shift_idx, cfg), grads, live, shift_idx, cfg)
    if cfg.delay == 0:
        ext, ext_idx, valid, ext_live = sent, block_idx, None, sent_live
    else:
        ext, ext_idx, ext_live = state.buf, state.buf_idx, state.buf_live
        valid = staleness_valid(state.step, cfg, depth=1)
    gate_scale = combine_gate_scale(valid, ext_live, live)
    local_blk = slice_rows(params, ext_idx, p)
    grads_blk = slice_rows(grads, ext_idx, p)
    if acfg.use_fused:
        blended, gate = _fused_blend(local_blk, grads_blk, ext, cfg, acfg,
                                     gate_scale=gate_scale)
    else:
        gate = _gossip_gate(local_blk, grads_blk, ext, acfg)
        if gate_scale is not None:
            gate = gate * gate_scale
        blended = tree_map(lambda w, e, g: _blend(w, e, g, gate, acfg),
                           local_blk, ext, grads_blk)
    new_params = update_rows(local_sgd_apply(params, grads, acfg.eps),
                             blended, ext_idx, p)
    new_state = GossipState(buf=sent, buf_idx=block_idx,
                            step=state.step + 1, buf_live=sent_live)
    return new_params, new_state, {"gate": gate, "n_good": gate.sum()}


def asgd_gossip_apply(params, grads, state: GossipState, shift_idx: int,
                      block_idx: int, cfg: GossipConfig, acfg: ASGDConfig,
                      live=None):
    """One ASGD round of the pytree engine: local SGD step + gossip blend
    (paper eqs. 4-7).

    params, grads: trees of (W, ...) leaves (grads: the local steps
    Delta_M); state: :class:`GossipState`; shift_idx, block_idx: this
    round's host-int draws (:func:`draw_gossip_indices`).  Silent configs
    and the off-rounds of ``cfg.gossip_every > 1`` take the local step
    only.  ``live``: optional (W,) f32 0/1 per-peer liveness, on a state
    from ``init_gossip_state(elastic=True)``.

    Returns (new_params, new_state, {"gate": (W,), "n_good": scalar})."""
    leaf = flatten_sorted(params)[0][0]
    live = _resolve_live(state.buf_live is not None, live, leaf.shape[0],
                         leaf.device, "asgd_gossip_apply")
    if acfg.silent or (cfg.gossip_every > 1
                       and state.step % cfg.gossip_every):
        return _local_round(params, grads, state, acfg.eps, live)
    apply = _apply_rows if cfg.partial_mode == "rows" else _apply_leaves
    return apply(params, grads, state, shift_idx, block_idx, cfg, acfg,
                 live=live)


def sync_dp_apply(params, grads, eps):
    """Synchronous data-parallel SGD (the paper's BATCH baseline): every
    worker steps with the worker-mean of the steps."""
    return tree_map(
        lambda w, g: w - eps * g.mean(dim=0, keepdim=True).expand_as(g)
        .to(w.dtype), params, grads)


def local_sgd_apply(params, grads, eps):
    """SimuParallelSGD's inner step: purely local, nothing exchanged."""
    return tree_map(lambda w, g: w - eps * g.to(w.dtype), params, grads)


# ---------------------------------------------------------------------------
# packed-resident state
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PackedGossipState:
    """Carried between packed-resident rounds.

    buf: tuple of D staleness-FIFO slots, oldest first — each the
      (W, R, LANE) block received that round, zeros outside the exchanged
      partition's rows; f32 (carrier), or int8 under wire_format="int8".
    buf_scales: tuple of D (W, R // block_rows) f32 dequantization scales
      under int8, else None.
    buf_idx: tuple of D partition indices (host ints) the slots hold.
    step: round counter (host int).
    buf_live: tuple of D (W,) f32 liveness vectors aligned with buf on an
      elastic state, else None.  Transient like buf_scales: checkpoints
      drop it.
    """

    buf: tuple
    buf_idx: tuple
    step: int
    buf_scales: tuple | None = None
    buf_live: tuple | None = None


def fifo_depth(cfg: GossipConfig, *, pipelined: bool = False) -> int:
    """Staleness-FIFO depth of the packed engines: ``delay`` slots (at
    least one), plus the in-flight round when pipelined."""
    return max(1, cfg.delay + (1 if pipelined else 0))


def init_packed_gossip_state(packed, cfg: GossipConfig | None = None,
                             block_rows: int | None = None,
                             depth: int | None = None,
                             elastic: bool = False) -> PackedGossipState:
    """Zero staleness FIFO (eq. 3: all-zero == 'no message yet'; the first
    rounds are also closed by the staleness guard).  Under
    wire_format="int8" (pass the spec's block_rows) the slots are int8
    zeros with zero scales.  ``elastic=True`` carries ``buf_live`` at
    zeros: every slot reads as dropped until a real exchange refills it
    (the join window of a fresh start or an elastic restore)."""
    if depth is None:
        depth = fifo_depth(cfg) if cfg is not None else 1
    wn, rows = packed.shape[:2]
    live = None
    if elastic:
        live = tuple(torch.zeros((wn,), dtype=torch.float32,
                                 device=packed.device) for _ in range(depth))
    if cfg is not None and resolved_wire_format(cfg) == "int8":
        if block_rows is None:
            raise ValueError(
                'init_packed_gossip_state: wire_format="int8" needs '
                "block_rows (spec.block_rows)")
        nb = scale_blocks(rows, block_rows)
        return PackedGossipState(
            buf=tuple(torch.zeros(packed.shape, dtype=torch.int8,
                                  device=packed.device)
                      for _ in range(depth)),
            buf_scales=tuple(torch.zeros((wn, nb), dtype=torch.float32,
                                         device=packed.device)
                             for _ in range(depth)),
            buf_idx=(0,) * depth, step=0, buf_live=live)
    return PackedGossipState(
        buf=tuple(torch.zeros_like(packed) for _ in range(depth)),
        buf_idx=(0,) * depth, step=0, buf_live=live)


def init_pipelined_gossip_state(packed, cfg: GossipConfig,
                                block_rows: int | None = None,
                                elastic: bool = False) -> PackedGossipState:
    """Staleness FIFO of the pipelined engine: depth ``cfg.delay + 1``."""
    return init_packed_gossip_state(packed, cfg, block_rows=block_rows,
                                    depth=fifo_depth(cfg, pipelined=True),
                                    elastic=elastic)


def _fifo_head(state: PackedGossipState):
    """(ext, ext_scales, ext_idx, ext_live) — the OLDEST buffered
    payload."""
    scales = None if state.buf_scales is None else state.buf_scales[0]
    live = None if state.buf_live is None else state.buf_live[0]
    return state.buf[0], scales, state.buf_idx[0], live


def _fifo_push(state: PackedGossipState, sent, sent_scales, block_idx: int,
               sent_live=None) -> PackedGossipState:
    """Drop the oldest payload, append the just-launched one, bump step."""
    scales = live = None
    if sent_scales is not None:
        scales = state.buf_scales[1:] + (sent_scales,)
    if sent_live is not None:
        live = state.buf_live[1:] + (sent_live,)
    return PackedGossipState(buf=state.buf[1:] + (sent,),
                             buf_idx=state.buf_idx[1:] + (int(block_idx),),
                             step=state.step + 1, buf_scales=scales,
                             buf_live=live)


def _silent_round(packed, pgrads, state: PackedGossipState, step_lr,
                  live=None):
    """Plain local SGD step (dead workers frozen), FIFO untouched, step
    bumped, zero gates — the silent-round body shared by the packed
    engines."""
    new_state = dataclasses.replace(state, step=state.step + 1)
    zero = torch.zeros((packed.shape[0],), dtype=torch.float32,
                       device=packed.device)
    return packed - step_lr * mask_live_rows(pgrads, live), new_state, {
        "gate": zero, "n_good": zero.sum()}


def packed_row_ranges(spec, cfg: GossipConfig) -> tuple:
    """Static (row_start, row_end) per partition index on the packed
    layout: the spec's group ranges in 'leaves' mode; p contiguous chunks
    of the packed rows in 'rows' mode (block_rows-aligned under int8, so a
    quantization tile never straddles two partitions)."""
    p = cfg.partial_blocks
    if cfg.partial_mode == "leaves":
        if spec.group_row_ranges is None:
            raise ValueError(
                "packed 'leaves' mode needs a group-contiguous spec: "
                "pack_spec_w(tree, groups=leaf_groups(tree, p), n_groups=p)")
        if len(spec.group_row_ranges) != p:
            raise ValueError(
                f"spec has {len(spec.group_row_ranges)} group ranges, "
                f"cfg.partial_blocks={p}")
        return spec.group_row_ranges
    if resolved_wire_format(cfg) == "int8":
        br = spec.block_rows
        if spec.rows < p * br:
            raise ValueError(
                f"wire_format='int8' 'rows' partitioning is unsatisfiable: "
                f"rows={spec.rows} < partial_blocks={p} * block_rows={br}")

        def bound(g):   # proportional boundary, snapped to block_rows
            return min(int(round(g * spec.rows / p / br)) * br, spec.rows)

        return tuple((bound(g), bound(g + 1)) for g in range(p))
    chunk = -(-spec.rows // p)
    return tuple((min(g * chunk, spec.rows), min((g + 1) * chunk, spec.rows))
                 for g in range(p))


def _roll_packed_rows(packed, r0: int, r1: int, shift: int,
                      cfg: GossipConfig):
    """Float wire: rows [r0, r1) of every worker rolled by ``shift`` along
    W; all other rows are zeros — they were never sent."""
    out = torch.zeros_like(packed)
    out[:, r0:r1] = torch.roll(wire_roundtrip(packed[:, r0:r1], cfg), shift,
                               dims=0)
    return out


def quantized_exchange_body(packed, r0: int, r1: int, block_rows: int,
                            roll):
    """int8 wire: quantize rows [r0, r1), move the int8 payload and its
    per-block_rows scales with ``roll``, scatter both into full-size zero
    buffers.  Returns (q (W, R, LANE) int8, scales (W, R // block_rows))."""
    wn, rows = packed.shape[:2]
    nb = scale_blocks(rows, block_rows)
    q, s = quantize_rows(packed[:, r0:r1], block_rows)
    q, s = roll(q), roll(s)
    full_q = torch.zeros(packed.shape, dtype=torch.int8, device=packed.device)
    full_q[:, r0:r1] = q
    full_s = torch.zeros((wn, nb), dtype=torch.float32, device=packed.device)
    full_s[:, r0 // block_rows:r1 // block_rows] = s
    return full_q, full_s


def exchange_packed(packed, ranges, shift_idx: int, block_idx: int,
                    cfg: GossipConfig, block_rows: int | None = None):
    """This round's payload: partition ``block_idx``'s rows rolled by
    ``cfg.shifts[shift_idx]`` along the worker axis.  Returns the f32 block,
    or the (q, scales) pair under wire_format="int8" (pass block_rows)."""
    shift = cfg.shifts[shift_idx]
    r0, r1 = ranges[block_idx]
    with torch.no_grad():
        if resolved_wire_format(cfg) == "int8":
            if block_rows is None:
                raise ValueError(
                    'exchange_packed: wire_format="int8" needs block_rows '
                    "(spec.block_rows)")
            return quantized_exchange_body(
                packed, r0, r1, block_rows,
                lambda x: torch.roll(x, shift, dims=0))
        return _roll_packed_rows(packed, r0, r1, shift, cfg)


def _blend_head(packed, pgrads, state, valid, cfg, acfg, spec, lr,
                live=None):
    """Blend the FIFO head into the ensemble (both kernel passes); the
    staleness guard, the head's recorded liveness and this round's fold
    into the gates' one ``gate_scale``."""
    ext, ext_scales, ext_idx, ext_live = _fifo_head(state)
    ranges = packed_row_ranges(spec, cfg)
    new_packed, gates = gossip_blend_w_resident(
        packed, pgrads, ext[:, None], ranges[ext_idx], acfg.eps, lr=lr,
        ext_scales=None if ext_scales is None else ext_scales[:, None],
        use_parzen=acfg.use_parzen, elastic=acfg.elastic,
        elastic_alpha=acfg.elastic_alpha, block_rows=spec.block_rows,
        psum_axes=cfg.gate_psum_axes or None,
        gate_scale=combine_gate_scale(valid, ext_live, live))
    return new_packed, gates[:, 0]


def _drop_dead(sent, sent_scales, live, shift_idx: int, cfg: GossipConfig):
    """This round's payload (and its int8 scales) with the rows of dead
    senders and receivers dropped, and its launch-time validity."""
    sent_live = roll_live(live, shift_idx, cfg)
    if sent_scales is not None:
        sent_scales = mask_live_rows(sent_scales, sent_live)
    return mask_live_rows(sent, sent_live), sent_scales, sent_live


def asgd_gossip_apply_packed(packed, pgrads, state: PackedGossipState,
                             shift_idx: int, block_idx: int,
                             cfg: GossipConfig, acfg: ASGDConfig, spec,
                             live=None):
    """One packed-resident ASGD round (the unpipelined engine).

    Exchange partition ``block_idx`` with shift ``cfg.shifts[shift_idx]``,
    blend the block launched ``delay`` rounds ago (the FIFO head; the
    just-launched block when delay == 0) through the gossip-blend kernels,
    push the new block.  At ``delay + 1`` this is the pipelined engine's
    parity oracle.

    packed, pgrads: (W, R, LANE) f32 ensemble and packed local steps.
    live: optional (W,) f32 0/1 per-peer liveness (elastic state).
    Returns (new_packed, new_state, {"gate": (W,), "n_good": scalar}).
    """
    live = _resolve_live(state.buf_live is not None, live, packed.shape[0],
                         packed.device, "asgd_gossip_apply_packed")
    if acfg.silent or (cfg.gossip_every > 1
                       and state.step % cfg.gossip_every):
        return _silent_round(packed, pgrads, state, acfg.eps, live)
    ranges = packed_row_ranges(spec, cfg)
    sent = exchange_packed(packed, ranges, shift_idx, block_idx, cfg,
                           block_rows=spec.block_rows)
    sent, sent_scales = sent if isinstance(sent, tuple) else (sent, None)
    sent_live = None
    if live is not None:
        sent, sent_scales, sent_live = _drop_dead(sent, sent_scales, live,
                                                  shift_idx, cfg)
        pgrads = mask_live_rows(pgrads, live)
    if cfg.delay == 0:
        head = PackedGossipState(
            buf=(sent,), buf_idx=(block_idx,), step=state.step,
            buf_scales=None if sent_scales is None else (sent_scales,),
            buf_live=None if sent_live is None else (sent_live,))
        valid = None
    else:
        head = state
        valid = staleness_valid(state.step, cfg)
    new_packed, gate = _blend_head(packed, pgrads, head, valid, cfg, acfg,
                                   spec, None, live)
    new_state = _fifo_push(state, sent, sent_scales, block_idx, sent_live)
    return new_packed, new_state, {"gate": gate, "n_good": gate.sum()}


def initiate_exchange_packed(packed, shift_idx: int, block_idx: int,
                             cfg: GossipConfig, spec, live=None):
    """The INITIATE half of the pipelined round: launch this round's
    payload from the CURRENT (pre-blend) ensemble.  Returns (sent,
    sent_scales, block_idx); sent_scales is None except under int8.  With
    ``live`` the rows of dead senders and receivers are dropped and a
    fourth element, ``sent_live`` (W,), carries the launch-time validity
    to the consume half."""
    ranges = packed_row_ranges(spec, cfg)
    sent = exchange_packed(packed, ranges, shift_idx, block_idx, cfg,
                           block_rows=spec.block_rows)
    sent, sent_scales = sent if isinstance(sent, tuple) else (sent, None)
    if live is None:
        return sent, sent_scales, block_idx
    sent, sent_scales, sent_live = _drop_dead(
        sent, sent_scales, live.to(dtype=torch.float32), shift_idx, cfg)
    return sent, sent_scales, block_idx, sent_live


def consume_exchange_packed(packed, pgrads, state: PackedGossipState, sent,
                            sent_scales, block_idx: int, cfg: GossipConfig,
                            acfg: ASGDConfig, spec, lr=None, sent_live=None,
                            live=None):
    """The CONSUME half: blend the FIFO head — the payload launched
    ``cfg.delay + 1`` rounds ago — with the eq.-1 step fused in-kernel
    (``lr``, default acfg.eps), then push the just-launched payload.  The
    first delay+1 rounds blend placeholders and are gated out.  On an
    elastic state ``sent_live`` is the launch-time validity from the
    initiate half (all alive when None) and ``live`` this round's
    liveness: the head's recorded validity and ``live`` both gate."""
    live = _resolve_live(state.buf_live is not None, live, packed.shape[0],
                         packed.device, "consume_exchange_packed")
    if live is not None:
        if sent_live is None:
            sent_live = torch.ones_like(live)
        pgrads = mask_live_rows(pgrads, live)
    valid = staleness_valid(state.step, cfg, extra=1)
    new_packed, gate = _blend_head(packed, pgrads, state, valid, cfg, acfg,
                                   spec, lr, live)
    new_state = _fifo_push(state, sent, sent_scales, block_idx, sent_live)
    return new_packed, new_state, {"gate": gate, "n_good": gate.sum()}


def asgd_gossip_apply_pipelined(packed, pgrads, state: PackedGossipState,
                                shift_idx: int, block_idx: int,
                                cfg: GossipConfig, acfg: ASGDConfig, spec,
                                lr=None, live=None):
    """One PIPELINED packed-resident round: initiate + consume composed.
    Effective staleness ``cfg.delay + 1``: bitwise equal to
    :func:`asgd_gossip_apply_packed` at ``delay + 1`` on the same indices.
    ``state`` comes from :func:`init_pipelined_gossip_state`; ``live`` as
    in :func:`asgd_gossip_apply_packed`."""
    step_lr = acfg.eps if lr is None else lr
    live = _resolve_live(state.buf_live is not None, live, packed.shape[0],
                         packed.device, "asgd_gossip_apply_pipelined")
    if acfg.silent or (cfg.gossip_every > 1
                       and state.step % cfg.gossip_every):
        return _silent_round(packed, pgrads, state, step_lr, live)
    sent = initiate_exchange_packed(packed, shift_idx, block_idx, cfg, spec,
                                    live=live)
    sent_live = sent[3] if live is not None else None
    return consume_exchange_packed(packed, pgrads, state, *sent[:3], cfg,
                                   acfg, spec, lr=lr, sent_live=sent_live,
                                   live=live)


def final_average(params):
    """SimuParallelSGD final aggregation (alg. 3 line 9) / ASGD's optional
    MapReduce aggregate (paper §4.3): every worker gets the worker mean."""
    leaves, treedef = flatten_sorted(params)
    return unflatten(treedef, [
        x.mean(dim=0, keepdim=True).expand_as(x) for x in leaves])
