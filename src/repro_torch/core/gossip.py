"""Packed-resident and pipelined ASGD gossip rounds (paper eqs. 4-7).

The packed ``(W, R, LANE)`` ensemble of W worker replicas (core/packing.py
pack_w on a group-contiguous spec) is the carried training state.  One
round: draw a (shift, partition) pair; exchange the partition's packed
rows with a ring peer (``torch.roll`` along W, which is the collective
permute when one device holds all workers); blend a past round's received
block through the Parzen gate with the two gossip-blend kernels.

Randomness: the reference draws (shift_idx, block_idx) with ``jax.random``
inside the round.  Here they are explicit host-int arguments of every
engine function — :func:`draw_gossip_indices` draws them from a
``torch.Generator`` — so the partition's row range reaches the kernels by
value with no device sync, and the tests can replay the reference's draws.

The staleness FIFO (``PackedGossipState.buf``) is a tuple of D slots,
oldest first, where the reference stacks a leading depth axis: a push is
then a tuple shift, not a copy of the whole FIFO.

Not ported yet (ROADMAP.md queue A): the pytree engine
(``asgd_gossip_apply``, ``GossipState``), elastic per-peer liveness
(``live``/``buf_live``), and the multi-device transports.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..kernels.gossip_blend import gossip_blend_w_resident
from .asgd import ASGDConfig
from .packing import quantize_rows, scale_blocks
from .tree import flatten_sorted, unflatten


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
    """

    shifts: tuple = (1, 2, 4, 8)
    partial_blocks: int = 4
    partial_mode: str = "leaves"
    delay: int = 1
    wire_format: Any = None
    payload_dtype: Any = None
    gossip_every: int = 1
    fused_block_rows: int = 64


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


def wire_roundtrip(x, cfg: GossipConfig):
    """The float wire's value map on a block: identity, or a cast to
    payload_dtype and back ("dtype").  The int8 wire is a real format
    (quantized_exchange_body), not a value map."""
    if resolved_wire_format(cfg) == "dtype":
        return x.to(cfg.payload_dtype).to(x.dtype)
    return x


def draw_gossip_indices(generator: torch.Generator,
                        cfg: GossipConfig) -> tuple[int, int]:
    """(shift_idx, block_idx) for one round, as host ints, from a CPU
    ``torch.Generator``."""
    shift_idx = int(torch.randint(len(cfg.shifts), (), generator=generator))
    block_idx = int(torch.randint(cfg.partial_blocks, (),
                                  generator=generator))
    return shift_idx, block_idx


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
    """

    buf: tuple
    buf_idx: tuple
    step: int
    buf_scales: tuple | None = None


def fifo_depth(cfg: GossipConfig, *, pipelined: bool = False) -> int:
    """Staleness-FIFO depth of the packed engines: ``delay`` slots (at
    least one), plus the in-flight round when pipelined."""
    return max(1, cfg.delay + (1 if pipelined else 0))


def init_packed_gossip_state(packed, cfg: GossipConfig | None = None,
                             block_rows: int | None = None,
                             depth: int | None = None) -> PackedGossipState:
    """Zero staleness FIFO (eq. 3: all-zero == 'no message yet'; the first
    rounds are also closed by the staleness guard).  Under
    wire_format="int8" (pass the spec's block_rows) the slots are int8
    zeros with zero scales."""
    if depth is None:
        depth = fifo_depth(cfg) if cfg is not None else 1
    wn, rows = packed.shape[:2]
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
            buf_idx=(0,) * depth, step=0)
    return PackedGossipState(
        buf=tuple(torch.zeros_like(packed) for _ in range(depth)),
        buf_idx=(0,) * depth, step=0)


def init_pipelined_gossip_state(packed, cfg: GossipConfig,
                                block_rows: int | None = None
                                ) -> PackedGossipState:
    """Staleness FIFO of the pipelined engine: depth ``cfg.delay + 1``."""
    return init_packed_gossip_state(packed, cfg, block_rows=block_rows,
                                    depth=fifo_depth(cfg, pipelined=True))


def _fifo_head(state: PackedGossipState):
    """(ext, ext_scales, ext_idx) — the OLDEST buffered payload."""
    scales = None if state.buf_scales is None else state.buf_scales[0]
    return state.buf[0], scales, state.buf_idx[0]


def _fifo_push(state: PackedGossipState, sent, sent_scales,
               block_idx: int) -> PackedGossipState:
    """Drop the oldest payload, append the just-launched one, bump step."""
    scales = None
    if sent_scales is not None:
        scales = state.buf_scales[1:] + (sent_scales,)
    return PackedGossipState(buf=state.buf[1:] + (sent,),
                             buf_idx=state.buf_idx[1:] + (int(block_idx),),
                             step=state.step + 1, buf_scales=scales)


def _silent_round(packed, pgrads, state: PackedGossipState, step_lr):
    """Plain local SGD step, FIFO untouched, step bumped, zero gates — the
    silent-round body shared by the packed engines."""
    new_state = dataclasses.replace(state, step=state.step + 1)
    zero = torch.zeros((packed.shape[0],), dtype=torch.float32,
                       device=packed.device)
    return packed - step_lr * pgrads, new_state, {
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


def _blend_head(packed, pgrads, state, valid, cfg, acfg, spec, lr):
    """Blend the FIFO head into the ensemble (both kernel passes)."""
    ext, ext_scales, ext_idx = _fifo_head(state)
    ranges = packed_row_ranges(spec, cfg)
    new_packed, gates = gossip_blend_w_resident(
        packed, pgrads, ext[:, None], ranges[ext_idx], acfg.eps, lr=lr,
        ext_scales=None if ext_scales is None else ext_scales[:, None],
        use_parzen=acfg.use_parzen, elastic=acfg.elastic,
        elastic_alpha=acfg.elastic_alpha, block_rows=spec.block_rows,
        gate_scale=valid)
    return new_packed, gates[:, 0]


def asgd_gossip_apply_packed(packed, pgrads, state: PackedGossipState,
                             shift_idx: int, block_idx: int,
                             cfg: GossipConfig, acfg: ASGDConfig, spec):
    """One packed-resident ASGD round (the unpipelined engine).

    Exchange partition ``block_idx`` with shift ``cfg.shifts[shift_idx]``,
    blend the block launched ``delay`` rounds ago (the FIFO head; the
    just-launched block when delay == 0) through the gossip-blend kernels,
    push the new block.  At ``delay + 1`` this is the pipelined engine's
    parity oracle.

    packed, pgrads: (W, R, LANE) f32 ensemble and packed local steps.
    Returns (new_packed, new_state, {"gate": (W,), "n_good": scalar}).
    """
    if acfg.silent:
        return _silent_round(packed, pgrads, state, acfg.eps)
    if cfg.gossip_every > 1 and state.step % cfg.gossip_every:
        return _silent_round(packed, pgrads, state, acfg.eps)
    ranges = packed_row_ranges(spec, cfg)
    sent = exchange_packed(packed, ranges, shift_idx, block_idx, cfg,
                           block_rows=spec.block_rows)
    sent, sent_scales = sent if isinstance(sent, tuple) else (sent, None)
    if cfg.delay == 0:
        head = PackedGossipState(
            buf=(sent,), buf_idx=(block_idx,), step=state.step,
            buf_scales=None if sent_scales is None else (sent_scales,))
        valid = None
    else:
        head = state
        valid = staleness_valid(state.step, cfg)
    new_packed, gate = _blend_head(packed, pgrads, head, valid, cfg, acfg,
                                   spec, None)
    new_state = _fifo_push(state, sent, sent_scales, block_idx)
    return new_packed, new_state, {"gate": gate, "n_good": gate.sum()}


def initiate_exchange_packed(packed, shift_idx: int, block_idx: int,
                             cfg: GossipConfig, spec):
    """The INITIATE half of the pipelined round: launch this round's
    payload from the CURRENT (pre-blend) ensemble.  Returns (sent,
    sent_scales, block_idx); sent_scales is None except under int8."""
    ranges = packed_row_ranges(spec, cfg)
    sent = exchange_packed(packed, ranges, shift_idx, block_idx, cfg,
                           block_rows=spec.block_rows)
    sent, sent_scales = sent if isinstance(sent, tuple) else (sent, None)
    return sent, sent_scales, block_idx


def consume_exchange_packed(packed, pgrads, state: PackedGossipState, sent,
                            sent_scales, block_idx: int, cfg: GossipConfig,
                            acfg: ASGDConfig, spec, lr=None):
    """The CONSUME half: blend the FIFO head — the payload launched
    ``cfg.delay + 1`` rounds ago — with the eq.-1 step fused in-kernel
    (``lr``, default acfg.eps), then push the just-launched payload.  The
    first delay+1 rounds blend placeholders and are gated out."""
    valid = staleness_valid(state.step, cfg, extra=1)
    new_packed, gate = _blend_head(packed, pgrads, state, valid, cfg, acfg,
                                   spec, lr)
    new_state = _fifo_push(state, sent, sent_scales, block_idx)
    return new_packed, new_state, {"gate": gate, "n_good": gate.sum()}


def asgd_gossip_apply_pipelined(packed, pgrads, state: PackedGossipState,
                                shift_idx: int, block_idx: int,
                                cfg: GossipConfig, acfg: ASGDConfig, spec,
                                lr=None):
    """One PIPELINED packed-resident round: initiate + consume composed.
    Effective staleness ``cfg.delay + 1``: bitwise equal to
    :func:`asgd_gossip_apply_packed` at ``delay + 1`` on the same indices.
    ``state`` comes from :func:`init_pipelined_gossip_state`."""
    step_lr = acfg.eps if lr is None else lr
    if acfg.silent:
        return _silent_round(packed, pgrads, state, step_lr)
    if cfg.gossip_every > 1 and state.step % cfg.gossip_every:
        return _silent_round(packed, pgrads, state, step_lr)
    sent, sent_scales, block_idx = initiate_exchange_packed(
        packed, shift_idx, block_idx, cfg, spec)
    return consume_exchange_packed(packed, pgrads, state, sent, sent_scales,
                                   block_idx, cfg, acfg, spec, lr=lr)


def final_average(params):
    """SimuParallelSGD final aggregation (alg. 3 line 9) / ASGD's optional
    MapReduce aggregate (paper §4.3): every worker gets the worker mean."""
    leaves, treedef = flatten_sorted(params)
    return unflatten(treedef, [
        x.mean(dim=0, keepdim=True).expand_as(x) for x in leaves])
