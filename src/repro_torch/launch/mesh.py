"""Mesh construction and the manual-region gossip rounds over
``torch.distributed``.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names: ``("data", "model")`` (the production (16, 16)) or
``("pod", "data", "model")`` (2, 16, 16).  One process (rank) per mesh
point.  The ASGD worker axis W is laid over the worker axes (pod+)data:
the rank at worker coordinate i holds workers [i·W_local, (i+1)·W_local)
— its ``(W_local, R, LANE)`` slice — and every rank of a worker
coordinate holds the same slice (replicated over ``model``).  A
``("pod", "data")`` worker axis is the flattened group, pod-major, as jax
orders the combined axis.

A *region* is the program the reference's ``shard_map`` runs on each
shard, written out: a callable every rank calls with its OWN slices.  The
exchange inside it is the paper's one-peer send: this round's partition
rows (never the full-size zero-padded buffer) go to the ring peer by
``dist.batch_isend_irecv`` on the worker group, landing where
``torch.roll`` along the global W would put them.  The blend is the
resident kernel pair B1r/B1a on the local slice.

Transport: NCCL for CUDA tensors (one GPU per rank), gloo for CPU tensors.
A tensor on a group of the other kind raises; nothing is staged through
the host.  Rendezvous is a file the caller names (:func:`init_ranks`).
``meta`` tensors (the dry-run's trace of one rank, ``launch/dryrun.py``)
travel nowhere: the transports make the outputs of their shapes, dtypes
and device, by the same ops as for a real tensor, and send nothing (the
dry-run plans those bytes, ``hlo_analysis.planned_collectives``).

Every rank must call a region with the same host ints ``shift_idx``,
``block_idx``, ``step`` and ``buf_idx``/``ext_idx``: they select the
static row range and the ring peers, and ranks that disagree pair the
wrong sends and receives, or hang.  ``core.gossip.draw_gossip_indices``
with one seed on every rank draws them so.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.distributed as dist

from .. import resolve_device
from ..core.gossip import (combine_gate_scale, mask_live_rows,
                           packed_row_ranges, quantized_exchange_body,
                           resolved_wire_format, staleness_valid,
                           wire_roundtrip)
from ..kernels.gossip_blend import gossip_blend_w_resident

WORKER_AXES = ("pod", "data")


# ---------------------------------------------------------------------------
# process group and mesh construction
# ---------------------------------------------------------------------------

def init_ranks(store_path: str, rank: int, world_size: int,
               device=None) -> torch.device:
    """Join the process group through the file ``store_path`` (every rank
    names the same file; no TCP port): NCCL for ``cuda`` (the default),
    gloo for ``cpu``.  On CUDA each rank takes the GPU ``rank % count``.
    Returns the device."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = {"cuda": "nccl", "cpu": "gloo"}.get(dev.type)
    if backend is None:
        raise ValueError(f"no transport for device {dev}: cuda (NCCL) or "
                         "cpu (gloo)")
    dist.init_process_group(backend, store=dist.FileStore(store_path,
                                                          world_size),
                            rank=rank, world_size=world_size)
    return dev


def _auto_mesh(shape, axes, device=None):
    """A DeviceMesh of ``shape`` over the whole process group, its dims
    named ``axes``, row-major over the global ranks."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_ranks (or "
                           "torch.distributed.init_process_group) first")
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks; the process group has {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(resolve_device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))


@contextlib.contextmanager
def mesh_context(mesh):
    """``mesh`` as the ambient mesh of ``models/hints.py constrain`` inside
    the block (the previous one restored after it).  The regions take
    their mesh as an argument and need none."""
    from ..models import hints
    hints.push_mesh(mesh)
    try:
        yield mesh
    finally:
        hints.pop_mesh()


@contextlib.contextmanager
def fake_process_group(world_size: int, rank: int = 0):
    """This process as rank ``rank`` of a "fake" process group of
    ``world_size`` ranks (``torch.testing``'s FakeStore: collectives
    return at once and move nothing), for building a production-size
    ``DeviceMesh`` in one process — the dry-run's.  The group is destroyed
    on exit, so ``dist.is_initialized()`` is false again."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(16, 16) ``("data", "model")``, or (2, 16, 16) ``("pod", "data",
    "model")``; raises unless the process group has that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _auto_mesh(shape, axes, device)


def make_host_mesh(data: int = 2, model: int = 2, device=None):
    """A small ``("data", "model")`` mesh: ``data`` clamped to the ranks
    the process group has (``model`` of them per data coordinate)."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = min(data, max(1, n // model))
    return _auto_mesh((data, model), ("data", "model"), device)


def _dim_size(mesh, name: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(name)]


def data_axes(mesh) -> tuple:
    """The axes the ASGD worker dimension is sharded over."""
    return tuple(a for a in mesh.mesh_dim_names if a in WORKER_AXES)


def n_worker_groups(mesh) -> int:
    return math.prod(_dim_size(mesh, a) for a in data_axes(mesh))


def local_worker_count(mesh, n_workers: int | None = None) -> int:
    """Worker replicas resident on ONE rank of the worker axes: W divided
    by the number of worker coordinates (W defaults to that number,
    W_local == 1)."""
    groups = n_worker_groups(mesh)
    n = groups if n_workers is None else n_workers
    if n % groups:
        raise ValueError(
            f"worker count {n} does not divide over {groups} data shards")
    return n // groups


def _axes_group(mesh, axes):
    """The process group over the mesh dims ``axes`` (a name or a tuple);
    several dims are flattened, in mesh order (pod-major)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    unknown = [a for a in axes if a not in mesh.mesh_dim_names]
    if unknown or not axes:
        raise ValueError(f"mesh dims {axes} not in the mesh's "
                         f"{mesh.mesh_dim_names}")
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return mesh[axes]._flatten().get_group()


def _worker_group(mesh):
    wa = data_axes(mesh)
    if not wa:
        raise ValueError(
            f"mesh has no data axes (mesh_dim_names={mesh.mesh_dim_names}); "
            "the ASGD worker dimension shards over 'pod'/'data'")
    return _axes_group(mesh, wa)


def _travels(x) -> bool:
    """False for a ``meta`` tensor: it has no data to send."""
    return x.device.type != "meta"


def _check_transport(x, group) -> None:
    """CUDA tensors go over NCCL and CPU tensors over gloo; anything else
    raises (no silent staging through the host) but a ``meta`` tensor,
    which travels nowhere."""
    if not _travels(x):
        return
    backend = str(dist.get_backend(group))
    want = {"cuda": "nccl", "cpu": "gloo"}.get(x.device.type)
    if want is None or want not in backend:
        raise ValueError(f"a {x.device.type} tensor cannot travel on a "
                         f"{backend!r} group: CUDA tensors go over NCCL, "
                         "CPU tensors over gloo")


def shard_workers(x, mesh):
    """This rank's ``(W_local, ...)`` slice of a global ``(W, ...)``
    array."""
    group = _worker_group(mesh)
    w_local = local_worker_count(mesh, x.shape[0])
    i = dist.get_rank(group)
    return x[i * w_local:(i + 1) * w_local]


def gather_workers(x, mesh):
    """The global ``(W, ...)`` array from every worker coordinate's
    ``(W_local, ...)`` slice (the inverse of :func:`shard_workers`)."""
    group = _worker_group(mesh)
    x = x.contiguous()
    _check_transport(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    if _travels(x):
        dist.all_gather(parts, x, group=group)
    return torch.cat(parts)


def psum_rank_order(x, mesh, axes):
    """The sum of ``x`` over the ranks of the mesh dims ``axes`` (the
    reference's ``lax.psum``), added in rank order on every rank: an
    ``all_gather`` and a fixed-order sum, where ``all_reduce``'s order
    would be the backend's."""
    group = _axes_group(mesh, axes)
    x = x.contiguous()
    _check_transport(x, group)
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    if _travels(x):
        dist.all_gather(parts, x, group=group)
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def pmax(x, mesh, axes):
    """The elementwise max of ``x`` over the ranks of the mesh dims
    ``axes`` (the reference's ``lax.pmax``; a max is exact in any order),
    in one ``all_reduce``.  ``x`` is taken over (reduced in place)."""
    group = _axes_group(mesh, axes)
    _check_transport(x, group)
    if _travels(x) and dist.get_world_size(group) > 1:
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=group)
    return x


def shard_map_workers(fn, mesh, *, replicated_argnums=()):
    """``fn`` over the worker axes: the wrapper takes global ``(W, ...)``
    arguments, calls ``fn`` on this rank's ``(W_local, ...)`` slice of
    each (:func:`shard_workers`), and returns the global outputs gathered
    from every worker coordinate.  Arguments that are worker-SHARED — the
    (R, LANE) 'leaves'-mode partition mask, whose axis 0 is the packed row
    dim — are named in ``replicated_argnums`` and passed whole.

    ``fn`` must be communication-free per worker, as the blend is; its
    one cross-rank term, the gate accumulator's sum over non-worker dims
    that are sharded too, is ``psum_axes=`` with ``mesh=`` bound into
    ``fn``."""
    _worker_group(mesh)
    repl = frozenset(replicated_argnums)

    def wrapped(*args):
        out = fn(*(a if i in repl else shard_workers(a, mesh)
                   for i, a in enumerate(args)))
        if isinstance(out, tuple):
            return tuple(gather_workers(o, mesh) for o in out)
        return gather_workers(out, mesh)
    return wrapped


# ---------------------------------------------------------------------------
# the ring transport
# ---------------------------------------------------------------------------

def _ppermute(parts, group, n_shards: int, tally=None):
    """Move each ``(tensor, d)`` of ``parts`` ``d`` shards forward along
    the ring of ``group`` (``jnp.roll`` semantics: shard i's tensor lands
    on shard (i + d) % n), all in ONE batch of P2P ops.  Returns the
    received tensors in order; ``d % n == 0`` returns the tensor itself,
    with no communication.  ``tally`` counts the bytes this rank sends."""
    me = dist.get_rank(group)
    ops, out = [], []
    for x, d in parts:
        d %= n_shards
        if d == 0:
            out.append(x)
            continue
        x = x.contiguous()
        _check_transport(x, group)
        recv = torch.empty_like(x)
        ops.append(dist.P2POp(dist.isend, x, dist.get_global_rank(
            group, (me + d) % n_shards), group))
        ops.append(dist.P2POp(dist.irecv, recv, dist.get_global_rank(
            group, (me - d) % n_shards), group))
        if tally is not None:
            tally.bytes_sent += x.numel() * x.element_size()
        out.append(recv)
    if ops and _travels(ops[0].tensor):
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out


def _ppermute_shift(x, group, n_shards: int, shift: int, tally=None):
    """``x`` moved ``shift`` shards forward along the ring."""
    return _ppermute([(x, shift)], group, n_shards, tally)[0]


def _roll_workers_manual(x, shift: int, group, n_shards: int, w_local: int,
                         tally=None):
    """Global ``torch.roll(·, shift, dims=0)`` over the worker axis, each
    rank holding ``w_local`` contiguous workers of the (n_shards ·
    w_local)-ring.

    shift = q·w_local + r: output local row j takes row (j − r) of the
    shard q back for j >= r, and row (w_local + j − r) of the shard q + 1
    back for j < r.  So a rank sends its first w_local − r rows q shards
    forward and its last r rows q + 1 shards forward — both in one batch,
    each row once.  A fetch from 0 shards back is local."""
    shift %= n_shards * w_local
    q, r = divmod(shift, w_local)
    if r == 0:
        return _ppermute_shift(x, group, n_shards, q, tally)
    a, b = _ppermute([(x[:w_local - r], q), (x[w_local - r:], q + 1)],
                     group, n_shards, tally)
    return torch.cat([b, a])


# ---------------------------------------------------------------------------
# manual regions
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _RegionCtx:
    """What a region holds: its mesh, the worker group and this rank's
    place on it, the static row ranges, the wire, and the bytes this rank
    has sent so far."""

    mesh: object
    group: object
    n_shards: int
    w_local: int
    ranges: tuple
    wire: object
    bytes_sent: int = 0

    def roll(self, x, shift: int):
        return _roll_workers_manual(x, shift, self.group, self.n_shards,
                                    self.w_local, self)


def _region_ctx(mesh, spec, cfg, n_workers) -> _RegionCtx:
    group = _worker_group(mesh)
    return _RegionCtx(mesh=mesh, group=group,
                      n_shards=dist.get_world_size(group),
                      w_local=local_worker_count(mesh, n_workers),
                      ranges=packed_row_ranges(spec, cfg),
                      wire=resolved_wire_format(cfg))


class ManualRegion:
    """A region: every rank calls it with its own ``(W_local, ...)``
    slices and the same host ints.  ``bytes_sent`` is what this rank has
    put on the wire over all its calls."""

    def __init__(self, body, ctx: _RegionCtx):
        self._body, self.ctx = body, ctx

    @property
    def bytes_sent(self) -> int:
        return self.ctx.bytes_sent

    def __call__(self, packed, *args):
        if packed.shape[0] != self.ctx.w_local:
            raise ValueError(
                f"a region takes this rank's (W_local={self.ctx.w_local}, "
                f"R, LANE) slice; got {tuple(packed.shape)}")
        with torch.no_grad():
            return self._body(packed, *args)


def _check_indices(cfg, shift_idx: int, block_idx: int) -> None:
    if not (0 <= shift_idx < len(cfg.shifts)
            and 0 <= block_idx < cfg.partial_blocks):
        raise ValueError(f"shift_idx {shift_idx} / block_idx {block_idx} "
                         f"out of range for {len(cfg.shifts)} shifts and "
                         f"{cfg.partial_blocks} partitions")


def _exchange_switch(packed, shift_idx: int, block_idx: int, *, cfg, spec,
                     ctx: _RegionCtx):
    """This round's partial exchange on the local slice: the static row
    range of partition ``block_idx`` through the wire, rolled along the
    worker ring by ``cfg.shifts[shift_idx]``.  Only the range's rows (and
    under int8 their scales) travel.  Returns ``sent`` (float wires) or
    ``(sent, sent_scales)`` (int8), full-size with zeros outside the
    range."""
    _check_indices(cfg, shift_idx, block_idx)
    s = cfg.shifts[shift_idx]
    r0, r1 = ctx.ranges[block_idx]
    if ctx.wire == "int8":
        # the engines' quantize/scatter body; only the roll differs
        return quantized_exchange_body(packed, r0, r1, spec.block_rows,
                                       lambda t: ctx.roll(t, s))
    out = torch.zeros_like(packed)
    out[:, r0:r1] = ctx.roll(wire_roundtrip(packed[:, r0:r1], cfg), s)
    return out


def _region_blend(packed, pgrads, ext, ext_scales, ext_idx: int, step: int,
                  *, cfg, acfg, spec, ctx: _RegionCtx, extra: int = 0,
                  depth=None, lr=None, lives=()):
    """The resident blend (B1r/B1a) of the local slice with the staleness
    guard (``extra=1``: the pipelined delay+1 threshold; ``depth``
    overrides it), the eq.-1 ``lr``, and the per-peer liveness vectors
    ``lives`` (local (W_local,) slices) folded into the one gate_scale,
    as the engines fold them.  ``cfg.gate_psum_axes`` sums the gate
    accumulator over those mesh dims."""
    valid = staleness_valid(step, cfg, extra=extra, depth=depth)
    new_packed, gates = gossip_blend_w_resident(
        packed, pgrads, ext[:, None], ctx.ranges[ext_idx], acfg.eps, lr=lr,
        ext_scales=None if ext_scales is None else ext_scales[:, None],
        use_parzen=acfg.use_parzen, elastic=acfg.elastic,
        elastic_alpha=acfg.elastic_alpha, block_rows=spec.block_rows,
        psum_axes=cfg.gate_psum_axes or None, mesh=ctx.mesh,
        gate_scale=combine_gate_scale(valid, *lives))
    return new_packed, gates[:, 0]


def _roll_live_manual(live, shift_idx: int, cfg, ctx: _RegionCtx):
    """sent_live on the local slice: the (W_local,) liveness travels the
    payload's ring shift, times the receiver's own liveness
    (core.gossip.roll_live with the region's transport)."""
    return ctx.roll(live, cfg.shifts[shift_idx]) * live


def _send(packed, live, shift_idx, block_idx, *, cfg, spec, ctx):
    """This round's payload ``(sent, sent_scales or None, sent_live or
    None)``: with ``live``, the rows of dead senders and receivers are
    dropped on the wire (the eq.-3 all-zero block)."""
    out = _exchange_switch(packed, shift_idx, block_idx, cfg=cfg, spec=spec,
                           ctx=ctx)
    sent, sent_scales = out if isinstance(out, tuple) else (out, None)
    if live is None:
        return sent, sent_scales, None
    sent_live = _roll_live_manual(live, shift_idx, cfg, ctx)
    if sent_scales is not None:
        sent_scales = mask_live_rows(sent_scales, sent_live)
    return mask_live_rows(sent, sent_live), sent_scales, sent_live


def _outputs(new_packed, sent, sent_scales, gates, sent_live):
    """The reference's output tuple: (new_packed, sent[, sent_scales],
    gates[, sent_live])."""
    out = (new_packed, sent)
    if sent_scales is not None:
        out += (sent_scales,)
    out += (gates,)
    return out if sent_live is None else out + (sent_live,)


def _split_args(args, n_float: int, int8: bool, elastic: bool):
    """(ext, ext_scales, rest..., lives) from a region's positional
    arguments after ``packed, pgrads``: the payload, its scales under
    int8, then ``n_float`` host ints, then the two elastic vectors."""
    ext, i = args[0], 1
    ext_scales = None
    if int8:
        ext_scales, i = args[1], 2
    n = len(args) - i - n_float
    if n != (2 if elastic else 0):
        raise TypeError(f"region takes {n_float} host ints"
                        f"{' and 2 liveness vectors' if elastic else ''} "
                        f"after the payload; got {len(args) - i} arguments")
    lives = tuple(args[i + n_float:]) if elastic else (None, None)
    return ext, ext_scales, args[i:i + n_float], lives


def shard_map_gossip_round(mesh, spec, cfg, acfg, *, n_workers=None,
                           elastic: bool = False):
    """The whole packed-resident gossip round — exchange AND blend — as one
    region over this rank's slices:

      * float wire: ``round(packed, pgrads, buf, buf_idx, step, shift_idx,
        block_idx) -> (new_packed, sent, gates)``
      * int8 wire: ``round(packed, pgrads, buf, buf_scales, buf_idx, step,
        shift_idx, block_idx) -> (new_packed, sent, sent_scales, gates)``

    ``buf`` is ONE received block (the caller feeds last round's ``sent``
    back), so the staleness guard clamps to depth 1 whatever cfg.delay
    says; with delay 0 this round's block is blended.  The ints are host
    ints, the same on every rank.  The exchange moves the partition's
    rows of the int8 payload plus its per-block_rows f32 scales, or its
    f32 rows; B1r/B1a blend the slice.

    spec: group-contiguous WPackSpec of ONE rank's slice or of the
    global ensemble (the rows are the same); n_workers: global W (default:
    the number of worker coordinates, W_local == 1).

    elastic=True appends ``buf_live`` (the buffered payload's recorded
    validity) and ``live`` (this round's mask), each this rank's
    (W_local,) slice, and one more output, ``sent_live``: a payload from
    or to a dead worker arrives as eq.-3 zeros with its gate closed, and a
    dead worker's step is masked."""
    ctx = _region_ctx(mesh, spec, cfg, n_workers)
    int8 = ctx.wire == "int8"

    def body(packed, pgrads, *args):
        buf, buf_scales, (buf_idx, step, shift_idx, block_idx), \
            (buf_live, live) = _split_args(args, 4, int8, elastic)
        sent, sent_scales, sent_live = _send(
            packed, live, shift_idx, block_idx, cfg=cfg, spec=spec, ctx=ctx)
        pgrads = mask_live_rows(pgrads, live)
        if cfg.delay == 0:
            ext, ext_scales, ext_idx, ext_live = (sent, sent_scales,
                                                  block_idx, sent_live)
        else:
            ext, ext_scales, ext_idx, ext_live = (buf, buf_scales, buf_idx,
                                                  buf_live)
        new_packed, gates = _region_blend(
            packed, pgrads, ext, ext_scales, ext_idx, step, cfg=cfg,
            acfg=acfg, spec=spec, ctx=ctx, depth=min(cfg.delay, 1),
            lives=(ext_live, live))
        return _outputs(new_packed, sent, sent_scales, gates, sent_live)
    return ManualRegion(body, ctx)


def shard_map_initiate_exchange(mesh, spec, cfg, *, n_workers=None,
                                elastic: bool = False):
    """The INITIATE half of the pipelined round as its own region: ONLY
    the partial-row send of this round's payload, from the pre-blend
    ensemble.  ``initiate(packed, shift_idx, block_idx) -> sent`` (float
    wires) or ``(sent, sent_scales)`` (int8).  elastic=True appends this
    rank's ``live`` slice and a trailing ``sent_live`` output: dead
    peers' rows leave the region as eq.-3 zeros."""
    ctx = _region_ctx(mesh, spec, cfg, n_workers)

    def body(packed, shift_idx, block_idx, *elastic_args):
        if len(elastic_args) != (1 if elastic else 0):
            raise TypeError("initiate takes (packed, shift_idx, block_idx"
                            f"{', live' if elastic else ''})")
        live = elastic_args[0] if elastic else None
        sent, sent_scales, sent_live = _send(
            packed, live, shift_idx, block_idx, cfg=cfg, spec=spec, ctx=ctx)
        out = (sent,) if sent_scales is None else (sent, sent_scales)
        if elastic:
            out += (sent_live,)
        return out if len(out) > 1 else out[0]
    return ManualRegion(body, ctx)


def shard_map_consume_blend(mesh, spec, cfg, acfg, *, n_workers=None,
                            pipelined: bool = True, elastic: bool = False):
    """The CONSUME half as its own region: the resident blend + eq.-1
    update of the FIFO-head payload, with no communication (unless
    ``cfg.gate_psum_axes`` asks for the accumulator's sum).
    ``consume(packed, pgrads, ext[, ext_scales], ext_idx, step) ->
    (new_packed, gates)``; ``pipelined=True`` applies the pipelined
    schedule's delay+1 staleness threshold.  elastic=True appends this
    rank's ``ext_live`` (the head's recorded launch validity) and ``live``
    slices: both close gates, and dead workers' steps are masked."""
    ctx = _region_ctx(mesh, spec, cfg, n_workers)
    int8 = ctx.wire == "int8"

    def body(packed, pgrads, *args):
        ext, ext_scales, (ext_idx, step), (ext_live, live) = _split_args(
            args, 2, int8, elastic)
        return _region_blend(packed, mask_live_rows(pgrads, live), ext,
                             ext_scales, ext_idx, step, cfg=cfg, acfg=acfg,
                             spec=spec, ctx=ctx,
                             extra=1 if pipelined else 0,
                             lives=(ext_live, live))
    return ManualRegion(body, ctx)


def shard_map_pipelined_round(mesh, spec, cfg, acfg, *, n_workers=None,
                              elastic: bool = False):
    """The whole PIPELINED round as one region: blend the caller-carried
    FIFO-head payload ``ext`` (launched delay+1 rounds ago) and send this
    round's payload from the PRE-blend ensemble.

      * float wire: ``round(packed, pgrads, ext, ext_idx, step, shift_idx,
        block_idx) -> (new_packed, sent, gates)``
      * int8 wire: ``round(packed, pgrads, ext, ext_scales, ext_idx, step,
        shift_idx, block_idx) -> (new_packed, sent, sent_scales, gates)``

    The FIFO pop/push lives with the caller (core.gossip
    asgd_gossip_apply_pipelined is the single-device form of the same
    round).  elastic=True appends this rank's ``ext_live`` and ``live``
    slices and a trailing ``sent_live`` output."""
    ctx = _region_ctx(mesh, spec, cfg, n_workers)
    int8 = ctx.wire == "int8"

    def body(packed, pgrads, *args):
        ext, ext_scales, (ext_idx, step, shift_idx, block_idx), \
            (ext_live, live) = _split_args(args, 4, int8, elastic)
        new_packed, gates = _region_blend(
            packed, mask_live_rows(pgrads, live), ext, ext_scales, ext_idx,
            step, cfg=cfg, acfg=acfg, spec=spec, ctx=ctx, extra=1,
            lives=(ext_live, live))
        sent, sent_scales, sent_live = _send(
            packed, live, shift_idx, block_idx, cfg=cfg, spec=spec, ctx=ctx)
        return _outputs(new_packed, sent, sent_scales, gates, sent_live)
    return ManualRegion(body, ctx)
