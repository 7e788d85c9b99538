"""Tensor parallelism over ``model``: the pytree ASGD train step, and
prefill and greedy decode, on leaves placed as ``launch/sharding.py`` lays
them out.

Layout.  A ``("data", "model")`` (or ``("pod", "data", "model")``) mesh,
one rank per point.  The worker axis W is split over the worker axes as
``launch/mesh.py shard_workers`` cuts it: the rank at worker coordinate i
holds workers [i·W_local, (i+1)·W_local), the spec's worker entry.  Each
leaf of that slice is a ``DTensor`` on the mesh's ``model`` dim
(:func:`model_mesh`): ``Shard(d)`` where ``sharding.param_pspec`` names
``model`` at dim d, ``Replicate()`` where it names none (norm scales,
qk-norm, a bias or head count that does not divide).  The worker dim
stays a plain dim of every shard, so one rank's shard of a leaf is what
``sharding.placed_bytes`` says a device holds.

The step (:class:`TensorParallelStep`, built by ``launch/steps.py
make_train_step(..., mesh=)``):

* forward/backward — ``models.model.loss_fn_w`` on the DTensor leaves
  under ``implicit_replication`` (the tokens, the frontend's frames or
  patches, positions, masks, RoPE and sinusoidal tables count as
  replicated) with the model mesh ambient, so the
  sharding hints (``models/hints.py constrain``) redistribute the
  residual stream where the config asks (``seq_parallel``,
  ``attn_batch_shard``); a vocab-sharded table takes the masked lookup
  (``models/model.py embed_tokens``).  Each gradient is redistributed to
  its leaf's placements: a replicated leaf's ``Partial`` gradient is
  summed over ``model`` there, once.
* gossip round — the pytree engine's round (``core/gossip.py
  asgd_gossip_apply``) on the rank's local shards, with every option of
  the reference's pytree step.  'leaves' mode: the groups come from the
  leaves' global shapes (a DTensor's ``numel`` is its global one; the
  local worker count scales every leaf alike), and the drawn group's
  shards travel to the ring peer at the same ``model`` coordinate over
  the worker group (``launch/mesh.py _roll_workers_manual``): a rank's
  wire bytes are its shards'.  'rows' mode: each leaf's 1/p block along
  dim 1 (``core/gossip.py _block_start``, the last block clamped); a
  leaf whose dim 1 is ``Shard(1)`` (a vocab-sharded embedding) sends,
  blends and writes back the rank's part of the block, possibly empty
  (:func:`_rows_range`), and the buffer holds each rank's parts
  (:func:`init_placed_gossip_state`): no leaf is gathered.  The wire: a
  float one casts the shards to its dtype; the int8 one takes each
  worker's absmax over the rank's shard of each sent leaf (or block
  part), one (W_local, n_sent) f32 tensor, its max over ``model`` where
  a leaf is sharded (one collective a round), so each scale is the whole
  leaf's, and sends the int8 codes and the f32 scales; the receiver's
  ``q * scale`` is bitwise ``torch.roll(_fake_quant_leaf(leaf))`` on its
  shard, and the buffer keeps carrier-dtype values.  The blend: B2r's
  ``(W_local, 1, 3)`` partials of the rank's pack summed over ``model``
  in rank order (``psum_rank_order``), a replicated leaf's rows in B2r's
  mask on ``model`` rank 0 only (counted once), B2a under one set of
  gates, so every replica of a replicated leaf is written alike; or the
  plain blend (``ASGDConfig(use_fused=False)``, the reference's default)
  in plain torch (``core/gossip.py _per_worker_reduce3``,
  ``gate_from_terms``, ``blend_group``), each worker's three eq.-4 terms
  summed over its shards (a replicated leaf's on ``model`` rank 0 only),
  then over ``model`` once in rank order.  ``live=``: the rank's
  (W_local,) slice of the fleet's 0/1 liveness, rolled over the worker
  group with the payload (:func:`_roll_live`), masks dead workers' steps
  and the payloads from or to them, and folds with the buffered
  payload's validity into the gates' scale (``combine_gate_scale``), as
  ``launch/mesh.py``'s regions do.  The silent flag and the off-rounds
  of ``gossip_every > 1`` take the local step, the counter bumped and
  the gates shut.
* the inner optimizer (:func:`tp_direction`): momentum and Adam
  (``optim/optimizers.py``) elementwise on each rank's local shards, the
  moments DTensors with their params' placements; the gossip blends
  params only.
* algos 'silent' (the local step) and 'sync' (each worker steps with the
  mean of all W workers' steps: a rank's local shards summed over its
  workers, then over the worker group in rank order, leaf by leaf).

Serving (:func:`make_serve_steps`, built by ``launch/steps.py
make_prefill_step`` / ``make_decode_step(mesh=)``; ``launch/serve.py
generate(mesh=)``): one model's params, no worker axis, placed by
``param_pspec(train=False)`` (:func:`place_serve_params`); the batch the
rank's slice over the data axes where it divides, else whole
(:func:`serve_slice`); the decode cache placed by ``cache_pspec``
(:func:`place_cache`): KV heads ``Shard``ed over ``model`` where they
divide, else the sequence, else ``Replicate()``.  The prefill
(``models.model.prefill`` on the DTensor leaves) projects each layer's
K/V as its heads are placed and redistributes every cache leaf once, at
its end (:func:`_place_prefill_cache`).  A decode step reads each rank's
local shard (``models/common.py _decode_placed``; whisper's cross cache
alike): its own KV heads, or its own positions combined over ``model``
as flash-decoding combines them, or the whole replicated cache; no
cache-sized tensor moves.  The logits come back vocab-sharded, their
argmax taken over the shards (:func:`greedy_tokens`).  The 'S' and 'R'
layers' states are placed alike: ``ssm`` over its heads, ``conv`` and
``h`` over their channels, where they divide; each decode step reads and
steps the rank's local shards (models/ssm.py, models/rglru.py), and the
prefill's states keep their f32.  An MoE FFN runs expert-parallel as in
training; its dispatch groups and capacity are the GLOBAL batch's
(``rows=``, the whole batch's rows: ``models/moe.py batch_slice``).

Scope (:func:`check_scope`): every config the port carries — attention
layers ('G', 'L' windows, 'E' encoder layers), Mamba-2 SSD ('S') and
RG-LRU ('R') layers, dense MLPs (GLU or plain with biases) and MoE FFNs,
RMSNorm or LayerNorm, RoPE or sinusoidal positions, softcaps, scaled
embeddings, a vision prefix of patches or an audio encoder with
cross-attention (all ten archs) — and every option of the reference's
pytree step: algos 'asgd', 'silent' and 'sync', inner 'sgd', 'momentum'
and 'adam', 'leaves' and 'rows' modes, any ``gossip_every``, the blend
through B2r/B2a (``ASGDConfig(use_fused=True)``) or in plain torch,
``ASGDConfig(silent=True)``, wires None, "dtype" and "int8", and
``live=``.  The packed and pipelined engines run worker-split, through
``launch/mesh.py``'s regions, as the reference runs them.  An 'S'
layer runs kernel B5 (B5b under autograd) on each rank's own heads, an 'R'
layer its doubling scan on each rank's channels (models/ssm.py
``_apply_ssd_placed``, models/rglru.py ``_apply_rglru_placed``).  An MoE
FFN is expert-parallel (models/moe.py ``_apply_placed``): routing is
identical on every ``model`` rank (the input and router whole, the
global E in C and the slot numbering), each rank runs its own experts on
the pairs they own, the combine is summed over ``model`` once, the aux
loss is differentiated once (its gradient scaled by 1/model before it
meets the partial views), and dispatch groups and positions are global
over the data axes (whole in training, where workers are sliced and a
worker's batch never is).  Where the heads do not divide over ``model``
(the d_model fallback of ``sharding.param_pspec``), DTensor contracts
the sharded d_model and replicates the attention's operands, an 'S'
layer scans every head on every rank, and where the experts do not
divide every rank runs every expert: correct, not parallel.
Transport: NCCL for CUDA tensors, gloo for CPU tensors
(``launch/mesh.py _check_transport``); nothing is staged through the
host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import torch
import torch.distributed as dist

from ..core.gossip import (GossipState, _block_start, _fused_blend,
                           _per_worker_reduce3, _resolve_live, blend_group,
                           combine_gate_scale, init_gossip_state,
                           int8_codes, int8_scale, leaf_groups,
                           local_sgd_apply, mask_live_rows,
                           resolved_wire_format, staleness_valid)
from ..core.parzen import gate_from_terms
from ..core.tree import flatten_sorted, tree_map, unflatten
from . import sharding as SH
from .mesh import (_roll_workers_manual, _worker_group, data_axes,
                   gather_workers, mesh_context, n_worker_groups, pmax,
                   psum_rank_order, shard_workers)


def check_scope(cfg, *, algo, inner, gcfg, acfg, pack_spec=None,
                pipelined=False, lr_schedule=None) -> None:
    """Raise for what the tensor-parallel step does not carry: a model the
    port does not (``models.blocks.check_supported``, NotImplementedError);
    the packed and pipelined engines and ``lr_schedule`` (ValueError: the
    reference runs those worker-split, as ``launch/mesh.py``'s regions
    do); gate sums over dims other than ``model``.  Every option of the
    pytree step is carried: algos, inner optimizers, both blends, the
    silent flag, every wire, both partial modes, ``gossip_every``."""
    from ..models.blocks import check_supported
    check_supported(cfg)
    if pack_spec is not None or pipelined or lr_schedule is not None:
        raise ValueError(
            "mesh= runs the pytree engine; the packed and pipelined engines "
            "shard only the worker axis and run on a mesh through "
            "launch/mesh.py's regions")
    if gcfg.gate_psum_axes not in ((), ("model",)):
        raise ValueError(
            f"gate_psum_axes={gcfg.gate_psum_axes!r}: the tensor-parallel "
            "round sums the gate partials over 'model' itself")


def check_serve_scope(cfg) -> None:
    """Raise NotImplementedError for a model the tensor-parallel serve does
    not carry: it carries every one the port serves
    (``models.blocks.check_supported``)."""
    from ..models.blocks import check_supported
    check_supported(cfg)


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------

def model_mesh(mesh):
    """The 1-D ``model`` sub-mesh a rank's DTensor leaves live on."""
    if "model" not in (mesh.mesh_dim_names or ()):
        raise ValueError(f"mesh dims {mesh.mesh_dim_names} have no 'model'")
    return mesh["model"]


def _rewrap(like, local):
    """``local`` as a DTensor of ``like``'s mesh, placements and shape."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False, shape=like.shape,
                              stride=like.stride())


def place_params(mesh, tree):
    """This rank's placed tree of a global (W, ...) tree (every rank passes
    the same): each leaf's spec from ``sharding.tree_pspecs`` on ``mesh``;
    its worker entry is the rank's worker slice (``shard_workers``), the
    rest placed on :func:`model_mesh` by ``sharding.placements`` —
    ``Shard(d)`` where the spec names ``model`` at dim d, ``Replicate()``
    where it names none."""
    from torch.distributed.tensor import distribute_tensor
    mm = model_mesh(mesh)
    specs = flatten_sorted(SH.tree_pspecs(mesh, tree,
                                          worker_axes=data_axes(mesh)))[0]
    leaves, treedef = flatten_sorted(tree)
    return unflatten(treedef, [
        distribute_tensor(shard_workers(x, mesh), mm,
                          SH.placements(mm, (None,) + tuple(s[1:])))
        for x, s in zip(leaves, specs)])


def place_serve_params(mesh, tree):
    """This rank's placed tree of one model's params (no worker axis; every
    rank passes the same): each leaf on :func:`model_mesh` by
    ``sharding.tree_pspecs(train=False)`` — heads, d_ff and the vocab over
    ``model`` where they divide, replicated over the data axes."""
    from torch.distributed.tensor import distribute_tensor
    mm = model_mesh(mesh)
    specs = flatten_sorted(SH.tree_pspecs(mesh, tree, train=False))[0]
    leaves, treedef = flatten_sorted(tree)
    return unflatten(treedef, [distribute_tensor(x, mm, SH.placements(mm, s))
                               for x, s in zip(leaves, specs)])


def model_only(spec) -> tuple:
    """A spec's ``model`` entries, the data axes' dropped (the worker dim
    and the batch are sliced by hand, not placed)."""
    return tuple(a if a == "model" else None for a in spec)


def _batch_dim(path) -> int:
    """The batch dim of a cache leaf: behind the layer axis of a
    scan-stacked leaf (``sharding.cache_pspec``'s rule)."""
    return 1 if any(n.startswith("pos") for n in path) else 0


def serve_slice(mesh, x, dim: int = 0):
    """This rank's share of a serving batch along ``dim``: its slice over
    the data axes where the batch divides over them (``batch_pspec``),
    else the whole batch."""
    groups = n_worker_groups(mesh)
    if groups == 1 or x.shape[dim] % groups:
        return x
    n = x.shape[dim] // groups
    return x.narrow(dim, dist.get_rank(_worker_group(mesh)) * n, n)


def serve_gather(mesh, x, batch: int):
    """The whole batch (dim 0) from every data coordinate's
    :func:`serve_slice` of a batch of ``batch`` rows."""
    groups = n_worker_groups(mesh)
    if groups == 1 or batch % groups:
        return x
    return gather_workers(x, mesh)


def place_cache(mesh, cache, cfg):
    """This rank's placed decode cache of a global one (every rank passes
    the same, e.g. ``models.model.init_cache``'s): each leaf by
    ``sharding.cache_pspecs`` — its batch the rank's data slice where the
    spec names the data axes, the rest on :func:`model_mesh`: ``Shard``
    on the KV heads where they divide over ``model``, else on the
    sequence, else ``Replicate()``.  Leaves are copied, so decoding into
    the placed cache leaves ``cache`` alone."""
    from torch.distributed.tensor import distribute_tensor
    mm = model_mesh(mesh)
    specs = flatten_sorted(SH.cache_pspecs(mesh, cache, cfg,
                                           worker_axes=data_axes(mesh)))[0]
    out = []
    for (path, x), spec in zip(SH.tree_paths(cache), specs):
        b = _batch_dim(path)
        if spec[b] is not None:
            x = serve_slice(mesh, x, b)
        out.append(distribute_tensor(x.clone(), mm,
                                     SH.placements(mm, model_only(spec))))
    return unflatten(flatten_sorted(cache)[1], out)


# the attention caches' leaves, bf16 as the plain prefill leaves them
_KV_LEAVES = ("k", "v", "cross_k", "cross_v")


def _place_prefill_cache(mm, cache, cfg):
    """The prefill's cache (DTensor leaves as the projections left them:
    heads sharded, replicated, or a ``Partial`` f32 sum over a sharded
    d_model; the 'R'/'S' states over their heads or channels, or
    replicated) redistributed once to ``sharding.cache_pspec``'s
    placements, the KV leaves cast to bf16 (the states keep their dtype,
    as the plain prefill's).  The leaves hold the rank's batch already."""
    sizes = {"model": mm.size()}

    def place(path, x):
        x = x.redistribute(mm, SH.placements(mm, model_only(
            SH.cache_pspec(path, x, cfg, axis_sizes=sizes))))
        return x.to(torch.bfloat16) if path[-1] in _KV_LEAVES else x
    return SH.tree_map_with_path(place, cache)


def greedy_tokens(logits):
    """``torch.argmax(logits, dim=-1)`` of (B, V) logits whose vocab dim is
    sharded over a 1-D mesh (``Shard(-1)``, the lm_head's or the tied
    table's placement): each rank's first largest column and its value,
    all-gathered, and the first rank holding the row's largest taken —
    the whole row's first largest, as ``torch.argmax`` returns at ties.
    Other placements are gathered whole; a plain tensor is argmaxed."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(logits, DTensor):
        return torch.argmax(logits, dim=-1)
    mesh, last = logits.device_mesh, logits.ndim - 1
    if logits.placements != (Shard(last),):
        return torch.argmax(logits.full_tensor(), dim=-1)
    local = logits.to_local()
    idx = torch.argmax(local, dim=-1)
    val = local.gather(-1, idx[..., None])[..., 0]
    first = local.shape[-1] * mesh.get_local_rank()   # even shards
    both = torch.stack([val.double(), (idx + first).double()])[None]
    parts = DTensor.from_local(both, mesh, (Shard(0),)).full_tensor()
    best = torch.argmax(parts[:, 0], dim=0)
    return parts[:, 1].gather(0, best[None])[0].long()


def _check_placed(tree, what: str, how: str) -> None:
    """Raise unless every leaf of ``tree`` is a DTensor: the mesh path
    never serves on whole leaves."""
    from torch.distributed.tensor import DTensor
    if not all(isinstance(x, DTensor) for x in flatten_sorted(tree)[0]):
        raise ValueError(f"tensor-parallel serve: the {what} are not "
                         f"placed on the mesh (use {how})")


def _moe_slice(cfg, mesh, local: int, rows):
    """The block a serve step of an MoE config runs in: ``models/moe.py
    batch_slice`` where the rank's ``local`` rows are its data slice of
    ``rows`` (the whole batch's), nothing where they are the whole batch
    (or the config has no experts).  On a mesh of several data groups an
    MoE config must say which (``rows``): its dispatch groups and
    capacity are the global batch's."""
    from ..models import moe
    if not cfg.n_experts:
        return contextlib.nullcontext()
    groups = n_worker_groups(mesh)
    if rows is None and groups > 1:
        raise ValueError(
            "tensor-parallel serve of an MoE config over data groups: pass "
            "rows=, the whole batch's rows (the dispatch groups are the "
            "global batch's)")
    if rows is None or rows == local:
        return contextlib.nullcontext()
    if rows != local * groups:
        raise ValueError(f"tensor-parallel serve: {local} rows a rank are "
                         f"not a slice of {rows} over {groups} data groups")
    return moe.batch_slice(dist.get_rank(_worker_group(mesh)), groups,
                           functools.partial(gather_workers, mesh=mesh))


def make_serve_steps(cfg, mesh):
    """(prefill, decode) of ``launch/steps.py make_prefill_step`` /
    ``make_decode_step(mesh=)``: ``models.model``'s prefill and
    decode_step on :func:`place_serve_params`' leaves under
    ``implicit_replication`` (tokens, patches, frames and position tables
    count as replicated) with the model mesh ambient.  ``cfg``: the
    serving config (``_serve_cfg``).  ``rows``: the whole batch's rows
    where the rank's batch is its :func:`serve_slice` of it (None: the
    batch is whole on the rank); a config with MoE on a mesh of several
    data groups needs it (:func:`_moe_slice`)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..models import model as M
    check_serve_scope(cfg)
    mm = model_mesh(mesh)

    def prefill(params, batch, cache_len=None, rows=None):
        sliced = _moe_slice(cfg, mesh, batch["tokens"].shape[0], rows)
        _check_placed(params, "params", "place_serve_params")
        with implicit_replication(), mesh_context(mm), sliced:
            last, cache = M.prefill(cfg, params, batch, cache_len=cache_len)
            return last, _place_prefill_cache(mm, cache, cfg)

    def decode(params, token, pos, cache, rows=None):
        sliced = _moe_slice(cfg, mesh, token.shape[0], rows)
        _check_placed(params, "params", "place_serve_params")
        _check_placed(cache, "cache", "the prefill or place_cache")
        with implicit_replication(), mesh_context(mm), sliced:
            return M.decode_step(cfg, params, token, pos, cache)
    return prefill, decode


def gather_params(mesh, tree):
    """The global (W, ...) numpy arrays of a placed tree (the inverse of
    :func:`place_params`, for checkpoints and tests): every leaf gathered
    over ``model``, then over the worker axes.  Every rank calls it and
    gets the whole tree."""
    return tree_map(lambda x: gather_workers(x.full_tensor(), mesh)
                    .cpu().numpy(), tree)


def _replicated(x) -> bool:
    from torch.distributed.tensor import Replicate
    return all(isinstance(p, Replicate) for p in x.placements)


def _is_placed(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _local_of(x):
    """A DTensor's local shard; anything else itself."""
    return x.to_local() if _is_placed(x) else x


# ---------------------------------------------------------------------------
# the gossip round on local shards
# ---------------------------------------------------------------------------

def _rows2d(x):
    """A (W_local, ...) tensor as (W_local, n), empty ones too."""
    return x.reshape(x.shape[0], math.prod(x.shape[1:]))


def _absmax_over_model(absmax, mesh):
    """The (W_local, n_sent) per-worker absmaxes of the rank's shards as
    the whole leaves': their max over ``model``, in one collective."""
    return pmax(absmax, mesh, ("model",))


def _int8_payload(parts, mesh, sharded: bool):
    """The int8 wire's payload of ``parts`` ((W_local, ...) local tensors,
    one a sent leaf or block): each worker's absmax over each part, as
    one (W_local, n) f32 tensor — its max over ``model`` where a part is
    sharded (:func:`_absmax_over_model`), so each is the whole leaf's —
    the scales and codes as ``core/gossip.py _fake_quant_leaf`` forms
    them, and the codes and the scales' bytes side by side, (W_local,
    codes + 4 n) int8."""
    flat = [_rows2d(x).float() for x in parts]
    absmax = torch.stack([
        f.abs().amax(dim=1) if f.shape[1] else f.new_zeros(f.shape[0])
        for f in flat], dim=1)
    if sharded:
        absmax = _absmax_over_model(absmax, mesh)
    scale, inv = int8_scale(absmax)
    codes = [int8_codes(f, inv[:, i:i + 1]).to(torch.int8)
             for i, f in enumerate(flat)]
    return torch.cat(codes + [scale.view(torch.int8)], dim=1)


def _send_parts(parts, shift: int, gcfg, mesh, tally, sharded: bool):
    """``parts`` ((W_local, ...) local tensors) through the wire, rolled
    along the worker ring in one batch of sends to the peers at the same
    ``model`` coordinate (``launch/mesh.py _roll_workers_manual``): a
    rank's wire bytes are its parts'.  A float wire casts to its dtype
    and back; the int8 wire sends codes and (W_local, n) f32 scales
    (:func:`_int8_payload`) and the receiver dequantizes, ``(q * scale)``
    in the part's dtype: bitwise ``torch.roll(_fake_quant_leaf(leaf))``
    on the rank's shard.  ``sharded``: some part is not whole on every
    ``model`` rank."""
    wl = parts[0].shape[0]
    sizes = [math.prod(x.shape[1:]) for x in parts]
    wf = resolved_wire_format(gcfg)
    if wf == "int8":
        flat = _int8_payload(parts, mesh, sharded)
    else:
        wire = gcfg.payload_dtype if wf == "dtype" else functools.reduce(
            torch.promote_types, [x.dtype for x in parts])
        flat = torch.cat([_rows2d(x).to(wire) for x in parts], dim=1)
    group = _worker_group(mesh)
    recv = _roll_workers_manual(flat, shift, group,
                                dist.get_world_size(group), wl, tally)
    if wf == "int8":
        n = sum(sizes)
        scale = recv[:, n:].contiguous().view(torch.float32)
        recv = recv[:, :n]
    out = []
    for i, (x, part) in enumerate(zip(parts, recv.split(sizes, dim=1))):
        if wf == "int8":
            part = part.float() * scale[:, i:i + 1]
        out.append(part.reshape(x.shape).to(x.dtype))
    return out


def _exchange_leaves(leaves, local, gids, shift: int, block_idx: int, gcfg,
                     mesh, tally):
    """'leaves' mode's peer block on the rank's shards (``core/gossip.py
    exchange_leaves``): the local shards of group ``block_idx`` through
    the wire (:func:`_send_parts`), zeros for every other leaf (never
    sent).  ``leaves``: the DTensors whose shards ``local`` holds."""
    sel = [i for i, g in enumerate(gids) if g == block_idx]
    sent = [torch.zeros_like(x) for x in local]
    if not sel:
        return sent
    recv = _send_parts([local[i] for i in sel], shift, gcfg, mesh, tally,
                       sharded=not all(_replicated(leaves[i]) for i in sel))
    for i, x in zip(sel, recv):
        sent[i] = x
    return sent


def _roll_live(live, shift: int, mesh, tally):
    """sent_live on the rank's (W_local,) slice: ``live`` travels the
    payload's ring shift over the worker group, times the receiver's own
    (``core/gossip.py roll_live``; ``launch/mesh.py _roll_live_manual``)."""
    group = _worker_group(mesh)
    return _roll_workers_manual(live, shift, group,
                                dist.get_world_size(group), live.shape[0],
                                tally) * live


def _rows_range(x, block_idx: int, p: int):
    """(lo, hi): rows-mode block ``block_idx`` of leaf ``x`` (a DTensor)
    along dim 1 on the rank's shard — the global block (``core/gossip.py
    _block_start``, the last one clamped) where dim 1 is whole on the
    rank; where the leaf is ``Shard(1)`` (a vocab-sharded table) its
    intersection with the rank's own rows, in local indices, possibly
    empty.  None for a leaf of fewer than 2 dims (sent whole)."""
    from torch.distributed.tensor import Shard
    if x.ndim < 2:
        return None
    start, blk = _block_start(x, block_idx, p)
    if Shard(1) not in x.placements:
        return start, start + blk
    mm = x.device_mesh
    chunk = -(-x.shape[1] // mm.size())       # torch.chunk's split
    first = min(mm.get_local_rank() * chunk, x.shape[1])
    last = min(first + chunk, x.shape[1])
    lo, hi = max(start, first), min(start + blk, last)
    return lo - first, max(hi, lo) - first


def _rows_block(xs, leaves, block_idx: int, p: int):
    """Each local tensor's part of rows-mode block ``block_idx``
    (:func:`_rows_range` of its leaf), as a view."""
    out = []
    for x, leaf in zip(xs, leaves):
        r = _rows_range(leaf, block_idx, p)
        out.append(x if r is None else x[:, r[0]:r[1]])
    return out


def init_placed_gossip_state(params, gcfg, elastic: bool = False):
    """The tensor-parallel step's gossip state of a placed tree:
    ``core.gossip.init_gossip_state``'s in 'leaves' mode (a zero DTensor a
    leaf; ``buf_live`` (W_local,) zeros when ``elastic``); in 'rows' mode
    its buffer each rank's part of block 0 as a plain zero tensor a leaf
    (the parts' rows differ by rank and by block: no leaf is gathered)."""
    if gcfg.partial_mode != "rows":
        return init_gossip_state(params, gcfg, elastic=elastic)
    leaves, treedef = flatten_sorted(params)
    local = [x.to_local() for x in leaves]
    parts = _rows_block(local, leaves, 0, gcfg.partial_blocks)
    live = None
    if elastic:
        live = torch.zeros((local[0].shape[0],), dtype=torch.float32,
                           device=local[0].device)
    return GossipState(
        buf=unflatten(treedef, [torch.zeros_like(x) for x in parts]),
        buf_idx=0, step=0, buf_live=live)


def _plain_blend(local, grads, ext, gids, reduce_gids, ext_idx, gate_scale,
                 acfg, mesh):
    """``core/gossip.py``'s plain blend (``use_fused=False``) on the rank's
    local shards: each worker's three eq.-4 terms summed over its shards
    (``_per_worker_reduce3``; ``reduce_gids`` leaves a replicated leaf to
    ``model`` rank 0), then over ``model`` once, in rank order; the gate
    from the sums (``gate_from_terms``), and every leaf of group
    ``ext_idx`` blended under it (``blend_group``), the rest stepped.
    Returns (new local shards, gate (W_local,))."""
    terms = torch.stack(_per_worker_reduce3(local, grads, ext, reduce_gids,
                                            ext_idx), dim=-1)
    terms = psum_rank_order(terms, mesh, ("model",))
    gate = gate_from_terms(terms[:, 0], terms[:, 1], terms[:, 2], acfg.eps,
                           use_parzen=acfg.use_parzen)
    if gate_scale is not None:
        gate = gate * gate_scale
    return blend_group(local, grads, ext, gids, ext_idx, gate, acfg), gate


def _blend(local, grads, ext, gids, ext_idx, counted, gate_scale, gcfg,
           acfg, mesh):
    """The blend of lists of local tensors, through B2r/B2a
    (``_fused_blend``, one pack a round) or in plain torch
    (:func:`_plain_blend`).  ``gids``: each tensor's group ('leaves' mode:
    those of group ``ext_idx`` blended with ``ext`` under one gate a
    worker, the rest stepped), or None: every tensor blended ('rows'
    mode's block parts).  ``counted``: per tensor, whether this rank adds
    its eq.-4 terms (False: a replicated leaf on ``model`` rank > 0,
    counted on rank 0); the gate sums are then summed over ``model``
    once.  Returns (new local tensors, gate (W_local,))."""
    def tree(xs):       # a dict in list order (flatten_sorted's order)
        return {f"{i:06d}": x for i, x in enumerate(xs)}
    groups = [ext_idx] * len(local) if gids is None else gids
    reduce = None if all(counted) else tree(
        [g if c else -1 for g, c in zip(groups, counted)])
    if acfg.use_fused:
        new, gate = _fused_blend(
            tree(local), tree(grads), tree(ext),
            dataclasses.replace(gcfg, gate_psum_axes=("model",)), acfg,
            None if gids is None else tree(gids), ext_idx,
            gate_scale=gate_scale, mesh=mesh, reduce_groups=reduce)
    else:
        new, gate = _plain_blend(
            tree(local), tree(grads), tree(ext), tree(groups),
            tree(groups) if reduce is None else reduce, ext_idx, gate_scale,
            acfg, mesh)
    return flatten_sorted(new)[0], gate


def _local_round(params, grads, state: GossipState, eps, live):
    """``core/gossip.py _local_round`` on the shards (the silent flag, and
    the off-rounds of ``gossip_every > 1``): the local step with dead
    workers frozen, the buffer untouched, the counter bumped, zero
    gates."""
    if live is not None:
        grads = tree_map(lambda g: _rewrap(g, mask_live_rows(
            g.to_local(), live)), grads)
    leaf = flatten_sorted(params)[0][0].to_local()
    return (_local_steps(params, grads, eps),
            dataclasses.replace(state, step=state.step + 1),
            {"gate": torch.zeros((leaf.shape[0],), dtype=torch.float32,
                                 device=leaf.device)})


def tp_gossip_apply(params, grads, state: GossipState, shift_idx: int,
                    block_idx: int, gcfg, acfg, *, mesh, tally=None,
                    live=None):
    """One ASGD round of the pytree engine (``core/gossip.py
    asgd_gossip_apply``) on placed trees: ``params`` and ``grads`` DTensor
    trees with the same placements, ``state`` from
    :func:`init_placed_gossip_state`.  'leaves' mode sends the drawn
    group's shards; 'rows' mode each leaf's part of the drawn 1/p block
    along dim 1 (:func:`_rows_range`), to the ring peer at the same
    ``model`` coordinate (:func:`_send_parts`), and blends and writes back
    the rank's rows.  The silent flag and the off-rounds of ``gossip_every
    > 1`` take the local step (:func:`_local_round`).  ``live``: this
    rank's (W_local,) slice of the fleet's 0/1 liveness (the same on every
    ``model`` rank of a worker coordinate), on an elastic state: a dead
    worker's step is masked, the payloads from or to it are dropped, and
    the payload's validity (:func:`_roll_live`), the buffered one's and
    ``live`` fold into the gate's scale.  ``tally``: an object whose
    ``bytes_sent`` counts what this rank sends.

    Returns (new_params, new_state, {"gate": (W_local,)}) — every rank of a
    worker coordinate gets the same."""
    leaves, treedef = flatten_sorted(params)
    local = [x.to_local() for x in leaves]
    live = _resolve_live(state.buf_live is not None, live, local[0].shape[0],
                         local[0].device, "tensor-parallel step")
    if acfg.silent or (gcfg.gossip_every > 1
                       and state.step % gcfg.gossip_every):
        return _local_round(params, grads, state, acfg.eps, live)
    rows = gcfg.partial_mode == "rows"
    if rows and any(_is_placed(x) for x in flatten_sorted(state.buf)[0]):
        raise ValueError("tensor-parallel 'rows' mode: the gossip state "
                         "holds each rank's block parts (use "
                         "init_placed_gossip_state)")
    shift, p = gcfg.shifts[shift_idx], gcfg.partial_blocks
    local_grads = [g.to_local() for g in flatten_sorted(grads)[0]]
    sent_live = None
    if live is not None:
        sent_live = _roll_live(live, shift, mesh, tally)
        local_grads = [mask_live_rows(g, live) for g in local_grads]
    if rows:
        sent = _send_parts(_rows_block(local, leaves, block_idx, p), shift,
                           gcfg, mesh, tally, sharded=not all(
                               _replicated(x) for x in leaves))
        sent = [mask_live_rows(x, sent_live) for x in sent]
    else:
        gids = flatten_sorted(leaf_groups(params, p))[0]
        sent = _exchange_leaves(leaves, local, gids, shift, block_idx, gcfg,
                                mesh, tally)
        sent = [mask_live_rows(x, sent_live) if g == block_idx else x
                for x, g in zip(sent, gids)]
    if gcfg.delay == 0:
        ext, ext_idx, valid, ext_live = sent, block_idx, None, sent_live
    else:
        # single-slot buffer, as core.gossip's
        ext, ext_idx, ext_live = ([_local_of(x) for x in
                                   flatten_sorted(state.buf)[0]],
                                  state.buf_idx, state.buf_live)
        valid = staleness_valid(state.step, gcfg, depth=1)
    gate_scale = combine_gate_scale(valid, ext_live, live)
    # a replicated leaf's terms: added on model rank 0 only
    first = mesh.get_local_rank("model") == 0
    counted = [first or not _replicated(x) for x in leaves]
    if rows:
        new = [local_sgd_apply(w, g, acfg.eps)
               for w, g in zip(local, local_grads)]
        blk = _rows_block(local, leaves, ext_idx, p)
        gblk = _rows_block(local_grads, leaves, ext_idx, p)
        keep = [i for i, x in enumerate(blk) if x.numel()]
        out, gate = _blend(
            [blk[i] for i in keep], [gblk[i] for i in keep],
            [ext[i] for i in keep], None, ext_idx,
            [counted[i] for i in keep], gate_scale, gcfg, acfg, mesh)
        for i, b in zip(keep, out):       # the rank's rows written back
            r = _rows_range(leaves[i], ext_idx, p)
            if r is None:
                new[i] = b.to(new[i].dtype)
            else:
                new[i][:, r[0]:r[1]] = b.to(new[i].dtype)
        buf = unflatten(treedef, sent)
    else:
        new, gate = _blend(local, local_grads, ext, gids, ext_idx, counted,
                           gate_scale, gcfg, acfg, mesh)
        buf = unflatten(treedef, [_rewrap(x, t) for x, t in
                                  zip(leaves, sent)])
    new_state = GossipState(buf=buf, buf_idx=block_idx, step=state.step + 1,
                            buf_live=sent_live)
    return (unflatten(treedef, [_rewrap(x, t) for x, t in zip(leaves, new)]),
            new_state, {"gate": gate})


def _local_steps(params, grads, eps):
    """``core/gossip.py local_sgd_apply`` on the local shards: w − eps·g,
    nothing exchanged."""
    return tree_map(lambda x, g: _rewrap(x, local_sgd_apply(
        x.to_local(), g.to_local(), eps)), params, grads)


def tp_sync_apply(params, grads, eps, *, mesh):
    """``core/gossip.py sync_dp_apply`` (algo 'sync') on placed trees: each
    worker steps with the mean of all W workers' steps.  Leaf by leaf, a
    rank's (W_local, ...) local shards are summed over its workers, then
    over the worker group in rank order (``psum_rank_order``), and divided
    by W; each rank holds one leaf's sum at a time."""
    axes = data_axes(mesh)
    n = flatten_sorted(grads)[0][0].to_local().shape[0] * \
        n_worker_groups(mesh)

    def step(x, g):
        local, glocal = x.to_local(), g.to_local()
        total = psum_rank_order(glocal.sum(dim=0, keepdim=True), mesh, axes)
        mean = (total / n).expand_as(glocal).to(local.dtype)
        return _rewrap(x, local - eps * mean)
    return tree_map(step, params, grads)


def tp_direction(params, grads, opt_state, inner: str, eps):
    """``launch/steps.py inner_direction`` on placed trees: (dw, new
    opt_state), the optimizer's update ('momentum', 'adam') on each rank's
    local shards, elementwise, so its values are the whole leaves'.
    ``opt_state``: ``init_inner_state(placed params, inner)``, its moments
    DTensors with their params' placements (Adam's ``t`` an int).  The
    gossip blends params only, never moments."""
    from .steps import inner_direction
    if inner == "sgd":
        return grads, opt_state
    dw, new_s = inner_direction(*(tree_map(_local_of, t) for t in
                                  (params, grads, opt_state)), inner, eps)
    return tree_map(_rewrap, grads, dw), tree_map(
        lambda like, x: _rewrap(like, x) if _is_placed(like) else x,
        opt_state, new_s)


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Tally:
    bytes_sent: int = 0


class TensorParallelStep:
    """``step(params, gossip, opt_state, batch, shift_idx, block_idx,
    live=None) -> (params, gossip, opt_state, metrics)`` on a rank of
    ``mesh``: params a tree of DTensor leaves (:func:`place_params`),
    gossip :func:`init_placed_gossip_state` of them (``elastic=True`` for
    ``live=``), opt_state ``launch/steps.py init_inner_state`` of them,
    batch the rank's worker slice ``{"tokens": (W_local, B, S)}``, with
    ``"frames"`` (W_local, B, S_enc, D) or ``"patches"`` (W_local, B, P,
    D) for a frontend (each the same on every ``model`` rank of a worker
    coordinate), the draws host ints, the same on every rank, and
    ``live`` the rank's (W_local,) slice of the fleet's liveness (algo
    'asgd' only).  The inner optimizer's direction (:func:`tp_direction`)
    feeds the algo: 'asgd' runs the gossip round (:func:`tp_gossip_apply`;
    under ``ASGDConfig(silent=True)`` and on the off-rounds of
    ``gossip_every > 1`` the local step, the counter bumped and the gates
    shut), 'silent' the local step and 'sync' the worker mean
    (:func:`tp_sync_apply`), the gossip state untouched.  metrics: "loss"
    the mean over all W workers, and for 'asgd' "gate" (W,) and "n_good"
    gathered over the worker axes, so every rank reports the whole
    ensemble's.  ``bytes_sent``: what this rank has put on the wire.
    Built by ``launch/steps.py make_train_step`` after
    :func:`check_scope`."""

    def __init__(self, cfg, mesh, *, gcfg, acfg, remat, algo="asgd",
                 inner="sgd"):
        self.cfg, self.mesh, self.remat = cfg, mesh, remat
        self.gcfg, self.acfg, self.algo, self.inner = gcfg, acfg, algo, inner
        self.mm = model_mesh(mesh)
        self._tally = _Tally()

    @property
    def bytes_sent(self) -> int:
        return self._tally.bytes_sent

    def loss_and_grad(self, params, batch):
        """Per-worker losses (W_local,) and the gradient tree, each leaf
        with its param's placements."""
        from torch.distributed.tensor.experimental import implicit_replication

        from .steps import tree_loss_and_grad
        with implicit_replication(), mesh_context(self.mm):
            losses, grads = tree_loss_and_grad(self.cfg, params, batch,
                                               remat=self.remat)
        return losses.full_tensor(), tree_map(
            lambda g, p: g.redistribute(self.mm, p.placements), grads,
            params)

    def _round(self, params, dw, gossip, shift_idx, block_idx, live):
        """(new params, new gossip state, this rank's (W_local,) gates or
        None where the algo has none)."""
        eps = self.acfg.eps
        if self.algo == "sync":
            return (tp_sync_apply(params, dw, eps, mesh=self.mesh),
                    gossip, None)
        if self.algo == "silent":
            return _local_steps(params, dw, eps), gossip, None
        new_params, new_gossip, gm = tp_gossip_apply(
            params, dw, gossip, shift_idx, block_idx, self.gcfg,
            self.acfg, mesh=self.mesh, tally=self._tally, live=live)
        return new_params, new_gossip, gm["gate"]

    def __call__(self, params, gossip, opt_state, batch, shift_idx,
                 block_idx, live=None):
        from .steps import check_live
        check_live(live, self.algo)
        losses, grads = self.loss_and_grad(params, batch)
        with torch.no_grad():
            dw, opt_state = tp_direction(params, grads, opt_state,
                                         self.inner, self.acfg.eps)
            new_params, new_gossip, gate = self._round(
                params, dw, gossip, shift_idx, block_idx, live)
            metrics = {}
            if gate is not None:
                gate = gather_workers(gate, self.mesh)
                metrics = {"gate": gate, "n_good": gate.sum()}
            metrics = {"loss": gather_workers(losses, self.mesh).mean(),
                       **metrics}
        return new_params, new_gossip, opt_state, metrics
