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
* gossip round — the pytree engine's 'leaves' round with the fused blend
  (``core/gossip.py _apply_leaves``, ``_fused_blend``) on the rank's
  local shards.  The groups come from the leaves' global shapes (a
  DTensor's ``numel`` is its global one; the local worker count scales
  every leaf alike).  The group's shards travel, in the wire's dtype, to
  the ring peer at the same ``model`` coordinate over the worker group
  (``launch/mesh.py _roll_workers_manual``): a rank's wire bytes are its
  shards'.  B2r's ``(W_local, 1, 3)`` partials of the rank's pack are
  summed over ``model`` in rank order (``psum_rank_order``).  A
  replicated leaf is whole on every ``model`` rank, so its rows enter
  B2r's mask on ``model`` rank 0 only and are counted once; B2a blends
  under the round's group mask with the one set of gates, so every
  replica of a replicated leaf is written alike.  The plain blend
  (``ASGDConfig(use_fused=False)``, the reference's default) is the same
  round in plain torch (``core/gossip.py _per_worker_reduce3``,
  ``gate_from_terms``, ``blend_group``): each worker's three eq.-4 terms
  summed over the rank's shards (a replicated leaf's on ``model`` rank 0
  only), then over ``model`` once in rank order, and every leaf of the
  group blended under the one gate.
* algos 'silent' (the local step) and 'sync' (each worker steps with the
  mean of all W workers' steps: a rank's local shards summed over its
  workers, then over the worker group in rank order, leaf by leaf), and
  ``ASGDConfig(silent=True)`` (the local step, the round counter
  bumped, the gates shut), as ``core/gossip.py``'s.

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
cross-attention (all ten archs); algos 'asgd', 'silent' and 'sync',
inner 'sgd', 'leaves' mode, a round every step, the blend through
B2r/B2a (``ASGDConfig(use_fused=True)``) or in plain torch,
``ASGDConfig(silent=True)``, and wire None or "dtype".  Every other
option raises NotImplementedError naming its ROADMAP item.  An 'S' layer
runs kernel B5 (B5b under autograd) on each rank's own heads, an 'R'
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

import torch
import torch.distributed as dist

from ..core.gossip import (GossipState, _fused_blend, _per_worker_reduce3,
                           blend_group, leaf_groups, local_sgd_apply,
                           resolved_wire_format, staleness_valid)
from ..core.parzen import gate_from_terms
from ..core.tree import flatten_sorted, tree_map, unflatten
from . import sharding as SH
from .mesh import (_roll_workers_manual, _worker_group, data_axes,
                   gather_workers, mesh_context, n_worker_groups,
                   psum_rank_order, shard_workers)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"tensor-parallel train step: {what} is not ported (ROADMAP Queue "
        f"A item {item})")


def check_scope(cfg, *, algo, inner, gcfg, acfg, pack_spec=None,
                pipelined=False, lr_schedule=None) -> None:
    """Raise NotImplementedError for what the tensor-parallel step does not
    carry, naming the ROADMAP item that queues it: every model the port
    carries is (``models.blocks.check_supported``), and algos 'asgd',
    'silent' and 'sync', the fused and the plain blend and
    ``ASGDConfig(silent=True)``; not every option of the step."""
    from ..models.blocks import check_supported
    check_supported(cfg)
    if pack_spec is not None or pipelined or lr_schedule is not None:
        raise ValueError(
            "mesh= runs the pytree engine; the packed and pipelined engines "
            "shard only the worker axis and run on a mesh through "
            "launch/mesh.py's regions")
    if resolved_wire_format(gcfg) == "int8":
        raise _not_ported("the int8 wire on shards", "15d")
    for what, bad in ((f"inner {inner!r}", inner != "sgd"),
                      (f"partial_mode {gcfg.partial_mode!r}",
                       gcfg.partial_mode != "leaves"),
                      (f"gossip_every {gcfg.gossip_every}",
                       gcfg.gossip_every != 1)):
        if bad:
            raise _not_ported(what, "15f")
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


# ---------------------------------------------------------------------------
# the gossip round on local shards
# ---------------------------------------------------------------------------

def _exchange_shards(local, gids, shift: int, block_idx: int, gcfg, group,
                     tally):
    """This round's peer block on the rank's shards, full-tree shaped: the
    shards of group ``block_idx`` cast to the wire's dtype, rolled along
    the worker ring in one batch of sends, cast back; zeros elsewhere."""
    sel = [i for i, g in enumerate(gids) if g == block_idx]
    out = [torch.zeros_like(x) for x in local]
    if not sel:
        return out
    if resolved_wire_format(gcfg) == "dtype":
        wire = gcfg.payload_dtype
    else:
        wire = functools.reduce(torch.promote_types,
                                [local[i].dtype for i in sel])
    wl = local[sel[0]].shape[0]
    flat = torch.cat([local[i].reshape(wl, -1).to(wire) for i in sel], 1)
    recv = _roll_workers_manual(flat, shift, group,
                                dist.get_world_size(group), wl, tally)
    parts = recv.split([local[i][0].numel() for i in sel], dim=1)
    for i, part in zip(sel, parts):
        out[i] = part.reshape(local[i].shape).to(local[i].dtype)
    return out


def _plain_blend(local, grads, ext, gids, reduce_gids, ext_idx, gate_scale,
                 acfg, mesh):
    """``core/gossip.py``'s plain blend ('leaves' mode, ``use_fused=False``)
    on the rank's local shards: each worker's three eq.-4 terms summed
    over its shards (``_per_worker_reduce3``; ``reduce_gids`` leaves a
    replicated leaf to ``model`` rank 0), then over ``model`` once, in rank
    order; the gate from the sums (``gate_from_terms``), and every leaf of
    group ``ext_idx`` blended under it (``blend_group``), the rest
    stepped.
    Returns (new local shards, gate (W_local,))."""
    terms = torch.stack(_per_worker_reduce3(local, grads, ext, reduce_gids,
                                            ext_idx), dim=-1)
    terms = psum_rank_order(terms, mesh, ("model",))
    gate = gate_from_terms(terms[:, 0], terms[:, 1], terms[:, 2], acfg.eps,
                           use_parzen=acfg.use_parzen)
    if gate_scale is not None:
        gate = gate * gate_scale
    return blend_group(local, grads, ext, gids, ext_idx, gate, acfg), gate


def tp_gossip_apply(params, grads, state: GossipState, shift_idx: int,
                    block_idx: int, gcfg, acfg, *, mesh, tally=None):
    """One ASGD round of the pytree engine ('leaves' mode, the fused blend
    through B2r/B2a or, ``use_fused=False``, the plain one) on placed
    trees: ``params``, ``grads`` and ``state.buf`` DTensor trees with the
    same placements.  ``tally``: an object whose ``bytes_sent`` counts
    what this rank sends.

    Returns (new_params, new_state, {"gate": (W_local,)}) — every rank of a
    worker coordinate gets the same."""
    leaves, treedef = flatten_sorted(params)
    local = [x.to_local() for x in leaves]
    gids = flatten_sorted(leaf_groups(params, gcfg.partial_blocks))[0]
    sent = _exchange_shards(local, gids, gcfg.shifts[shift_idx], block_idx,
                            gcfg, _worker_group(mesh), tally)
    if gcfg.delay == 0:
        ext, ext_idx, valid = sent, block_idx, None
    else:
        # single-slot buffer, as core.gossip._apply_leaves
        ext = [x.to_local() for x in flatten_sorted(state.buf)[0]]
        ext_idx = state.buf_idx
        valid = staleness_valid(state.step, gcfg, depth=1)

    def tree(xs):
        return unflatten(treedef, xs)
    # a replicated leaf's terms: added on model rank 0 only (-1: a group
    # no round draws)
    reduce_gids = None
    if mesh.get_local_rank("model") > 0:
        reduce_gids = tree([-1 if _replicated(x) else g
                            for x, g in zip(leaves, gids)])
    local_grads = tree([g.to_local() for g in flatten_sorted(grads)[0]])
    if acfg.use_fused:
        new, gate = _fused_blend(
            tree(local), local_grads, tree(ext),
            dataclasses.replace(gcfg, gate_psum_axes=("model",)), acfg,
            tree(gids), ext_idx, gate_scale=valid, mesh=mesh,
            reduce_groups=reduce_gids)
    else:
        new, gate = _plain_blend(
            tree(local), local_grads, tree(ext), tree(gids),
            tree(gids) if reduce_gids is None else reduce_gids, ext_idx,
            valid, acfg, mesh)
    new_state = GossipState(
        buf=tree([_rewrap(x, t) for x, t in zip(leaves, sent)]),
        buf_idx=block_idx, step=state.step + 1)
    return (tree([_rewrap(x, t) for x, t in
                  zip(leaves, flatten_sorted(new)[0])]),
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
    gossip ``core.gossip.init_gossip_state(params, gcfg)`` of them, batch
    the rank's worker slice ``{"tokens": (W_local, B, S)}``, with
    ``"frames"`` (W_local, B, S_enc, D) or ``"patches"`` (W_local, B, P,
    D) for a frontend (each the same on every ``model`` rank of a worker
    coordinate), the draws host ints, the same on every rank.  ``algo``
    'asgd' runs the gossip round (:func:`tp_gossip_apply`; under
    ``ASGDConfig(silent=True)`` the local step alone, the round's
    counter bumped and its gates shut, as ``core.gossip``'s silent
    round), 'silent' the local step and 'sync' the worker mean
    (:func:`tp_sync_apply`), the gossip state untouched.  metrics: "loss"
    the mean over all W workers, and for 'asgd' "gate" (W,) and "n_good"
    gathered over the worker axes, so every rank reports the whole
    ensemble's.  ``bytes_sent``: what this rank has put on the wire.
    Built by ``launch/steps.py make_train_step`` after
    :func:`check_scope`."""

    def __init__(self, cfg, mesh, *, gcfg, acfg, remat, algo="asgd"):
        self.cfg, self.mesh, self.remat = cfg, mesh, remat
        self.gcfg, self.acfg, self.algo = gcfg, acfg, algo
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

    def _round(self, params, grads, gossip, shift_idx, block_idx):
        """(new params, new gossip state, this rank's (W_local,) gates or
        None where the algo has none)."""
        eps = self.acfg.eps
        if self.algo == "sync":
            return (tp_sync_apply(params, grads, eps, mesh=self.mesh),
                    gossip, None)
        if self.algo == "silent":
            return _local_steps(params, grads, eps), gossip, None
        if self.acfg.silent:
            leaf = flatten_sorted(params)[0][0].to_local()
            return (_local_steps(params, grads, eps),
                    dataclasses.replace(gossip, step=gossip.step + 1),
                    torch.zeros((leaf.shape[0],), dtype=torch.float32,
                                device=leaf.device))
        new_params, new_gossip, gm = tp_gossip_apply(
            params, grads, gossip, shift_idx, block_idx, self.gcfg,
            self.acfg, mesh=self.mesh, tally=self._tally)
        return new_params, new_gossip, gm["gate"]

    def __call__(self, params, gossip, opt_state, batch, shift_idx,
                 block_idx, live=None):
        if live is not None:
            raise _not_ported("elastic live=", "15f")
        losses, grads = self.loss_and_grad(params, batch)
        with torch.no_grad():
            new_params, new_gossip, gate = self._round(
                params, grads, gossip, shift_idx, block_idx)
            metrics = {}
            if gate is not None:
                gate = gather_workers(gate, self.mesh)
                metrics = {"gate": gate, "n_good": gate.sum()}
            metrics = {"loss": gather_workers(losses, self.mesh).mean(),
                       **metrics}
        return new_params, new_gossip, opt_state, metrics
