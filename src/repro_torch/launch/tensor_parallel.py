"""Tensor parallelism over ``model``: the pytree ASGD train step on leaves
placed as ``launch/sharding.py`` lays them out.

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
  replica of a replicated leaf is written alike.

Scope (:func:`check_scope`): configs of attention layers ('G', 'L'
windows, 'E' encoder layers) with dense MLPs (GLU or plain with biases),
RMSNorm or LayerNorm, RoPE or sinusoidal positions, softcaps, scaled
embeddings, a vision prefix of patches or an audio encoder with
cross-attention (smollm-135m, qwen2.5-14b, qwen3-14b, gemma3-1b,
paligemma-3b, whisper-tiny); algo 'asgd', inner 'sgd', 'leaves' mode, a
round every step, the blend through B2r/B2a
(``ASGDConfig(use_fused=True)``) and wire None or "dtype".  'R' and 'S'
layers, MoE, and every other option raise NotImplementedError naming
their ROADMAP item.  Where the heads do not divide over ``model`` (the
d_model fallback of ``sharding.param_pspec``), DTensor contracts the
sharded d_model and replicates the attention's operands: correct, not
parallel.  Transport: NCCL for CUDA tensors, gloo for CPU tensors
(``launch/mesh.py _check_transport``); nothing is staged through the
host.
"""
from __future__ import annotations

import dataclasses
import functools

import torch
import torch.distributed as dist

from ..core.gossip import (GossipState, _fused_blend, leaf_groups,
                           resolved_wire_format, staleness_valid)
from ..core.tree import flatten_sorted, tree_map, unflatten
from . import sharding as SH
from .mesh import (_roll_workers_manual, _worker_group, data_axes,
                   gather_workers, mesh_context, shard_workers)


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"tensor-parallel train step: {what} is not ported (ROADMAP Queue A "
        f"item {item})")


def _model_features(cfg):
    """(what, ROADMAP item, present) of each model feature the DTensor path
    does not carry."""
    types = set(cfg.pattern_cycle)
    return (("'R' (RG-LRU) layers", "15e", "R" in types),
            ("'S' (SSD) layers", "15e", "S" in types),
            ("MoE FFNs", "15e", cfg.n_experts > 0))


def check_scope(cfg, *, algo, inner, gcfg, acfg, pack_spec=None,
                pipelined=False, lr_schedule=None) -> None:
    """Raise NotImplementedError for what the tensor-parallel step does not
    carry, naming the ROADMAP item that queues it: the model by its
    features (``_model_features``), the step by its options."""
    for what, item, present in _model_features(cfg):
        if present:
            raise _not_ported(f"{what} ({cfg.name!r})", item)
    if pack_spec is not None or pipelined or lr_schedule is not None:
        raise ValueError(
            "mesh= runs the pytree engine; the packed and pipelined engines "
            "shard only the worker axis and run on a mesh through "
            "launch/mesh.py's regions")
    if resolved_wire_format(gcfg) == "int8":
        raise _not_ported("the int8 wire on shards", "15d")
    for what, bad in ((f"algo {algo!r}", algo != "asgd"),
                      (f"inner {inner!r}", inner != "sgd"),
                      (f"partial_mode {gcfg.partial_mode!r}",
                       gcfg.partial_mode != "leaves"),
                      ("the plain blend (ASGDConfig(use_fused=False))",
                       not acfg.use_fused),
                      ("ASGDConfig(silent=True)", acfg.silent),
                      (f"gossip_every {gcfg.gossip_every}",
                       gcfg.gossip_every != 1)):
        if bad:
            raise _not_ported(what, "15f")
    if gcfg.gate_psum_axes not in ((), ("model",)):
        raise ValueError(
            f"gate_psum_axes={gcfg.gate_psum_axes!r}: the tensor-parallel "
            "round sums the gate partials over 'model' itself")


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


def tp_gossip_apply(params, grads, state: GossipState, shift_idx: int,
                    block_idx: int, gcfg, acfg, *, mesh, tally=None):
    """One ASGD round of the pytree engine ('leaves' mode, fused blend) on
    placed trees: ``params``, ``grads`` and ``state.buf`` DTensor trees
    with the same placements.  ``tally``: an object whose ``bytes_sent``
    counts what this rank sends.

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
    new, gate = _fused_blend(
        tree(local), tree([g.to_local() for g in flatten_sorted(grads)[0]]),
        tree(ext), dataclasses.replace(gcfg, gate_psum_axes=("model",)),
        acfg, tree(gids), ext_idx, gate_scale=valid, mesh=mesh,
        reduce_groups=reduce_gids)
    new_state = GossipState(
        buf=tree([_rewrap(x, t) for x, t in zip(leaves, sent)]),
        buf_idx=block_idx, step=state.step + 1)
    return (tree([_rewrap(x, t) for x, t in
                  zip(leaves, flatten_sorted(new)[0])]),
            new_state, {"gate": gate})


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
    coordinate), the draws host ints, the same on every rank.  metrics: "loss" the mean over all W workers, and
    "gate" (W,) and "n_good" gathered over the worker axes, so every rank
    reports the whole ensemble's.  ``bytes_sent``: what this rank
    has put on the wire.  Built by ``launch/steps.py make_train_step``
    after :func:`check_scope`."""

    def __init__(self, cfg, mesh, *, gcfg, acfg, remat):
        self.cfg, self.mesh, self.remat = cfg, mesh, remat
        self.gcfg, self.acfg = gcfg, acfg
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

    def __call__(self, params, gossip, opt_state, batch, shift_idx,
                 block_idx, live=None):
        if live is not None:
            raise _not_ported("elastic live=", "15f")
        losses, grads = self.loss_and_grad(params, batch)
        with torch.no_grad():
            new_params, new_gossip, gm = tp_gossip_apply(
                params, grads, gossip, shift_idx, block_idx, self.gcfg,
                self.acfg, mesh=self.mesh, tally=self._tally)
            gate = gather_workers(gm["gate"], self.mesh)
            metrics = {"loss": gather_workers(losses, self.mesh).mean(),
                       "gate": gate, "n_good": gate.sum()}
        return new_params, new_gossip, opt_state, metrics
