"""Train steps of the gossip engines.

  pytree     — the state is a tree of (W, ...) leaves; the loss is
               differentiated leaf by leaf, then asgd_gossip_apply runs
               one round ('leaves' or 'rows' mode, the blend in plain
               torch or, with ASGDConfig.use_fused, through B2r/B2a)
  packed     — the ``(W, R, LANE)`` packed ensemble is the carried state,
               differentiated through ``unpack_w`` views so ``.grad`` IS
               the packed local step; asgd_gossip_apply_packed
  pipelined  — the packed state; initiate_exchange_packed before the
               forward/backward, consume_exchange_packed after it (blend
               of the payload launched delay+1 rounds ago)

and the serving steps (:func:`make_prefill_step`, :func:`make_decode_step`)
over models.model's prefill and decode_step.

``algo`` 'sync' (the synchronous data-parallel baseline) and 'silent'
(SimuParallelSGD) replace the gossip round on the pytree and packed
engines.  The packed engines keep the inner-optimizer state packed
(momentum/Adam are elementwise, so their values match the reference's
pytree state leaf for leaf, with zeros in the padding).

The input specs (:func:`input_specs`, :func:`step_and_args`) describe a
step's arguments at a production mesh's GLOBAL shapes without allocating
anything: each tensor is a :class:`Struct`, a ``meta`` tensor of the
reference's shape and dtype with its spec (``launch/sharding.py``).  The
scalars the reference carries as device ints — the round's draws, the
FIFO's partition indices and step, the sgd optimizer's placeholder, the
decode position — are host ints here, as the port's steps take them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..core.asgd import ASGDConfig
from ..core.gossip import (GossipConfig, _silent_round, asgd_gossip_apply,
                           asgd_gossip_apply_packed, consume_exchange_packed,
                           initiate_exchange_packed, local_sgd_apply,
                           sync_dp_apply)
from ..core.packing import unpack_w
from ..core.tree import flatten_sorted, tree_map, unflatten
from ..models import model as M
from . import sharding as SH
from .mesh import data_axes, n_worker_groups

# the reference's struct dtype (its PARAM_DTYPE); the port itself trains
# and serves in f32, and its dry-run traces with dtype=torch.float32
PARAM_DTYPE = torch.bfloat16

# train-step engines (input_specs / step_and_args / dryrun --engine):
#   pytree    — the per-leaf tree of (W, ...) leaves
#   packed    — the packed-resident (W, R, LANE) ensemble
#   pipelined — packed-resident + the one-round-deep exchange pipeline
ENGINES = ("pytree", "packed", "pipelined")


def packed_loss_and_grad(cfg: ModelConfig, packed, batch, spec, *,
                         remat=True):
    """Per-worker losses (W,) and their gradient w.r.t. the packed
    ensemble, born packed: the W-batched forward reads ``unpack_w`` views
    of one leaf tensor, and one backward through the views' split fills
    the (W, R, LANE) gradient directly.  The workers' losses are
    independent, so the gradient of their sum is each worker's own.
    ``remat``: models.model.forward_w's (backward recomputes each cycle
    from the same views, so nothing may write ``packed`` before it)."""
    leaf = packed.detach().requires_grad_(True)
    losses = M.loss_fn_w(cfg, unpack_w(leaf, spec), batch, remat=remat)
    losses.sum().backward()
    return losses.detach(), leaf.grad


def tree_loss_and_grad(cfg: ModelConfig, params, batch, *, remat=True):
    """Per-worker losses (W,) and their gradient tree w.r.t. ``params``
    (a tree of (W, ...) leaves).  The workers' losses are independent, so
    the gradient of their sum is each worker's own.  ``remat``:
    models.model.forward_w's."""
    leaves, treedef = flatten_sorted(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    losses = M.loss_fn_w(cfg, unflatten(treedef, xs), batch, remat=remat)
    grads = torch.autograd.grad(losses.sum(), xs, allow_unused=True)
    return losses.detach(), unflatten(treedef, [
        torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)])


def make_train_step(cfg: ModelConfig, *, pack_spec=None, algo="asgd",
                    inner="sgd", gcfg: GossipConfig | None = None,
                    acfg: ASGDConfig | None = None, remat=True,
                    pipelined=False, lr_schedule=None, mesh=None):
    """Returns step(params, gossip, opt_state, batch, shift_idx, block_idx,
    live=None) -> (params, gossip, opt_state, metrics).

    pack_spec None selects the pytree engine: params is a tree of (W, ...)
    leaves, gossip an init_gossip_state.  Otherwise params is the
    (W, R, LANE) f32 ensemble on pack_spec (group-contiguous for 'leaves'
    mode) and gossip an init_packed_gossip_state (init_pipelined_
    gossip_state when pipelined).  batch: {"tokens": (W, B, S)}, with
    "frames" (W, B, S_enc, D) for an audio arch and "patches" (W, B, P, D)
    for a vision arch, passed through to the model unchanged;
    shift_idx, block_idx: this round's host-int draws
    (core.gossip.draw_gossip_indices); live: optional (W,) f32 0/1
    per-peer liveness on an elastic gossip state (algo 'asgd' only).
    algo: 'asgd' (paper), 'silent' (SimuParallelSGD: local steps only) or
    'sync' (synchronous data-parallel SGD).  inner: 'sgd' | 'momentum' |
    'adam'.  lr_schedule (pipelined only): step -> lr, the consume blend's
    per-round lr operand.  remat: every engine's forward checkpoints each
    full cycle of the layer pattern per ``cfg.remat_policy``
    (models.model.forward_w), the reference's default.
    mesh: a ``("data", "model")`` DeviceMesh (the reference's
    ``spmd_axes=``): the pytree step on this rank's worker slice (of the
    params and of the batch, frames and patches too), every
    leaf a DTensor placed over ``model`` by launch/sharding.py
    (launch/tensor_parallel.py: place_params, TensorParallelStep, whose
    scope check raises for what it does not carry).
    Raises NotImplementedError for an arch the port does not carry
    (models.blocks.check_supported); 'S' layers train through the SSD
    scan's backward (kernel B5b on the card), so a batch's seq must be a
    multiple of cfg.ssm_chunk (models.ssm.apply_ssd raises otherwise).
    The reported loss includes the MoE router's aux term (models.model
    .loss_fn_w), which every engine differentiates with the rest.
    """
    from ..optim import adam_update, momentum_update

    M.check_supported(cfg)

    gcfg = gcfg or GossipConfig()
    acfg = acfg or ASGDConfig(eps=0.01)
    if algo not in ("asgd", "silent", "sync"):
        raise ValueError(f"unknown algo {algo!r}")
    if pipelined:
        if pack_spec is None:
            raise ValueError("pipelined=True requires pack_spec (the "
                             "packed-resident layout)")
        if algo != "asgd":
            raise ValueError(
                f"pipelined=True requires algo='asgd' (got {algo!r}): the "
                "pipeline overlaps the gossip exchange — sync/silent have "
                "no exchange to overlap")
        if gcfg.gossip_every > 1:
            raise ValueError(
                "pipelined=True requires gossip_every == 1 (use "
                "core.gossip.asgd_gossip_apply_pipelined for interval "
                "gossip)")
    if lr_schedule is not None and not pipelined:
        raise ValueError(
            "lr_schedule= is only wired into the pipelined engine")
    if mesh is not None:
        from .tensor_parallel import TensorParallelStep, check_scope
        check_scope(cfg, algo=algo, inner=inner, gcfg=gcfg, acfg=acfg,
                    pack_spec=pack_spec, pipelined=pipelined,
                    lr_schedule=lr_schedule)
        return TensorParallelStep(cfg, mesh, gcfg=gcfg, acfg=acfg,
                                  remat=remat)

    def direction(params, grads, opt_state):
        """(dw, new_opt_state): w - eps*dw is the inner-optimizer step
        (params and grads: a tree or the packed tensor)."""
        if inner == "sgd":
            return grads, opt_state
        update = momentum_update if inner == "momentum" else adam_update
        new_p, new_s = update(params, grads, opt_state, acfg.eps)
        return tree_map(lambda w, n: (w - n) / acfg.eps, params,
                        new_p), new_s

    def baseline(params, dw):
        """The non-gossip algos' update: sync or silent."""
        if algo == "sync":
            return sync_dp_apply(params, dw, acfg.eps)
        return local_sgd_apply(params, dw, acfg.eps)

    def check_live(live):
        if live is not None and algo != "asgd":
            raise ValueError(
                f"live= (per-peer liveness) requires algo='asgd' (got "
                f"{algo!r}): sync/silent carry no gossip state to gate")

    def pytree_step(params, gossip, opt_state, batch, shift_idx, block_idx,
                    live=None):
        check_live(live)
        loss, grads = tree_loss_and_grad(cfg, params, batch, remat=remat)
        with torch.no_grad():
            dw, opt_state = direction(params, grads, opt_state)
            metrics = {"loss": loss.mean()}
            if algo != "asgd":
                return baseline(params, dw), gossip, opt_state, metrics
            new_params, new_gossip, gm = asgd_gossip_apply(
                params, dw, gossip, shift_idx, block_idx, gcfg, acfg,
                live=live)
        metrics.update(gm)
        return new_params, new_gossip, opt_state, metrics

    if pack_spec is None:
        return pytree_step

    def step(packed, gossip, opt_state, batch, shift_idx, block_idx,
             live=None):
        check_live(live)
        lr = None if lr_schedule is None else lr_schedule(gossip.step)
        if pipelined and not acfg.silent:
            # INITIATE: this round's payload from the pre-blend ensemble;
            # with live, its launch-time validity crosses to the CONSUME
            sent = initiate_exchange_packed(packed, shift_idx, block_idx,
                                            gcfg, pack_spec, live=live)
            sent_live = sent[3] if live is not None else None
        loss, pgrads = packed_loss_and_grad(cfg, packed, batch, pack_spec,
                                            remat=remat)
        with torch.no_grad():
            dw, opt_state = direction(packed, pgrads, opt_state)
            metrics = {"loss": loss.mean()}
            if algo != "asgd":
                return baseline(packed, dw), gossip, opt_state, metrics
            if pipelined:
                if acfg.silent:
                    new_packed, new_gossip, gm = _silent_round(
                        packed, dw, gossip, acfg.eps if lr is None else lr,
                        live)
                else:
                    # CONSUME: blend the payload launched delay+1 rounds
                    # ago, push this round's
                    new_packed, new_gossip, gm = consume_exchange_packed(
                        packed, dw, gossip, *sent[:3], gcfg, acfg,
                        pack_spec, lr=lr, sent_live=sent_live, live=live)
            else:
                new_packed, new_gossip, gm = asgd_gossip_apply_packed(
                    packed, dw, gossip, shift_idx, block_idx, gcfg, acfg,
                    pack_spec, live=live)
        metrics.update(gm)
        return new_packed, new_gossip, opt_state, metrics

    return step


def init_inner_state(params, inner="sgd"):
    from ..optim import adam_init, momentum_init
    if inner == "sgd":
        return 0   # stateless placeholder
    if inner == "momentum":
        return momentum_init(params)
    return adam_init(params)


def _serve_cfg(cfg: ModelConfig) -> ModelConfig:
    """The serving steps' config: batch-sharded attention and sequence
    parallelism are training-path layouts (a worker-local batch over the
    reference's `model` axis), off when serving."""
    return dataclasses.replace(cfg, attn_batch_shard=False,
                               seq_parallel=False)


def make_prefill_step(cfg: ModelConfig):
    """Returns step(params, batch) -> (last_logits (B, V), cache): the
    prompt's full-sequence pass (models.model.prefill), its cache as long
    as the prompt (and a vision prefix)."""
    cfg = _serve_cfg(cfg)

    def step(params, batch):
        return M.prefill(cfg, params, batch)
    return step


def make_decode_step(cfg: ModelConfig):
    """Returns step(params, token, pos, cache) -> (logits (B, V), cache):
    one greedy-decode position (models.model.decode_step; the cache is
    updated in place)."""
    cfg = _serve_cfg(cfg)

    def step(params, token, pos, cache):
        return M.decode_step(cfg, params, token, pos, cache)
    return step


# ---------------------------------------------------------------------------
# input specs: Structs (meta tensors with their specs) — never allocated
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Struct:
    """A step argument that is never allocated: ``meta`` is a tensor on
    the meta device of the global shape and dtype, ``spec`` its partition
    spec on the mesh (a tuple, ``launch/sharding.py``)."""

    meta: torch.Tensor
    spec: tuple

    @property
    def shape(self) -> tuple:
        return tuple(self.meta.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.meta.dtype


def _struct(shape, dtype, spec) -> Struct:
    return Struct(torch.empty(tuple(shape), dtype=dtype, device="meta"),
                  tuple(spec))


def _with_specs(tree, specs):
    leaves, treedef = flatten_sorted(tree)
    return unflatten(treedef, [Struct(x, s) for x, s in
                               zip(leaves, flatten_sorted(specs)[0])])


def metas(tree):
    """The meta tensors of a tree of Structs."""
    return tree_map(lambda s: s.meta, tree)


def batch_struct(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                 train: bool, dtype=PARAM_DTYPE, workers=None):
    """The host batch of one step.  train: tokens (W, B_local, S) where
    W = ``workers`` (default: the worker groups) and B_local =
    global_batch / W; serve: (B_global, S), batch over the data axes.  A
    vision arch's text is S minus its patches; frames/patches in
    ``dtype``."""
    wa = data_axes(mesh)
    W = workers or n_worker_groups(mesh)
    S = shape.seq_len
    S_text = S - cfg.prefix_len if cfg.frontend == "vision" else S

    def mk(shp, dt):
        return _struct(shp, dt, SH.batch_pspec(len(shp), worker_axes=wa,
                                               train=train))

    if train:
        lead = (W, max(1, shape.global_batch // W))
    else:
        lead = (shape.global_batch,)
    out = {"tokens": mk(lead + (S_text,), torch.int32)}
    if cfg.frontend == "audio":
        out["frames"] = mk(lead + (cfg.encoder_seq, cfg.d_model), dtype)
    if cfg.frontend == "vision":
        out["patches"] = mk(lead + (cfg.prefix_len, cfg.d_model), dtype)
    return out


def params_struct(cfg: ModelConfig, mesh, *, train: bool,
                  dtype=PARAM_DTYPE, workers=None):
    """The params (a leading W axis when train: ``workers``, default the
    worker groups)."""
    W = workers or n_worker_groups(mesh)
    shapes = M.init_model(cfg, device="meta", dtype=dtype)
    if train:
        shapes = tree_map(lambda x: x.expand((W,) + tuple(x.shape)),
                          shapes)
    return _with_specs(shapes, SH.tree_pspecs(
        mesh, shapes, worker_axes=data_axes(mesh), train=train))


def cache_struct(cfg: ModelConfig, shape: ShapeConfig, mesh,
                 dtype=PARAM_DTYPE):
    """One model's decode cache at the shape's batch and length."""
    cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                         dtype=dtype, device="meta")
    return _with_specs(cache, SH.cache_pspecs(mesh, cache, cfg,
                                              worker_axes=data_axes(mesh)))


def gossip_struct(cfg: ModelConfig, mesh, gcfg: GossipConfig,
                  dtype=PARAM_DTYPE, workers=None):
    """The pytree engine's GossipState: buf laid out like the params."""
    from ..core.gossip import init_gossip_state
    p_struct = params_struct(cfg, mesh, train=True, dtype=dtype,
                             workers=workers)
    state = init_gossip_state(metas(p_struct), gcfg)
    specs = tree_map(lambda s: s.spec, p_struct)
    return dataclasses.replace(state, buf=_with_specs(state.buf, specs))


def packed_spec_for(cfg: ModelConfig, mesh, gcfg: GossipConfig,
                    dtype=PARAM_DTYPE, workers=None):
    """Group-contiguous WPackSpec of the train params' structure, built
    from meta tensors (pack_spec_w reads shapes and sizes only)."""
    from ..core.gossip import leaf_groups
    from ..core.packing import pack_spec_w
    p = metas(params_struct(cfg, mesh, train=True, dtype=dtype,
                            workers=workers))
    return pack_spec_w(p, block_rows=gcfg.fused_block_rows,
                       groups=leaf_groups(p, gcfg.partial_blocks),
                       n_groups=gcfg.partial_blocks)


def _worker_split(mesh, ndim: int) -> tuple:
    return (SH._worker_entry(data_axes(mesh)),) + (None,) * (ndim - 1)


def packed_params_struct(cfg: ModelConfig, mesh, gcfg: GossipConfig,
                         spec=None, dtype=PARAM_DTYPE, workers=None):
    """The resident (W, rows, LANE) f32 ensemble, its worker axis over the
    data axes."""
    from ..kernels import LANE
    spec = spec or packed_spec_for(cfg, mesh, gcfg, dtype, workers)
    return _struct((spec.n_workers, spec.rows, LANE), torch.float32,
                   _worker_split(mesh, 3))


def packed_gossip_struct(cfg: ModelConfig, mesh, gcfg: GossipConfig,
                         spec=None, *, pipelined: bool = False,
                         dtype=PARAM_DTYPE, workers=None):
    """The PackedGossipState a packed-resident / pipelined run carries
    (FIFO depth per core.gossip.fifo_depth): each slot and its int8 scales
    split over the worker axis like the ensemble (the reference stacks
    the slots on a leading FIFO axis; the port keeps a tuple)."""
    from ..core.gossip import (fifo_depth, init_packed_gossip_state,
                               resolved_wire_format)
    spec = spec or packed_spec_for(cfg, mesh, gcfg, dtype, workers)
    p = packed_params_struct(cfg, mesh, gcfg, spec, dtype)
    block_rows = (spec.block_rows if resolved_wire_format(gcfg) == "int8"
                  else None)
    state = init_packed_gossip_state(
        p.meta, gcfg, block_rows=block_rows,
        depth=fifo_depth(gcfg, pipelined=pipelined))

    def attach(slots):
        return None if slots is None else tuple(
            Struct(x, _worker_split(mesh, x.ndim)) for x in slots)
    return dataclasses.replace(state, buf=attach(state.buf),
                               buf_scales=attach(state.buf_scales))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, mesh,
                gcfg: GossipConfig | None = None, engine: str = "pytree",
                dtype=PARAM_DTYPE, workers=None) -> dict:
    """Everything a step function needs, at global shapes, as Structs and
    host ints, keyed by the step's argument names.

    engine: 'pytree' (per-leaf params + GossipState) or 'packed' /
    'pipelined' (the resident (W, rows, LANE) ensemble +
    PackedGossipState).  ``workers``: the train shapes' W (default: the
    mesh's worker groups, the reference's).  A decode step's ``pos`` is
    the last position of the cache: the port's decode reads positions [0,
    pos] (the reference reads the whole cache under a mask), so that is
    its whole cost."""
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r} (expected {ENGINES})")
    gcfg = gcfg or GossipConfig()
    if shape.kind == "train":
        if engine != "pytree":
            spec = packed_spec_for(cfg, mesh, gcfg, dtype, workers)
            params = packed_params_struct(cfg, mesh, gcfg, spec, dtype)
            gossip = packed_gossip_struct(
                cfg, mesh, gcfg, spec, pipelined=engine == "pipelined",
                dtype=dtype)
        else:
            params = params_struct(cfg, mesh, train=True, dtype=dtype,
                                   workers=workers)
            gossip = gossip_struct(cfg, mesh, gcfg, dtype, workers)
        return {"params": params, "gossip": gossip, "opt_state": 0,
                "batch": batch_struct(cfg, shape, mesh, train=True,
                                      dtype=dtype, workers=workers),
                "shift_idx": 0, "block_idx": 0}
    if shape.kind == "prefill":
        return {"params": params_struct(cfg, mesh, train=False, dtype=dtype),
                "batch": batch_struct(cfg, shape, mesh, train=False,
                                      dtype=dtype)}
    wa = data_axes(mesh)
    w_size = n_worker_groups(mesh)
    tok_spec = ((SH._worker_entry(wa),)
                if shape.global_batch % w_size == 0 else (None,))
    return {"params": params_struct(cfg, mesh, train=False, dtype=dtype),
            "token": _struct((shape.global_batch,), torch.int32, tok_spec),
            "pos": shape.seq_len - 1,
            "cache": cache_struct(cfg, shape, mesh, dtype)}


def step_and_args(cfg: ModelConfig, shape: ShapeConfig, mesh,
                  gcfg: GossipConfig | None = None, algo="asgd",
                  engine: str = "pytree", dtype=PARAM_DTYPE, workers=None,
                  w_local=None, layers=None):
    """(step, input_specs): the port's step for the shape and engine —
    make_train_step (with the struct-derived pack spec for 'packed' /
    'pipelined'), make_prefill_step or make_decode_step — and its
    arguments as :func:`input_specs` gives them, in the step's order.
    ``w_local``: build the train step for one rank's slice of that many
    workers (its pack spec's worker count), as the dry-run traces it.
    ``layers``: the step runs only the first ``layers`` layers of the
    stack (whole cycles) over the FULL model's arguments — the dry-run's
    shallow traces, whose arguments, gossip round and gradient buffers
    are then the full model's."""
    specs = input_specs(cfg, shape, mesh, gcfg, engine=engine, dtype=dtype,
                        workers=workers)
    full_cfg = cfg
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    if shape.kind == "train":
        pack_spec = None
        if engine != "pytree":
            pack_spec = packed_spec_for(full_cfg, mesh,
                                        gcfg or GossipConfig(), dtype,
                                        workers)
            if w_local is not None:
                pack_spec = dataclasses.replace(pack_spec, n_workers=w_local)
        return make_train_step(cfg, pack_spec=pack_spec, algo=algo,
                               gcfg=gcfg,
                               pipelined=engine == "pipelined"), specs
    if shape.kind == "prefill":
        return make_prefill_step(cfg), specs
    return make_decode_step(cfg), specs
