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

``algo`` 'sync' (the synchronous data-parallel baseline) and 'silent'
(SimuParallelSGD) replace the gossip round on the pytree and packed
engines.  The packed engines keep the inner-optimizer state packed
(momentum/Adam are elementwise, so their values match the reference's
pytree state leaf for leaf, with zeros in the padding).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.asgd import ASGDConfig
from ..core.gossip import (GossipConfig, _silent_round, asgd_gossip_apply,
                           asgd_gossip_apply_packed, consume_exchange_packed,
                           initiate_exchange_packed, local_sgd_apply,
                           sync_dp_apply)
from ..core.packing import unpack_w
from ..core.tree import flatten_sorted, tree_map, unflatten
from ..models import model as M


def packed_loss_and_grad(cfg: ModelConfig, packed, batch, spec):
    """Per-worker losses (W,) and their gradient w.r.t. the packed
    ensemble, born packed: the W-batched forward reads ``unpack_w`` views
    of one leaf tensor, and one backward through the views' split fills
    the (W, R, LANE) gradient directly.  The workers' losses are
    independent, so the gradient of their sum is each worker's own."""
    leaf = packed.detach().requires_grad_(True)
    losses = M.loss_fn_w(cfg, unpack_w(leaf, spec), batch)
    losses.sum().backward()
    return losses.detach(), leaf.grad


def tree_loss_and_grad(cfg: ModelConfig, params, batch):
    """Per-worker losses (W,) and their gradient tree w.r.t. ``params``
    (a tree of (W, ...) leaves).  The workers' losses are independent, so
    the gradient of their sum is each worker's own."""
    leaves, treedef = flatten_sorted(params)
    xs = [x.detach().requires_grad_(True) for x in leaves]
    losses = M.loss_fn_w(cfg, unflatten(treedef, xs), batch)
    grads = torch.autograd.grad(losses.sum(), xs, allow_unused=True)
    return losses.detach(), unflatten(treedef, [
        torch.zeros_like(x) if g is None else g for x, g in zip(xs, grads)])


def make_train_step(cfg: ModelConfig, *, pack_spec=None, algo="asgd",
                    inner="sgd", gcfg: GossipConfig | None = None,
                    acfg: ASGDConfig | None = None, pipelined=False,
                    lr_schedule=None):
    """Returns step(params, gossip, opt_state, batch, shift_idx, block_idx,
    live=None) -> (params, gossip, opt_state, metrics).

    pack_spec None selects the pytree engine: params is a tree of (W, ...)
    leaves, gossip an init_gossip_state.  Otherwise params is the
    (W, R, LANE) f32 ensemble on pack_spec (group-contiguous for 'leaves'
    mode) and gossip an init_packed_gossip_state (init_pipelined_
    gossip_state when pipelined).  batch: {"tokens": (W, B, S)};
    shift_idx, block_idx: this round's host-int draws
    (core.gossip.draw_gossip_indices); live: optional (W,) f32 0/1
    per-peer liveness on an elastic gossip state (algo 'asgd' only).
    algo: 'asgd' (paper), 'silent' (SimuParallelSGD: local steps only) or
    'sync' (synchronous data-parallel SGD).  inner: 'sgd' | 'momentum' |
    'adam'.  lr_schedule (pipelined only): step -> lr, the consume blend's
    per-round lr operand.
    Raises NotImplementedError for an arch the port does not carry
    (models.blocks.check_supported); 'S' layers train through the SSD
    scan's backward (kernel B5b on the card), so a batch's seq must be a
    multiple of cfg.ssm_chunk (models.ssm.apply_ssd raises otherwise).
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
        loss, grads = tree_loss_and_grad(cfg, params, batch)
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
        loss, pgrads = packed_loss_and_grad(cfg, packed, batch, pack_spec)
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
