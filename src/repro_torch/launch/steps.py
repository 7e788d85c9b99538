"""Train steps of the packed-resident engines.

The ``(W, R, LANE)`` packed ensemble is the carried state.  Each step
differentiates the summed worker losses w.r.t. the ensemble through
``unpack_w`` views, so ``.grad`` IS the packed local step — the torch form
of the reference's pipelined step — then runs one gossip round on packed
rows:

  packed     — asgd_gossip_apply_packed (exchange + blend of the FIFO head)
  pipelined  — initiate_exchange_packed before the forward/backward,
               consume_exchange_packed after it (blend of the payload
               launched delay+1 rounds ago)

Both engines take the packed gradient and keep the inner-optimizer state
packed (momentum/Adam are elementwise, so their values match the
reference's pytree state leaf for leaf, with zeros in the padding).  The
pytree engine and ``algo='sync'`` are not ported yet (ROADMAP.md queue A).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core.asgd import ASGDConfig
from ..core.gossip import (GossipConfig, _silent_round,
                           asgd_gossip_apply_packed, consume_exchange_packed,
                           initiate_exchange_packed)
from ..core.packing import unpack_w
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


def make_train_step(cfg: ModelConfig, *, pack_spec, algo="asgd",
                    inner="sgd", gcfg: GossipConfig | None = None,
                    acfg: ASGDConfig | None = None, pipelined=False,
                    lr_schedule=None):
    """Returns step(packed, gossip, opt_state, batch, shift_idx, block_idx)
    -> (packed, gossip, opt_state, metrics).

    packed: (W, R, LANE) f32 ensemble on pack_spec (group-contiguous for
    'leaves' mode); gossip: init_packed_gossip_state (or
    init_pipelined_gossip_state when pipelined); batch: {"tokens":
    (W, B, S)}; shift_idx, block_idx: this round's host-int draws
    (core.gossip.draw_gossip_indices).  algo: 'asgd' (paper) or 'silent'
    (SimuParallelSGD: local steps only).  inner: 'sgd' | 'momentum' |
    'adam'.  lr_schedule (pipelined only): step -> lr, the consume blend's
    per-round lr operand.
    """
    from ..optim import adam_update, momentum_update

    gcfg = gcfg or GossipConfig()
    acfg = acfg or ASGDConfig(eps=0.01)
    if algo == "sync":
        raise NotImplementedError(
            "algo='sync' (synchronous data-parallel baseline) is not ported "
            "yet — ROADMAP.md queue A, item 6")
    if algo not in ("asgd", "silent"):
        raise ValueError(f"unknown algo {algo!r}")
    if pipelined:
        if algo != "asgd":
            raise ValueError(
                f"pipelined=True requires algo='asgd' (got {algo!r}): the "
                "pipeline overlaps the gossip exchange — silent has no "
                "exchange to overlap")
        if gcfg.gossip_every > 1:
            raise ValueError(
                "pipelined=True requires gossip_every == 1 (use "
                "core.gossip.asgd_gossip_apply_pipelined for interval "
                "gossip)")
    if lr_schedule is not None and not pipelined:
        raise ValueError(
            "lr_schedule= is only wired into the pipelined engine")

    def direction(packed, pgrads, opt_state):
        """(dw, new_opt_state): w - eps*dw is the inner-optimizer step."""
        if inner == "sgd":
            return pgrads, opt_state
        update = momentum_update if inner == "momentum" else adam_update
        new_p, new_s = update(packed, pgrads, opt_state, acfg.eps)
        return (packed - new_p) / acfg.eps, new_s

    def step(packed, gossip, opt_state, batch, shift_idx, block_idx):
        lr = None if lr_schedule is None else lr_schedule(gossip.step)
        if pipelined and not acfg.silent:
            # INITIATE: this round's payload from the pre-blend ensemble
            sent, sent_scales, block_idx = initiate_exchange_packed(
                packed, shift_idx, block_idx, gcfg, pack_spec)
        loss, pgrads = packed_loss_and_grad(cfg, packed, batch, pack_spec)
        with torch.no_grad():
            dw, opt_state = direction(packed, pgrads, opt_state)
            metrics = {"loss": loss.mean()}
            if algo == "silent":
                return packed - acfg.eps * dw, gossip, opt_state, metrics
            if pipelined:
                if acfg.silent:
                    new_packed, new_gossip, gm = _silent_round(
                        packed, dw, gossip, acfg.eps if lr is None else lr)
                else:
                    # CONSUME: blend the payload launched delay+1 rounds
                    # ago, push this round's
                    new_packed, new_gossip, gm = consume_exchange_packed(
                        packed, dw, gossip, sent, sent_scales, block_idx,
                        gcfg, acfg, pack_spec, lr=lr)
            else:
                new_packed, new_gossip, gm = asgd_gossip_apply_packed(
                    packed, dw, gossip, shift_idx, block_idx, gcfg, acfg,
                    pack_spec)
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
