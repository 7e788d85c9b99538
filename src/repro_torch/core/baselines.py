"""Reference optimizers the paper compares against, plus the round-based
multi-worker simulator.

Implemented baselines (paper §2):
  * BATCH            — alg. 1, MapReduce-style full-batch descent [Chu 2007]
  * SimuParallelSGD  — alg. 3, communication-free local SGD + final average
                       [Zinkevich 2010]
  * MiniBatchSGD     — alg. 4, single-stream mini-batch SGD [Sculley 2010]
  * ASGD             — alg. 5 (this paper), round-simulated here; the
                       thread-level GASPI-semantics version lives in
                       async_sim.py, the SPMD version in gossip.py.

The round simulator models one gossip round per mini-batch (the paper's
communication frequency 1/b), message delivery with a configurable staleness
``delay`` (in rounds), and one random recipient per sender (a random
permutation per round) — the paper's "send to random node != i".

Randomness: the reference draws its batches, routings and drops from
jax.random inside the simulation, which torch cannot replay.  Here every
draw is an explicit tensor argument — the round draws (:class:`RoundDraws`),
the shard permutation, the mini-batch indices — and thin ``draw_*``
functions draw them from a ``torch.Generator`` on the run's device, all at
once, so the simulation loop never waits on the host.

The reference ``vmap``s the gradient and the update over the workers inside
a ``lax.scan``; here every round's state is a (W, K, D) tensor and each
round is a handful of batched ops: one B4 launch for the W gradients, the
P=1 gated update for all W at once (B2 with ``use_fused``), one B4 launch
for the W errors.  Errors and message counts stay on the device until the
end.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from . import kmeans
from .asgd import ASGDConfig
from .gossip import _gossip_gate


# ---------------------------------------------------------------------------
# single-stream baselines (alg. 1 and alg. 4)
# ---------------------------------------------------------------------------

def run_batch(x, w0, eps, iters, error_fn=None):
    """Paper alg. 1: full-batch gradient descent.  Returns (w, errors
    (iters,))."""
    error_fn = error_fn or (lambda w: kmeans.quantization_error(x, w))
    w, errs = w0, []
    for _ in range(iters):
        w = w - eps * kmeans.batch_delta(x, w)
        errs.append(error_fn(w))
    return w, torch.stack(errs)


def draw_minibatch_indices(generator, iters, b, m):
    """(iters, b) sample indices in [0, m) for :func:`run_minibatch_sgd`."""
    return torch.randint(0, m, (iters, b), generator=generator,
                         device=generator.device)


def run_minibatch_sgd(x, w0, eps, batch_idx, error_fn=None):
    """Paper alg. 4: sequential mini-batch SGD over the drawn batches
    ``batch_idx`` (iters, b).  Returns (w, errors (iters,))."""
    error_fn = error_fn or (lambda w: kmeans.quantization_error(x, w))
    w, errs = w0, []
    for idx in batch_idx:
        w = w - eps * kmeans.minibatch_delta(x[idx], w)
        errs.append(error_fn(w))
    return w, torch.stack(errs)


# ---------------------------------------------------------------------------
# round-based multi-worker simulation (alg. 3 and alg. 5)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RoundSimConfig:
    """Configuration for the vectorized multi-worker round simulator.

    Attributes:
      workers: number of simulated ranks (paper: threads x nodes).
      rounds: mini-batch rounds per worker (paper T; touched samples = T*b).
      delay: message staleness in rounds (>=1; paper's asynchronous delivery
        means a receiver always sees a *past* sender state).
      drop_rate: probability a message is lost (paper §4.4 first race kind:
        fully-overwritten == dropped, "completely harmless").
      asgd: the ASGD numeric-core config (eps, b, parzen, silent, elastic).
    """

    workers: int = 16
    rounds: int = 200
    delay: int = 1
    drop_rate: float = 0.0
    asgd: ASGDConfig = dataclasses.field(default_factory=ASGDConfig)


@dataclasses.dataclass(frozen=True)
class RoundDraws:
    """The random draws of a simulation, per round r and worker i:
    batch_idx (rounds, W, b) rows of worker i's shard; perm (rounds, W) the
    sender whose stale state worker i receives; kept (rounds, W) bool, the
    message arrived (None: no drops)."""

    batch_idx: torch.Tensor
    perm: torch.Tensor
    kept: torch.Tensor | None = None


def draw_rounds(generator, cfg: RoundSimConfig, h: int) -> RoundDraws:
    """Every draw of ``cfg.rounds`` rounds over shards of ``h`` rows, on
    ``generator``'s device."""
    dev = generator.device
    rw = (cfg.rounds, cfg.workers)
    batch_idx = torch.randint(0, h, rw + (cfg.asgd.batch,),
                              generator=generator, device=dev)
    perm = torch.argsort(torch.rand(rw, generator=generator, device=dev),
                         dim=1)
    kept = None
    if cfg.drop_rate > 0.0:
        kept = torch.rand(rw, generator=generator,
                          device=dev) >= cfg.drop_rate
    return RoundDraws(batch_idx, perm, kept)


def draw_shard_permutation(generator, m):
    """A permutation of the m samples for :func:`shard_data`."""
    return torch.randperm(m, generator=generator, device=generator.device)


def shard_data(x, workers, perm):
    """Paper alg. 3/5 lines 1-2: random partition, H = floor(m/n) each.
    Returns (workers, H, d)."""
    h = x.shape[0] // workers
    return x[perm[: h * workers]].reshape(workers, h, -1)


def _asgd_update_w(w, dw, ext, acfg: ASGDConfig):
    """``asgd_update(w_i, dw_i, [ext_i], acfg)`` for all W workers at once:
    w, dw, ext (W, *state).  Returns (w_next, n_good (W,))."""
    wn = w.shape[0]
    if acfg.use_fused:
        from ..kernels.gossip_blend.ops import (_to_2d,
                                                gossip_blend_worker_batched)
        n = w[0].numel()
        w3, d3, e3 = (_to_2d(t.reshape(wn, -1).float(), 64)
                      for t in (w, dw, ext))
        out3, gates = gossip_blend_worker_batched(
            w3, d3, e3[:, None], acfg.eps, use_parzen=acfg.use_parzen,
            elastic=acfg.elastic, elastic_alpha=acfg.elastic_alpha)
        w_next = out3.reshape(wn, -1)[:, :n].reshape(w.shape).to(w.dtype)
        return w_next, gates.sum(dim=1)
    # the direct (unexpanded) form of asgd_update's blend_externals
    gate = _gossip_gate(w, dw, ext, acfg, single_sweep=False)
    g = gate.reshape((wn,) + (1,) * (w.ndim - 1))
    mean = (w + g * ext.to(w.dtype)) * (1.0 / (1.0 + g))
    attraction = w - mean
    if acfg.elastic:
        w_next = -acfg.elastic_alpha * attraction + (-acfg.eps * dw + w)
    else:
        w_next = -acfg.eps * (1.0 * attraction + dw) + w
    return w_next, gate


def simulate_rounds(shards, w0, cfg: RoundSimConfig, draws: RoundDraws,
                    grad_fn: Callable = kmeans.minibatch_delta_w,
                    error_fn: Callable | None = None):
    """Simulate ``cfg.workers`` ASGD ranks for ``cfg.rounds`` gossip rounds.

    Each round, for all workers i at once:
      1. take the drawn mini-batch of size cfg.asgd.batch from its shard
      2. dw_i = grad_fn(batch, w_i)                     (one B4 launch)
      3. externals = [state of perm(i) from `delay` rounds ago]  (unless
         silent), zeros where the message was dropped (an empty buffer
         closes the gate, eq. 3)
      4. w_i <- asgd_update(w_i, dw_i, externals, cfg.asgd)
      5. the new w_i is "sent": it enters the delivery pipeline

    shards (W, H, d); w0 (*state); grad_fn maps (W, b, d) batches and
    (W, *state) states to (W, *state) steps; error_fn maps (W, *state) to
    (W,) errors (default: eq. 8 on a fixed eval subsample, one B4 launch).

    Returns dict with:
      w:        (workers, *state) final per-worker states
      errors:   (rounds,) mean error across workers per round
      n_good:   (rounds,) mean admitted ("good") messages per worker-round
      w_first_error: error of worker 0's final state
      w_mean_error: error of the final averaged state (alg. 3 line 9)
    """
    wn, acfg = cfg.workers, cfg.asgd
    if error_fn is None:
        # fixed eval subsample: per-round error tracking must not dominate
        # the simulation cost (strided over the full set, copied once)
        flat = shards.reshape(-1, shards.shape[-1])
        eval_x = flat[::max(1, flat.shape[0] // 16384)].contiguous()
        error_fn = lambda w: kmeans.quantization_error_w(eval_x, w)  # noqa
    w = w0.expand((wn,) + tuple(w0.shape))
    # delivery pipeline: pipe[r % delay] holds the states sent `delay`
    # rounds ago at read time (replaced, never written in place)
    pipe = [w] * cfg.delay
    zeros = torch.zeros((wn,), dtype=torch.float32, device=w0.device)
    errs, goods = [], []
    for r in range(cfg.rounds):
        batches = torch.take_along_dim(
            shards, draws.batch_idx[r][..., None], dim=1)   # (W, b, d)
        dw = grad_fn(batches, w)
        if acfg.silent:
            w_next, n_good = -acfg.eps * dw + w, zeros
        else:
            incoming = pipe[r % cfg.delay][draws.perm[r]]
            if cfg.drop_rate > 0.0:
                kept = draws.kept[r].reshape((wn,) + (1,) * (w.ndim - 1))
                incoming = torch.where(kept, incoming,
                                       torch.zeros_like(incoming))
            w_next, n_good = _asgd_update_w(w, dw, incoming, acfg)
        pipe[r % cfg.delay] = w_next
        errs.append(torch.mean(error_fn(w_next)))
        goods.append(torch.mean(n_good))
        w = w_next
    return {
        "w": w,
        "errors": torch.stack(errs),
        "n_good": torch.stack(goods),
        "w_first_error": error_fn(w[:1])[0],
        "w_mean_error": error_fn(torch.mean(w, dim=0, keepdim=True))[0],
    }


def run_simuparallel_sgd(shards, w0, eps, b, rounds, draws: RoundDraws,
                         error_fn=None):
    """Paper alg. 3 via the round simulator with communication disabled.

    SimuParallelSGD's final aggregate (line 9) is the mean of worker states.
    """
    cfg = RoundSimConfig(
        workers=shards.shape[0], rounds=rounds, delay=1,
        asgd=ASGDConfig(eps=eps, batch=b, silent=True))
    return simulate_rounds(shards, w0, cfg, draws, error_fn=error_fn)
