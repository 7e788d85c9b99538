"""Thread-level ASGD simulator with GASPI one-sided-communication semantics.

This is the *paper-faithful* execution model (DESIGN.md §2.1): R ranks run
completely unsynchronized in OS threads; each rank owns N receive buffers that
remote ranks write into with single-sided, unacknowledged writes, exactly like
GPI-2 RDMA segments:

  * a sender never waits — it memcpy's its state into a random recipient's
    buffer and continues (communication is "free");
  * delivery is uninformed — the recipient reads whatever is in the buffer
    whenever its own mini-batch happens to finish (unbounded staleness);
  * buffers are written WITHOUT locks, in segments, so a reader can observe a
    torn state (the paper's §4.4 second race kind: partially overwritten
    message) and two writers can interleave (fig. 2 scenario III);
  * an all-zero buffer means "no message" (paper eq. 3 lambda mask).

The numeric core (Parzen gate + blend) mirrors the SPMD path's
(repro_torch.core.asgd, whose ``ASGDConfig`` it takes) — only the transport
differs. NumPy is used on the data path because genuinely thread-interleaved
writes require mutable buffers.

This module is a copy of the reference's ``core/async_sim.py``, bitwise the
same simulator.  It is a host simulator by design, not a device path: its
ranks are host threads writing host buffers, so it runs on the CPU wherever
the rest of the port runs (no CUDA tensor ever enters it).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, List

import numpy as np

from .asgd import ASGDConfig


# ---------------------------------------------------------------------------
# NumPy mirrors of the numeric core (the tensor versions are awkward to
# call from dozens of threads; the reference's copies are verified
# equivalent to its jax core in tests/test_async_sim.py, and this copy to
# the reference's in tests/test_torch_async_sim.py)
# ---------------------------------------------------------------------------

def _parzen_gate_np(w_i, dw_i, w_j, eps):
    stepped = w_i - eps * dw_i
    return float(np.sum((stepped - w_j) ** 2) < np.sum((w_i - w_j) ** 2))


def _asgd_update_np(w_i, dw_i, externals, cfg: ASGDConfig):
    if cfg.use_fused and externals:
        return _asgd_update_np_fused(w_i, dw_i, externals, cfg)
    gates = []
    for w_j in externals:
        g = float(np.sum(w_j * w_j) > 0.0)
        if cfg.use_parzen and g > 0.0:
            g = _parzen_gate_np(w_i, dw_i, w_j, cfg.eps)
        gates.append(g)
    denom = 1.0 + sum(gates)
    acc = w_i.copy()
    for g, w_j in zip(gates, externals):
        if g > 0.0:
            acc += w_j
    attraction = w_i - acc / denom
    if cfg.elastic:
        return (w_i - cfg.eps * dw_i) - cfg.elastic_alpha * attraction, sum(gates)
    return w_i - cfg.eps * (attraction + dw_i), sum(gates)


def _asgd_update_np_fused(w_i, dw_i, externals, cfg: ASGDConfig):
    """Batched mirror of the fused gossip_blend kernel dataflow.

    One vectorized pass over the stacked (P, ...) externals computes all 3P
    reduction terms (expanded eq.-4 identity), a second applies the gated
    mean — the NumPy analogue of the kernel's 2-HBM-pass structure, vs the
    per-external Python loop above.  Verified equivalent to _asgd_update_np
    in tests/test_gossip_blend.py.
    """
    E = np.stack([np.asarray(w_j).reshape(-1) for w_j in externals])  # (P,n)
    w = w_i.reshape(-1)
    dw = dw_i.reshape(-1)
    # pass 1: all reduction terms at once
    dot = E @ (-dw) + np.dot(dw, w)          # <dw, w - ext_p>  (P,)
    sq_ext = np.einsum("pn,pn->p", E, E)
    nonempty = sq_ext > 0.0
    if cfg.use_parzen:
        sq_dw = np.dot(dw, dw)
        gates = ((2.0 * cfg.eps * dot - cfg.eps ** 2 * sq_dw) > 0.0) & nonempty
    else:
        gates = nonempty
    g = gates.astype(w.dtype)
    # pass 2: gated mean + step
    denom = 1.0 + g.sum()
    mean = (w + g @ E) / denom
    attraction = (w - mean).reshape(w_i.shape)
    if cfg.elastic:
        w_next = (w_i - cfg.eps * dw_i) - cfg.elastic_alpha * attraction
    else:
        w_next = w_i - cfg.eps * (attraction + dw_i)
    return w_next, float(g.sum())


def _kmeans_minibatch_delta_np(batch, w):
    d2 = (-2.0 * batch @ w.T) + np.sum(w * w, axis=1)[None, :]
    s = np.argmin(d2, axis=1)
    k = w.shape[0]
    dw = np.zeros_like(w)
    np.add.at(dw, s, w[s] - batch)
    return dw / batch.shape[0]


def _kmeans_error_np(x, w):
    d2 = (-2.0 * x @ w.T) + np.sum(w * w, axis=1)[None, :]
    s = np.argmin(d2, axis=1)
    return float(0.5 * np.mean(np.sum((x - w[s]) ** 2, axis=1)))


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class AsyncSimConfig:
    """Thread-simulator parameters (paper §4 'Parameters' + §5.2 setup).

    ranks: simulated processes (paper: nodes x threads).
    rounds: mini-batch iterations per rank (paper T).
    n_buffers: receive buffers per rank (paper eq. 3 N).
    fanout: random recipients per send (paper: 'a few').
    segments: chunks per single-sided write — >1 enables torn reads
      (set to 1 for race-free writes; races are the paper's default).
    partial_fraction: fraction of the state sent per message (paper §4.4
      partial updates for induced sparsity; 1.0 = full state; K-Means
      partitions along cluster centers, i.e. rows of w).
    straggler_ms: per-round sleep for straggler ranks (real clusters: NUMA,
      network, OS jitter — the paper's 1024-CPU setting). 0 disables.
    straggler_frac: fraction of ranks that are stragglers.

    Chaos / elasticity (DESIGN.md §8 — the thread-world proof layer of
    the SPMD liveness gates):
    chaos_kills: ranks to kill-and-revive mid-run (0 disables). A dead
      rank freezes (no compute, no reads, no sends); writes addressed to
      it are dropped on the floor (a GASPI write to a crashed node); on
      revival it clears its receive buffers first, so it re-enters
      through the eq.-3 zero mask — the analogue of the SPMD join window.
    chaos_seed: seed of the kill schedule ONLY (decoupled from the data/
      transport seed so the same trajectory can be replayed under a
      different churn pattern and vice versa).
    chaos_schedule: explicit ((rank, kill_round, revive_round), ...)
      triples; overrides chaos_kills when non-empty.
    deterministic: run the ranks single-threaded in round-robin order
      (rank 0..R-1 within each round) instead of free-running threads —
      every rng stream and buffer interleaving is then a pure function of
      (seed, chaos schedule), so trajectories replay BITWISE. Used by the
      chaos regression tests; the racy threaded mode stays the default.
    """

    ranks: int = 8
    rounds: int = 200
    n_buffers: int = 2
    fanout: int = 1
    segments: int = 4
    partial_fraction: float = 1.0
    straggler_ms: float = 0.0
    straggler_frac: float = 0.25
    chaos_kills: int = 0
    chaos_seed: int = 0
    chaos_schedule: tuple = ()
    deterministic: bool = False
    asgd: ASGDConfig = dataclasses.field(default_factory=ASGDConfig)


def make_kill_schedule(ranks: int, rounds: int, kills: int,
                       chaos_seed: int = 0) -> tuple:
    """Seeded ((rank, kill_round, revive_round), ...) churn schedule.

    Victims are distinct ranks (at most ranks-1, so somebody survives);
    kills land in [rounds//4, rounds//2], outages last [rounds//8,
    rounds//3] and every victim revives before the run ends — the
    schedule exercises death AND the rejoin window, not just death.
    Deterministic in (ranks, rounds, kills, chaos_seed)."""
    rng = np.random.default_rng(chaos_seed)
    n = min(kills, max(ranks - 1, 0))
    victims = rng.choice(ranks, size=n, replace=False)
    out = []
    for r in victims:
        k = int(rng.integers(max(1, rounds // 4), rounds // 2 + 1))
        down = int(rng.integers(max(1, rounds // 8), rounds // 3 + 1))
        out.append((int(r), k, min(k + down, rounds - 1)))
    return tuple(out)


class AsyncASGD:
    """Runs paper alg. 5 with real threads and racy single-sided buffers."""

    def __init__(self, cfg: AsyncSimConfig, shards: np.ndarray, w0: np.ndarray,
                 grad_fn: Callable = _kmeans_minibatch_delta_np,
                 error_fn: Callable | None = None, seed: int = 0):
        self.cfg = cfg
        self.shards = shards  # (ranks, H, d_features)
        self.w_shape = w0.shape
        self.grad_fn = grad_fn
        self.error_fn = error_fn or (
            lambda w: _kmeans_error_np(shards.reshape(-1, shards.shape[-1]), w))
        self.seed = seed
        R = cfg.ranks
        # local states (float64 for determinism of the math itself)
        self.w = [w0.astype(np.float64).copy() for _ in range(R)]
        # single-sided receive buffers: buffers[r][n] is written by remote
        # ranks WITHOUT synchronization. zero == empty (lambda mask).
        self.buffers = [
            [np.zeros_like(w0, dtype=np.float64) for _ in range(cfg.n_buffers)]
            for _ in range(R)]
        self.msgs_sent = np.zeros(R, dtype=np.int64)
        self.msgs_good = np.zeros(R, dtype=np.int64)
        self.msgs_dropped = np.zeros(R, dtype=np.int64)
        self.err_trace: List[List[float]] = [[] for _ in range(R)]
        # churn plan (DESIGN.md §8): explicit schedule wins; else seeded
        self.kill_schedule = tuple(cfg.chaos_schedule) or (
            make_kill_schedule(R, cfg.rounds, cfg.chaos_kills,
                               cfg.chaos_seed)
            if cfg.chaos_kills > 0 else ())
        self._kill_revive = {r: (k, v) for r, k, v in self.kill_schedule}
        # shared liveness view senders consult (racy in thread mode — a
        # write can still race a crash, exactly like a real RDMA fabric)
        self.alive = np.ones(R, dtype=bool)

    # -- single-sided transport ------------------------------------------------
    def _send(self, state: np.ndarray, dst: int, slot: int, rng) -> None:
        """Uninformed one-sided write into the recipient's buffer.

        Written in `segments` chunks with thread yields in between so that
        concurrent writes to the same slot can interleave (fig. 2, III) and a
        concurrent read can observe a torn message (§4.4 race kind 2).
        """
        buf = self.buffers[dst][slot]
        flat_src = state.reshape(-1)
        flat_dst = buf.reshape(-1)
        n = flat_src.shape[0]
        seg = max(1, n // self.cfg.segments)
        if self.cfg.partial_fraction < 1.0:
            # paper §4.4: partial updates along the state partition (rows of
            # w for K-Means). Send a contiguous random row-block; untouched
            # rows keep whatever was in the buffer.
            rows = state.shape[0]
            nsend = max(1, int(rows * self.cfg.partial_fraction))
            start = int(rng.integers(0, rows - nsend + 1))
            buf[start:start + nsend] = state[start:start + nsend]
            return
        for off in range(0, n, seg):
            flat_dst[off:off + seg] = flat_src[off:off + seg]
            time.sleep(0)  # yield: let another writer interleave

    # -- per-rank main loop ------------------------------------------------------
    def _rank_round(self, r: int, t: int, rng, is_straggler: bool) -> None:
        """One mini-batch round of rank r — the exact body the threaded
        loop always ran, factored out so the deterministic round-robin
        replay (cfg.deterministic) drives the identical code and rng call
        sequence."""
        cfg = self.cfg
        kv = self._kill_revive.get(r)
        if kv is not None:
            k, v = kv
            if k <= t < v:
                # dead: frozen w, no compute, no reads, no sends. The rng
                # stream pauses with the rank (the schedule is part of the
                # determinism key, so replays still match bitwise).
                self.alive[r] = False
                return
            if t == v and not self.alive[r]:
                # revival: pre-death mail is a whole outage stale — drop
                # it and re-enter through the eq.-3 zero mask, the
                # thread-world analogue of the SPMD join window
                for b in self.buffers[r]:
                    b[:] = 0.0
                self.alive[r] = True
        if is_straggler:
            time.sleep(cfg.straggler_ms / 1000.0)
        shard = self.shards[r]
        H = shard.shape[0]
        idx = rng.integers(0, H, size=cfg.asgd.batch)
        dw = self.grad_fn(shard[idx], self.w[r])
        # read receive buffers (racy read: snapshot copies, may be torn)
        externals = [] if cfg.asgd.silent else [
            b.copy() for b in self.buffers[r]]
        w_next, n_good = _asgd_update_np(self.w[r], dw, externals, cfg.asgd)
        self.w[r] = w_next
        self.msgs_good[r] += int(n_good)
        # consume: clear own buffers (GASPI notify-reset analogue)
        if not cfg.asgd.silent:
            for b in self.buffers[r]:
                b[:] = 0.0
            # send to `fanout` random other ranks, random slots, no waiting
            for _ in range(cfg.fanout):
                dst = int(rng.integers(0, cfg.ranks - 1))
                dst = dst if dst < r else dst + 1  # != r
                slot = int(rng.integers(0, cfg.n_buffers))
                if not self.alive[dst]:
                    # one-sided write to a crashed node: lost, unnoticed
                    self.msgs_dropped[r] += 1
                    continue
                self._send(w_next, dst, slot, rng)
                self.msgs_sent[r] += 1
        if t % 10 == 0:
            self.err_trace[r].append(self.error_fn(self.w[r]))

    def _is_straggler(self, r: int) -> bool:
        cfg = self.cfg
        return cfg.straggler_ms > 0 and r < cfg.straggler_frac * cfg.ranks

    def _run_rank(self, r: int) -> None:
        rng = np.random.default_rng(self.seed * 7919 + r)
        strag = self._is_straggler(r)
        for t in range(self.cfg.rounds):
            self._rank_round(r, t, rng, strag)

    def run(self) -> dict:
        t0 = time.perf_counter()
        if self.cfg.deterministic:
            # round-robin replay: same per-rank rng streams, fixed global
            # interleaving — the whole trajectory is a pure function of
            # (seed, kill_schedule) and replays bitwise
            R = self.cfg.ranks
            rngs = [np.random.default_rng(self.seed * 7919 + r)
                    for r in range(R)]
            strag = [self._is_straggler(r) for r in range(R)]
            for t in range(self.cfg.rounds):
                for r in range(R):
                    self._rank_round(r, t, rngs[r], strag[r])
        else:
            threads = [threading.Thread(target=self._run_rank, args=(r,))
                       for r in range(self.cfg.ranks)]
            for th in threads:
                th.start()
            for th in threads:
                th.join()
        wall = time.perf_counter() - t0
        w_first = self.w[0]
        w_mean = np.mean(np.stack(self.w), axis=0)
        return {
            "w_first": w_first,
            "w_mean": w_mean,
            "error_first": self.error_fn(w_first),
            "error_mean_aggregate": self.error_fn(w_mean),
            "msgs_sent": self.msgs_sent.copy(),
            "msgs_good": self.msgs_good.copy(),
            "msgs_dropped": self.msgs_dropped.copy(),
            "err_trace": [list(t) for t in self.err_trace],
            "kill_schedule": self.kill_schedule,
            "wall_seconds": wall,
        }


def run_async_asgd(cfg: AsyncSimConfig, x: np.ndarray, w0: np.ndarray,
                   seed: int = 0, **kw) -> dict:
    """Convenience wrapper: shard `x` evenly and run the thread simulator."""
    R = cfg.ranks
    m = x.shape[0]
    h = m // R
    rng = np.random.default_rng(seed)
    perm = rng.permutation(m)
    shards = x[perm[: h * R]].reshape(R, h, x.shape[-1])
    sim = AsyncASGD(cfg, shards, w0, seed=seed, **kw)
    return sim.run()
