"""The port's core/baselines.py — BATCH, mini-batch SGD, the shard split and
the round simulator (ASGD, silent, drops, use_fused) — against the
reference's, with every random draw replayed from the reference's keys and
passed in as tensors, on the same numpy data.  The E/M steps run B4's plain
version on the CPU, the fused blend B2's.

Tolerances: per-round errors within rel 1e-5 and final states within atol
1e-5 (f32 sums in another order, compounded over the rounds); admitted
messages ``n_good`` equal in every round.  The gates are hard thresholds:
``n_good`` equal says that no gate of these runs sat close enough to its
threshold to flip under the other summation order (the ROADMAP rule).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jb
from repro.core import kmeans as jk
from repro.core.asgd import ASGDConfig as JConfig
from repro_torch.core import baselines as tb
from repro_torch.core.asgd import ASGDConfig as TConfig

W, ROUNDS, B, EPS = 8, 40, 64, 0.1
ERR_RTOL, STATE_ATOL = 1e-5, 1e-5


@pytest.fixture(scope="module")
def setup():
    """The reference's round-simulator test data: k=8, d=6, m=32000."""
    x, _, _ = jk.synthetic_clusters(jax.random.key(2), k=8, d=6, m=32000)
    w0 = jk.init_prototypes(jax.random.key(3), x, 8)
    shards = jb.shard_data(jax.random.key(4), x, W)
    return x, w0, shards


def t(a):
    return torch.tensor(np.asarray(a))


def replay_rounds(key, rounds, wn, b, h, drop_rate):
    """The reference's per-round draws (baselines.py:137-151) as
    RoundDraws."""
    keys = jax.random.split(key, rounds)

    def one(key_r):
        k_batch, k_perm, k_drop = jax.random.split(key_r, 3)
        return (jax.random.randint(k_batch, (wn, b), 0, h),
                jax.random.permutation(k_perm, wn),
                jax.random.uniform(k_drop, (wn,)) >= drop_rate)

    idx, perm, kept = jax.vmap(one)(keys)
    return tb.RoundDraws(t(idx).long(), t(perm).long(),
                         t(kept) if drop_rate > 0 else None)


def configs(use_fused, drop_rate, silent=False, delay=1):
    kw = dict(eps=EPS, batch=B, use_fused=use_fused, silent=silent)
    return (jb.RoundSimConfig(workers=W, rounds=ROUNDS, delay=delay,
                              drop_rate=drop_rate, asgd=JConfig(**kw)),
            tb.RoundSimConfig(workers=W, rounds=ROUNDS, delay=delay,
                              drop_rate=drop_rate, asgd=TConfig(**kw)))


def assert_runs_match(out, ref):
    np.testing.assert_array_equal(out["n_good"].numpy(),
                                  np.asarray(ref["n_good"]))
    np.testing.assert_allclose(out["errors"].numpy(),
                               np.asarray(ref["errors"]), rtol=ERR_RTOL,
                               atol=0)
    np.testing.assert_allclose(out["w"].numpy(), np.asarray(ref["w"]),
                               rtol=0, atol=STATE_ATOL)
    for name in ("w_first_error", "w_mean_error"):
        np.testing.assert_allclose(float(out[name]), float(ref[name]),
                                   rtol=ERR_RTOL)


def test_shard_data_from_the_references_permutation(setup):
    x, _, shards = setup
    perm = jax.random.permutation(jax.random.key(4), x.shape[0])
    np.testing.assert_array_equal(
        tb.shard_data(t(x), W, t(perm).long()).numpy(), np.asarray(shards))


@pytest.mark.parametrize("use_fused,drop_rate,delay", [
    (False, 0.0, 1), (True, 0.0, 1), (False, 0.5, 1), (True, 0.5, 2)])
def test_simulate_rounds_matches_reference(setup, use_fused, drop_rate,
                                           delay):
    _, w0, shards = setup
    jcfg, tcfg = configs(use_fused, drop_rate, delay=delay)
    key = jax.random.key(5)
    ref = jb.simulate_rounds(key, shards, w0, jcfg)
    draws = replay_rounds(key, ROUNDS, W, B, shards.shape[1], drop_rate)
    out = tb.simulate_rounds(t(shards), t(w0), tcfg, draws)
    assert float(out["n_good"].sum()) > 0        # the blend is exercised
    assert_runs_match(out, ref)
    assert float(out["errors"][-1]) < float(out["errors"][0])


def test_silent_and_simuparallel_match_reference(setup):
    _, w0, shards = setup
    key = jax.random.key(6)
    draws = replay_rounds(key, ROUNDS, W, B, shards.shape[1], 0.0)
    ref = jb.run_simuparallel_sgd(key, shards, w0, EPS, B, ROUNDS)
    out = tb.run_simuparallel_sgd(t(shards), t(w0), EPS, B, ROUNDS, draws)
    assert float(out["n_good"].abs().sum()) == 0
    assert_runs_match(out, ref)


def test_run_batch_matches_reference(setup):
    x, w0, _ = setup
    w_j, e_j = jb.run_batch(x, w0, eps=1.0, iters=10)
    w_t, e_t = tb.run_batch(t(x), t(w0), eps=1.0, iters=10)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=ERR_RTOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=STATE_ATOL)


def test_run_minibatch_sgd_matches_reference(setup):
    x, w0, _ = setup
    key, iters = jax.random.key(7), 50
    idx = jax.vmap(lambda k: jax.random.randint(k, (B,), 0, x.shape[0]))(
        jax.random.split(key, iters))
    w_j, e_j = jb.run_minibatch_sgd(key, x, w0, eps=0.1, b=B, iters=iters)
    w_t, e_t = tb.run_minibatch_sgd(t(x), t(w0), 0.1, t(idx).long())
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=ERR_RTOL)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), rtol=0,
                               atol=STATE_ATOL)
    assert float(e_t[-1]) < float(e_t[0])


def test_draws_have_the_references_shapes_and_ranges():
    cfg = dataclasses.replace(configs(False, 0.25)[1], rounds=7)
    d = tb.draw_rounds(torch.Generator().manual_seed(0), cfg, 100)
    assert tuple(d.batch_idx.shape) == (7, W, B)
    assert int(d.batch_idx.min()) >= 0 and int(d.batch_idx.max()) < 100
    assert all(sorted(p.tolist()) == list(range(W)) for p in d.perm)
    assert d.kept.dtype == torch.bool and tuple(d.kept.shape) == (7, W)
    assert tb.draw_rounds(torch.Generator(), configs(False, 0.0)[1],
                          10).kept is None
