"""The port's copy of the threaded GASPI simulator (core/async_sim.py)
against the reference's, bitwise: its NumPy numeric core, and whole runs
in deterministic round-robin replay — among them EXPERIMENTS.md §Churn's
seed-2 run (4 ranks x 60 rounds, k=6, d=8, m=16000, eps 0.1, batch 100),
which must reproduce its kill schedule ((3, 25, 41),) and its errors
0.1964 (stable) / 0.1972 (chaos) on w_first.

Those numbers were recorded when jax's threefry generator was not yet
"partitionable" by default; jax 0.5 changed that default, and with it the
values ``jax.random`` draws from a key.  The §Churn data is therefore drawn
in the legacy mode (``jax.threefry_partitionable(False)``), which
reproduces the recorded numbers with the reference too; the other runs
here use the default mode.
"""
import jax
import numpy as np
import pytest

from repro.core import async_sim as jsim
from repro.core import kmeans as jk
from repro.core.asgd import ASGDConfig as JConfig
from repro_torch.core import async_sim as tsim
from repro_torch.core.asgd import ASGDConfig as TConfig


def kmeans_data(legacy_random=False):
    with jax.threefry_partitionable(not legacy_random):
        x, _, _ = jk.synthetic_clusters(jax.random.key(0), k=6, d=8,
                                        m=16000)
        x = np.asarray(x, np.float64)
    return x, x[:6].copy()


@pytest.fixture(scope="module")
def churn_data():
    return kmeans_data()


def run_both(x, w0, seed, **kw):
    asgd = kw.pop("asgd", {"eps": 0.1, "batch": 100})
    ref = jsim.run_async_asgd(
        jsim.AsyncSimConfig(asgd=JConfig(**asgd), **kw), x, w0, seed=seed)
    out = tsim.run_async_asgd(
        tsim.AsyncSimConfig(asgd=TConfig(**asgd), **kw), x, w0, seed=seed)
    return out, ref


def assert_bitwise(out, ref):
    for key in ("w_first", "w_mean", "msgs_sent", "msgs_good",
                "msgs_dropped"):
        np.testing.assert_array_equal(out[key], ref[key])
    for key in ("error_first", "error_mean_aggregate", "err_trace",
                "kill_schedule"):
        assert out[key] == ref[key], key


def test_churn_seed2_reproduces_experiments_md():
    x, w0 = kmeans_data(legacy_random=True)
    base = dict(ranks=4, rounds=60, deterministic=True)
    stable, stable_ref = run_both(x, w0, 2, **base)
    chaos, chaos_ref = run_both(x, w0, 2, chaos_kills=1, chaos_seed=7,
                                **base)
    assert_bitwise(stable, stable_ref)
    assert_bitwise(chaos, chaos_ref)
    assert chaos["kill_schedule"] == ((3, 25, 41),)
    assert round(stable["error_first"], 4) == 0.1964
    assert round(chaos["error_first"], 4) == 0.1972
    assert (round(stable["error_mean_aggregate"], 4),
            round(chaos["error_mean_aggregate"], 4)) == (0.1958, 0.2015)
    assert (stable["msgs_sent"].sum(), chaos["msgs_sent"].sum(),
            chaos["msgs_dropped"].sum()) == (240, 211, 13)
    assert tsim.make_kill_schedule(4, 60, 1, 7) == ((3, 25, 41),)


@pytest.mark.parametrize("case", [
    dict(partial_fraction=0.5),
    dict(chaos_schedule=((2, 10, 30),), n_buffers=3),
    dict(asgd={"eps": 0.1, "batch": 100, "use_fused": True}),
    dict(asgd={"eps": 0.1, "batch": 100, "elastic": True}),
    dict(asgd={"eps": 0.1, "batch": 100, "silent": True}),
], ids=["partial", "explicit-schedule", "fused", "elastic", "silent"])
def test_deterministic_runs_are_bitwise_the_references(churn_data, case):
    x, w0 = churn_data
    out, ref = run_both(x, w0, 3, ranks=4, rounds=30, deterministic=True,
                        **case)
    assert_bitwise(out, ref)


def test_numpy_core_is_bitwise_the_references():
    rng = np.random.default_rng(0)
    for trial in range(5):
        w = rng.normal(size=(6, 4))
        dw = rng.normal(size=(6, 4)) * 0.1
        exts = [rng.normal(size=(6, 4)) for _ in range(3)] + \
            [np.zeros((6, 4))]
        for kw in ({}, {"use_fused": True}, {"use_parzen": False}):
            a = tsim._asgd_update_np(w, dw, exts, TConfig(eps=0.07, **kw))
            b = jsim._asgd_update_np(w, dw, exts, JConfig(eps=0.07, **kw))
            np.testing.assert_array_equal(a[0], b[0])
            assert a[1] == b[1]
        x = rng.normal(size=(40, 4))
        np.testing.assert_array_equal(
            tsim._kmeans_minibatch_delta_np(x, w),
            jsim._kmeans_minibatch_delta_np(x, w))
        assert tsim._kmeans_error_np(x, w) == jsim._kmeans_error_np(x, w)


def test_threaded_mode_runs_and_counts_messages(churn_data):
    """The racy threaded mode (no determinism claim): it finishes, sends
    one message per live rank-round, and descends."""
    x, w0 = churn_data
    out = tsim.run_async_asgd(
        tsim.AsyncSimConfig(ranks=4, rounds=30,
                            asgd=TConfig(eps=0.1, batch=100)), x, w0, seed=4)
    assert out["kill_schedule"] == ()
    assert out["msgs_sent"].sum() == 4 * 30
    assert out["error_first"] < jsim._kmeans_error_np(x, w0)
