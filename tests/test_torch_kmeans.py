"""Every function of the port's core/kmeans.py against the reference's on
the same numpy inputs (the E/M steps through B4's plain version on the
CPU), and the K-Means examples at a small size on the CPU.

Tolerances: assignments exactly (random normal inputs hold no ties); the
eq.-8 error and the eq.-9/10 steps within rtol 1e-5, atol 1e-6 (f32 sums
in another order); ``synthetic_clusters`` draws from torch's generator,
not jax.random, so it is held to the reference's distribution only:
shapes, label range, centres in [-1, 1), per-cluster spread within
[0.5, 1.5) x spread.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jk
from repro_torch.core import kmeans as tk
from repro_torch.core.baselines import run_batch

TOL = {"rtol": 1e-5, "atol": 1e-6}


def data(seed, m=64, d=5, k=7, wn=None):
    rng = np.random.default_rng(seed)
    lead = () if wn is None else (wn,)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal(lead + (k, d)).astype(np.float32))


def both(fn, *arrays):
    """(port result as numpy, reference result as numpy)."""
    t = getattr(tk, fn)(*(torch.from_numpy(a) for a in arrays))
    j = getattr(jk, fn)(*(jnp.asarray(a) for a in arrays))
    return np.asarray(t), np.asarray(j)


@pytest.mark.parametrize("seed", [0, 1])
def test_assign_matches_reference_and_naive_distance(seed):
    x, w = data(seed)
    t, j = both("assign", x, w)
    np.testing.assert_array_equal(t, j)
    naive = np.argmin(((x[:, None] - w[None]) ** 2).sum(-1), axis=-1)
    np.testing.assert_array_equal(t, naive)


@pytest.mark.parametrize("fn", ["quantization_error", "minibatch_delta",
                                "batch_delta"])
def test_eq8_eq9_match_reference(fn):
    x, w = data(3, m=500, d=6, k=9)
    t, j = both(fn, x, w)
    np.testing.assert_allclose(t, j, **TOL)


def test_online_delta_matches_reference():
    x, w = data(4, m=1, d=4, k=3)
    t, j = both("online_delta", x[0], w)
    np.testing.assert_allclose(t, j, **TOL)
    assert int((np.abs(t).sum(-1) > 0).sum()) == 1       # one row (eq. 10)


def test_ground_truth_error_matches_reference():
    _, w = data(5, k=6)
    _, c = data(6, k=6)
    t, j = both("ground_truth_error", w, c)
    np.testing.assert_allclose(t, j, **TOL)


@pytest.mark.parametrize("shared", [False, True])
def test_worker_batched_forms_match_vmapped_reference(shared):
    """quantization_error_w / minibatch_delta_w on W prototype sets against
    the reference's functions under vmap."""
    wn = 4
    x, w = data(7, m=300, d=6, k=5, wn=wn)
    xs = x if shared else np.stack([x + i for i in range(wn)])
    in_ax = None if shared else 0
    err = tk.quantization_error_w(torch.from_numpy(xs), torch.from_numpy(w))
    err_j = jax.vmap(jk.quantization_error, in_axes=(in_ax, 0))(
        jnp.asarray(xs), jnp.asarray(w))
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), **TOL)
    if not shared:
        dw = tk.minibatch_delta_w(torch.from_numpy(xs), torch.from_numpy(w))
        dw_j = jax.vmap(jk.minibatch_delta)(jnp.asarray(xs), jnp.asarray(w))
        np.testing.assert_allclose(dw.numpy(), np.asarray(dw_j), **TOL)


def test_init_prototypes_from_the_references_draw():
    x = np.asarray(jk.synthetic_clusters(jax.random.key(0), 6, 4, 500)[0])
    key = jax.random.key(1)
    idx = np.asarray(jax.random.choice(key, 500, (6,), replace=False))
    t = tk.init_prototypes(torch.tensor(x), torch.tensor(idx))
    np.testing.assert_array_equal(
        t.numpy(), np.asarray(jk.init_prototypes(key, jnp.asarray(x), 6)))
    drawn = tk.choose_prototype_indices(torch.Generator().manual_seed(0),
                                        500, 6)
    assert len(set(drawn.tolist())) == 6 and int(drawn.max()) < 500


def cluster_stats(x, centers, labels, k):
    x, centers, labels = (np.asarray(a, np.float64)
                          for a in (x, centers, labels))
    labels = labels.astype(int)
    sig = np.array([(x[labels == c] - centers[c]).std() for c in range(k)])
    return sig, labels


@pytest.mark.parametrize("spread", [0.05, 0.15])
def test_synthetic_clusters_match_the_references_distribution(spread):
    k, d, m = 8, 6, 20000
    x, c, lab = tk.synthetic_clusters(torch.Generator().manual_seed(0), k, d,
                                      m, spread=spread)
    xj, cj, lj = jk.synthetic_clusters(jax.random.key(0), k, d, m,
                                       spread=spread)
    for xx, cc, ll in ((x.numpy(), c.numpy(), lab.numpy()),
                       (np.asarray(xj), np.asarray(cj), np.asarray(lj))):
        assert xx.shape == (m, d) and cc.shape == (k, d) and ll.shape == (m,)
        assert ll.dtype == np.int32 and 0 <= ll.min() and ll.max() < k
        assert np.all(np.abs(cc) <= 1.0) and np.isfinite(xx).all()
        sig, _ = cluster_stats(xx, cc, ll, k)
        assert np.all(sig > 0.45 * spread) and np.all(sig < 1.55 * spread)
        counts = np.bincount(ll, minlength=k)
        assert counts.min() > 0.8 * m / k and counts.max() < 1.2 * m / k


def test_gradient_step_descends_and_batch_converges_near_truth():
    g = torch.Generator().manual_seed(0)
    x, c, _ = tk.synthetic_clusters(g, 4, 2, 4000, spread=0.05)
    w = tk.init_prototypes(x, tk.choose_prototype_indices(g, 4000, 4))
    e0 = tk.quantization_error(x, w)
    assert tk.quantization_error(x, w - 0.5 * tk.batch_delta(x, w)) < e0
    w, errs = run_batch(x, w, eps=1.0, iters=60)
    assert errs[-1] < errs[0]
    # the reference's own test's bound; a seed whose init puts two
    # prototypes in one cluster would miss it in either package
    assert float(tk.ground_truth_error(w, c)) < 0.1


def test_examples_run_on_the_cpu(capsys):
    from repro_torch.examples import kmeans_scaling, quickstart
    out = quickstart.main(["--device", "cpu", "--m", "4000"])
    assert np.isfinite(out["asgd"]["error_first"])
    assert float(out["batch_errors"][-1]) < float(out["batch_errors"][0])
    rows = kmeans_scaling.main(["--device", "cpu", "--m", "8000"])
    assert [r[0] for r in rows] == [4, 8, 16, 32, 64]
    assert all(np.isfinite(r[3:]).all() for r in rows)
    assert "modeled (FDR-Infiniband cost model)" in capsys.readouterr().out
