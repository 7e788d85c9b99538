"""The port's fused K-Means E/M step (kernels/kmeans_assign: B4 through its
plain version on the CPU) against the reference's ``kmeans_assign`` — its
Pallas kernel, in interpret mode here — and its oracle
``kmeans_assign_ref``, on the same numpy inputs.

Tolerances: idx and counts exactly (random normal inputs hold no ties);
sums within rtol 1e-5, atol 1e-5 (f32 sums of up to 2048 samples of O(1)
values added in another order); bf16 inputs are cast to f32 by both
wrappers, so the same holds there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kmeans as jkmeans
from repro.kernels.kmeans_assign.ops import kmeans_assign as j_assign
from repro.kernels.kmeans_assign.ref import (
    kmeans_assign_ref as j_assign_ref,
    minibatch_delta_from_stats as j_from_stats)
from repro_torch.kernels.kmeans_assign import kmeans_assign, kmeans_assign_w
from repro_torch.kernels.kmeans_assign.ref import (
    kmeans_assign_ref, minibatch_delta_from_stats)
from _torch_threads import one_torch_thread  # noqa: F401

SUMS_TOL = {"rtol": 1e-5, "atol": 1e-5}
SHAPES = [(256, 8, 4), (512, 10, 10), (1000, 17, 7), (256, 128, 100),
          (300, 5, 3), (2048, 64, 256), (64, 3, 2),
          (512, 10, 50), (512, 10, 100)]          # Fig. 7's k at d = 10


def operands(seed, m, d, k, wn=None):
    rng = np.random.default_rng(seed)
    lead = () if wn is None else (wn,)
    x = rng.standard_normal(lead + (m, d)).astype(np.float32)
    w = rng.standard_normal(lead + (k, d)).astype(np.float32)
    return x, w


def assert_stats(port, ref):
    idx, sums, counts = port
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref[0]))
    np.testing.assert_allclose(sums.numpy(), np.asarray(ref[1]), **SUMS_TOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(ref[2]))


@pytest.mark.parametrize("m,d,k", SHAPES)
def test_shape_sweep_matches_reference_kernel_and_oracle(m, d, k):
    x, w = operands(m + d + k, m, d, k)
    port = kmeans_assign(torch.from_numpy(x), torch.from_numpy(w))
    assert port[0].dtype == torch.int32 and port[1].dtype == torch.float32
    assert port[2].dtype == torch.float32
    assert_stats(port, j_assign(jnp.asarray(x), jnp.asarray(w)))
    assert_stats(port, j_assign_ref(jnp.asarray(x), jnp.asarray(w)))
    assert_stats(kmeans_assign_ref(torch.from_numpy(x), torch.from_numpy(w)),
                 j_assign_ref(jnp.asarray(x), jnp.asarray(w)))


def test_bf16_inputs_are_cast_to_f32():
    x, w = operands(0, 512, 16, 8)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    port = kmeans_assign(
        torch.tensor(np.array(xb.astype(jnp.float32))).to(torch.bfloat16),
        torch.tensor(np.array(wb.astype(jnp.float32))).to(torch.bfloat16))
    assert_stats(port, j_assign(xb, wb))


def test_stats_give_paper_eq9():
    """The kernel's statistics -> eq. (9) equal the reference's
    ``core.kmeans.minibatch_delta`` (rtol 1e-5, atol 1e-6)."""
    x, w = operands(2, 640, 12, 6)
    _, sums, counts = kmeans_assign(torch.from_numpy(x), torch.from_numpy(w))
    dw = minibatch_delta_from_stats(torch.from_numpy(w), sums, counts, 640)
    np.testing.assert_allclose(
        dw.numpy(), np.asarray(jkmeans.minibatch_delta(jnp.asarray(x),
                                                       jnp.asarray(w))),
        rtol=1e-5, atol=1e-6)
    j_sums, j_counts = j_assign_ref(jnp.asarray(x), jnp.asarray(w))[1:]
    np.testing.assert_allclose(
        dw.numpy(), np.asarray(j_from_stats(jnp.asarray(w), j_sums, j_counts,
                                            640)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("shared", [False, True], ids=["per-worker",
                                                       "shared-x"])
def test_worker_axis_matches_a_loop_over_workers(shared):
    """(W, M, D) batches, and one (M, D) set read by every worker (stride
    0 on the card), against the unbatched function per worker: bitwise."""
    wn, m, d, k = 5, 300, 7, 6
    xs, ws = operands(3, m, d, k, wn)
    x = torch.from_numpy(xs[0] if shared else xs)
    w = torch.from_numpy(ws)
    idx, sums, counts = kmeans_assign_w(x, w)
    assert tuple(idx.shape) == (wn, m) and tuple(sums.shape) == (wn, k, d)
    assert tuple(counts.shape) == (wn, k)
    for i in range(wn):
        one = kmeans_assign(x if shared else x[i], w[i])
        torch.testing.assert_close(idx[i], one[0], rtol=0, atol=0)
        torch.testing.assert_close(counts[i], one[2], rtol=0, atol=0)
        torch.testing.assert_close(sums[i], one[1], rtol=1e-6, atol=1e-6)


def test_counts_sum_to_m_and_sums_to_total():
    for seed, k, d in ((0, 2, 3), (1, 40, 20), (2, 17, 9)):
        x, w = operands(seed, 384, d, k)
        _, sums, counts = kmeans_assign(torch.from_numpy(x),
                                        torch.from_numpy(w))
        assert float(counts.sum()) == 384
        np.testing.assert_allclose(sums.sum(0).numpy(), x.sum(0),
                                   rtol=1e-4, atol=1e-4)


def test_ties_go_to_the_first_prototype():
    """Two equal prototypes: every sample that picks either picks the
    first, as argmin does in both packages."""
    x, w = operands(4, 200, 4, 3)
    w[2] = w[0]
    idx = kmeans_assign(torch.from_numpy(x), torch.from_numpy(w))[0]
    assert not bool((idx == 2).any()) and bool((idx == 0).any())
    np.testing.assert_array_equal(
        idx.numpy(), np.asarray(j_assign_ref(jnp.asarray(x),
                                             jnp.asarray(w))[0]))


def test_cpu_wrapper_rejects_bad_operands():
    x, w = operands(5, 64, 4, 3)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match="w must be"):
        kmeans_assign_w(xt, wt)
    with pytest.raises(ValueError, match="x must be"):
        kmeans_assign_w(xt[:, :3], wt[None])
    with pytest.raises(ValueError, match="float32"):
        kmeans_assign_w(xt.double(), wt[None])
    with pytest.raises(ValueError, match="empty"):
        kmeans_assign_w(xt[:0], wt[None])
