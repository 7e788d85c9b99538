"""The port's worker-batched (B2) and single-worker (B3) gossip blend
against the reference's Pallas kernels (interpret mode on the CPU) and
its jnp oracles, at small shapes (W=3, R=16 rows of 512 lanes).

On the CPU the wrappers run their plain-torch versions, so these tests
hold the plain versions — the functions the CUDA kernels are checked
against on the card — to the TPU kernels.  Tolerances: the (..., P, 3)
sums within rtol 1e-5 (the packages add in different orders); the inputs
put every gate far from its threshold (asserted), so gates are compared
exactly; states within atol 1e-6 (f32 rounding of O(1) values).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.packing import pack_group_mask as jpack_group_mask
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.kernels.gossip_blend import ops as jops
from repro.kernels.gossip_blend import ref as jref
from repro.kernels.gossip_blend.kernel import (gossip_apply_pallas,
                                               gossip_apply_w_pallas,
                                               gossip_reduce_pallas,
                                               gossip_reduce_w_pallas)
from repro_torch import kernels as K
from repro_torch.core.gossip import leaf_groups
from repro_torch.core.packing import pack_group_mask, pack_spec_w
from repro_torch.kernels.gossip_blend import ops as tops
from repro_torch.kernels.gossip_blend import ref as tref
from repro_torch.kernels.gossip_blend.kernel import (gossip_apply,
                                                     gossip_apply_w,
                                                     gossip_reduce,
                                                     gossip_reduce_w)

W, R, LANE, BR = 3, 16, 512, 8
EPS, ALPHA = 0.05, 0.3


def make_operands(p, seed, wn=W, rows=R):
    """w, dw, ext (W, P, R, LANE) with each (worker, external) pair ahead
    of the local step or behind it, alternating, and a partition mask
    over a contiguous span of the flat layout (a leaf segment)."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((wn, rows, LANE)).astype(np.float32)
    dw = (0.1 * rng.standard_normal((wn, rows, LANE))).astype(np.float32)
    side = np.where(np.arange(wn * p) % 2 == 0, 0.5, -0.5)
    ext = (w[:, None] - side.reshape(wn, p, 1, 1) * dw[:, None]
           + 0.01 * rng.standard_normal((wn, p, rows, LANE))
           ).astype(np.float32)
    mask = np.zeros(rows * LANE, np.float32)
    mask[700:rows * LANE - 900] = 1.0
    return w, dw, ext, mask.reshape(rows, LANE)


def far_from_threshold(acc):
    acc = np.asarray(acc)
    margin = np.abs(2 * EPS * acc[..., 0] - EPS * EPS * acc[..., 2])
    return bool((margin > 1e-3 * (np.abs(2 * EPS * acc[..., 0])
                                  + EPS * EPS * acc[..., 2])).all())


def t(x):
    return None if x is None else torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("p", [1, 3])
def test_b2_plain_matches_pallas(p, masked, elastic):
    w, dw, ext, mask = make_operands(p, seed=p)
    m = mask if masked else None
    acc_j = gossip_reduce_w_pallas(jnp.asarray(w), jnp.asarray(dw),
                                   jnp.asarray(ext),
                                   None if m is None else jnp.asarray(m),
                                   block_rows=BR, interpret=True)
    acc_t = gossip_reduce_w(t(w), t(dw), t(ext), t(m))
    assert acc_t.shape == (W, p, 3)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5,
                               atol=0)
    assert far_from_threshold(acc_j)
    g_j = jops.gossip_gates(acc_j, EPS)
    np.testing.assert_array_equal(tops.gossip_gates(acc_t, EPS).numpy(),
                                  np.asarray(g_j))
    assert 0 < float(jnp.sum(g_j)) < W * p       # the gates mix
    inv = 1.0 / (jnp.sum(g_j, axis=1) + 1.0)
    out_j = gossip_apply_w_pallas(
        jnp.asarray(w), jnp.asarray(dw), jnp.asarray(ext), g_j, inv,
        None if m is None else jnp.asarray(m), eps=EPS, elastic=elastic,
        elastic_alpha=ALPHA, block_rows=BR, interpret=True)
    out_t = gossip_apply_w(t(w), t(dw), t(ext), t(g_j), t(inv), t(m),
                           eps=EPS, elastic=elastic, elastic_alpha=ALPHA)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)
    if masked:      # off the partition: exactly the plain step
        off = mask == 0
        np.testing.assert_array_equal(out_t.numpy()[:, off],
                                      (t(w) - EPS * t(dw)).numpy()[:, off])


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("p", [1, 3])
def test_b3_plain_matches_pallas(p, elastic):
    w, dw, ext, _ = make_operands(p, seed=10 + p, wn=1)
    w, dw, ext = w[0], dw[0], ext[0]
    acc_j = gossip_reduce_pallas(jnp.asarray(w), jnp.asarray(dw),
                                 jnp.asarray(ext), block_rows=BR,
                                 interpret=True)
    acc_t = gossip_reduce(t(w), t(dw), t(ext))
    assert acc_t.shape == (p, 3)
    np.testing.assert_allclose(acc_t.numpy(), np.asarray(acc_j), rtol=1e-5,
                               atol=0)
    assert far_from_threshold(acc_j)
    g_j = jops.gossip_gates(acc_j, EPS)
    np.testing.assert_array_equal(tops.gossip_gates(acc_t, EPS).numpy(),
                                  np.asarray(g_j))
    inv = 1.0 / (jnp.sum(g_j) + 1.0)
    out_j = gossip_apply_pallas(jnp.asarray(w), jnp.asarray(dw),
                                jnp.asarray(ext), g_j, inv, eps=EPS,
                                elastic=elastic, elastic_alpha=ALPHA,
                                block_rows=BR, interpret=True)
    out_t = gossip_apply(t(w), t(dw), t(ext), t(g_j), float(inv), eps=EPS,
                         elastic=elastic, elastic_alpha=ALPHA)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("use_parzen", [True, False])
@pytest.mark.parametrize("masked", [False, True])
def test_gossip_blend_w_matches_reference(masked, use_parzen):
    """ops.gossip_blend_w on flat (W, N) states, N = 1300 (not a multiple
    of 512: the padding), against the reference wrapper and its oracles;
    the port's oracles against the reference's."""
    n, p = 1300, 2
    rng = np.random.default_rng(5)
    w = rng.standard_normal((W, n)).astype(np.float32)
    dw = (0.1 * rng.standard_normal((W, n))).astype(np.float32)
    coef = np.array([[0.5, -0.5], [-0.5, 0.5], [0.5, 0.5]], np.float32)
    exts = (w[:, None] - coef[:, :, None] * dw[:, None]).astype(np.float32)
    exts[2, 1] = 0.0                         # an empty buffer (eq. 3)
    mask = (np.arange(n) % 7 < 4).astype(np.float32) if masked else None
    kw = dict(use_parzen=use_parzen, elastic=False)
    jm = None if mask is None else jnp.asarray(mask)
    out_j, g_j = jops.gossip_blend_w(jnp.asarray(w), jnp.asarray(exts),
                                     jnp.asarray(dw), EPS, mask=jm,
                                     block_rows=BR, interpret=True, **kw)
    out_t, g_t = tops.gossip_blend_w(t(w), t(exts), t(dw), EPS, mask=t(mask),
                                     block_rows=BR, **kw)
    assert out_t.shape == (W, n)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)
    for jfn, tfn in ((jref.gossip_blend_w_ref, tref.gossip_blend_w_ref),
                     (jref.gossip_blend_w_batched,
                      tref.gossip_blend_w_batched)):
        o_j, gg_j = jfn(jnp.asarray(w), jnp.asarray(exts), jnp.asarray(dw),
                        EPS, mask=jm, **kw)
        o_t, gg_t = tfn(t(w), t(exts), t(dw), EPS, mask=t(mask), **kw)
        np.testing.assert_array_equal(gg_t.numpy(), np.asarray(gg_j))
        np.testing.assert_array_equal(gg_t.numpy(), g_t.numpy())
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0,
                                   atol=1e-6)


@pytest.mark.parametrize("elastic", [False, True])
def test_gossip_blend_matches_reference(elastic):
    """ops.gossip_blend (B3 on a flat (N,) state, N = 2000) and the port's
    single-state oracles, against the reference's."""
    n = 2000
    rng = np.random.default_rng(6)
    w = rng.standard_normal(n).astype(np.float32)
    dw = (0.1 * rng.standard_normal(n)).astype(np.float32)
    exts = np.stack([w - c * dw for c in (0.5, -0.5, 1.5)]).astype(
        np.float32)
    kw = dict(elastic=elastic, elastic_alpha=ALPHA)
    out_j, g_j = jops.gossip_blend(jnp.asarray(w), jnp.asarray(exts),
                                   jnp.asarray(dw), EPS, block_rows=BR,
                                   interpret=True, **kw)
    out_t, g_t = tops.gossip_blend(t(w), t(exts), t(dw), EPS, block_rows=BR,
                                   **kw)
    np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))
    assert g_t.tolist() == [1.0, 0.0, 1.0]
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j), rtol=0,
                               atol=1e-6)
    for jfn, tfn in ((jref.gossip_blend_ref, tref.gossip_blend_ref),
                     (jref.gossip_blend_batched, tref.gossip_blend_batched)):
        o_j, gg_j = jfn(jnp.asarray(w), jnp.asarray(exts), jnp.asarray(dw),
                        EPS, **kw)
        o_t, gg_t = tfn(t(w), t(exts), t(dw), EPS, **kw)
        np.testing.assert_array_equal(gg_t.numpy(), np.asarray(gg_j))
        np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0,
                                   atol=1e-6)


def _tree(wn):
    rng = np.random.default_rng(7)
    return {"a": rng.standard_normal((wn, 6, 40)).astype(np.float32),
            "b": {"c": rng.standard_normal((wn, 5)).astype(np.float32),
                  "d": rng.standard_normal((wn, 3, 4, 70)).astype(
                      np.float32)},
            "e": rng.standard_normal((wn, 9, 33)).astype(np.float32)}


@pytest.mark.parametrize("grouped", [False, True])
def test_pack_group_mask_bitwise(grouped):
    """Both branches: the leaf-segment mask of a plain spec (the fused
    pytree blend's) and the row-range mask of a group-contiguous spec."""
    tree = _tree(2)
    jt = jax.tree.map(jnp.asarray, tree)
    tt = jax.tree.map(torch.from_numpy, tree)
    p = 3
    groups = leaf_groups(tt, p)
    kw = {"groups": groups, "n_groups": p} if grouped else {}
    jspec = jpack_spec_w(jt, block_rows=BR, **kw)
    tspec = pack_spec_w(tt, block_rows=BR, **kw)
    for b in range(p):
        mj = np.asarray(jpack_group_mask(groups, jnp.int32(b), jspec))
        mt = pack_group_mask(groups, b, tspec)
        assert mt.dtype == torch.float32 and mt.shape == (tspec.rows, LANE)
        np.testing.assert_array_equal(mt.numpy(), mj)
        assert 0 < mj.sum() < mj.size


def test_cpu_wrappers_launch_nothing_and_check_operands():
    w, dw, ext, mask = make_operands(2, seed=3)
    K.reset_launch_counts()
    tops.gossip_blend_worker_batched(t(w), t(dw), t(ext), EPS,
                                     mask2d=t(mask))
    tops.gossip_blend_packed(t(w[0]), t(dw[0]), t(ext[0]), EPS)
    assert K.launch_counts() == {}
    with pytest.raises(NotImplementedError, match="item 7"):
        tops.gossip_blend_worker_batched(t(w), t(dw), t(ext), EPS,
                                         psum_axes=("data",))
    with pytest.raises(ValueError, match="mask must be"):
        gossip_reduce_w(t(w), t(dw), t(ext), t(mask[:8]))
    with pytest.raises(ValueError, match="float32"):
        gossip_reduce_w(t(w), t(dw).double(), t(ext))
    with pytest.raises(ValueError, match="P >= 1"):
        gossip_reduce_w(t(w), t(dw), t(ext)[:, :0])
    meta = [x.to("meta") for x in (t(w), t(dw), t(ext))]
    with pytest.raises(ValueError, match="run on cuda"):
        gossip_reduce_w(*meta)
    # no externals: the plain SGD step and no gates, as in the reference
    out, g = tops.gossip_blend_packed(t(w[0]), t(dw[0]), t(ext[0])[:0], EPS)
    assert g.shape == (0,) and torch.equal(out, t(w[0]) - EPS * t(dw[0]))
    # a validity scale of 0 closes every gate (the staleness guard)
    out, g = tops.gossip_blend_worker_batched(t(w), t(dw), t(ext), EPS,
                                              gate_scale=0.0)
    assert not g.any()
    torch.testing.assert_close(out, t(w) - EPS * t(dw), rtol=0, atol=0)
