"""The port's RG-LRU block (repro_torch/models/rglru.py) against the
reference's (src/repro/models/rglru.py) on the same weights and inputs,
made from a seed with numpy, two worker replicas at once (each held to
the reference on its own weights):

* ``_causal_conv`` and ``_rg_lru_coeffs`` within atol 1e-5 / rel 1e-5;
* ``rg_lru_scan`` — a doubling scan where the reference takes
  ``jax.lax.associative_scan``, so summed in another order — within 1e-5
  of max|h|, with and without ``h0``, at lengths that are not powers of 2;
* ``apply_rglru``'s output and final state within atol 1e-5 / rel 1e-5,
  its gradients within atol 1e-5 of ``jax.grad``'s;
* ``apply_rglru_decode`` stepped over a sequence against the reference's
  own decode, within atol 1e-5 / rel 1e-5;
* ``init_rglru``'s leaf names, shapes and sorted order (``Lambda`` first),
  on which the packed layout and the checkpoint's leaf list depend.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as JR
from repro_torch.checkpoint import canonical_leaves
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import flatten_sorted
from repro_torch.models import rglru as TR
from _torch_threads import one_torch_thread  # noqa: F401

D, C, W, B = 24, 32, 2, 2
TOL = dict(rtol=1e-5, atol=1e-5)


def setup(seed=0, S=13):
    """Reference params of W workers (numpy, leading worker axis), the
    port's, and x (W, B, S, D)."""
    wnp = [jax.tree.map(np.asarray, JR.init_rglru(jax.random.key(seed + w),
                                                  D, C)) for w in range(W)]
    rng = np.random.default_rng(seed)
    for p in wnp:    # nonzero biases, so that they are tested too
        for name in ("conv_b", "b_a", "b_x"):
            p[name] = 0.1 * rng.standard_normal(C).astype(np.float32)
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *wnp)
    x = rng.standard_normal((W, B, S, D)).astype(np.float32)
    return wnp, params_from_numpy(stacked), x


def test_causal_conv_and_coeffs_match_reference():
    wnp, tp, _ = setup()
    x = np.random.default_rng(5).standard_normal((W, B, 9, C)).astype(
        np.float32)
    conv = TR._causal_conv(torch.from_numpy(x), tp["conv_w"], tp["conv_b"])
    a, b = TR._rg_lru_coeffs(tp, torch.from_numpy(x))
    for w in range(W):
        jp = jax.tree.map(jnp.asarray, wnp[w])
        np.testing.assert_allclose(
            conv[w].numpy(), np.asarray(JR._causal_conv(
                jnp.asarray(x[w]), jp["conv_w"], jp["conv_b"])), **TOL)
        ja, jb = JR._rg_lru_coeffs(jp, jnp.asarray(x[w]))
        np.testing.assert_allclose(a[w].numpy(), np.asarray(ja), **TOL)
        np.testing.assert_allclose(b[w].numpy(), np.asarray(jb), **TOL)


@pytest.mark.parametrize("S", [1, 2, 7, 16, 37])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_reference(S, with_h0):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, (B, S, C)).astype(np.float32)
    b = rng.standard_normal((B, S, C)).astype(np.float32)
    h0 = rng.standard_normal((B, C)).astype(np.float32) if with_h0 else None
    ref = np.asarray(JR.rg_lru_scan(
        jnp.asarray(a), jnp.asarray(b),
        None if h0 is None else jnp.asarray(h0)))
    ours = TR.rg_lru_scan(torch.from_numpy(a), torch.from_numpy(b),
                          None if h0 is None else torch.from_numpy(h0))
    assert ours.shape == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    # and the recurrence it computes, stepped in float64
    h = np.zeros((B, C)) if h0 is None else h0.astype(np.float64)
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        np.testing.assert_allclose(ours[:, t].numpy(), h, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())


def test_apply_rglru_output_state_and_gradients_match_reference():
    S = 13
    wnp, tp, x = setup(seed=1, S=S)
    ct = np.random.default_rng(2).standard_normal((W, B, S, D)).astype(
        np.float32)
    leaves = {n: v.clone().requires_grad_() for n, v in tp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, h_fin = TR.apply_rglru(leaves, xt)
    assert out.shape == (W, B, S, D) and h_fin.shape == (W, B, C)
    assert h_fin.dtype == torch.float32
    (out * torch.from_numpy(ct)).sum().backward()
    # jitted once, called for each worker
    japply = jax.jit(JR.apply_rglru)
    jgrad = jax.jit(jax.grad(lambda p, xx, c: jnp.sum(
        JR.apply_rglru(p, xx)[0] * c), argnums=(0, 1)))
    for w in range(W):
        jp = jax.tree.map(jnp.asarray, wnp[w])
        jout, jh = japply(jp, jnp.asarray(x[w]))
        np.testing.assert_allclose(out[w].detach().numpy(), np.asarray(jout),
                                   **TOL)
        np.testing.assert_allclose(h_fin[w].detach().numpy(), np.asarray(jh),
                                   **TOL)
        gp, gx = jgrad(jp, jnp.asarray(x[w]), jnp.asarray(ct[w]))
        np.testing.assert_allclose(xt.grad[w].numpy(), np.asarray(gx),
                                   rtol=0, atol=1e-5)
        for name in sorted(leaves):
            np.testing.assert_allclose(leaves[name].grad[w].numpy(),
                                       np.asarray(gp[name]), rtol=0,
                                       atol=1e-5, err_msg=name)


def test_decode_steps_match_reference_decode():
    """apply_rglru_decode stepped over 6 tokens from a zero cache against
    the reference's apply_rglru_decode, output and cache each step; and
    the steps' outputs are the full-sequence block's (a zero conv
    history is the causal conv's zero padding)."""
    S = 6
    wnp, tp, x = setup(seed=3, S=S)
    cache = {n: torch.from_numpy(np.stack([v] * W)) for n, v in
             TR.init_rglru_cache(B, C).items()}
    jcaches = [JR.init_rglru_cache(B, C) for _ in range(W)]
    full, _ = TR.apply_rglru(tp, torch.from_numpy(x))
    for t in range(S):
        out, cache = TR.apply_rglru_decode(tp, torch.from_numpy(
            x[:, :, t:t + 1]), cache)
        for w in range(W):
            jp = jax.tree.map(jnp.asarray, wnp[w])
            jout, jcaches[w] = JR.apply_rglru_decode(
                jp, jnp.asarray(x[w, :, t:t + 1]), jcaches[w])
            np.testing.assert_allclose(out[w].numpy(), np.asarray(jout),
                                       **TOL)
            for name in ("conv", "h"):
                np.testing.assert_allclose(cache[name][w].numpy(),
                                           np.asarray(jcaches[w][name]),
                                           **TOL)
        np.testing.assert_allclose(out[:, :, 0].numpy(),
                                   full[:, :, t].numpy(), **TOL)


def test_init_rglru_leaf_names_and_sorted_order():
    jp = JR.init_rglru(jax.random.key(0), D, C)
    tp = TR.init_rglru(torch.Generator().manual_seed(0), D, C)
    assert sorted(tp) == sorted(jp)
    assert sorted(tp)[0] == "Lambda"          # capital L sorts first
    jl = jax.tree.leaves(jp)
    names = [str(k[0].key) for k, _ in
             jax.tree_util.tree_flatten_with_path(jp)[0]]
    assert names == sorted(tp)
    leaves = flatten_sorted(tp)[0]
    assert [tuple(t.shape) for t in leaves] == [x.shape for x in jl]
    assert [t.dtype for t in leaves] == [torch.float32] * len(jl)
    assert [id(t) for t in canonical_leaves(tp)[0]] == \
        [id(t) for t in leaves]
    a = torch.sigmoid(tp["Lambda"])
    assert bool(((a >= 0.9 - 1e-6) & (a <= 0.999 + 1e-6)).all())
