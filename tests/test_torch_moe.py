"""The port's MoE FFN (repro_torch.models.moe) against the reference's
(repro.models.moe) on the same weights — the reference's ``init_moe``
carried over as numpy — and the same numpy-seeded inputs: the cases of
tests/test_moe.py, each run through both packages, plus the dropped
(token, slot) pairs themselves and the decode path's drops at granite's
routing shape.

Tolerances: outputs within 1e-5 (atol and rtol; f32 products summed in
another order), aux within rel 1e-6, gradients within atol 1e-5 of
``jax.grad``; the routing (top-k indices) and the dropped pairs equal
exactly wherever the router's top-k has no near-tie (ROADMAP.md's rule for
gates near a threshold), and the cumsum exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JM
from repro_torch.models import moe as TM
from _torch_threads import one_torch_thread  # noqa: F401

TOL = 1e-5


def setup(D, F, E, seed=0, W=1):
    """W workers' reference params (numpy, a leading worker axis) and the
    port's tensors of them."""
    ps = [jax.tree.map(np.asarray, JM.init_moe(jax.random.key(seed + w), D,
                                               F, E)) for w in range(W)]
    stacked = {n: np.stack([p[n] for p in ps]) for n in ps[0]}
    return ps, {n: torch.from_numpy(v) for n, v in stacked.items()}


def inputs(shape, seed, scale=0.5):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


def clear_of_ties(probs, topk, margin=1e-6):
    """Tokens whose k-th and (k+1)-th router probabilities differ by more
    than ``margin``: their top-k sets are the same in any order of sums."""
    s = -np.sort(-probs, axis=-1)
    if topk == probs.shape[-1]:
        return np.ones(probs.shape[:-1], bool)
    return (s[..., topk - 1] - s[..., topk]) > margin


def ref_keep(jp, xt, topk, C):
    """The reference's dropped pairs, from its own route and cumsum (its
    _dispatch_group's first lines): keep (Tg*k,)."""
    E = jp["router"].shape[-1]
    _, idx, _, _ = JM.route(jp, jnp.asarray(xt), topk)
    flat_e = idx.reshape(-1)
    pos_in_e = JM._blocked_cumsum(jax.nn.one_hot(flat_e, E,
                                                 dtype=jnp.int32)) - 1
    pos = jnp.take_along_axis(pos_in_e, flat_e[:, None], axis=1)[:, 0]
    return np.asarray(pos < C)


def dense_moe(p, x, topk):
    """Every expert computes every token, combined by the router weights
    (no capacity): the undropped sum.  x (T, D), p one model's tensors."""
    w, idx, _, _ = TM.route({"router": p["router"][None]}, x[None], topk)
    h = torch.nn.functional.silu(torch.einsum("td,edf->tef", x, p["gate"])) \
        * torch.einsum("td,edf->tef", x, p["up"])
    y_all = torch.einsum("tef,efd->ted", h, p["down"])
    wts = torch.zeros(x.shape[0], p["router"].shape[-1]).scatter_add_(
        -1, idx[0], w[0])
    return torch.einsum("te,ted->td", wts, y_all)


# ---------------------------------------------------------------------------
# route and the cumsum
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,E,topk,T", [(8, 6, 3, 20), (16, 32, 8, 64),
                                        (16, 16, 2, 64)])
def test_route_matches_reference(D, E, topk, T):
    """w, idx, aux and load of one router; at granite's (32, 8) and
    phi3.5's (16, 2) expert counts too."""
    (jp,), tp = setup(D, 16, E, seed=3)
    x = inputs((T, D), 4, scale=1.0)
    jw, jidx, jaux, jload = JM.route(jp, jnp.asarray(x), topk)
    w, idx, aux, load = TM.route(tp, torch.from_numpy(x)[None], topk)
    probs = np.asarray(jax.nn.softmax(x @ jp["router"], axis=-1))
    clear = clear_of_ties(probs, topk)
    assert clear.all()
    np.testing.assert_array_equal(idx[0].numpy(), np.asarray(jidx))
    np.testing.assert_allclose(w[0].numpy(), np.asarray(jw), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux[0]), float(jaux), rtol=1e-6)
    np.testing.assert_array_equal(load[0].numpy(), np.asarray(jload))


@pytest.mark.parametrize("seed", range(5))
def test_router_weights_normalized(seed):
    """The reference's property test, on both packages' routers."""
    D, E, topk = 8, 6, 3
    (jp,), tp = setup(D, 16, E, seed=seed % 100)
    x = inputs((20, D), 100 + seed, scale=1.0)
    w, idx, aux, _ = TM.route(tp, torch.from_numpy(x)[None], topk)
    jw, _, jaux, _ = JM.route(jp, jnp.asarray(x), topk)
    for ws, a in ((w[0].numpy(), float(aux[0])), (np.asarray(jw),
                                                  float(jaux))):
        np.testing.assert_allclose(ws.sum(-1), 1.0, rtol=1e-5)
        assert a >= 0.99          # Switch aux loss >= 1 at balance
    assert bool(((idx >= 0) & (idx < E)).all())


@pytest.mark.parametrize("n,e,blk", [(1, 3, 64), (64, 4, 64), (65, 4, 64),
                                     (5000, 8, 64), (4096, 32, 4096),
                                     (4097, 32, 4096), (100_000, 4, 4096)])
def test_blocked_cumsum_is_exact(n, e, blk):
    """Exact against the reference's form and numpy's cumsum, below, at
    and past one block; W-batched rows too."""
    x = np.random.default_rng(n).integers(0, 3, (2, n, e)).astype(np.int32)
    got = TM._blocked_cumsum(torch.from_numpy(x), blk=blk)
    np.testing.assert_array_equal(got.numpy(), np.cumsum(x, axis=1))
    np.testing.assert_array_equal(
        got[1].numpy(), np.asarray(JM._blocked_cumsum(jnp.asarray(x[1]),
                                                      blk=blk)))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,topk", [(4, 2), (8, 2), (8, 4)])
def test_matches_dense_reference_with_ample_capacity(E, topk):
    """Capacity >= T*k drops nothing: the capacity dispatch equals the
    reference's and the dense computation of every expert."""
    D, F = 16, 32
    (jp,), tp = setup(D, F, E)
    x = inputs((2, 24, D), 1)
    y_j, aux_j = JM.apply_moe(jp, jnp.asarray(x), topk,
                              capacity_factor=float(E))
    y, aux = TM.apply_moe(tp, torch.from_numpy(x)[None], topk,
                          capacity_factor=float(E))
    np.testing.assert_allclose(y[0].numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(float(aux[0]), float(aux_j), rtol=1e-6)
    dense = dense_moe({n: v[0] for n, v in tp.items()},
                      torch.from_numpy(x).reshape(-1, D), topk)
    np.testing.assert_allclose(y[0].reshape(-1, D).numpy(), dense.numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("cf,groups", [(8.0, 4), (1.25, 4), (1.25, 5)])
def test_group_dispatch_matches_reference(cf, groups):
    """Groups against the monolithic dispatch with ample capacity (the
    reference's case), and each worker's groups against the reference's
    at capacity 1.25 (per-group drops) — 16 groups of granite's config,
    and a count that does not divide T (one group).  Three workers with
    their own weights and tokens: groups never cross workers."""
    E, topk, D, F, W = 8, 2, 16, 32, 3
    jps, tp = setup(D, F, E, seed=2, W=W)
    x = inputs((W, 4, 16, D), 3)
    y, aux = TM.apply_moe(tp, torch.from_numpy(x), topk,
                          capacity_factor=cf, dispatch_groups=groups)
    for w in range(W):
        y_j, aux_j = JM.apply_moe(jps[w], jnp.asarray(x[w]), topk,
                                  capacity_factor=cf,
                                  dispatch_groups=groups)
        np.testing.assert_allclose(y[w].numpy(), np.asarray(y_j), rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(float(aux[w]), float(aux_j), rtol=1e-6)
    if cf == float(E):
        y1, _ = TM.apply_moe(tp, torch.from_numpy(x), topk,
                             capacity_factor=cf, dispatch_groups=1)
        np.testing.assert_allclose(y.numpy(), y1.numpy(), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("E,topk,cf", [(4, 2, 0.25), (32, 8, 1.25),
                                       (16, 2, 1.25)])
def test_overflow_drops_the_reference_pairs(E, topk, cf):
    """Small capacity: the port drops exactly the reference's (token,
    slot) pairs, never overwrites a kept one, and its output is finite
    and the reference's.  (32, 8) and (16, 2) at 1.25 are granite's and
    phi3.5's training capacities at Tg = 16 (C = 5 and 2)."""
    D, F, Tg = 16, 32, 16 if E > 4 else 32
    (jp,), tp = setup(D, F, E, seed=4)
    x = inputs((1, Tg, D), 5)
    C = max(1, int(cf * Tg * topk / E))
    probs = np.asarray(jax.nn.softmax(x[0] @ jp["router"], axis=-1))
    assert clear_of_ties(probs, topk).all()
    _, idx, _, _ = TM.route(tp, torch.from_numpy(x)[None], topk)
    slot, keep = TM.capacity_slots(idx, E, C)
    want = ref_keep(jp, x[0], topk, C)
    np.testing.assert_array_equal(keep[0, 0].numpy(), want)
    assert 0 < (~want).sum() < want.size          # some drop, some kept
    kept = slot[keep]
    assert len(set(kept.tolist())) == len(kept)   # one pair a slot
    assert bool((slot[~keep] == E * C).all())
    y_j, _ = JM.apply_moe(jp, jnp.asarray(x), topk, capacity_factor=cf)
    y, _ = TM.apply_moe(tp, torch.from_numpy(x)[None], topk,
                        capacity_factor=cf)
    assert bool(torch.isfinite(y).all())
    np.testing.assert_allclose(y[0].numpy(), np.asarray(y_j), rtol=TOL,
                               atol=TOL)


def test_decode_matches_full_path():
    """apply_moe_decode(x) == apply_moe(x) for a 1-token sequence with
    ample capacity, and == the reference's decode."""
    E, topk, D, F = 8, 4, 16, 32
    (jp,), tp = setup(D, F, E, seed=6)
    x = inputs((8, 1, D), 7)
    y_dec, aux = TM.apply_moe_decode(tp, torch.from_numpy(x)[None], topk)
    y_full, _ = TM.apply_moe(tp, torch.from_numpy(x)[None], topk,
                             capacity_factor=float(E))
    y_ref, _ = JM.apply_moe_decode(jp, jnp.asarray(x), topk)
    np.testing.assert_allclose(y_dec.numpy(), y_full.numpy(), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(y_dec[0].numpy(), np.asarray(y_ref),
                               rtol=TOL, atol=TOL)
    assert aux.shape == (1,) and float(aux[0]) == 0.0


def test_decode_drops_pairs_at_granite_routing():
    """Pins a reference behaviour the port keeps on purpose: at granite's
    decode routing (batch 4, top-8 of 32 experts) the decode capacity
    max(1, ceil(B*k/E) * 2) = 2 drops (token, slot) pairs — the
    reference's comment says decode drops nothing.  The port drops the
    same pairs and matches the reference's output, not the undropped
    sum."""
    B, E, topk, D, F = 4, 32, 8, 32, 16
    C = max(1, -(-B * topk // E) * 2)
    assert C == 2
    for seed in range(20):
        (jp,), tp = setup(D, F, E, seed=seed)
        x = inputs((B, 1, D), 50 + seed, scale=1.0)
        want = ref_keep(jp, x[:, 0], topk, C)
        if (~want).any():
            break
    else:
        pytest.fail("no seed of 20 drops a pair")
    probs = np.asarray(jax.nn.softmax(x[:, 0] @ jp["router"], axis=-1))
    assert clear_of_ties(probs, topk).all()
    _, idx, _, _ = TM.route(tp, torch.from_numpy(x[:, 0])[None, None], topk)
    _, keep = TM.capacity_slots(idx, E, C)
    np.testing.assert_array_equal(keep[0, 0].numpy(), want)
    y, _ = TM.apply_moe_decode(tp, torch.from_numpy(x)[None], topk)
    y_ref, _ = JM.apply_moe_decode(jp, jnp.asarray(x), topk)
    np.testing.assert_allclose(y[0].numpy(), np.asarray(y_ref), rtol=TOL,
                               atol=TOL)
    undropped = dense_moe({n: v[0] for n, v in tp.items()},
                          torch.from_numpy(x[:, 0]), topk)
    gap = float((y[0, :, 0] - undropped).abs().max())
    assert gap > 100 * TOL * float(undropped.abs().max())


# ---------------------------------------------------------------------------
# gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,topk,cf,groups", [(8, 2, 8.0, 1),
                                              (8, 2, 1.25, 4),
                                              (32, 8, 1.25, 2)])
def test_gradients_match_jax_grad(E, topk, cf, groups):
    """d(sum(y * r) + 0.01 * aux) by the port's autograd against
    jax.grad of the reference, for x and every param leaf: with ample
    capacity, and with per-group drops (the dropped pairs pass no
    gradient)."""
    D, F = 16, 32
    (jp,), tp = setup(D, F, E, seed=8)
    x = inputs((2, 16, D), 9)
    r = inputs((2, 16, D), 10, scale=1.0)

    def jloss(p, xx):
        y, aux = JM.apply_moe(p, xx, topk, capacity_factor=cf,
                              dispatch_groups=groups)
        return jnp.sum(y * r) + 0.01 * aux

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, jp), jnp.asarray(x))
    leaves = {n: v.clone().requires_grad_(True) for n, v in tp.items()}
    xt = torch.from_numpy(x)[None].requires_grad_(True)
    y, aux = TM.apply_moe(leaves, xt, topk, capacity_factor=cf,
                          dispatch_groups=groups)
    ((y * torch.from_numpy(r)[None]).sum() + 0.01 * aux.sum()).backward()
    np.testing.assert_allclose(xt.grad[0].numpy(), np.asarray(jg_x),
                               rtol=0, atol=TOL)
    for n, v in leaves.items():
        np.testing.assert_allclose(v.grad[0].numpy(), np.asarray(jg_p[n]),
                                   rtol=0, atol=TOL, err_msg=n)
