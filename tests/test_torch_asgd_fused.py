"""The port's single-worker fused ASGD update (core/asgd.py, kernels B3r/B3a
through their plain versions on the CPU) against the reference's — which
runs its Pallas kernels in interpret mode here — and against the port's
own unfused ``asgd_update``; plus ``asgd_delta_bar`` and
``parzen_gate_inner``.

Tolerances: f32 states within atol 1e-5 of the reference's fused path
and of the unfused loop (sums in other orders, then one division); bf16
states within 2e-2 (one bf16 rounding of O(1) values); gate counts
exactly — the externals sit at +-0.5, +-1.5, 2.5 steps from the state,
far from the Parzen threshold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import asgd as jasgd
from repro.core import parzen as jparzen
from repro_torch.core import asgd as tasgd
from repro_torch.core import parzen as tparzen
from repro_torch.core.packing import pack, pack_spec

COEFS = (0.5, -0.5, 1.5, -1.5, 2.5)


def tree_case(seed, p):
    rng = np.random.default_rng(seed)
    w = {"layer": {"w": rng.standard_normal((17, 9)),
                   "b": rng.standard_normal(9)},
         "head": rng.standard_normal(23)}
    w = jax.tree.map(lambda x: x.astype(np.float32), w)
    dw = jax.tree.map(lambda x: (0.1 * rng.standard_normal(x.shape))
                      .astype(np.float32), w)
    exts = [jax.tree.map(lambda x, d, c=COEFS[i % 5]: x - c * d, w, dw)
            for i in range(p)]
    if p >= 2:      # one empty receive buffer (eq. 3)
        exts[1] = jax.tree.map(np.zeros_like, w)
    return w, dw, exts


def to_j(tree, dtype=jnp.float32):
    return jax.tree.map(lambda x: jnp.asarray(x, dtype), tree)


def to_t(tree, dtype=torch.float32):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x), dtype=dtype),
                        tree)


def assert_trees_close(t_tree, j_tree, atol):
    tl, jl = jax.tree.leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("p", [0, 1, 2, 5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_update_matches_reference(p, dtype):
    w, dw, exts = tree_case(p, p)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    cfg_j = jasgd.ASGDConfig(eps=0.1, use_fused=True)
    cfg_t = tasgd.ASGDConfig(eps=0.1, use_fused=True)
    ref, ng_r = jasgd.asgd_update_fused(to_j(w, jd), to_j(dw, jd),
                                        [to_j(e, jd) for e in exts], cfg_j)
    out, ng = tasgd.asgd_update(to_t(w, td), to_t(dw, td),
                                [to_t(e, td) for e in exts], cfg_t)
    assert float(ng) == float(ng_r)
    for leaf in jax.tree.leaves(out):
        assert leaf.dtype == td
    assert_trees_close(out, ref, 1e-5 if dtype == "float32" else 2e-2)


@pytest.mark.parametrize("elastic", [False, True])
@pytest.mark.parametrize("p", [1, 3, 8])
def test_fused_update_matches_unfused_loop(p, elastic):
    w, dw, exts = tree_case(20 + p, p)
    kw = dict(eps=0.07, elastic=elastic, elastic_alpha=0.3)
    args = (to_t(w), to_t(dw), [to_t(e) for e in exts])
    a, ng_a = tasgd.asgd_update(*args, tasgd.ASGDConfig(**kw))
    b, ng_b = tasgd.asgd_update(*args, tasgd.ASGDConfig(use_fused=True,
                                                        **kw))
    c, ng_c = tasgd.asgd_update_fused(*args, tasgd.ASGDConfig(**kw))
    assert float(ng_a) == float(ng_b) == float(ng_c) > 0
    for x, y, z in zip(jax.tree.leaves(a), jax.tree.leaves(b),
                       jax.tree.leaves(c)):
        np.testing.assert_allclose(y.numpy(), x.numpy(), rtol=0, atol=1e-5)
        assert torch.equal(y, z)


@pytest.mark.parametrize("use_parzen", [True, False])
def test_packed_update_matches_reference(use_parzen):
    w, dw, exts = tree_case(3, 3)
    spec = pack_spec(to_t(w), block_rows=64)
    w2, d2 = pack(to_t(w), spec), pack(to_t(dw), spec)
    e3 = torch.stack([pack(to_t(e), spec) for e in exts])
    cfg_t = tasgd.ASGDConfig(eps=0.1, use_parzen=use_parzen)
    cfg_j = jasgd.ASGDConfig(eps=0.1, use_parzen=use_parzen)
    out, ng = tasgd.asgd_update_packed(w2, d2, e3, cfg_t)
    ref, ng_r = jasgd.asgd_update_packed(jnp.asarray(w2.numpy()),
                                         jnp.asarray(d2.numpy()),
                                         jnp.asarray(e3.numpy()), cfg_j)
    assert out.shape == w2.shape and float(ng) == float(ng_r)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    # silent, and no externals: the plain step
    for cfg, e in ((tasgd.ASGDConfig(eps=0.1, silent=True), e3),
                   (cfg_t, e3[:0])):
        out, ng = tasgd.asgd_update_packed(w2, d2, e, cfg)
        assert float(ng) == 0.0 and torch.equal(out, w2 - 0.1 * d2)


def test_delta_bar_and_parzen_gate_inner_match_reference():
    w, dw, exts = tree_case(4, 3)
    cfg_j, cfg_t = jasgd.ASGDConfig(eps=0.1), tasgd.ASGDConfig(eps=0.1)
    ref, ng_r = jasgd.asgd_delta_bar(to_j(w), to_j(dw),
                                     [to_j(e) for e in exts], cfg_j)
    out, ng = tasgd.asgd_delta_bar(to_t(w), to_t(dw),
                                   [to_t(e) for e in exts], cfg_t)
    assert float(ng) == float(ng_r) == 2.0
    assert_trees_close(out, ref, 1e-6)
    silent, ng = tasgd.asgd_delta_bar(to_t(w), to_t(dw), [],
                                      cfg_t)
    assert float(ng) == 0.0
    assert_trees_close(silent, to_j(dw), 0.0)
    for c in COEFS + (0.0,):
        e = jax.tree.map(lambda x, d: x - c * d, w, dw)
        for eps in (0.1, 1.5):
            g_j = float(jparzen.parzen_gate_inner(to_j(w), to_j(dw),
                                                  to_j(e), eps))
            g_t = float(tparzen.parzen_gate_inner(to_t(w), to_t(dw),
                                                  to_t(e), eps))
            assert g_t == g_j == float(tparzen.parzen_gate(
                to_t(w), to_t(dw), to_t(e), eps))


def test_fused_update_silent_and_elastic():
    w, dw, exts = tree_case(6, 1)
    args = (to_t(w), to_t(dw), [to_t(e) for e in exts])
    out, ng = tasgd.asgd_update_fused(*args, tasgd.ASGDConfig(
        eps=0.1, silent=True))
    assert float(ng) == 0.0
    for a, x, d in zip(jax.tree.leaves(out), jax.tree.leaves(args[0]),
                       jax.tree.leaves(args[1])):
        assert torch.equal(a, x - 0.1 * d)
    cfg = dict(eps=0.07, elastic=True, elastic_alpha=0.3)
    ref, _ = jasgd.asgd_update_fused(to_j(w), to_j(dw), [to_j(exts[0])],
                                     jasgd.ASGDConfig(**cfg))
    out, _ = tasgd.asgd_update_fused(*args, tasgd.ASGDConfig(**cfg))
    assert_trees_close(out, ref, 1e-6)
