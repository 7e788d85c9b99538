"""The port's mamba-2 mixer (models/ssm.py) against the reference's at the
reduced mamba2-370m widths (d_model 256, 32 heads of 16, state 16, chunk
8), on reference-initialized weights carried over with
repro_torch.convert and inputs made from a seed with numpy.  The port's
functions take a leading worker axis; one model is W = 1.

Tolerance: 1e-4 of the largest magnitude of the result (f32 matmuls and
the chunked scan summed in another order); the conv (4 products and sums
in the reference's order) and the zero cache exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.models import ssm as JS
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import tree_map
from repro_torch.models import ssm as TS
from _torch_threads import one_torch_thread  # noqa: F401

CFG = get_arch("mamba2-370m").reduced()
DIMS = {"head_dim": CFG.ssm_head_dim, "state": CFG.ssm_state,
        "n_groups": CFG.ssm_groups}


def setup(seed=0, batch=2, seq=16):
    jp = JS.init_ssd(jax.random.key(seed), CFG.d_model,
                     expand=CFG.ssm_expand, **DIMS)
    rng = np.random.default_rng(seed)
    # a trained-looking mixer: nonzero norm scale, conv bias and dt bias
    np_params = jax.tree.map(np.asarray, jp)
    np_params["norm"]["scale"] = 0.1 * rng.standard_normal(
        np_params["norm"]["scale"].shape).astype(np.float32)
    np_params["conv_b"] = 0.1 * rng.standard_normal(
        np_params["conv_b"].shape).astype(np.float32)
    np_params["dt_bias"] = rng.standard_normal(
        np_params["dt_bias"].shape).astype(np.float32)
    x = rng.standard_normal((batch, seq, CFG.d_model)).astype(np.float32)
    tp = tree_map(lambda t: t[None], params_from_numpy(np_params))
    return jax.tree.map(jnp.asarray, np_params), tp, x


def assert_near(ours, ref, tol=1e-4):
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (err, scale)


def test_init_ssd_matches_reference_layout():
    jp = JS.init_ssd(jax.random.key(0), CFG.d_model, expand=CFG.ssm_expand,
                     **DIMS)
    tp = TS.init_ssd(torch.Generator().manual_seed(0), CFG.d_model,
                     expand=CFG.ssm_expand, **DIMS)
    shapes = jax.tree.map(lambda a: tuple(a.shape), jp)
    assert tree_map(lambda t: tuple(t.shape), tp) == shapes
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                   rtol=1e-6)


def test_causal_conv_matches_reference():
    jp, tp, x = setup(1)
    C = tp["conv_w"].shape[-1]
    xc = np.random.default_rng(1).standard_normal((2, 16, C)).astype(
        np.float32)
    ours = TS._causal_conv(torch.from_numpy(xc)[None], tp["conv_w"],
                           tp["conv_b"])[0]
    ref = JS._causal_conv(jnp.asarray(xc), jp["conv_w"], jp["conv_b"])
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("seq", [8, 24])
def test_apply_ssd_matches_reference(seq):
    jp, tp, x = setup(2, seq=seq)
    out, h = TS.apply_ssd(tp, torch.from_numpy(x)[None],
                          chunk=CFG.ssm_chunk, **DIMS)
    jout, jh = JS.apply_ssd(jp, jnp.asarray(x), chunk=CFG.ssm_chunk, **DIMS)
    assert_near(out[0], jout)
    assert_near(h[0], jh)


def test_apply_ssd_refuses_a_ragged_chunk():
    _, tp, x = setup(3, seq=12)
    with pytest.raises(ValueError, match="multiple of ssm_chunk"):
        TS.apply_ssd(tp, torch.from_numpy(x)[None], chunk=CFG.ssm_chunk,
                     **DIMS)


def test_init_ssd_cache_matches_reference():
    jc = JS.init_ssd_cache(3, CFG.d_model, expand=CFG.ssm_expand, **DIMS)
    tc = TS.init_ssd_cache(3, CFG.d_model, expand=CFG.ssm_expand, **DIMS)
    for name in ("conv", "ssm"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].dtype == torch.float32 and not tc[name].any()


def test_apply_ssd_decode_matches_reference():
    """Three decode steps from a random cache, each against the reference
    on the reference's own carried cache."""
    jp, tp, x = setup(4, seq=3)
    rng = np.random.default_rng(4)
    jc = JS.init_ssd_cache(2, CFG.d_model, expand=CFG.ssm_expand, **DIMS)
    jc = {k: jnp.asarray(rng.standard_normal(v.shape).astype(np.float32))
          for k, v in jc.items()}
    tc = {k: torch.from_numpy(np.array(v))[None] for k, v in jc.items()}
    for t in range(3):
        xt = x[:, t:t + 1]
        out, tc = TS.apply_ssd_decode(tp, torch.from_numpy(xt)[None], tc,
                                      **DIMS)
        jout, jc = JS.apply_ssd_decode(jp, jnp.asarray(xt), jc, **DIMS)
        assert_near(out[0], jout)
        for k in ("conv", "ssm"):
            assert_near(tc[k][0], jc[k])
