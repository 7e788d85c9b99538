"""The port's P=1 Parzen gate + blend (kernels/parzen_blend: B6r/B6a through
their plain versions on the CPU) against the reference's ``parzen_blend`` —
its Pallas kernels, in interpret mode here — and its oracle
``parzen_blend_ref``, on the same numpy inputs; mirrors the reference's
tests/test_kernels.py TestParzenBlend, plus each pass on its own.

Tolerances: gates exactly (the externals sit half a step ahead of or
behind the state, far from the threshold, or are empty); f32 states
within rtol 1e-5, atol 1e-6 (the reduce's sums in another order; the apply
is the same elementwise formula); the (3,) accumulator within rtol 1e-5;
bf16 states within 2e-2 (one bf16 rounding of O(1) values).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ASGDConfig as JConfig
from repro.core import asgd_update as j_asgd_update
from repro.kernels.gossip_blend.ops import _to_2d as j_to_2d
from repro.kernels.parzen_blend.kernel import parzen_reduce_pallas
from repro.kernels.parzen_blend.ops import parzen_blend as j_parzen_blend
from repro.kernels.parzen_blend.ref import parzen_blend_ref as j_blend_ref
from repro_torch.core.asgd import ASGDConfig, asgd_update
from repro_torch.kernels.gossip_blend.ops import _to_2d
from repro_torch.kernels.parzen_blend import parzen_blend
from repro_torch.kernels.parzen_blend.kernel import (parzen_apply,
                                                     parzen_reduce)
from repro_torch.kernels.parzen_blend.ref import (parzen_apply_plain,
                                                  parzen_blend_ref)

TOL = {"rtol": 1e-5, "atol": 1e-6}


def flat_case(seed, n, side):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal(n).astype(np.float32)
    dw = (0.1 * rng.standard_normal(n)).astype(np.float32)
    return w, (w - side * dw).astype(np.float32), dw


@pytest.mark.parametrize("n", [100, 512, 32768, 70000, 512 * 64 + 7])
@pytest.mark.parametrize("ahead", [True, False])
def test_shape_sweep_matches_reference(n, ahead):
    w, ext, dw = flat_case(n + ahead, n, 0.5 if ahead else -0.5)
    out, g = parzen_blend(*(torch.from_numpy(a) for a in (w, ext, dw)), 0.1)
    out_j, g_j = j_parzen_blend(*(jnp.asarray(a) for a in (w, ext, dw)), 0.1)
    out_r, g_r = j_blend_ref(*(jnp.asarray(a) for a in (w, ext, dw)), 0.1)
    assert float(g) == float(g_j) == float(g_r) == (1.0 if ahead else 0.0)
    assert out.shape == (n,) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_r), **TOL)
    o2, g2 = parzen_blend_ref(*(torch.from_numpy(a) for a in (w, ext, dw)),
                              0.1)
    assert float(g2) == float(g_r)
    np.testing.assert_allclose(o2.numpy(), np.asarray(out_r), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dtype_sweep(dtype):
    w, ext, dw = flat_case(0, 4096, 0.5)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    wj, ej, dj = (jnp.asarray(a).astype(jd) for a in (w, ext, dw))
    out, g = parzen_blend(*(torch.tensor(np.array(a.astype(jnp.float32)))
                            .to(td) for a in (wj, ej, dj)), 0.1)
    out_j, g_j = j_parzen_blend(wj, ej, dj, 0.1)
    assert out.dtype == td and float(g) == float(g_j)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j.astype(jnp.float32)),
                               rtol=2e-2 if dtype == "bfloat16" else 1e-5,
                               atol=2e-2 if dtype == "bfloat16" else 1e-6)


def test_empty_external_gate_closed():
    rng = np.random.default_rng(1)
    w = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    dw = torch.from_numpy(rng.standard_normal(2048).astype(np.float32))
    out, g = parzen_blend(w, torch.zeros(2048), dw, 0.2)
    assert float(g) == 0.0
    torch.testing.assert_close(out, w - 0.2 * dw, rtol=1e-5, atol=0)


def test_agrees_with_asgd_update_at_p1():
    """parzen_blend == asgd_update with one external, in both packages."""
    rng = np.random.default_rng(7)
    w, dw, ext = (rng.standard_normal(8192).astype(np.float32)
                  for _ in range(3))
    dw = (0.05 * dw).astype(np.float32)
    out, g = parzen_blend(*(torch.from_numpy(a) for a in (w, ext, dw)), 0.05)
    out_c, n_good = asgd_update(torch.from_numpy(w), torch.from_numpy(dw),
                                [torch.from_numpy(ext)],
                                ASGDConfig(eps=0.05))
    out_j, n_good_j = j_asgd_update(jnp.asarray(w), jnp.asarray(dw),
                                    [jnp.asarray(ext)], JConfig(eps=0.05))
    assert float(g) == float(n_good) == float(n_good_j)
    torch.testing.assert_close(out, out_c, **TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)


def test_reduce_keeps_the_tpu_kernels_accumulator_order():
    """B6r's (3,) = [<dw, w-ext>, ||dw||^2, ||ext||^2], the reference
    kernel's order (B3's puts ||ext||^2 second)."""
    w, ext, dw = flat_case(3, 512 * 128, 0.5)
    acc = parzen_reduce(*(_to_2d(torch.from_numpy(a), 64)
                          for a in (w, ext, dw)))
    acc_j = parzen_reduce_pallas(*(j_to_2d(jnp.asarray(a), 64)
                                   for a in (w, ext, dw)))
    np.testing.assert_allclose(acc.numpy(), np.asarray(acc_j), rtol=1e-5)
    w64, e64, d64 = (a.astype(np.float64) for a in (w, ext, dw))
    np.testing.assert_allclose(
        acc.numpy(), [np.dot(d64, w64 - e64), np.dot(d64, d64),
                      np.dot(e64, e64)], rtol=1e-5)


@pytest.mark.parametrize("gate", [0.0, 1.0])
def test_apply_is_the_reference_formula(gate):
    w, ext, dw = (_to_2d(torch.from_numpy(a), 64)
                  for a in flat_case(4, 3000, 0.5))
    g = torch.tensor([gate])
    out = parzen_apply(w, ext, dw, g, eps=0.1)
    torch.testing.assert_close(
        out, w - 0.1 * (g.reshape(()) * 0.5 * (w - ext) + dw), rtol=0,
        atol=0)
    torch.testing.assert_close(out, parzen_apply_plain(w, ext, dw, g,
                                                       eps=0.1),
                               rtol=0, atol=0)
    with pytest.raises(ValueError, match="one-element"):
        parzen_apply(w, ext, dw, torch.ones(2), eps=0.1)
    with pytest.raises(ValueError, match="ext"):
        parzen_reduce(w, ext[:1], dw)
