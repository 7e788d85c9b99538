"""The port's SSD scan (kernels/ssd_scan: the plain version on the CPU)
against the reference's ``ssd_scan`` (its Pallas kernel in interpret mode)
and its sequential oracle ``ssd_scan_ref``, on the reference test's five
shapes (padding included), the decay extremes, and the two chunked forms
of the models.  Inputs made from a seed with numpy.

Tolerances: against the sequential oracle rtol/atol 2e-3, as the
reference's own kernel test (chunked and sequential sums differ in order
and in where exp() is taken); between two chunked forms (the reference's
Pallas kernel, its jnp form, the port's) and between the two sequential
oracles, 1e-4 of the largest magnitude of the result (f32 sums of up to
Q·N terms, which cancel, taken in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan import ssd_scan as jssd_scan
from repro.kernels.ssd_scan.ref import ssd_scan_ref as jssd_scan_ref
from repro.models.ssm import ssd_chunked as jssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_chunked
from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain, ssd_scan_ref
from repro_torch.models.ssm import ssd_chunked, ssd_reference

SHAPES = [  # (B, S, H, P, N, chunk) of tests/test_kernels.py
    (2, 128, 4, 8, 16, 32), (1, 100, 2, 16, 8, 32),
    (2, 256, 3, 8, 128, 128), (1, 64, 8, 64, 128, 64),
    (3, 96, 1, 4, 4, 32),
]


def make_inputs(Bb, S, H, P, N, seed):
    rng = np.random.default_rng(seed)
    f = np.float32
    x = rng.standard_normal((Bb, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S, H)))).astype(f)
    A = (-np.exp(rng.standard_normal(H))).astype(f)
    B = rng.standard_normal((Bb, S, 1, N)).astype(f)
    C = rng.standard_normal((Bb, S, 1, N)).astype(f)
    return x, dt, A, B, C


def torch_of(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def assert_near(ours, ref, tol=1e-4):
    """max |ours - ref| <= tol * max |ref|."""
    ours, ref = np.asarray(ours), np.asarray(ref)
    assert ours.shape == ref.shape
    err, scale = np.abs(ours - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (err, scale)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_ssd_scan_matches_reference_kernel_and_oracle(shape):
    Bb, S, H, P, N, chunk = shape
    ins = make_inputs(Bb, S, H, P, N, sum(shape))
    y, h = ssd_scan(*torch_of(*ins), chunk=chunk)
    assert y.shape == (Bb, S, H, P) and h.shape == (Bb, H, N, P)
    yk, hk = jssd_scan(*map(jnp.asarray, ins), chunk=chunk)
    assert_near(y, yk)
    assert_near(h, hk)
    yr, hr = ssd_scan_ref(*torch_of(*ins))
    yj, hj = jssd_scan_ref(*map(jnp.asarray, ins))
    assert_near(yr, yj)
    assert_near(hr, hj)
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=2e-3, atol=2e-3)


def test_decay_extremes_stable():
    """Fast forgetting (A = -100) and tiny dt stay finite, as the
    reference's kernel does, and agree with it."""
    Bb, S, H, P, N = 1, 64, 2, 4, 8
    x = np.ones((Bb, S, H, P), np.float32)
    dt = np.full((Bb, S, H), 1e-4, np.float32)
    A = np.array([-100.0, -1e-3], np.float32)
    B = np.ones((Bb, S, 1, N), np.float32)
    C = np.ones((Bb, S, 1, N), np.float32)
    y, h = ssd_scan(*torch_of(x, dt, A, B, C), chunk=32)
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(h).all())
    yk, hk = jssd_scan(*map(jnp.asarray, (x, dt, A, B, C)), chunk=32)
    np.testing.assert_allclose(y.numpy(), np.asarray(yk), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(h.numpy(), np.asarray(hk), rtol=1e-5,
                               atol=1e-6)


def test_model_chunked_forms_match_reference_and_oracle():
    """The port's ssd_chunked (the reference model's form) against the
    reference's ssd_chunked and the sequential oracle; it refuses a chunk
    that does not divide S, as the reference asserts."""
    ins = make_inputs(2, 128, 4, 8, 16, 0)
    y, h = ssd_chunked(*torch_of(*ins), chunk=32)
    yj, hj = jssd_chunked(*map(jnp.asarray, ins), chunk=32)
    assert_near(y, yj)
    assert_near(h, hj)
    yr, hr = ssd_reference(*torch_of(*ins))
    np.testing.assert_allclose(y.numpy(), yr.numpy(), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=2e-3, atol=2e-3)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_chunked(*torch_of(*ins), chunk=48)


def test_per_row_decay_rates_and_padding_are_exact():
    """A per batch row (the port's worker axis folded into the batch) equals
    running each row with its own A; the dt = 0 padding rows change
    nothing (the same scan on an S that the chunk divides)."""
    x, dt, A, B, C = torch_of(*make_inputs(3, 96, 2, 4, 8, 5))
    rates = torch.stack([A, 2 * A, 0.5 * A])
    y, h = ssd_scan(x, dt, rates, B, C, chunk=32)
    for r in range(3):
        yr, hr = ssd_scan(x[r:r + 1], dt[r:r + 1], rates[r], B[r:r + 1],
                          C[r:r + 1], chunk=32)
        torch.testing.assert_close(y[r:r + 1], yr, rtol=0, atol=0)
        torch.testing.assert_close(h[r:r + 1], hr, rtol=0, atol=0)
    yp, hp = ssd_scan(x[:, :80], dt[:, :80], rates, B[:, :80], C[:, :80],
                      chunk=32)
    yq, hq = ssd_scan(x[:, :80], dt[:, :80], rates, B[:, :80], C[:, :80],
                      chunk=16)
    torch.testing.assert_close(yp, yq, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(hp, hq, rtol=1e-5, atol=1e-5)


def test_binding_checks_operands():
    x, dt, A, B, C = torch_of(*make_inputs(1, 64, 2, 4, 8, 1))
    args = (x, dt, A.expand(1, 2).contiguous(), B[:, :, 0], C[:, :, 0])
    y, h = ssd_scan_chunked(*args, 32)
    yp, hp = ssd_scan_plain(*args, 32)
    assert torch.equal(y, yp) and torch.equal(h, hp)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ssd_scan_chunked(*args, 48)
    with pytest.raises(ValueError, match="A must be"):
        ssd_scan_chunked(args[0], args[1], A, *args[3:], 32)
    with pytest.raises(ValueError, match="float32"):
        ssd_scan_chunked(args[0].double(), *args[1:], 32)
    with pytest.raises(ValueError, match="one state group"):
        ssd_scan(x, dt, A, torch.cat([B, B], 2), torch.cat([C, C], 2))
    with pytest.raises(ValueError, match="runs on cuda"):
        ssd_scan_chunked(*(t.to("meta") for t in args), 32)
