"""The port's SSD scan (kernels/ssd_scan: the plain version on the CPU)
against the reference's ``ssd_scan`` (its Pallas kernel in interpret mode)
and its sequential oracle ``ssd_scan_ref``, on the reference test's five
shapes (padding included), the decay extremes, and the two chunked forms
of the models; the plain version's stages (the kernel's decomposition)
against both; the kernel's strided operands.  Inputs made from a seed with
numpy.

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
from repro_torch.kernels.ssd_scan.kernel import row_strides
from repro_torch.kernels.ssd_scan.ops import kernel_operands
from repro_torch.kernels.ssd_scan.ref import (ssd_chunk_prep,
                                              ssd_chunk_states,
                                              ssd_scan_plain, ssd_scan_ref,
                                              ssd_state_passing)
from repro_torch.models.ssm import ssd_chunked, ssd_reference
from _torch_threads import one_torch_thread  # noqa: F401

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
    # meta operands (the dry-run) give the outputs' shapes; operands on
    # several devices raise
    y, h = ssd_scan_chunked(*(t.to("meta") for t in args), 32)
    assert y.device.type == "meta" and y.shape == args[0].shape
    with pytest.raises(ValueError, match="several devices"):
        ssd_scan_chunked(args[0].to("meta"), *args[1:], 32)


def kernel_layout(x, dt, A, B, C):
    """The kernel's operand layout: A per row, B and C without the group."""
    return x, dt, A.expand(x.shape[0], -1).contiguous(), B[:, :, 0], C[:, :, 0]


@pytest.mark.parametrize("shape", [s for s in SHAPES if s[1] % s[5] == 0],
                         ids=lambda s: "x".join(map(str, s)))
def test_staged_plain_matches_reference_kernel_and_model_form(shape):
    """The plain version in the kernel's stages against the
    reference's Pallas kernel (interpret mode) and the port's model form
    ``ssd_chunked``."""
    Bb, S, H, P, N, chunk = shape
    ins = make_inputs(Bb, S, H, P, N, 3 * sum(shape))
    y, h = ssd_scan_plain(*kernel_layout(*torch_of(*ins)), chunk)
    yk, hk = jssd_scan(*map(jnp.asarray, ins), chunk=chunk)
    assert_near(y, yk)
    assert_near(h, hk)
    ym, hm = ssd_chunked(*torch_of(*ins), chunk=chunk)
    assert_near(y, ym)
    assert_near(h, hm)


@pytest.mark.parametrize("chunk", [8, 32, 64])
def test_state_passing_matches_sequential_oracle_at_chunk_ends(chunk):
    """Stage (c)'s state before each chunk is the sequential recurrence's
    state after the chunk before it (its run on the prefix)."""
    Bb, S, H, P, N = 2, 128, 3, 8, 16
    x, dt, A, B, C = torch_of(*make_inputs(Bb, S, H, P, N, chunk))
    xk, dtk, Ak, Bk, Ck = kernel_layout(x, dt, A, B, C)
    lcum, cb = ssd_chunk_prep(dtk, Ak, Bk, Ck, chunk)
    nc = S // chunk
    assert lcum.shape == (Bb, nc, chunk, H) and cb.shape == (Bb, nc, chunk,
                                                             chunk)
    xdt = (xk.reshape(Bb, nc, chunk, H, P)
           * dtk.reshape(Bb, nc, chunk, H)[..., None])
    h_prev, h = ssd_state_passing(ssd_chunk_states(xdt, Bk, lcum), lcum)
    assert h_prev.shape == (Bb, nc, H, N, P)
    assert not bool(h_prev[:, 0].any())
    for c in range(1, nc):
        s = c * chunk
        _, hr = ssd_scan_ref(x[:, :s], dt[:, :s], A, B[:, :s], C[:, :s])
        np.testing.assert_allclose(h_prev[:, c].numpy(), hr.numpy(),
                                   rtol=2e-3, atol=2e-3)
    _, hr = ssd_scan_ref(x, dt, A, B, C)
    np.testing.assert_allclose(h.numpy(), hr.numpy(), rtol=2e-3, atol=2e-3)


def conv_views(Bb, S, H, P, N, seed, offset=0):
    """x, B, C as views of one (Bb, S, offset + H P + 2 N) conv output, the
    model's layout (``models/ssm.py apply_ssd``), and dt, A."""
    rng = np.random.default_rng(seed)
    xbc = torch.from_numpy(rng.standard_normal(
        (Bb, S, offset + H * P + 2 * N)).astype(np.float32))[..., offset:]
    x = xbc[..., :H * P].reshape(Bb, S, H, P)
    B, C = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    _, dt, A, _, _ = torch_of(*make_inputs(Bb, S, H, P, N, seed))
    return x, dt, A, B[:, :, None], C[:, :, None]


def test_strided_operands_give_the_contiguous_result():
    """The conv output's views go through ops.ssd_scan as they are (the
    kernel reads them at their row stride) and give the y and h of their
    contiguous copies."""
    x, dt, A, B, C = conv_views(2, 64, 4, 8, 16, 7)
    assert row_strides(x, B[:, :, 0], C[:, :, 0]) == (64, 64)
    y, h = ssd_scan(x, dt, A, B, C, chunk=32)
    yc, hc = ssd_scan(x.contiguous(), dt, A, B.contiguous(), C.contiguous(),
                      chunk=32)
    assert_near(y, yc, tol=1e-6)
    assert_near(h, hc, tol=1e-6)


def test_kernel_operands_copy_only_what_async_copies_cannot_read():
    """Views whose rows lie at one stride pass uncopied, whether or not they
    start on 16 bytes (the kernel then copies 4 bytes at a time); a layout
    other than rows at one stride gets the contiguous copy."""
    x, _, _, B, C = conv_views(2, 64, 4, 8, 16, 1)
    x1, _, _, B1, C1 = conv_views(2, 64, 4, 8, 16, 1, offset=1)
    for ops in ((x, B[:, :, 0], C[:, :, 0]),
                (x1, B1[:, :, 0], C1[:, :, 0])):
        out = kernel_operands(*ops)
        assert [t.data_ptr() for t in out] == [t.data_ptr() for t in ops]
    B, C = B[:, :, 0], C[:, :, 0]
    for ops in ((x, B.transpose(1, 2).contiguous().transpose(1, 2), C),
                (x, B, C.contiguous())):
        assert row_strides(*ops) is None
        out = kernel_operands(*ops)
        assert all(t.is_contiguous() for t in out)
        assert all(torch.equal(a, b) for a, b in zip(out, ops))
        assert row_strides(*out) == (32, 16)
