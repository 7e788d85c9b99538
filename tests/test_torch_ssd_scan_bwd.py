"""The SSD scan's gradient (the autograd Function around B5 whose
backward is B5b on the card) on the CPU, where both directions are the
plain versions, against ``jax.grad`` of the reference's chunked form
(models/ssm.py:67 ``ssd_chunked``) on the same numpy inputs; and the plain
backward (ref.ssd_scan_plain_bwd, which the card holds B5b to) against
``torch.autograd`` of the plain forward off the clip's ties.

Tolerance: each gradient within 1e-4 of its own largest magnitude (f32
sums over a chunk's Q·N or Q·P terms, which cancel, in another order).

The clip's ties: the reference clips every exponent to [-60, 0] with
``jnp.clip``, whose gradient at exactly -60 or 0 is half of exp's (JAX
splits a tie of max and min); ``torch.clamp`` would pass all of it.  The
port's backward follows the reference (ref.ddecay); the tie case shows
the two rules apart.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.ssm import ssd_chunked
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssd_scan.ref import (HEAD_GROUP, _decay, ddecay,
                                              ssd_bc_finish_bwd,
                                              ssd_dt_a_bwd,
                                              ssd_head_group_bwd,
                                              ssd_scan_plain,
                                              ssd_scan_plain_bwd,
                                              ssd_scan_plain_saved,
                                              ssd_scan_ref,
                                              ssd_state_walk_bwd)

TOL = 1e-4
NAMES = ("dx", "ddt", "dA", "dB", "dC")


def operands(case, Bb=2, S=32, H=4, P=8, N=6, seed=0):
    """numpy x (Bb,S,H,P), dt (Bb,S,H), A (H,), B/C (Bb,S,1,N), dy, dh."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((Bb, S, H, P)).astype(f32)
    dt = np.log1p(np.exp(rng.standard_normal((Bb, S, H)))).astype(f32)
    A = (-np.linspace(1.0, 16.0, H)).astype(f32)   # the init's -exp(A_log)
    B = rng.standard_normal((Bb, S, 1, N)).astype(f32)
    C = rng.standard_normal((Bb, S, 1, N)).astype(f32)
    if case == "clip":
        # dt·A sums below -60 within a chunk: most exponents clip
        dt = (1.0 + np.abs(dt)).astype(f32)
        A = (-np.linspace(4.0, 30.0, H)).astype(f32)
    elif case == "cancelling":
        # x alternating in sign over B, C that share a large constant
        # component, slow decay: y is a small part of its terms
        sign = (-1.0) ** np.arange(S)
        x = (sign[None, :, None, None]
             * (1 + 0.1 * rng.standard_normal((Bb, S, H, P)))).astype(f32)
        dt = (0.05 + 0.001 * rng.random((Bb, S, H))).astype(f32)
        A = (-0.01 * np.linspace(1.0, 4.0, H)).astype(f32)
        B = (1 + 0.01 * rng.standard_normal((Bb, S, 1, N))).astype(f32)
        C = (1 + 0.01 * rng.standard_normal((Bb, S, 1, N))).astype(f32)
    elif case == "tie":
        # exact ties of the clip: dt = 0 rows (L_i - L_j = 0 and L_i = 0
        # exactly) and dt·A = -60 exactly at the start of a chunk
        dt[:, ::3] = 0.0
        dt[:, 8] = 2.0
        A[0] = -30.0
    dy = rng.standard_normal((Bb, S, H, P)).astype(f32)
    dh = rng.standard_normal((Bb, H, N, P)).astype(f32)
    return x, dt, A, B, C, dy, dh


def reference_grads(x, dt, A, B, C, dy, dh, chunk):
    """jax.vjp of the reference's ssd_chunked; dh None is a zero
    cotangent of the final state."""
    (_, h), vjp = jax.vjp(lambda *a: ssd_chunked(*a, chunk),
                          *map(jnp.asarray, (x, dt, A, B, C)))
    ct_h = jnp.zeros_like(h) if dh is None else jnp.asarray(dh)
    return [np.asarray(g) for g in vjp((jnp.asarray(dy), ct_h))]


def port_grads(x, dt, A, B, C, dy, dh, chunk):
    """Gradients through ops.ssd_scan (the model's entry point: A (H,),
    B and C (Bb, S, 1, N))."""
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, B, C)]
    y, h = ssd_scan(*ins, chunk=chunk)
    loss = (y * torch.from_numpy(dy)).sum()
    if dh is not None:
        loss = loss + (h * torch.from_numpy(dh)).sum()
    loss.backward()
    return [t.grad.numpy() for t in ins]


def assert_close(ours, ref, name):
    scale = np.abs(ref).max()
    err = np.abs(ours - ref).max()
    assert ours.shape == ref.shape, name
    assert np.isfinite(ours).all() and err <= TOL * scale, (name, err, scale)


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("case", ["ordinary", "clip", "cancelling", "tie"])
def test_gradient_matches_jax_grad_of_the_reference(case, with_dh):
    x, dt, A, B, C, dy, dh = operands(case)
    dh = dh if with_dh else None
    ref = reference_grads(x, dt, A, B, C, dy, dh, 8)
    ours = port_grads(x, dt, A, B, C, dy, dh, 8)
    for name, a, b in zip(NAMES, ours, ref):
        assert_close(a, b, name)


def test_the_tie_rule_shows():
    """At the tie input, torch.clamp's rule (all of exp's gradient at a
    bound) misses the reference's ddt by far more than the tolerance; the
    port's half rule meets it."""
    x, dt, A, B, C, dy, dh = operands("tie")
    v = torch.tensor([-61.0, -60.0, -1.0, 0.0, 1.0])
    np.testing.assert_allclose(
        ddecay(v).numpy(), [0.0, 0.5 * np.exp(-60.0), np.exp(-1.0), 0.5, 0.0],
        rtol=1e-6)
    ref = reference_grads(x, dt, A, B, C, dy, dh, 8)
    ins = [torch.tensor(a, requires_grad=True)
           for a in (x, dt, np.broadcast_to(A, (2, 4)).copy(), B[:, :, 0],
                     C[:, :, 0])]
    y, h = ssd_scan_plain(*ins, 8)
    ((y * torch.from_numpy(dy)).sum()
     + (h * torch.from_numpy(dh)).sum()).backward()
    clamp_err = np.abs(ins[1].grad.numpy() - ref[1]).max()
    assert clamp_err > 100 * TOL * np.abs(ref[1]).max()
    assert_close(port_grads(x, dt, A, B, C, dy, dh, 8)[1], ref[1], "ddt")


@pytest.mark.parametrize("chunk", [8, 16])
def test_plain_backward_matches_autograd_of_the_plain_forward(chunk):
    """Off the ties the clip rules agree: the written-out backward equals
    torch.autograd of ssd_scan_plain, with a decay rate per batch row."""
    Bb, S, H, P, N = 3, 48, 2, 5, 7
    g = torch.Generator().manual_seed(chunk)
    x = torch.randn((Bb, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((Bb, S, H), generator=g))
    A = -torch.rand((Bb, H), generator=g) * 4 - 0.1
    B = torch.randn((Bb, S, N), generator=g)
    C = torch.randn((Bb, S, N), generator=g)
    dy = torch.randn((Bb, S, H, P), generator=g)
    dh = torch.randn((Bb, H, N, P), generator=g)
    ins = [t.clone().requires_grad_() for t in (x, dt, A, B, C)]
    y, h = ssd_scan_plain(*ins, chunk)
    auto = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), ins)
    _, _, L, h_prev = ssd_scan_plain_saved(x, dt, A, B, C, chunk)
    ours = ssd_scan_plain_bwd(x, dt, A, B, C, L, h_prev, dy, dh, chunk)
    for name, a, b in zip(NAMES, ours, auto):
        assert_close(a.numpy(), b.numpy(), name)


def test_padded_and_strided_operands_differentiate():
    """ops.ssd_scan pads S to a chunk multiple and reads x, B and C as
    views of one conv output: the gradient reaches that output through
    the pad and the views, equal to autograd of the sequential recurrence
    (no clip binds, no tie among the real rows)."""
    Bb, S, H, P, N = 2, 30, 3, 4, 5
    g = torch.Generator().manual_seed(3)
    xbc = torch.randn((Bb, S, H * P + 2 * N), generator=g)
    dt = 0.1 + torch.rand((Bb, S, H), generator=g)
    A = -torch.linspace(0.5, 2.0, H)
    dy = torch.randn((Bb, S, H, P), generator=g)
    dh = torch.randn((Bb, H, N, P), generator=g)

    def run(fn):
        leaf = xbc.clone().requires_grad_()
        x = leaf[..., :H * P].reshape(Bb, S, H, P)
        Bv, Cv = leaf[..., H * P:H * P + N], leaf[..., H * P + N:]
        d = dt.clone().requires_grad_()
        y, h = fn(x, d, A, Bv[:, :, None], Cv[:, :, None])
        ((y * dy).sum() + (h * dh).sum()).backward()
        return leaf.grad, d.grad

    ours = run(lambda *a: ssd_scan(*a, chunk=8))
    seq = run(ssd_scan_ref)
    for a, b in zip(ours, seq):
        assert_close(a.numpy(), b.numpy(), "grad")


def head_walk_bwd(x, dt, B, C, L, h_prev, dh, dy):
    """The per-(row, chunk) head walk of the first backward kernel: every
    head's dx, Σ_p dxdt·x and dL, then dB and dC with the heads summed in
    one reduction.  Returns (dx, ddt_x, dL, dB, dC)."""
    Bb, nc, Q, H = L.shape
    S, P, N = x.shape[1], x.shape[-1], B.shape[-1]
    Bc, Cc = B.reshape(Bb, nc, Q, N), C.reshape(Bb, nc, Q, N)
    xdt = x.reshape(Bb, nc, Q, H, P) * dt.reshape(Bb, nc, Q, H)[..., None]
    dyc = dy.reshape(Bb, nc, Q, H, P)
    li = L.transpose(2, 3)
    v = li[..., :, None] - li[..., None, :]
    G = torch.einsum("bcihp,bcjhp->bchij", dyc, xdt)
    tri = torch.ones((Q, Q), dtype=torch.bool).tril()
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, :, None]
    lq = L[:, :, -1:]
    BD = torch.einsum("bcjn,bchnp->bcjhp", Bc, dh)
    dxdt = (torch.einsum("bchij,bcihp->bcjhp", cb * _decay(v) * tri, dyc)
            + _decay(lq - L)[..., None] * BD)
    dx = dxdt * dt.reshape(Bb, nc, Q, H)[..., None]
    ddt_x = (dxdt * x.reshape(Bb, nc, Q, H, P)).sum(-1)
    dv = cb * G * ddecay(v) * tri.tril(-1)
    dL = (dv.sum(-1) - dv.sum(-2)).transpose(2, 3)
    CH = torch.einsum("bcin,bchnp->bcihp", Cc, h_prev)
    dL = dL + ddecay(L) * (dyc * CH).sum(-1)
    ds = (ddecay(lq - L) * (xdt * BD).sum(-1))[:, :, :-1]
    dL = torch.cat([dL[:, :, :-1] - ds,
                    dL[:, :, -1:] + ds.sum(2, keepdim=True)], dim=2)
    dL[:, :, -1] += ddecay(lq[:, :, 0]) * (dh * h_prev).sum((-1, -2))
    dcb = (_decay(v) * G * tri).sum(2)
    dC = (torch.einsum("bcij,bcjn->bcin", dcb, Bc)
          + torch.einsum("bcihp,bchnp->bcin", _decay(L)[..., None] * dyc,
                         h_prev))
    dB = (torch.einsum("bcij,bcin->bcjn", dcb, Cc)
          + torch.einsum("bcjhp,bchnp->bcjn",
                         _decay(lq - L)[..., None] * xdt, dh))
    return (dx.reshape(Bb, S, H, P), ddt_x.reshape(Bb, S, H), dL,
            dB.reshape(Bb, S, N), dC.reshape(Bb, S, N))


@pytest.mark.parametrize("group", [1, HEAD_GROUP, "H"])
def test_head_groups_match_the_per_chunk_head_walk(group):
    """The head stage's group split (per group of heads: E∘G, U_C, U_B
    added in order; the groups added in order by the finish) gives the
    gradients of the per-(row, chunk) head walk, within 1e-6 of each
    gradient's largest magnitude, whatever the group size — a ragged last
    group included (H = 6)."""
    Bb, S, H, P, N, chunk = 2, 48, 6, 5, 7, 16
    group = H if group == "H" else group
    g = torch.Generator().manual_seed(11)
    x = torch.randn((Bb, S, H, P), generator=g)
    dt = torch.nn.functional.softplus(torch.randn((Bb, S, H), generator=g))
    A = -torch.rand((Bb, H), generator=g) * 4 - 0.1
    B = torch.randn((Bb, S, N), generator=g)
    C = torch.randn((Bb, S, N), generator=g)
    dy = torch.randn((Bb, S, H, P), generator=g)
    dhf = torch.randn((Bb, H, N, P), generator=g)
    _, _, L, h_prev = ssd_scan_plain_saved(x, dt, A, B, C, chunk)
    dh = ssd_state_walk_bwd(dy, C, L, dhf)
    dx, ddt_x, dL, parts = ssd_head_group_bwd(x, dt, B, C, L, h_prev, dh,
                                              dy, group)
    assert parts[0].shape[2] == -(-H // group)
    ddt, dA = ssd_dt_a_bwd(dt, A, ddt_x, dL)
    ours = (dx, ddt, dA, *ssd_bc_finish_bwd(B, C, parts))
    wx, wddt_x, wdL, wdB, wdC = head_walk_bwd(x, dt, B, C, L, h_prev, dh,
                                              dy)
    want = (wx, *ssd_dt_a_bwd(dt, A, wddt_x, wdL), wdB, wdC)
    for name, a, b in zip(NAMES, ours, want):
        err = float((a - b).abs().max())
        assert err <= 1e-6 * float(b.abs().max()), (name, err)
