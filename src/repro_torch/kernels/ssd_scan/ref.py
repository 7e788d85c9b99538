"""Plain-torch versions of the Mamba-2 chunked SSD scan (kernel B5).

:func:`ssd_scan_ref` ports the reference's oracle, the sequential
recurrence (``kernels/ssd_scan/ref.py:8``, which delegates to
``models/ssm.py:130 ssd_reference``).  :func:`ssd_scan_plain` is the
chunked form in the kernel's operand layout, its clips and its stages —
:func:`ssd_chunk_prep`, :func:`ssd_chunk_states`, :func:`ssd_state_passing`
(the kernel fuses these two: one launch walks the chunks with the state in
its accumulators), :func:`ssd_chunk_output` — so the CPU tests hold the
kernel's decomposition itself against the reference: what the wrapper runs
for CPU tensors and what chip_smoke.py holds the kernel against on the
card.

:func:`ssd_scan_plain_bwd` is the gradient of the chunked scan (kernel
B5b), written out in B5b's stages: :func:`ssd_state_walk_bwd` (the state
passing walked backward), :func:`ssd_head_group_bwd` (per row, chunk and
head: dx, dt's share from x, the log-decay's adjoint, and per group of
heads the partial sums that dB and dC need) and :func:`ssd_bc_finish_bwd`
(per row and chunk: the groups' partials added in order, then dB and dC).
The reference has no backward kernel: it differentiates its jnp chunked
form (``models/ssm.py:67 ssd_chunked``) with ``jax.grad``, and this
follows that gradient, clip ties included (:func:`ddecay`).
"""
from __future__ import annotations

import torch

CLIP = -60.0   # every decay exponent is clipped to [CLIP, 0], as on the TPU


def ssd_scan_ref(x, dt, A, B, C):
    """x: (B,S,H,P), dt: (B,S,H), A: (H,), B/C: (B,S,1,N).

    h_t = exp(dt_t A) h_{t-1} + dt_t (B_t ⊗ x_t);  y_t = C_t · h_t.
    Returns (y (B,S,H,P), h_final (B,H,N,P))."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    Bm, Cm = B[:, :, 0], C[:, :, 0]
    h = x.new_zeros((Bb, H, N, P))
    ys = []
    for t in range(S):
        a = torch.exp(dt[:, t] * A[None, :])                 # (B,H)
        upd = torch.einsum("bk,bhp->bhkp", Bm[:, t],
                           x[:, t] * dt[:, t][..., None])
        h = h * a[..., None, None] + upd
        ys.append(torch.einsum("bk,bhkp->bhp", Cm[:, t], h))
    return torch.stack(ys, dim=1), h


def _decay(v):
    return torch.exp(torch.clamp(v, CLIP, 0.0))


def ddecay(v):
    """d exp(clip(v, CLIP, 0)) / dv as ``jax.grad`` takes it through
    ``jnp.clip``: exp(v) strictly inside the range, 0 outside, and half
    of exp(v) at exactly CLIP or 0 (JAX splits a tie of max and min
    between its operands; ``torch.clamp`` would give all of it)."""
    e = torch.exp(torch.clamp(v, CLIP, 0.0))
    inside = (v > CLIP) & (v < 0.0)
    tie = (v == CLIP) | (v == 0.0)
    return torch.where(inside, e, torch.where(tie, 0.5 * e,
                                              torch.zeros_like(e)))


def ssd_chunk_prep(dt, A, B, C, chunk: int):
    """Stage (a), per (row, chunk): the cumulative log-decay of every head,
    L (Bb, nc, Q, H), and C·Bᵀ (Bb, nc, Q, Q), once for all the heads."""
    Bb, S, H = dt.shape
    nc = S // chunk
    lcum = torch.cumsum(dt.reshape(Bb, nc, chunk, H) * A[:, None, None, :],
                        dim=2)
    cb = torch.einsum("bcin,bcjn->bcij", C.reshape(Bb, nc, chunk, -1),
                      B.reshape(Bb, nc, chunk, -1))
    return lcum, cb


def ssd_chunk_states(xdt, B, lcum):
    """Stage (b), per (row, chunk, head): the chunk state S_c = (B ∘
    exp(L_Q − L))ᵀ·(x·dt), (Bb, nc, H, N, P); xdt (Bb, nc, Q, H, P)."""
    Bb, nc, Q, H = lcum.shape
    w = _decay(lcum[:, :, -1:] - lcum)                   # (Bb,nc,Q,H)
    bw = B.reshape(Bb, nc, Q, 1, -1) * w[..., None]      # (Bb,nc,Q,H,N)
    return torch.einsum("bcjhn,bcjhp->bchnp", bw, xdt)


def ssd_state_passing(states, lcum):
    """Stage (c), per (row, head), the one serial step: h_c = exp(L_Q of
    chunk c)·h_{c−1} + S_c over the chunks, elementwise.  Returns (h_prev
    (Bb, nc, H, N, P), the state before each chunk, and the final h)."""
    dec = _decay(lcum[:, :, -1])                         # (Bb,nc,H)
    h = torch.zeros_like(states[:, 0])
    prev = []
    for c in range(states.shape[1]):
        prev.append(h)
        h = dec[:, c, :, None, None] * h + states[:, c]
    return torch.stack(prev, dim=1), h


def ssd_chunk_output(xdt, C, lcum, cb, h_prev):
    """Stage (d), per (row, chunk, head): y = ((C·Bᵀ) ∘ exp(L_i − L_j) ∘
    tril)·(x·dt) + exp(L_i)·C·h_prev.  Returns y (Bb, S, H, P)."""
    Bb, nc, Q, H = lcum.shape
    tri = torch.ones((Q, Q), dtype=torch.bool, device=lcum.device).tril()
    li = lcum.transpose(2, 3)                            # (Bb,nc,H,Q)
    gamma = (cb[:, :, None] * _decay(li[..., :, None] - li[..., None, :])
             * tri)                                      # (Bb,nc,H,Q,Q)
    y = torch.einsum("bchij,bcjhp->bcihp", gamma, xdt)
    y = y + _decay(lcum)[..., None] * torch.einsum(
        "bcin,bchnp->bcihp", C.reshape(Bb, nc, Q, -1), h_prev)
    return y.reshape(Bb, nc * Q, H, -1)


def ssd_scan_plain_saved(x, dt, A, B, C, chunk: int):
    """:func:`ssd_scan_plain` that also returns what its backward reads:
    (y, h_final, L (Bb, nc, Q, H), h_prev (Bb, nc, H, N, P))."""
    Bb, S, H, P = x.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    lcum, cb = ssd_chunk_prep(dt, A, B, C, chunk)
    xdt = (x.reshape(Bb, nc, chunk, H, P)
           * dt.reshape(Bb, nc, chunk, H)[..., None])
    h_prev, h = ssd_state_passing(ssd_chunk_states(xdt, B, lcum), lcum)
    return ssd_chunk_output(xdt, C, lcum, cb, h_prev), h, lcum, h_prev


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """The chunked scan in the kernel's layout: x (Bb,S,H,P), dt (Bb,S,H),
    A (Bb,H) (one decay rate per batch row and head), B/C (Bb,S,N) shared
    by the heads (G = 1, never broadcast); S % chunk == 0.

    What ``ssd_scan_pallas`` computes per chunk, in the kernel's
    stages: L and C·Bᵀ per (row, chunk); the chunk states; the state
    passing; the chunk output.  Returns (y (Bb,S,H,P), h_final
    (Bb,H,N,P))."""
    return ssd_scan_plain_saved(x, dt, A, B, C, chunk)[:2]


# ---------------------------------------------------------------------------
# the backward (B5b's stages).  Per chunk c, with L the in-chunk cumulative
# dt·A, xdt = x·dt and dh_c the adjoint of the state after chunk c:
#   dh_{c-1} = exp(L_Q) dh_c + sum_i exp(L_i) C_i (x) dy_i
#   dxdt_j   = sum_{i>=j} (C_i.B_j) exp(L_i - L_j) dy_i + exp(L_Q - L_j) B_j.dh_c
# and each exponent's weight goes into dL: + at its row index, - at its
# column index.  The diagonal exponents (L_i - L_i, L_Q - L_{Q-1}) are
# ties whose two halves cancel; they are left out.
# ---------------------------------------------------------------------------


def ssd_state_walk_bwd(dy, C, lcum, dh_final):
    """Stage (a), per (row, head), chunks in reverse: dh (Bb, nc, H, N, P),
    the adjoint of the state after each chunk, seeded by ``dh_final``
    (None: zero).  dy (Bb, S, H, P), C (Bb, S, N), lcum (Bb, nc, Q, H)."""
    Bb, nc, Q, H = lcum.shape
    P, N = dy.shape[-1], C.shape[-1]
    inj = torch.einsum("bcin,bcihp->bchnp", C.reshape(Bb, nc, Q, N),
                       _decay(lcum)[..., None] * dy.reshape(Bb, nc, Q, H, P))
    dec = _decay(lcum[:, :, -1])                         # (Bb,nc,H)
    dh = (dy.new_zeros((Bb, H, N, P)) if dh_final is None else dh_final)
    out = [None] * nc
    for c in reversed(range(nc)):
        out[c] = dh
        dh = dec[:, c, :, None, None] * dh + inj[:, c]
    return torch.stack(out, dim=1)


HEAD_GROUP = 8   # heads a block of B5b's head stage walks (GH in the source)


def _group_sums(t, group):
    """t (Bb, nc, H, ...) -> (Bb, nc, ceil(H / group), ...): the heads of
    each group of ``group`` consecutive heads added in order, as B5b's head
    stage adds them."""
    H = t.shape[2]
    out = []
    for h0 in range(0, H, group):
        s = t[:, :, h0]
        for h in range(h0 + 1, min(H, h0 + group)):
            s = s + t[:, :, h]
        out.append(s)
    return torch.stack(out, dim=2)


def ssd_head_group_bwd(x, dt, B, C, lcum, h_prev, dh, dy, group=HEAD_GROUP):
    """Stage (b), per (row, chunk, head), the heads in groups of ``group``:
    with G = dy·xdtᵀ over the lower triangle,
      dxdt = (C·Bᵀ ∘ E ∘ tril)ᵀ·dy + diag(E(L_Q − L))·B·dh_c  -> dx, Σ_p dxdt·x
      U_C  = dy·h_prevᵀ,  U_B = xdt·dh_cᵀ                        (Q × N)
    and the head's dL terms: the row sums (+) and column sums (−) of
    C·Bᵀ ∘ G ∘ E′ below the diagonal, E′(L_i)·C_i·U_C,i, −E′(L_Q − L_j)·
    B_j·U_B,j (j < Q − 1; their sum to dL_{Q−1}) and E′(L_Q)·<dh_c,
    h_prev>.  Per group, the heads added in order: E ∘ G ∘ tril, diag(E(L))
    ·U_C and diag(E(L_Q − L))·U_B.  Returns (dx (Bb,S,H,P), Σ_p dxdt·x
    (Bb,S,H), dL (Bb,nc,Q,H), (E∘G (Bb,nc,ng,Q,Q), U_C, U_B
    (Bb,nc,ng,Q,N))), ng = ceil(H / group)."""
    Bb, nc, Q, H = lcum.shape
    S, P, N = x.shape[1], x.shape[-1], B.shape[-1]
    Bc, Cc = B.reshape(Bb, nc, Q, N), C.reshape(Bb, nc, Q, N)
    xdt = (x.reshape(Bb, nc, Q, H, P)
           * dt.reshape(Bb, nc, Q, H)[..., None])
    dyc = dy.reshape(Bb, nc, Q, H, P)
    li = lcum.transpose(2, 3)                            # (Bb,nc,H,Q)
    lq = li[..., -1:]                                    # (Bb,nc,H,1)
    v = li[..., :, None] - li[..., None, :]              # (Bb,nc,H,Q,Q)
    tri = torch.ones((Q, Q), dtype=torch.bool, device=x.device).tril()
    cb = torch.einsum("bcin,bcjn->bcij", Cc, Bc)[:, :, None]
    G = torch.einsum("bcihp,bcjhp->bchij", dyc, xdt) * tri
    BD = torch.einsum("bcjn,bchnp->bchjp", Bc, dh)       # B_j.dh_c
    dxdt = (torch.einsum("bchij,bcihp->bchjp", cb * _decay(v) * tri, dyc)
            + _decay(lq - li)[..., None] * BD)           # (Bb,nc,H,Q,P)
    dxdt = dxdt.transpose(2, 3)                          # (Bb,nc,Q,H,P)
    dx = dxdt * dt.reshape(Bb, nc, Q, H)[..., None]
    ddt_x = (dxdt * x.reshape(Bb, nc, Q, H, P)).sum(-1)
    uc = torch.einsum("bcihp,bchnp->bchin", dyc, h_prev)
    ub = torch.einsum("bcjhp,bchnp->bchjn", xdt, dh)
    # dL: the intra-chunk exponents (strictly below the diagonal) ...
    dv = cb * G * ddecay(v) * tri.tril(-1)
    dL = dv.sum(-1) - dv.sum(-2)                         # (Bb,nc,H,Q)
    # ... E(L_i) of C_i.h_prev ...
    dL = dL + ddecay(li) * (Cc[:, :, None] * uc).sum(-1)
    # ... E(L_Q - L_j) of the chunk state (j < Q - 1) ...
    ds = (ddecay(lq - li) * (Bc[:, :, None] * ub).sum(-1))[..., :-1]
    dL = torch.cat([dL[..., :-1] - ds,
                    dL[..., -1:] + ds.sum(-1, keepdim=True)], dim=-1)
    # ... and E(L_Q) of the state passing
    dL[..., -1] += ddecay(lq[..., 0]) * (dh * h_prev).sum((-1, -2))
    parts = (_group_sums(_decay(v) * G, group),
             _group_sums(_decay(li)[..., None] * uc, group),
             _group_sums(_decay(lq - li)[..., None] * ub, group))
    return (dx.reshape(Bb, S, H, P), ddt_x.reshape(Bb, S, H),
            dL.transpose(2, 3), parts)


def ssd_bc_finish_bwd(B, C, parts):
    """Stage (c), per (row, chunk): the head groups' partials added in
    order, then dC = Dcb·B + U_C and dB = Dcbᵀ·C + U_B, Dcb = Σ_h E ∘ G ∘
    tril.  ``parts`` as :func:`ssd_head_group_bwd` returns them.  Returns
    (dB, dC) (Bb, S, N)."""
    dcb, uc, ub = (_group_sums(t, t.shape[2]).squeeze(2) for t in parts)
    Bb, nc, Q, N = uc.shape
    Bc, Cc = B.reshape(Bb, nc, Q, N), C.reshape(Bb, nc, Q, N)
    dC = torch.einsum("bcij,bcjn->bcin", dcb, Bc) + uc
    dB = torch.einsum("bcij,bcin->bcjn", dcb, Cc) + ub
    return dB.reshape(Bb, nc * Q, N), dC.reshape(Bb, nc * Q, N)


def ssd_dt_a_bwd(dt, A, ddt_x, dL):
    """Stage (d): dL through the in-chunk cumulative sum to d(dt·A), then
    ddt = ddt_x + d(dt·A)·A and dA[b, h] = Σ_s d(dt·A)·dt.  Returns (ddt
    (Bb,S,H), dA (Bb,H))."""
    Bb, nc, Q, H = dL.shape
    dla = dL.flip(2).cumsum(2).flip(2).reshape(Bb, nc * Q, H)
    return ddt_x + dla * A[:, None, :], (dla * dt).sum(1)


def ssd_scan_plain_bwd(x, dt, A, B, C, L, h_prev, dy, dh_final, chunk: int):
    """Gradients of :func:`ssd_scan_plain` (what B5b computes), in its
    stages.  x, dt, A (Bb,H), B, C as the forward took them; L (Bb, nc, Q,
    H) and h_prev (Bb, nc, H, N, P) as :func:`ssd_scan_plain_saved` returns
    them; dy (Bb,S,H,P); dh_final (Bb,H,N,P) or None (zero).  Every clipped
    exponent passes its gradient by :func:`ddecay`.  Returns (dx, ddt, dA
    (Bb,H), dB, dC)."""
    if x.shape[1] % chunk or L.shape[2] != chunk:
        raise ValueError(f"S={x.shape[1]} and L {tuple(L.shape)} do not "
                         f"match chunk={chunk}")
    dh = ssd_state_walk_bwd(dy, C, L, dh_final)
    dx, ddt_x, dL, parts = ssd_head_group_bwd(x, dt, B, C, L, h_prev, dh,
                                              dy)
    dB, dC = ssd_bc_finish_bwd(B, C, parts)
    ddt, dA = ssd_dt_a_bwd(dt, A, ddt_x, dL)
    return dx, ddt, dA, dB, dC
