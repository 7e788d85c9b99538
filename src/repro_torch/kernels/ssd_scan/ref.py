"""Plain-torch versions of the Mamba-2 chunked SSD scan (kernel B5).

:func:`ssd_scan_ref` ports the reference's oracle, the sequential
recurrence (``kernels/ssd_scan/ref.py:8``, which delegates to
``models/ssm.py:130 ssd_reference``).  :func:`ssd_scan_plain` is the
chunked form with the kernel's own dataflow and clips, in the kernel's
operand layout: what the wrapper runs for CPU tensors and what
chip_smoke.py holds the kernel against on the card.
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


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """The chunked scan in the kernel's layout: x (Bb,S,H,P), dt (Bb,S,H),
    A (Bb,H) (one decay rate per batch row and head), B/C (Bb,S,N) shared
    by the heads (G = 1, never broadcast); S % chunk == 0.

    Per chunk, as ``ssd_scan_pallas`` computes it: the cumulative log-decay
    L, the intra-chunk term ((C·Bᵀ) ∘ exp(L_i − L_j) ∘ tril)·(x·dt), plus
    exp(L_i)·C·h_prev, then h ← exp(L_tot)·h + (B ∘ exp(L_tot − L))ᵀ·(x·dt).
    Returns (y (Bb,S,H,P), h_final (Bb,H,N,P))."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    tri = torch.ones((chunk, chunk), dtype=torch.bool, device=x.device).tril()
    h = x.new_zeros((Bb, H, N, P))
    ys = []
    for s0 in range(0, S, chunk):
        sl = slice(s0, s0 + chunk)
        dtc = dt[:, sl]                                      # (Bb,Q,H)
        Bc, Cc = B[:, sl], C[:, sl]                          # (Bb,Q,N)
        lcum = torch.cumsum(dtc * A[:, None, :], dim=1)      # L_i (Bb,Q,H)
        ltot = lcum[:, -1]                                   # (Bb,H)
        xdt = x[:, sl] * dtc[..., None]                      # (Bb,Q,H,P)
        li = lcum.transpose(1, 2)                            # (Bb,H,Q)
        cb = torch.einsum("bin,bjn->bij", Cc, Bc)            # (Bb,Q,Q)
        gamma = (cb[:, None] * _decay(li[..., :, None] - li[..., None, :])
                 * tri)                                      # (Bb,H,Q,Q)
        y = torch.einsum("bhij,bjhp->bihp", gamma, xdt)
        y = y + _decay(lcum)[..., None] * torch.einsum(
            "bin,bhnp->bihp", Cc, h)
        bw = Bc[:, :, None, :] * _decay(ltot[:, None] - lcum)[..., None]
        s_c = torch.einsum("bjhn,bjhp->bhnp", bw, xdt)       # (Bb,H,N,P)
        h = _decay(ltot)[..., None, None] * h + s_c
        ys.append(y)
    return torch.cat(ys, dim=1), h
