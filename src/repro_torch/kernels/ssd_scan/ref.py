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


def ssd_scan_plain(x, dt, A, B, C, chunk: int):
    """The chunked scan in the kernel's layout: x (Bb,S,H,P), dt (Bb,S,H),
    A (Bb,H) (one decay rate per batch row and head), B/C (Bb,S,N) shared
    by the heads (G = 1, never broadcast); S % chunk == 0.

    What ``ssd_scan_pallas`` computes per chunk, in the kernel's
    stages: L and C·Bᵀ per (row, chunk); the chunk states; the state
    passing; the chunk output.  Returns (y (Bb,S,H,P), h_final
    (Bb,H,N,P))."""
    Bb, S, H, P = x.shape
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    lcum, cb = ssd_chunk_prep(dt, A, B, C, chunk)
    xdt = (x.reshape(Bb, nc, chunk, H, P)
           * dt.reshape(Bb, nc, chunk, H)[..., None])
    h_prev, h = ssd_state_passing(ssd_chunk_states(xdt, B, lcum), lcum)
    return ssd_chunk_output(xdt, C, lcum, cb, h_prev), h
