"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

The sequence mixer of mamba2-370m.  The forward pass runs the chunked SSD
scan through :func:`repro_torch.kernels.ssd_scan.ssd_scan` — kernel B5 on
the card, its plain version on the CPU — where the reference runs its jnp
chunked form :func:`ssd_chunked` (kept here for the tests; the reference's
own tests hold the two forms together).  Decode is one recurrence step in
plain torch, as in the reference.

Worker batching as in common.py: params carry a leading worker axis (W,
...) and activations are (W, B, S, D); one model is W = 1.  Shapes (per
worker): x (B,S,H,P) with heads*head_dim = d_inner; B, C (B,S,G,N) with
G = 1 state group shared by the heads; dt (B,S,H); A (H,) < 0.

Recurrence:   h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t ⊗ x_t);   y_t = C_t·h_t + D x_t
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from ..kernels.ssd_scan.ref import CLIP
from ..kernels.ssd_scan.ref import ssd_scan_ref as ssd_reference  # noqa: F401
from .common import dense_init, per_worker, rmsnorm


def init_ssd(generator, d_model, *, expand=2, head_dim=64, state=128,
             n_groups=1, conv_width=4, dtype=torch.float32, device=None):
    """One model's mixer params (no worker axis), the reference's layout."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    conv_ch = d_inner + 2 * n_groups * state
    d_proj = 2 * d_inner + 2 * n_groups * state + n_heads
    kw = {"generator": generator, "in_axis": 0, "dtype": dtype,
          "device": device}
    conv_w = torch.randn((conv_width, conv_ch), generator=generator,
                         device=device) / math.sqrt(conv_width)
    f32 = {"dtype": torch.float32, "device": device}
    return {
        "in_proj": dense_init(shape=(d_model, d_proj), **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": torch.zeros((conv_ch,), dtype=dtype, device=device),
        "A_log": torch.log(torch.linspace(1.0, 16.0, n_heads, **f32)),
        "D": torch.ones((n_heads,), **f32),
        "dt_bias": torch.zeros((n_heads,), **f32),
        "norm": {"scale": torch.zeros((d_inner,), dtype=dtype,
                                      device=device)},
        "out_proj": dense_init(shape=(d_inner, d_model), **kw),
    }


def _split_proj(proj, d_inner, n_groups, state, n_heads):
    """(z, x, B, C, dt) along the last axis of the in_proj output."""
    return torch.split(proj, [d_inner, d_inner, n_groups * state,
                              n_groups * state, n_heads], dim=-1)


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x: (W,B,S,C), w: (W,K,C), b: (W,C).  The
    unrolled K-tap FIR of the reference, summed in its order."""
    K, S = w.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, K - 1, 0))
    y = sum(xp[:, :, i:i + S, :] * per_worker(w[:, i], x.ndim)
            for i in range(K))
    return y + per_worker(b, x.ndim)


def ssd_chunked(x, dt, A, B, C, chunk):
    """The reference model's chunked SSD scan (plain torch; one model).

    x: (B,S,H,P); dt: (B,S,H) positive; A: (H,) negative; B, C: (B,S,G,N)
    with G == 1.  Returns y (B,S,H,P) and the final state (B,H,N,P)."""
    Bb, S, H, P = x.shape
    N = B.shape[3]
    if S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk}")
    nc = S // chunk
    xc = x.reshape(Bb, nc, chunk, H, P)
    dtc = dt.reshape(Bb, nc, chunk, H)
    Bc = B[:, :, 0].reshape(Bb, nc, chunk, N)
    Cc = C[:, :, 0].reshape(Bb, nc, chunk, N)

    lcum = torch.cumsum(dtc * A, dim=2)                     # (B,nc,Q,H)
    ltot = lcum[:, :, -1:, :]
    cb = torch.einsum("bnik,bnjk->bnij", Cc, Bc)            # (B,nc,Q,Q)
    li = lcum[:, :, :, None, :]
    lj = lcum[:, :, None, :, :]
    decay = torch.exp(torch.clamp(li - lj, CLIP, 0.0))      # (B,nc,Q,Q,H)
    idx = torch.arange(chunk, device=x.device)
    tri = (idx[:, None] >= idx[None, :]).to(decay.dtype)
    gamma = cb[..., None] * decay * tri[None, None, :, :, None]
    xdt = xc * dtc[..., None]
    y_intra = torch.einsum("bnijh,bnjhp->bnihp", gamma, xdt)

    sdecay = torch.exp(torch.clamp(ltot - lcum, CLIP, 0.0))  # (B,nc,Q,H)
    s_c = torch.einsum("bnjk,bnjh,bnjhp->bnhkp", Bc, sdecay, xdt)
    chunk_decay = torch.exp(torch.clamp(ltot[:, :, 0, :], CLIP, 0.0))

    h = x.new_zeros((Bb, H, N, P))
    h_pre = []
    for c in range(nc):                      # inter-chunk scan, PRE-states
        h_pre.append(h)
        h = h * chunk_decay[:, c, :, None, None] + s_c[:, c]
    h_pre = torch.stack(h_pre, dim=1)                       # (B,nc,H,N,P)

    in_decay = torch.exp(torch.clamp(lcum, CLIP, 0.0))      # (B,nc,Q,H)
    y_inter = torch.einsum("bnik,bnhkp,bnih->bnihp", Cc, h_pre, in_decay)
    return (y_intra + y_inter).reshape(Bb, S, H, P), h


def apply_ssd(params, x_in, *, chunk=64, head_dim=64, state=128,
              n_groups=1):
    """Full mamba-2 mixer: in_proj -> conv -> SSD (kernel B5) -> gated norm
    -> out_proj, on W replicas.  x_in: (W,B,S,D).  Returns (y (W,B,S,D),
    final SSD state (W,B,H,N,P)).  S % chunk must be 0, as the reference's
    ``ssd_chunked`` asserts (the kernel wrapper could pad; the reference's
    model does not)."""
    W, Bb, S, _ = x_in.shape
    if S % chunk:
        raise ValueError(f"seq {S} is not a multiple of ssm_chunk {chunk}")
    d_inner = params["out_proj"].shape[1]
    H = d_inner // head_dim
    proj = torch.einsum("wbsd,wde->wbse", x_in, params["in_proj"])
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, n_groups, state, H)

    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc, params["conv_w"], params["conv_b"]))
    x, Bm, Cm = torch.split(xbc, [d_inner, n_groups * state,
                                  n_groups * state], dim=-1)

    dt = F.softplus(dt.float() + per_worker(params["dt_bias"], dt.ndim))
    A = -torch.exp(params["A_log"].float())                 # (W,H) < 0
    xh = x.reshape(W * Bb, S, H, head_dim).float()
    y, h_last = ssd_scan(
        xh, dt.reshape(W * Bb, S, H), A.repeat_interleave(Bb, dim=0),
        Bm.reshape(W * Bb, S, n_groups, state),
        Cm.reshape(W * Bb, S, n_groups, state), chunk=chunk)
    y = y + params["D"].float().repeat_interleave(Bb, dim=0)[
        :, None, :, None] * xh
    y = y.reshape(W, Bb, S, d_inner).to(x_in.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z))
    out = torch.einsum("wbse,wed->wbsd", y, params["out_proj"])
    return out, h_last.reshape((W, Bb) + h_last.shape[1:])


def init_ssd_cache(batch, d_model, *, expand=2, head_dim=64, state=128,
                   n_groups=1, conv_width=4, dtype=torch.float32,
                   device=None):
    """One model's decode cache: conv tail (batch, K-1, C) and SSD state
    (batch, H, N, P) f32, zeros."""
    d_inner = expand * d_model
    H = d_inner // head_dim
    conv_ch = d_inner + 2 * n_groups * state
    return {
        "conv": torch.zeros((batch, conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, H, state, head_dim), dtype=torch.float32,
                           device=device),
    }


def apply_ssd_decode(params, x_in, cache, *, head_dim=64, state=128,
                     n_groups=1):
    """Single-token decode on W replicas: O(1) in sequence length.
    x_in: (W,B,1,D); cache: conv (W,B,K-1,C), ssm (W,B,H,N,P).  Returns
    (out (W,B,1,D), new cache) — new tensors; the cache is not written."""
    W, Bb = x_in.shape[:2]
    d_inner = params["out_proj"].shape[1]
    H = d_inner // head_dim
    proj = torch.einsum("wbsd,wde->wbse", x_in, params["in_proj"])[:, :, 0]
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, n_groups, state, H)

    xbc = torch.cat([x, Bm, Cm], dim=-1)                    # (W,B,C)
    conv_buf = torch.cat([cache["conv"], xbc[:, :, None]], dim=2)
    y_conv = torch.einsum("wbkc,wkc->wbc", conv_buf, params["conv_w"]) \
        + params["conv_b"][:, None]
    xbc = F.silu(y_conv)
    x, Bm, Cm = torch.split(xbc, [d_inner, n_groups * state,
                                  n_groups * state], dim=-1)

    dt = F.softplus(dt.float() + params["dt_bias"][:, None])  # (W,B,H)
    A = -torch.exp(params["A_log"].float())                   # (W,H)
    a = torch.exp(dt * A[:, None])                            # (W,B,H)
    xh = x.reshape(W, Bb, H, head_dim).float()
    Bv = Bm.reshape(W, Bb, n_groups, state)[:, :, 0].float()
    Cv = Cm.reshape(W, Bb, n_groups, state)[:, :, 0].float()
    upd = torch.einsum("wbk,wbhp->wbhkp", Bv, xh * dt[..., None])
    h = cache["ssm"] * a[..., None, None] + upd
    y = torch.einsum("wbk,wbhkp->wbhp", Cv, h)
    y = y + params["D"][:, None, :, None] * xh
    y = y.reshape(W, Bb, 1, d_inner).to(x_in.dtype)
    y = rmsnorm(params["norm"], y * F.silu(z[:, :, None]))
    out = torch.einsum("wbse,wed->wbsd", y, params["out_proj"])
    return out, {"conv": conv_buf[:, :, 1:], "ssm": h}
