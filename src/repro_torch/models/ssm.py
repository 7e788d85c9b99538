"""Mamba-2 SSD (state-space duality) block — arXiv:2405.21060.

The sequence mixer of mamba2-370m.  The forward pass runs the chunked SSD
scan through :func:`repro_torch.kernels.ssd_scan.ssd_scan` — kernel B5 on
the card, its plain version on the CPU — where the reference runs its jnp
chunked form :func:`ssd_chunked` (kept here for the tests; the reference's
own tests hold the two forms together).  Training differentiates the scan
through its backward, kernel B5b on the card (the plain backward on the
CPU), where the reference takes ``jax.grad`` of its chunked form; the rest
of the mixer is autograd of plain torch.  Decode is one recurrence step in
plain torch, as in the reference.

Worker batching as in common.py: params carry a leading worker axis (W,
...) and activations are (W, B, S, D); one model is W = 1.  Shapes (per
worker): x (B,S,H,P) with heads*head_dim = d_inner; B, C (B,S,G,N) with
G = 1 state group shared by the heads; dt (B,S,H); A (H,) < 0.

Recurrence:   h_t = exp(dt_t A) h_{t-1} + dt_t * (B_t ⊗ x_t);   y_t = C_t·h_t + D x_t
"""
from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..kernels.ssd_scan import ssd_scan
from ..kernels.ssd_scan.ref import CLIP
from ..kernels.ssd_scan.ref import ssd_scan_ref as ssd_reference  # noqa: F401
from .common import (dense_init, gather_shards, like_placed, mean_over,
                     per_worker, placed, rmsnorm, share_of, whole_local)


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
    """Full mamba-2 mixer: in_proj -> conv -> SSD (kernel B5; B5b under
    autograd) -> gated norm -> out_proj, on W replicas.  x_in: (W,B,S,D).  Returns (y (W,B,S,D),
    final SSD state (W,B,H,N,P)).  S % chunk must be 0, as the reference's
    ``ssd_chunked`` asserts (the kernel wrapper could pad; the reference's
    model does not).  On DTensor leaves (launch/tensor_parallel.py) each
    rank runs its own heads: :func:`_apply_ssd_placed`."""
    S = x_in.shape[2]
    if S % chunk:
        raise ValueError(f"seq {S} is not a multiple of ssm_chunk {chunk}")
    dims = {"chunk": chunk, "head_dim": head_dim, "state": state,
            "n_groups": n_groups}
    if placed(params["in_proj"]):
        return _apply_ssd_placed(params, x_in, **dims)
    d_inner = params["out_proj"].shape[1]
    proj = torch.einsum("wbsd,wde->wbse", x_in, params["in_proj"])
    z, y, h_last = _ssd_heads(params, proj, d_inner, 0, d_inner // head_dim,
                              **dims)
    y = rmsnorm(params["norm"], y.to(x_in.dtype) * F.silu(z))
    out = torch.einsum("wbse,wed->wbsd", y, params["out_proj"])
    return out, h_last


def _ssd_heads(params, proj, d_inner, h0, hn, *, chunk, head_dim, state,
               n_groups):
    """The mixer from the in_proj output to the gated norm's inputs, for
    heads [h0, h0 + hn): proj (W,B,S,Dproj) the whole projection; params'
    conv_w, conv_b, A_log, dt_bias and D plain and whole.  The conv runs
    on those heads' x channels and on every B/C channel.  Returns z and y
    (W,B,S,hn*P) of those heads' columns of d_inner, y f32, and their
    final state (W,B,hn,N,P)."""
    W, Bb, S, _ = proj.shape
    H, gs = d_inner // head_dim, n_groups * state
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, n_groups, state, H)
    conv_w, conv_b = params["conv_w"], params["conv_b"]
    heads = slice(h0, h0 + hn)
    if hn < H:
        cols = slice(h0 * head_dim, (h0 + hn) * head_dim)
        conv_w = torch.cat([conv_w[..., cols], conv_w[..., d_inner:]], -1)
        conv_b = torch.cat([conv_b[..., cols], conv_b[..., d_inner:]], -1)
        z, x, dt = z[..., cols], x[..., cols], dt[..., heads]

    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc = F.silu(_causal_conv(xbc, conv_w, conv_b))
    x, Bm, Cm = torch.split(xbc, [hn * head_dim, gs, gs], dim=-1)

    dt = F.softplus(dt.float() + per_worker(params["dt_bias"][:, heads],
                                            dt.ndim))
    A = -torch.exp(params["A_log"][:, heads].float())        # (W,hn) < 0
    xh = x.reshape(W * Bb, S, hn, head_dim).float()
    y, h_last = ssd_scan(
        xh, dt.reshape(W * Bb, S, hn), A.repeat_interleave(Bb, dim=0),
        Bm.reshape(W * Bb, S, n_groups, state),
        Cm.reshape(W * Bb, S, n_groups, state), chunk=chunk)
    y = y + params["D"][:, heads].float().repeat_interleave(Bb, dim=0)[
        :, None, :, None] * xh
    return (z, y.reshape(W, Bb, S, hn * head_dim),
            h_last.reshape((W, Bb) + h_last.shape[1:]))


def _apply_ssd_placed(params, x_in, **dims):
    """:func:`apply_ssd` on DTensor leaves of a 1-D mesh, placed by
    ``launch/sharding.py param_pspec``: in_proj over its columns (or
    d_model), conv_w/conv_b over the conv channels, out_proj over d_inner,
    A_log, dt_bias, D and the norm's scale replicated.  Neither the
    in_proj columns [z | x | B | C | dt] nor the conv channels [x | B | C]
    shard along the heads, so the projection's output is gathered whole
    on every rank and each rank runs :func:`_ssd_heads` on its own heads'
    columns of z, x and dt and on the whole of B and C, with conv_w and
    conv_b gathered whole (K x C: a weight, smaller than the conv's
    output): kernel B5 (B5b under autograd) scans the rank's heads.  Then
    :func:`_gated_out`: the gated norm on the rank's columns, its mean of
    squares averaged over the mesh, and the rank's rows of out_proj, a
    ``Partial`` sum.  The ranks' gradients of what they read whole are
    summed over the mesh (``whole_local``): B and C's columns of in_proj
    and conv_w/conv_b, and A_log, dt_bias, D and the norm's scale, which
    each rank reads at its heads only.

    Where the heads do not divide over the mesh, every rank runs every
    head (``cache_pspec`` then replicates the ssm state): correct, not
    parallel, as attention's d_model fallback."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = params["out_proj"].device_mesh
    d_inner = params["out_proj"].shape[1]
    h0, hn, split = share_of(mesh, d_inner // dims["head_dim"])
    local = {k: whole_local(params[k], split)
             for k in ("conv_w", "conv_b", "A_log", "dt_bias", "D")}
    z, y, h_last = _ssd_heads(local, _whole_proj(params, x_in, split),
                              d_inner, h0, hn, **dims)
    out = _gated_out(params, y.to(x_in.dtype), z, h0, hn, split,
                     dims["head_dim"])
    return out, DTensor.from_local(
        h_last, mesh, (Shard(2),) if split else (Replicate(),),
        run_check=False)


def _whole_proj(params, x_in, split):
    """The in_proj output (W,B,S,Dproj) whole on every rank, as a plain
    tensor: where in_proj is split along its columns, each rank projects
    its columns from the whole input and the columns are all-gathered;
    otherwise DTensor's product (a ``Partial`` over a split d_model, or
    whole) is reduced or gathered.  ``split``: whether each rank then
    uses its own heads' share of it (``whole_local``)."""
    from torch.distributed.tensor import Shard
    w = params["in_proj"]
    if w.placements == (Shard(2),):
        return gather_shards(torch.einsum(
            "wbsd,wde->wbse", whole_local(x_in, True), w.to_local()),
            w.device_mesh, -1, split)
    return whole_local(torch.einsum("wbsd,wde->wbse", x_in, w), split)


def _gated_out(params, y, z, h0, hn, split, head_dim):
    """The gated norm and out_proj on a rank's heads [h0, h0 + hn): y and
    z (W,B,S,hn*P) plain, those heads' columns of d_inner; params placed
    (:func:`_apply_ssd_placed`).  Where the heads split, the norm's mean
    of squares is averaged over the mesh and the rank's rows of out_proj
    (``Shard``ed along d_inner, as the heads) give a ``Partial`` sum;
    otherwise every rank normalises and projects the whole, its out_proj
    gathered.  Returns the DTensor output (W,B,S,D)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = params["out_proj"].device_mesh
    cols = slice(h0 * head_dim, (h0 + hn) * head_dim)
    scale = whole_local(params["norm"]["scale"], split)[..., cols]
    if split:
        if params["out_proj"].placements != (Shard(1),):
            raise ValueError("out_proj placed "
                             f"{params['out_proj'].placements} beside heads "
                             "split over the mesh")
        w_out = params["out_proj"].to_local()
        combine = functools.partial(mean_over, mesh=mesh)
    else:
        w_out, combine = whole_local(params["out_proj"], False), None
    y = rmsnorm({"scale": scale}, y * F.silu(z), combine=combine)
    out = torch.einsum("wbse,wed->wbsd", y, w_out)
    return DTensor.from_local(out, mesh, (Partial(),) if split
                              else (Replicate(),), run_check=False)


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
    (out (W,B,1,D), new cache) — new tensors; the cache is not written.
    On DTensor leaves and a placed cache: :func:`_apply_ssd_decode_placed`."""
    dims = {"head_dim": head_dim, "state": state, "n_groups": n_groups}
    if placed(params["in_proj"]):
        return _apply_ssd_decode_placed(params, x_in, cache, **dims)
    H = params["out_proj"].shape[1] // head_dim
    proj = torch.einsum("wbsd,wde->wbse", x_in, params["in_proj"])[:, :, 0]
    z, x, Bm, Cm, dt = _split_proj(proj, params["out_proj"].shape[1],
                                   n_groups, state, H)
    conv_buf = torch.cat([cache["conv"],
                          torch.cat([x, Bm, Cm], dim=-1)[:, :, None]], dim=2)
    xbc = F.silu(_conv_step(params, conv_buf))
    z, y, h = _ssd_step(params, z, xbc, dt, cache["ssm"], 0, H, **dims)
    y = rmsnorm(params["norm"], y.to(x_in.dtype) * F.silu(z))
    out = torch.einsum("wbse,wed->wbsd", y, params["out_proj"])
    return out, {"conv": conv_buf[:, :, 1:], "ssm": h}


def _conv_step(params, conv_buf):
    """The conv's output at the new token: conv_buf (W,B,K,C') the cached
    tail and the token's channels, conv_w/conv_b of the same channels."""
    return torch.einsum("wbkc,wkc->wbc", conv_buf, params["conv_w"]) \
        + params["conv_b"][:, None]


def _ssd_step(params, z, xbc, dt, ssm, h0, hn, *, head_dim, state,
              n_groups):
    """One recurrence step of heads [h0, h0 + hn): z (W,B,d_inner) and xbc
    (W,B,C) the token's whole gate and conv output, dt (W,B,H), ssm
    (W,B,hn,N,P) those heads' state; params' A_log, dt_bias and D whole.
    Returns z and y (W,B,1,hn*P) of those heads' columns, y f32, and
    their new state."""
    W, Bb = z.shape[:2]
    d_inner = z.shape[-1]
    cols = slice(h0 * head_dim, (h0 + hn) * head_dim)
    heads = slice(h0, h0 + hn)
    x, Bm, Cm = torch.split(xbc, [d_inner, n_groups * state,
                                  n_groups * state], dim=-1)
    dt = F.softplus(dt[..., heads].float()
                    + params["dt_bias"][:, None, heads])      # (W,B,hn)
    A = -torch.exp(params["A_log"][:, heads].float())          # (W,hn)
    a = torch.exp(dt * A[:, None])                             # (W,B,hn)
    xh = x[..., cols].reshape(W, Bb, hn, head_dim).float()
    Bv = Bm.reshape(W, Bb, n_groups, state)[:, :, 0].float()
    Cv = Cm.reshape(W, Bb, n_groups, state)[:, :, 0].float()
    upd = torch.einsum("wbk,wbhp->wbhkp", Bv, xh * dt[..., None])
    h = ssm * a[..., None, None] + upd
    y = torch.einsum("wbk,wbhkp->wbhp", Cv, h)
    y = y + params["D"][:, None, heads, None] * xh
    return (z[..., cols][:, :, None], y.reshape(W, Bb, 1, hn * head_dim),
            h)


def _apply_ssd_decode_placed(params, x_in, cache, **dims):
    """:func:`apply_ssd_decode` on :func:`_apply_ssd_placed`'s leaves and a
    cache placed by ``launch/sharding.py cache_pspec``: conv over its
    channels and ssm over its heads where they divide over the mesh, else
    replicated.  The token's projection is gathered whole; each rank runs
    the conv on its shard of the conv cache (the channels of its conv_w
    and conv_b shards, which ``param_pspec`` splits alike), and the
    token's conv output is all-gathered; then each rank steps its own
    heads' state (every head where the state is replicated).  What moves
    is the token's: its projection, its conv output, the gated norm's
    sum and out_proj's ``Partial`` sum.  The cache leaves are read as the
    rank's local shards and the new values come back with their
    placements, for ``copy_`` into the leaves."""
    from torch.distributed.tensor import Replicate
    mesh = params["out_proj"].device_mesh
    d_inner = params["out_proj"].shape[1]
    H = d_inner // dims["head_dim"]
    conv, ssm = cache["conv"], cache["ssm"]
    h0, hn, split = share_of(mesh, H)
    if split != (ssm.placements != (Replicate(),)):
        raise ValueError(f"an ssm cache placed {ssm.placements} beside "
                         f"{H} heads on a mesh of {mesh.size()}")
    proj = _whole_proj(params, x_in, split)[:, :, 0]
    z, x, Bm, Cm, dt = _split_proj(proj, d_inner, dims["n_groups"],
                                   dims["state"], H)
    xbc = torch.cat([x, Bm, Cm], dim=-1)                    # (W,B,C)
    local = conv.to_local()
    c0 = 0
    if conv.placements != (Replicate(),):
        c0 = mesh.get_local_rank() * local.shape[-1]
    conv_buf = torch.cat([local, xbc[..., c0:c0 + local.shape[-1]][
        :, :, None]], dim=2)
    xbc = _conv_step({k: params[k].to_local()
                      for k in ("conv_w", "conv_b")}, conv_buf)
    if conv.placements != (Replicate(),):
        xbc = gather_shards(xbc, mesh, -1)
    whole = {k: whole_local(params[k], split)
             for k in ("A_log", "dt_bias", "D")}
    z, y, h = _ssd_step(whole, z, F.silu(xbc), dt, ssm.to_local(), h0, hn,
                        **dims)
    out = _gated_out(params, y.to(x_in.dtype), z, h0, hn, split,
                     dims["head_dim"])
    return out, {"conv": like_placed(conv, conv_buf[:, :, 1:]),
                 "ssm": like_placed(ssm, h)}
