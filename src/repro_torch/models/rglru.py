"""RG-LRU recurrent block (RecurrentGemma / Griffin) — arXiv:2402.19427.

The Real-Gated Linear Recurrent Unit:

    r_t = sigmoid(W_a x_t + b_a)            recurrence gate
    i_t = sigmoid(W_x x_t + b_x)            input gate
    a_t = a ^ (c * r_t),  a = sigmoid(Lambda)  (per-channel learnt decay)
    h_t = a_t ⊙ h_{t-1} + sqrt(1 - a_t^2) ⊙ (i_t ⊙ x_t)

The full Griffin block is conv1d + RG-LRU on one branch, a GeLU gate on
the other, merged multiplicatively.  Plain torch, as the reference is jnp:
the recurrence over a sequence is a log-depth doubling scan (the reference
takes ``jax.lax.associative_scan``; the sums run in another order), decode
one O(1) state update.

Worker batching as in common.py: params carry a leading worker axis (W,
...) and activations are (W, B, S, D); one model is W = 1.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .common import (dense_init, gather_shards, like_placed, per_worker,
                     placed, whole_local)

_C = 8.0  # paper's fixed exponent scale


def init_rglru(generator, d_model, lru_width, conv_width=4,
               dtype=torch.float32, device=None):
    """One model's block params (no worker axis), the reference's leaf
    names — ``Lambda`` with a capital L sorts first among them."""
    kw = {"generator": generator, "in_axis": 0, "dtype": dtype,
          "device": device}
    # Lambda so that a = sigmoid(Lambda) lies in [0.9, 0.999] (paper)
    u = 0.9 + 0.099 * torch.rand((lru_width,), generator=generator,
                                 device=device)
    conv_w = torch.randn((conv_width, lru_width), generator=generator,
                         device=device) / math.sqrt(conv_width)
    zeros = lambda: torch.zeros((lru_width,), dtype=dtype,  # noqa: E731
                                device=device)
    return {
        "in_x": dense_init(shape=(d_model, lru_width), **kw),
        "in_gate": dense_init(shape=(d_model, lru_width), **kw),
        "conv_w": conv_w.to(dtype),
        "conv_b": zeros(),
        "w_a": dense_init(shape=(lru_width, lru_width), **kw),
        "b_a": zeros(),
        "w_x": dense_init(shape=(lru_width, lru_width), **kw),
        "b_x": zeros(),
        "Lambda": torch.log(u / (1 - u)),
        "out": dense_init(shape=(lru_width, d_model), **kw),
    }


def _causal_conv(x, w, b):
    """Depthwise causal conv1d.  x: (W,B,S,C), w: (W,K,C), b: (W,C).  The
    reference's K shifted products, summed in its order."""
    K, S = w.shape[1], x.shape[2]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, :, i:i + S, :] * per_worker(w[:, i], x.ndim)
               for i in range(K)) + per_worker(b, x.ndim)


def _rg_lru_coeffs(params, x, xw=None):
    """x: (W,B,S,C) post-conv.  Returns the per-step (a_t, b_t) of the
    linear recurrence h = a*h + b, computed in f32.  ``xw``: the whole
    width that the gates' products contract, where x is a rank's channels
    of it (tensor parallelism); x itself by default."""
    x32 = x.float()
    xw32 = x32 if xw is None else xw.float()
    r = torch.sigmoid(torch.einsum("wbsc,wcv->wbsv", xw32,
                                   params["w_a"].float())
                      + per_worker(params["b_a"].float(), x.ndim))
    i = torch.sigmoid(torch.einsum("wbsc,wcv->wbsv", xw32,
                                   params["w_x"].float())
                      + per_worker(params["b_x"].float(), x.ndim))
    log_a_base = F.logsigmoid(params["Lambda"].float())     # log a
    log_a = _C * r * per_worker(log_a_base, x.ndim)          # a^(c r)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-12)) \
        * (i * x32)
    return a, b


def rg_lru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over the sequence axis (-2), by doubling:
    after the step of offset d, position t holds the composition of steps
    t-2d+1..t, so log2(S) elementwise steps give every h_t.  Out of place,
    so autograd differentiates it.  a, b: (..., S, C); h0: optional
    initial state (..., C)."""
    if h0 is not None:
        b = torch.cat([b[..., :1, :] + a[..., :1, :] * h0[..., None, :],
                       b[..., 1:, :]], dim=-2)
    S, d = a.shape[-2], 1
    while d < S:
        b = torch.cat([b[..., :d, :],
                       a[..., d:, :] * b[..., :-d, :] + b[..., d:, :]],
                      dim=-2)
        if 2 * d < S:         # the last step needs no composed a
            a = torch.cat([a[..., :d, :], a[..., d:, :] * a[..., :-d, :]],
                          dim=-2)
        d *= 2
    return b


def apply_rglru(params, x_in):
    """Full Griffin recurrent block on W replicas.  x_in: (W,B,S,D) ->
    (y (W,B,S,D), final state (W,B,C) f32).  The gate's GeLU is the tanh
    approximation, ``jax.nn.gelu``'s default.  On DTensor leaves
    (launch/tensor_parallel.py): :func:`_apply_rglru_placed`."""
    if placed(params["in_x"]):
        return _apply_rglru_placed(params, x_in)
    return _rglru(params, x_in)


def _rglru(params, x_in, widen=None):
    """:func:`apply_rglru` on plain tensors; ``widen`` (a rank's channels
    -> the whole width) feeds the gates' products where the params are a
    rank's channels (:func:`_rg_lru_coeffs`' ``xw``)."""
    gate = F.gelu(torch.einsum("wbsd,wdc->wbsc", x_in, params["in_gate"]),
                  approximate="tanh")
    x = torch.einsum("wbsd,wdc->wbsc", x_in, params["in_x"])
    x = _causal_conv(x, params["conv_w"], params["conv_b"])
    a, b = _rg_lru_coeffs(params, x, None if widen is None else widen(x))
    h = rg_lru_scan(a, b)                                    # (W,B,S,C) f32
    y = h.to(x_in.dtype) * gate
    out = torch.einsum("wbsc,wcd->wbsd", y, params["out"])
    return out, h[:, :, -1]


# the dim of the LRU width in each leaf of the block (after the worker
# axis): the columns of in_x, in_gate, w_a and w_x, the rows of out
_WIDTH_DIMS = {"in_x": 2, "in_gate": 2, "conv_w": 2, "conv_b": 1, "w_a": 2,
               "b_a": 1, "w_x": 2, "b_x": 1, "Lambda": 1, "out": 1}


def _width_split(params) -> bool:
    """Whether every leaf of the block is sharded along the LRU width
    (``param_pspec`` where the width divides over ``model``)."""
    from torch.distributed.tensor import Shard
    return all(params[n].placements == (Shard(d),)
               for n, d in _WIDTH_DIMS.items())


def _apply_rglru_placed(params, x_in):
    """:func:`apply_rglru` on DTensor leaves of a 1-D mesh, placed by
    ``launch/sharding.py param_pspec``.

    * The width split (every leaf sharded along the LRU width): each rank
      runs the block on its own channels — x_in gathered whole, its
      columns of in_x and in_gate, its conv channels, its columns of w_a
      and w_x, whose products contract the whole width, so the conv's
      output is all-gathered once for both gates; the scan along the
      sequence on its channels, with no communication; out's product a
      ``Partial`` sum, the final state ``Shard``ed along the width.
    * x_in sharded over its batch (``cfg.attn_batch_shard``'s hint,
      models/blocks.py): each rank runs the block on its own rows with
      every leaf gathered whole; the output and state are its rows.
    * Otherwise (the width does not divide): every rank runs the whole
      block on the whole input; correct, not parallel.

    The gradients of what a rank reads whole and uses for its share are
    summed over the mesh (``whole_local``)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = params["in_x"].device_mesh

    def wrap(t, place):
        return DTensor.from_local(t, mesh, (place,), run_check=False)
    if x_in.placements == (Shard(1),):
        out, h = _rglru({k: whole_local(v, True) for k, v in params.items()},
                        x_in.to_local())
        return wrap(out, Shard(1)), wrap(h, Shard(1))
    if not _width_split(params):
        out, h = _rglru({k: whole_local(v, False)
                         for k, v in params.items()},
                        whole_local(x_in, False))
        return wrap(out, Replicate()), wrap(h, Replicate())
    out, h = _rglru({k: v.to_local() for k, v in params.items()},
                    whole_local(x_in, True),
                    widen=lambda x: gather_shards(x, mesh, -1))
    return wrap(out, Partial()), wrap(h, Shard(2))


def init_rglru_cache(batch, lru_width, conv_width=4, dtype=torch.float32,
                     device=None):
    """One model's decode cache: conv tail (batch, K-1, C) of ``dtype``
    and the state h (batch, C) f32, zeros."""
    return {
        "conv": torch.zeros((batch, conv_width - 1, lru_width), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, lru_width), dtype=torch.float32,
                         device=device),
    }


def apply_rglru_decode(params, x_in, cache):
    """Single-token decode on W replicas.  x_in: (W,B,1,D); cache: conv
    (W,B,K-1,C), h (W,B,C).  Returns (out (W,B,1,D), new cache) — new
    tensors; the cache is not written.  On DTensor leaves and a placed
    cache: :func:`_apply_rglru_decode_placed`."""
    if placed(params["in_x"]):
        return _apply_rglru_decode_placed(params, x_in, cache)
    return _rglru_decode(params, x_in, cache)


def _rglru_decode(params, x_in, cache, widen=None):
    """:func:`apply_rglru_decode` on plain tensors (``widen`` as
    :func:`_rglru`'s)."""
    gate = F.gelu(torch.einsum("wbsd,wdc->wbsc", x_in, params["in_gate"]),
                  approximate="tanh")
    x = torch.einsum("wbsd,wdc->wbsc", x_in, params["in_x"])[:, :, 0]
    conv_buf = torch.cat([cache["conv"], x[:, :, None]], dim=2)
    x = torch.einsum("wbkc,wkc->wbc", conv_buf, params["conv_w"]) \
        + params["conv_b"][:, None]
    a, b = _rg_lru_coeffs(params, x[:, :, None],
                          None if widen is None else widen(x)[:, :, None])
    h = a[:, :, 0] * cache["h"] + b[:, :, 0]                 # (W,B,C)
    y = h[:, :, None].to(x_in.dtype) * gate
    out = torch.einsum("wbsc,wcd->wbsd", y, params["out"])
    return out, {"conv": conv_buf[:, :, 1:], "h": h}


def _apply_rglru_decode_placed(params, x_in, cache):
    """:func:`apply_rglru_decode` on :func:`_apply_rglru_placed`'s leaves
    and a cache placed by ``launch/sharding.py cache_pspec`` (conv and h
    over the width where it divides, as the params): each rank steps its
    own channels from its local shards of the cache, the token's conv
    output all-gathered for the gates' products, out's product a
    ``Partial`` sum; where the width does not divide, every rank steps
    the whole replicated cache.  What moves is the token's; the new
    cache values come back with the leaves' placements, for ``copy_``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    mesh = params["in_x"].device_mesh
    local = {k: v.to_local() for k, v in cache.items()}
    split = _width_split(params)
    if split == (cache["h"].placements == (Replicate(),)):
        raise ValueError(f"an h cache placed {cache['h'].placements} "
                         f"beside an LRU width placed "
                         f"{params['in_x'].placements}")
    if split:
        out, new = _rglru_decode(
            {k: v.to_local() for k, v in params.items()},
            whole_local(x_in, True),
            local, widen=lambda x: gather_shards(x, mesh, -1))
    else:
        out, new = _rglru_decode(
            {k: whole_local(v, False) for k, v in params.items()},
            whole_local(x_in, False), local)
    out = DTensor.from_local(out, mesh, (Partial() if split else
                                         Replicate(),), run_check=False)
    return out, {k: like_placed(cache[k], v) for k, v in new.items()}
