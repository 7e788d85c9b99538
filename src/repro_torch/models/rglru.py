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

from .common import dense_init, per_worker

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


def _rg_lru_coeffs(params, x):
    """x: (W,B,S,C) post-conv.  Returns the per-step (a_t, b_t) of the
    linear recurrence h = a*h + b, computed in f32."""
    x32 = x.float()
    r = torch.sigmoid(torch.einsum("wbsc,wcv->wbsv", x32,
                                   params["w_a"].float())
                      + per_worker(params["b_a"].float(), x.ndim))
    i = torch.sigmoid(torch.einsum("wbsc,wcv->wbsv", x32,
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
    approximation, ``jax.nn.gelu``'s default."""
    gate = F.gelu(torch.einsum("wbsd,wdc->wbsc", x_in, params["in_gate"]),
                  approximate="tanh")
    x = torch.einsum("wbsd,wdc->wbsc", x_in, params["in_x"])
    x = _causal_conv(x, params["conv_w"], params["conv_b"])
    a, b = _rg_lru_coeffs(params, x)
    h = rg_lru_scan(a, b)                                    # (W,B,S,C) f32
    y = h.to(x_in.dtype) * gate
    out = torch.einsum("wbsc,wcd->wbsd", y, params["out"])
    return out, h[:, :, -1]


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
    tensors; the cache is not written."""
    gate = F.gelu(torch.einsum("wbsd,wdc->wbsc", x_in, params["in_gate"]),
                  approximate="tanh")
    x = torch.einsum("wbsd,wdc->wbsc", x_in, params["in_x"])[:, :, 0]
    conv_buf = torch.cat([cache["conv"], x[:, :, None]], dim=2)
    x = torch.einsum("wbkc,wkc->wbc", conv_buf, params["conv_w"]) \
        + params["conv_b"][:, None]
    a, b = _rg_lru_coeffs(params, x[:, :, None])
    h = a[:, :, 0] * cache["h"] + b[:, :, 0]                 # (W,B,C)
    y = h[:, :, None].to(x_in.dtype) * gate
    out = torch.einsum("wbsc,wcd->wbsd", y, params["out"])
    return out, {"conv": conv_buf[:, :, 1:], "h": h}
