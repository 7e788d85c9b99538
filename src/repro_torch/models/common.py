"""Shared model building blocks: initializers, norms, RoPE, masks, dense
attention.

Worker batching: every apply function here takes params whose leaves carry
a LEADING WORKER AXIS (W, ...) and activations (W, B, S, ...) — the
reference's ``jax.vmap`` over worker replicas written out, so one op
serves all W replicas (each matmul is one batched GEMM over W).  A single
model is W = 1.  Param layouts behind that axis are the reference's (wq
(D, H, Dh), wo (H, Dh, D), ...), so weights cross one array per leaf.

Attention is plain torch here, as it is jnp in the reference; the
reference's chunked ``attention_flash`` (taken at seq >= 2048) is not
ported yet (ROADMAP.md queue A, item 5).
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# initializers (single model, no worker axis) — draw from an explicit
# torch.Generator; the reference's jax.random draws cannot be replayed, the
# tests carry its weights across with repro_torch.convert instead
# ---------------------------------------------------------------------------


def dense_init(generator, shape, in_axis=-2, dtype=torch.float32,
               device=None):
    """LeCun-normal (fan-in)."""
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    x = torch.randn(shape, generator=generator, device=device)
    return (x / math.sqrt(fan_in)).to(dtype)


def embed_init(generator, shape, dtype=torch.float32, device=None):
    x = torch.randn(shape, generator=generator, device=device)
    return (x * 0.02).to(dtype)


def per_worker(p, ndim: int):
    """A (W, *tail) param reshaped to broadcast against an ndim-dim
    activation (W, ..., *tail)."""
    return p.reshape((p.shape[0],) + (1,) * (ndim - p.ndim) + p.shape[1:])


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def init_rmsnorm(d, dtype=torch.float32, device=None):
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def rmsnorm(params, x, eps=1e-6):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    # gemma-style (1 + scale): zero-init scale == identity
    scale = per_worker(params["scale"].float(), x.ndim)
    return (y * (1.0 + scale)).to(x.dtype)


def make_norm(norm_type):
    """(init, apply) of the config's norm.  Only RMSNorm is ported: the
    reference's LayerNorm serves whisper-tiny alone (ROADMAP.md queue A,
    item 9)."""
    if norm_type != "rmsnorm":
        raise NotImplementedError(
            f"norm_type {norm_type!r} not ported yet — ROADMAP.md queue A, "
            "item 9")
    return init_rmsnorm, rmsnorm


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_freqs(head_dim, theta, device=None):
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32,
                                  device=device), exps)


def apply_rope(x, positions, theta=10000.0):
    """x: (..., S, H, Dh), positions: (S,) integer."""
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)
    angles = positions[:, None].float() * freqs            # (S, Dh/2)
    angles = angles[:, None, :]                            # (S, 1, Dh/2)
    sin, cos = torch.sin(angles), torch.cos(angles)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# masks (True == may attend)
# ---------------------------------------------------------------------------

def causal_mask(q_pos, k_pos):
    return q_pos[:, None] >= k_pos[None, :]


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AttnSpec:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    use_rope: bool = True


def init_attention(generator, spec: AttnSpec, dtype=torch.float32,
                   device=None):
    D, H, KV, Dh = spec.d_model, spec.n_heads, spec.n_kv_heads, spec.head_dim
    kw = {"generator": generator, "dtype": dtype, "device": device}
    p = {
        "wq": dense_init(shape=(D, H, Dh), in_axis=0, **kw),
        "wk": dense_init(shape=(D, KV, Dh), in_axis=0, **kw),
        "wv": dense_init(shape=(D, KV, Dh), in_axis=0, **kw),
        "wo": dense_init(shape=(H, Dh, D), in_axis=1, **kw),
    }
    if spec.qkv_bias:
        p["bq"] = torch.zeros((H, Dh), dtype=dtype, device=device)
        p["bk"] = torch.zeros((KV, Dh), dtype=dtype, device=device)
        p["bv"] = torch.zeros((KV, Dh), dtype=dtype, device=device)
    if spec.qk_norm:
        p["q_norm"] = init_rmsnorm(Dh, dtype, device)
        p["k_norm"] = init_rmsnorm(Dh, dtype, device)
    return p


def _project_qkv(params, spec: AttnSpec, x, positions):
    """x: (W, B, S, D) -> q: (W, B, S, H, Dh), k/v: (W, B, S, KV, Dh)."""
    q = torch.einsum("wbsd,wdhk->wbshk", x, params["wq"])
    k = torch.einsum("wbsd,wdhk->wbshk", x, params["wk"])
    v = torch.einsum("wbsd,wdhk->wbshk", x, params["wv"])
    if spec.qkv_bias:
        q = q + per_worker(params["bq"], q.ndim)
        k = k + per_worker(params["bk"], k.ndim)
        v = v + per_worker(params["bv"], v.ndim)
    if spec.qk_norm:   # qwen3-style per-head RMS norm before RoPE
        q = rmsnorm(params["q_norm"], q)
        k = rmsnorm(params["k_norm"], k)
    if spec.use_rope:
        q = apply_rope(q, positions, spec.rope_theta)
        k = apply_rope(k, positions, spec.rope_theta)
    return q, k, v


def _gqa_expand(k, n_heads):
    """(..., S, KV, Dh) -> (..., S, H, Dh) by repeating each KV head."""
    kv = k.shape[-2]
    if kv == n_heads:
        return k
    return k.repeat_interleave(n_heads // kv, dim=-2)


def attention_dense(params, spec: AttnSpec, x, positions, mask):
    """x: (W, B, S, D); mask: (S, S) bool (True == attend).  Materializes
    the scores."""
    q, k, v = _project_qkv(params, spec, x, positions)
    k = _gqa_expand(k, spec.n_heads)
    v = _gqa_expand(v, spec.n_heads)
    scale = spec.head_dim ** -0.5
    scores = torch.einsum("wbqhk,wbshk->wbhqs", q, k) * scale
    scores = torch.where(mask, scores.float(),
                         torch.full((), -1e30, device=scores.device))
    probs = F.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("wbhqs,wbshk->wbqhk", probs, v)
    return torch.einsum("wbqhk,whkd->wbqd", out, params["wo"])


def activation(name):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "relu": F.relu,
    }[name]
