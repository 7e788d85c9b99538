"""Shared model building blocks: initializers, norms, RoPE, masks, dense
attention, decode attention against a KV cache.

Worker batching: every apply function here takes params whose leaves carry
a LEADING WORKER AXIS (W, ...) and activations (W, B, S, ...) — the
reference's ``jax.vmap`` over worker replicas written out, so one op
serves all W replicas (each matmul is one batched GEMM over W).  A single
model is W = 1.  Param layouts behind that axis are the reference's (wq
(D, H, Dh), wo (H, Dh, D), ...), so weights cross one array per leaf.

Attention is plain torch here, as it is jnp in the reference: the dense
form, and the reference's chunked ``attention_flash`` (online softmax over
query and key blocks), which models/blocks.py takes at seq >= 2048.  The
sliding-window mask serves the local ('L') layers of gemma-3 and
recurrentgemma; the prefix mask PaliGemma's prefix-LM (bidirectional over
the image prefix); ``AttnSpec.softcap`` the gemma family's score softcap.
LayerNorm serves whisper, RMSNorm every other arch.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ..core.tree import tree_map

# ---------------------------------------------------------------------------
# initializers (single model, no worker axis) — draw from an explicit
# torch.Generator; the reference's jax.random draws cannot be replayed, the
# tests carry its weights across with repro_torch.convert instead
# ---------------------------------------------------------------------------


def _on_meta(device) -> bool:
    return device is not None and torch.device(device).type == "meta"


def dense_init(generator, shape, in_axis=-2, dtype=torch.float32,
               device=None):
    """LeCun-normal (fan-in); on the meta device the leaf alone (shapes
    only, no generator)."""
    if _on_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
    fan_in = shape[in_axis] if len(shape) > 1 else shape[0]
    x = torch.randn(shape, generator=generator, device=device)
    return (x / math.sqrt(fan_in)).to(dtype)


def embed_init(generator, shape, dtype=torch.float32, device=None):
    if _on_meta(device):
        return torch.empty(shape, dtype=dtype, device=device)
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


def init_layernorm(d, dtype=torch.float32, device=None):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(params, x, eps=1e-5):
    """The reference's LayerNorm: f32 inside, the population variance
    (``jnp.var``; torch.var would apply Bessel's correction)."""
    x32 = x.float()
    centred = x32 - x32.mean(dim=-1, keepdim=True)
    var = centred.square().mean(dim=-1, keepdim=True)
    y = centred * torch.rsqrt(var + eps)
    return (y * per_worker(params["scale"], x.ndim)
            + per_worker(params["bias"], x.ndim)).to(x.dtype)


def make_norm(norm_type):
    """(init, apply) of the config's norm: RMSNorm, else LayerNorm, as the
    reference chooses."""
    if norm_type == "rmsnorm":
        return init_rmsnorm, rmsnorm
    return init_layernorm, layernorm


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


def sliding_mask(q_pos, k_pos, window):
    c = causal_mask(q_pos, k_pos)
    return c & (q_pos[:, None] - k_pos[None, :] < window)


def prefix_mask(q_pos, k_pos, prefix_len):
    """PaliGemma's prefix-LM: bidirectional over the first prefix_len
    positions, causal after them."""
    return causal_mask(q_pos, k_pos) | (k_pos[None, :] < prefix_len)


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
    softcap: float | None = None


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


def _softcap(scores, cap):
    if cap is None:
        return scores
    return cap * torch.tanh(scores / cap)


def attention_dense(params, spec: AttnSpec, x, positions, mask):
    """x: (W, B, S, D); mask: (S, S) bool (True == attend).  Materializes
    the scores."""
    q, k, v = _project_qkv(params, spec, x, positions)
    k = _gqa_expand(k, spec.n_heads)
    v = _gqa_expand(v, spec.n_heads)
    scale = spec.head_dim ** -0.5
    scores = torch.einsum("wbqhk,wbshk->wbhqs", q, k) * scale
    scores = _softcap(scores, spec.softcap)
    scores = torch.where(mask, scores.float(),
                         torch.full((), -1e30, device=scores.device))
    probs = F.softmax(scores, dim=-1).to(x.dtype)
    out = torch.einsum("wbhqs,wbshk->wbqhk", probs, v)
    return torch.einsum("wbqhk,whkd->wbqd", out, params["wo"])


def attention_flash(params, spec: AttnSpec, x, positions, *,
                    window: int | None = None,
                    prefix_len: int | None = None, block_q: int = 512,
                    block_k: int = 1024):
    """Causal (optionally sliding-window / prefix) chunked attention, the
    reference's ``attention_flash`` (models/common.py:206) in its block
    order: per query block of ``block_q``, key blocks of ``block_k`` with
    the running (max, sum, acc) online softmax, each block's scores
    softcapped (``spec.softcap``) and then masked at -1e30,
    out = acc / max(sum, 1e-30).  Every key block is computed, as the
    reference computes it (a wholly masked one adds exact zeros once a
    live block has set the running max).  x: (W, B, S, D); positions:
    (S,).  S must be a multiple of both block sizes (capped at S), as the
    reference asserts."""
    W, B, S, _ = x.shape
    bq, bk = min(block_q, S), min(block_k, S)
    if S % bq or S % bk:
        raise ValueError(f"attention_flash: seq {S} is not a multiple of "
                         f"block_q {bq} and block_k {bk}")
    q, k, v = _project_qkv(params, spec, x, positions)
    H, Dh = spec.n_heads, spec.head_dim
    # (W, B, H, S, Dh), the reference's per-block layout
    q, k, v = (t.permute(0, 1, 3, 2, 4)
               for t in (q, _gqa_expand(k, H), _gqa_expand(v, H)))
    scale = Dh ** -0.5
    outs = []
    for q0 in range(0, S, bq):
        q_i = q[:, :, :, q0:q0 + bq] * scale
        qp = positions[q0:q0 + bq]
        m = torch.full((W, B, H, bq), -math.inf, device=x.device)
        l = torch.zeros((W, B, H, bq), device=x.device)
        acc = torch.zeros((W, B, H, bq, Dh), device=x.device)
        for k0 in range(0, S, bk):
            k_j, v_j = k[:, :, :, k0:k0 + bk], v[:, :, :, k0:k0 + bk]
            kp = positions[k0:k0 + bk]
            s = torch.einsum("wbhqd,wbhkd->wbhqk", q_i, k_j).float()
            s = _softcap(s, spec.softcap)
            msk = causal_mask(qp, kp)
            if window is not None:
                msk = msk & (qp[:, None] - kp[None, :] < window)
            if prefix_len is not None:
                msk = msk | (kp[None, :] < prefix_len)
            s = torch.where(msk, s, torch.full((), -1e30, device=x.device))
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = (acc * alpha[..., None]
                   + torch.einsum("wbhqk,wbhkd->wbhqd", p.to(v_j.dtype),
                                  v_j).float())
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.to(x.dtype))
    out = torch.cat(outs, dim=3).permute(0, 1, 3, 2, 4)   # (W,B,S,H,Dh)
    return torch.einsum("wbqhk,whkd->wbqd", out, params["wo"])


# the dim of the heads in each head-indexed leaf of an attention's params
# (after the worker axis): wq/wk/wv (W, D, H|KV, Dh), wo (W, H, Dh, D),
# the biases (W, H|KV, Dh)
_HEAD_DIMS = {"wq": 2, "wk": 2, "wv": 2, "wo": 1, "bq": 1, "bk": 1, "bv": 1}


def head_shards(p_attn):
    """The 1-D mesh that shards every head-indexed leaf of ``p_attn`` (DTensor
    leaves, launch/tensor_parallel.py) along its heads, or None."""
    from torch.distributed.tensor import DTensor, Shard
    wq = p_attn["wq"]
    if not isinstance(wq, DTensor) or wq.device_mesh.ndim != 1:
        return None
    for name, dim in _HEAD_DIMS.items():
        if name in p_attn and p_attn[name].placements != (Shard(dim),):
            return None
    return wq.device_mesh


def attend_heads(fn, p_attn, spec: AttnSpec, x, *args, **kw):
    """``fn(p_attn, spec, x, *args, **kw)``, an attention that projects x,
    attends per head and projects out.  Where :func:`head_shards` finds
    its heads sharded, each rank runs ``fn`` on its own heads — the
    leaves' local shards, the spec's head counts divided by the mesh size,
    x gathered whole — and the output is the ``Partial`` sum of the ranks'
    parts, as the output projection sums over the heads: the same
    function, since heads are independent.  Each part's gradient is
    handed back as a ``Partial`` where a whole tensor fed every rank (x,
    the qk-norm scales) and as the shard's own on the sharded leaves."""
    mesh = head_shards(p_attn)
    if mesh is None:
        return fn(p_attn, spec, x, *args, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def local(t):
        if t.placements == (Replicate(),):
            return t.to_local(grad_placements=(Partial(),))
        return t.to_local()
    m = mesh.size()
    x = x.redistribute(mesh, (Replicate(),))
    part = fn(tree_map(local, p_attn),
              dataclasses.replace(spec, n_heads=spec.n_heads // m,
                                  n_kv_heads=spec.n_kv_heads // m),
              local(x), *args, **kw)
    # backward keeps the replicated gradient whole on each rank
    return DTensor.from_local(part, mesh, (Partial(),))


def attention_decode(params, spec: AttnSpec, x, pos: int, cache, *,
                     window: int | None = None):
    """One query position against a KV cache.  x: (W, B, 1, D); pos: host
    int, the current position; cache: k/v (W, B, S_max, KV, Dh) bf16.

    Writes this step's k/v into the cache at ``pos`` IN PLACE (the
    reference returns an updated copy) and returns out (W, B, 1, D).  The
    scores are taken over positions 0..pos only, and with a ``window``
    over pos - window + 1..pos only: the reference masks the rest to
    -1e30, which softmax turns into exact zeros.  The bf16 cache is read
    as f32 at the products, as JAX promotes ``f32 q · bf16 k``."""
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, spec, x, positions)
    cache["k"][:, :, pos] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, pos] = v_new[:, :, 0].to(cache["v"].dtype)
    lo = 0 if window is None else max(0, pos - window + 1)
    k = _gqa_expand(cache["k"][:, :, lo:pos + 1].float(), spec.n_heads)
    v = _gqa_expand(cache["v"][:, :, lo:pos + 1].float(), spec.n_heads)
    scale = spec.head_dim ** -0.5
    s = torch.einsum("wbqhk,wbshk->wbhqs", q * scale, k)
    s = _softcap(s.float(), spec.softcap)
    p = F.softmax(s, dim=-1).to(x.dtype)
    out = torch.einsum("wbhqs,wbshk->wbqhk", p, v)
    return torch.einsum("wbqhk,whkd->wbqd", out, params["wo"])


def init_kv_cache(batch, max_seq, n_kv_heads, head_dim,
                  dtype=torch.bfloat16, device=None):
    """One model's zero KV cache: k/v (batch, max_seq, KV, Dh), bf16 as in
    the reference."""
    shape = (batch, max_seq, n_kv_heads, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def activation(name):
    return {
        "silu": F.silu,
        "gelu": lambda x: F.gelu(x, approximate="tanh"),
        "gelu_exact": F.gelu,
        "relu": F.relu,
    }[name]
