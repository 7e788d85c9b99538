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


def rmsnorm(params, x, eps=1e-6, combine=None):
    """``combine``: where x is a rank's even share of the normalised dim,
    the ranks' means of squares -> the whole dim's (models/ssm.py's gated
    norm under tensor parallelism)."""
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    if combine is not None:
        var = combine(var)
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


# each projection's (weight, bias, qk-norm, RoPE)
_PROJECTIONS = {"q": ("wq", "bq", "q_norm", True),
                "k": ("wk", "bk", "k_norm", True),
                "v": ("wv", "bv", None, False)}


def _project(params, spec: AttnSpec, x, positions, which: str):
    """x: (W, B, S, D) -> the ``which`` ("q", "k" or "v") projection
    (W, B, S, H|KV, Dh): the bias, the qwen3-style per-head RMS norm
    (q and k) and RoPE (q and k) where the spec has them."""
    w, b, norm, rope = _PROJECTIONS[which]
    t = torch.einsum("wbsd,wdhk->wbshk", x, params[w])
    if spec.qkv_bias:
        t = t + per_worker(params[b], t.ndim)
    if spec.qk_norm and norm:
        t = rmsnorm(params[norm], t)
    if spec.use_rope and rope:
        t = apply_rope(t, positions, spec.rope_theta)
    return t


def _project_qkv(params, spec: AttnSpec, x, positions):
    """x: (W, B, S, D) -> q: (W, B, S, H, Dh), k/v: (W, B, S, KV, Dh)."""
    return tuple(_project(params, spec, x, positions, n) for n in "qkv")


def project_kv(params, spec: AttnSpec, x, positions):
    """k, v of x (W, B, S, KV, Dh) (:func:`_project`)."""
    return (_project(params, spec, x, positions, "k"),
            _project(params, spec, x, positions, "v"))


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
# the biases (W, H|KV, Dh); the query side's and the key/value side's
_Q_HEAD_DIMS = {"wq": 2, "wo": 1, "bq": 1}
_KV_HEAD_DIMS = {"wk": 2, "wv": 2, "bk": 1, "bv": 1}


def _kv_split(p_attn) -> bool:
    from torch.distributed.tensor import Shard
    return all(p_attn[n].placements == (Shard(d),)
               for n, d in _KV_HEAD_DIMS.items() if n in p_attn)


def head_shards(p_attn):
    """The 1-D mesh that shards ``p_attn``'s query heads (DTensor leaves,
    launch/tensor_parallel.py): wq, wo and bq each sharded along its
    heads, and the key/value heads either sharded alike or fewer, their
    count dividing the mesh's size (one KV head for several ranks' query
    heads: paligemma's 1 KV head beside its 4 heads at model 2); or
    None."""
    from torch.distributed.tensor import DTensor, Shard
    wq = p_attn["wq"]
    if not isinstance(wq, DTensor) or wq.device_mesh.ndim != 1:
        return None
    for name, dim in _Q_HEAD_DIMS.items():
        if name in p_attn and p_attn[name].placements != (Shard(dim),):
            return None
    mesh = wq.device_mesh
    if not _kv_split(p_attn) and mesh.size() % p_attn["wk"].shape[2]:
        return None
    return mesh


def attend_heads(fn, p_attn, spec: AttnSpec, x, *args, **kw):
    """``fn(p_attn, spec, x, *args, **kw)``, an attention that projects x,
    attends per head and projects out.  Where :func:`head_shards` finds
    its query heads sharded, each rank runs ``fn`` on its own heads — the
    leaves' local shards, the spec's head counts divided by the mesh size,
    x and every DTensor of ``args`` (a cross-attention's encoder output)
    gathered whole — and the output is the ``Partial`` sum of the ranks'
    parts, as the output projection sums over the heads: the same
    function, since heads are independent.  Where the KV heads do not
    split, each rank reads the one KV head its query heads share, its
    leaves gathered whole and that head taken (the GQA grouping: query
    head h reads KV head h // (H / KV)).  Each part's gradient is handed
    back as a ``Partial`` where a whole tensor fed every rank (x, the
    encoder output, the qk-norm scales, the gathered KV leaves) and as
    the shard's own on the sharded leaves."""
    mesh = head_shards(p_attn)
    if mesh is None:
        return fn(p_attn, spec, x, *args, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate

    def local(t):
        if t.placements == (Replicate(),):
            return t.to_local(grad_placements=(Partial(),))
        return t.to_local()

    def whole(t):
        return whole_local(t, True)
    m = mesh.size()
    kv_split = _kv_split(p_attn)

    def leaf(name, t):
        if isinstance(t, dict):
            return tree_map(local, t)
        if name in _KV_HEAD_DIMS and not kv_split:
            kv_head = mesh.get_local_rank() // (m // spec.n_kv_heads)
            return whole(t).narrow(_KV_HEAD_DIMS[name], kv_head, 1)
        return local(t)
    part = fn({n: leaf(n, t) for n, t in p_attn.items()},
              dataclasses.replace(
                  spec, n_heads=spec.n_heads // m,
                  n_kv_heads=spec.n_kv_heads // m if kv_split else 1),
              whole(x), *map(whole, args), **kw)
    # backward keeps the replicated gradient whole on each rank
    return DTensor.from_local(part, mesh, (Partial(),))


def heads_kv(fn, p_attn, spec: AttnSpec, x, *args):
    """``fn(p_attn, spec, x, *args) -> (k, v)``, keys and values (W, B, S,
    KV, Dh) projected for a cache, on DTensor leaves whose query heads
    :func:`head_shards` splits: each rank projects from local tensors —
    its own KV heads where they split alike (k/v ``Shard`` on the KV dim),
    every KV head from the leaves gathered whole where they do not
    (``Replicate``) — as :func:`attend_heads` runs the attention: DTensor's
    einsum would merge a sharded KV dim into its batch, which it refuses
    where the dim is 1 long (one KV head at ``model`` 1).  Elsewhere
    ``fn`` itself."""
    mesh = head_shards(p_attn)
    if mesh is None:
        return fn(p_attn, spec, x, *args)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    split = _kv_split(p_attn)
    get = (lambda t: t.to_local()) if split else _whole
    p = {n: tree_map(get, t) if isinstance(t, dict) else get(t)
         for n, t in p_attn.items() if n in _KV_HEAD_DIMS or n == "k_norm"}
    if split:
        spec = dataclasses.replace(
            spec, n_kv_heads=spec.n_kv_heads // mesh.size())
    place = (Shard(3),) if split else (Replicate(),)
    return tuple(DTensor.from_local(t, mesh, place) for t in
                 fn(p, spec, _whole(x), *map(_whole, args)))


def attention_decode(params, spec: AttnSpec, x, pos: int, cache, *,
                     window: int | None = None):
    """One query position against a KV cache.  x: (W, B, 1, D); pos: host
    int, the current position; cache: k/v (W, B, S_max, KV, Dh) bf16.

    Writes this step's k/v into the cache at ``pos`` IN PLACE (the
    reference returns an updated copy) and returns out (W, B, 1, D).  The
    scores are taken over positions 0..pos only, and with a ``window``
    over pos - window + 1..pos only: the reference masks the rest to
    -1e30, which softmax turns into exact zeros.  The bf16 cache is read
    as f32 at the products, as JAX promotes ``f32 q · bf16 k``.  A cache
    placed by ``launch/sharding.py cache_pspec`` (DTensor leaves,
    launch/tensor_parallel.py) takes :func:`_decode_placed`."""
    if placed(cache["k"]):
        return _decode_placed(params, spec, x, pos, cache, window)
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(params, spec, x, positions)
    cache["k"][:, :, pos] = k_new[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, pos] = v_new[:, :, 0].to(cache["v"].dtype)
    lo = _window_start(pos, window)
    out = attend_keys(spec, q, cache["k"][:, :, lo:pos + 1],
                      cache["v"][:, :, lo:pos + 1], x.dtype)
    return torch.einsum("wbqhk,whkd->wbqd", out, params["wo"])


def _window_start(pos: int, window: int | None) -> int:
    return 0 if window is None else max(0, pos - window + 1)


def attend_keys(spec: AttnSpec, q, k, v, dtype):
    """Queries q (W, B, Sq, H, Dh) against every one of the keys k/v
    (W, B, S, KV, Dh), read as f32: the scale on q before the product,
    the softcap, the softmax in f32, its probabilities cast to ``dtype``.
    Returns (W, B, Sq, H, Dh)."""
    k = _gqa_expand(k.float(), spec.n_heads)
    v = _gqa_expand(v.float(), spec.n_heads)
    s = torch.einsum("wbqhk,wbshk->wbhqs", q * spec.head_dim ** -0.5, k)
    p = F.softmax(_softcap(s.float(), spec.softcap), dim=-1).to(dtype)
    return torch.einsum("wbhqs,wbshk->wbqhk", p, v)


# ---------------------------------------------------------------------------
# decode against a placed cache (the tensor-parallel serve)
# ---------------------------------------------------------------------------

def placed(t) -> bool:
    """Whether ``t`` is a DTensor (a leaf placed over a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


def _whole(t):
    """A DTensor's whole value on every rank (all-gathered, or summed where
    it is a ``Partial``) as a plain tensor; a plain tensor itself."""
    return t.full_tensor() if placed(t) else t


# ---------------------------------------------------------------------------
# local computations on placed leaves (the SSD and RG-LRU mixers under
# tensor parallelism: models/ssm.py, models/rglru.py)
# ---------------------------------------------------------------------------

def whole_local(t, shared: bool):
    """A DTensor's whole value on every rank of its mesh as a plain tensor
    (all-gathered, or summed where it is a ``Partial``), for a computation
    on local tensors; a plain tensor itself.  Its gradient comes back as
    the computation made it: ``shared`` — each rank computes its own share
    of the function from the whole value (its heads, its channels), so the
    ranks' gradients are summed over the mesh (a ``Partial``); else every
    rank computes the same, and its gradient is the same on every rank
    (``Replicate``)."""
    if not placed(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    mesh = t.device_mesh
    whole = (t if all(isinstance(p, Replicate) for p in t.placements)
             else t.redistribute(mesh, (Replicate(),) * mesh.ndim))
    return whole.to_local(
        grad_placements=(Partial(),) * mesh.ndim if shared else None)


def mean_over(local, mesh):
    """The mean over the ranks of the 1-D ``mesh`` of each rank's
    ``local`` (an all-reduce), on every rank, its gradient handed back to
    each rank's term."""
    from torch.distributed.tensor import DTensor, Partial
    return whole_local(DTensor.from_local(local / mesh.size(), mesh,
                                          (Partial(),)), True)


def gather_shards(local, mesh, dim: int, shared: bool = True):
    """The whole of a tensor whose even shards along ``dim`` the ranks of
    the 1-D ``mesh`` hold (``local`` this rank's), as a plain tensor on
    every rank: an all-gather, its gradient reduce-scattered back where
    each rank's use of the whole is its own share (``shared``, as
    :func:`whole_local`'s), else sliced."""
    from torch.distributed.tensor import DTensor, Shard
    shards = DTensor.from_local(local, mesh, (Shard(dim % local.ndim),))
    return whole_local(shards, shared)


def share_of(mesh, n: int) -> tuple[int, int, bool]:
    """(first, count, split) of this rank's share of ``n`` heads or
    channels on the 1-D ``mesh``: its 1/size of them where ``n`` divides
    over the mesh (``split``), else all ``n``."""
    m = mesh.size()
    if n % m:
        return 0, n, False
    return mesh.get_local_rank() * (n // m), n // m, True


def like_placed(like, local):
    """``local`` as a DTensor of ``like``'s mesh and placements (even
    shards): a cache leaf's new value, for ``copy_`` into the leaf."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(local, like.device_mesh, like.placements,
                              run_check=False)


def cache_split(c) -> str:
    """How ``cache_pspec`` placed a cache leaf c (..., B, S, KV, Dh) on its
    1-D mesh: "heads" (KV heads sharded), "seq" (the sequence sharded) or
    "whole" (replicated)."""
    from torch.distributed.tensor import Replicate, Shard
    (p,) = c.placements
    if isinstance(p, Replicate):
        return "whole"
    if isinstance(p, Shard) and p.dim in (c.ndim - 2, c.ndim - 3):
        return "heads" if p.dim == c.ndim - 2 else "seq"
    raise ValueError(f"a cache leaf placed {c.placements}: cache_pspec "
                     "shards the KV heads or the sequence, or replicates")


def _decode_placed(params, spec: AttnSpec, x, pos: int, cache, window):
    """:func:`attention_decode` on a cache placed by ``cache_pspec``.

    * KV heads split: each rank holds its KV heads at every position, and
      the query heads split alike (``head_shards``), so each rank runs the
      plain decode on its heads and its local shards (``attend_heads``,
      the write at ``pos`` its own) and the output projection sums the
      ranks' parts.
    * sequence split: q, k and v of this token are made whole on every
      rank (the projections' ``Partial`` sums over a sharded d_model
      reduced, sharded heads gathered: a token's worth, not the cache's).
      The rank holding ``pos`` writes k/v there; every rank scores ALL
      query heads against its own positions of [lo, pos]
      (:func:`split_attend`), the parts combined over the mesh; then
      ``wo`` (head- or d_model-sharded) takes each rank's share.  Where
      the query heads split but the KV heads do not (paligemma's 4/1 at
      model 2), the KV head is whole on no rank, so the ranks compute
      every head's scores on their range rather than their own heads'.
    * replicated: every rank writes and attends the whole cache, as the
      plain decode does, on the whole q, k and v.

    The cache is never sliced, gathered or redistributed as a DTensor:
    each rank reads its local shard."""
    from torch.distributed.tensor import DTensor, Replicate
    kc, vc = cache["k"], cache["v"]
    split = cache_split(kc)
    if split == "heads":
        if head_shards(params) is None:
            raise ValueError("a cache split over KV heads needs the query "
                             "and KV heads split alike (param_pspec)")
        return attend_heads(attention_decode, params, spec, x, pos,
                            {"k": kc.to_local(), "v": vc.to_local()},
                            window=window)
    positions = torch.full((1,), pos, dtype=torch.long, device=x.device)
    q, k_new, v_new = map(_whole, _project_qkv(params, spec, x, positions))
    kl, vl = kc.to_local(), vc.to_local()
    lo = _window_start(pos, window)
    mesh = kc.device_mesh
    if split == "whole":
        kl[:, :, pos] = k_new[:, :, 0].to(kl.dtype)
        vl[:, :, pos] = v_new[:, :, 0].to(vl.dtype)
        out = attend_keys(spec, q, kl[:, :, lo:pos + 1],
                          vl[:, :, lo:pos + 1], q.dtype)
    else:
        n = kl.shape[2]
        r0 = mesh.get_local_rank() * n           # this rank's first position
        if r0 <= pos < r0 + n:                   # the owner of pos writes
            kl[:, :, pos - r0] = k_new[:, :, 0].to(kl.dtype)
            vl[:, :, pos - r0] = v_new[:, :, 0].to(vl.dtype)
        a, b = max(lo, r0) - r0, max(min(pos + 1, r0 + n) - r0, 0)
        out = split_attend(spec, q, kl[:, :, a:max(a, b)],
                           vl[:, :, a:max(a, b)], mesh)
    out = DTensor.from_local(out, mesh, (Replicate(),))
    return torch.einsum("wbqhk,whkd->wbqd", out, params["wo"])


def split_attend(spec: AttnSpec, q, k, v, mesh):
    """:func:`attend_keys` of one query position over keys split along the
    sequence over the 1-D ``mesh`` (flash-decoding): this rank's keys k/v
    (W, B, S_r, KV, Dh), S_r possibly 0, give the partial max m, sum of
    exponentials l and weighted values acc of every head; the ranks'
    parts are all-gathered and combined, each scaled by exp(m_r - max).
    A rank with no key adds exactly nothing (m_r = -inf scales by 0, not
    by exp(-inf - -inf)).  q: (W, B, 1, H, Dh), whole on every rank.
    Returns (W, B, 1, H, Dh), the same on every rank."""
    from torch.distributed.tensor import DTensor, Shard
    W, B, _, H, Dh = q.shape
    if k.shape[2]:
        k = _gqa_expand(k.float(), H)
        v = _gqa_expand(v.float(), H)
        s = torch.einsum("wbqhk,wbshk->wbhqs", q * spec.head_dim ** -0.5, k)
        s = _softcap(s.float(), spec.softcap)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        l = p.sum(dim=-1, keepdim=True)
        acc = torch.einsum("wbhqs,wbshk->wbhqk", p, v)
    else:
        m = torch.full((W, B, H, 1, 1), -math.inf, device=q.device)
        l = torch.zeros((W, B, H, 1, 1), device=q.device)
        acc = torch.zeros((W, B, H, 1, Dh), device=q.device)
    part = torch.cat([m, l, acc], dim=-1)[None]
    parts = DTensor.from_local(part, mesh, (Shard(0),)).full_tensor()
    m_r = parts[..., :1]
    top = m_r.amax(dim=0)
    scale = torch.where(m_r == -math.inf, torch.zeros((), device=q.device),
                        torch.exp(m_r - top))
    out = ((parts[..., 2:] * scale).sum(dim=0)
           / (parts[..., 1:2] * scale).sum(dim=0))
    return out.to(q.dtype).permute(0, 1, 3, 2, 4)


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
