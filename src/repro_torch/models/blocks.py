"""Per-layer blocks: init, full-sequence apply (train / prefill, optionally
returning the decode cache) and single-token decode against a cache.

Layer types: 'G' (global attention), 'L' (sliding-window attention) and
'E' (whisper's bidirectional encoder attention), each with the GLU MLP,
the plain MLP with biases (``not cfg.glu_mlp``) or, when the config has
experts, the MoE FFN (models/moe.py); 'R' (RG-LRU, models/rglru.py); 'S'
(mamba-2 SSD), for serving and for training (the SSD scan differentiates
through kernel B5b on the card).  Decoder layers of a ``cross_attention``
config (whisper) attend to the encoder's output after their mixer.  An
attention layer at seq >= FLASH_MIN_SEQ with seq % 512 == 0 takes the
chunked ``attention_flash`` ('L' with its window, 'G' with the prefix),
as the reference's ``_attend_full`` does; shorter ones the dense form
under the encoder's all-ones, the prefix, the sliding or the causal mask.
The sharding hints (``models/hints.py constrain``) stand at the
reference's points under its conditions (``cfg.attn_batch_shard``,
``cfg.seq_parallel``); under ``seq_parallel`` each matmul segment's
input is also ``gathered`` (``_segment_in``) and its output
reduce-scattered back to the sequence-sharded stream (``_segment_out``),
where XLA puts them for the reference.  On plain tensors (or with no
mesh ambient) every hint returns its argument, so no value changes.
Remat changes none either and is left out.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from .common import (AttnSpec, _gqa_expand, attend_heads, attend_keys,
                     attention_decode, attention_dense, attention_flash,
                     cache_split, causal_mask, head_shards, heads_kv,
                     init_attention, init_kv_cache, make_norm, placed,
                     prefix_mask, project_kv, sliding_mask, split_attend)
from .hints import WORKERS, constrain, gathered
from .mlp import apply_mlp, apply_mlp_nonglu, init_mlp, init_mlp_nonglu
from .moe import apply_moe, apply_moe_decode, init_moe
from .rglru import (apply_rglru, apply_rglru_decode, init_rglru,
                    init_rglru_cache)
from .ssm import apply_ssd, apply_ssd_decode, init_ssd, init_ssd_cache

# the reference switches to its chunked attention_flash at this length
FLASH_MIN_SEQ = 2048

# the layer types the port carries; attention ones are 'G', 'L' and 'E'
LAYER_TYPES = ("G", "L", "E", "R", "S")


def not_ported(cfg: ModelConfig, what: str) -> NotImplementedError:
    """The error for a feature of ``cfg`` the port does not carry (every
    config of the reference is carried; a layer type none of them has
    raises this)."""
    return NotImplementedError(f"{cfg.name}: {what} not ported")


def attn_spec(cfg: ModelConfig) -> AttnSpec:
    return AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        qkv_bias=cfg.qkv_bias,
        qk_norm=cfg.qk_norm,
        rope_theta=cfg.rope_theta,
        use_rope=cfg.use_rope,
        softcap=cfg.attn_softcap,
    )


def cross_spec(cfg: ModelConfig) -> AttnSpec:
    """Cross-attention: no RoPE (positions don't align), no qk-norm."""
    return AttnSpec(
        d_model=cfg.d_model,
        n_heads=cfg.n_heads,
        n_kv_heads=cfg.n_kv_heads,
        head_dim=cfg.resolved_head_dim,
        use_rope=False,
    )


def check_supported(cfg: ModelConfig) -> None:
    """Raise for a layer type the port does not carry, for serving and
    training alike.  Every feature of the reference's ten configs is
    ported: 'G', 'L' and 'E' attention (dense, flash, prefix, windowed,
    softcapped), the GLU, plain and MoE FFNs, 'R' and 'S' layers,
    cross-attention, the audio and vision frontends, sinusoidal
    positions, LayerNorm and RMSNorm, scaled embeddings."""
    layer_types = set(cfg.pattern_cycle)
    if not layer_types <= set(LAYER_TYPES):
        raise not_ported(cfg, f"layer types {sorted(layer_types)} (only "
                              f"{', '.join(map(repr, LAYER_TYPES))})")


def _layer_type(cfg: ModelConfig, ltype: str) -> None:
    if ltype not in LAYER_TYPES:
        raise not_ported(cfg, f"layer type {ltype!r}")


def _ssm_dims(cfg: ModelConfig) -> dict:
    return {"head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
            "n_groups": cfg.ssm_groups}


def init_layer(generator, cfg: ModelConfig, ltype: str, *,
               is_decoder=True, dtype=torch.float32, device=None):
    """One layer's params, the reference's leaves: decoder layers of a
    ``cross_attention`` config add ``ln_cross`` and ``cross``; the FFN is
    the MoE on decoder layers with experts, else the GLU MLP, else (``not
    cfg.glu_mlp``) the plain MLP with biases."""
    _layer_type(cfg, ltype)
    norm_init, _ = make_norm(cfg.norm_type)
    p = {"ln1": norm_init(cfg.d_model, dtype, device)}
    if ltype in ("G", "L", "E"):
        p["attn"] = init_attention(generator, attn_spec(cfg), dtype, device)
    elif ltype == "R":
        p["rglru"] = init_rglru(generator, cfg.d_model,
                                cfg.lru_width or cfg.d_model, dtype=dtype,
                                device=device)
    else:
        p["ssm"] = init_ssd(generator, cfg.d_model, expand=cfg.ssm_expand,
                            dtype=dtype, device=device, **_ssm_dims(cfg))
    if cfg.cross_attention and is_decoder and ltype != "E":
        p["ln_cross"] = norm_init(cfg.d_model, dtype, device)
        p["cross"] = init_attention(generator, cross_spec(cfg), dtype,
                                    device)
    if cfg.d_ff > 0 and ltype != "S":
        p["ln2"] = norm_init(cfg.d_model, dtype, device)
        if cfg.n_experts > 0 and is_decoder:
            p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff,
                                cfg.n_experts, dtype, device)
        elif cfg.glu_mlp:
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                device)
        else:
            p["mlp"] = init_mlp_nonglu(generator, cfg.d_model, cfg.d_ff,
                                       dtype, device)
    return p


def init_layer_cache(cfg: ModelConfig, ltype: str, batch, max_seq,
                     dtype=torch.bfloat16, device=None, cross_seq=0):
    """One model's zero decode cache of one layer (the reference's: a
    full-length KV cache for 'L' too, not a ring of its window); with
    ``cross_seq`` on a ``cross_attention`` config, zero bf16 ``cross_k``
    and ``cross_v`` of (batch, cross_seq, KV, Dh) beside it.  'E' layers
    have no decode cache (the reference raises for them too)."""
    _layer_type(cfg, ltype)
    if ltype in ("G", "L"):
        c = init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                          cfg.resolved_head_dim, dtype, device)
    elif ltype == "R":
        c = init_rglru_cache(batch, cfg.lru_width or cfg.d_model,
                             device=device)
    elif ltype == "S":
        c = init_ssd_cache(batch, cfg.d_model, expand=cfg.ssm_expand,
                           device=device, **_ssm_dims(cfg))
    else:
        raise ValueError(f"{cfg.name}: no decode cache for layer type "
                         f"{ltype!r}")
    if cfg.cross_attention and cross_seq:
        c["cross_k"] = torch.zeros(
            (batch, cross_seq, cfg.n_kv_heads, cfg.resolved_head_dim),
            dtype=dtype, device=device)
        c["cross_v"] = torch.zeros_like(c["cross_k"])
    return c


def _attend_full(cfg: ModelConfig, spec, p_attn, h, positions, ltype,
                 prefix_len):
    """The full-sequence attention of a 'G', 'L' or 'E' layer, in the
    reference's branch order: at seq >= FLASH_MIN_SEQ with seq % 512 == 0
    the chunked ``attention_flash`` (causal, with 'L''s window, and
    ``prefix_len`` where the layer is 'G' or has no window — an 'E' layer
    there too, causal: the reference's, which no config reaches, since
    whisper's encoder_seq is 1500); otherwise the dense form under the
    first mask that applies of: all ones ('E'), the prefix mask, the
    sliding mask, the causal mask."""
    seq = h.shape[2]
    window = cfg.sliding_window if ltype == "L" else None
    batch_shard = _batch_shard(cfg, h)
    if batch_shard:
        h = constrain(h, WORKERS, "model", None, None)
    if seq >= FLASH_MIN_SEQ and seq % 512 == 0:
        out = attend_heads(
            attention_flash, p_attn, spec, h, positions, window=window,
            prefix_len=prefix_len if ltype == "G" or window is None
            else None)
        if batch_shard:
            out = constrain(out, WORKERS, "model", None, None)
        return out
    if ltype == "E":                   # encoder: bidirectional
        mask = torch.ones((seq, seq), dtype=torch.bool, device=h.device)
    elif prefix_len:
        mask = prefix_mask(positions, positions, prefix_len)
    elif window is not None:
        mask = sliding_mask(positions, positions, window)
    else:
        mask = causal_mask(positions, positions)
    return attend_heads(attention_dense, p_attn, spec, h, positions, mask)


def apply_layer(cfg: ModelConfig, ltype: str, p, x, positions, *,
                enc_out=None, prefix_len=0, return_cache=False,
                cache_len=None):
    """Full-sequence layer (pre-norm residual) on W worker replicas:
    x + mixer(norm1(x)); then, on a decoder layer with cross-attention and
    ``enc_out`` (W, B, S_enc, D), + cross(norm_cross(x), enc_out); then +
    ffn(norm2(x)) where the layer has one (the GLU or plain MLP, or the MoE
    FFN).  x: (W, B, S, D); p: leaves with a leading worker axis;
    positions: (S,); ``prefix_len``: the vision prefix of a prefix-LM (0:
    none).  Returns (x, aux, cache), as the reference does: aux (W,) the
    MoE router's load-balance loss (None without MoE, where the
    reference's is 0); cache None unless ``return_cache``: for 'G', 'L'
    and 'E' the bf16 KV cache of ``cache_len`` positions (W, B, L, KV, Dh)
    holding this prompt's k/v, with the cross layers' bf16 ``cross_k`` and
    ``cross_v`` (W, B, S_enc, KV, Dh) projected from ``enc_out``; for 'R'
    and 'S' a ZERO conv cache and the final state, as the reference
    returns them (its post-conv tail is computed and dropped)."""
    _layer_type(cfg, ltype)
    _, norm = make_norm(cfg.norm_type)
    if cfg.seq_parallel:
        # sequence parallelism: the residual stream's S axis over `model`
        # between the matmul segments
        x = constrain(x, WORKERS, None, "model", None)
    h = _segment_in(cfg, norm(p["ln1"], x))
    cache = None
    if ltype in ("G", "L", "E"):
        seq = x.shape[2]
        spec = attn_spec(cfg)
        out = _segment_out(cfg, _attend_full(cfg, spec, p["attn"], h,
                                             positions, ltype, prefix_len))
        if return_cache:
            # recompute K/V once for the cache, as the reference does
            k, v = heads_kv(project_kv, p["attn"], spec, h, positions)
            cache = {"k": prompt_cache(k, cache_len or seq),
                     "v": prompt_cache(v, cache_len or seq)}
    elif ltype == "R":
        if _batch_shard(cfg, h):
            # the batch-sharded recurrent block
            h = constrain(h, WORKERS, "model", None, None)
        out, h_fin = apply_rglru(p["rglru"], h)
        out = _segment_out(cfg, out)
        if return_cache:
            K = p["rglru"]["conv_w"].shape[1]
            cache = {"conv": _zeros_beside(
                h_fin, x.shape[:2] + (K - 1, h_fin.shape[-1]), x.dtype),
                "h": h_fin}
    else:
        out, h_fin = apply_ssd(p["ssm"], h, chunk=cfg.ssm_chunk,
                               **_ssm_dims(cfg))
        out = _segment_out(cfg, out)
        if return_cache:
            K, C = p["ssm"]["conv_w"].shape[1:]
            cache = {"conv": _zeros_beside(h_fin, x.shape[:2] + (K - 1, C),
                                           torch.float32),
                     "ssm": h_fin}
    x = x + out
    if "cross" in p and enc_out is not None:
        out, k, v = _cross_full(cfg, p["cross"], norm(p["ln_cross"], x),
                                enc_out, want_kv=return_cache)
        x = x + out
        if return_cache and cache is not None:
            cache["cross_k"] = prompt_cache(k, k.shape[2])
            cache["cross_v"] = prompt_cache(v, v.shape[2])
    if cfg.seq_parallel:
        x = constrain(x, WORKERS, None, "model", None)
    x, aux = _ffn(cfg, p, x, norm)
    return x, aux, cache


def _zeros_beside(state, shape, dtype):
    """The zero conv cache an 'R' or 'S' prefill returns beside its final
    ``state``: replicated zeros on the state's mesh where the state is
    placed (the tensor-parallel prefill, which redistributes every cache
    leaf to ``cache_pspec``'s placement at its end)."""
    if not placed(state):
        return torch.zeros(shape, dtype=dtype, device=state.device)
    from torch.distributed.tensor import DTensor, Replicate
    return DTensor.from_local(
        torch.zeros(shape, dtype=dtype, device=state.device),
        state.device_mesh, (Replicate(),) * state.device_mesh.ndim)


def prompt_cache(t, length: int):
    """A prompt's k or v (W, B, S, KV, Dh) as a bf16 cache leaf of
    ``length`` positions, zeros after S.  A DTensor (the tensor-parallel
    prefill) keeps its placements, its local shard padded; where it is a
    ``Partial`` sum (a projection over a sharded d_model) it stays f32,
    for launch/tensor_parallel.py to reduce before the cast."""
    from torch.distributed.tensor import DTensor, Partial
    dtype = torch.bfloat16
    local = t.to_local() if placed(t) else t
    if placed(t) and any(isinstance(p, Partial) for p in t.placements):
        dtype = torch.float32
    out = local.new_zeros(local.shape[:2] + (length,) + local.shape[3:],
                          dtype=dtype)
    out[:, :, :local.shape[2]] = local.to(dtype)
    if not placed(t):
        return out
    return DTensor.from_local(out, t.device_mesh, t.placements)


def _batch_shard(cfg: ModelConfig, h) -> bool:
    """Batch-sharded attention / recurrent block: the config asks for it
    and each worker's batch (h (W, B, S, D)) divides over 16."""
    return cfg.attn_batch_shard and h.shape[1] >= 16 and h.shape[1] % 16 == 0


def _ffn(cfg: ModelConfig, p, x, norm):
    """The layer's FFN residual and its aux loss (W,), None without MoE.
    On placed leaves the MoE (models/moe.py's expert parallelism) takes
    its input whole (``_segment_in``) and its ``Partial`` output is summed
    over ``model`` once (``_segment_out``'s reduce-scatter, else
    :func:`_summed`)."""
    if "moe" in p:
        h, aux = apply_moe(p["moe"], _segment_in(cfg, norm(p["ln2"], x)),
                           cfg.experts_per_token, act=cfg.act,
                           capacity_factor=cfg.capacity_factor,
                           dispatch_groups=cfg.moe_dispatch_groups)
        return x + _summed(_segment_out(cfg, h)), aux
    if "mlp" in p:
        x = x + _segment_out(cfg, _mlp(cfg, p["mlp"],
                                       _segment_in(cfg, norm(p["ln2"], x))))
    return x, None


def _summed(t):
    """A ``Partial`` DTensor all-reduced to ``Replicate()``; anything else
    itself."""
    if not placed(t):
        return t
    from torch.distributed.tensor import Partial, Replicate
    if not any(isinstance(p, Partial) for p in t.placements):
        return t
    return t.redistribute(t.device_mesh, (Replicate(),) * t.device_mesh.ndim)


def _segment_in(cfg: ModelConfig, h):
    """A matmul segment's input under ``cfg.seq_parallel``: the
    sequence-sharded stream all-gathered whole (models/hints.py
    ``gathered``), as XLA does for the reference; DTensor's einsum would
    flatten the sharded sequence into the batch, which torch 2.11
    refuses."""
    return gathered(h) if cfg.seq_parallel else h


def _segment_out(cfg: ModelConfig, out):
    """A matmul segment's output under ``cfg.seq_parallel``: its sum over
    ``model`` (a ``Partial``) reduce-scattered onto the sequence-sharded
    stream, as XLA does for the reference.  Backward all-gathers the
    gradient whole (a ``Partial`` source takes a ``Replicate`` gradient)
    before the einsum's own."""
    if not cfg.seq_parallel:
        return out
    return constrain(out, WORKERS, None, "model", None)


def _mlp(cfg: ModelConfig, p_mlp, h):
    return (apply_mlp(p_mlp, h, cfg.act) if cfg.glu_mlp
            else apply_mlp_nonglu(p_mlp, h, cfg.act))


def _cross_full(cfg: ModelConfig, p_cross, x, enc_out, want_kv=False):
    """Full-sequence cross-attention: decoder queries of x (W, B, S, D)
    against the encoder output enc_out (W, B, S_enc, D).  Returns (out,
    k, v), k/v (W, B, S_enc, KV, Dh) the encoder's keys and values, which
    a prefill keeps as its cross cache (the reference projects them a
    second time for it; cross_spec has no bias, norm or RoPE).  Where the
    heads are sharded over ``model`` (launch/tensor_parallel.py), each
    rank attends with its own heads (``attend_heads``), and k/v are
    projected apart on the DTensor leaves when ``want_kv`` (the
    tensor-parallel prefill's cache), else None."""
    spec = cross_spec(cfg)
    if head_shards(p_cross) is not None:
        out = attend_heads(_cross_heads, p_cross, spec, x, enc_out)
        return (out, *(heads_kv(lambda p, _, e: _cross_kv(p, e), p_cross,
                                spec, enc_out) if want_kv else (None, None)))
    k, v = _cross_kv(p_cross, enc_out)
    return _cross_attend(spec, p_cross, x, k, v), k, v


def _cross_kv(p_cross, enc_out):
    return (torch.einsum("wbsd,wdhk->wbshk", enc_out, p_cross["wk"]),
            torch.einsum("wbsd,wdhk->wbshk", enc_out, p_cross["wv"]))


def _cross_heads(p_cross, spec, x, enc_out):
    """The cross-attention of ``spec``'s heads: k/v projected from the
    encoder output, then :func:`_cross_attend`."""
    return _cross_attend(spec, p_cross, x, *_cross_kv(p_cross, enc_out))


def _cross_decode(cfg: ModelConfig, p_cross, x, cache):
    """One token's cross-attention against the bf16 cross cache, read in
    x's dtype as the reference reads it.  A cross cache placed by
    ``cache_pspec`` (launch/tensor_parallel.py) is read as
    ``models/common.py _decode_placed`` reads a self-attention cache,
    over every encoder position: each rank's KV heads with its own query
    heads, or the whole query against each rank's positions combined
    over the mesh, or the whole replicated cache."""
    spec = cross_spec(cfg)
    kc, vc = cache["cross_k"], cache["cross_v"]
    if not placed(kc):
        return _cross_attend(spec, p_cross, x, kc.to(x.dtype),
                             vc.to(x.dtype))
    from torch.distributed.tensor import DTensor, Replicate
    split = cache_split(kc)
    kl, vl = kc.to_local(), vc.to_local()
    if split == "heads":
        return attend_heads(_cross_cached, p_cross, spec, x, kl, vl)
    q = torch.einsum("wbsd,wdhk->wbshk", x, p_cross["wq"]).full_tensor()
    if split == "whole":
        out = attend_keys(spec, q, kl, vl, q.dtype)
    else:
        out = split_attend(spec, q, kl, vl, kc.device_mesh)
    out = DTensor.from_local(out, kc.device_mesh, (Replicate(),))
    return torch.einsum("wbqhk,whkd->wbqd", out, p_cross["wo"])


def _cross_cached(p_cross, spec, x, k, v):
    """:func:`_cross_attend` of ``spec``'s heads on their cached k/v."""
    return _cross_attend(spec, p_cross, x, k.to(x.dtype), v.to(x.dtype))


def _cross_attend(spec, p_cross, x, k, v):
    """Decoder queries of x (W, B, Sq, D) against the encoder's k/v, no
    mask, in the reference's order: the scale on q before the product,
    the softmax in f32, its probabilities cast to x's dtype."""
    q = torch.einsum("wbsd,wdhk->wbshk", x, p_cross["wq"])
    k = _gqa_expand(k, spec.n_heads)
    v = _gqa_expand(v, spec.n_heads)
    s = torch.einsum("wbqhk,wbshk->wbhqs", q * spec.head_dim ** -0.5, k)
    probs = F.softmax(s.float(), dim=-1).to(x.dtype)
    out = torch.einsum("wbhqs,wbshk->wbqhk", probs, v)
    return torch.einsum("wbqhk,whkd->wbqd", out, p_cross["wo"])


def apply_layer_decode(cfg: ModelConfig, ltype: str, p, x, pos: int, cache):
    """One token on W replicas against this layer's cache, which it updates
    IN PLACE (the reference returns a new cache); the cross-attention
    leaves ``cross_k``/``cross_v``, where the cache has them, are read and
    left alone.  x: (W, B, 1, D); pos: host int.  Returns x."""
    _layer_type(cfg, ltype)
    _, norm = make_norm(cfg.norm_type)
    h = norm(p["ln1"], x)
    if ltype in ("G", "L"):
        window = cfg.sliding_window if ltype == "L" else None
        x = x + attention_decode(p["attn"], attn_spec(cfg), h, pos, cache,
                                 window=window)
    elif ltype in ("R", "S"):
        if ltype == "R":
            out, new = apply_rglru_decode(p["rglru"], h, cache)
        else:
            out, new = apply_ssd_decode(p["ssm"], h, cache, **_ssm_dims(cfg))
        for name, t in new.items():
            cache[name].copy_(t)
        x = x + out
    else:
        raise ValueError(f"{cfg.name}: no decode for layer type {ltype!r}")
    if "cross" in p and "cross_k" in cache:
        x = x + _cross_decode(cfg, p["cross"], norm(p["ln_cross"], x), cache)
    if "moe" in p:
        out, _ = apply_moe_decode(p["moe"], norm(p["ln2"], x),
                                  cfg.experts_per_token, act=cfg.act)
        x = x + _summed(out)
    elif "mlp" in p:
        x = x + _mlp(cfg, p["mlp"], norm(p["ln2"], x))
    return x
