"""Per-layer blocks: init, full-sequence apply (train / prefill, optionally
returning the decode cache) and single-token decode against a cache.

This port carries the 'G' (global attention) layer with the GLU MLP — every
layer of the dense archs — and the 'S' (mamba-2 SSD) layer, for serving and
for training (the SSD scan differentiates through kernel B5b on the card).
A 'G' layer at seq >= FLASH_MIN_SEQ with seq % 512 == 0 takes the chunked
``attention_flash``, as the reference's ``_attend_full`` does; shorter
ones the dense form.  The reference's other layer types ('L', 'R', 'E'),
MoE and cross-attention raise NotImplementedError (ROADMAP.md queue A,
item 9).  Sharding hints, sequence parallelism and remat change no values
on one device and are left out.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import (AttnSpec, _project_qkv, attention_decode,
                     attention_dense, attention_flash, causal_mask,
                     init_attention, init_kv_cache, make_norm)
from .mlp import apply_mlp, init_mlp
from .ssm import apply_ssd, apply_ssd_decode, init_ssd, init_ssd_cache

# the reference switches to its chunked attention_flash at this length
FLASH_MIN_SEQ = 2048


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
    )


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any model feature the port does not carry, for serving
    and training alike: 'G' and 'S' layers are ported."""
    missing = []
    layer_types = set(cfg.pattern_cycle)
    if not layer_types <= {"G", "S"}:
        missing.append(f"layer types {sorted(layer_types)} (only 'G', 'S')")
    if cfg.n_experts:
        missing.append("MoE")
    if cfg.d_ff and not cfg.glu_mlp:
        missing.append("non-GLU MLP")
    if cfg.cross_attention or cfg.encoder_layers or cfg.frontend:
        missing.append("encoder / cross-attention / modality frontends")
    if not cfg.use_rope and layer_types & {"G", "L", "E"}:
        missing.append("absolute (sinusoidal) positions")
    if cfg.norm_type != "rmsnorm":
        missing.append(f"{cfg.norm_type}")
    if cfg.attn_softcap or cfg.logit_softcap or cfg.scale_embeddings:
        missing.append("softcaps / scaled embeddings (gemma family)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet — "
            "ROADMAP.md queue A, item 9 (remaining architectures)")


def _layer_type(ltype: str) -> None:
    if ltype not in ("G", "S"):
        raise NotImplementedError(
            f"layer type {ltype!r} not ported yet — ROADMAP.md queue A, "
            "item 9")


def _ssm_dims(cfg: ModelConfig) -> dict:
    return {"head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
            "n_groups": cfg.ssm_groups}


def init_layer(generator, cfg: ModelConfig, ltype: str, *,
               dtype=torch.float32, device=None):
    _layer_type(ltype)
    norm_init, _ = make_norm(cfg.norm_type)
    p = {"ln1": norm_init(cfg.d_model, dtype, device)}
    if ltype == "G":
        p["attn"] = init_attention(generator, attn_spec(cfg), dtype, device)
    else:
        p["ssm"] = init_ssd(generator, cfg.d_model, expand=cfg.ssm_expand,
                            dtype=dtype, device=device, **_ssm_dims(cfg))
    if cfg.d_ff > 0 and ltype != "S":
        p["ln2"] = norm_init(cfg.d_model, dtype, device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def init_layer_cache(cfg: ModelConfig, ltype: str, batch, max_seq,
                     dtype=torch.bfloat16, device=None):
    """One model's zero decode cache of one layer (the reference's)."""
    _layer_type(ltype)
    if ltype == "G":
        return init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype, device)
    return init_ssd_cache(batch, cfg.d_model, expand=cfg.ssm_expand,
                          device=device, **_ssm_dims(cfg))


def apply_layer(cfg: ModelConfig, ltype: str, p, x, positions, *,
                return_cache=False, cache_len=None):
    """Full-sequence layer (pre-norm residual) on W worker replicas:
    x + mixer(norm1(x)), then + mlp(norm2(x)) where the layer has one.
    x: (W, B, S, D); p: leaves with a leading worker axis; positions: (S,).
    Returns (x, cache) — cache None unless ``return_cache``: for 'G' the
    bf16 KV cache of ``cache_len`` positions (W, B, L, KV, Dh) holding this
    prompt's k/v; for 'S' a ZERO conv cache and the final SSD state, as the
    reference returns them (its post-conv tail is computed and dropped)."""
    _layer_type(ltype)
    _, norm = make_norm(cfg.norm_type)
    h = norm(p["ln1"], x)
    cache = None
    if ltype == "G":
        seq = x.shape[2]
        spec = attn_spec(cfg)
        if seq >= FLASH_MIN_SEQ and seq % 512 == 0:
            out = attention_flash(p["attn"], spec, h, positions)
        else:
            out = attention_dense(p["attn"], spec, h, positions,
                                  causal_mask(positions, positions))
        if return_cache:
            # recompute K/V once for the cache, as the reference does
            _, k, v = _project_qkv(p["attn"], spec, h, positions)
            W, B = x.shape[:2]
            cache = init_kv_cache(W * B, cache_len or seq, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, device=x.device)
            cache = {n: c.reshape((W, B) + c.shape[1:])
                     for n, c in cache.items()}
            cache["k"][:, :, :seq] = k.to(torch.bfloat16)
            cache["v"][:, :, :seq] = v.to(torch.bfloat16)
    else:
        out, h_fin = apply_ssd(p["ssm"], h, chunk=cfg.ssm_chunk,
                               **_ssm_dims(cfg))
        if return_cache:
            K, C = p["ssm"]["conv_w"].shape[1:]
            cache = {"conv": torch.zeros(x.shape[:2] + (K - 1, C),
                                         device=x.device),
                     "ssm": h_fin}
    x = x + out
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x, cache


def apply_layer_decode(cfg: ModelConfig, ltype: str, p, x, pos: int, cache):
    """One token on W replicas against this layer's cache, which it updates
    IN PLACE (the reference returns a new cache).  x: (W, B, 1, D); pos:
    host int.  Returns x."""
    _layer_type(ltype)
    _, norm = make_norm(cfg.norm_type)
    h = norm(p["ln1"], x)
    if ltype == "G":
        x = x + attention_decode(p["attn"], attn_spec(cfg), h, pos, cache)
    else:
        out, new = apply_ssd_decode(p["ssm"], h, cache, **_ssm_dims(cfg))
        cache["conv"].copy_(new["conv"])
        cache["ssm"].copy_(new["ssm"])
        x = x + out
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x
