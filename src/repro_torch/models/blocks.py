"""Per-layer blocks: init + full-sequence apply.

This slice carries the 'G' (global attention) layer with the GLU MLP —
every layer of the dense archs.  The reference's other layer types ('L',
'R', 'S', 'E'), MoE, cross-attention and the decode path raise
NotImplementedError (ROADMAP.md queue A).  Sharding hints, sequence
parallelism and remat change no values on one device and are left out.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import (AttnSpec, attention_dense, causal_mask, init_attention,
                     make_norm)
from .mlp import apply_mlp, init_mlp

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
    """Raise for any model feature this slice does not carry."""
    missing = []
    if any(t != "G" for t in cfg.pattern_cycle):
        missing.append(f"layer types {sorted(set(cfg.pattern_cycle))} "
                       "(only 'G')")
    if cfg.n_experts:
        missing.append("MoE")
    if not cfg.glu_mlp:
        missing.append("non-GLU MLP")
    if cfg.cross_attention or cfg.encoder_layers or cfg.frontend:
        missing.append("encoder / cross-attention / modality frontends")
    if not cfg.use_rope:
        missing.append("absolute (sinusoidal) positions")
    if cfg.norm_type != "rmsnorm":
        missing.append(f"{cfg.norm_type}")
    if cfg.attn_softcap or cfg.logit_softcap or cfg.scale_embeddings:
        missing.append("softcaps / scaled embeddings (gemma family)")
    if missing:
        raise NotImplementedError(
            f"{cfg.name}: {', '.join(missing)} not ported yet — "
            "ROADMAP.md queue A, item 9 (remaining architectures)")


def init_layer(generator, cfg: ModelConfig, ltype: str, *,
               dtype=torch.float32, device=None):
    if ltype != "G":
        raise NotImplementedError(
            f"layer type {ltype!r} not ported yet — ROADMAP.md queue A, "
            "item 9")
    norm_init, _ = make_norm(cfg.norm_type)
    p = {"ln1": norm_init(cfg.d_model, dtype, device),
         "attn": init_attention(generator, attn_spec(cfg), dtype, device)}
    if cfg.d_ff > 0:
        p["ln2"] = norm_init(cfg.d_model, dtype, device)
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype, device)
    return p


def apply_layer(cfg: ModelConfig, ltype: str, p, x, positions):
    """Full-sequence 'G' layer (pre-norm residual) on W worker replicas:
    x + attn(norm1(x)), then + mlp(norm2(x)).  x: (W, B, S, D); p: leaves
    with a leading worker axis; positions: (S,)."""
    if ltype != "G":
        raise NotImplementedError(
            f"layer type {ltype!r} not ported yet — ROADMAP.md queue A, "
            "item 9")
    _, norm = make_norm(cfg.norm_type)
    seq = x.shape[2]
    if seq >= FLASH_MIN_SEQ and seq % 512 == 0:
        raise NotImplementedError(
            f"seq {seq} >= {FLASH_MIN_SEQ}: the reference runs its chunked "
            "attention_flash here, not ported yet — ROADMAP.md queue A, "
            "item 5")
    h = norm(p["ln1"], x)
    x = x + attention_dense(p["attn"], attn_spec(cfg), h, positions,
                            causal_mask(positions, positions))
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x
