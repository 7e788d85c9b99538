"""Per-layer blocks: init, full-sequence apply (train / prefill, optionally
returning the decode cache) and single-token decode against a cache.

This port carries the 'G' (global attention) and 'L' (sliding-window
attention) layers with the GLU MLP or, when the config has experts, the
MoE FFN (models/moe.py); the 'R' (RG-LRU, models/rglru.py) layer; and the
'S' (mamba-2 SSD) layer, for serving and for training (the SSD scan
differentiates through kernel B5b on the card).  An attention layer at
seq >= FLASH_MIN_SEQ with seq % 512 == 0 takes the chunked
``attention_flash`` ('L' with its window), as the reference's
``_attend_full`` does; shorter ones the dense form under the causal or
sliding mask.  The reference's encoder layer ('E'), cross-attention, the
prefix mask and the other missing features raise NotImplementedError
naming the arch family's ROADMAP.md queue A item (``FAMILY_ITEMS``).
Sharding hints, sequence parallelism and remat change no values on one
device and are left out.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from .common import (AttnSpec, _project_qkv, attention_decode,
                     attention_dense, attention_flash, causal_mask,
                     init_attention, init_kv_cache, make_norm, sliding_mask)
from .mlp import apply_mlp, init_mlp
from .moe import apply_moe, apply_moe_decode, init_moe
from .rglru import (apply_rglru, apply_rglru_decode, init_rglru,
                    init_rglru_cache)
from .ssm import apply_ssd, apply_ssd_decode, init_ssd, init_ssd_cache

# the reference switches to its chunked attention_flash at this length
FLASH_MIN_SEQ = 2048

# the layer types the port carries; attention ones are 'G' and 'L'
LAYER_TYPES = ("G", "L", "R", "S")

# the ROADMAP.md queue A item that ports each arch family's missing
# features: paligemma-3b 9e, whisper-tiny 9f (the dense, MoE, SSM and
# hybrid families lack none)
FAMILY_ITEMS = {"vlm": "9e", "audio": "9f"}


def not_ported(cfg: ModelConfig, what: str) -> NotImplementedError:
    """The error for a feature of ``cfg`` the port does not carry, naming
    the family's ROADMAP.md queue A item where it has one."""
    item = FAMILY_ITEMS.get(cfg.arch_type)
    return NotImplementedError(
        f"{cfg.name}: {what} not ported yet — ROADMAP.md queue A"
        + (f", item {item}" if item else ""))


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


def check_supported(cfg: ModelConfig) -> None:
    """Raise for any model feature the port does not carry, for serving
    and training alike: 'G' and 'L' (with the GLU MLP or MoE), 'R' and
    'S' layers, scaled embeddings and both softcaps are ported.  The
    message names the arch family's ROADMAP.md item."""
    missing = []
    layer_types = set(cfg.pattern_cycle)
    if not layer_types <= set(LAYER_TYPES):
        missing.append(f"layer types {sorted(layer_types)} (only "
                       f"{', '.join(map(repr, LAYER_TYPES))})")
    if cfg.d_ff and not cfg.glu_mlp:
        missing.append("non-GLU MLP")
    if cfg.cross_attention or cfg.encoder_layers or cfg.frontend:
        missing.append("encoder / cross-attention / modality frontends")
    if not cfg.use_rope and layer_types & {"G", "L", "E"}:
        missing.append("absolute (sinusoidal) positions")
    if cfg.norm_type != "rmsnorm":
        missing.append(f"{cfg.norm_type}")
    if missing:
        raise not_ported(cfg, ", ".join(missing))


def _layer_type(cfg: ModelConfig, ltype: str) -> None:
    if ltype not in LAYER_TYPES:
        raise not_ported(cfg, f"layer type {ltype!r}")


def _ssm_dims(cfg: ModelConfig) -> dict:
    return {"head_dim": cfg.ssm_head_dim, "state": cfg.ssm_state,
            "n_groups": cfg.ssm_groups}


def init_layer(generator, cfg: ModelConfig, ltype: str, *,
               dtype=torch.float32, device=None):
    _layer_type(cfg, ltype)
    norm_init, _ = make_norm(cfg.norm_type)
    p = {"ln1": norm_init(cfg.d_model, dtype, device)}
    if ltype in ("G", "L"):
        p["attn"] = init_attention(generator, attn_spec(cfg), dtype, device)
    elif ltype == "R":
        p["rglru"] = init_rglru(generator, cfg.d_model,
                                cfg.lru_width or cfg.d_model, dtype=dtype,
                                device=device)
    else:
        p["ssm"] = init_ssd(generator, cfg.d_model, expand=cfg.ssm_expand,
                            dtype=dtype, device=device, **_ssm_dims(cfg))
    if cfg.d_ff > 0 and ltype != "S":
        p["ln2"] = norm_init(cfg.d_model, dtype, device)
        if cfg.n_experts > 0:
            p["moe"] = init_moe(generator, cfg.d_model, cfg.d_ff,
                                cfg.n_experts, dtype, device)
        else:
            p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, dtype,
                                device)
    return p


def init_layer_cache(cfg: ModelConfig, ltype: str, batch, max_seq,
                     dtype=torch.bfloat16, device=None):
    """One model's zero decode cache of one layer (the reference's: a
    full-length KV cache for 'L' too, not a ring of its window)."""
    _layer_type(cfg, ltype)
    if ltype in ("G", "L"):
        return init_kv_cache(batch, max_seq, cfg.n_kv_heads,
                             cfg.resolved_head_dim, dtype, device)
    if ltype == "R":
        return init_rglru_cache(batch, cfg.lru_width or cfg.d_model,
                                device=device)
    return init_ssd_cache(batch, cfg.d_model, expand=cfg.ssm_expand,
                          device=device, **_ssm_dims(cfg))


def apply_layer(cfg: ModelConfig, ltype: str, p, x, positions, *,
                return_cache=False, cache_len=None):
    """Full-sequence layer (pre-norm residual) on W worker replicas:
    x + mixer(norm1(x)), then + ffn(norm2(x)) where the layer has one (the
    GLU MLP, or the MoE FFN).  x: (W, B, S, D); p: leaves with a leading
    worker axis; positions: (S,).  Returns (x, aux, cache), as the
    reference does: aux (W,) the MoE router's load-balance loss (None
    without MoE, where the reference's is 0); cache None unless
    ``return_cache``: for 'G' and 'L' the bf16 KV cache of ``cache_len``
    positions (W, B, L, KV, Dh) holding this prompt's k/v; for 'R' and
    'S' a ZERO conv cache and the final state, as the reference returns
    them (its post-conv tail is computed and dropped)."""
    _layer_type(cfg, ltype)
    _, norm = make_norm(cfg.norm_type)
    h = norm(p["ln1"], x)
    cache = None
    if ltype in ("G", "L"):
        seq = x.shape[2]
        spec = attn_spec(cfg)
        window = cfg.sliding_window if ltype == "L" else None
        if seq >= FLASH_MIN_SEQ and seq % 512 == 0:
            out = attention_flash(p["attn"], spec, h, positions,
                                  window=window)
        else:
            mask = (causal_mask(positions, positions) if window is None
                    else sliding_mask(positions, positions, window))
            out = attention_dense(p["attn"], spec, h, positions, mask)
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
    elif ltype == "R":
        out, h_fin = apply_rglru(p["rglru"], h)
        if return_cache:
            K = p["rglru"]["conv_w"].shape[1]
            cache = {"conv": torch.zeros(
                x.shape[:2] + (K - 1, h_fin.shape[-1]), dtype=x.dtype,
                device=x.device), "h": h_fin}
    else:
        out, h_fin = apply_ssd(p["ssm"], h, chunk=cfg.ssm_chunk,
                               **_ssm_dims(cfg))
        if return_cache:
            K, C = p["ssm"]["conv_w"].shape[1:]
            cache = {"conv": torch.zeros(x.shape[:2] + (K - 1, C),
                                         device=x.device),
                     "ssm": h_fin}
    x = x + out
    x, aux = _ffn(cfg, p, x, norm)
    return x, aux, cache


def _ffn(cfg: ModelConfig, p, x, norm):
    """The layer's FFN residual and its aux loss (W,), None without MoE."""
    if "moe" in p:
        h, aux = apply_moe(p["moe"], norm(p["ln2"], x),
                           cfg.experts_per_token, act=cfg.act,
                           capacity_factor=cfg.capacity_factor,
                           dispatch_groups=cfg.moe_dispatch_groups)
        return x + h, aux
    if "mlp" in p:
        x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x, None


def apply_layer_decode(cfg: ModelConfig, ltype: str, p, x, pos: int, cache):
    """One token on W replicas against this layer's cache, which it updates
    IN PLACE (the reference returns a new cache).  x: (W, B, 1, D); pos:
    host int.  Returns x."""
    _layer_type(cfg, ltype)
    _, norm = make_norm(cfg.norm_type)
    h = norm(p["ln1"], x)
    if ltype in ("G", "L"):
        window = cfg.sliding_window if ltype == "L" else None
        x = x + attention_decode(p["attn"], attn_spec(cfg), h, pos, cache,
                                 window=window)
    else:
        if ltype == "R":
            out, new = apply_rglru_decode(p["rglru"], h, cache)
        else:
            out, new = apply_ssd_decode(p["ssm"], h, cache, **_ssm_dims(cfg))
        for name, t in new.items():
            cache[name].copy_(t)
        x = x + out
    if "moe" in p:
        out, _ = apply_moe_decode(p["moe"], norm(p["ln2"], x),
                                  cfg.experts_per_token, act=cfg.act)
        x = x + out
    elif "mlp" in p:
        x = x + apply_mlp(p["mlp"], norm(p["ln2"], x), cfg.act)
    return x
