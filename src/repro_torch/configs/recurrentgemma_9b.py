"""recurrentgemma-9b — hybrid RG-LRU + local attention, 1:2 [arXiv:2402.19427].

38 blocks, cycle (R, R, L): two RG-LRU recurrent blocks per local-attention
block (window 2048 as in the Griffin paper). GQA with a single KV head.
Sub-quadratic everywhere -> runs the long_500k shape.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    source="arXiv:2402.19427",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256_000,
    head_dim=256,
    pattern_cycle=("R", "R", "L"),
    sliding_window=2048,
    lru_width=4096,
    scale_embeddings=True,
    act="gelu",
    rope_theta=10000.0,
    supports_long_context=True,
    # §Perf (EXPERIMENTS.md recurrentgemma iterations 1-3): collective
    # 14.88s -> 1.39s (-91%), memory -20%, compute -21%
    seq_parallel=True,
    attn_batch_shard=True,
    remat_policy="dots",
)
