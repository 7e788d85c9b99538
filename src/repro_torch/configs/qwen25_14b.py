"""qwen2.5-14b — dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family].

48 layers, d_model 5120, 40 heads GQA kv=8, d_ff 13824, vocab 152064.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen2.5-0.5B (family card)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152_064,
    pattern_cycle=("G",),
    qkv_bias=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    # §Perf (EXPERIMENTS.md qwen2.5 iterations 2-3): sequence-parallel
    # residual stream (-61% memory term) + dots remat (-23% compute term,
    # useful-flops ratio 1.02)
    seq_parallel=True,
    remat_policy="dots",
    attn_batch_shard=True,   # 40 heads % 16 != 0 -> batch-sharded attention
)
