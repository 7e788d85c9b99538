"""qwen3-14b — dense GQA with per-head QK RMS-norm [hf:Qwen/Qwen3-8B family].

40 layers, d_model 5120, 40 heads GQA kv=8, d_ff 17408, vocab 151936,
qk_norm (no QKV bias — qwen3 dropped it). Full attention -> long_500k
skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-14b",
    arch_type="dense",
    source="hf:Qwen/Qwen3-8B (family card)",
    n_layers=40,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=17408,
    vocab=151_936,
    head_dim=128,
    pattern_cycle=("G",),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=False,
    # rollout of the qwen2.5 §Perf wins (same family/shape)
    seq_parallel=True,
    remat_policy="dots",
    attn_batch_shard=True,
)
