"""phi3.5-moe-42b-a6.6b — 16-expert top-2 MoE
[hf:microsoft/Phi-3.5-MoE-instruct].

32 layers, d_model 4096, 32 heads GQA kv=8, per-expert d_ff 6400.
Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b",
    arch_type="moe",
    source="hf:microsoft/Phi-3.5-MoE-instruct",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6400,
    vocab=32_064,
    pattern_cycle=("G",),
    n_experts=16,
    experts_per_token=2,
    moe_dispatch_groups=16,   # shard-local dispatch (models/moe.py)
    tie_embeddings=False,
    rope_theta=10000.0,
)
