"""granite-moe-1b-a400m — 32-expert top-8 fine-grained MoE
[hf:ibm-granite/granite-3.0-1b-a400m-base].

24 layers, d_model 1024, 16 heads GQA kv=8, per-expert d_ff 512 (fine-
grained experts). Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-1b-a400m",
    arch_type="moe",
    source="hf:ibm-granite/granite-3.0-1b-a400m-base",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    d_ff=512,
    vocab=49_155,
    pattern_cycle=("G",),
    n_experts=32,
    experts_per_token=8,
    moe_dispatch_groups=16,   # shard-local dispatch (models/moe.py)
    tie_embeddings=True,
    rope_theta=10000.0,
)
