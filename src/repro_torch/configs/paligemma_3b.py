"""paligemma-3b — SigLIP vision encoder + gemma decoder [arXiv:2407.07726].

The gemma-2b language backbone: 18 layers, d_model 2048, 8 heads GQA kv=1,
d_ff 16384 (GeGLU). The SigLIP ViT + projector is a STUB per the brief:
input_specs() supplies 256 precomputed patch embeddings (B, 256, 2048)
prepended to the token stream; masking is prefix-LM (bidirectional over the
image prefix, causal after). Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    arch_type="vlm",
    source="arXiv:2407.07726",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257_216,
    head_dim=256,
    pattern_cycle=("G",),
    scale_embeddings=True,
    act="gelu",
    frontend="vision",
    prefix_len=256,
    # rollout of the qwen2.5 §Perf wins (8 heads % 16 != 0 -> batch-shard)
    seq_parallel=True,
    attn_batch_shard=True,
)
