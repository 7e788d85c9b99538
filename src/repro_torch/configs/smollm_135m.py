"""smollm-135m — llama-architecture small dense model
[hf:HuggingFaceTB/SmolLM-135M].

30 layers, d_model 576, 9 heads GQA kv=3, d_ff 1536, vocab 49152. The
~100M-class end-to-end training driver (examples/train_lm.py) uses this
config. Full attention -> long_500k skipped.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    arch_type="dense",
    source="hf:HuggingFaceTB/SmolLM-135M",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    d_ff=1536,
    vocab=49_152,
    pattern_cycle=("G",),
    rope_theta=10000.0,
    tie_embeddings=True,
    # rollout of the qwen2.5 §Perf wins (9 heads % 16 != 0 -> batch-shard)
    seq_parallel=True,
    attn_batch_shard=True,
)
