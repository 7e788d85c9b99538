"""gemma3-1b — dense with 5:1 local:global attention, 128k-class context
[hf:google/gemma-3-1b-pt].

26 layers, d_model 1152, 4 heads GQA kv=1, d_ff 6912, vocab 262144.
Cycle (L,L,L,L,L,G): sliding-window 512 locals + periodic globals.
Decode cost is O(window) for 25/26 of layers -> runs long_500k (global
layers read the full cache — linear per step, fine for decode; prefill-32k
globals use chunked flash attention).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-1b",
    arch_type="dense",
    source="hf:google/gemma-3-1b-pt",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262_144,
    head_dim=256,
    pattern_cycle=("L", "L", "L", "L", "L", "G"),
    sliding_window=512,
    scale_embeddings=True,
    act="gelu",
    rope_theta=1_000_000.0,
    qk_norm=True,
    supports_long_context=True,
    # rollout of the qwen2.5 §Perf wins (4 heads % 16 != 0 -> batch-shard)
    seq_parallel=True,
    attn_batch_shard=True,
)
