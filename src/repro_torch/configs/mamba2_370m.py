"""mamba2-370m — SSD state-space duality, attention-free [arXiv:2405.21060].

48 layers, d_model 1024, ssm_state 128, head_dim 64 (d_inner 2048 -> 32 SSD
heads), no FFN (d_ff=0: the mamba block IS the mixer+channel mix). O(1)
decode state -> runs long_500k.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-370m",
    arch_type="ssm",
    source="arXiv:2405.21060",
    n_layers=48,
    d_model=1024,
    n_heads=1,            # unused by SSD layers (attn-free)
    n_kv_heads=1,
    d_ff=0,
    vocab=50_280,
    pattern_cycle=("S",),
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_chunk=128,
    use_rope=False,
    tie_embeddings=True,
    norm_type="rmsnorm",
    supports_long_context=True,
)
