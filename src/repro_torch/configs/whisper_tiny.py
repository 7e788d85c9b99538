"""whisper-tiny — encoder-decoder audio transformer [arXiv:2212.04356].

4+4 layers, d_model 384, 6 heads (MHA), learned-absolute positions (we use
sinusoidal, no RoPE), LayerNorm + non-GLU GELU MLPs. The mel-spectrogram +
conv frontend is a STUB per the brief: input_specs() supplies precomputed
frame embeddings (B, 1500, 384); this config is the transformer backbone.
long_500k skipped: full self/cross attention decoder.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    arch_type="audio",
    source="arXiv:2212.04356",
    n_layers=4,                  # decoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51_865,
    pattern_cycle=("G",),
    use_rope=False,              # whisper: absolute positions
    norm_type="layernorm",
    act="gelu",
    glu_mlp=False,
    tie_embeddings=True,
    encoder_layers=4,
    encoder_seq=1500,            # 30s audio -> 1500 frames
    cross_attention=True,
    frontend="audio",
)
