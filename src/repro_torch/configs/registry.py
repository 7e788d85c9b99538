"""``--arch <id>`` registry for all assigned architectures + the paper's
own K-Means workload config."""
from __future__ import annotations

from .base import SHAPES, ModelConfig, ShapeConfig
from .gemma3_1b import CONFIG as GEMMA3_1B
from .granite_moe_1b import CONFIG as GRANITE_MOE_1B
from .mamba2_370m import CONFIG as MAMBA2_370M
from .paligemma_3b import CONFIG as PALIGEMMA_3B
from .phi35_moe import CONFIG as PHI35_MOE
from .qwen25_14b import CONFIG as QWEN25_14B
from .qwen3_14b import CONFIG as QWEN3_14B
from .recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from .smollm_135m import CONFIG as SMOLLM_135M
from .whisper_tiny import CONFIG as WHISPER_TINY

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in (
        RECURRENTGEMMA_9B,
        WHISPER_TINY,
        PHI35_MOE,
        PALIGEMMA_3B,
        MAMBA2_370M,
        QWEN25_14B,
        SMOLLM_135M,
        QWEN3_14B,
        GRANITE_MOE_1B,
        GEMMA3_1B,
    )
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(
            f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(
            f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


def assigned_pairs() -> list[tuple[ModelConfig, ShapeConfig]]:
    """The 10x4 grid minus the long_500k skips (DESIGN.md §4)."""
    pairs = []
    for cfg in ARCHS.values():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.supports_long_context:
                continue  # full-attention archs skip 500k (DESIGN.md §4)
            if shape.kind == "decode" and not cfg.decoder_only_decode:
                continue  # encoder-only archs (none assigned)
            pairs.append((cfg, shape))
    return pairs
