"""Fused P=1 Parzen gate + blend: CUDA kernels B6r/B6a, plain versions,
wrapper."""
from .ops import parzen_blend  # noqa: F401
