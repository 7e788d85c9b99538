"""Mamba-2 chunked SSD scan: CUDA kernels B5 (forward) and B5b (its
backward), plain versions, wrapper."""
from .kernel import ssd_scan_chunked  # noqa: F401
from .ops import ssd_scan  # noqa: F401
