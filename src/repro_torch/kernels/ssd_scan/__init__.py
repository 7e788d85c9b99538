"""Mamba-2 chunked SSD scan: CUDA kernel B5, plain versions, wrapper."""
from .kernel import ssd_scan_chunked  # noqa: F401
from .ops import ssd_scan  # noqa: F401
