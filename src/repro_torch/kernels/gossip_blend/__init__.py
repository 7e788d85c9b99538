"""Packed-resident gossip blend: CUDA kernels, plain versions, wrappers."""
from .ops import (choose_block_rows, gossip_blend_w_resident,  # noqa: F401
                  gossip_gates)
