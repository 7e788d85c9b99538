"""Gossip blend: CUDA kernels, plain versions, wrappers."""
from .ops import (choose_block_rows, gossip_blend,  # noqa: F401
                  gossip_blend_packed, gossip_blend_w,
                  gossip_blend_w_resident, gossip_blend_worker_batched,
                  gossip_gates)
