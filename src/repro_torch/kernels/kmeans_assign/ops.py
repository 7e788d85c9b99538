"""Public wrapper of the fused K-Means E/M step (B4)."""
from __future__ import annotations

from .kernel import kmeans_assign_w


def kmeans_assign(x, w):
    """Fused E/M step.  x: (M, D), w: (K, D), any float dtype (cast to f32,
    as the reference does).  Returns (idx (M,) int32, sums (K, D) f32,
    counts (K,) f32).  Nothing is padded: the kernel takes any M, K and D
    (D up to its limit on CUDA).

    A leading worker axis goes through :func:`kmeans_assign_w` directly:
    x (M, D) or (W, M, D) with w (W, K, D)."""
    idx, sums, counts = kmeans_assign_w(x.float().contiguous(),
                                        w.float().contiguous()[None])
    return idx[0], sums[0], counts[0]
