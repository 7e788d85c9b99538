"""K-Means fused E/M step: CUDA kernel B4, plain version, wrappers."""
from .kernel import kmeans_assign_w  # noqa: F401
from .ops import kmeans_assign  # noqa: F401
