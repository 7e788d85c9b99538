"""The paper's K-Means examples on the port: ``python -m
repro_torch.examples.quickstart`` and ``python -m
repro_torch.examples.kmeans_scaling`` (CUDA by default, ``--device cpu``
on the CPU)."""
