"""Examples on the port: the paper's K-Means (``python -m
repro_torch.examples.quickstart``, ``python -m
repro_torch.examples.kmeans_scaling``) and serving (``python -m
repro_torch.examples.serve_decode``); CUDA by default, ``--device cpu``
on the CPU."""
