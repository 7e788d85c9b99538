"""PyTorch / CUDA port of the ASGD numeric core (paper eqs. 1-7).

The JAX package ``repro`` is the reference; every module here mirrors the
reference module at the same relative path and is held against it by the
``tests/test_torch_*.py`` parity tests.  The port imports ``torch`` and
numpy only — never ``jax`` and nothing of ``repro``.

Entry points run on CUDA.  They run on the CPU only when the caller asks
(``device="cpu"``, ``--device cpu``), as the tests do; with no GPU and no
such request they raise (:func:`resolve_device`).  On the CPU every kernel
wrapper runs its plain-torch version; on a CUDA tensor it launches its
hand-written kernel or raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for and absent — there is no silent
    CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' (--device cpu) to run on the CPU")
    return dev


def set_full_fp32_precision() -> None:
    """Full-f32 matmuls and convolutions, as the reference computes: TF32
    keeps ~3 decimal digits and would break parity with the JAX package."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
