"""ctypes bindings of the P=1 Parzen gate + blend kernels.

Ports, from src/repro/kernels/parzen_blend/kernel.py:
  parzen_reduce_pallas (:65) -> :func:`parzen_reduce`   (B6r)
  parzen_apply_pallas  (:85) -> :func:`parzen_apply`    (B6a)
Both are entry points of kernels/gossip_blend/csrc/gossip_blend.cu, over
the templated reduce and apply bodies of B1-B3 (one library, one reduction
scheme): B6r is B3r at P = 1 with the accumulator in the TPU kernel's
order, B6a the apply with the reference's blend formula.  Bound: both
stream whole states (B6r reads w, ext, dw; B6a reads them and writes out),
a few flops per byte — bytes bound them.

For CPU tensors each wrapper returns its plain-torch version (ref.py); for
CUDA tensors it launches its kernel or raises, and counts the launch.
"""
from __future__ import annotations

import torch

from .. import LANE, count_launch
from ..gossip_blend.kernel import _check, _cuda_ready, _library
from .ref import parzen_apply_plain, parzen_reduce_plain

REDUCE = "parzen_reduce"
APPLY = "parzen_apply"


def _check_operands(w2d, ext2d, dw2d):
    if w2d.ndim != 2 or w2d.shape[1] != LANE or w2d.shape[0] < 1:
        raise ValueError(f"w must be (R, {LANE}), got {tuple(w2d.shape)}")
    for name, t in (("ext", ext2d), ("dw", dw2d)):
        if t.shape != w2d.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != w "
                             f"{tuple(w2d.shape)}")
    for t in (w2d, ext2d, dw2d):
        if t.dtype != torch.float32:
            raise ValueError(f"operands must be float32, got {t.dtype}")
    return w2d.shape[0]


def parzen_reduce(w2d, ext2d, dw2d):
    """B6r.  w2d, ext2d, dw2d: (R, LANE) f32.  Returns (3,) f32 =
    [<dw, w - ext>, ||dw||^2, ||ext||^2] — reproducible run to run (a
    fixed-order two-launch reduction, no atomics)."""
    rows = _check_operands(w2d, ext2d, dw2d)
    if not _cuda_ready(w2d, ext2d, dw2d):
        return parzen_reduce_plain(w2d, ext2d, dw2d)
    lib = _library(1)
    nblk = -(-rows // lib.gossip_reduce_rows_per_block())
    partials = torch.empty((1, nblk, 1, 3), dtype=torch.float32,
                           device=w2d.device)
    acc = torch.empty(3, dtype=torch.float32, device=w2d.device)
    with torch.cuda.device(w2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.parzen_reduce(w2d.data_ptr(), ext2d.data_ptr(),
                               dw2d.data_ptr(), partials.data_ptr(),
                               acc.data_ptr(), rows, stream)
    _check(rc, lib, REDUCE)
    count_launch(REDUCE)
    return acc


def parzen_apply(w2d, ext2d, dw2d, gate, *, eps: float):
    """B6a: ``w - eps * (gate * 0.5 * (w - ext) + dw)`` with gate a
    one-element f32 tensor (read by the kernel on the device, no host
    sync) and eps a static float.  Returns the (R, LANE) f32 state (a new
    tensor)."""
    _check_operands(w2d, ext2d, dw2d)
    if not torch.is_tensor(gate) or gate.numel() != 1:
        raise ValueError("gate must be a one-element tensor")
    gate = gate.float().reshape(1).contiguous()
    if not _cuda_ready(w2d, ext2d, dw2d, gate):
        return parzen_apply_plain(w2d, ext2d, dw2d, gate, eps=eps)
    lib = _library(1)
    out = torch.empty_like(w2d)
    with torch.cuda.device(w2d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.parzen_apply(w2d.data_ptr(), ext2d.data_ptr(),
                              dw2d.data_ptr(), gate.data_ptr(),
                              out.data_ptr(), w2d.shape[0], float(eps),
                              stream)
    _check(rc, lib, APPLY)
    count_launch(APPLY)
    return out
