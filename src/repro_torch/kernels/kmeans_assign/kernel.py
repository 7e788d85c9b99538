"""ctypes binding of the K-Means E/M kernel (csrc/kmeans_assign.cu).

Ports ``kmeans_assign_pallas`` (src/repro/kernels/kmeans_assign/kernel.py:57)
-> :func:`kmeans_assign_w` (B4).  The source holds its bound and design
notes.

The wrapper checks device, dtype, shape and contiguity.  For CPU tensors it
returns the plain-torch version (ref.py); for CUDA tensors it launches the
kernel on the current stream, raises if the launch failed, and counts the
launch (kernels.count_launch); any other device raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import count_launch, load_library
from .ref import kmeans_assign_plain

SOURCE = pathlib.Path(__file__).parent / "csrc" / "kmeans_assign.cu"
ASSIGN = "kmeans_assign"

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_plans: dict = {}


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.kmeans_assign.argtypes = [_P, _LL, _P, _P, _P, _P, _P, _P, _P,
                                      _I, _LL, _I, _I, _I, _P]
        lib.kmeans_assign_plan.argtypes = [_I, _LL, _I, _I, _P]
        lib.kmeans_assign.restype = lib.kmeans_assign_plan.restype = _I
        lib.kmeans_max_d.argtypes, lib.kmeans_max_d.restype = [], _I
        lib.kmeans_error_string.argtypes = [_I]
        lib.kmeans_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(rc: int, lib, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: {lib.kmeans_error_string(rc).decode()}")


def _plan(lib, device, wn, m, k, d):
    """(blocks per worker, floats of global scratch) for this device and
    shape, from the kernel's own planner (occupancy-sized grid)."""
    if d > lib.kmeans_max_d():
        raise ValueError(f"D={d} exceeds the kernel's {lib.kmeans_max_d()}")
    key = (device.index, wn, m, k, d)
    plan = _plans.get(key)
    if plan is None:
        out = (ctypes.c_longlong * 2)()
        _check(lib.kmeans_assign_plan(wn, m, k, d, out), lib,
               "kmeans_assign_plan")
        plan = _plans[key] = (int(out[0]), int(out[1]))
    return plan


def _check_operands(x, w):
    """Validate x (M, D) or (W, M, D) and w (W, K, D), both float32;
    returns (W, M, K, D)."""
    if w.ndim != 3:
        raise ValueError(f"w must be (W, K, D), got {tuple(w.shape)}")
    wn, k, d = w.shape
    if x.ndim not in (2, 3) or x.shape[-1] != d or \
            (x.ndim == 3 and x.shape[0] != wn):
        raise ValueError(f"x must be (M, {d}) or ({wn}, M, {d}), got "
                         f"{tuple(x.shape)}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"x and w must be float32, got {x.dtype}, "
                         f"{w.dtype}")
    m = x.shape[-2]
    if min(wn, m, k, d) < 1:
        raise ValueError(f"empty operand: W={wn} M={m} K={k} D={d}")
    return wn, m, k, d


def kmeans_assign_w(x, w):
    """B4.  x: (M, D) f32 shared by every worker (read with worker stride
    0, not copied) or (W, M, D) f32; w: (W, K, D) f32.

    Returns idx (W, M) int32 (argmin of ``-2 x.w_k + ||w_k||^2``, the first
    k on a tie), sums (W, K, D) f32 and counts (W, K) f32 (integer counts,
    converted once) — reproducible run to run (fixed-order sums, no
    atomics)."""
    wn, m, k, d = _check_operands(x, w)
    if x.device != w.device:
        raise ValueError(f"operands on several devices: {x.device}, "
                         f"{w.device}")
    if x.device.type == "cpu":
        return kmeans_assign_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"kmeans_assign runs on cuda (or its plain version "
                         f"on cpu), got device {x.device}")
    for t in (x, w):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
    lib = _library()
    dev = x.device
    with torch.cuda.device(dev):
        nb, n_scratch = _plan(lib, dev, wn, m, k, d)
        idx = torch.empty((wn, m), dtype=torch.int32, device=dev)
        sums = torch.empty((wn, k, d), dtype=torch.float32, device=dev)
        counts = torch.empty((wn, k), dtype=torch.float32, device=dev)
        partials = torch.empty((wn, nb, k, d), dtype=torch.float32,
                               device=dev)
        pcounts = torch.empty((wn, nb, k), dtype=torch.int32, device=dev)
        scratch = (torch.empty(n_scratch, dtype=torch.float32, device=dev)
                   if n_scratch else None)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.kmeans_assign(
            x.data_ptr(), 0 if x.ndim == 2 else m * d, w.data_ptr(),
            idx.data_ptr(), sums.data_ptr(), counts.data_ptr(),
            partials.data_ptr(), pcounts.data_ptr(),
            None if scratch is None else scratch.data_ptr(), wn, m, k, d, nb,
            stream)
    _check(rc, lib, f"{ASSIGN} launch")
    count_launch(ASSIGN)
    return idx, sums, counts
