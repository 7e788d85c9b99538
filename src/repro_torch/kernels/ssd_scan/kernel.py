"""ctypes binding of the Mamba-2 chunked SSD scan kernel (csrc/ssd_scan.cu).

Ports ``ssd_scan_pallas`` (src/repro/kernels/ssd_scan/kernel.py:85) ->
:func:`ssd_scan_chunked` (B5).  The source holds its bound and design
notes.

The wrapper checks shapes, dtype, device and layout: x, B and C may be
views at a row stride (:func:`row_strides`), dt and A are contiguous.  For
CPU tensors it returns the plain-torch version (ref.py); for CUDA tensors
it allocates the workspace, launches the kernel's three stages on the
current stream (``lib.ssd_launches()`` device launches), raises if a launch
failed, and counts one launch per call (kernels.count_launch); any other device raises.  The reference has no
gradient of this kernel, so on CUDA an input that requires grad (with grad
enabled) raises NotImplementedError: the plain version is never
differentiated in the kernel's place.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import count_launch, load_library
from .ref import ssd_scan_plain

SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd_scan.cu"
SCAN = "ssd_scan"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.ssd_scan.argtypes = [_P] * 8 + [_I] * 6 + [_L, _L, _P]
        lib.ssd_scan.restype = _I
        lib.ssd_workspace_floats.argtypes = [_I] * 6
        lib.ssd_workspace_floats.restype = ctypes.c_size_t
        for fn in (lib.ssd_max_chunk, lib.ssd_max_state, lib.ssd_launches):
            fn.argtypes, fn.restype = [], _I
        lib.ssd_error_string.argtypes = [_I]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check_operands(x, dt, A, B, C, chunk):
    """Validate the kernel layout; returns (Bb, S, H, P, N)."""
    if x.ndim != 4:
        raise ValueError(f"x must be (Bb, S, H, P), got {tuple(x.shape)}")
    Bb, S, H, P = x.shape
    N = B.shape[-1] if B.ndim == 3 else -1
    want = {"dt": (dt, (Bb, S, H)), "A": (A, (Bb, H)), "B": (B, (Bb, S, N)),
            "C": (C, (Bb, S, N))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(t.shape)}")
    if min(Bb, S, H, P, N) < 1:
        raise ValueError(f"empty operand: Bb={Bb} S={S} H={H} P={P} N={N}")
    for t in (x, dt, A, B, C):
        if t.dtype != torch.float32:
            raise ValueError(f"operands must be float32, got {t.dtype}")
    if chunk < 1 or S % chunk:
        raise ValueError(f"S={S} is not a multiple of chunk={chunk} "
                         "(ops.ssd_scan pads)")
    return Bb, S, H, P, N


def _row_stride(t):
    """Element stride between the steps (dim 1) of t (Bb, S, *inner) when
    its inner dims are contiguous and its batch stride is S steps; else
    None.  Size-1 dims may have any stride."""
    sizes, strides = t.shape, t.stride()
    inner = 1
    for d in range(t.ndim - 1, 1, -1):
        if sizes[d] > 1 and strides[d] != inner:
            return None
        inner *= sizes[d]
    row = strides[1] if sizes[1] > 1 else (
        strides[0] if sizes[0] > 1 else inner)
    if row < inner or (sizes[0] > 1 and strides[0] != sizes[1] * row):
        return None
    return row


def row_strides(x, B, C):
    """(x_row, bc_row): the strides at which the kernel reads x (Bb, S, H,
    P) and B, C (Bb, S, N) — rows of contiguous elements, one stride for B
    and C — or None when they are not laid out so."""
    x_row, b_row, c_row = _row_stride(x), _row_stride(B), _row_stride(C)
    if x_row is None or b_row is None or b_row != c_row:
        return None
    return x_row, b_row


def ssd_scan_chunked(x, dt, A, B, C, chunk: int):
    """B5.  x (Bb, S, H, P), dt (Bb, S, H), A (Bb, H), B/C (Bb, S, N) — the
    heads of a row share B and C — all f32; S % chunk == 0.  On CUDA, x, B
    and C may be views at a row stride (:func:`row_strides`).

    Returns (y (Bb, S, H, P), h_final (Bb, H, N, P)) f32, reproducible run
    to run (one writer per output, no atomics)."""
    Bb, S, H, P, N = _check_operands(x, dt, A, B, C, chunk)
    devices = {t.device for t in (x, dt, A, B, C)}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    dev = x.device
    if dev.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk)
    if dev.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda (or its plain version on "
                         f"cpu), got device {dev}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, dt, A, B, C)):
        raise NotImplementedError(
            "ssd_scan has no backward (the reference has none either: it "
            "trains by autodiff of the jnp chunked form) — SSM training is "
            "ROADMAP.md queue A, item 9")
    strides = row_strides(x, B, C)
    if strides is None or not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("kernel operands must be contiguous (x, B and C: "
                         "contiguous rows at one stride for B and C)")
    lib = _library()
    if chunk > lib.ssd_max_chunk() or N > lib.ssd_max_state():
        raise ValueError(f"chunk={chunk} / N={N} exceed the kernel's "
                         f"{lib.ssd_max_chunk()} / {lib.ssd_max_state()}")
    with torch.cuda.device(dev):
        y = torch.empty((Bb, S, H, P), dtype=torch.float32, device=dev)
        h = torch.empty((Bb, H, N, P), dtype=torch.float32, device=dev)
        work = torch.empty(lib.ssd_workspace_floats(Bb, S, H, P, N, chunk),
                           dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan(x.data_ptr(), dt.data_ptr(), A.data_ptr(),
                          B.data_ptr(), C.data_ptr(), y.data_ptr(),
                          h.data_ptr(), work.data_ptr(), Bb, S, H, P, N,
                          chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(
            f"{SCAN} launch failed: {lib.ssd_error_string(rc).decode()}")
    count_launch(SCAN)
    return y, h
