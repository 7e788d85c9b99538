"""ctypes binding of the packed-resident gossip-blend CUDA kernels.

Ports, from src/repro/kernels/gossip_blend/kernel.py:
  gossip_reduce_w_resident_pallas (:370) -> :func:`gossip_reduce_w_resident`
  gossip_apply_w_resident_pallas  (:412) -> :func:`gossip_apply_w_resident`
The source, its byte bound and its design notes are in
csrc/gossip_blend_resident.cu.

On the TPU the row range arrives by scalar prefetch; here the engines draw
the partition on the host, so ``row_range`` is two host ints passed to the
kernel by value — no device sync.  ``lr`` is a device scalar read by the
kernel at run time.

Each wrapper checks device, dtype, shape and contiguity.  For CPU tensors
it returns its plain-torch version (ref.py); for CUDA tensors it launches
the kernel on the current stream, raises if the launch failed, and counts
the launch (kernels.count_launch); any other device raises.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import LANE, count_launch, load_library
from .ref import (clamp_row_range, gossip_apply_w_resident_plain,
                  gossip_reduce_w_resident_plain)

SOURCE = pathlib.Path(__file__).parent / "csrc" / "gossip_blend_resident.cu"
REDUCE = "gossip_reduce_w_resident"
APPLY = "gossip_apply_w_resident"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.gossip_reduce_w_resident.argtypes = [
            _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P]
        lib.gossip_apply_w_resident.argtypes = [
            _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _I,
            _F, _P]
        for fn in (lib.gossip_reduce_w_resident, lib.gossip_apply_w_resident,
                   lib.gossip_reduce_rows_per_block,
                   lib.gossip_max_externals):
            fn.restype = _I
        lib.gossip_error_string.argtypes = [_I]
        lib.gossip_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _check(rc: int, lib, name: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{name} launch failed: {lib.gossip_error_string(rc).decode()}")


def _check_operands(w3d, dw3d, ext4d, ext_scales, block_rows: int):
    """Validate the operands both passes share; returns (W, P, R)."""
    if w3d.ndim != 3 or w3d.shape[2] != LANE:
        raise ValueError(f"w3d must be (W, R, {LANE}), got "
                         f"{tuple(w3d.shape)}")
    wn, rows, _ = w3d.shape
    if w3d.dtype != torch.float32 or dw3d.dtype != torch.float32:
        raise ValueError("w3d and dw3d must be float32")
    if dw3d.shape != w3d.shape:
        raise ValueError(f"dw3d {tuple(dw3d.shape)} != w3d "
                         f"{tuple(w3d.shape)}")
    if ext4d.ndim != 4 or ext4d.shape[0] != wn or \
            tuple(ext4d.shape[2:]) != (rows, LANE):
        raise ValueError(f"ext4d must be (W, P, R, LANE) = ({wn}, P, {rows}, "
                         f"{LANE}), got {tuple(ext4d.shape)}")
    p = ext4d.shape[1]
    if block_rows < 1 or rows % block_rows:
        raise ValueError(f"block_rows={block_rows} must divide R={rows}")
    if ext_scales is None:
        if ext4d.dtype != torch.float32:
            raise ValueError(f"float ext4d must be float32, got "
                             f"{ext4d.dtype} (int8 needs ext_scales)")
    else:
        if ext4d.dtype != torch.int8:
            raise ValueError("ext_scales given: ext4d must be int8")
        if tuple(ext_scales.shape) != (wn, p, rows // block_rows) or \
                ext_scales.dtype != torch.float32:
            raise ValueError(
                f"ext_scales must be float32 (W, P, R // block_rows) = "
                f"({wn}, {p}, {rows // block_rows}), got "
                f"{ext_scales.dtype} {tuple(ext_scales.shape)}")
    return wn, p, rows


def _cuda_ready(*tensors) -> bool:
    """True for CUDA operands (checked contiguous, aligned, one device);
    False for CPU operands; raises for a mix or another device."""
    devices = {t.device for t in tensors if t is not None}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    dev = devices.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"gossip-blend kernels run on cuda (or their plain "
                         f"version on cpu), got device {dev}")
    for t in tensors:
        if t is not None and (not t.is_contiguous() or t.data_ptr() % 16):
            raise ValueError("kernel operands must be contiguous and "
                             "16-byte aligned")
    return True


def _ptr(t):
    return None if t is None else t.data_ptr()


def gossip_reduce_w_resident(w3d, dw3d, ext4d, row_range, ext_scales=None,
                             *, block_rows: int):
    """Pass 1.  w3d/dw3d: (W, R, LANE) f32; ext4d: (W, P, R, LANE) f32, or
    int8 with ext_scales (W, P, R // block_rows) f32; row_range: host ints
    (r0, r1) of the exchanged partition.

    Returns (W, P, 3) f32: [<dw, w - ext_p>, ||ext_p||^2, ||dw||^2] with
    every term restricted to rows [r0, r1) — reproducible run to run (a
    fixed-order two-launch reduction, no atomics)."""
    wn, p, rows = _check_operands(w3d, dw3d, ext4d, ext_scales, block_rows)
    r0, r1 = clamp_row_range(row_range, rows)
    if not _cuda_ready(w3d, dw3d, ext4d, ext_scales):
        return gossip_reduce_w_resident_plain(
            w3d, dw3d, ext4d, (r0, r1), ext_scales, block_rows=block_rows)
    lib = _library()
    if p > lib.gossip_max_externals():
        raise ValueError(f"P={p} externals exceed the kernel's "
                         f"{lib.gossip_max_externals()}")
    per = lib.gossip_reduce_rows_per_block()
    nblk = -(-(r1 - r0) // per)
    partials = torch.empty((wn, max(nblk, 1), p, 3), dtype=torch.float32,
                           device=w3d.device)
    acc = torch.empty((wn, p, 3), dtype=torch.float32, device=w3d.device)
    with torch.cuda.device(w3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gossip_reduce_w_resident(
            _ptr(w3d), _ptr(dw3d), _ptr(ext4d), _ptr(ext_scales),
            _ptr(partials), _ptr(acc), wn, p, rows, r0, r1, block_rows,
            int(ext_scales is not None), stream)
    _check(rc, lib, REDUCE)
    count_launch(REDUCE)
    return acc


def gossip_apply_w_resident(w3d, dw3d, ext4d, gates, inv_denom, lr,
                            row_range, ext_scales=None, *,
                            elastic: bool = False, elastic_alpha: float = 0.5,
                            block_rows: int):
    """Pass 2: per-worker gated mean + fused eq.-1 step, the attraction
    restricted to rows [r0, r1); rows outside take ``w - lr*dw``.

    gates: (W, P) f32; inv_denom: (W,) f32 = 1 / (sum_p gates + 1); lr: a
    float or a one-element f32 tensor, read by the kernel from device
    memory at run time (an lr schedule never rebuilds anything).
    Returns the updated (W, R, LANE) f32 states (a new tensor)."""
    wn, p, rows = _check_operands(w3d, dw3d, ext4d, ext_scales, block_rows)
    r0, r1 = clamp_row_range(row_range, rows)
    if tuple(gates.shape) != (wn, p) or tuple(inv_denom.shape) != (wn,):
        raise ValueError(f"gates must be ({wn}, {p}) and inv_denom ({wn},), "
                         f"got {tuple(gates.shape)}, {tuple(inv_denom.shape)}")
    if not torch.is_tensor(lr):
        lr = torch.full((1,), float(lr), dtype=torch.float32,
                        device=w3d.device)
    if lr.numel() != 1:
        raise ValueError("lr must be a scalar")
    gates = gates.float().contiguous()
    inv_denom = inv_denom.float().contiguous()
    lr = lr.float().reshape(1).contiguous()
    if not _cuda_ready(w3d, dw3d, ext4d, ext_scales, gates, inv_denom, lr):
        return gossip_apply_w_resident_plain(
            w3d, dw3d, ext4d, gates, inv_denom, lr, (r0, r1), ext_scales,
            elastic=elastic, elastic_alpha=elastic_alpha,
            block_rows=block_rows)
    lib = _library()
    if p > lib.gossip_max_externals():
        raise ValueError(f"P={p} externals exceed the kernel's "
                         f"{lib.gossip_max_externals()}")
    out = torch.empty_like(w3d)
    with torch.cuda.device(w3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.gossip_apply_w_resident(
            _ptr(w3d), _ptr(dw3d), _ptr(ext4d), _ptr(ext_scales),
            _ptr(gates), _ptr(inv_denom), _ptr(lr), _ptr(out), wn, p, rows,
            r0, r1, block_rows, int(ext_scales is not None), int(elastic),
            float(elastic_alpha), stream)
    _check(rc, lib, APPLY)
    count_launch(APPLY)
    return out
