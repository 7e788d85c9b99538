"""ctypes bindings of the gossip-blend CUDA kernels (csrc/gossip_blend.cu).

Ports, from src/repro/kernels/gossip_blend/kernel.py:
  gossip_reduce_w_resident_pallas (:370) -> :func:`gossip_reduce_w_resident`
  gossip_apply_w_resident_pallas  (:412) -> :func:`gossip_apply_w_resident`
      (B1r/B1a)
  gossip_reduce_w_pallas (:225) -> :func:`gossip_reduce_w`   (B2r)
  gossip_apply_w_pallas  (:259) -> :func:`gossip_apply_w`    (B2a)
  gossip_reduce_pallas   (:115) -> :func:`gossip_reduce`     (B3r)
  gossip_apply_pallas    (:141) -> :func:`gossip_apply`      (B3a)
The same library holds B6r/B6a (``parzen_reduce``/``parzen_apply``), bound
in kernels/parzen_blend/kernel.py.  The source holds their byte bounds and
design notes.

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
from .ref import (clamp_row_range, gossip_apply_plain,
                  gossip_apply_w_plain, gossip_apply_w_resident_plain,
                  gossip_reduce_plain, gossip_reduce_w_plain,
                  gossip_reduce_w_resident_plain)

SOURCE = pathlib.Path(__file__).parent / "csrc" / "gossip_blend.cu"
REDUCE = "gossip_reduce_w_resident"
APPLY = "gossip_apply_w_resident"
REDUCE_W = "gossip_reduce_w"
APPLY_W = "gossip_apply_w"
REDUCE_1 = "gossip_reduce"
APPLY_1 = "gossip_apply"

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_ARGTYPES = {
    REDUCE: [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _P],
    APPLY: [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _I, _I, _I, _I, _I,
            _F, _P],
    REDUCE_W: [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _P],
    APPLY_W: [_P, _P, _P, _P, _P, _P, _P, _I, _I, _LL, _F, _I, _F, _P],
    REDUCE_1: [_P, _P, _P, _P, _P, _I, _LL, _P],
    APPLY_1: [_P, _P, _P, _P, _P, _P, _I, _LL, _F, _I, _F, _P],
    "parzen_reduce": [_P, _P, _P, _P, _P, _LL, _P],
    "parzen_apply": [_P, _P, _P, _P, _P, _LL, _F, _P],
    "gossip_reduce_rows_per_block": [],
    "gossip_max_externals": [],
}


def _library(p: int) -> ctypes.CDLL:
    """The kernels' library, built on first use; raises if ``p`` externals
    exceed what the kernels take."""
    lib = load_library(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, _I
        lib.gossip_error_string.argtypes = [_I]
        lib.gossip_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    if p > lib.gossip_max_externals():
        raise ValueError(f"P={p} externals exceed the kernel's "
                         f"{lib.gossip_max_externals()}")
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
    lib = _library(p)
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
    lib = _library(p)
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


# ---------------------------------------------------------------------------
# B2 (worker-batched, optional partition mask) and B3 (one worker)
# ---------------------------------------------------------------------------

def _check_batched(w3d, dw3d, ext4d, mask2d):
    """Validate (W, R, LANE) states, (W, P, R, LANE) externals and an
    optional (R, LANE) mask, all float32; returns (W, P, R)."""
    if w3d.ndim != 3 or w3d.shape[2] != LANE:
        raise ValueError(f"w must be (W, R, {LANE}), got {tuple(w3d.shape)}")
    wn, rows, _ = w3d.shape
    if dw3d.shape != w3d.shape:
        raise ValueError(f"dw {tuple(dw3d.shape)} != w {tuple(w3d.shape)}")
    if ext4d.ndim != 4 or ext4d.shape[0] != wn or \
            tuple(ext4d.shape[2:]) != (rows, LANE) or ext4d.shape[1] < 1:
        raise ValueError(f"ext must be (W, P >= 1, R, LANE) = ({wn}, P, "
                         f"{rows}, {LANE}), got {tuple(ext4d.shape)}")
    if mask2d is not None and tuple(mask2d.shape) != (rows, LANE):
        raise ValueError(f"mask must be ({rows}, {LANE}), got "
                         f"{tuple(mask2d.shape)}")
    for t in (w3d, dw3d, ext4d, mask2d):
        if t is not None and t.dtype != torch.float32:
            raise ValueError(f"operands must be float32, got {t.dtype}")
    if rows < 1:
        raise ValueError("R must be at least 1")
    return wn, ext4d.shape[1], rows


def _reduce_batched(w3d, dw3d, ext4d, mask2d, name):
    """Launch the B2/B3 reduce on checked CUDA operands; returns
    (W, P, 3)."""
    wn, p, rows = ext4d.shape[0], ext4d.shape[1], ext4d.shape[2]
    lib = _library(p)
    nblk = -(-rows // lib.gossip_reduce_rows_per_block())
    partials = torch.empty((wn, nblk, p, 3), dtype=torch.float32,
                           device=w3d.device)
    acc = torch.empty((wn, p, 3), dtype=torch.float32, device=w3d.device)
    with torch.cuda.device(w3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if name == REDUCE_W:
            rc = lib.gossip_reduce_w(_ptr(w3d), _ptr(dw3d), _ptr(ext4d),
                                     _ptr(mask2d), _ptr(partials), _ptr(acc),
                                     wn, p, rows, stream)
        else:
            rc = lib.gossip_reduce(_ptr(w3d), _ptr(dw3d), _ptr(ext4d),
                                   _ptr(partials), _ptr(acc), p, rows,
                                   stream)
    _check(rc, lib, name)
    count_launch(name)
    return acc


def _apply_batched(w3d, dw3d, ext4d, gates, inv_denom, mask2d, eps,
                   elastic, elastic_alpha, name):
    """Launch the B2/B3 apply on checked CUDA operands; returns
    (W, R, LANE)."""
    wn, p, rows = ext4d.shape[0], ext4d.shape[1], ext4d.shape[2]
    lib = _library(p)
    out = torch.empty_like(w3d)
    with torch.cuda.device(w3d.device):
        stream = torch.cuda.current_stream().cuda_stream
        if name == APPLY_W:
            rc = lib.gossip_apply_w(
                _ptr(w3d), _ptr(dw3d), _ptr(ext4d), _ptr(gates),
                _ptr(inv_denom), _ptr(mask2d), _ptr(out), wn, p, rows,
                float(eps), int(elastic), float(elastic_alpha), stream)
        else:
            rc = lib.gossip_apply(
                _ptr(w3d), _ptr(dw3d), _ptr(ext4d), _ptr(gates),
                _ptr(inv_denom), _ptr(out), p, rows, float(eps),
                int(elastic), float(elastic_alpha), stream)
    _check(rc, lib, name)
    count_launch(name)
    return out


def gossip_reduce_w(w3d, dw3d, ext4d, mask2d=None):
    """B2r.  w3d/dw3d: (W, R, LANE) f32; ext4d: (W, P, R, LANE) f32;
    mask2d: optional (R, LANE) f32 0/1 partition mask shared by every
    worker.  Returns (W, P, 3) f32 = [<dw, w - ext_p>, ||ext_p||^2,
    ||dw||^2], every term restricted by the mask — reproducible run to run
    (a fixed-order two-launch reduction, no atomics)."""
    _check_batched(w3d, dw3d, ext4d, mask2d)
    if not _cuda_ready(w3d, dw3d, ext4d, mask2d):
        return gossip_reduce_w_plain(w3d, dw3d, ext4d, mask2d)
    return _reduce_batched(w3d, dw3d, ext4d, mask2d, REDUCE_W)


def gossip_apply_w(w3d, dw3d, ext4d, gates, inv_denom, mask2d=None, *,
                   eps: float, elastic: bool = False,
                   elastic_alpha: float = 0.5):
    """B2a: per-worker gated mean + step, gates (W, P) f32, inv_denom (W,)
    f32 = 1 / (sum_p gates + 1), eps a static float.  Positions where the
    mask is 0 take ``w - eps*dw``.  Returns the updated (W, R, LANE) f32
    states (a new tensor)."""
    wn, p, _ = _check_batched(w3d, dw3d, ext4d, mask2d)
    if tuple(gates.shape) != (wn, p) or tuple(inv_denom.shape) != (wn,):
        raise ValueError(f"gates must be ({wn}, {p}) and inv_denom ({wn},), "
                         f"got {tuple(gates.shape)}, {tuple(inv_denom.shape)}")
    gates = gates.float().contiguous()
    inv_denom = inv_denom.float().contiguous()
    if not _cuda_ready(w3d, dw3d, ext4d, mask2d, gates, inv_denom):
        return gossip_apply_w_plain(w3d, dw3d, ext4d, gates, inv_denom,
                                    mask2d, eps=eps, elastic=elastic,
                                    elastic_alpha=elastic_alpha)
    return _apply_batched(w3d, dw3d, ext4d, gates, inv_denom, mask2d, eps,
                          elastic, elastic_alpha, APPLY_W)


def _check_single(w2d, ext3d):
    if w2d.ndim != 2 or ext3d.ndim != 3:
        raise ValueError(f"w must be (R, {LANE}) and ext (P, R, {LANE}), got "
                         f"{tuple(w2d.shape)}, {tuple(ext3d.shape)}")


def gossip_reduce(w2d, dw2d, ext3d):
    """B3r.  w2d/dw2d: (R, LANE) f32; ext3d: (P, R, LANE) f32.  Returns
    (P, 3) f32 = [<dw, w - ext_p>, ||ext_p||^2, ||dw||^2] — the TPU
    kernel's accumulator, reproducible run to run."""
    _check_single(w2d, ext3d)
    _check_batched(w2d[None], dw2d[None], ext3d[None], None)
    if not _cuda_ready(w2d, dw2d, ext3d):
        return gossip_reduce_plain(w2d, dw2d, ext3d)
    return _reduce_batched(w2d[None], dw2d[None], ext3d[None], None,
                           REDUCE_1)[0]


def gossip_apply(w2d, dw2d, ext3d, gates, inv_denom, *, eps: float,
                 elastic: bool = False, elastic_alpha: float = 0.5):
    """B3a: one worker's gated mean + step with P scalar gates (P,) f32 and
    inv_denom a scalar (float or one-element tensor) = 1 / (sum gates + 1).
    Returns the updated (R, LANE) f32 state (a new tensor)."""
    _check_single(w2d, ext3d)
    _, p, _ = _check_batched(w2d[None], dw2d[None], ext3d[None], None)
    if tuple(gates.shape) != (p,):
        raise ValueError(f"gates must be ({p},), got {tuple(gates.shape)}")
    if not torch.is_tensor(inv_denom):
        inv_denom = torch.tensor(float(inv_denom), device=w2d.device)
    if inv_denom.numel() != 1:
        raise ValueError("inv_denom must be a scalar")
    gates = gates.float().contiguous()
    inv_denom = inv_denom.float().reshape(1).contiguous()
    if not _cuda_ready(w2d, dw2d, ext3d, gates, inv_denom):
        return gossip_apply_plain(w2d, dw2d, ext3d, gates, inv_denom,
                                  eps=eps, elastic=elastic,
                                  elastic_alpha=elastic_alpha)
    return _apply_batched(w2d[None], dw2d[None], ext3d[None], gates[None],
                          inv_denom, None, eps, elastic, elastic_alpha,
                          APPLY_1)[0]
