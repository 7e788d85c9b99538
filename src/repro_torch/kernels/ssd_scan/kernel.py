"""ctypes binding of the Mamba-2 chunked SSD scan kernel (csrc/ssd_scan.cu)
and of its backward (csrc/ssd_scan_bwd.cu).

Ports ``ssd_scan_pallas`` (src/repro/kernels/ssd_scan/kernel.py:85) ->
:func:`ssd_scan_chunked` (B5).  The reference has no backward kernel: it
trains by ``jax.grad`` of its jnp chunked form (models/ssm.py:67
``ssd_chunked``); B5b computes that gradient.  The sources hold their
bounds and design notes.

:func:`ssd_scan_chunked` checks shapes, dtype, device and layout (x, B and
C may be views at a row stride, :func:`row_strides`; dt and A are
contiguous) and runs a ``torch.autograd.Function``.  For CPU tensors both
directions are the plain-torch versions (ref.py).  For CUDA tensors the
forward allocates B5's workspace and launches B5's three stages on the
current stream (``lib.ssd_launches()`` device launches), and keeps that
workspace (C.B^T, L, every chunk's h_prev) when autograd will need it; the
backward launches B5b's four stages on it.  Each raises if a launch
failed, and each call counts one launch (kernels.count_launch).  For meta
tensors (the dry-run) both directions return outputs of the kernels'
shapes — the forward's workspace too, sized as ssd_scan.cu sizes it — run
no plain version, and note the call with its modeled work
(kernels.modeled_launch); any other device raises.  No path falls back to
a plain version on the card.
"""
from __future__ import annotations

import ctypes
import pathlib

import torch

from .. import count_launch, load_library, modeled_launch, plain_modeled
from .ref import ssd_scan_plain_bwd, ssd_scan_plain_saved

SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd_scan.cu"
BWD_SOURCE = pathlib.Path(__file__).parent / "csrc" / "ssd_scan_bwd.cu"
SCAN = "ssd_scan"
SCAN_BWD = "ssd_scan_bwd"

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _library() -> ctypes.CDLL:
    lib = load_library(SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.ssd_scan.argtypes = [_P] * 8 + [_I] * 6 + [_L, _L, _P]
        lib.ssd_scan.restype = _I
        lib.ssd_workspace_floats.argtypes = [_I] * 6
        lib.ssd_workspace_floats.restype = ctypes.c_size_t
        lib.ssd_workspace_parts.argtypes = [_I] * 6 + [_P]
        lib.ssd_workspace_parts.restype = None
        for fn in (lib.ssd_max_chunk, lib.ssd_max_state, lib.ssd_launches):
            fn.argtypes, fn.restype = [], _I
        lib.ssd_error_string.argtypes = [_I]
        lib.ssd_error_string.restype = ctypes.c_char_p
        lib._argtypes_set = True
    return lib


def _bwd_library() -> ctypes.CDLL:
    lib = load_library(BWD_SOURCE)
    if not getattr(lib, "_argtypes_set", False):
        lib.ssd_scan_bwd.argtypes = [_P] * 16 + [_I] * 6 + [_L, _L, _P]
        lib.ssd_scan_bwd.restype = _I
        lib.ssd_bwd_workspace_floats.argtypes = [_I] * 6
        lib.ssd_bwd_workspace_floats.restype = ctypes.c_size_t
        for fn in (lib.ssd_bwd_launches, lib.ssd_bwd_max_head_dim):
            fn.argtypes, fn.restype = [], _I
        lib.ssd_bwd_error_string.argtypes = [_I]
        lib.ssd_bwd_error_string.restype = ctypes.c_char_p
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


def _kernel_strides(x, dt, A, B, C):
    strides = row_strides(x, B, C)
    if strides is None or not (dt.is_contiguous() and A.is_contiguous()):
        raise ValueError("kernel operands must be contiguous (x, B and C: "
                         "contiguous rows at one stride for B and C)")
    return strides


def _scan_cuda(x, dt, A, B, C, chunk):
    """B5 on the card: (y, h_final, workspace)."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    strides = _kernel_strides(x, dt, A, B, C)
    lib = _library()
    if chunk > lib.ssd_max_chunk() or N > lib.ssd_max_state():
        raise ValueError(f"chunk={chunk} / N={N} exceed the kernel's "
                         f"{lib.ssd_max_chunk()} / {lib.ssd_max_state()}")
    dev = x.device
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
    return y, h, work


def _round_up(v: int, m: int) -> int:
    return -(-v // m) * m


def workspace_floats(Bb, S, H, P, N, Q) -> int:
    """Floats of B5's workspace: C.B^T, L and h_prev of every chunk (the
    ``sizes`` of ssd_scan.cu, whose ``ssd_workspace_floats`` returns the
    same)."""
    qp, bnc = _round_up(Q, 32), Bb * (S // Q)
    return bnc * qp * qp + bnc * H * qp + bnc * H * N * P


def bwd_workspace_floats(Bb, S, H, P, N, Q) -> int:
    """Floats of B5b's scratch (``work_parts`` of ssd_scan_bwd.cu, with its
    GH = 8 heads a group and PT = 64 columns a tile)."""
    qp, nc = _round_up(Q, 32), S // Q
    bnch, bncg = Bb * nc * H, Bb * nc * (-(-H // 8))
    return (_round_up(bnch * N * P, 4) + _round_up(bnch * qp, 4)
            + _round_up(bnch * (-(-P // 64)), 4) + bncg * qp * qp
            + 2 * _round_up(bncg * Q * N, 4))


def scan_work(Bb, S, H, P, N, Q):
    """(bytes, operations, "tf32") of B5's bound: x, dt, A, B, C read once,
    y and h written once; the multiply-adds (2 operations each) the
    function needs — C.B^T's lower triangle once per row (the heads share
    B and C), per head the triangle times xdt, C.h and the state update —
    three TF32 products each, as the kernel computes them."""
    nc = S // Q
    n_bytes = 4 * (2 * Bb * S * H * P + Bb * S * H + Bb * H + 2 * Bb * S * N
                   + Bb * H * N * P)
    n_ops = (Bb * nc * Q * (Q + 1) * N
             + Bb * H * nc * (Q * (Q + 1) * P + 4 * Q * N * P))
    return n_bytes, 3 * n_ops, "tf32"


def scan_bwd_work(Bb, S, H, P, N, Q):
    """(bytes, operations, "tf32") of B5b's bound: x, dt, A, B, C, dy and d
    h_final read once, dx, ddt, dA, dB, dC written once; the products'
    multiply-adds, none twice (the state walk over chunks 1..nc-1, per (b,
    c, h) dy_i.xdt_j and its product with dy over the triangle, B.dh_c and
    dh_c.xdt, h_prev.dy, per (b, c) the triangle's sums over B and C),
    three TF32 products each."""
    nc = S // Q
    n_bytes = 4 * (3 * Bb * S * H * P + 2 * Bb * S * H + 2 * Bb * H
                   + 4 * Bb * S * N + Bb * H * N * P)
    macs = (Bb * H * ((nc - 1) * 2 * Q * N * P
                      + nc * (Q * (Q + 1) * P + 2 * Q * N * P))
            + Bb * nc * Q * (Q + 1) * N)
    return n_bytes, 3 * 2 * macs, "tf32"


def _workspace_parts(work, Bb, S, H, P, N, chunk):
    """B5's workspace as its parts: (C.B^T, L, h_prev), flat."""
    parts = (ctypes.c_size_t * 3)()
    _library().ssd_workspace_parts(Bb, S, H, P, N, chunk, parts)
    return torch.split(work, list(parts))


def saved_for_backward(work, x, B, chunk):
    """What B5's workspace ``work`` holds for the backward, in the plain
    versions' layout: (L (Bb, nc, Q, H), h_prev (Bb, nc, H, N, P)) — for
    holding B5b against ``ref.ssd_scan_plain_bwd`` on the same inputs."""
    Bb, S, H, P = x.shape
    N, nc = B.shape[-1], S // chunk
    _, L, st = _workspace_parts(work, Bb, S, H, P, N, chunk)
    L = L.reshape(Bb, nc, H, -1)[..., :chunk].transpose(2, 3)
    return L, st.reshape(Bb, nc, H, N, P)


def _check_bwd(P):
    lib = _bwd_library()
    if P > lib.ssd_bwd_max_head_dim():
        raise ValueError(f"P={P} exceeds the backward kernel's "
                         f"{lib.ssd_bwd_max_head_dim()}")
    return lib


def _scan_bwd_cuda(x, dt, A, B, C, work, dy, dh, chunk):
    """B5b on the card: (dx, ddt, dA, dB, dC) from B5's workspace ``work``,
    dy (contiguous or not) and dh (None: zero)."""
    Bb, S, H, P = x.shape
    N = B.shape[-1]
    strides = _kernel_strides(x, dt, A, B, C)
    lib = _check_bwd(P)
    cb, L, st = _workspace_parts(work, Bb, S, H, P, N, chunk)
    dev = x.device
    dy = dy.contiguous()
    dh = None if dh is None else dh.contiguous()
    with torch.cuda.device(dev):
        grads = [torch.empty(shape, dtype=torch.float32, device=dev)
                 for shape in ((Bb, S, H, P), (Bb, S, H), (Bb, H),
                               (Bb, S, N), (Bb, S, N))]
        bwork = torch.empty(
            lib.ssd_bwd_workspace_floats(Bb, S, H, P, N, chunk),
            dtype=torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
            C.data_ptr(), cb.data_ptr(), L.data_ptr(), st.data_ptr(),
            dy.data_ptr(), None if dh is None else dh.data_ptr(),
            *(g.data_ptr() for g in grads), bwork.data_ptr(), Bb, S, H, P,
            N, chunk, *strides, stream)
    if rc != 0:
        raise RuntimeError(f"{SCAN_BWD} launch failed: "
                           f"{lib.ssd_bwd_error_string(rc).decode()}")
    count_launch(SCAN_BWD)
    return tuple(grads)


class _SSDScan(torch.autograd.Function):
    """B5 forward, B5b backward on the card; the plain versions of both on
    the CPU.  The gradient is ``jax.grad``'s of the reference's chunked
    form, clip ties included (ref.py ``ddecay``)."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.chunk = chunk
        dims = (*x.shape, B.shape[-1], chunk)
        if x.device.type == "meta":
            Bb, S, H, P, N, _ = dims
            modeled_launch(SCAN, scan_work(*dims))
            y = torch.empty((Bb, S, H, P), device="meta")
            h = torch.empty((Bb, H, N, P), device="meta")
            saved = (torch.empty(workspace_floats(*dims), device="meta"),)
        elif x.device.type == "cpu":
            y, h, L, h_prev = plain_modeled(SCAN, scan_work(*dims),
                                            ssd_scan_plain_saved, x, dt, A,
                                            B, C, chunk)
            saved = (L, h_prev)
        else:
            if any(ctx.needs_input_grad):
                _check_bwd(x.shape[-1])
            y, h, work = _scan_cuda(x, dt, A, B, C, chunk)
            saved = (work,)
        if any(ctx.needs_input_grad):
            ctx.save_for_backward(x, dt, A, B, C, *saved)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        x, dt, A, B, C, *saved = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        dims = (*x.shape, B.shape[-1], ctx.chunk)
        if x.device.type == "meta":
            modeled_launch(SCAN_BWD, scan_bwd_work(*dims))
            grads = tuple(torch.empty_like(t) for t in (x, dt, A, B, C))
        elif x.device.type == "cpu":
            grads = plain_modeled(SCAN_BWD, scan_bwd_work(*dims),
                                  ssd_scan_plain_bwd, x, dt, A, B, C, *saved,
                                  dy, dh, ctx.chunk)
        else:
            grads = _scan_bwd_cuda(x, dt, A, B, C, *saved, dy, dh,
                                   ctx.chunk)
        return (*grads, None)


def ssd_scan_chunked(x, dt, A, B, C, chunk: int):
    """B5.  x (Bb, S, H, P), dt (Bb, S, H), A (Bb, H), B/C (Bb, S, N) — the
    heads of a row share B and C — all f32; S % chunk == 0.  On CUDA, x, B
    and C may be views at a row stride (:func:`row_strides`).

    Returns (y (Bb, S, H, P), h_final (Bb, H, N, P)) f32, reproducible run
    to run (one writer per output, no atomics).  Differentiable in x, dt,
    A, B and C: on CUDA the backward is kernel B5b."""
    _check_operands(x, dt, A, B, C, chunk)
    devices = {t.device for t in (x, dt, A, B, C)}
    if len(devices) != 1:
        raise ValueError(
            f"operands on several devices: {sorted(map(str, devices))}")
    dev = x.device
    if dev.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"ssd_scan runs on cuda (or its plain version on "
                         f"cpu, its shapes on meta), got device {dev}")
    return _SSDScan.apply(x, dt, A, B, C, chunk)
