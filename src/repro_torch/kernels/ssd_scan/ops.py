"""Public wrapper of the SSD-scan kernels (B5, and B5b under autograd):
layout + padding glue."""
from __future__ import annotations

import torch.nn.functional as F

from .kernel import row_strides, ssd_scan_chunked


def pad_to_chunk(x, dt, B, C, chunk: int):
    """Pad S (axis 1) to a multiple of ``chunk`` with zero rows — exact:
    dt = 0 gives decay 1 and no input contribution."""
    pad = -x.shape[1] % chunk
    if not pad:
        return x, dt, B, C
    return (F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad)),
            F.pad(B, (0, 0, 0, pad)), F.pad(C, (0, 0, 0, pad)))


def kernel_operands(x, B, C):
    """x, B and C as the kernel reads them: the views themselves where their
    rows lie at one stride (kernel.row_strides), else contiguous copies.
    The kernel picks its copy width from the pointers and strides."""
    if row_strides(x, B, C) is not None:
        return x, B, C
    return x.contiguous(), B.contiguous(), C.contiguous()


def ssd_scan(x, dt, A, B, C, *, chunk: int = 128):
    """Model-layout entry point, mirroring the reference's ``ssd_scan``.

    x: (Bb, S, H, P); dt: (Bb, S, H); A: (H,), or (Bb, H) for a decay rate
    per batch row (the port's worker axis folded into the batch); B, C:
    (Bb, S, 1, N) (one state group, G = 1).  Returns (y (Bb, S, H, P),
    h_final (Bb, H, N, P)) f32.

    Casts to f32 and pads S to a chunk multiple (:func:`pad_to_chunk`).
    The kernel reads B and C once per row for all heads — nothing is
    broadcast per head — and reads x, B and C at their row strides: the
    model's views of its conv output go in uncopied
    (:func:`kernel_operands`).  Differentiable: the padding's ``F.pad``
    and the views pass their gradients back through autograd, and the scan
    itself differentiates by B5b on the card (kernel.py)."""
    Bb, S, H, _ = x.shape
    if B.ndim != 4 or B.shape[2] != 1 or C.shape != B.shape:
        raise ValueError(f"B and C must be (Bb, S, 1, N) (one state group), "
                         f"got {tuple(B.shape)}, {tuple(C.shape)}")
    A = A.float()
    if A.ndim == 1:
        A = A.expand(Bb, H)
    xp, dtp, Bp, Cp = pad_to_chunk(x.float(), dt.float(), B[:, :, 0].float(),
                                   C[:, :, 0].float(), chunk)
    xk, Bk, Ck = kernel_operands(xp, Bp, Cp)
    y, h = ssd_scan_chunked(xk, dtp.contiguous(), A.contiguous(), Bk, Ck,
                            chunk)
    return y[:, :S], h
