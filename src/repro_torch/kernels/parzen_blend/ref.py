"""Plain-torch versions of the P=1 Parzen gate + blend kernels (B6r, B6a),
and the port of the reference's oracle ``parzen_blend_ref``
(``kernels/parzen_blend/ref.py:7``)."""
from __future__ import annotations

import torch


def parzen_reduce_plain(w2d, ext2d, dw2d):
    """(3,) f32 = [<dw, w - ext>, ||dw||^2, ||ext||^2] — B6r's accumulator,
    in the TPU kernel's order (B3's keeps ||ext||^2 second)."""
    w, ext, dw = w2d.float(), ext2d.float(), dw2d.float()
    return torch.stack([(dw * (w - ext)).sum(), (dw * dw).sum(),
                        (ext * ext).sum()])


def parzen_apply_plain(w2d, ext2d, dw2d, gate, *, eps: float):
    """B6a: ``w - eps * (gate * 0.5 * (w - ext) + dw)`` in that order of
    operations; gate a one-element f32 tensor."""
    g = gate.float().reshape(())
    return w2d - eps * (g * 0.5 * (w2d - ext2d) + dw2d)


def parzen_blend_ref(w, ext, dw, eps):
    """Flat-state ASGD update with one external (eq. 5 semantics).

    w, ext, dw: (N,).  Returns (w_next (N,) f32, gate scalar f32).

      gate = [||(w - eps*dw) - ext||^2 < ||w - ext||^2] * [||ext|| > 0]
      w_next = w - eps * (gate * (w - ext)/2 + dw)
    """
    w, ext, dw = w.float(), ext.float(), dw.float()
    stepped = w - eps * dw
    d_after = torch.sum((stepped - ext) ** 2)
    d_before = torch.sum((w - ext) ** 2)
    nonempty = torch.sum(ext * ext) > 0.0
    gate = ((d_after < d_before) & nonempty).float()
    return w - eps * (gate * 0.5 * (w - ext) + dw), gate
