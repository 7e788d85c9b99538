"""Plain-torch versions of the K-Means E/M fused step (kernel B4).

:func:`kmeans_assign_ref` ports the reference's oracle
(``kernels/kmeans_assign/ref.py:8``); :func:`kmeans_assign_plain` is the
same function with the kernel's optional worker axis, what the wrapper runs
for CPU tensors and what chip_smoke.py holds the kernel against on the
card.
"""
from __future__ import annotations

import torch


def kmeans_assign_ref(x, w):
    """x: (M, D), w: (K, D) ->
      idx    (M,)  int32   — closest prototype per sample (E-step)
      sums   (K, D) f32    — sum of samples per prototype (M-step partial)
      counts (K,)  f32     — samples per prototype

    Scores are ``-2 * (x @ w.T) + ||w||^2`` in that order; argmin takes the
    first index on a tie.  The mini-batch gradient eq. (9) follows as
    ``dw = (counts[:, None] * w - sums) / M``.
    """
    scores = -2.0 * (x @ w.T) + torch.sum(w * w, dim=-1)[None, :]
    idx = torch.argmin(scores, dim=-1).to(torch.int32)
    onehot = torch.nn.functional.one_hot(idx.long(), w.shape[0]).to(x.dtype)
    sums = onehot.T @ x
    counts = onehot.sum(dim=0)
    return idx, sums.float(), counts.float()


def minibatch_delta_from_stats(w, sums, counts, m):
    """Paper eq. (9) from the fused M-step statistics; any leading worker
    axis broadcasts."""
    return (counts[..., None] * w - sums) / m


def kmeans_assign_plain(x, w):
    """B4's function with a worker axis, in plain torch.

    x: (M, D) shared by every worker, or (W, M, D); w: (W, K, D); f32.
    Returns idx (W, M) int32, sums (W, K, D) f32, counts (W, K) f32.
    Counts are integer counts converted to f32 once (exact up to 2^24,
    correctly rounded above), as the kernel's are."""
    wn, k, _ = w.shape
    scores = (-2.0 * torch.matmul(x, w.transpose(1, 2))
              + torch.sum(w * w, dim=-1)[:, None, :])        # (W, M, K)
    idx = torch.argmin(scores, dim=-1)                       # (W, M)
    del scores
    onehot = torch.nn.functional.one_hot(idx, k).to(x.dtype)
    sums = torch.matmul(onehot.transpose(1, 2), x)           # (W, K, D)
    del onehot
    offs = torch.arange(wn, device=w.device)[:, None] * k
    counts = torch.bincount((idx + offs).reshape(-1), minlength=wn * k)
    return (idx.to(torch.int32), sums.float(),
            counts.reshape(wn, k).float())
