"""K-Means clustering as a gradient-descent problem — paper §5.1, eqs. (8)-(10).

The paper evaluates ASGD on K-Means because it leaves "little room for
algorithmic optimization other than the choice of the numerical optimization
method".  State w is the (k, d) tensor of cluster prototypes.

  E(w)        = sum_i 1/2 (x_i - w_{s_i(w)})^2          quantization error (8)
  batch step  : Delta(w_k) = 1/m' sum_{i: s_i = k} (x_i - w_k)        (9)
  online step : Delta(w_k) = (x_i - w_k) for k = s_i(w)               (10)

As in the reference, the deltas are returned with the ``asgd_update`` sign
convention (w <- w - eps * dw), i.e. dw := (w_k - x_i)-style steps.

Every E/M step goes through the fused kernel B4 (kernels/kmeans_assign):
on CUDA tensors its hand-written kernel, on CPU tensors its plain version.
The ``*_w`` functions take a leading worker axis — W prototype sets, with
one shared sample set or one per worker — in one launch; the round
simulator (core/baselines.py) runs on them.
"""
from __future__ import annotations

import torch

from ..kernels.kmeans_assign import kmeans_assign, kmeans_assign_w
from ..kernels.kmeans_assign.ref import minibatch_delta_from_stats


def assign(x, w):
    """s_i(w): index of the closest prototype per sample.

    x: (m, d), w: (k, d) -> (m,) int32, by the expansion
    ||x-w||^2 = ||x||^2 - 2 x.w^T + ||w||^2 with ||x||^2 dropped (B4)."""
    return kmeans_assign(x, w)[0]


def _gather_rows(w, s):
    """w (W, K, D), s (W, M) -> w[i, s[i, j]] as (W, M, D)."""
    return torch.gather(w, 1, s.long()[..., None].expand(
        -1, -1, w.shape[-1]))


def quantization_error(x, w):
    """Paper eq. (8) (mean over samples, not sum — scale-free for plots)."""
    s = assign(x, w)
    return 0.5 * torch.mean(torch.sum((x - w[s.long()]) ** 2, dim=-1))


def quantization_error_w(x, w):
    """Eq. (8) for W prototype sets at once: x (M, D) shared or (W, M, D),
    w (W, K, D) -> (W,) errors, one B4 launch."""
    s = kmeans_assign_w(x.float().contiguous(), w.float().contiguous())[0]
    return 0.5 * torch.mean(torch.sum((x - _gather_rows(w, s)) ** 2,
                                      dim=-1), dim=-1)


def minibatch_delta(x_batch, w):
    """Paper eq. (9) with m' = |batch|: mean attraction per prototype.

    Returns dw with the ``asgd_update`` sign convention (w <- w - eps*dw),
    dw_k = 1/m' sum_{i: s_i=k} (w_k - x_i); prototypes with no assigned
    sample get dw_k = 0 — the mean over the batch (paper's 1/m'), not per
    cluster."""
    _, sums, counts = kmeans_assign(x_batch, w)
    return minibatch_delta_from_stats(w, sums, counts, x_batch.shape[0])


def minibatch_delta_w(batches, w):
    """Eq. (9) for W workers at once: batches (W, b, D), w (W, K, D) ->
    (W, K, D), one B4 launch."""
    _, sums, counts = kmeans_assign_w(batches.float().contiguous(),
                                      w.float().contiguous())
    return minibatch_delta_from_stats(w, sums, counts, batches.shape[1])


def online_delta(x_i, w):
    """Paper eq. (10): single-sample online step (SGD baseline)."""
    s = assign(x_i[None, :], w).long()                 # (1,), no host read
    dw = torch.zeros_like(w)
    dw[s] = w[s] - x_i[None, :]
    return dw


def batch_delta(x, w):
    """Paper eq. (9) with m' = m (full BATCH step, alg. 1)."""
    return minibatch_delta(x, w)


def ground_truth_error(w, centers_true):
    """Paper §5.4 evaluation: distance of found prototypes to generating
    centers, greedily matched (relative measure only — see paper caveats)."""
    d2 = torch.sum((w[:, None, :] - centers_true[None, :, :]) ** 2, dim=-1)
    return torch.mean(torch.min(d2, dim=-1).values)


def synthetic_clusters(generator, k, d, m, spread=0.15):
    """Paper §5.3 synthetic data, drawn on ``generator``'s device: k centers
    uniform in [-1, 1)^d, m labels uniform over them, per-cluster sigma in
    [0.5, 1.5) * spread, x = center + sigma * N(0, 1).

    Returns (x: (m, d) f32, centers: (k, d), labels: (m,) int32).  The
    reference draws from jax.random; this draws from torch's generator, so
    the two agree in distribution, not in values.  The noise is scaled and
    shifted in place (one (m, d) buffer besides the centres' gather)."""
    dev = generator.device
    centers = torch.rand((k, d), generator=generator, device=dev) * 2.0 - 1.0
    labels = torch.randint(0, k, (m,), generator=generator, device=dev)
    sig = spread * (0.5 + torch.rand((k,), generator=generator, device=dev))
    x = torch.randn((m, d), generator=generator, device=dev)
    x.mul_(sig[labels][:, None]).add_(centers[labels])
    return x, centers, labels.to(torch.int32)


def choose_prototype_indices(generator, m, k):
    """k distinct sample indices, drawn on ``generator``'s device."""
    return torch.randperm(m, generator=generator,
                          device=generator.device)[:k]


def init_prototypes(x, idx):
    """k-means|| style cheap init: the samples ``idx`` (k distinct indices,
    e.g. from :func:`choose_prototype_indices`) as prototypes."""
    return x[idx.to(x.device)].clone()
