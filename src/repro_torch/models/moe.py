"""Mixture-of-Experts FFN with top-k routing and capacity-based dispatch.

Covers phi3.5-moe (16 experts, top-2) and granite-moe (32 experts, top-8),
as the reference's ``models/moe.py`` does: tokens are placed into an
(E, C, D) capacity buffer, every expert computes only its capacity slice,
and the results come back weighted by the router's probabilities.  The
router's Switch-style load-balance loss comes out beside the output.

Worker batching as in common.py: params carry a leading worker axis (W,
...) and activations are (W, B, S, D); one model is W = 1.  Dispatch
groups never cross workers: T = B*S is counted per worker, and each
worker's tokens split into ``dispatch_groups`` independent groups (the
reference vmaps over them), each with its own capacity.

Determinism: the dispatch and the gather-back are row gathers through
one-to-one slot tables, never scatters that add.  A (token, slot) pair
that overflows its expert reads, and a capacity slot that no pair fills
holds, one zero sentinel row — the exact zeros the reference writes.  So
every kept row moves once each way, the backward of each gather adds at
most one value into any row that is read afterwards (the sentinel's
gradient is dropped), and a token's k expert outputs add up in slot order
as a (Tg, k, D) sum, where the reference adds them with
``.at[tok].add``.  No float atomics decide a value on the card.

Expert parallelism (launch/tensor_parallel.py; :func:`_apply_placed`):
on DTensor leaves placed by ``launch/sharding.py param_pspec`` — each
expert leaf (W, E, D, F) / (W, E, F, D) ``Shard(1)`` over the 1-D
``model`` mesh, the router ``Replicate()`` — the FFN runs on local
tensors, under this contract:

* routing is identical on every ``model`` rank: each takes the FFN's
  input and the router whole and runs :func:`route` and
  :func:`capacity_slots` with the GLOBAL expert count E, so C and the
  slot numbering e*C + pos are the single-device program's;
* rank r owns experts [r*E_l, (r+1)*E_l) (E_l = E / model) and their
  slots; it gathers only those slots' rows, runs its local gate/up/down
  shards, and gathers back the pairs it owns (the sentinel zero row for
  every other pair);
* the combine is summed over ``model`` once: each rank's (W, B, S, D)
  part is a ``Partial`` that the layer all-reduces (or reduce-scatters
  under seq_parallel, models/blocks.py ``_ffn``); the gradients of the
  input and the router come back ``Partial`` too (each rank's pairs),
  and a local expert leaf's gradient stays its shard;
* the Switch aux loss, computed alike on every rank, is differentiated
  once: its gradient is scaled by 1/model before it meets the partial
  views (exact at a power-of-two ``model``);
* dispatch groups and positions are global over the data axes: where
  the serving batch is sliced over them (:func:`batch_slice`), the
  global groups of the reference's single-device program are formed
  again — a slice that holds whole groups runs them locally, otherwise
  each rank adds to its running counts those of the earlier slices in
  the same group, an exclusive scan of E ints a chunk over the data
  axes.  Training slices workers, never a worker's batch: its groups
  are whole on every rank.

Where E does not divide over ``model`` (``param_pspec`` then shards
gate/up over F, else D, and down over D, else F, else replicates), every
rank gathers every expert whole and runs the whole FFN, its views'
gradients ``Replicate``: correct, not parallel, as attention's d_model
fallback.  Each placed call counts in :func:`placed_calls`.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F

from .common import activation, dense_init, placed, whole_local


def init_moe(generator, d_model, d_ff, n_experts, dtype=torch.float32,
             device=None):
    """One model's MoE params (no worker axis), the reference's layout;
    the router is always f32."""
    kw = {"generator": generator, "device": device}
    return {
        "router": dense_init(shape=(d_model, n_experts), in_axis=0,
                             dtype=torch.float32, **kw),
        "gate": dense_init(shape=(n_experts, d_model, d_ff), in_axis=1,
                           dtype=dtype, **kw),
        "up": dense_init(shape=(n_experts, d_model, d_ff), in_axis=1,
                         dtype=dtype, **kw),
        "down": dense_init(shape=(n_experts, d_ff, d_model), in_axis=1,
                           dtype=dtype, **kw),
    }


def route(params, x, topk):
    """x: (W, ..., T, D) -> (weights (W, ..., T, k), idx (W, ..., T, k),
    aux_loss (W, ...), load (W, ..., E)), one router per worker.

    Top-k in descending order (a token's slots in that order), the k
    weights renormalized to sum to one, and the aux loss E * <f, p>: f the
    mean over tokens of each expert's top-k count (no gradient), p the
    mean router probability."""
    router = params["router"]                           # (W, D, E)
    logits = (x.float().reshape(router.shape[0], -1, router.shape[1])
              @ router).reshape(x.shape[:-1] + router.shape[-1:])
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, topk, dim=-1, sorted=True)
    w = w / w.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    E = logits.shape[-1]
    # means as the reference's compile: a multiply by the f32 reciprocal
    inv_t = 1.0 / x.shape[-2]
    f = _one_hot(idx, E).sum(dim=(-3, -2)).float() * inv_t
    p = probs.sum(dim=-2) * inv_t
    aux = E * (f * p).sum(dim=-1)
    return w.to(x.dtype), idx, aux, f


def _one_hot(idx, n):
    """``F.one_hot(idx, n)`` (int64) as a comparison with ``arange``: the
    same ops on every device, where ``F.one_hot`` checks its range on the
    CPU (a host sync) and not on CUDA, so a meta-device trace
    (launch/dryrun.py) counts what the card runs."""
    return (idx[..., None] == torch.arange(n, device=idx.device)).long()


def _blocked_cumsum(x, blk=4096):
    """Exact two-level inclusive cumsum of integer counts along axis -2,
    the reference's form: within blocks of ``blk`` rows, then the blocks'
    totals as offsets.  x: (..., n, e)."""
    n, e = x.shape[-2:]
    if n <= blk:
        return torch.cumsum(x, dim=-2)
    lead = tuple(x.shape[:-2])
    nb = -(-n // blk)
    xb = F.pad(x, (0, 0, 0, nb * blk - n)).reshape(lead + (nb, blk, e))
    within = torch.cumsum(xb, dim=-2)                  # (..., nb, blk, E)
    totals = within[..., -1, :]                        # (..., nb, E)
    offsets = torch.cumsum(totals, dim=-2) - totals    # exclusive
    out = (within + offsets[..., None, :]).reshape(lead + (nb * blk, e))
    return out[..., :n, :]


def _gather_rows(src, index):
    """src (W, G, n, D), index (W, G, m) -> (W, G, m, D)."""
    return torch.gather(src, 2, index[..., None].expand(
        index.shape + (src.shape[-1],)))


def _with_zero_row(x):
    """(W, G, n, D) -> (W, G, n + 1, D): the sentinel zero row at n."""
    return torch.cat([x, x.new_zeros(x.shape[:2] + (1, x.shape[-1]))], dim=2)


def capacity_slots(idx, E, C, offset=None):
    """idx (..., Tg, k) -> (slot (..., Tg*k), keep (..., Tg*k)): each
    (token, slot) pair's place e*C + pos in the (E, C) buffer, E*C (the
    sentinel) where it is dropped.  Pairs go token-major, slot-minor; a
    pair's position is the running count of its expert over the pairs
    before it, the reference's; pairs at position >= C are dropped.
    ``offset`` (..., E): counts of each expert's pairs that come before
    these tokens in their group (a group split over the data axes)."""
    flat_e = idx.reshape(idx.shape[:-2] + (-1,))
    onehot = _one_hot(flat_e, E)                        # (..., N, E)
    pos_in_e = _blocked_cumsum(onehot) - 1              # running count
    if offset is not None:
        pos_in_e = pos_in_e + offset[..., None, :]
    pos = torch.gather(pos_in_e, -1, flat_e[..., None])[..., 0]
    keep = pos < C                                      # overflow dropped
    return torch.where(keep, flat_e * C + pos, E * C), keep


def _dispatch_group(params, xt, topk, act, C):
    """Capacity dispatch of every worker's token groups at once, capacity
    C an expert per group.  xt: (W, G, Tg, D) -> (y (W, G, Tg, D), aux
    (W, G))."""
    E = params["router"].shape[-1]
    w, idx, aux, _ = route(params, xt, topk)            # (W, G, Tg, k)
    slot, _ = capacity_slots(idx, E, C)                 # (W, G, N)
    return _experts(params, xt, w, slot, act, E, C), aux


def _experts(params, xt, w, slot, act, E, C):
    """The dispatch to E experts' C slots a group, their FFN and the
    weighted gather back: xt (W, G, Tg, D), w (W, G, Tg, k), slot
    (W, G, Tg*k) in [0, E*C], E*C a pair the experts do not take.
    params' gate/up/down hold those E experts.  -> y (W, G, Tg, D)."""
    Wn, G, Tg, D = xt.shape
    topk = w.shape[-1]
    N = Tg * topk
    # the pair that fills each slot (N: the sentinel); kept slots unique
    filler = torch.full((Wn, G, E * C + 1), N, dtype=slot.dtype,
                        device=xt.device)
    filler.scatter_(-1, slot, torch.arange(N, device=xt.device)
                    .expand(Wn, G, N))
    filler = filler[..., :E * C]

    # dispatch: every pair's token row, then each slot's filler
    xk = xt[:, :, :, None].expand(Wn, G, Tg, topk, D).reshape(Wn, G, N, D)
    buf = _gather_rows(_with_zero_row(xk), filler)      # (W, G, E*C, D)
    buf = (buf.reshape(Wn, G, E, C, D).transpose(1, 2)
           .reshape(Wn, E, G * C, D))

    # expert FFN on the capacity slices: (W, E, G*C, D) x (W, E, D, F).
    # At W > 1 a stacked layer's (W, E) weight views do not fold into one
    # batch stride, so each product copies its weight; one matmul a
    # worker instead took longer at the training step's shapes (its
    # launches cost more than the copies)
    f = activation(act)
    h = f(buf @ params["gate"]) * (buf @ params["up"])
    out = h @ params["down"]                            # (W, E, G*C, D)
    out = (out.reshape(Wn, E, G, C, D).transpose(1, 2)
           .reshape(Wn, G, E * C, D))

    # gather back, weighted, the k slots of a token summed in slot order
    gathered = _gather_rows(_with_zero_row(out), slot)  # (W, G, N, D)
    return (gathered.reshape(Wn, G, Tg, topk, D)
            * w[..., None].to(gathered.dtype)).sum(dim=-2)


def apply_moe(params, x, topk, act="silu", capacity_factor=1.25,
              dispatch_groups=1):
    """x: (W, B, S, D) -> (y (W, B, S, D), aux_loss (W,)).

    Each worker's T = B*S tokens split into ``dispatch_groups`` groups
    when that divides T (else one), each with capacity
    C = max(1, int(capacity_factor * Tg * k / E)); aux is the mean over a
    worker's groups.  On placed leaves, expert-parallel under the module
    docstring's contract (:func:`_apply_placed`)."""
    E = params["router"].shape[-1]

    def groups(T):
        return dispatch_groups if T % dispatch_groups == 0 else 1

    def capacity(Tg):
        return max(1, int(capacity_factor * Tg * topk / E))
    if placed(params["router"]):
        return _apply_placed(params, x, topk, act, groups, capacity)
    Wn, B, S, D = x.shape
    g = groups(B * S)
    Tg = B * S // g
    y, aux = _dispatch_group(params, x.reshape(Wn, g, Tg, D), topk, act,
                             capacity(Tg))
    return y.reshape(Wn, B, S, D), aux.sum(dim=-1) * (1.0 / g)


def apply_moe_decode(params, x, topk, act="silu"):
    """Decode path: x (W, B, 1, D), one group of B tokens per worker, with
    the reference's capacity C = max(1, ceil(B*k/E) * 2).  That capacity
    can still drop (token, slot) pairs (the reference's comment says it
    drops nothing; at granite's B 4, k 8, E 32 it does), and the port
    drops the same ones.  Returns (y (W, B, 1, D), zeros (W,)).  On
    placed leaves, expert-parallel under the module docstring's contract:
    routing identical over ``model``, the combine summed once, and B and
    the running positions the global batch's over the data axes
    (:func:`batch_slice`), a scan of each expert's count over them."""
    Wn, B, _, D = x.shape
    E = params["router"].shape[-1]

    def capacity(B):
        return max(1, -(-B * topk // E) * 2)
    zeros = torch.zeros((Wn,), dtype=torch.float32, device=x.device)
    if placed(params["router"]):
        return _apply_placed(params, x, topk, act, lambda T: 1,
                             capacity)[0], zeros
    y, _ = _dispatch_group(params, x.reshape(Wn, 1, B, D), topk, act,
                           capacity(B))
    return y.reshape(Wn, B, 1, D), zeros


# ---------------------------------------------------------------------------
# expert parallelism on placed leaves (launch/tensor_parallel.py)
# ---------------------------------------------------------------------------

_slices = []       # the ambient batch slices, innermost last
_placed = [0]      # calls of _apply_placed


def placed_calls() -> int:
    """Calls of the placed MoE (:func:`_apply_placed`) since the last
    :func:`reset_placed_calls`."""
    return _placed[0]


def reset_placed_calls() -> None:
    _placed[0] = 0


@contextlib.contextmanager
def batch_slice(index: int, count: int, gather):
    """Inside the block a placed MoE's input (W, B, S, D) holds slice
    ``index`` of ``count`` equal, contiguous slices of the batch, the
    global batch count*B (the tensor-parallel serve over the data axes);
    ``gather(t)`` all-gathers a (W, ...) tensor over the slices, slice
    order, as (count*W, ...)."""
    _slices.append((index, count, gather))
    try:
        yield
    finally:
        _slices.pop()


class _GradScale(torch.autograd.Function):
    """The identity, its gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


def _chunk_offsets(idx, E, per_group, index, gather):
    """(W, G, E): each of this slice's G chunks' count of every expert's
    pairs before it in its group — the chunks of all slices in global
    order, ``per_group`` a group, their counts all-gathered and scanned
    (exclusive) within each group."""
    Wn, G = idx.shape[:2]
    counts = _one_hot(idx.reshape(Wn, G, -1), E).sum(dim=-2)   # (W, G, E)
    every = gather(counts)
    n = every.shape[0] // Wn
    every = every.reshape(n, Wn, G, E).transpose(0, 1).reshape(Wn, n * G, E)
    before = torch.cumsum(every, dim=1) - every
    start = before[:, ::per_group].repeat_interleave(per_group, dim=1)
    return (before - start)[:, index * G:(index + 1) * G]


def _apply_placed(params, x, topk, act, groups, capacity):
    """:func:`apply_moe` / :func:`apply_moe_decode` on placed leaves (the
    module docstring's contract).  ``groups(T)`` and ``capacity(Tg)``:
    the dispatch groups of T tokens and the capacity of a group of Tg, of
    the GLOBAL batch.  The rank's tokens split into chunks of q =
    gcd(Tg, its tokens), each inside one group: whole groups where the
    slice holds them, else a chunk's positions offset by the chunks
    before it in its group (:func:`_chunk_offsets`).  Returns (y (W, B, S,
    D): a ``Partial`` over ``model`` where the experts split, else
    ``Replicate``; aux (W,) ``Replicate``, the mean of the chunks')."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    _placed[0] += 1
    router = params["router"]
    mesh, E = router.device_mesh, router.shape[-1]
    split = params["gate"].placements == (Shard(1),)
    if split and any(params[k].placements != (Shard(1),)
                     for k in ("up", "down")):
        raise ValueError("MoE experts placed " + str(
            [params[k].placements for k in ("gate", "up", "down")]))
    index, count, gather = _slices[-1] if _slices else (0, 1, None)
    Wn, B, S, D = x.shape
    T = count * B * S
    Tg = T // groups(T)
    C = capacity(Tg)
    q = math.gcd(Tg, B * S)
    xt = whole_local(x, split).reshape(Wn, B * S // q, q, D)
    w, idx, aux, _ = route({"router": whole_local(router, split)}, xt, topk)
    offset = None
    if q != Tg:
        offset = _chunk_offsets(idx, E, Tg // q, index, gather)
    slot, _ = capacity_slots(idx, E, C, offset)
    if split:
        El = E // mesh.size()
        first = mesh.get_local_rank() * El * C
        mine = (slot >= first) & (slot < first + El * C)
        slot = torch.where(mine, slot - first, El * C)
        experts = {k: params[k].to_local() for k in ("gate", "up", "down")}
        aux = _GradScale.apply(aux, 1.0 / mesh.size())
    else:
        El = E
        experts = {k: whole_local(params[k], False)
                   for k in ("gate", "up", "down")}
    y = _experts(experts, xt, w, slot, act, El, C).reshape(Wn, B, S, D)
    aux = aux.sum(dim=-1) * (1.0 / aux.shape[-1])
    return (DTensor.from_local(y, mesh, (Partial(),) if split
                               else (Replicate(),), run_check=False),
            DTensor.from_local(aux, mesh, (Replicate(),), run_check=False))
