"""Per-leaf partition specs for params, batches and caches, and their
placement on a ``DeviceMesh``.

Scheme: the mesh is (data=16, model=16) [+ pod=2].  Training params carry
a leading worker axis W sharded over (pod+)data — each ASGD worker group
owns a full replica, tensor-parallel over ``model``:

  leaf kind                    spec (after the leading W axis)
  -------------------------------------------------------------
  embed (V, D)                 (model, None)    vocab-sharded
  lm_head (D, V)               (None, model)
  attn wq (D, H, Dh)           (None, model, None)   heads over model
  attn wk/wv (D, KV, Dh)       (None, model, None) if KV%16==0 else repl
  attn wo (H, Dh, D)           (model, None, None)
  mlp gate/up (D, F)           (None, model)
  mlp down (F, D)              (model, None)
  moe experts (E, D, F)        (model, None, None)   expert-parallel
  ssd in/out proj              contracting-dim sharded
  rglru in/out + w_a/w_x       lru-width sharded
  norms / scalars              replicated

Serving params drop the W axis (same specs shifted left); batches shard
their batch dim over (pod+)data; decode KV caches shard KV heads over
``model`` when divisible, else the sequence axis.  Scan-stacked layer
leaves carry an extra leading n_cycles axis (always replicated), found by
path inspection.

A spec is a plain tuple with one entry per tensor dim: ``None``
(replicated), a mesh dim name, or a tuple of names (that dim split over
several mesh dims, the first the outermost) — element for element what
``tuple(PartitionSpec(...))`` holds.  :func:`placements` maps a spec to
DTensor placements: ``Shard(d)`` on every mesh dim named at tensor dim
``d``, ``Replicate()`` on the rest; a ``("pod", "data")`` worker axis
shards dim 0 over both, pod-major — the order ``launch/mesh.py`` gives
the worker group.

The pytree train step of the dense archs runs these layouts
(``launch/tensor_parallel.py``: each rank's worker slice, every leaf a
DTensor on the mesh's ``model`` dim, ``Shard(d)`` where the spec names
``model`` at d); the packed engines' regions (``launch/mesh.py``) split
only the worker axis and replicate it over ``model``, as the reference
shards its packed ensembles.  :func:`placed_bytes` is what a device holds
of a leaf, the dry-run's and the tensor-parallel step's alike.
"""
from __future__ import annotations

import math

import torch

from ..core.tree import flatten_sorted, unflatten


def tree_paths(tree, prefix=()):
    """(path, leaf) pairs of a nested-dict tree in sorted-key order (the
    order of :func:`core.tree.flatten_sorted`); a path is the tuple of
    dict keys from the root."""
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += tree_paths(tree[k], prefix + (k,))
        return out
    return [(prefix, tree)]


def tree_map_with_path(fn, tree):
    """``fn(path, leaf)`` over every leaf, the tree's structure kept."""
    treedef = flatten_sorted(tree)[1]
    return unflatten(treedef, [fn(p, l) for p, l in tree_paths(tree)])


def _key_names(path) -> list[str]:
    names = []
    for e in path:
        if hasattr(e, "key"):
            names.append(str(e.key))
        elif hasattr(e, "name"):
            names.append(str(e.name))
        else:
            names.append(str(e))
    return names


def _spec_candidates(names: list[str], ndim: int):
    """Ordered candidate specs (best first) for one param leaf WITHOUT its
    worker/scan leading axes.  The chooser takes the first candidate whose
    sharded dims divide evenly (small head counts — 9, 6, 4 — fall back to
    sharding d_model/d_ff instead of replicating)."""
    m = "model"
    leaf = names[-1] if names else ""
    if "moe" in names:
        if leaf == "router":
            return [(None, None)]
        # (E, D, F) / (E, F, D): expert-parallel first, then inner dims
        return [(m, None, None), (None, None, m), (None, m, None)]
    if "attn" in names or "cross" in names:
        if leaf == "wq":                          # (D, H, Dh)
            return [(None, m, None), (m, None, None)]
        if leaf in ("wk", "wv"):                  # (D, KV, Dh)
            return [(None, m, None), (m, None, None)]
        if leaf == "wo":                          # (H, Dh, D)
            return [(m, None, None), (None, None, m)]
        if leaf == "bq":
            return [(m, None)]
        if leaf in ("bk", "bv"):
            return [(m, None)]
        return [(None,) * ndim]                   # q_norm/k_norm scales
    if "ssm" in names:
        if leaf == "in_proj":                     # (D, Dproj)
            return [(None, m), (m, None)]
        if leaf == "out_proj":                    # (d_inner, D)
            return [(m, None), (None, m)]
        if leaf in ("conv_w", "conv_b"):          # (K, C)/(C,)
            return [(None,) * (ndim - 1) + (m,)]
        return [(None,) * ndim]                   # A/D/dt/norm small
    if "rglru" in names:
        if leaf in ("in_x", "in_gate"):           # (D, Wl)
            return [(None, m), (m, None)]
        if leaf in ("w_a", "w_x"):                # (Wl, Wl)
            return [(None, m), (m, None)]
        if leaf == "out":                         # (Wl, D)
            return [(m, None), (None, m)]
        if leaf in ("conv_w",):
            return [(None, m)]
        if leaf in ("conv_b", "b_a", "b_x", "Lambda"):
            return [(m,)]
        return [(None,) * ndim]
    if "mlp" in names:
        if leaf in ("gate", "up"):                # (D, F)
            return [(None, m), (m, None)]
        if leaf == "down":                        # (F, D)
            return [(m, None), (None, m)]
        if leaf == "up_b":
            return [(m,)]
        return [(None,) * ndim]                   # down_b
    if leaf == "embed":                           # (V, D)
        return [(m, None), (None, m)]
    if leaf == "lm_head":                         # (D, V)
        return [(None, m), (m, None)]
    return [(None,) * ndim]                       # norms, scalars


def _axis_size(ax, axis_sizes) -> int:
    if isinstance(ax, str):
        return axis_sizes[ax]
    return math.prod(axis_sizes[a] for a in ax)


def _divides(spec, shape, axis_sizes) -> bool:
    for dim, ax in zip(shape, spec):
        if ax is None:
            continue
        if dim % _axis_size(ax, axis_sizes):
            return False
    return True


def _worker_entry(worker_axes):
    """The spec entry of the worker (or serving batch) dim."""
    return tuple(worker_axes) if len(worker_axes) > 1 else worker_axes[0]


def param_pspec(path, leaf, *, axis_sizes, worker_axes=("data",),
                train=True) -> tuple:
    """Full spec of a param leaf (train: leading W axis).  Picks the first
    divisibility-satisfying candidate."""
    names = _key_names(path)
    scanned = any(n.startswith("pos") for n in names) or "scan" in names
    extra = (1 if train else 0) + (1 if scanned else 0)
    tail_ndim = leaf.ndim - extra
    tail_shape = tuple(leaf.shape[extra:])
    tail = None
    for cand in _spec_candidates(names, tail_ndim):
        cand = tuple(cand)[:tail_ndim]
        cand = cand + (None,) * (tail_ndim - len(cand))
        if _divides(cand, tail_shape, axis_sizes):
            tail = cand
            break
    if tail is None:
        tail = (None,) * tail_ndim
    lead = ()
    if train:
        lead += (_worker_entry(worker_axes),)
    if scanned:
        lead += (None,)
    return lead + tail


def axis_sizes_of(mesh) -> dict:
    """{mesh dim name: size} of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def tree_pspecs(mesh, tree, *, worker_axes=("data",), train=True):
    sizes = axis_sizes_of(mesh)
    return tree_map_with_path(
        lambda p, l: param_pspec(p, l, axis_sizes=sizes,
                                 worker_axes=worker_axes, train=train),
        tree)


def placements(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim named at tensor dim ``d`` (a tuple entry names several, the
    first outermost), ``Replicate()`` on every other mesh dim."""
    from torch.distributed.tensor import Replicate, Shard
    out = [Replicate()] * len(mesh.mesh_dim_names)
    for d, ax in enumerate(spec):
        if ax is None:
            continue
        for a in ((ax,) if isinstance(ax, str) else ax):
            out[mesh.mesh_dim_names.index(a)] = Shard(d)
    return tuple(out)


def tree_shardings(mesh, tree, **kw):
    """The placements of every leaf of ``tree`` (:func:`tree_pspecs`)."""
    return tree_map_with_path(lambda _, s: placements(mesh, s),
                              tree_pspecs(mesh, tree, **kw))


def distribute_params(mesh, tree, *, worker_axes=("data",), train=True):
    """``tree`` placed on ``mesh`` leaf by leaf (``distribute_tensor`` with
    the leaf's :func:`placements`): every rank keeps its shard as a DTensor
    — the counterpart of attaching ``NamedSharding``s."""
    from torch.distributed.tensor import distribute_tensor
    specs = tree_pspecs(mesh, tree, worker_axes=worker_axes, train=train)
    leaves, treedef = flatten_sorted(tree)
    return unflatten(treedef, [
        distribute_tensor(x, mesh, placements(mesh, s))
        for x, s in zip(leaves, flatten_sorted(specs)[0])])


def placed_bytes(shape, dtype, spec, axis_sizes) -> int:
    """Bytes of one shard of a tensor laid out by ``spec``: each dim
    divided by the product of the mesh dims named at it (ceil)."""
    n = 1
    for i, dim in enumerate(shape):
        ax = spec[i] if i < len(spec) else None
        n *= dim if ax is None else -(-dim // _axis_size(ax, axis_sizes))
    return n * torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# batches and caches
# ---------------------------------------------------------------------------

def batch_pspec(leaf_ndim: int, *, worker_axes=("data",), train=True):
    """tokens (W, B, S) / frames (W, B, S, D) for train;
    (B, S)/(B, S, D) for serve with batch over data axes."""
    return (_worker_entry(worker_axes),) + (None,) * (leaf_ndim - 1)


def cache_pspec(path, leaf, cfg, *, axis_sizes, worker_axes=("data",)):
    """Decode KV caches: (B, S, KV, Dh) — batch over data (when divisible;
    long_500k's batch=1 degrades to replicated); KV heads over model if
    divisible, else shard S.

    SSM/RG-LRU states: shard the channel/head dims over model."""
    names = _key_names(path)
    wa = _worker_entry(worker_axes)
    scanned = any(n.startswith("pos") for n in names)
    lead = (None,) if scanned else ()
    off = 1 if scanned else 0
    leaf_nd = leaf.ndim - off
    name = names[-1]
    m_size = axis_sizes.get("model", 1)
    w_size = 1
    for a in (worker_axes if isinstance(worker_axes, (list, tuple))
              else [worker_axes]):
        w_size *= axis_sizes.get(a, 1)
    batch = leaf.shape[off]
    wa_or_none = wa if batch % w_size == 0 else None

    if name in ("k", "v", "cross_k", "cross_v"):
        kv = leaf.shape[-2]
        seq = leaf.shape[-3]
        if kv % m_size == 0:
            return lead + (wa_or_none, None, "model", None)
        if seq % m_size == 0:
            return lead + (wa_or_none, "model", None, None)   # shard seq
        return lead + (wa_or_none, None, None, None)
    if name == "ssm":                              # (B, H, N, P)
        if leaf.shape[off + 1] % m_size == 0:
            return lead + (wa_or_none, "model", None, None)
        return lead + (wa_or_none,) + (None,) * (leaf_nd - 1)
    if name == "conv":                             # (B, K-1, C)
        if leaf.shape[-1] % m_size == 0:
            return lead + (wa_or_none, None, "model")
        return lead + (wa_or_none, None, None)
    if name == "h":                                # rglru state (B, W)
        if leaf.shape[-1] % m_size == 0:
            return lead + (wa_or_none, "model")
        return lead + (wa_or_none, None)
    return lead + (wa_or_none,) + (None,) * (leaf_nd - 1)


def cache_pspecs(mesh, cache, cfg, **kw):
    sizes = axis_sizes_of(mesh)
    return tree_map_with_path(
        lambda p, l: cache_pspec(p, l, cfg, axis_sizes=sizes, **kw), cache)


def cache_shardings(mesh, cache, cfg, **kw):
    """The placements of every cache leaf (:func:`cache_pspec`)."""
    return tree_map_with_path(lambda _, s: placements(mesh, s),
                              cache_pspecs(mesh, cache, cfg, **kw))
