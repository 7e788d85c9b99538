"""Mesh-agnostic sharding hints for model internals.

Model code must run identically (a) on plain tensors on one device (every
path the port runs: the tests, the trainer, the server, the mesh regions,
which replicate each worker's slice over ``model``), and (b) on DTensors
with a ``DeviceMesh`` ambient.  ``constrain`` redistributes a DTensor to a
spec's placements only when a mesh is ambient (``launch/mesh.py
mesh_context`` sets it) and only with axis names that exist on it;
otherwise it returns its argument itself.  ``gathered`` is the
all-gather at a matmul boundary of the sequence-parallel stream, a no-op
in the same cases.

The reference's model runs under ``vmap`` over the worker axis, which pads
a spec with the worker entry; the port's model carries that axis as dim 0
(W, B, S, D), so its calls name it: :data:`WORKERS` stands for the
ambient mesh's worker axes (pod and/or data).
"""
from __future__ import annotations

# the worker (vmap) dim's spec entry: the ambient mesh's (pod+)data axes
WORKERS = "__workers__"

_WORKER_AXES = ("pod", "data")
_ambient = []      # a stack of ambient meshes (mesh_context pushes one)


def push_mesh(mesh) -> None:
    _ambient.append(mesh)


def pop_mesh() -> None:
    _ambient.pop()


def ambient_mesh():
    """The innermost ambient ``DeviceMesh``, or None."""
    return _ambient[-1] if _ambient else None


def _axis_ok(a, names):
    if a is None:
        return True
    if isinstance(a, (tuple, list)):
        return all(b in names for b in a)
    return a in names


def _resolve(a, names):
    if a != WORKERS:
        return a
    wa = tuple(n for n in names if n in _WORKER_AXES)
    if not wa:
        return None
    return wa if len(wa) > 1 else wa[0]


def constrain(x, *spec):
    """``x`` redistributed to ``spec``'s placements under an ambient mesh
    when ``x`` is a DTensor; ``x`` itself without a mesh or for a plain
    tensor.  Axis names the mesh lacks are dropped; an all-None spec is a
    no-op."""
    mesh = ambient_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    names = tuple(mesh.mesh_dim_names or ())
    clean = tuple(a if _axis_ok(a, names) else None
                  for a in (_resolve(a, names) for a in spec))
    if all(a is None for a in clean):
        return x
    from ..launch.sharding import placements
    return x.redistribute(mesh, placements(mesh, clean))


def gathered(x):
    """``x`` all-gathered to ``Replicate()`` under an ambient mesh when it
    is a DTensor sharded there; ``x`` itself otherwise.  The all-gather
    XLA inserts at a matmul boundary of the sequence-parallel stream
    (the reference's seq_parallel), written out: DTensor's einsum would
    flatten the sharded sequence dim into the batch, which it refuses."""
    if ambient_mesh() is None:
        return x
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(x, DTensor) or all(isinstance(p, Replicate)
                                         for p in x.placements):
        return x
    return x.redistribute(x.device_mesh, (Replicate(),) * x.device_mesh.ndim)
