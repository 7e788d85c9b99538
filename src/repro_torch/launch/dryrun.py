"""Dry-run: prove that every (architecture x input shape x mesh) pair
builds and traces, and write its roofline record for one NVIDIA H100.

    python -m repro_torch.launch.dryrun --all --mesh single
    python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k \\
        --engine pipelined

The mesh is the reference's production one, (16, 16) ("data", "model")
or (2, 16, 16) ("pod", "data", "model"), built through ``launch/mesh.py``
in this one process as rank 0 of a "fake" process group of 256 (512)
ranks: it gives the arguments' specs and placements
(``launch/sharding.py``) and the worker layout, and no collective moves
data.

What is traced is the step ONE RANK of the port runs, in its layout
(``steps.layout_of``, each record's ``"layout"``):

* "tensor_parallel" — the pytree train step and every serve step, as
  ``launch/tensor_parallel.py`` runs them: each of the rank's params,
  gossip buffer and decode cache leaves a DTensor on the mesh's ``model``
  dim holding the rank's shard (``Shard(d)`` where the spec names
  ``model``, ``Replicate()`` where it names none), the worker axis and a
  serving batch the rank's slice over the data axes
  (:func:`rank_args`); its arguments' bytes are ``placed_bytes``.  The
  reference's dry-run lowers these steps with their leaves sharded so.
  The step takes the reference's plain blend (``ASGDConfig(eps=0.01)``)
  and ``--algo``'s silent and sync.
* "worker_split" — the packed and pipelined engines: the rank's W_local
  = W / n_worker_groups workers, each a full replica (the regions
  replicate every worker's slice over ``model``, as the reference's
  packed engines do).

Every argument is a ``meta`` tensor (``launch/steps.py input_specs``, cut
to the rank's shard), so nothing is allocated, and the trace runs under
the counters of what the rank runs (:class:`Counters`):

* ``FlopCounterMode`` — the aten FLOPs (``hlo_flops`` of the record);
* bytes read and written by every aten op, unfused (views and empty
  allocations move none) — an upper bound, not XLA's post-fusion bytes —
  plus each hand-written kernel's modeled bytes;
* live bytes: every tensor storage from its creation until it is freed;
  the peak is what one rank holds at once, its arguments included.
* the collectives DTensor's redistributions reach, by the reference's op
  names and wire factors (``hlo_analysis.traced_collective``).

A DTensor op counts once, as the local ops DTensor runs on the rank's
shards; DTensor's sharding propagation (ops on global shapes under a fake
mode) counts nothing.  The port's own transports (``launch/mesh.py``: the
worker ring, the rank-order sums, the gathers) send nothing on meta
tensors; their bytes are planned (``hlo_analysis.planned_collectives``).
On the dry-run's CPU mesh DTensor turns a ``Shard`` to ``Shard``
redistribution into an all-gather and a chunk (gloo has no all-to-all),
where NCCL on the card runs an all-to-all of the shard: the traced
all-gather bytes, and a peak that holds the gathered buffer, overstate
what such a redistribution costs on the card.

The kernels the trace reaches (B1r/B1a, B2r/B2a, B5, B5b) return outputs
of their shapes on meta tensors and note their modeled work
(``kernels.record_modeled``); nothing runs their plain versions.

Depth: as the reference does, the costs come from traces of one and two
cycles of the layer pattern, per_cycle = c2 − c1 and fixed = c1 −
per_cycle, scaled to the full depth.  Both shallow traces run their
cycles over the FULL model's arguments (``steps.step_and_args
layers=``): the packed layout, the gossip round and the gradient buffers
are the full model's in both, so only the stack grows, and the result is
exact wherever the depth is a whole number of cycles (a tail of layers
past the last cycle counts as a fraction of one, as in the reference).
The peak is extrapolated the same way and marked ``"extrapolated":
true``; it is exact where every cycle's live set is alike — a
tensor-parallel decode's first layer reads the replicated embedding and
every later one a residual the MLP left ``Partial`` beside its
all-reduced copy, so its extrapolated peak holds one (B_local, D) row
more for each cycle past the second.  Full depth is traced where the
shallow traces predict it fits ``--full-budget`` seconds; its time is
``trace_full_s`` (null where it was not traced, and then no full-depth
number is given).

Each record keeps the reference's keys where they have a counterpart
(``launch/hlo_analysis.py`` says what stands in for each term), and adds
``layout``, ``fits`` (the peak within the card's 80 GiB), the bytes a
device holds under the tensor-parallel specs (``placed_bytes``), the
collectives planned and traced apart, and the dtype traced.  A pair the
step of its layout cannot carry (e.g. gate sums over the data axes on
the tensor-parallel step, ``check_scope``) fails with its error.  The
records go to ``build/dryrun/`` under the repo root.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import time
import traceback

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves as _pt_leaves

from .. import kernels as K
from ..configs.registry import assigned_pairs, get_arch, get_shape
from ..core.gossip import GossipConfig
from . import sharding as SH
from . import steps as ST
from .hlo_analysis import (RooflineTerms, kernel_seconds, model_flops,
                           planned_collectives)
from .mesh import (WORKER_AXES, fake_process_group, local_worker_count,
                   make_production_mesh, n_worker_groups)

ARTIFACT_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun"
DEVICE_BYTES = 80 * 2 ** 30          # one H100's HBM
TRACE_DTYPE = torch.float32          # the port trains and serves in f32
_FACTORIES = {"empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided"}


def _moves_no_bytes(func) -> bool:
    """Views (every output aliases an input, unwritten) and empty
    allocations read and write nothing."""
    if func.__name__.split(".")[0] in _FACTORIES:
        return True
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [t for t in _pt_leaves(tree) if isinstance(t, torch.Tensor)]


def _propagation(tensors) -> bool:
    """Ops on ``FakeTensor``s: DTensor's sharding propagation, which runs
    an op at its GLOBAL shapes under a fake mode to learn the output's
    (once per op and placements: it is cached) — no rank runs them."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


class _AtenCounter(TorchDispatchMode):
    """Bytes each aten op reads and writes (each distinct input once, each
    output once) and the live bytes of every storage the step holds:
    storages are tracked from the op that made them (or :meth:`track`)
    until freed; ``peak`` is the most alive at once.

    What one rank runs, and nothing else: an op on DTensors is left to
    DTensor (``NotImplemented``), which runs the rank's local ops — they
    come back here and count once; its sharding propagation's ops at
    global shapes (:func:`_propagation`) count nothing.  The
    ``_c10d_functional`` collectives (and on CUDA ``_dtensor``'s
    all-to-all) DTensor's redistributions reach go to
    ``collectives`` (the reference's op name -> wire bytes,
    ``hlo_analysis.traced_collective``) and ``n_collectives``, not to the
    bytes; the ``c10d`` ops of the port's own transports
    (``launch/mesh.py``, which send nothing on meta tensors) count neither:
    their bytes are planned (``hlo_analysis.planned_collectives``)."""

    def __init__(self):
        super().__init__()
        from torch.distributed.tensor import DTensor
        from torch.multiprocessing.reductions import StorageWeakRef
        self._weak = StorageWeakRef
        self._placed = DTensor
        self.bytes = 0
        self.peak = 0
        self.collectives: dict = {}
        self.n_collectives = 0
        self._live: dict = {}
        self._total = 0

    def _add(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        ent = self._live.get(key)
        if ent is not None:
            if not ent[0].expired():
                return
            self._total -= ent[1]
        n = st.nbytes()
        self._live[key] = (self._weak(st), n)
        self._total += n

    def _update(self) -> None:
        if self._total <= self.peak:
            return
        for key, (ref, n) in list(self._live.items()):
            if ref.expired():
                del self._live[key]
                self._total -= n
        self.peak = max(self.peak, self._total)

    def track(self, tensors) -> None:
        for t in tensors:
            self._add(t)
        self._update()

    def _collective(self, func, outs) -> bool:
        """Note a traced collective; False for the namespace's other ops."""
        from .hlo_analysis import traced_collective
        got = traced_collective(func.__name__.split(".")[0],
                                sum(_nbytes(t) for t in outs))
        if got is None:
            return False
        name, wire = got
        self.collectives[name] = self.collectives.get(name, 0) + wire
        self.n_collectives += 1
        return True

    def _hand_on(self, ins, outs) -> None:
        """``wait_tensor`` and the async wrapper hand a collective's buffer
        on: a real run's output wraps or aliases it (no new storage); a
        meta run's wrapper makes an empty copy, which takes the buffer's
        place in the live set (the card holds one buffer)."""
        from torch.distributed._functional_collectives import \
            AsyncCollectiveTensor
        for i, o in zip(ins, outs):
            if isinstance(o, AsyncCollectiveTensor):
                continue
            key = i.untyped_storage()._cdata
            if o.untyped_storage()._cdata == key:
                continue
            ent = self._live.pop(key, None)
            if ent is not None:
                self._total -= ent[1]
            self._add(o)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, self._placed) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        outs = _tensors(out)
        ins = {id(t): t for t in _tensors((args, kwargs))}
        if _propagation(outs + list(ins.values())):
            return out
        ns = func.namespace
        if not (ns in ("_c10d_functional", "_dtensor")
                and self._collective(func, outs)):
            if ns == "_c10d_functional":
                self._hand_on(list(ins.values()), outs)
                self._update()
                return out
            if ns != "c10d" and not _moves_no_bytes(func):
                self.bytes += (sum(_nbytes(t) for t in ins.values())
                               + sum(_nbytes(t) for t in outs))
        for t in outs:
            self._add(t)
        self._update()
        return out


def _flop_counter():
    """``FlopCounterMode`` counting the rank's local ops only: it sees no
    DTensor op (:class:`_AtenCounter`, entered after it, leaves those to
    DTensor) and skips DTensor's sharding propagation."""
    from torch.utils.flop_counter import FlopCounterMode

    class LocalFlops(FlopCounterMode):
        def _count_flops(self, func_packet, out, args, kwargs):
            if _propagation(_tensors((out, args, kwargs))):
                return out
            return super()._count_flops(func_packet, out, args, kwargs)
    return LocalFlops(display=False)


class Counters:
    """The dry-run's counters around a block: aten FLOPs
    (``FlopCounterMode``), aten bytes, the live-bytes peak and the traced
    collectives (:class:`_AtenCounter`, seeded with ``tensors``, the
    step's arguments — a DTensor's local shard), and the modeled kernel
    calls (``kernels.record_modeled``), each of what one rank runs.  After
    the block: ``flops``, ``bytes``, ``peak``, ``collectives``
    ({op: wire bytes}), ``n_collectives``, ``kernels`` (the modeled
    calls), ``seconds``."""

    def __init__(self, tensors=()):
        self._tensors = list(tensors)

    def __enter__(self):
        self._rec = K.record_modeled()
        self.kernels = self._rec.__enter__()
        self._flop = _flop_counter()
        self._flop.__enter__()
        self._aten = _AtenCounter()
        self._aten.__enter__()
        self._aten.track(self._tensors)
        self._tensors = None        # the counters hold no argument alive
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.seconds = time.perf_counter() - self._t0
        self._aten.__exit__(*exc)
        self._flop.__exit__(*exc)
        self._rec.__exit__(*exc)
        self.flops = int(self._flop.get_total_flops())
        self.bytes = self._aten.bytes
        self.peak = self._aten.peak
        self.collectives = self._aten.collectives
        self.n_collectives = self._aten.n_collectives
        return False


# ---------------------------------------------------------------------------
# one rank's arguments
# ---------------------------------------------------------------------------

def _local_shape(struct, axis_sizes, axes=None) -> tuple:
    """The rank's shard of a Struct: each dim split over the mesh axes its
    spec names there (``axes``: only those of these)."""
    out = []
    for i, dim in enumerate(struct.shape):
        ax = struct.spec[i] if i < len(struct.spec) else None
        names = () if ax is None else ((ax,) if isinstance(ax, str) else ax)
        n = math.prod(axis_sizes[a] for a in names
                      if axes is None or a in axes)
        if dim % n:
            raise ValueError(f"dim {i} of {struct.shape} does not split "
                             f"over {names}")
        out.append(dim // n)
    return tuple(out)


def _map_args(fn, obj):
    """``fn`` over every Struct of an argument (dicts, tuples and state
    dataclasses of Structs; host ints pass through)."""
    if isinstance(obj, ST.Struct):
        return fn(obj)
    if isinstance(obj, dict):
        return {k: _map_args(fn, v) for k, v in obj.items()}
    if isinstance(obj, tuple):
        return tuple(_map_args(fn, v) for v in obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: _map_args(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj)})
    return obj


def _leaves(obj, kind) -> list:
    """Every leaf of type ``kind`` in an argument: dict keys in sorted
    order (the order of ``core.tree.flatten_sorted`` and
    ``jax.tree.flatten``), tuple, list and dataclass fields in order."""
    if isinstance(obj, kind):
        return [obj]
    if isinstance(obj, dict):
        return [x for k in sorted(obj) for x in _leaves(obj[k], kind)]
    if isinstance(obj, (tuple, list)):
        return [x for v in obj for x in _leaves(v, kind)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [x for f in dataclasses.fields(obj)
                for x in _leaves(getattr(obj, f.name), kind)]
    return []


def structs_of(obj) -> list:
    """Every Struct of an argument (:func:`_leaves`' order)."""
    return _leaves(obj, ST.Struct)


def arg_tensors(args) -> list:
    """Every tensor of a step's arguments (:func:`_leaves`' order), a
    DTensor's local shard in its place."""
    return [t.to_local() if hasattr(t, "to_local") else t
            for t in _leaves(args, torch.Tensor)]


# the arguments the tensor-parallel steps take placed (DTensor leaves on
# the mesh's ``model`` dim); the rest (batches, tokens) are the rank's
# plain slices
PLACED_ARGS = ("params", "gossip", "cache")


def _placed(struct, sizes, mm, device):
    """A Struct as the tensor-parallel steps take it: a DTensor on the
    ``model`` mesh ``mm``, ``Shard(d)`` where its spec names ``model`` at
    d, its shape the Struct's with the data axes' dims cut (the worker
    axis, a cache's batch), its local shard empty on ``device``."""
    from torch.distributed.tensor import DTensor

    from .tensor_parallel import model_only
    shape = _local_shape(struct, sizes, WORKER_AXES)
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    local = torch.empty(_local_shape(struct, sizes), dtype=struct.dtype,
                        device=device)
    return DTensor.from_local(local, mm, SH.placements(
        mm, model_only(struct.spec)), run_check=False,
        shape=torch.Size(shape), stride=tuple(stride))


def rank_args(specs: dict, mesh, device="meta",
              layout="worker_split") -> dict:
    """One rank's step arguments from global ``input_specs`` as empty
    tensors on ``device`` (``meta``: nothing allocated).  ``layout``
    (``steps.layout_of``): "worker_split" cuts each Struct over the worker
    axes only (the packed engines replicate the rest over ``model``);
    "tensor_parallel" cuts it over every mesh axis its spec names, the
    :data:`PLACED_ARGS` wrapped as DTensors on the ``model`` dim
    (:func:`_placed`)."""
    sizes = SH.axis_sizes_of(mesh)

    def plain(s):
        return torch.empty(_local_shape(s, sizes, WORKER_AXES),
                           dtype=s.dtype, device=device)
    if layout == "worker_split":
        return _map_args(plain, specs)
    from .tensor_parallel import model_mesh
    mm = model_mesh(mesh)
    return {k: _map_args((lambda s: _placed(s, sizes, mm, device))
                         if k in PLACED_ARGS else plain, v)
            for k, v in specs.items()}


def trace_step(cfg, shape, mesh, gcfg, algo="asgd", engine="pytree",
               workers=None, device="meta", fill=None, layers=None,
               acfg=None) -> dict:
    """Trace one rank's step of ``cfg`` under :class:`Counters`: on meta
    tensors, or on ``device`` with ``fill(args)`` writing the arguments'
    values first (the tests run the same step on real CPU tensors);
    ``layers``: only the stack's first layers run, over the full model's
    arguments (``steps.step_and_args``); ``acfg``: the pytree step's
    ASGDConfig.  The pytree train step and the serve steps run
    tensor-parallel on ``mesh`` (``steps.layout_of``).  Returns the
    counts, and the step's argument bytes and (shape, dtype) list (of a
    DTensor, its local shard)."""
    w_local = (local_worker_count(mesh, workers) if shape.kind == "train"
               else None)
    fn, specs = ST.step_and_args(cfg, shape, mesh, gcfg, algo=algo,
                                 engine=engine, dtype=TRACE_DTYPE,
                                 workers=workers, w_local=w_local,
                                 layers=layers, acfg=acfg)
    args = rank_args(specs, mesh, device, ST.layout_of(shape, engine))
    if fill is not None:
        fill(args)
    tensors = arg_tensors(args)
    with Counters(tensors) as c:
        out = fn(*args.values())
        del out
    return {"flops": c.flops, "bytes": c.bytes, "peak": c.peak,
            "kernels": list(c.kernels), "collectives": c.collectives,
            "n_collectives": c.n_collectives,
            "arg_bytes": sum(_nbytes(t) for t in tensors),
            "arg_shapes": [(tuple(t.shape), t.dtype) for t in tensors],
            "seconds": c.seconds}


def _kernel_summary(kernels) -> dict:
    out: dict = {}
    for k in kernels:
        e = out.setdefault(k["name"], {"launches": 0, "bytes": 0, "ops": 0,
                                       "ops_dtype": k["ops_dtype"]})
        e["launches"] += 1
        e["bytes"] += k["bytes"]
        e["ops"] += k["ops"]
    return out


def _extrap(v1, v2, scale):
    per_cycle = max(v2 - v1, 0.0)
    fixed = max(v1 - per_cycle, 0.0)
    return fixed + per_cycle * scale


def _kernel_extrap(k1, k2, scale) -> dict:
    out = {}
    for name in sorted(set(k1) | set(k2)):
        a = k1.get(name, {"launches": 0, "bytes": 0, "ops": 0})
        b = k2.get(name, {"launches": 0, "bytes": 0, "ops": 0})
        out[name] = {f: _extrap(a[f], b[f], scale)
                     for f in ("launches", "bytes", "ops")}
        out[name]["launches"] = round(out[name]["launches"])
        out[name]["ops_dtype"] = (k1.get(name) or k2[name])["ops_dtype"]
    return out


def _placed_bytes(specs, mesh) -> int:
    sizes = SH.axis_sizes_of(mesh)
    return sum(SH.placed_bytes(s.shape, s.dtype, s.spec, sizes)
               for s in structs_of(specs))


def run_pair(arch_name: str, shape_name: str, *, multi_pod: bool,
             gcfg: GossipConfig | None = None, algo: str = "asgd",
             engine: str = "pytree", verbose: bool = True,
             full_budget_s: float = 10.0, mesh=None, cfg=None,
             shape=None) -> dict:
    """Trace one (arch, shape, mesh) and return its roofline record.

    ``engine`` ('pytree' | 'packed' | 'pipelined', train shapes only):
    which train step to trace; serve shapes ignore it.  ``mesh``: trace on
    this DeviceMesh (its process group already up) instead of the
    production one in a fake process group of its own; ``cfg`` /
    ``shape``: configs to trace in place of the registry's (a reduced
    smoke pair).  The extrapolation's own values are kept under
    ``"shallow"``."""
    if mesh is None:
        with fake_process_group(512 if multi_pod else 256):
            return run_pair(arch_name, shape_name, multi_pod=multi_pod,
                            gcfg=gcfg, algo=algo, engine=engine,
                            verbose=verbose, full_budget_s=full_budget_s,
                            mesh=make_production_mesh(multi_pod=multi_pod,
                                                      device="cpu"),
                            cfg=cfg, shape=shape)
    cfg = cfg or get_arch(arch_name)
    shape = shape or get_shape(shape_name)
    chips = math.prod(mesh.shape)
    mesh_name = "x".join(map(str, mesh.shape))
    gcfg = gcfg or GossipConfig()
    if shape.kind != "train":
        engine = "pytree"   # serve steps have no gossip engine
    layout = ST.layout_of(shape, engine)

    # shallow traces for the extrapolation
    c = len(cfg.pattern_cycle)
    t1 = time.perf_counter()
    r1 = trace_step(cfg, shape, mesh, gcfg, algo, engine, layers=c)
    r2 = trace_step(cfg, shape, mesh, gcfg, algo, engine, layers=2 * c)
    t_shallow = time.perf_counter() - t1
    scale = cfg.n_layers / c

    shallow = {f: _extrap(r1[f], r2[f], scale)
               for f in ("flops", "bytes", "peak", "arg_bytes",
                         "n_collectives")}
    shallow["kernels"] = _kernel_extrap(_kernel_summary(r1["kernels"]),
                                        _kernel_summary(r2["kernels"]),
                                        scale)
    shallow["collectives"] = {
        op: _extrap(r1["collectives"].get(op, 0),
                    r2["collectives"].get(op, 0), scale)
        for op in sorted(set(r1["collectives"]) | set(r2["collectives"]))}
    flops, aten_bytes, peak = (shallow["flops"], shallow["bytes"],
                               shallow["peak"])
    kernels, arg_bytes = shallow["kernels"], shallow["arg_bytes"]
    traced, n_traced = shallow["collectives"], shallow["n_collectives"]
    extrapolated = True

    # full depth where the shallow traces say it fits the budget
    full, t_full = None, None
    predicted = _extrap(r1["seconds"], r2["seconds"], scale)
    if predicted <= full_budget_s:
        t0 = time.perf_counter()
        full = trace_step(cfg, shape, mesh, gcfg, algo, engine)
        t_full = time.perf_counter() - t0
        flops, aten_bytes, peak = full["flops"], full["bytes"], full["peak"]
        kernels = _kernel_summary(full["kernels"])
        arg_bytes = full["arg_bytes"]
        traced, n_traced = full["collectives"], full["n_collectives"]
        extrapolated = False
    k_bytes, k_seconds = kernel_seconds(
        [{"bytes": k["bytes"], "ops": k["ops"], "ops_dtype": k["ops_dtype"]}
         for k in kernels.values()])

    # the collectives one rank's step sends: planned from the port's own
    # transports (the ring, the rank-order sums, the metrics), and traced
    # where DTensor redistributes
    specs = ST.input_specs(cfg, shape, mesh, gcfg, engine=engine,
                           dtype=TRACE_DTYPE)
    coll = {"total": 0.0, "by_op": {}, "count": 0}
    w_local = local_worker_count(mesh) if shape.kind == "train" else None
    if shape.kind == "train":
        local = rank_args(specs, mesh, layout=layout)
        pspec = None
        if engine != "pytree":
            pspec = dataclasses.replace(
                ST.packed_spec_for(cfg, mesh, gcfg, TRACE_DTYPE),
                n_workers=w_local)
        axes = ("model",) if layout == "tensor_parallel" \
            else gcfg.gate_psum_axes
        psum = math.prod(SH.axis_sizes_of(mesh)[a] for a in axes)
        coll = planned_collectives(
            algo=algo, engine=engine, gcfg=gcfg,
            n_shards=n_worker_groups(mesh), w_local=w_local, spec=pspec,
            params=local["params"] if engine == "pytree" else None,
            psum_ranks=psum, placed=layout == "tensor_parallel")
    by_op = dict(coll["by_op"])
    for op, wire in traced.items():
        by_op[op] = by_op.get(op, 0.0) + wire

    terms = RooflineTerms(
        arch=arch_name, shape=shape_name, mesh=mesh_name, chips=chips,
        hlo_flops=flops, hlo_bytes=aten_bytes + k_bytes,
        collective_bytes=math.fsum(by_op.values()),
        model_flops=model_flops(cfg, shape, chips=chips),
        dtype=str(TRACE_DTYPE).removeprefix("torch."),
        kernel_compute_s=k_seconds)
    rec = terms.as_dict()
    rec.update({
        "algo": algo,
        "engine": engine,
        "layout": layout,
        "ranks": chips,
        "w_local": w_local,
        "aten_bytes": aten_bytes,
        "kernels": kernels,
        "collective_by_op": by_op,
        "collective_op_count": coll["count"] + round(n_traced),
        "collective_planned": coll["by_op"],
        "collective_traced": traced,
        "memory": {
            "argument_bytes": arg_bytes,
            "peak_bytes": peak,
            "extrapolated": extrapolated,
            "placed_bytes": _placed_bytes(specs, mesh),
            "device_bytes": DEVICE_BYTES,
        },
        "fits": peak <= DEVICE_BYTES,
        "trace_full_s": None if t_full is None else round(t_full, 2),
        "trace_shallow_s": round(t_shallow, 2),
        "shallow": shallow,
    })
    if verbose:
        full_txt = "-" if t_full is None else f"{t_full:.1f}s"
        print(f"[dryrun] {arch_name} x {shape_name} x {mesh_name} "
              f"({algo}/{engine}, {layout}): OK full={full_txt} "
              f"shallow={t_shallow:.1f}s dominant={rec['dominant']} "
              f"useful={rec['useful_ratio']:.3f} "
              f"peak={peak / 2 ** 30:.2f}GiB"
              f"{' (extrapolated)' if extrapolated else ''} "
              f"fits={rec['fits']}", flush=True)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default=None, help="single arch id")
    ap.add_argument("--shape", default=None, help="single shape id")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--algo", default="asgd",
                    choices=["asgd", "silent", "sync"])
    ap.add_argument("--engine", default="pytree", choices=list(ST.ENGINES),
                    help="train step to trace; serve shapes ignore this")
    ap.add_argument("--all", action="store_true",
                    help="all assigned (arch x shape) pairs")
    ap.add_argument("--full-budget", type=float, default=10.0,
                    help="trace full depth where the shallow traces "
                         "predict at most this many seconds")
    ap.add_argument("--out", default=None,
                    help="record JSON (default build/dryrun/"
                         "roofline_torch[_MESH][_ENGINE].json)")
    args = ap.parse_args(argv)

    if args.all:
        pairs = [(c.name, s.name) for c, s in assigned_pairs()]
    elif args.arch and args.shape:
        pairs = [(args.arch, args.shape)]
    elif args.arch:
        pairs = [(args.arch, s.name) for c, s in assigned_pairs()
                 if c.name == args.arch]
    else:
        ap.error("need --all or --arch [--shape]")

    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    records, failures = [], []
    t0 = time.perf_counter()
    for arch, shape in pairs:
        for mp in meshes:
            try:
                records.append(run_pair(arch, shape, multi_pod=mp,
                                        algo=args.algo, engine=args.engine,
                                        full_budget_s=args.full_budget))
            except Exception as e:
                traceback.print_exc()
                failures.append({"arch": arch, "shape": shape,
                                 "mesh": "multi" if mp else "single",
                                 "error": repr(e)[:500]})
                print(f"[dryrun] {arch} x {shape} "
                      f"{'multi' if mp else 'single'}: FAILED {e!r}",
                      flush=True)

    out = args.out
    if out is None:
        ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
        base = "roofline_torch" if args.mesh == "single" \
            else f"roofline_torch_{args.mesh}"
        if args.engine != "pytree":
            base += f"_{args.engine}"
        out = ARTIFACT_DIR / f"{base}.json"
    payload = {"records": records, "failures": failures,
               "seconds": time.perf_counter() - t0}
    pathlib.Path(out).write_text(json.dumps(payload, indent=1))
    print(f"[dryrun] wrote {out}: {len(records)} ok, {len(failures)} "
          f"failed in {payload['seconds']:.1f} s", flush=True)
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
