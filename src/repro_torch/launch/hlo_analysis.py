"""Roofline terms of a dry-run record on an NVIDIA H100.

The port compiles no HLO.  What stands in for each of the reference's
terms (``launch/dryrun.py`` measures them on a meta-device trace of the
step one rank runs):

compute term    = aten FLOPs / peak of the traced dtype
                  + each modeled kernel's operations / its peak
memory term     = bytes / HBM bandwidth
collective term = bytes one rank sends / NVLink bandwidth (one direction)

* aten FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the
  step's aten ops (the matmuls; elementwise ops count none, as XLA's
  cost analysis counts them lightly) — the counterpart of
  ``cost_analysis()["flops"]``;
* bytes: every aten op's inputs read once and outputs written once,
  unfused — an upper bound, not XLA's post-fusion "bytes accessed" —
  plus the modeled bytes of each hand-written kernel's launch (its bound's
  bytes, PERF.md §6);
* collective bytes: traced where DTensor redistributes (the
  ``_c10d_functional`` ops the trace reaches, under the reference's op
  names by :data:`TRACED_COLLECTIVES`, the buffer their output), and
  planned (:func:`planned_collectives`) where the port's own transports
  send (``launch/mesh.py``, which on meta tensors send nothing): the
  partition's rows a ring send moves, the gate terms a psum gathers, the
  sync baseline's sum, the metrics gathered over the worker group — the
  counterpart of parsing the HLO's collectives.  A test holds the plan to
  the bytes a real gloo run of the regions counts.

The constants are the card's (NVIDIA H100 80GB HBM3, 700 W, as
``nvidia-smi --query-gpu=name,power.limit`` gives them; dense rates from
NVIDIA's data sheet).  The port trains and serves in f32 with TF32 off
(``repro_torch.set_full_fp32_precision``), so a step's aten FLOPs run at
the f32 rate; the split-TF32 kernels (B5, B5b) count three TF32 products
for each of theirs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

# NVIDIA H100 80GB HBM3, 700 W
PEAK_FLOPS = {"float32": 67e12,     # f32 outside the tensor cores
              "tf32": 495e12}       # TF32 on the tensor cores, dense
HBM_BW = 3.35e12                    # bytes/s
NVLINK_BW = 450e9                   # bytes/s, one direction

# wire bytes one rank sends, as a multiple of the op's buffer (the
# reference's factors; the buffer is the op's output, as the reference
# reads it from the HLO)
_WIRE_FACTOR = {
    "ppermute": 1.0,        # the partition's rows, once
    "psum": 1.0,            # rank-order sum: an all_gather, (n - 1) buffers
    "all-reduce": 2.0,      # ring: reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
}

# the collectives a trace reaches (DTensor's redistributions:
# ``_c10d_functional`` ops, and ``_dtensor``'s all-to-all on a CUDA mesh)
# under the reference's HLO op names
TRACED_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",     # _dtensor's, on CUDA meshes
}


def traced_collective(op_name: str, out_bytes: int):
    """(reference op name, wire bytes one rank sends) of a traced
    collective op (:data:`TRACED_COLLECTIVES`) whose outputs hold
    ``out_bytes``; None for any other op (``wait_tensor``, the async
    wrappers)."""
    name = TRACED_COLLECTIVES.get(op_name)
    if name is None:
        return None
    return name, _WIRE_FACTOR[name] * out_bytes


@dataclass
class RooflineTerms:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    model_flops: float
    dtype: str = "float32"              # the dtype the step computes in
    kernel_compute_s: float = 0.0       # the modeled kernels' operations

    @property
    def compute_s(self) -> float:
        # one rank's program: hlo_flops is already per device
        return self.hlo_flops / PEAK_FLOPS[self.dtype] + self.kernel_compute_s

    @property
    def memory_s(self) -> float:
        return self.hlo_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        # collective_bytes is what one rank sends
        return self.collective_bytes / NVLINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def useful_ratio(self) -> float:
        if self.hlo_flops <= 0:
            return 0.0
        return self.model_flops / self.hlo_flops

    def as_dict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops, "dtype": self.dtype,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant, "useful_ratio": self.useful_ratio,
        }


def kernel_seconds(kernels) -> tuple[float, float]:
    """(bytes, compute seconds) of modeled kernel calls (dicts with
    ``bytes``, ``ops`` and ``ops_dtype``, kernels.record_modeled)."""
    return (sum(k["bytes"] for k in kernels),
            sum(k["ops"] / PEAK_FLOPS[k["ops_dtype"]] for k in kernels))


def model_flops(cfg, shape, chips: int = 1) -> float:
    """MODEL_FLOPS = 6*N*D tokens for train, 2*N*D for forward-only
    (N = active params, D = tokens processed this step). Divided by `chips`
    to compare against per-device HLO flops."""
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens / chips
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens / chips
    tokens = shape.global_batch  # decode: ONE token per sequence
    return 2.0 * n_active * tokens / chips


# ---------------------------------------------------------------------------
# collective bytes, planned from the regions' row plan
# ---------------------------------------------------------------------------

def moved_rows(shift: int, n_shards: int, w_local: int) -> int:
    """Worker rows of its ``w_local`` slice that one rank sends for a ring
    roll by ``shift`` over ``n_shards`` ranks (``launch/mesh.py
    _roll_workers_manual``: shift = q·w_local + r sends w_local − r rows q
    shards forward and r rows q + 1 shards forward; a send 0 shards
    forward stays local)."""
    q, r = divmod(shift % (n_shards * w_local), w_local)
    if r == 0:
        return w_local * (q % n_shards != 0)
    return (w_local - r) * (q % n_shards != 0) + r * ((q + 1) % n_shards
                                                      != 0)


def _wire_row_bytes(spec, gcfg, r0: int, r1: int) -> int:
    """Bytes one worker's partition rows [r0, r1) take on the wire: int8
    plus one f32 scale per block_rows, or f32 (a "dtype" wire round-trips
    before the send, so f32 travels)."""
    from ..core.gossip import resolved_wire_format
    from ..kernels import LANE
    rows = r1 - r0
    if resolved_wire_format(gcfg) == "int8":
        return rows * LANE + rows // spec.block_rows * 4
    return rows * LANE * 4


def ppermute_bytes(spec, gcfg, n_shards: int, w_local: int, shift_idx: int,
                   block_idx: int, *, elastic: bool = False) -> int:
    """Bytes one rank sends in one exchange of the packed regions: the
    partition's rows of each worker row it moves (and its f32 liveness
    entry when elastic) — what ``launch/mesh.py _ppermute`` tallies."""
    from ..core.gossip import packed_row_ranges
    r0, r1 = packed_row_ranges(spec, gcfg)[block_idx]
    per = _wire_row_bytes(spec, gcfg, r0, r1) + (4 if elastic else 0)
    return moved_rows(gcfg.shifts[shift_idx], n_shards, w_local) * per


def _local(x):
    """A DTensor's local shard; a plain tensor itself."""
    return x.to_local() if hasattr(x, "to_local") else x


def _leaves_bytes(params, gcfg, block_idx: int, w_local: int,
                  placed: bool = False) -> int:
    """One worker's bytes of the pytree engine's exchange
    (``core.gossip exchange_leaves``: the leaves of group ``block_idx`` in
    their dtype; 'rows' mode: every leaf's 1/p block): of a placed tree,
    the rank's shards of the groups its leaves' global shapes give ('rows'
    mode: each leaf's part of the block, ``launch/tensor_parallel.py
    _rows_range``), on the placed step's int8 wire one byte an element
    and one f32 scale a sent leaf."""
    from ..core.gossip import _block_size, leaf_groups, resolved_wire_format
    from ..core.tree import flatten_sorted
    leaves = flatten_sorted(params)[0]
    p = gcfg.partial_blocks
    if gcfg.partial_mode == "rows":
        from .tensor_parallel import _rows_range
        sent = []
        for x in leaves:
            n = _local(x).numel()
            if x.ndim >= 2:
                lo, hi = (_rows_range(x, block_idx, p) if placed else
                          (0, _block_size(x.shape[1], p)))
                n = n // max(_local(x).shape[1], 1) * (hi - lo)
            sent.append((x, n))
    else:
        groups = flatten_sorted(leaf_groups(params, p))[0]
        sent = [(x, _local(x).numel())
                for x, g in zip(leaves, groups) if g == block_idx]
    if placed and resolved_wire_format(gcfg) == "int8":
        return sum(n for _, n in sent) // w_local + 4 * len(sent)
    return sum(n * x.element_size() for x, n in sent) // w_local


def _absmax_bytes(params, gcfg, block_idx: int, w_local: int) -> int:
    """The placed int8 wire's absmax max over ``model``: (W_local, n_sent)
    f32 where a sent leaf is sharded (``launch/tensor_parallel.py
    _int8_payload``), else nothing."""
    from ..core.gossip import leaf_groups
    from ..core.tree import flatten_sorted
    from .tensor_parallel import _replicated
    leaves = flatten_sorted(params)[0]
    if gcfg.partial_mode == "rows":
        sent = leaves
    else:
        groups = flatten_sorted(leaf_groups(params, gcfg.partial_blocks))[0]
        sent = [x for x, g in zip(leaves, groups) if g == block_idx]
    if all(_replicated(x) for x in sent):
        return 0
    return w_local * len(sent) * 4


def planned_collectives(*, algo: str, engine: str, gcfg, n_shards: int,
                        w_local: int, spec=None, params=None,
                        psum_ranks: int = 1, placed: bool = False) -> dict:
    """Bytes one rank sends in one train step under the port's regions,
    by op, the draws' mean over every (shift, partition) pair (each is
    drawn uniformly).  ``spec``: the packed engines' WPackSpec; ``params``:
    one rank's (W_local, ...) tree for the pytree engine and 'sync';
    ``psum_ranks``: ranks of ``gcfg.gate_psum_axes`` (1: no psum).
    ``placed``: the tensor-parallel step (``launch/tensor_parallel.py``):
    ``params`` DTensor leaves whose shards travel, the gate terms summed
    over ``psum_ranks`` (``model``) ranks, 'sync' a rank-order sum of one
    worker's shards over the worker group, and the step's metrics — the
    losses and, for 'asgd', the gates, (W_local,) f32 each — gathered
    over it; under the int8 wire the ring send's codes and scales, and
    the scales' absmaxes' max over ``model``.  Returns {"total", "by_op",
    "count"} as the reference's parse does."""
    from ..core.gossip import resolved_wire_format
    by_op: dict = {}
    count = 0
    if algo == "sync":
        if spec is not None:
            from ..kernels import LANE
            grad = w_local * spec.rows * LANE * 4
        else:
            from ..core.tree import tree_leaves
            grad = sum(_local(x).numel() * x.element_size()
                       for x in tree_leaves(params))
        if n_shards > 1 and placed:
            by_op["psum"] = _WIRE_FACTOR["psum"] * (n_shards - 1) * (
                grad // w_local)
            count = 1
        elif n_shards > 1:
            by_op["all-reduce"] = _WIRE_FACTOR["all-reduce"] * grad
            count = 1
    elif algo == "asgd":
        pairs = [(s, b) for s in range(len(gcfg.shifts))
                 for b in range(gcfg.partial_blocks)]
        if engine == "pytree":
            sent = [moved_rows(gcfg.shifts[s], n_shards, w_local)
                    * _leaves_bytes(params, gcfg, b, w_local, placed)
                    for s, b in pairs]
            if placed and psum_ranks > 1 and \
                    resolved_wire_format(gcfg) == "int8":
                absmax = sum(_absmax_bytes(params, gcfg, b, w_local)
                             for _, b in pairs)
                if absmax:
                    by_op["all-reduce"] = (_WIRE_FACTOR["all-reduce"]
                                           * absmax / len(pairs))
                    count += 1
        else:
            sent = [ppermute_bytes(spec, gcfg, n_shards, w_local, s, b)
                    for s, b in pairs]
        by_op["ppermute"] = _WIRE_FACTOR["ppermute"] * sum(sent) / len(pairs)
        count = 1
        if psum_ranks > 1 and (engine != "pytree" or placed):
            gates = w_local * 3 * 4               # (W_local, 1, 3) f32
            by_op["psum"] = _WIRE_FACTOR["psum"] * (psum_ranks - 1) * gates
            count += 1
    elif algo != "silent":
        raise ValueError(f"unknown algo {algo!r}")
    if placed and n_shards > 1:
        metrics = (2 if algo == "asgd" else 1) * w_local * 4
        by_op["all-gather"] = (_WIRE_FACTOR["all-gather"] * (n_shards - 1)
                               * metrics)
        count += 1
    return {"total": math.fsum(by_op.values()), "by_op": by_op,
            "count": count}
