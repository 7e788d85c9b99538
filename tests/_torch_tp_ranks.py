"""One rank of tests/test_torch_tensor_parallel.py's gloo launch: 4 CPU
processes as a (2, 2) ``("data", "model")`` mesh, W = 4 workers, so
W_local = 2 and the ring's shift 1 sends one row of a rank's slice and
shift 2 both.

    python tests/_torch_tp_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

Every rank reads the same inputs (per case: the global (W, ...) weights,
each step's tokens and (shift, partition) draws, made by the test from
numpy seeds), places the weights (launch/tensor_parallel.py place_params),
runs the port's tensor-parallel pytree step (make_train_step(mesh=)) on
its worker slice, and writes to OUT_DIR/rank<RANK>.npz: each step's
metrics, wire bytes and gate sums (with the planted fault's beside them),
the rank's workers, every leaf's placement and local bytes, the sharding
hints that redistributed, whether live= raised, and (rank 0) the
gathered final params.  Imports torch and the port only.
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core import gossip as G
from repro_torch.core.gossip import GossipConfig, init_gossip_state
from repro_torch.kernels.gossip_blend import ops
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step
from repro_torch.models import blocks

W, BATCH, SEQ, STEPS, EPS = 4, 2, 32, 3, 0.01
MESH = (2, 2)
ARCHS = ("smollm-135m", "qwen2.5-14b", "qwen3-14b")
# reduced qwen2.5-14b with 3 heads and 1 KV head: wq/wk/wv/wo take the
# d_model fallback that 40/8 heads take at model 16, and its biases
# replicate
CUTS = {"qwen2.5-14b": {"n_heads": 3, "n_kv_heads": 1}}
# the bf16 wire on qwen2.5, the carrier wire on the others
WIRE = {"qwen2.5-14b": "dtype"}


def config(arch, registry_get_arch):
    """The case's reduced config from either package's registry."""
    return dataclasses.replace(registry_get_arch(arch).reduced(),
                               **CUTS.get(arch, {}))


def gossip_kw(arch, bf16):
    """GossipConfig keywords of a case; ``bf16`` the package's bfloat16."""
    kw = dict(shifts=(1, 2), partial_blocks=4, delay=1)
    if WIRE.get(arch) == "dtype":
        kw.update(wire_format="dtype", payload_dtype=bf16)
    return kw


def path_key(path):
    return "/".join(path)


def nest(flat):
    """{"a/b": x} -> {"a": {"b": x}}."""
    out = {}
    for k, v in flat.items():
        *head, last = k.split("/")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[last] = v
    return out


def placement_name(placements) -> str:
    (p,) = placements
    return f"S{p.dim}" if hasattr(p, "dim") else "R"


class Hints:
    """Counts the models/blocks.py hints that redistributed a DTensor."""

    def __init__(self):
        self.moved = 0
        self._constrain = blocks.constrain

    def __call__(self, x, *spec):
        y = self._constrain(x, *spec)
        if y is not x and y.placements != x.placements:
            self.moved += 1
        return y


class Sums:
    """Each round's (W_local, 1, 3) gate sums as the step takes them
    (``gossip_gates``'s argument: B2r's partials summed over ``model``),
    and beside them the planted fault: B2r under the round's group mask on
    every ``model`` rank, summed the same way, which counts a replicated
    leaf once per ``model`` rank."""

    def __init__(self):
        self.terms, self.doubled = [], []
        self._gates = ops.gossip_gates
        self._blend = G.gossip_blend_worker_batched

    def gates(self, acc, *args, **kw):
        self.terms.append(acc.clone())
        return self._gates(acc, *args, **kw)

    def blend(self, w3, d3, e4, eps, *, mask2d=None, psum_axes=None,
              mesh=None, **kw):
        self.doubled.append(MM.psum_rank_order(
            ops.gossip_reduce_w(w3, d3, e4, mask2d), mesh, psum_axes))
        return self._blend(w3, d3, e4, eps, mask2d=mask2d,
                           psum_axes=psum_axes, mesh=mesh, **kw)


def run_case(mesh, inp, out, rank, arch):
    cfg = config(arch, get_arch)
    gcfg = GossipConfig(**gossip_kw(arch, torch.bfloat16))
    acfg = ASGDConfig(eps=EPS, use_fused=True)
    head = f"{arch}.w."
    weights = nest({k[len(head):]: inp[k] for k in inp if k.startswith(head)})
    params = TP.place_params(mesh, params_from_numpy(weights))
    gossip = init_gossip_state(params, gcfg)
    step = make_train_step(cfg, gcfg=gcfg, acfg=acfg, mesh=mesh)
    hints, sums = Hints(), Sums()
    blocks.constrain = hints
    ops.gossip_gates, G.gossip_blend_worker_batched = sums.gates, sums.blend
    try:
        for t in range(STEPS):
            tokens = MM.shard_workers(torch.from_numpy(inp[f"{arch}.tok.{t}"]),
                                      mesh)
            si, bi = (int(v) for v in inp[f"{arch}.draw.{t}"])
            before = step.bytes_sent
            params, gossip, _, m = step(params, gossip, 0,
                                        {"tokens": tokens}, si, bi)
            out[f"{arch}.{t}.bytes"] = np.int64(step.bytes_sent - before)
            out[f"{arch}.{t}.terms"] = sums.terms[-1].numpy()
            out[f"{arch}.{t}.doubled"] = sums.doubled[-1].numpy()
            for k, v in m.items():
                out[f"{arch}.{t}.{k}"] = v.numpy()
    finally:
        blocks.constrain = hints._constrain
        ops.gossip_gates, G.gossip_blend_worker_batched = (sums._gates,
                                                           sums._blend)
    out[f"{arch}.workers"] = MM.shard_workers(torch.arange(W), mesh).numpy()
    out[f"{arch}.hints_moved"] = np.int64(hints.moved)
    for path, x in SH.tree_paths(params):
        key = f"{arch}.leaf.{path_key(path)}"
        local = x.to_local()
        out[f"{key}.placement"] = np.array(placement_name(x.placements))
        out[f"{key}.bytes"] = np.int64(local.numel() * local.element_size())
    try:
        step(params, gossip, 0, {"tokens": tokens}, 0, 0,
             live=torch.ones(MM.local_worker_count(mesh, W)))
        out[f"{arch}.live_raises"] = np.int64(0)
    except NotImplementedError:
        out[f"{arch}.live_raises"] = np.int64(1)
    final = TP.gather_params(mesh, params)
    if rank == 0:
        for path, x in SH.tree_paths(final):
            out[f"{arch}.final.{path_key(path)}"] = x


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        inp = dict(np.load(inputs))
        mesh = MM.make_host_mesh(*MESH, device="cpu")
        out = {}
        for arch in ARCHS:
            run_case(mesh, inp, out, rank, arch)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
