"""One rank of tests/test_torch_tensor_parallel.py's gloo launch: 4 CPU
processes as a (2, 2) ``("data", "model")`` mesh, W = 4 workers, so
W_local = 2 and the ring's shift 1 sends one row of a rank's slice and
shift 2 both.

    python tests/_torch_tp_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

Every rank reads the same inputs (per case: the global (W, ...) weights,
each step's tokens, the frontend's frames or patches, and the (shift,
partition) draws, made by the test from numpy seeds), places the weights
(launch/tensor_parallel.py place_params), runs the port's
tensor-parallel pytree step (make_train_step(mesh=)) on its worker slice
of the batch, and writes to OUT_DIR/rank<RANK>.npz: each step's metrics,
wire bytes and gate sums (with the planted fault's beside them), the
rank's workers, every leaf's placement and local bytes, the sharding
hints that redistributed, the attention calls on each rank's own heads,
whether live= raised, and (rank 0) the
gathered final params; before the cases, DTensor's ``Partial +
Replicate`` on the model mesh (:func:`partial_plus_replicated`).
Imports torch and the port only, so the launch (:func:`start_ranks`)
also runs where jax is absent (tests/_torch_tp_card_check.py).
"""
import dataclasses
import math
import os
import pathlib
import subprocess
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
from repro_torch.models import blocks, common
from repro_torch.models import model as TM

W, BATCH, SEQ, STEPS, EPS = 4, 2, 32, 3, 0.01
MESH = (2, 2)
WORLD = math.prod(MESH)
ARCHS = ("smollm-135m", "qwen2.5-14b", "qwen3-14b", "whisper-tiny",
         "paligemma-3b", "gemma3-1b")
# reduced qwen2.5-14b with 3 heads and 1 KV head: wq/wk/wv/wo take the
# d_model fallback that 40/8 heads take at model 16, and its biases
# replicate.  gemma3-1b the same, the fallback its 4/1 heads take at
# model 16, with both softcaps set (the registered config has none),
# cut to one ('L', 'G') cycle (its reduced (L x 5, G) cycle is 6 layers
# the reference compiles for 20 s); paligemma-3b's 4 heads split over
# model and its 1 KV head falls back; whisper-tiny at 3 heads (its 6 take
# the fallback at model 16) and a vocab of 500 that pads to 512, as its
# 51865 pads to 51968
CUTS = {"qwen2.5-14b": {"n_heads": 3, "n_kv_heads": 1},
        "gemma3-1b": {"n_heads": 3, "n_kv_heads": 1, "attn_softcap": 50.0,
                      "logit_softcap": 30.0, "pattern_cycle": ("L", "G"),
                      "n_layers": 2},
        "whisper-tiny": {"n_heads": 3, "n_kv_heads": 3, "vocab": 500}}
# each frontend's stub input, beside the tokens in a worker's batch
STUB = {"audio": "frames", "vision": "patches"}
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


START_NOISE = 1.0          # each worker's offset, in units of its leaf's std
PERTURBED = ("bq", "bk", "bv")


def weights(cfg, seed):
    """{path key: (W, ...) f32} from numpy: dense leaves N(0, 1/fan_in),
    the embedding N(0, 0.02^2), norm scales and biases N(0, 0.5^2); each
    worker the base plus START_NOISE of its own."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in SH.tree_paths(TM.init_model(cfg, device="meta")):
        shape = tuple(leaf.shape)
        tail = shape[1:] if "scan" in path else shape
        name = path[-1]
        if name == "embed":
            std = 0.02
        elif len(tail) == 1 or name in PERTURBED:
            std = 0.5
        else:
            std = 1.0 / math.sqrt(tail[1] if name == "wo" else tail[0])
        base = std * rng.standard_normal(shape)
        offsets = START_NOISE * std * rng.standard_normal((W,) + shape)
        out[path_key(path)] = (base + offsets).astype(np.float32)
    return out


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


class HeadSplits:
    """Counts the attention calls that ran on each rank's own heads
    (models/common.py ``head_shards`` found a mesh)."""

    def __init__(self):
        self.calls = 0
        self._head_shards = common.head_shards

    def __call__(self, p_attn):
        mesh = self._head_shards(p_attn)
        self.calls += mesh is not None
        return mesh


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
    hints, sums, heads = Hints(), Sums(), HeadSplits()
    blocks.constrain = hints
    common.head_shards = heads
    ops.gossip_gates, G.gossip_blend_worker_batched = sums.gates, sums.blend
    try:
        for t in range(STEPS):
            batch = {"tokens": inp[f"{arch}.tok.{t}"]}
            if cfg.frontend:
                batch[STUB[cfg.frontend]] = inp[f"{arch}.stub.{t}"]
            batch = {k: MM.shard_workers(torch.from_numpy(v), mesh)
                     for k, v in batch.items()}
            si, bi = (int(v) for v in inp[f"{arch}.draw.{t}"])
            before = step.bytes_sent
            params, gossip, _, m = step(params, gossip, 0, batch, si, bi)
            out[f"{arch}.{t}.bytes"] = np.int64(step.bytes_sent - before)
            out[f"{arch}.{t}.terms"] = sums.terms[-1].numpy()
            out[f"{arch}.{t}.doubled"] = sums.doubled[-1].numpy()
            for k, v in m.items():
                out[f"{arch}.{t}.{k}"] = v.numpy()
    finally:
        blocks.constrain = hints._constrain
        common.head_shards = heads._head_shards
        ops.gossip_gates, G.gossip_blend_worker_batched = (sums._gates,
                                                           sums._blend)
    out[f"{arch}.workers"] = MM.shard_workers(torch.arange(W), mesh).numpy()
    out[f"{arch}.hints_moved"] = np.int64(hints.moved)
    out[f"{arch}.head_splits"] = np.int64(heads.calls)
    for path, x in SH.tree_paths(params):
        key = f"{arch}.leaf.{path_key(path)}"
        local = x.to_local()
        out[f"{key}.placement"] = np.array(placement_name(x.placements))
        out[f"{key}.bytes"] = np.int64(local.numel() * local.element_size())
    try:
        step(params, gossip, 0, batch, 0, 0,
             live=torch.ones(MM.local_worker_count(mesh, W)))
        out[f"{arch}.live_raises"] = np.int64(0)
    except NotImplementedError:
        out[f"{arch}.live_raises"] = np.int64(1)
    final = TP.gather_params(mesh, params)
    if rank == 0:
        for path, x in SH.tree_paths(final):
            out[f"{arch}.final.{path_key(path)}"] = x


def partial_plus_replicated(mesh, out):
    """DTensor's rule for ``Partial + Replicate`` (a bias or the residual
    added to the output of a contraction over a sharded dim): y = p + b,
    p ``Partial`` with the model rank's part r + 1, b a replicated leaf of
    10s; y's value, and b's gradient of y's sum, redistributed to b's
    placements as the step redistributes a leaf's gradient."""
    from torch.distributed.tensor import (DTensor, Partial, Replicate,
                                          distribute_tensor)
    mm = TP.model_mesh(mesh)
    part = torch.full((3,), float(mm.get_local_rank() + 1))
    p = DTensor.from_local(part, mm, (Partial(),))
    b = distribute_tensor(torch.full((3,), 10.0), mm, (Replicate(),))
    b.requires_grad_(True)
    y = p + b
    (g,) = torch.autograd.grad(y.sum(), [b])
    out["probe.y"] = y.full_tensor().detach().numpy()
    out["probe.grad"] = g.redistribute(mm, b.placements).to_local().numpy()


def start_ranks(out_dir, inputs):
    """Writes ``inputs`` to OUT_DIR/inputs.npz and starts the WORLD ranks
    of this program on them (loopback only, one thread and no GPU a
    rank), each logging to OUT_DIR/rank<RANK>.log.  Returns (procs,
    logs)."""
    out_dir = pathlib.Path(out_dir)
    np.savez(out_dir / "inputs.npz", **inputs)
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = {**os.environ, "PYTHONPATH": str(src), "OMP_NUM_THREADS": "1",
           "GLOO_SOCKET_IFNAME": "lo", "CUDA_VISIBLE_DEVICES": ""}
    logs = [open(out_dir / f"rank{r}.log", "w") for r in range(WORLD)]
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(WORLD),
         str(out_dir / "store"), str(out_dir / "inputs.npz"), str(out_dir)],
        env=env, stdout=logs[r], stderr=subprocess.STDOUT)
        for r in range(WORLD)]
    return procs, logs


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        inp = dict(np.load(inputs))
        mesh = MM.make_host_mesh(*MESH, device="cpu")
        out = {}
        partial_plus_replicated(mesh, out)
        for arch in ARCHS:
            run_case(mesh, inp, out, rank, arch)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
