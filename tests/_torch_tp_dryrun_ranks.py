"""One rank of tests/test_torch_dryrun_tp.py's gloo launch: 4 CPU
processes as a (2, 2) ``("data", "model")`` mesh, each tracing its own
rank of the dry-run's tensor-parallel steps (launch/dryrun.py
``trace_step``) on real CPU tensors under the dry-run's counters.

    python tests/_torch_tp_dryrun_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

The cases (:data:`CASES`) are reduced configs at small shapes; every
rank fills its arguments from one seed (:func:`filler`), so the
replicas of a replicated leaf agree across ``model``.  Each rank writes
OUT_DIR/rank<RANK>.npz: each case's FLOPs, aten bytes, live-bytes peak,
argument bytes, the modeled kernel calls' names and operations, and
the traced collectives.  Imports torch and the port only.
"""
import json
import math
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import GossipConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as MM

MESH = (2, 2)
WORLD = math.prod(MESH)
WORKERS = 2                # W_local = 1 on each data coordinate
TRAIN = ShapeConfig("train_small", 16, 4, "train")
PREFILL = ShapeConfig("prefill_small", 16, 2, "prefill")
DECODE = ShapeConfig("decode_small", 32, 2, "decode")
GCFG = GossipConfig(shifts=(1,), partial_blocks=2)
# (id, arch, shape, algo, ASGDConfig.use_fused)
CASES = (("smollm-fused", "smollm-135m", TRAIN, "asgd", True),
         ("smollm-plain", "smollm-135m", TRAIN, "asgd", False),
         ("smollm-sync", "smollm-135m", TRAIN, "sync", False),
         ("mamba2-train", "mamba2-370m", TRAIN, "asgd", False),
         ("mamba2-prefill", "mamba2-370m", PREFILL, "asgd", False),
         ("granite-train", "granite-moe-1b-a400m", TRAIN, "asgd", False),
         ("granite-decode", "granite-moe-1b-a400m", DECODE, "asgd", False),
         ("whisper-prefill", "whisper-tiny", PREFILL, "asgd", False))
EPS = 0.01


def filler(vocab, seed=0):
    """Writes seeded values into a step's arguments (a DTensor's local
    shard): params and batch floats N(0, 0.02^2), token ids in [0,
    vocab), gossip state and caches zero (their initial values)."""
    def fill(args):
        g = torch.Generator().manual_seed(seed)
        for k, v in args.items():
            for t in D.arg_tensors(v):
                if k in ("gossip", "cache"):
                    t.zero_()
                elif t.is_floating_point():
                    t.normal_(0, 0.02, generator=g)
                else:
                    t.random_(0, vocab, generator=g)
    return fill


def trace(case, mesh, device="meta"):
    """The counts of one case's trace on ``mesh``: on meta, or on real
    ``device`` tensors filled by :func:`filler`."""
    _, arch, shape, algo, fused = case
    cfg = get_arch(arch).reduced()
    kw = dict(workers=WORKERS, algo=algo,
              acfg=ASGDConfig(eps=EPS, use_fused=fused))
    if device != "meta":
        kw.update(device=device, fill=filler(cfg.vocab))
    r = D.trace_step(cfg, shape, mesh, GCFG, **kw)
    ops: dict = {}
    for k in r["kernels"]:
        ops[k["name"]] = ops.get(k["name"], 0) + k["ops"]
    return {"flops": r["flops"], "bytes": r["bytes"], "peak": r["peak"],
            "arg_bytes": r["arg_bytes"],
            "kernels": [k["name"] for k in r["kernels"]],
            "kernel_ops": ops, "collectives": r["collectives"],
            "n_collectives": r["n_collectives"]}


def main(argv):
    rank, world, store, _, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        mesh = MM.make_host_mesh(*MESH, device="cpu")
        out = {c[0]: np.array(json.dumps(trace(c, mesh, "cpu")))
               for c in CASES}
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
