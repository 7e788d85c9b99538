"""One rank of tests/test_torch_tensor_parallel_moe.py's gloo launch: 4 CPU
processes as a (2, 2) ``("data", "model")`` mesh, MoE configs trained and
served expert-parallel over ``model`` (models/moe.py ``_apply_placed``).

    python tests/_torch_tp_moe_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

Every rank reads the same inputs (per case: the weights, each step's
tokens and draws, the prompts; made by the test from numpy seeds and the
reference's initialisation).  Training (:data:`TRAIN`): W = 4 workers
(W_local 2), seq 32, the weights placed by ``place_params``, then the
first batch's gradient tree (``TensorParallelStep.loss_and_grad``) and
STEPS pytree steps of ``make_train_step(mesh=)``; written: each step's
metrics, the gradients and final params gathered whole (rank 0), every
leaf's and gradient's placement and local bytes, and every placed MoE
call's routing (:class:`Routing`).  Serving (:data:`SERVE`):
``_torch_tp_serve_ranks.py``'s ``serve_case`` (generate(mesh=), each
step's logits and placed cache, the decode steps' collectives), every
serve param's placement, and every placed MoE call's input and routing.
Imports torch and the port only (tests/_torch_tp_card_check.py runs it
where jax is absent).
"""
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_tp_ranks as R
import _torch_tp_serve_ranks as S
import _torch_tp_ssm_ranks as T
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import GossipConfig, init_gossip_state
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step
from repro_torch.models import moe

# case: (arch, cuts, batch).  Reduced granite-moe-1b-a400m and
# phi3.5-moe-42b-a6.6b: 4 experts top-2, 16 dispatch groups, split 2 a
# rank over model 2; granite-aux1 at router_aux_weight 1.0, where a
# gradient of the aux loss counted twice cannot hide; granite-e3 at 3
# experts, which model 2 does not divide (gate/up shard d_ff, down
# d_model: every rank runs every expert)
TRAIN = {"granite-moe": ("granite-moe-1b-a400m", {}, 2),
         "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}, 2),
         "granite-aux1": ("granite-moe-1b-a400m", {"router_aux_weight": 1.0},
                          2),
         "granite-e3": ("granite-moe-1b-a400m", {"n_experts": 3}, 2)}
# case: (arch, cuts, batch, prompt), the batch split over data 2.  At
# prompt 16 a data slice holds 8 of the 16 global groups of 2 tokens
# (C 1): it runs them locally, where the naive slice would form 16 groups
# of one token.  granite-routing: granite's 32 experts top-8 at narrow
# widths, batch 4, prompt 17: 68 tokens do not divide into 16 groups, so
# the prefill is one group over both slices and, as every decode step
# (C 2 at batch 4: it drops pairs), takes the exclusive scan over data.
# granite-g3: 3 dispatch groups of 12 tokens at batch 2, prompt 18 —
# each slice's 18 tokens are chunks of 6, a group straddling the slices
SERVE = {"granite-moe": ("granite-moe-1b-a400m", {}, 2, 16),
         "phi3.5-moe": ("phi3.5-moe-42b-a6.6b", {}, 2, 16),
         "granite-routing": ("granite-moe-1b-a400m",
                             {"n_experts": 32, "experts_per_token": 8,
                              "d_ff": 64}, 4, 17),
         "granite-e3": ("granite-moe-1b-a400m", {"n_experts": 3}, 2, 16),
         "granite-g3": ("granite-moe-1b-a400m", {"moe_dispatch_groups": 3},
                        2, 18)}


class Routing:
    """Records every placed MoE call (models/moe.py ``_apply_placed``)
    while installed: its input (the rank's rows, whole over ``model``),
    and the (slot, keep) tables :func:`capacity_slots` gave it, the slots
    in the global numbering."""

    def __init__(self):
        self.inputs, self.slots, self.keeps = [], [], []
        self._placed, self._slots = moe._apply_placed, moe.capacity_slots
        self._inside = False

    def placed(self, params, x, *args, **kw):
        self.inputs.append(x.full_tensor().detach().numpy().copy())
        self._inside = True
        try:
            return self._placed(params, x, *args, **kw)
        finally:
            self._inside = False

    def capacity_slots(self, *args, **kw):
        slot, keep = self._slots(*args, **kw)
        if self._inside:
            self.slots.append(slot.numpy().copy())
            self.keeps.append(keep.numpy().copy())
        return slot, keep

    def write(self, out, key):
        for what in ("inputs", "slots", "keeps"):
            for i, v in enumerate(getattr(self, what)):
                out[f"{key}.{what}.{i}"] = v
        out[f"{key}.calls"] = np.int64(len(self.inputs))

    def __enter__(self):
        moe._apply_placed, moe.capacity_slots = self.placed, \
            self.capacity_slots
        return self

    def __exit__(self, *exc):
        moe._apply_placed, moe.capacity_slots = self._placed, self._slots


def config(arch, cuts, registry_get_arch):
    return T.config(arch, cuts, registry_get_arch)


def run_train(mesh, inp, out, rank, name):
    arch, cuts, _ = TRAIN[name]
    cfg = config(arch, cuts, get_arch)
    gcfg = GossipConfig(**T.gossip_kw())
    head = f"train.{name}."
    weights = R.nest({k[len(head) + 2:]: inp[k] for k in inp
                      if k.startswith(head + "w.")})
    params = TP.place_params(mesh, params_from_numpy(weights))
    gossip = init_gossip_state(params, gcfg)
    step = make_train_step(cfg, gcfg=gcfg,
                           acfg=ASGDConfig(eps=R.EPS, use_fused=True),
                           mesh=mesh)

    def batch(t):
        return {"tokens": MM.shard_workers(
            torch.from_numpy(inp[f"{head}tok.{t}"]), mesh)}
    moe.reset_placed_calls()
    with Routing() as routing:
        _, grads = step.loss_and_grad(params, batch(0))
    routing.write(out, f"{head}route")
    T.record_tree(out, f"{head}grad", grads)
    grads = TP.gather_params(mesh, grads)
    for t in range(T.STEPS):
        si, bi = (int(v) for v in inp[f"{head}draw.{t}"])
        params, gossip, _, m = step(params, gossip, 0, batch(t), si, bi)
        for k, v in m.items():
            out[f"{head}{t}.{k}"] = v.numpy()
    out[f"{head}placed_calls"] = np.int64(moe.placed_calls())
    T.record_tree(out, f"{head}leaf", params)
    final = TP.gather_params(mesh, params)
    if rank == 0:
        for what, tree in (("grads", grads), ("final", final)):
            for path, x in SH.tree_paths(tree):
                out[f"{head}{what}.{R.path_key(path)}"] = x


def run_serve(mesh, inp, out, name):
    arch, cuts, rows, prompt = SERVE[name]
    cfg = config(arch, cuts, get_arch)
    head = f"{name}.w."
    plain = params_from_numpy(R.nest(
        {k[len(head):]: inp[k] for k in inp if k.startswith(head)}))
    T.record_tree(out, f"{name}.param", TP.place_serve_params(mesh, plain))
    moe.reset_placed_calls()
    with Routing() as routing:
        S.serve_case(mesh, inp, out, name, cfg, rows, prompt)
    routing.write(out, f"{name}.route")
    out[f"{name}.placed_calls"] = np.int64(moe.placed_calls())


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        inp = dict(np.load(inputs))
        mesh = MM.make_host_mesh(*R.MESH, device="cpu")
        out = {}
        for name in TRAIN:
            if f"train.{name}.tok.0" in inp:
                run_train(mesh, inp, out, rank, name)
        for name in SERVE:
            if f"{name}.tokens" in inp:
                run_serve(mesh, inp, out, name)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
