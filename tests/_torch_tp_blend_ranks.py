"""One rank of tests/test_torch_tensor_parallel_blend.py's gloo launch: 4
CPU processes as a (2, 2) ``("data", "model")`` mesh, W = 4 workers
(W_local = 2), running the tensor-parallel pytree step
(make_train_step(mesh=)) of reduced smollm-135m under the step options
the dry-run's step takes (:data:`CASES`): the plain blend
(``ASGDConfig(use_fused=False)``), algos 'sync' and 'silent', and
``ASGDConfig(silent=True)``.

    python tests/_torch_tp_blend_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

The inputs are tests/_torch_tp_ranks.py's (the global weights, each
step's tokens and draws, made by the test from numpy seeds and
``jax.random`` keys).  Each rank writes OUT_DIR/rank<RANK>.npz: each
step's metrics; under the plain blend each round's (W_local, 3) eq.-4
sums as the step sums them over ``model`` (a replicated leaf's terms on
``model`` rank 0 only) and beside them the planted fault's (a replicated
leaf's terms on every ``model`` rank); the rank's workers, the round
counter after the steps, whether live= held (:func:`live_check`), and
(rank 0) the gathered final params.  Imports torch and the port only.
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import GossipConfig, init_gossip_state
from repro_torch.core.tree import flatten_sorted
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step

import _torch_tp_ranks as R

ARCH = "smollm-135m"
# case -> (algo, ASGDConfig keywords)
CASES = {"plain": ("asgd", {}),
         "silent-flag": ("asgd", {"silent": True}),
         "sync": ("sync", {}),
         "silent": ("silent", {})}


class PlainSums:
    """Each plain-blend round's eq.-4 sums as the step takes them, and the
    planted fault's: the same sums with every leaf of the round's group
    counted on every ``model`` rank."""

    def __init__(self):
        self.terms, self.doubled = [], []
        self._blend = TP._plain_blend

    def __call__(self, local, grads, ext, gids, reduce_gids, ext_idx,
                 gate_scale, acfg, mesh):
        for out, groups in ((self.terms, reduce_gids), (self.doubled, gids)):
            out.append(MM.psum_rank_order(torch.stack(
                TP._per_worker_reduce3(local, grads, ext, groups, ext_idx),
                dim=-1), mesh, ("model",)))
        return self._blend(local, grads, ext, gids, reduce_gids, ext_idx,
                           gate_scale, acfg, mesh)


def live_check(step, algo, params, gossip, batch):
    """live=: under algo 'asgd' one more step with live = ones on an
    elastic copy of the state (its buffered payload alive) is bitwise the
    step without it, gates and buffer too; under sync and silent live=
    raises ValueError, as the single-device step's check_live."""
    live = torch.ones(gossip.buf_live.shape if gossip.buf_live is not None
                      else flatten_sorted(params)[0][0].to_local().shape[:1])
    if algo != "asgd":
        try:
            step(params, gossip, 0, batch, 0, 0, live=live)
        except ValueError:
            return True
        return False
    want = step(params, gossip, 0, batch, 0, 0)
    got = step(params, dataclasses.replace(gossip, buf_live=live), 0, batch,
               0, 0, live=live)
    same = [torch.equal(a.to_local(), b.to_local()) for a, b in zip(
        *(flatten_sorted({"p": o[0], "b": o[1].buf})[0]
          for o in (got, want)))]
    return (all(same) and torch.equal(got[3]["gate"], want[3]["gate"])
            and torch.equal(got[1].buf_live, live))


def run_case(mesh, inp, out, rank, case):
    algo, acfg_kw = CASES[case]
    cfg = R.config(ARCH, get_arch)
    gcfg = GossipConfig(**R.gossip_kw(ARCH, torch.bfloat16))
    acfg = ASGDConfig(eps=R.EPS, use_fused=False, **acfg_kw)
    head = f"{ARCH}.w."
    weights = R.nest({k[len(head):]: inp[k] for k in inp
                      if k.startswith(head)})
    params = TP.place_params(mesh, params_from_numpy(weights))
    gossip = init_gossip_state(params, gcfg)
    step = make_train_step(cfg, algo=algo, gcfg=gcfg, acfg=acfg, mesh=mesh)
    sums = PlainSums()
    TP._plain_blend = sums
    try:
        for t in range(R.STEPS):
            batch = {"tokens": MM.shard_workers(torch.from_numpy(
                inp[f"{ARCH}.tok.{t}"]), mesh)}
            si, bi = (int(v) for v in inp[f"{ARCH}.draw.{t}"])
            params, gossip, _, m = step(params, gossip, 0, batch, si, bi)
            for k, v in m.items():
                out[f"{case}.{t}.{k}"] = v.numpy()
    finally:
        TP._plain_blend = sums._blend
    for t, (a, b) in enumerate(zip(sums.terms, sums.doubled)):
        out[f"{case}.{t}.terms"] = a.numpy()
        out[f"{case}.{t}.doubled"] = b.numpy()
    out[f"{case}.step"] = np.int64(gossip.step)
    out[f"{case}.live_ok"] = np.int64(live_check(step, algo, params, gossip,
                                                 batch))
    final = TP.gather_params(mesh, params)
    if rank == 0:
        for path, x in SH.tree_paths(final):
            out[f"{case}.final.{R.path_key(path)}"] = x


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        inp = dict(np.load(inputs))
        mesh = MM.make_host_mesh(*R.MESH, device="cpu")
        out = {"workers": MM.shard_workers(torch.arange(R.W), mesh).numpy()}
        for case in CASES:
            run_case(mesh, inp, out, rank, case)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
