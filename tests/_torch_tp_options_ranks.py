"""One rank of tests/test_torch_tensor_parallel_options.py's gloo launch:
4 CPU processes as a (2, 2) ``("data", "model")`` mesh, W = 4 workers
(W_local = 2), running the tensor-parallel pytree step
(make_train_step(mesh=)) of reduced smollm-135m under the options of the
reference's pytree step that ROADMAP items 15d and 15f brought to the
mesh (:data:`CASES`): the int8 wire on shards (the fused and the plain
blend), ``live=`` with worker :data:`DEAD` down on the second step,
inner momentum and Adam, sync with momentum, ``gossip_every`` 2, and
'rows' mode alone and on the int8 wire; and two planted faults
(:data:`FAULTS`): ``live`` rolled inside each rank's slice only, and the
rows block of a ``Shard(1)`` leaf taken at local indices.

    python tests/_torch_tp_options_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

The inputs are tests/_torch_tp_ranks.py's (the global weights, each
step's tokens and draws).  Each rank writes OUT_DIR/rank<RANK>.npz: each
case's per-step metrics, the bytes it sent and the gathered ``buf_live``
(the live cases), the round counter, and (rank 0) the gathered final
params; for Adam, each step held against the single-device step from
the same state on the same gradient (:func:`adam_step_check`) and the
params after the first step; and the int8 exchange of the initial
weights on every (shift, partition) pair (launch/tensor_parallel.py ``_exchange_leaves``),
gathered, beside the single-device ``core.gossip.exchange_leaves`` of
the same weights: whether they are bitwise equal, and the same with each
shard quantized by its own absmax (the planted fault), with the fault's
largest difference.  Imports torch and the port only.
"""
import contextlib
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import gossip as G
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.tree import flatten_sorted, unflatten
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import init_inner_state, make_train_step

import _torch_tp_ranks as R

ARCH = "smollm-135m"
# case -> (algo, inner, GossipConfig keywords, ASGDConfig keywords, live=)
CASES = {
    "int8": ("asgd", "sgd", {"wire_format": "int8"}, {}, False),
    "int8-plain": ("asgd", "sgd", {"wire_format": "int8"},
                   {"use_fused": False}, False),
    "live": ("asgd", "sgd", {}, {}, True),
    "momentum": ("asgd", "momentum", {}, {}, False),
    "adam": ("asgd", "adam", {}, {}, False),
    "sync-momentum": ("sync", "momentum", {}, {}, False),
    "every2": ("asgd", "sgd", {"gossip_every": 2}, {}, False),
    "rows": ("asgd", "sgd", {"partial_mode": "rows"}, {}, False),
    "rows-int8": ("asgd", "sgd", {"partial_mode": "rows",
                                  "wire_format": "int8"}, {}, False),
}
# planted fault -> the case it runs
FAULTS = {"live-unrolled": "live", "rows-local-index": "rows"}
DEAD, DEAD_STEP = 1, 1     # worker 1 is down on the second step
# Adam's update is w - lr * m^ / (sqrt(v^) + 1e-8): at t = 1 about
# lr * g / (|g| + 1e-8), so where |g| is near the float noise of its sums
# (across packages) the update moves by up to lr.  Such an element is an
# Adam tie: |g| below this at the step.
ADAM_TIE = 1e-6


def live_at(t):
    """The fleet's (W,) liveness on step ``t``."""
    live = torch.ones(R.W)
    if t == DEAD_STEP:
        live[DEAD] = 0.0
    return live


def gossip_kw(case):
    return {**R.gossip_kw(ARCH, torch.bfloat16), **CASES[case][2]}


def _unrolled_live(live, shift, mesh, tally):
    """The fault: ``live`` rolled inside the rank's slice only."""
    return torch.roll(live, shift, dims=0) * live


def _rows_at_local_index(x, block_idx, p):
    """The fault: every leaf's block taken at indices of its local shard,
    as if the shard were the leaf."""
    local = x.to_local()
    if local.ndim < 2:
        return None
    start, blk = G._block_start(local, block_idx, p)
    return start, start + blk


@contextlib.contextmanager
def planted(fault):
    """The fault's replacement of a launch/tensor_parallel.py helper."""
    name, fn = {"live-unrolled": ("_roll_live", _unrolled_live),
                "rows-local-index": ("_rows_range", _rows_at_local_index),
                "shard-absmax": ("_absmax_over_model",
                                 lambda a, mesh: a)}[fault]
    saved = getattr(TP, name)
    setattr(TP, name, fn)
    try:
        yield
    finally:
        setattr(TP, name, saved)


def weights(inp):
    head = f"{ARCH}.w."
    return params_from_numpy(R.nest({k[len(head):]: inp[k] for k in inp
                                     if k.startswith(head)}))


def gathered_state(mesh, params, gossip, opt, grads):
    """The global numpy trees of a placed step's state, and its gradient:
    params, the gossip buffer, Adam's moments, the step's gradient."""
    return {"params": TP.gather_params(mesh, params),
            "buf": TP.gather_params(mesh, gossip.buf),
            "m": TP.gather_params(mesh, opt["m"]),
            "v": TP.gather_params(mesh, opt["v"]),
            "grads": TP.gather_params(mesh, grads)}


def adam_step_check(out, tag, t, case, pre, post, gossip, opt, batch, si,
                    bi):
    """One step of the placed Adam run against the single-device step from
    the same state (a gathered :func:`gathered_state`, the placed state's
    host ints) on the placed step's own gradient: the elements beyond
    rtol and atol 1e-5; and the placed gradient's largest difference from
    the single-device one, over each leaf's largest magnitude.  (Adam
    divides each moment by its root mean square, so a gradient's rounding
    moves a small gradient's step by up to lr: the gradient and the
    update are held apart.)"""
    from repro_torch.launch import steps as ST
    algo, inner, _, acfg_kw, _ = CASES[case]
    cfg = R.config(ARCH, get_arch)
    gcfg = G.GossipConfig(**gossip_kw(case))
    step = make_train_step(cfg, algo=algo, inner=inner, gcfg=gcfg,
                           acfg=ASGDConfig(eps=R.EPS, **{"use_fused": True,
                                                         **acfg_kw}))
    params = params_from_numpy(pre["params"])
    placed_grads = params_from_numpy(pre["grads"])
    losses, grads = ST.tree_loss_and_grad(cfg, params, batch)
    saved = ST.tree_loss_and_grad
    ST.tree_loss_and_grad = lambda *a, **k: (losses, placed_grads)
    try:
        want = step(params, G.GossipState(
            buf=params_from_numpy(pre["buf"]), buf_idx=gossip.buf_idx,
            step=gossip.step), {"m": params_from_numpy(pre["m"]),
                                "v": params_from_numpy(pre["v"]),
                                "t": opt["t"]}, batch, si, bi)[0]
    finally:
        ST.tree_loss_and_grad = saved
    beyond, rel = 0, 0.0
    for (_, x), y, g, h in zip(SH.tree_paths(post),
                               flatten_sorted(want)[0],
                               flatten_sorted(placed_grads)[0],
                               flatten_sorted(grads)[0]):
        beyond += int((~np.isclose(x, y.numpy(), rtol=1e-5,
                                   atol=1e-5)).sum())
        rel = max(rel, float((g - h).abs().max() / h.abs().max()))
    out[f"{tag}.{t}.tf_beyond"] = np.int64(beyond)
    out[f"{tag}.{t}.grad_rel"] = np.float64(rel)


def run_case(mesh, inp, out, rank, case, tag):
    algo, inner, _, acfg_kw, elastic = CASES[case]
    cfg = R.config(ARCH, get_arch)
    gcfg = G.GossipConfig(**gossip_kw(case))
    acfg = ASGDConfig(eps=R.EPS, **{"use_fused": True, **acfg_kw})
    params = TP.place_params(mesh, weights(inp))
    gossip = TP.init_placed_gossip_state(params, gcfg, elastic=elastic)
    opt = init_inner_state(params, inner)
    step = make_train_step(cfg, algo=algo, inner=inner, gcfg=gcfg,
                           acfg=acfg, mesh=mesh)
    for t in range(R.STEPS):
        batch = {"tokens": MM.shard_workers(torch.from_numpy(
            inp[f"{ARCH}.tok.{t}"]), mesh)}
        si, bi = (int(v) for v in inp[f"{ARCH}.draw.{t}"])
        kw = {"live": MM.shard_workers(live_at(t), mesh)} if elastic else {}
        before = step.bytes_sent
        if inner == "adam":
            pre = gathered_state(mesh, params, gossip, opt,
                                 step.loss_and_grad(params, batch)[1])
            pre_gossip, pre_opt = gossip, opt
        params, gossip, opt, m = step(params, gossip, opt, batch, si, bi,
                                      **kw)
        if inner == "adam":
            post = TP.gather_params(mesh, params)
            if rank == 0:
                whole = {"tokens": torch.from_numpy(inp[f"{ARCH}.tok.{t}"])}
                adam_step_check(out, tag, t, case, pre, post, pre_gossip,
                                pre_opt, whole, si, bi)
                if t == 0:
                    for path, x in SH.tree_paths(post):
                        out[f"{tag}.after0.{R.path_key(path)}"] = x
        out[f"{tag}.{t}.bytes"] = np.int64(step.bytes_sent - before)
        for k, v in m.items():
            out[f"{tag}.{t}.{k}"] = v.numpy()
        if elastic:
            out[f"{tag}.{t}.buf_live"] = MM.gather_workers(
                gossip.buf_live, mesh).numpy()
    out[f"{tag}.step"] = np.int64(gossip.step)
    final = TP.gather_params(mesh, params)
    if rank == 0:
        for path, x in SH.tree_paths(final):
            out[f"{tag}.final.{R.path_key(path)}"] = x


def exchange_check(mesh, inp, out):
    """The int8 exchange of the initial weights on shards against the
    single-device one, every (shift, partition) pair; and the planted
    fault's."""
    gcfg = G.GossipConfig(**gossip_kw("int8"))
    whole = weights(inp)
    params = TP.place_params(mesh, whole)
    leaves, treedef = flatten_sorted(params)
    local = [x.to_local() for x in leaves]
    gids = flatten_sorted(G.leaf_groups(params, gcfg.partial_blocks))[0]
    groups = G.leaf_groups(whole, gcfg.partial_blocks)
    for si, shift in enumerate(gcfg.shifts):
        for bi in range(gcfg.partial_blocks):
            want = flatten_sorted(G.exchange_leaves(whole, groups, si, bi,
                                                    gcfg))[0]
            for fault in (None, "shard-absmax"):
                with (planted(fault) if fault else contextlib.nullcontext()):
                    sent = TP._exchange_leaves(leaves, local, gids, shift, bi,
                                               gcfg, mesh, None)
                got = flatten_sorted(TP.gather_params(mesh, unflatten(
                    treedef, [TP._rewrap(x, t) for x, t in
                              zip(leaves, sent)])))[0]
                diff = max(float(np.abs(g - w.numpy()).max())
                           for g, w in zip(got, want))
                key = f"xchg.{si}.{bi}" + (".fault" if fault else "")
                out[key] = np.float64(diff)
                out[key + ".sharded"] = np.int64(not all(
                    TP._replicated(x) for x, g in zip(leaves, gids)
                    if g == bi))


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        inp = dict(np.load(inputs))
        mesh = MM.make_host_mesh(*R.MESH, device="cpu")
        out = {"workers": MM.shard_workers(torch.arange(R.W), mesh).numpy()}
        exchange_check(mesh, inp, out)
        for case in CASES:
            run_case(mesh, inp, out, rank, case, case)
        for fault, case in FAULTS.items():
            with planted(fault):
                run_case(mesh, inp, out, rank, case, fault)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
