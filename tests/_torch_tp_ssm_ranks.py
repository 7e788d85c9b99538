"""One rank of tests/test_torch_tensor_parallel_ssm.py's gloo launch: 4
CPU processes as a (2, 2) ``("data", "model")`` mesh, training and
serving configs with 'S' (Mamba-2 SSD) and 'R' (RG-LRU) layers
tensor-parallel over ``model``.

    python tests/_torch_tp_ssm_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

Every rank reads the same inputs (per case: the weights, each step's
tokens and draws, the prompts; made by the test from numpy seeds and the
reference's initialisation).  Training (:data:`TRAIN`): W = 4 workers
(W_local 2), seq 32, the weights placed by ``place_params``, then the
first batch's gradient tree (``TensorParallelStep.loss_and_grad``) and
STEPS pytree steps of ``make_train_step(mesh=)``; written: each step's
metrics, the gradients and final params gathered whole (rank 0), every
leaf's and gradient's placement and local bytes, and the head counts
each SSD scan ran on (:class:`Scans`).  Serving (:data:`SERVE`):
``_torch_tp_serve_ranks.py``'s ``serve_case`` (generate(mesh=), each
step's logits and placed cache, the decode steps' collectives).
Imports torch and the port only (tests/_torch_tp_card_check.py runs it
where jax is absent).
"""
import dataclasses
import sys

import numpy as np
import torch
import torch.distributed as dist

import _torch_tp_ranks as R
import _torch_tp_serve_ranks as S
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import GossipConfig, init_gossip_state
from repro_torch.launch import mesh as MM
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step
from repro_torch.models import rglru, ssm

# case: (arch, cuts, batch).  Reduced mamba2-370m: 32 heads of 16 split
# over model 2, in_proj's 1088 columns [z | x | B | C | dt] and the
# conv's 544 channels [x | B | C] split at 544 and 272, inside x.
# mamba2-odd: d_model 48, head_dim 32, so 3 heads, which model 2 does not
# divide (every rank scans every head; the ssm cache is replicated), and
# in_proj's 227 columns do not divide either (it shards d_model); the
# conv's 128 channels do.  Reduced recurrentgemma-9b: one (R, R, L)
# cycle, the LRU width of 256 split at 128, seq_parallel on;
# recurrentgemma-b16 the same at a batch of 16, where attn_batch_shard's
# hint shards the recurrent block's batch over model.
TRAIN = {"mamba2-370m": ("mamba2-370m", {}, 2),
         "mamba2-odd": ("mamba2-370m", {"d_model": 48, "ssm_head_dim": 32},
                        2),
         "recurrentgemma-9b": ("recurrentgemma-9b", {}, 2),
         "recurrentgemma-b16": ("recurrentgemma-9b", {}, 16)}
# case: (arch, cuts, batch, prompt)
SERVE = {"mamba2-370m": ("mamba2-370m", {}, 2, 16),
         "mamba2-odd": ("mamba2-370m", TRAIN["mamba2-odd"][1], 2, 16),
         "recurrentgemma-9b": ("recurrentgemma-9b", {}, 2, 16)}
SEQ, STEPS = 32, 3


def config(arch, cuts, registry_get_arch):
    """A case's reduced config from either package's registry."""
    return dataclasses.replace(registry_get_arch(arch).reduced(), **cuts)


def gossip_kw():
    return dict(shifts=(1, 2), partial_blocks=4, delay=1)


def worker_starts(base, seed):
    """{path key: (W, ...) f32}: one model's leaves ``base`` plus each
    worker's own seeded offset of START_NOISE times the leaf's spread
    (0.5 for a constant leaf: zero norm scales and biases, D's ones), which
    at eps 0.01 opens some gates, as tests/_torch_tp_ranks.py's starts."""
    rng = np.random.default_rng(seed)
    out = {}
    for k in sorted(base):
        x = np.asarray(base[k], np.float32)
        std = float(x.std()) or 0.5
        out[k] = (x + R.START_NOISE * std * rng.standard_normal(
            (R.W,) + x.shape)).astype(np.float32)
    return out


def grad_parts(cfg, key, g):
    """A gradient leaf's parts, each held to its own scale: in_proj's
    columns [z | x | B | C | dt] and the conv's channels [x | B | C] apart
    (the B/C parts are the sums over ``model`` of each rank's heads'
    terms); any other leaf whole."""
    leaf = key.rsplit("/", 1)[-1]
    if "/ssm/" not in key or leaf not in ("in_proj", "conv_w", "conv_b"):
        return {key: g}
    d_inner = cfg.ssm_expand * cfg.d_model
    gs = cfg.ssm_groups * cfg.ssm_state
    names, sizes = ["x", "B", "C"], [d_inner, gs, gs]
    if leaf == "in_proj":
        names = ["z"] + names + ["dt"]
        sizes = [d_inner] + sizes + [d_inner // cfg.ssm_head_dim]
    if sum(sizes) != g.shape[-1]:
        raise ValueError(f"{key}: parts {sizes} of {g.shape}")
    return {f"{key}[{n}]": part for n, part in
            zip(names, np.split(g, np.cumsum(sizes)[:-1], axis=-1))}


class Scans:
    """Records the head count of every SSD scan (models/ssm.py's
    ``ssd_scan``: x (Bb, S, H, P)) that a mixer on placed leaves
    (``_apply_ssd_placed``) launches, while installed."""

    def __init__(self):
        self.heads, self._inside = [], False
        self._scan, self._placed = ssm.ssd_scan, ssm._apply_ssd_placed

    def scan(self, x, *args, **kw):
        if self._inside:
            self.heads.append(x.shape[2])
        return self._scan(x, *args, **kw)

    def placed(self, *args, **kw):
        self._inside = True
        try:
            return self._placed(*args, **kw)
        finally:
            self._inside = False

    def __enter__(self):
        ssm.ssd_scan, ssm._apply_ssd_placed = self.scan, self.placed
        return self

    def __exit__(self, *exc):
        ssm.ssd_scan, ssm._apply_ssd_placed = self._scan, self._placed


class RgPaths:
    """Records how each RG-LRU block on placed leaves ran (models/rglru.py
    ``_apply_rglru_placed``): "batch" (its input sharded over the batch),
    "width" (every leaf split along the LRU width) or "whole"."""

    def __init__(self):
        self.paths = []
        self._placed = rglru._apply_rglru_placed

    def __call__(self, params, x_in):
        from torch.distributed.tensor import Shard
        self.paths.append("batch" if x_in.placements == (Shard(1),) else
                          "width" if rglru._width_split(params) else "whole")
        return self._placed(params, x_in)

    def __enter__(self):
        rglru._apply_rglru_placed = self
        return self

    def __exit__(self, *exc):
        rglru._apply_rglru_placed = self._placed


def record_tree(out, key, tree):
    """Each DTensor leaf's placement and local bytes."""
    for path, x in SH.tree_paths(tree):
        k = f"{key}.{R.path_key(path)}"
        local = x.to_local()
        out[f"{k}.placement"] = np.array(R.placement_name(x.placements))
        out[f"{k}.bytes"] = np.int64(local.numel() * local.element_size())


def run_train(mesh, inp, out, rank, name):
    arch, cuts, _ = TRAIN[name]
    cfg = config(arch, cuts, get_arch)
    gcfg = GossipConfig(**gossip_kw())
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
    with Scans() as scans, RgPaths() as rg:
        _, grads = step.loss_and_grad(params, batch(0))
        record_tree(out, f"{head}grad", grads)
        grads = TP.gather_params(mesh, grads)
        for t in range(STEPS):
            si, bi = (int(v) for v in inp[f"{head}draw.{t}"])
            params, gossip, _, m = step(params, gossip, 0, batch(t), si, bi)
            for k, v in m.items():
                out[f"{head}{t}.{k}"] = v.numpy()
    out[f"{head}scan_heads"] = np.asarray(scans.heads, np.int64)
    out[f"{head}rg_paths"] = np.array(rg.paths)
    record_tree(out, f"{head}leaf", params)
    final = TP.gather_params(mesh, params)
    if rank == 0:
        for what, tree in (("grads", grads), ("final", final)):
            for path, x in SH.tree_paths(tree):
                out[f"{head}{what}.{R.path_key(path)}"] = x


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
        for name, (arch, cuts, rows, prompt) in SERVE.items():
            if f"{name}.tokens" in inp:
                with Scans() as scans, RgPaths() as rg:
                    S.serve_case(mesh, inp, out, name,
                                 config(arch, cuts, get_arch), rows, prompt)
                out[f"{name}.scan_heads"] = np.asarray(scans.heads, np.int64)
                out[f"{name}.rg_paths"] = np.array(rg.paths)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
