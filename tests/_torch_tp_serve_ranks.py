"""One rank of tests/test_torch_tensor_parallel_serve.py's gloo launch: 4
CPU processes as a (2, 2) ``("data", "model")`` mesh, serving each case
tensor-parallel over ``model`` with the batch split over ``data``.

    python tests/_torch_tp_serve_ranks.py RANK WORLD STORE INPUTS.npz OUT_DIR

Every rank reads the same inputs (per case: one model's weights, the
prompts and the frontend's frames or patches, made by the test from
numpy seeds), places the weights (launch/tensor_parallel.py
place_serve_params) and serves its share of the batch through
``launch/serve.py generate(mesh=)``, whose steps
(launch/steps.py make_prefill_step / make_decode_step(mesh=)) record
(:class:`Recorded`).  It writes to OUT_DIR/rank<RANK>.npz, per case: the
batch rows it served; the logits and every cache leaf's placement, local
bytes and value (gathered over ``model``) after the prefill and after
each decode step; the collectives (op and bytes) of the first decode
step and of a decode step on a placed zero cache about twice as long
(:class:`Collectives`); the ``attention_flash`` calls; generate's tokens;
and each decode step again from an f32 copy of the single-device
serve's cache and token, beside the single-device step on the same.
Before the cases, ``greedy_tokens`` on logits with ties
(:func:`probe_greedy`).  Imports torch and the port only, so the launch
also runs where jax is absent (tests/_torch_tp_card_check.py).
"""
import contextlib
import sys

import numpy as np
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

import _torch_tp_ranks as R
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import tree_map
from repro_torch.launch import mesh as MM
from repro_torch.launch import serve
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_decode_step, make_prefill_step
from repro_torch.models import blocks
from repro_torch.models import model as TM

NEW = 8
# case: (arch, batch, prompt).  The archs are cut as tests/_torch_tp_ranks
# .py CUTS cuts them for training, so every branch of cache_pspec is
# reached at model 2: smollm's 4/2 heads split the KV cache on heads;
# qwen2.5 at 3/1 heads takes the d_model fallback and splits its cache's
# sequence (24 positions); qwen3 at batch 1 does not divide over data
# and is replicated there; gemma3 at 3/1 heads and a prompt of 17 has
# 25 positions, which model 2 does not divide: the replicated cache (its
# window of 16 binds from the prompt on); paligemma's 4 heads split and
# its 1 KV head does not, its 32 positions sequence-split; whisper's 3
# heads fall back, its self and cross caches (24 and 32 positions)
# sequence-split; smollm at a prompt of 2048 prefills through
# attention_flash
CASES = {"smollm-135m": ("smollm-135m", 2, 16),
         "qwen2.5-14b": ("qwen2.5-14b", 2, 16),
         "qwen3-14b": ("qwen3-14b", 1, 16),
         "gemma3-1b": ("gemma3-1b", 2, 17),
         "paligemma-3b": ("paligemma-3b", 2, 16),
         "whisper-tiny": ("whisper-tiny", 2, 16),
         "smollm-2048": ("smollm-135m", 2, 2048)}


def cache_len(cfg, prompt):
    """The cache generate() makes: the prompt, a vision prefix, NEW."""
    return prompt + TM.vision_prefix(cfg) + NEW


def long_len(n):
    """The second cache length: about twice ``n``, of n's parity, so that
    model 2 places it the same way."""
    return 2 * n + n % 2


class Collectives(TorchDispatchMode):
    """Records every collective issued inside the block as
    "op:bytes" (the op's tensor inputs), waits left out.  DTensor ops are
    let through first (NotImplemented), so the collectives they desugar
    into are seen, as CommDebugMode sees them."""

    def __init__(self, cache=None):
        super().__init__()
        self.ops = []
        # the storages of ``cache``'s local shards, and the collective
        # inputs found reading one
        self.watched = storages(cache) if cache is not None else set()
        self.cache_reads = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(t is DTensor for t in types):
            return NotImplemented
        name = func._schema.name
        if (name.split("::")[0] in ("_c10d_functional", "c10d")
                and "wait" not in name):
            ins = [t for t in tree_leaves((args, kwargs or {}))
                   if isinstance(t, torch.Tensor)]
            n = sum(t.numel() * t.element_size() for t in ins)
            self.ops.append(f"{name}:{n}")
            self.cache_reads += sum(
                t.untyped_storage().data_ptr() in self.watched for t in ins)
        return func(*args, **(kwargs or {}))


def storages(cache) -> set:
    """The data pointers of the storages of a placed cache's local
    shards."""
    return {x.to_local().untyped_storage().data_ptr()
            for _, x in SH.tree_paths(cache)}


class Calls:
    """Counts the calls of ``module.name`` while installed."""

    def __init__(self, module, name):
        self.n, self.module, self.name = 0, module, name
        self.fn = getattr(module, name)

    def __call__(self, *args, **kw):
        self.n += 1
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def batch_of(inp, name, cfg):
    """The case's whole batch: tokens, and the frontend's frames or
    patches."""
    out = {"tokens": torch.from_numpy(inp[f"{name}.tokens"])}
    if cfg.frontend:
        out[R.STUB[cfg.frontend]] = torch.from_numpy(inp[f"{name}.stub"])
    return out


def record_cache(out, key, cache):
    for path, x in SH.tree_paths(cache):
        k = f"{key}.{R.path_key(path)}"
        local = x.to_local()
        out[f"{k}.placement"] = np.array(R.placement_name(x.placements))
        out[f"{k}.bytes"] = np.int64(local.numel() * local.element_size())
        # a copy: an f32 leaf replicated over `model` would be the live
        # cache itself, which the decode steps write in place
        out[f"{k}.value"] = x.full_tensor().float().numpy().copy()


class Recorded:
    """``launch/serve.py``'s step makers, their steps recording into
    ``out`` under ``name``: the logits and the cache after the prefill
    (step 0) and after each decode step, and the collectives of the first
    decode step."""

    def __init__(self, out, name):
        self.out, self.name, self.t = out, name, 0
        self.makers = serve.make_prefill_step, serve.make_decode_step

    def prefill(self, cfg, mesh):
        step = self.makers[0](cfg, mesh)

        def run(*args, **kw):
            last, cache = step(*args, **kw)
            self.record(last, cache)
            return last, cache
        return run

    def decode(self, cfg, mesh):
        step = self.makers[1](cfg, mesh)

        def run(*args, **kw):
            comms = (Collectives(args[3]) if self.t == 1
                     else contextlib.nullcontext())
            with comms:
                logits, cache = step(*args, **kw)
            if self.t == 1:
                self.out[f"{self.name}.comms"] = np.array(comms.ops)
                self.out[f"{self.name}.comms_cache"] = np.int64(
                    comms.cache_reads)
            self.record(logits, cache)
            return logits, cache
        return run

    def record(self, logits, cache):
        key = f"{self.name}.{self.t}"
        self.out[f"{key}.logits"] = logits.full_tensor().numpy()
        record_cache(self.out, f"{key}.cache", cache)
        self.t += 1

    def __enter__(self):
        serve.make_prefill_step, serve.make_decode_step = (self.prefill,
                                                           self.decode)
        return self

    def __exit__(self, *exc):
        serve.make_prefill_step, serve.make_decode_step = self.makers


def run_case(mesh, inp, out, name):
    arch, rows, prompt = CASES[name]
    serve_case(mesh, inp, out, name, R.config(arch, get_arch), rows, prompt)


def serve_case(mesh, inp, out, name, cfg, rows, prompt):
    """One case: ``cfg`` served at batch ``rows`` after a prompt of
    ``prompt`` tokens, its inputs under ``name`` in ``inp``."""
    head = f"{name}.w."
    plain = params_from_numpy(R.nest(
        {k[len(head):]: inp[k] for k in inp if k.startswith(head)}))
    params = TP.place_serve_params(mesh, plain)
    batch = batch_of(inp, name, cfg)
    out[f"{name}.rows"] = TP.serve_slice(mesh, torch.arange(rows)).numpy()
    with Recorded(out, name), Calls(blocks, "attention_flash") as flash:
        toks, _ = serve.generate(cfg, params, batch, prompt, NEW, mesh=mesh)
    out[f"{name}.generate"] = toks.numpy()
    out[f"{name}.flash"] = np.int64(flash.n)
    # each decode step again from the single-device serve's cache (an f32
    # copy: no bf16 rounding of the step's own k/v) and token, placed,
    # beside the single-device step on the same
    start = prompt + TM.vision_prefix(cfg)
    decode = make_decode_step(cfg, mesh)
    plain_decode = make_decode_step(cfg)
    _, plain_toks, plain_caches = serve_plain(cfg, plain, batch, prompt)
    with torch.no_grad():
        for i in range(NEW - 1):
            f32 = tree_map(lambda c: c.float(), plain_caches[i])
            logits, _ = decode(params, TP.serve_slice(mesh, plain_toks[:, i]),
                               start + i, TP.place_cache(mesh, f32, cfg),
                               rows=rows)
            out[f"{name}.forced.{i + 1}"] = logits.full_tensor().numpy()
            out[f"{name}.forced_plain.{i + 1}"] = plain_decode(
                plain, plain_toks[:, i], start + i, f32)[0].numpy()
        length = cache_len(cfg, prompt)
        big = TP.place_cache(mesh, TM.init_cache(cfg, rows, long_len(length)),
                             cfg)
        for path, x in SH.tree_paths(big):
            out[f"{name}.long.{R.path_key(path)}.placement"] = np.array(
                R.placement_name(x.placements))
        with Collectives(big) as comms:
            decode(params, TP.serve_slice(mesh, plain_toks[:, 0]), start, big,
                   rows=rows)
        out[f"{name}.comms_long"] = np.array(comms.ops)
        out[f"{name}.comms_long_cache"] = np.int64(comms.cache_reads)


def probe_greedy(mesh, out):
    """``greedy_tokens`` on vocab-sharded logits (8 columns, 4 a rank of
    the model mesh) with ties within and across the shards and padded
    columns at -1e30, beside ``torch.argmax`` of the whole rows."""
    from torch.distributed.tensor import Shard, distribute_tensor
    rows = torch.tensor([[0., 0., 0., 0., 0., 0., 0., 0.],
                         [1., 3., 2., 3., 3., 0., 3., 1.],
                         [1., 2., 2., 0., 5., 5., -1e30, -1e30],
                         [-1e30, -1e30, -1e30, -1e30, 4., 4., 7., -1e30],
                         [2., 9., 1., 0., -3., 9., 9., -1e30]])
    logits = distribute_tensor(rows, TP.model_mesh(mesh), (Shard(1),))
    out["greedy.got"] = TP.greedy_tokens(logits).numpy()
    out["greedy.want"] = torch.argmax(rows, dim=-1).numpy()


def serve_plain(cfg, params, batch, prompt):
    """The single-device serve of a case, as the ranks run it: the logits
    of the prefill and of each decode step, the greedy tokens (B, NEW),
    and copies of the cache after the prefill and after each step."""
    prefill, decode = make_prefill_step(cfg), make_decode_step(cfg)
    start = prompt + TM.vision_prefix(cfg)
    with torch.no_grad():
        last, cache = prefill(params, batch, cache_len=cache_len(cfg, prompt))
        logits, caches = [last], [tree_map(torch.clone, cache)]
        toks = [torch.argmax(last, dim=-1)]
        for i in range(NEW - 1):
            last, cache = decode(params, toks[-1], start + i, cache)
            logits.append(last)
            caches.append(tree_map(torch.clone, cache))
            toks.append(torch.argmax(last, dim=-1))
    return logits, torch.stack(toks, 1), caches


def main(argv):
    rank, world, store, inputs, out_dir = argv
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    MM.init_ranks(store, rank, world, device="cpu")
    try:
        inp = dict(np.load(inputs))
        mesh = MM.make_host_mesh(*R.MESH, device="cpu")
        out = {}
        probe_greedy(mesh, out)
        for name in CASES:
            if f"{name}.tokens" in inp:
                run_case(mesh, inp, out, name)
        np.savez(f"{out_dir}/rank{rank}.npz", **out)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1:])
