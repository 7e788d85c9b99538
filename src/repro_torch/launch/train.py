"""CLI trainer: ASGD gossip training of W worker replicas on one device.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \\
      --workers 4 --pipelined --wire-format int8 --steps 6

runs full smollm-135m on the GPU.  The engine follows the reference
trainer's flags: --pipelined or --packed-resident keep the packed
(W, R, LANE) ensemble as the state (blend kernels B1r/B1a); without them
the pytree engine carries a tree of (W, ...) leaves (its blend is plain
torch, since the CLI builds ``ASGDConfig(eps, elastic)`` with use_fused
off, as the reference CLI does).  --algo silent and --algo sync replace
the gossip round on the pytree and packed engines.  Add ``--device cpu``
(and ``--reduced`` for the smoke-scale arch) to run on the CPU through the
kernels' plain versions.  Archs with 'S' (mamba-2 SSD) layers train on
every engine: the SSD scan runs B5 forward and B5b backward on the card
(``--arch mamba2-370m --seq 512``); --seq must be a multiple of the
arch's ssm_chunk, as the reference's chunked scan asserts.  The MoE archs
(``--arch granite-moe-1b-a400m``, phi3.5-moe-42b-a6.6b) train on every
engine too: the router's load-balance term is part of every reported loss,
as in the reference; the expert products are batched cuBLAS matmuls.
whisper-tiny and paligemma-3b train on their stub frontends' inputs
(frames and patch embeddings drawn per worker with the tokens).

--save writes the train state after the last step and --restore resumes
from such a file at its step, running on to --steps (files of the JAX
reference's trainer restore too, and the other way round).  --elastic
(with --algo asgd) carries a per-peer liveness mask in the gossip state,
passes an all-alive mask to every step, and lets --restore take a file
saved at another --workers count: the workers are re-seated and the
restored FIFO stays gated out for the join window.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device, set_full_fp32_precision
from ..checkpoint import (load_checkpoint, load_checkpoint_packed,
                          save_checkpoint, save_checkpoint_packed)
from ..configs.registry import get_arch
from ..core.asgd import ASGDConfig
from ..core.gossip import (GossipConfig, draw_gossip_indices, final_average,
                           init_gossip_state, init_packed_gossip_state,
                           init_pipelined_gossip_state, leaf_groups)
from ..core.packing import pack_spec_w, pack_w, unpack_w
from ..core.tree import tree_map
from ..data.synthetic import lm_batch_iterator
from ..models import model as M
from .steps import init_inner_state, make_train_step


def gossip_config(workers: int, partial_blocks: int = 4, delay: int = 1,
                  wire_format: str = "none") -> GossipConfig:
    """The trainer's GossipConfig: ring shifts below W, and the
    --wire-format choice ("none", "int8", "bf16", "f16")."""
    wf, payload_dtype = {
        "none": (None, None),
        "int8": ("int8", None),
        "bf16": ("dtype", torch.bfloat16),
        "f16": ("dtype", torch.float16),
    }[wire_format]
    return GossipConfig(
        shifts=tuple(s for s in (1, 2, 4, 8) if s < max(workers, 2)),
        partial_blocks=partial_blocks, delay=delay, wire_format=wf,
        payload_dtype=payload_dtype)


def batch_iterators(cfg, workers: int, batch: int, seq: int, seed: int):
    """One synthetic token stream per worker, seeded as the reference's."""
    return [lm_batch_iterator(
        seed * 1000 + w, batch, seq, cfg.vocab, frontend=cfg.frontend,
        d_model=cfg.d_model, encoder_seq=cfg.encoder_seq,
        prefix_len=cfg.prefix_len) for w in range(workers)]


def next_wbatch(its, device):
    """One batch of every worker's stream, each key (the tokens, and the
    frontend's frames or patches) stacked into the W axis on ``device``,
    as the reference's trainer stacks them."""
    bs = [next(it) for it in its]
    return {k: torch.stack([torch.from_numpy(b[k]) for b in bs]).to(device)
            for k in bs[0]}


def run_steps(step_fn, state: dict, its, draws: torch.Generator, gcfg,
              steps: int, device, log_every: int = 10, start: int = 0,
              live=None):
    """The training loop shared by every engine: for rounds ``start`` to
    ``steps - 1``, one batch per worker, the round's (shift_idx,
    block_idx) host draws, one step (with ``live``, the per-peer liveness
    mask, when given).  Round t takes the generator's t-th draws, so a
    resumed run draws as an uninterrupted one.  ``state`` holds "params",
    "gossip" and "opt" and is updated in place; its "step" becomes the
    next round.  Returns {"losses", "step_seconds", "n_good"}."""
    losses, step_seconds, n_good = [], [], []
    live_args = () if live is None else (live,)
    for _ in range(start):
        draw_gossip_indices(draws, gcfg)
    t0 = time.perf_counter()
    for step in range(start, steps):
        t_step = time.perf_counter()
        shift_idx, block_idx = draw_gossip_indices(draws, gcfg)
        state["params"], state["gossip"], state["opt"], metrics = step_fn(
            state["params"], state["gossip"], state["opt"],
            next_wbatch(its, device), shift_idx, block_idx, *live_args)
        state["step"] = step + 1
        losses.append(float(metrics["loss"]))      # waits for the step
        step_seconds.append(time.perf_counter() - t_step)
        if "n_good" in metrics:
            n_good.append(float(metrics["n_good"]))
        if step % log_every == 0 or step == steps - 1:
            extra = f" good_msgs={n_good[-1]:.0f}" if n_good else ""
            print(f"step {step:5d} loss {losses[-1]:.4f}"
                  f" ({time.perf_counter() - t0:.1f}s){extra}", flush=True)
    return {"losses": losses, "step_seconds": step_seconds,
            "n_good": n_good}


def main(argv=None):
    """Parse flags, train, and return {"losses", "step_seconds", "n_good",
    "params", "state", "spec"} (params: the final worker-averaged tree;
    state: the final train state, as --save writes it; spec: the packed
    layout, None on the pytree engine), with "restore_seconds" and
    "save_seconds" (host clock) when --restore and --save are given."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale variant of the arch")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--algo", default="asgd",
                    choices=["asgd", "silent", "sync"])
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--workers", type=int, default=4,
                    help="ASGD worker replicas (W axis)")
    ap.add_argument("--batch", type=int, default=2, help="per-worker batch")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--eps", type=float, default=0.05)
    ap.add_argument("--inner", default="sgd",
                    choices=["sgd", "momentum", "adam"])
    ap.add_argument("--partial-blocks", type=int, default=4)
    ap.add_argument("--delay", type=int, default=1)
    ap.add_argument("--wire-format", default="none",
                    choices=["none", "int8", "bf16", "f16"])
    ap.add_argument("--elastic", action="store_true",
                    help="per-peer liveness in the gossip state; --restore "
                         "then accepts a file saved at another --workers")
    ap.add_argument("--elastic-blend", action="store_true",
                    help="beyond-paper elastic (EASGD-style) blending")
    ap.add_argument("--lr-schedule", default="none",
                    choices=["none", "const", "cosine", "linear"])
    ap.add_argument("--warmup", type=int, default=100)
    ap.add_argument("--packed-resident", action="store_true")
    ap.add_argument("--pipelined", action="store_true",
                    help="pipeline the gossip round (implies "
                         "--packed-resident)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save", default=None,
                    help="checkpoint path, written after the last step")
    ap.add_argument("--restore", default=None,
                    help="resume from a checkpoint at its step")
    ap.add_argument("--log-every", type=int, default=10)
    args = ap.parse_args(argv)

    if args.pipelined:
        args.packed_resident = True
    if args.elastic and args.algo != "asgd":
        ap.error("--elastic requires --algo asgd (the liveness gates live "
                 "in the gossip state)")
    if args.lr_schedule != "none" and not args.pipelined:
        ap.error("--lr-schedule requires --pipelined")

    device = resolve_device(args.device)
    set_full_fp32_precision()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    M.check_supported(cfg)
    if "S" in cfg.pattern_cycle and args.seq % cfg.ssm_chunk:
        raise ValueError(f"--seq {args.seq} is not a multiple of "
                         f"{cfg.name}'s ssm_chunk {cfg.ssm_chunk} (the "
                         "chunked SSD scan takes whole chunks)")
    W = args.workers

    params = M.init_model(cfg, args.seed, device=device)
    wparams = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
    gcfg = gossip_config(W, args.partial_blocks, args.delay,
                         args.wire_format)
    acfg = ASGDConfig(eps=args.eps, elastic=args.elastic_blend)
    schedule = None
    if args.lr_schedule != "none":
        from ..optim import lr_schedule as _mk_sched
        schedule = _mk_sched(args.lr_schedule, args.eps,
                             warmup=args.warmup, total=args.steps)

    spec, timing = None, {}
    if args.packed_resident:
        # pack ONCE at init; the ensemble stays packed until the final
        # average
        spec = pack_spec_w(wparams, block_rows=gcfg.fused_block_rows,
                           groups=leaf_groups(wparams, gcfg.partial_blocks),
                           n_groups=gcfg.partial_blocks)
        packed = pack_w(wparams, spec)
        wire_br = spec.block_rows if gcfg.wire_format == "int8" else None
        init_state = (init_pipelined_gossip_state if args.pipelined
                      else init_packed_gossip_state)
        state = {"params": packed,
                 "gossip": init_state(packed, gcfg, block_rows=wire_br,
                                      elastic=args.elastic),
                 "opt": init_inner_state(packed, args.inner), "step": 0}
        # the state holds the ensemble and each step replaces it: a local
        # name would keep the first one alive on the card all run long
        del packed
    else:
        wparams = tree_map(torch.Tensor.contiguous, wparams)
        state = {"params": wparams,
                 "gossip": init_gossip_state(wparams, gcfg,
                                             elastic=args.elastic),
                 "opt": init_inner_state(wparams, args.inner), "step": 0}
    del params, wparams
    if args.restore:
        t0 = time.perf_counter()
        if spec is not None:
            state = load_checkpoint_packed(args.restore, state, spec,
                                           elastic=args.elastic)
            how = f" (re-packed{', elastic' if args.elastic else ''})"
        else:
            state = load_checkpoint(args.restore, state,
                                    resize_workers=args.elastic)
            how = ""
        timing["restore_seconds"] = time.perf_counter() - t0
        print(f"restored step={state['step']} from {args.restore}{how}",
              flush=True)

    step_fn = make_train_step(
        cfg, pack_spec=spec, algo=args.algo, inner=args.inner, gcfg=gcfg,
        acfg=acfg, pipelined=args.pipelined, lr_schedule=schedule)
    # the trainer drives a fully live fleet; a launcher that detects churn
    # would flip entries of this mask per round
    live = (torch.ones((W,), dtype=torch.float32, device=device)
            if args.elastic else None)
    # the batch streams restart on a resume, as the reference's do
    out = run_steps(step_fn, state,
                    batch_iterators(cfg, W, args.batch, args.seq, args.seed),
                    torch.Generator().manual_seed(args.seed), gcfg,
                    args.steps, device, args.log_every, start=state["step"],
                    live=live)

    # final aggregate (paper §4.3) — for the packed engines the run's one
    # unpack boundary
    final = (unpack_w(state["params"], spec) if spec is not None
             else state["params"])
    if out["losses"]:
        print(f"final: last-loss={out['losses'][-1]:.4f} "
              f"(start {out['losses'][0]:.4f})", flush=True)
    else:
        print(f"final: no steps run (restored step {state['step']} >= "
              f"--steps {args.steps})", flush=True)
    if args.save:
        t0 = time.perf_counter()
        if spec is not None:
            save_checkpoint_packed(args.save, state, spec)
        else:
            save_checkpoint(args.save, state)
        timing["save_seconds"] = time.perf_counter() - t0
        print(f"saved -> {args.save}", flush=True)
    return {**out, **timing, "params": final_average(final), "state": state,
            "spec": spec}


if __name__ == "__main__":
    main()
