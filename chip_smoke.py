#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build every CUDA kernel of the port from its sources (one nvcc per
     source, all started together) and print the build time;
  2. [kernels] hold each kernel against its plain-torch version, with
     CUDA-event times for both, each kernel's bound, and a bitwise repeat
     of each reduce: B1r/B1a at the pipelined path's shapes (W=4,
     R=262848, P=1; f32 and int8 externals, a partial row range); B2r/B2a
     at the pytree path's (W=4, R=262784, P=1, the partition-1 mask);
     B3r/B3a on one smollm-135m replica (R=262784) at P=1 and P=4;
  3. [check] small-input checks, the GPU (kernels) against the CPU (plain
     versions, which the CPU tests hold to the JAX reference) on the
     reduced model from distinct worker starts, so that gates open: 3
     pipelined int8 steps; 3 pytree steps with use_fused=True in 'leaves'
     mode (f32 and int8 wire) and 'rows' mode;
  4. [main] the pipelined path: ``repro_torch.launch.train`` on full
     smollm-135m, W=4, --pipelined --wire-format int8, launch counters
     zeroed just before and read just after — B1r/B1a every round;
  5. [breakdown]/[profile] the pieces of one full-size pipelined step;
  6. [pytree] the pytree engine at full width through make_train_step
     with ASGDConfig(use_fused=True) and the trainer's loop
     (train.run_steps), counters zeroed before and read after — B2r/B2a
     every round — its breakdown and profile; one --algo sync and one
     --algo silent step through train.main;
  7. [fused-update] asgd_update(use_fused=True) on one full smollm-135m
     replica at P=1 and P=4 against use_fused=False, counters zeroed
     before and read after — B3r/B3a launched;
  8. [kernels] B4 (kmeans_assign) at the BATCH shape (M=10^8, K=D=10),
     the round shape (W=64, b=500) and the TPU kernel's envelope (M=2^20,
     K=1024, D=128): idx equal off near-ties, counts exact, sums within
     rtol 1e-5 of f64, bitwise repeatable; its counts at M=2^25+3; B6r/B6a
     on one flattened smollm-135m replica, gate open and shut;
  9. [parzen] the B6 entry point parzen_blend on that replica against the
     plain oracle, counters zeroed before and read after;
 10. [kmeans-check] the round simulator (use_fused False and True) and
     BATCH on a small input, GPU against CPU from the same draws;
 11. [kmeans] the paper's K-Means workload at full size: 10^8 samples
     (k=d=10) made on the card, simulate_rounds W=64 b=500 for 200 rounds
     (ASGD, silent) and 10 BATCH iterations, counters zeroed before and
     read after — B4 twice a round; its profile over 10 rounds.
Then it prints the kernels' JSON line, the card's name and power limit,
and last the device JSON line.  Without a GPU, or without the repo's
sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

W, R, P, BLOCK_ROWS = 4, 262848, 1, 64
ROW_RANGE = (61824, 133120)          # partition 1 of the main path's layout
EPS, LR = 0.05, 0.05
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12               # f32 outside the tensor cores
MAIN_STEPS = 8
PYTREE_STEPS = 8
TOL_REDUCE_RTOL = 1e-5               # sums in another order
TOL_APPLY_ATOL = 1e-6                # elementwise; the same op order
TOL_FUSED_ATOL = 1e-5                # fused vs unfused update: sums in
#                                      other orders, then one division
START_NOISE = 0.1                    # [check]: per-worker start offsets


def log(msg):
    print(msg, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call over ``reps`` calls, by CUDA events,
    after one warm-up call."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(n_bytes, n_flops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def wq_shape():
    """(W, layers, d_model, heads, head_dim) of smollm-135m's stacked
    query weights: (4, 30, 576, 9, 64)."""
    from repro_torch.configs.registry import get_arch
    cfg = get_arch("smollm-135m")
    return (W, cfg.n_layers, cfg.d_model, cfg.n_heads,
            cfg.resolved_head_dim)


def make_operands(torch, device, wire, wn=W, rows=R, p=P):
    """Operands made on the device from a seed: w, dw (wn, rows, 512),
    ext (wn, p, rows, 512) with the (worker, external) pairs alternately
    ahead of the local step and behind it (gates far from the Parzen
    threshold, and mixed)."""
    from repro_torch.core.packing import quantize_rows
    g = torch.Generator(device=device).manual_seed(0)
    w = 0.05 * torch.randn((wn, rows, 512), generator=g, device=device)
    dw = 0.01 * torch.randn((wn, rows, 512), generator=g, device=device)
    side = torch.tensor([0.5 if (i + j) % 2 == 0 else -0.5
                         for i in range(wn) for j in range(p)],
                        device=device).reshape(wn, p, 1, 1)
    ext = (w[:, None] - side * dw[:, None]
           + 0.02 * torch.randn((wn, p, rows, 512), generator=g,
                                device=device))
    scales = None
    if wire == "int8":
        ext, scales = quantize_rows(ext, BLOCK_ROWS)
    return w, dw, ext, scales


def check_reduce(torch, name, acc, acc_p, repeat):
    """Kernel vs plain sums within rtol, and a bitwise repeat."""
    rel = float(((acc - acc_p).abs() / acc_p.abs().clamp_min(1e-30)).max())
    if not torch.allclose(acc, acc_p, rtol=TOL_REDUCE_RTOL, atol=0):
        raise AssertionError(f"{name}: kernel vs plain rel err {rel:.3e} > "
                             f"{TOL_REDUCE_RTOL}")
    for _ in range(2):
        if not torch.equal(repeat(), acc):
            raise AssertionError(f"{name}: the reduce is not reproducible")
    return float((acc - acc_p).abs().max()), rel


def check_apply(torch, name, out, out_p):
    err = float((out - out_p).abs().max())
    if not err <= TOL_APPLY_ATOL:
        raise AssertionError(f"{name}: kernel vs plain max abs err "
                             f"{err:.3e} > {TOL_APPLY_ATOL}")
    return err


def time_pass(torch, results, key, label, fn, plain, err, n_bytes, n_flops,
              note=""):
    ms = cuda_ms(fn, 20)
    plain_ms = cuda_ms(plain, 5)
    b_ms, b_by = bound_ms(n_bytes, n_flops)
    results[key] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                    "bound_by": b_by, "max_abs_err": err}
    log(f"[kernels] {label}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({b_by}, {n_bytes / 1e9:.3f} GB), "
        f"{b_ms / ms:.1%} of bound, max abs err {err:.3e}{note}")


def phase_kernels(torch, device):
    """B1r/B1a against their plain versions at the pipelined path's
    shapes."""
    from repro_torch.kernels.gossip_blend import gossip_gates
    from repro_torch.kernels.gossip_blend.kernel import (
        gossip_apply_w_resident, gossip_reduce_w_resident)
    from repro_torch.kernels.gossip_blend.ref import (
        gossip_apply_w_resident_plain, gossip_reduce_w_resident_plain)

    r0, r1 = ROW_RANGE
    rows_in = r1 - r0
    results = {}
    for wire in ("f32", "int8"):
        w, dw, ext, scales = make_operands(torch, device, wire)
        ext_b = 1 if wire == "int8" else 4
        red = lambda: gossip_reduce_w_resident(          # noqa: E731
            w, dw, ext, ROW_RANGE, scales, block_rows=BLOCK_ROWS)
        red_plain = lambda: gossip_reduce_w_resident_plain(  # noqa: E731
            w, dw, ext, ROW_RANGE, scales, block_rows=BLOCK_ROWS)
        acc, acc_p = red(), red_plain()
        torch.cuda.synchronize()
        err_r, rel = check_reduce(torch, f"B1r/{wire}", acc, acc_p, red)
        gates = gossip_gates(acc_p, EPS)
        inv = 1.0 / (gates.sum(dim=1) + 1.0)
        app = lambda: gossip_apply_w_resident(           # noqa: E731
            w, dw, ext, gates, inv, LR, ROW_RANGE, scales,
            block_rows=BLOCK_ROWS)
        app_plain = lambda: gossip_apply_w_resident_plain(  # noqa: E731
            w, dw, ext, gates, inv, LR, ROW_RANGE, scales,
            block_rows=BLOCK_ROWS)
        out, out_p = app(), app_plain()
        torch.cuda.synchronize()
        err_a = check_apply(torch, f"B1a/{wire}", out, out_p)
        del out, out_p
        # bytes each function must move: reduce reads w, dw, ext (and the
        # scales) on the range's rows and writes (W, P, 3); apply reads w,
        # dw everywhere, ext on the range, gates/inv/lr, writes (W, R, LANE)
        n_in = W * rows_in * 512
        n_all = W * R * 512
        deq = P if scales is not None else 0       # dequantize multiplies
        sc_b = 0 if scales is None else W * P * (rows_in // BLOCK_ROWS) * 4
        where = f"rows [{r0},{r1}) of R={R}"
        time_pass(torch, results, ("B1r", wire), f"B1r {wire:4s} {where}",
                  red, red_plain, err_r,
                  n_in * (4 + 4 + P * ext_b) + sc_b + W * P * 3 * 4,
                  n_in * (2 + 6 * P + deq),
                  f" (max rel {rel:.3e}, bitwise repeatable)")
        time_pass(torch, results, ("B1a", wire), f"B1a {wire:4s} {where}",
                  app, app_plain, err_a,
                  n_all * 12 + n_in * P * ext_b + sc_b + W * P * 4 + W * 4
                  + 4, n_all * 2 + n_in * (4 + 2 * P + deq))
        del w, dw, ext, scales, acc, acc_p
        torch.cuda.empty_cache()
    return results


def pytree_shapes(torch, device):
    """(R of the pytree path's non-group W-packed spec, the partition-1
    mask on it, R of one replica's packed spec) for full smollm-135m."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.gossip import leaf_groups
    from repro_torch.core.packing import (pack_group_mask, pack_spec,
                                          pack_spec_w)
    from repro_torch.core.tree import tree_map
    from repro_torch.models.model import init_model

    params = init_model(get_arch("smollm-135m"), 0, device=device)
    wp = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
    spec = pack_spec_w(wp, block_rows=BLOCK_ROWS)
    mask = pack_group_mask(leaf_groups(wp, 4), 1, spec, device=device)
    return spec.rows, mask, pack_spec(params, BLOCK_ROWS).rows


def phase_batched_kernels(torch, device):
    """B2r/B2a at the pytree path's shapes (W=4, P=1, the partition-1
    mask) and B3r/B3a on one replica at P=1 and P=4, against their plain
    versions."""
    from repro_torch.kernels.gossip_blend import gossip_gates
    from repro_torch.kernels.gossip_blend.kernel import (
        gossip_apply, gossip_apply_w, gossip_reduce, gossip_reduce_w)
    from repro_torch.kernels.gossip_blend.ref import (
        gossip_apply_plain, gossip_apply_w_plain, gossip_reduce_plain,
        gossip_reduce_w_plain)

    rows_w, mask, rows_1 = pytree_shapes(torch, device)
    results = {}
    w, dw, ext, _ = make_operands(torch, device, "f32", W, rows_w, 1)
    red = lambda: gossip_reduce_w(w, dw, ext, mask)         # noqa: E731
    red_plain = lambda: gossip_reduce_w_plain(w, dw, ext, mask)  # noqa
    acc, acc_p = red(), red_plain()
    torch.cuda.synchronize()
    err_r, rel = check_reduce(torch, "B2r", acc, acc_p, red)
    gates = gossip_gates(acc_p, EPS)
    inv = 1.0 / (gates.sum(dim=1) + 1.0)
    app = lambda: gossip_apply_w(w, dw, ext, gates, inv, mask,  # noqa
                                 eps=EPS)
    app_plain = lambda: gossip_apply_w_plain(  # noqa: E731
        w, dw, ext, gates, inv, mask, eps=EPS)
    out, out_p = app(), app_plain()
    torch.cuda.synchronize()
    err_a = check_apply(torch, "B2a", out, out_p)
    del out, out_p
    # bytes each function must move: the worker-shared mask once; the
    # reduce reads w, dw, ext only where the mask is 1 (every term is 0
    # elsewhere) and writes (W, 1, 3); the apply reads w, dw everywhere, ext
    # where the mask is 1, gates/inv, and writes out.  Ops per element
    # where the mask is 1: masking, the 3 products and sums; elsewhere the
    # apply's plain step
    n_mask = rows_w * 512
    n_on = int(mask.count_nonzero())
    n_all, n_in = W * n_mask, W * n_on
    where = (f"W={W} P=1 R={rows_w} mask ({n_on / n_mask:.2%} of it "
             f"ones)")
    time_pass(torch, results, ("B2r", "f32"), f"B2r {where}", red,
              red_plain, err_r, n_mask * 4 + n_in * 12 + W * 3 * 4,
              n_in * 9, f" (max rel {rel:.3e}, bitwise repeatable; "
              f"gates {gates.flatten().tolist()})")
    time_pass(torch, results, ("B2a", "f32"), f"B2a {where}", app,
              app_plain, err_a, n_mask * 4 + n_all * 12 + n_in * 4 + W * 8,
              n_all * 2 + n_in * 6)
    del w, dw, ext, acc, acc_p, mask
    torch.cuda.empty_cache()

    for p in (1, 4):
        w, dw, ext, _ = make_operands(torch, device, "f32", 1, rows_1, p)
        w, dw, ext = w[0], dw[0], ext[0]
        red = lambda: gossip_reduce(w, dw, ext)             # noqa: E731
        red_plain = lambda: gossip_reduce_plain(w, dw, ext)  # noqa: E731
        acc, acc_p = red(), red_plain()
        torch.cuda.synchronize()
        err_r, rel = check_reduce(torch, f"B3r/P={p}", acc, acc_p, red)
        gates = gossip_gates(acc_p, EPS)
        inv = 1.0 / (gates.sum() + 1.0)
        app = lambda: gossip_apply(w, dw, ext, gates, inv,  # noqa: E731
                                   eps=EPS)
        app_plain = lambda: gossip_apply_plain(  # noqa: E731
            w, dw, ext, gates, inv, eps=EPS)
        out, out_p = app(), app_plain()
        torch.cuda.synchronize()
        err_a = check_apply(torch, f"B3a/P={p}", out, out_p)
        del out, out_p
        n = rows_1 * 512
        where = f"one replica R={rows_1} P={p}"
        time_pass(torch, results, ("B3r", p), f"B3r {where}", red,
                  red_plain, err_r, n * 4 * (2 + p) + p * 12,
                  n * (2 + 5 * p), f" (max rel {rel:.3e}, bitwise "
                  f"repeatable; gates {gates.tolist()})")
        time_pass(torch, results, ("B3a", p), f"B3a {where}", app,
                  app_plain, err_a, n * 4 * (3 + p) + p * 4 + 4,
                  n * (2 * p + 5))
        del w, dw, ext, acc, acc_p
        torch.cuda.empty_cache()
    return results


def worker_starts(torch, params):
    """W distinct CPU starting states for the [check] phases: the weights
    plus seeded noise (std START_NOISE) per worker.  Identical starts give
    <dw, w - ext> = 0 and shut every gate; these open some in the first
    admitted rounds, so the checks cover the gated mean."""
    from repro_torch.core.tree import tree_map
    g = torch.Generator().manual_seed(1)
    return tree_map(lambda x: (x.expand((W,) + tuple(x.shape)) + START_NOISE
                               * torch.randn((W,) + tuple(x.shape),
                                             generator=g)).contiguous(),
                    params)


def check_admitted(tag, n_good):
    if not sum(n_good) > 0:
        raise AssertionError(f"{tag}: no message admitted (n_good {n_good})"
                             f" — the check would not cover the blend")


def phase_small_check(torch, device):
    """3 pipelined int8 steps of the reduced model on the GPU (kernels) and
    on the CPU (plain versions) from the same distinct worker starts,
    batches and draws: losses within rel 1e-4, n_good equal and not all 0,
    ensembles within atol 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model

    cfg = get_arch("smollm-135m").reduced()
    wp = worker_starts(torch, init_model(cfg, 0, device="cpu"))
    gcfg = G.GossipConfig(shifts=(1, 2), partial_blocks=4, delay=1,
                          wire_format="int8")
    acfg = ASGDConfig(eps=EPS)
    spec = pack_spec_w(wp, block_rows=BLOCK_ROWS,
                       groups=G.leaf_groups(wp, 4), n_groups=4)
    step = make_train_step(cfg, pack_spec=spec, gcfg=gcfg, acfg=acfg,
                           pipelined=True)
    runs = {}
    for dev in ("cpu", device):
        packed = pack_w(wp, spec).to(dev)
        state = G.init_pipelined_gossip_state(packed, gcfg,
                                              block_rows=BLOCK_ROWS)
        its = [lm_batch_iterator(w, 2, 32, cfg.vocab) for w in range(W)]
        draws = torch.Generator().manual_seed(0)
        out = []
        for _ in range(3):
            tokens = torch.stack([torch.from_numpy(next(it)["tokens"])
                                  for it in its]).to(dev)
            packed, state, _, m = step(packed, state, 0, {"tokens": tokens},
                                       *G.draw_gossip_indices(draws, gcfg))
            out.append((float(m["loss"]), float(m["n_good"])))
        runs[str(dev)] = (out, packed.cpu())
    (cpu, cpu_pk), (gpu, gpu_pk) = runs["cpu"], runs[str(device)]
    for (lc, gc), (lg, gg) in zip(cpu, gpu):
        if abs(lg - lc) > 1e-4 * abs(lc) or gc != gg:
            raise AssertionError(f"small check: GPU (loss {lg}, n_good {gg})"
                                 f" vs CPU (loss {lc}, n_good {gc})")
    err = float((gpu_pk - cpu_pk).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"small check: ensembles differ by {err:.3e}")
    check_admitted("small check", [g for _, g in gpu])
    log(f"[check] reduced smollm, 3 pipelined int8 steps: GPU vs CPU "
        f"losses {[round(l, 6) for l, _ in gpu]} vs "
        f"{[round(l, 6) for l, _ in cpu]}, n_good {[g for _, g in gpu]}, "
        f"max |ensemble diff| {err:.3e}")


def phase_main_path(torch):
    from repro_torch import kernels as K
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    argv = ["--arch", "smollm-135m", "--workers", str(W), "--pipelined",
            "--wire-format", "int8", "--steps", str(MAIN_STEPS), "--batch",
            "2", "--seq", "128", "--log-every", "1"]
    log(f"[main] python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = train.main(argv)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    losses = out["losses"]
    if len(losses) != MAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"main path: losses {losses}")
    for name in (REDUCE, APPLY):
        if counts.get(name, 0) != MAIN_STEPS:
            raise AssertionError(
                f"main path: {name} launched {counts.get(name, 0)} times "
                f"in {MAIN_STEPS} gossip rounds: {counts}")
    wq = out["params"]["scan"]["pos0"]["attn"]["wq"]
    if tuple(wq.shape) != wq_shape() or not bool(torch.isfinite(wq).all()):
        raise AssertionError(f"main path: final average wq "
                             f"{tuple(wq.shape)} not finite/shaped")
    steady = sorted(out["step_seconds"][1:])
    median = steady[len(steady) // 2]
    log(f"[main] launches {counts} over {MAIN_STEPS} steps; step seconds "
        f"{[round(s, 4) for s in out['step_seconds']]} (first includes "
        f"warm-up); steady median {median * 1e3:.2f} ms; n_good "
        f"{out['n_good']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out
    torch.cuda.empty_cache()
    return counts


def phase_breakdown(torch, device):
    """CUDA-event times of the pieces of one full-size pipelined int8 step:
    the exchange (quantize + roll), the forward/backward, the blend (both
    kernels and the gates between)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.steps import make_train_step, packed_loss_and_grad
    from repro_torch.models.model import init_model

    cfg = get_arch("smollm-135m")
    params = init_model(cfg, 0, device=device)
    wp = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
    gcfg = G.GossipConfig(shifts=(1, 2), partial_blocks=4, delay=1,
                          wire_format="int8")
    acfg = ASGDConfig(eps=EPS)
    spec = pack_spec_w(wp, block_rows=BLOCK_ROWS,
                       groups=G.leaf_groups(wp, 4), n_groups=4)
    packed = pack_w(wp, spec)
    del params, wp
    state = G.init_pipelined_gossip_state(packed, gcfg, block_rows=BLOCK_ROWS)
    state = G.PackedGossipState(buf=state.buf, buf_idx=(1, 1), step=2,
                                buf_scales=state.buf_scales)   # guard open
    tokens = torch.randint(0, cfg.vocab, (W, 2, 128), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(0))
    _, pgrads = packed_loss_and_grad(cfg, packed, {"tokens": tokens}, spec)
    t_ex = cuda_ms(lambda: G.initiate_exchange_packed(packed, 0, 1, gcfg,
                                                      spec), 5)
    t_fb = cuda_ms(lambda: packed_loss_and_grad(cfg, packed,
                                                {"tokens": tokens}, spec), 3)
    t_bl = cuda_ms(lambda: G.consume_exchange_packed(
        packed, pgrads, state, state.buf[1], state.buf_scales[1], 1, gcfg,
        acfg, spec), 5)
    total = t_ex + t_fb + t_bl
    log(f"[breakdown] full smollm-135m W={W} batch 2 seq 128 pipelined "
        f"int8: exchange {t_ex:.3f} ms ({t_ex / total:.1%}), forward+"
        f"backward {t_fb:.3f} ms ({t_fb / total:.1%}), blend "
        f"{t_bl:.3f} ms ({t_bl / total:.1%}); sum {total:.3f} ms")

    # device busy share of one whole train step, from a profiler trace
    step = make_train_step(cfg, pack_spec=spec, gcfg=gcfg, acfg=acfg,
                           pipelined=True)
    batch = {"tokens": tokens}
    profile_step(torch, "profile", lambda: step(packed, state, 0, batch, 0,
                                                1))


def profile_step(torch, tag, run, what="one step"):
    """Wall time, device busy time and idle share of one call of ``run``
    (after a warm-up call), and the top device kernels, from a
    torch.profiler trace."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, -math.inf
    for s, e in spans:          # union of the device intervals
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = by_name.get(e.name, 0.0) + \
                (e.time_range.end - e.time_range.start)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    if spans:
        log(f"[{tag}] {what}: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.1%}, "
            f"{len(spans)} device ops")
        for name, us in top:
            log(f"[{tag}]   {us / 1e3:8.3f} ms  {name[:100]}")
    else:
        log(f"[{tag}] the trace holds no device events: device busy share "
            "not measured")


def pytree_gcfg(mode="leaves", wire_format=None):
    from repro_torch.core.gossip import GossipConfig
    return GossipConfig(shifts=(1, 2), partial_blocks=4, partial_mode=mode,
                        delay=1, wire_format=wire_format)


def phase_pytree_check(torch, device):
    """3 pytree-engine steps with use_fused=True of the reduced model on
    the GPU (B2 kernels) and on the CPU (plain versions) from the same
    distinct worker starts, batches and draws, in 'leaves' mode (f32 and
    int8 wire) and 'rows' mode: losses within rel 1e-4, n_good equal and
    not all 0, states within atol 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.gossip import init_gossip_state
    from repro_torch.core.tree import flatten_sorted, tree_map
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import batch_iterators, run_steps
    from repro_torch.models.model import init_model

    cfg = get_arch("smollm-135m").reduced()
    starts = worker_starts(torch, init_model(cfg, 0, device="cpu"))
    acfg = ASGDConfig(eps=EPS, use_fused=True)
    for mode, wire in (("leaves", None), ("leaves", "int8"),
                       ("rows", None)):
        gcfg = pytree_gcfg(mode, wire)
        step = make_train_step(cfg, gcfg=gcfg, acfg=acfg)
        runs = {}
        for dev in ("cpu", device):
            wp = tree_map(lambda x: x.to(dev), starts)
            state = {"params": wp, "gossip": init_gossip_state(wp, gcfg),
                     "opt": 0}
            out = run_steps(step, state, batch_iterators(cfg, W, 2, 32, 0),
                            torch.Generator().manual_seed(0), gcfg, 3, dev,
                            log_every=100)
            runs[str(dev)] = (out, [x.cpu() for x in
                                    flatten_sorted(state["params"])[0]])
        (cpu, cpu_p), (gpu, gpu_p) = runs["cpu"], runs[str(device)]
        for lc, lg in zip(cpu["losses"], gpu["losses"]):
            if abs(lg - lc) > 1e-4 * abs(lc):
                raise AssertionError(f"pytree check {mode}/{wire}: GPU loss "
                                     f"{lg} vs CPU {lc}")
        if gpu["n_good"] != cpu["n_good"]:
            raise AssertionError(f"pytree check {mode}/{wire}: n_good GPU "
                                 f"{gpu['n_good']} vs CPU {cpu['n_good']}")
        err = max(float((a - b).abs().max()) for a, b in zip(gpu_p, cpu_p))
        if not err <= 1e-4:
            raise AssertionError(f"pytree check {mode}/{wire}: states "
                                 f"differ by {err:.3e}")
        check_admitted(f"pytree check {mode}/{wire}", gpu["n_good"])
        log(f"[check] reduced smollm, 3 pytree steps, use_fused, {mode} "
            f"wire {wire or 'f32'}: GPU vs CPU losses "
            f"{[round(l, 6) for l in gpu['losses']]} vs "
            f"{[round(l, 6) for l in cpu['losses']]}, n_good "
            f"{gpu['n_good']}, max |state diff| {err:.3e}")


def phase_pytree(torch, device):
    """The pytree engine at full width: smollm-135m, W=4, batch 2, seq 128,
    'leaves' mode, p=4, delay 1, ASGDConfig(eps=0.05, use_fused=True),
    through make_train_step and train.run_steps; then one --algo sync and
    one --algo silent step through train.main.  Returns the launch counts
    of the B2 run."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.gossip import init_gossip_state
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.gossip_blend.kernel import APPLY_W, REDUCE_W
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model

    cfg = get_arch("smollm-135m")
    gcfg = train.gossip_config(W)
    acfg = ASGDConfig(eps=EPS, use_fused=True)
    params = init_model(cfg, 0, device=device)
    wp = tree_map(lambda x: x.expand((W,) + tuple(x.shape)).contiguous(),
                  params)
    del params
    state = {"params": wp, "gossip": init_gossip_state(wp, gcfg), "opt": 0}
    del wp
    step = make_train_step(cfg, gcfg=gcfg, acfg=acfg)
    log(f"[pytree] full smollm-135m W={W} batch 2 seq 128 leaves p=4 "
        f"delay 1, use_fused, {PYTREE_STEPS} steps")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = train.run_steps(step, state,
                          train.batch_iterators(cfg, W, 2, 128, 0),
                          torch.Generator().manual_seed(0), gcfg,
                          PYTREE_STEPS, device, log_every=1)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    losses = out["losses"]
    if len(losses) != PYTREE_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"pytree path: losses {losses}")
    for name in (REDUCE_W, APPLY_W):
        if counts.get(name, 0) != PYTREE_STEPS:
            raise AssertionError(
                f"pytree path: {name} launched {counts.get(name, 0)} times "
                f"in {PYTREE_STEPS} rounds: {counts}")
    wq = state["params"]["scan"]["pos0"]["attn"]["wq"]
    if tuple(wq.shape) != wq_shape() or not bool(torch.isfinite(wq).all()):
        raise AssertionError(f"pytree path: wq {tuple(wq.shape)} not "
                             f"finite/shaped")
    steady = sorted(out["step_seconds"][1:])
    log(f"[pytree] launches {counts} over {PYTREE_STEPS} steps; step "
        f"seconds {[round(x, 4) for x in out['step_seconds']]} (first "
        f"includes warm-up); steady median "
        f"{steady[len(steady) // 2] * 1e3:.2f} ms; n_good {out['n_good']};"
        f" peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    pytree_breakdown(torch, device, cfg, state, gcfg, acfg, step)
    del state, out
    torch.cuda.empty_cache()
    for algo in ("sync", "silent"):
        argv = ["--arch", "smollm-135m", "--workers", str(W), "--algo",
                algo, "--steps", "1", "--batch", "2", "--seq", "128"]
        res = train.main(argv)
        if not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"--algo {algo}: losses {res['losses']}")
        log(f"[pytree] train.main {' '.join(argv)}: loss "
            f"{res['losses'][0]:.4f}, {res['step_seconds'][0] * 1e3:.1f} ms "
            f"(first step, warm-up included)")
        del res
        torch.cuda.empty_cache()
    return counts


def pytree_breakdown(torch, device, cfg, state, gcfg, acfg, step):
    """CUDA-event times of the pieces of one full-size pytree step: the
    forward/backward, the exchange, the packs (params, grads, ext and the
    mask), the unpack, and the blend (B2r + gates + B2a); then a profile
    of one whole step."""
    from repro_torch.core import gossip as G
    from repro_torch.core.packing import (pack_group_mask, pack_spec_w,
                                          pack_w, unpack_w)
    from repro_torch.kernels.gossip_blend import gossip_blend_worker_batched
    from repro_torch.launch.steps import tree_loss_and_grad

    params = state["params"]
    tokens = torch.randint(0, cfg.vocab, (W, 2, 128), device=device,
                           generator=torch.Generator(device=device)
                           .manual_seed(0))
    batch = {"tokens": tokens}
    _, grads = tree_loss_and_grad(cfg, params, batch)
    groups = G.leaf_groups(params, gcfg.partial_blocks)
    ext = G.exchange_leaves(params, groups, 0, 1, gcfg)
    spec = pack_spec_w(params, block_rows=gcfg.fused_block_rows)

    def packs():
        return (pack_w(params, spec), pack_w(grads, spec),
                pack_w(ext, spec)[:, None],
                pack_group_mask(groups, 1, spec, device=device))

    w3, d3, e4, mask = packs()
    out3, _ = gossip_blend_worker_batched(w3, d3, e4, EPS, mask2d=mask)
    t_fb = cuda_ms(lambda: tree_loss_and_grad(cfg, params, batch), 3)
    t_ex = cuda_ms(lambda: G.exchange_leaves(params, groups, 0, 1, gcfg), 5)
    t_pk = cuda_ms(packs, 5)
    t_un = cuda_ms(lambda: unpack_w(out3, spec), 5)
    t_bl = cuda_ms(lambda: gossip_blend_worker_batched(
        w3, d3, e4, EPS, mask2d=mask), 5)
    total = t_fb + t_ex + t_pk + t_un + t_bl
    parts = (("forward+backward", t_fb), ("exchange", t_ex),
             ("pack x3 + mask", t_pk), ("unpack", t_un),
             ("blend (B2r + gates + B2a)", t_bl))
    log("[pytree-breakdown] full smollm-135m W=4 batch 2 seq 128 leaves "
        "use_fused: " + ", ".join(f"{n} {t:.3f} ms ({t / total:.1%})"
                                  for n, t in parts)
        + f"; sum {total:.3f} ms")
    del w3, d3, e4, mask, out3, ext, grads
    gossip = G.GossipState(buf=state["gossip"].buf, buf_idx=1, step=2)
    profile_step(torch, "pytree-profile",
                 lambda: step(params, gossip, 0, batch, 0, 1))


def phase_fused_update(torch, device):
    """asgd_update(use_fused=True) on one full smollm-135m replica tree at
    P=1 and P=4 against use_fused=False on the same inputs: n_good equal
    (the externals sit half a step ahead of or behind the state, far from
    the threshold), states within atol 1e-5.  Returns the launch counts of
    the fused calls."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.asgd import ASGDConfig, asgd_update
    from repro_torch.core.tree import flatten_sorted, tree_map
    from repro_torch.kernels.gossip_blend.kernel import APPLY_1, REDUCE_1
    from repro_torch.models.model import init_model

    w = init_model(get_arch("smollm-135m"), 0, device=device)
    g = torch.Generator(device=device).manual_seed(1)
    dw = tree_map(lambda x: 0.01 * torch.randn(x.shape, generator=g,
                                                device=device), w)
    exts = [tree_map(lambda x, d, c=c: x - c * d + 0.02 * torch.randn(
        x.shape, generator=g, device=device), w, dw)
        for c in (0.5, -0.5, 0.5, -0.5)]
    counts = {}
    for p in (1, 4):
        K.reset_launch_counts()
        fused, ng_f = asgd_update(w, dw, exts[:p],
                                  ASGDConfig(eps=EPS, use_fused=True))
        torch.cuda.synchronize()
        for name, n in K.launch_counts().items():
            counts[name] = counts.get(name, 0) + n
        plain, ng_p = asgd_update(w, dw, exts[:p], ASGDConfig(eps=EPS))
        err = max(float((a - b).abs().max()) for a, b in zip(
            flatten_sorted(fused)[0], flatten_sorted(plain)[0]))
        if float(ng_f) != float(ng_p) or not err <= TOL_FUSED_ATOL:
            raise AssertionError(f"fused update P={p}: n_good {ng_f} vs "
                                 f"{ng_p}, max abs diff {err:.3e}")
        log(f"[fused-update] one smollm-135m replica, P={p}: use_fused vs "
            f"not: n_good {float(ng_f):.0f} == {float(ng_p):.0f}, max abs "
            f"diff {err:.3e}")
        del fused, plain
    for name in (REDUCE_1, APPLY_1):
        if counts.get(name, 0) != 2:
            raise AssertionError(f"fused update: {name} launched "
                                 f"{counts.get(name, 0)} times: {counts}")
    log(f"[fused-update] launches {counts}")
    return counts


# ---------------------------------------------------------------------------
# the K-Means slice: B4 (kmeans_assign) and B6 (parzen_blend)
# ---------------------------------------------------------------------------

KM_K, KM_D, KM_M = 10, 10, 10**8     # paper's headline dims; 10^8 samples
KM_W, KM_B, KM_EPS = 64, 500, 0.1    # kmeans_scaling's largest W; Fig. 11 b
KM_ROUNDS, KM_BATCH_ITERS = 200, 10
TOL_SUMS_RTOL = 1e-5                 # B4 sums vs an f64 sum, relative to
#                                      the f64 sum of |x| (cancellation-free)
TIE_RTOL = 1e-5                      # B4 idx compared where the top-2 f64
#                                      margin exceeds 1e-5 (|best| + 1)
COUNT_M = 2**25 + 3                  # B4 counts above 2^24


def b4_check(torch, name, x, w, out, out_p, repeat):
    """B4 against its plain version: idx equal wherever the two best f64
    scores do not nearly tie (near-tie flips are counted, not failed);
    counts exactly the kernel idx's integer counts (and the plain
    version's when no idx differs); sums within TOL_SUMS_RTOL of an f64
    sum over the kernel's idx; three launches bitwise equal.  Returns
    (max abs err of sums vs f64, near-tie flips, near ties)."""
    idx, sums, counts = out
    idx_p, _, counts_p = out_p
    wn, k, d = w.shape
    xd, wd = x.double(), w.double()
    scores = (-2.0 * torch.matmul(xd, wd.transpose(1, 2))
              + (wd * wd).sum(-1)[:, None, :])
    if k > 1:
        top = torch.topk(scores, 2, dim=-1, largest=False).values
        off_tie = (top[..., 1] - top[..., 0]) > TIE_RTOL * (
            top[..., 0].abs() + 1.0)
        del top
    else:
        off_tie = torch.ones(idx.shape, dtype=torch.bool, device=x.device)
    del scores
    differ = idx != idx_p
    bad = int((differ & off_tie).sum())
    flips, near = int(differ.sum()), int((~off_tie).sum())
    if bad:
        raise AssertionError(f"{name}: {bad} idx differ off a tie")
    flat = (idx.long() + torch.arange(wn, device=x.device)[:, None] * k
            ).reshape(-1)
    exact = torch.bincount(flat, minlength=wn * k).reshape(wn, k)
    if not torch.equal(counts, exact.float()) or \
            (flips == 0 and not torch.equal(counts, counts_p)):
        raise AssertionError(f"{name}: counts differ")
    xs = xd.expand(wn, -1, -1).reshape(-1, d)
    s64 = torch.zeros((wn * k, d), dtype=torch.float64, device=x.device)
    a64 = torch.zeros_like(s64)
    s64.index_add_(0, flat, xs)
    a64.index_add_(0, flat, xs.abs())
    del xs, xd
    err = (sums.double().reshape(wn * k, d) - s64).abs()
    if not bool((err <= TOL_SUMS_RTOL * a64).all()):
        raise AssertionError(f"{name}: sums off the f64 sum by "
                             f"{float((err / a64.clamp_min(1e-300)).max()):.3e}"
                             f" of sum|x| > {TOL_SUMS_RTOL}")
    for _ in range(2):
        again = repeat()
        if not all(torch.equal(a, b) for a, b in zip(again, out)):
            raise AssertionError(f"{name}: not reproducible")
    return float(err.max()), flips, near


def phase_kmeans_kernels(torch, device):
    """B4 at its three shapes (BATCH, round, envelope) and at M = 2^25 + 3,
    K = 1 (count exactness); B6r/B6a on one flattened smollm-135m replica
    with the gate open and shut — each against its plain version."""
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_w
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_plain
    from repro_torch.kernels.parzen_blend.kernel import (parzen_apply,
                                                         parzen_reduce)
    from repro_torch.kernels.parzen_blend.ref import (parzen_apply_plain,
                                                      parzen_reduce_plain)
    from repro_torch.core.parzen import gate_from_terms

    results = {}
    g = torch.Generator(device=device).manual_seed(3)
    shapes = (("batch", None, KM_M, KM_K, KM_D),    # run_batch's E/M step
              ("round", KM_W, KM_B, KM_K, KM_D),    # one round's W gradients
              ("envelope", None, 2**20, 1024, 128))  # the TPU's VMEM note
    for case, wn, m, k, d in shapes:
        x = torch.randn(((wn,) if wn else ()) + (m, d), generator=g,
                        device=device)
        w = torch.randn((wn or 1, k, d), generator=g, device=device)
        run = lambda: kmeans_assign_w(x, w)                  # noqa: E731
        plain = lambda: kmeans_assign_plain(x, w)            # noqa: E731
        out, out_p = run(), plain()
        torch.cuda.synchronize()
        err, flips, near = b4_check(torch, f"B4/{case}", x, w, out, out_p,
                                    run)
        del out_p
        nw = wn or 1
        time_pass(torch, results, ("B4", case),
                  f"B4 {case:8s} W={nw} M={m} K={k} D={d}", run, plain, err,
                  x.numel() * 4 + nw * m * 4 + w.numel() * 4
                  + nw * k * (d + 1) * 4, 2 * nw * m * k * d,
                  f" (idx flips {flips} among {near} near ties, sums within "
                  f"{TOL_SUMS_RTOL} of f64, bitwise repeatable)")
        del x, w, out
        torch.cuda.empty_cache()
    x = torch.randn((COUNT_M, 4), generator=g, device=device)
    counts = kmeans_assign_w(x, torch.zeros((1, 1, 4), device=device))[2]
    torch.cuda.synchronize()
    if float(counts[0]) != float(torch.tensor(COUNT_M, dtype=torch.float32)):
        raise AssertionError(f"B4 counts: {float(counts[0])} for M={COUNT_M}")
    log(f"[kernels] B4 counts at M={COUNT_M}, K=1: {float(counts[0]):.1f} "
        f"== float32(M) (an f32 sum of ones would stop at 16777216)")
    del x
    torch.cuda.empty_cache()

    _, _, rows = pytree_shapes(torch, device)
    w = 0.05 * torch.randn((rows, 512), generator=g, device=device)
    dw = 0.01 * torch.randn((rows, 512), generator=g, device=device)
    noise = 0.02 * torch.randn((rows, 512), generator=g, device=device)
    n = rows * 512
    for case, side in (("open", 0.5), ("shut", -0.5)):
        ext = w - side * dw + noise
        red = lambda: parzen_reduce(w, ext, dw)             # noqa: E731
        red_plain = lambda: parzen_reduce_plain(w, ext, dw)  # noqa: E731
        acc, acc_p = red(), red_plain()
        torch.cuda.synchronize()
        err_r, rel = check_reduce(torch, f"B6r/{case}", acc, acc_p, red)
        gate = gate_from_terms(acc_p[0], acc_p[1], acc_p[2], EPS)
        if float(gate) != (1.0 if case == "open" else 0.0):
            raise AssertionError(f"B6: gate {float(gate)} not {case}")
        app = lambda: parzen_apply(w, ext, dw, gate, eps=EPS)  # noqa: E731
        app_plain = lambda: parzen_apply_plain(  # noqa: E731
            w, ext, dw, gate, eps=EPS)
        out, out_p = app(), app_plain()
        torch.cuda.synchronize()
        err_a = check_apply(torch, f"B6a/{case}", out, out_p)
        del out, out_p
        where = f"one replica R={rows}, gate {case}"
        time_pass(torch, results, ("B6r", case), f"B6r {where}", red,
                  red_plain, err_r, n * 12 + 12, n * 6,
                  f" (max rel {rel:.3e}, bitwise repeatable)")
        time_pass(torch, results, ("B6a", case), f"B6a {where}", app,
                  app_plain, err_a, n * 16 + 4, n * 6)
        del ext, acc, acc_p
    del w, dw, noise
    torch.cuda.empty_cache()
    return results


def phase_parzen_blend(torch, device):
    """The B6 entry point ``parzen_blend`` on one flattened smollm-135m
    replica (N = 134,515,008), an external ahead of the step (gate open)
    and one behind (shut), counters zeroed before and read after; each
    against the reference's oracle ported (``parzen_blend_ref``): gate
    equal, state within atol 1e-6.  Returns the launch counts."""
    from repro_torch import kernels as K
    from repro_torch.kernels.parzen_blend import parzen_blend
    from repro_torch.kernels.parzen_blend.ref import parzen_blend_ref
    from repro_torch.configs.registry import get_arch
    from repro_torch.models.model import init_model
    from repro_torch.core.tree import flatten_sorted

    leaves = flatten_sorted(init_model(get_arch("smollm-135m"), 0,
                                       device=device))[0]
    w = torch.cat([x.reshape(-1) for x in leaves])
    del leaves
    g = torch.Generator(device=device).manual_seed(4)
    dw = 0.01 * torch.randn(w.shape, generator=g, device=device)
    counts = {}
    for want, side in ((1.0, 0.5), (0.0, -0.5)):
        ext = w - side * dw + 0.02 * torch.randn(w.shape, generator=g,
                                                 device=device)
        K.reset_launch_counts()
        out, gate = parzen_blend(w, ext, dw, EPS)
        torch.cuda.synchronize()
        for name, c in K.launch_counts().items():
            counts[name] = counts.get(name, 0) + c
        ref, gate_r = parzen_blend_ref(w, ext, dw, EPS)
        err = float((out - ref).abs().max())
        if float(gate) != float(gate_r) or float(gate) != want or \
                not err <= TOL_APPLY_ATOL:
            raise AssertionError(f"parzen_blend: gate {float(gate)} vs ref "
                                 f"{float(gate_r)} (want {want}), max abs "
                                 f"diff {err:.3e}")
        log(f"[parzen] parzen_blend on one smollm-135m replica, N="
            f"{w.numel()}: gate {float(gate):.0f} == ref, max abs diff vs "
            f"parzen_blend_ref {err:.3e}")
        del ext, out, ref
    for name in ("parzen_reduce", "parzen_apply"):
        if counts.get(name, 0) != 2:
            raise AssertionError(f"parzen_blend: {name} launched "
                                 f"{counts.get(name, 0)} times: {counts}")
    log(f"[parzen] launches {counts}")
    del w, dw
    torch.cuda.empty_cache()
    return counts


def km_setup(torch, device, k, d, m, workers, seed):
    """(x, centers, w0, shards) from the port's generators on ``device``."""
    from repro_torch.core import baselines as B
    from repro_torch.core import kmeans as KM
    g = torch.Generator(device=device).manual_seed(seed)
    x, centers, labels = KM.synthetic_clusters(g, k, d, m, spread=0.12)
    del labels
    w0 = KM.init_prototypes(x, KM.choose_prototype_indices(g, m, k))
    perm = B.draw_shard_permutation(g, m)
    shards = B.shard_data(x, workers, perm)
    del perm
    return x, centers, w0, shards


def phase_kmeans_check(torch, device):
    """The round simulator and BATCH on a small input, on the GPU (B4, and
    B2 with use_fused) and on the CPU (plain versions, which the CPU tests
    hold to the JAX reference), from the same data and draws — the
    reference test's setup: k=8, d=6, m=32000, W=8, b=64, eps 0.1, delay
    1, 40 rounds, use_fused False and True; then 5 BATCH iterations.
    Per-round errors within rel 1e-5, n_good equal and not all 0, final
    states within atol 1e-5."""
    from repro_torch.core import baselines as B
    from repro_torch.core.asgd import ASGDConfig

    x, _, w0, shards = km_setup(torch, "cpu", 8, 6, 32000, 8, 0)
    for fused in (False, True):
        cfg = B.RoundSimConfig(workers=8, rounds=40, delay=1,
                               asgd=ASGDConfig(eps=0.1, batch=64,
                                               use_fused=fused))
        draws = B.draw_rounds(torch.Generator().manual_seed(1), cfg,
                              shards.shape[1])
        cpu = B.simulate_rounds(shards, w0, cfg, draws)
        gd = B.RoundDraws(draws.batch_idx.to(device), draws.perm.to(device))
        gpu = B.simulate_rounds(shards.to(device), w0.to(device), cfg, gd)
        e_c, e_g = cpu["errors"], gpu["errors"].cpu()
        rel = float(((e_g - e_c).abs() / e_c.abs()).max())
        err = float((gpu["w"].cpu() - cpu["w"]).abs().max())
        if rel > 1e-5 or err > 1e-5 or not torch.equal(
                gpu["n_good"].cpu(), cpu["n_good"]):
            raise AssertionError(f"kmeans check use_fused={fused}: errors "
                                 f"rel {rel:.3e}, states {err:.3e}, n_good "
                                 f"equal {torch.equal(gpu['n_good'].cpu(), cpu['n_good'])}")
        check_admitted(f"kmeans check use_fused={fused}",
                       gpu["n_good"].tolist())
        log(f"[kmeans-check] simulate_rounds W=8 b=64 40 rounds use_fused="
            f"{fused}: GPU vs CPU errors max rel {rel:.3e} (last "
            f"{float(e_g[-1]):.6f}), states max abs {err:.3e}, mean n_good "
            f"{float(gpu['n_good'].mean()):.4f} per worker-round")
    w_c, e_c = B.run_batch(x, w0, 1.0, 5)
    w_g, e_g = B.run_batch(x.to(device), w0.to(device), 1.0, 5)
    rel = float(((e_g.cpu() - e_c).abs() / e_c.abs()).max())
    err = float((w_g.cpu() - w_c).abs().max())
    if rel > 1e-5 or err > 1e-5:
        raise AssertionError(f"kmeans check BATCH: errors rel {rel:.3e}, "
                             f"states {err:.3e}")
    log(f"[kmeans-check] run_batch 5 iterations: GPU vs CPU errors max rel "
        f"{rel:.3e}, states max abs {err:.3e}")


def phase_kmeans(torch, device):
    """The K-Means path at full size on the card: m = 10^8 samples (k = d =
    10, spread 0.12) made on the card, sharded over W = 64 workers;
    simulate_rounds for 200 rounds (b = 500, eps 0.1, delay 1), ASGD and
    silent; 10 BATCH iterations (eps 1.0) over all 10^8 samples.  Counters
    zeroed before and read after each.  Returns the ASGD run's counts."""
    from repro_torch import kernels as K
    from repro_torch.core import baselines as B
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.kernels.kmeans_assign.kernel import ASSIGN

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    x, _, w0, shards = km_setup(torch, device, KM_K, KM_D, KM_M, KM_W, 0)
    torch.cuda.synchronize()
    log(f"[kmeans] data: m={KM_M} k={KM_K} d={KM_D} on the card, sharded "
        f"{tuple(shards.shape)}, in {time.perf_counter() - t0:.2f} s")
    gen = torch.Generator(device=device).manual_seed(1)
    runs, counts = {}, {}
    for mode in ("asgd", "silent"):
        cfg = B.RoundSimConfig(workers=KM_W, rounds=KM_ROUNDS, delay=1,
                               asgd=ASGDConfig(eps=KM_EPS, batch=KM_B,
                                               silent=mode == "silent"))
        draws = B.draw_rounds(gen, cfg, shards.shape[1])
        torch.cuda.synchronize()
        K.reset_launch_counts()
        t0 = time.perf_counter()
        out = B.simulate_rounds(shards, w0, cfg, draws)
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        c = K.launch_counts()
        if mode == "asgd":
            counts = c
        errs = out["errors"].cpu()
        # 2 a round (gradients, errors) + 2 for the final w_first/w_mean
        per_round = (c.get(ASSIGN, 0) - 2) / KM_ROUNDS
        if not bool(torch.isfinite(errs).all()) or not errs[-1] < errs[0] \
                or per_round != 2:
            raise AssertionError(f"kmeans {mode}: errors {errs[[0, -1]]}, "
                                 f"launches {c}")
        runs[mode] = out
        log(f"[kmeans] simulate_rounds {mode}: {KM_ROUNDS} rounds W={KM_W} "
            f"b={KM_B}: {secs / KM_ROUNDS * 1e3:.4f} ms per round (host "
            f"clock, one sync), {KM_W * KM_B * KM_ROUNDS / secs:.4e} "
            f"samples/s; {ASSIGN} {per_round:.2f} launches per round + 2 "
            f"final ({c}); error {float(errs[0]):.6f} -> "
            f"{float(errs[-1]):.6f}, w_first {float(out['w_first_error']):.6f}"
            f", w_mean {float(out['w_mean_error']):.6f}, mean n_good "
            f"{float(out['n_good'].mean()):.4f}")
    K.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, errs_b = B.run_batch(x, w0, 1.0, KM_BATCH_ITERS)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    c = K.launch_counts()
    errs_b = errs_b.cpu()
    if not bool(torch.isfinite(errs_b).all()) or \
            not errs_b[-1] < errs_b[0] or c.get(ASSIGN, 0) == 0:
        raise AssertionError(f"kmeans BATCH: errors {errs_b}, launches {c}")
    log(f"[kmeans] run_batch {KM_BATCH_ITERS} iterations over m={KM_M}: "
        f"{secs / KM_BATCH_ITERS * 1e3:.3f} ms per iteration (host clock), "
        f"{ASSIGN} {c.get(ASSIGN, 0) / KM_BATCH_ITERS:.2f} launches per "
        f"iteration; error {float(errs_b[0]):.6f} -> {float(errs_b[-1]):.6f}")
    log(f"[kmeans] final errors: ASGD {float(runs['asgd']['errors'][-1]):.6f}"
        f", silent {float(runs['silent']['errors'][-1]):.6f}, BATCH "
        f"{float(errs_b[-1]):.6f}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    cfg10 = B.RoundSimConfig(workers=KM_W, rounds=10, delay=1,
                             asgd=ASGDConfig(eps=KM_EPS, batch=KM_B))
    draws10 = B.draw_rounds(gen, cfg10, shards.shape[1])
    profile_step(torch, "kmeans-profile",
                 lambda: B.simulate_rounds(shards, w0, cfg10, draws10),
                 what="10 ASGD rounds")
    del x, shards, runs
    torch.cuda.empty_cache()
    return counts


def main() -> int:
    if not (SRC / "repro_torch" / "kernels").is_dir():
        print("chip_smoke: src/repro_torch not found beside this script — "
              "run it from a checkout of the repository", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 3
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as K
    from repro_torch import set_full_fp32_precision
    from repro_torch.kernels.gossip_blend.kernel import (
        APPLY, APPLY_1, APPLY_W, REDUCE, REDUCE_1, REDUCE_W, SOURCE)
    from repro_torch.kernels.kmeans_assign.kernel import ASSIGN
    from repro_torch.kernels.kmeans_assign.kernel import SOURCE as KM_SOURCE
    from repro_torch.kernels.parzen_blend.kernel import APPLY as PZ_APPLY
    from repro_torch.kernels.parzen_blend.kernel import REDUCE as PZ_REDUCE

    set_full_fp32_precision()
    device = torch.device("cuda")
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__} "
        f"(CUDA {torch.version.cuda}), {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    built = K.build_all()
    log(f"[build] {len(built)} kernel source(s) built in "
        f"{time.perf_counter() - t0:.1f} s: "
        f"{[str(p.relative_to(ROOT)) for p in built]}")

    kres = phase_kernels(torch, device)
    kres.update(phase_batched_kernels(torch, device))
    phase_small_check(torch, device)
    phase_pytree_check(torch, device)
    counts = phase_main_path(torch)
    phase_breakdown(torch, device)
    counts.update(phase_pytree(torch, device))
    counts.update(phase_fused_update(torch, device))
    kres.update(phase_kmeans_kernels(torch, device))
    counts.update(phase_parzen_blend(torch, device))
    phase_kmeans_check(torch, device)
    counts.update(phase_kmeans(torch, device))

    gb = "src/repro/kernels/gossip_blend/kernel.py"
    km = "src/repro/kernels/kmeans_assign/kernel.py"
    pz = "src/repro/kernels/parzen_blend/kernel.py"
    kernels = []
    # (table name, kernel name, source, reference file:line, timed case)
    for tag, name, src, ref, case in (
            ("B1r", REDUCE, SOURCE, f"{gb}:370", "int8"),  # the main
            ("B1a", APPLY, SOURCE, f"{gb}:412", "int8"),   # path's wire
            ("B2r", REDUCE_W, SOURCE, f"{gb}:225", "f32"),
            ("B2a", APPLY_W, SOURCE, f"{gb}:259", "f32"),
            ("B3r", REDUCE_1, SOURCE, f"{gb}:115", 4),     # P=4
            ("B3a", APPLY_1, SOURCE, f"{gb}:141", 4),
            ("B4", ASSIGN, KM_SOURCE, f"{km}:57", "batch"),
            ("B6r", PZ_REDUCE, SOURCE, f"{pz}:65", "open"),
            ("B6a", PZ_APPLY, SOURCE, f"{pz}:85", "open")):
        r = kres[(tag, case)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(src.relative_to(ROOT)),
            "replaces": ref, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    print(json.dumps({"kernels": kernels}), flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
