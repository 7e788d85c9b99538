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
  5. [breakdown]/[profile] the pieces of one full-size pipelined step,
     and its exchange and blend on an elastic state (live = ones);
     [elastic-check] liveness under churn (worker 2 dead in rounds 1-2)
     on the reduced model, GPU against CPU: 5 pipelined int8 steps (B1)
     and 5 pytree use_fused steps (B2), the dead worker's rows bitwise
     frozen, every round's blend launched, the engine with live = ones
     bitwise the legacy run; [ckpt] --save of the main path after 3 steps
     (a temporary file), restored bitwise into a fresh state, --restore
     to step 5 (B1r/B1a twice); [elastic] that file restored --elastic at
     W=2 to step 6 (2 join rounds admit nothing, B1r/B1a every round),
     then W=4 legacy and elastic runs in turns;
  6. [pytree] the pytree engine at full width through make_train_step
     with ASGDConfig(use_fused=True) and the trainer's loop
     (train.run_steps), counters zeroed before and read after — B2r/B2a
     every round — its breakdown and profile; one --algo sync and one
     --algo silent step through train.main;
  7. [fused-update] asgd_update(use_fused=True) on one full smollm-135m
     replica at P=1 and P=4 against use_fused=False, counters zeroed
     before and read after — B3r/B3a launched;
  8. [kernels] B4 (kmeans_assign) at the BATCH shape (M=10^8, K=D=10),
     the round shape (W=64, b=500), Fig. 7's largest k (M=10^7, K=100,
     D=10) and the TPU kernel's envelope (M=2^20, K=1024, D=128): idx
     equal off near-ties, counts exact, sums within rtol 1e-5 of f64,
     bitwise repeatable, which of B4's two kernels the shape takes, and at
     the round shape the device time of its two launches from the
     profiler; its counts at M=2^25+3; B6r/B6a on one flattened
     smollm-135m replica, gate open and shut;
  9. [parzen] the B6 entry point parzen_blend on that replica against the
     plain oracle, counters zeroed before and read after;
 10. [kmeans-check] the round simulator (use_fused False and True) and
     BATCH on a small input, GPU against CPU from the same draws;
 11. [kmeans] the paper's K-Means workload at full size: 10^8 samples
     (k=d=10) made on the card, simulate_rounds W=64 b=500 for 200 rounds
     (ASGD, silent) and 10 BATCH iterations, counters zeroed before and
     read after — B4 twice a round; its profile over 10 rounds;
 12. [kernels] B5 (ssd_scan) at the mamba2-370m serve shape (batch 4, S
     2048, 32 heads of 64, state 128, chunk 128): its time against both
     bounds (tensor cores in split TF32, f32 SIMT), device launches a
     call; as views of a conv output (read in place, bitwise equal to
     contiguous copies), at a padded S (2000, through ops.ssd_scan), at the
     decay extremes and on cancelling sums (split TF32 within the gate):
     y and h within 1e-4 of the largest magnitude of the plain version's,
     bitwise repeatable;
 13. [kernels] B5b (ssd_scan_bwd, the SSD scan's backward) at the
     mamba2-370m training shape (batch 8 = W 4 x 2, S 512, 32 heads of 64,
     state 128, chunk 128) against the plain backward on the same inputs
     (B5's saved L and h_prev): a random input, x, B and C as views of a
     conv output (bitwise the contiguous copies' gradients) and cancelling
     sums; every gradient within 1e-4 of its largest magnitude, bitwise
     repeatable; its time against both bounds (tensor cores in split TF32,
     f32 SIMT) and its stages' device times; through autograd, one B5 and
     one B5b launch;
 14. [serve-check] reduced mamba2-370m and smollm-135m from the same
     CPU-made weights, GPU against CPU: prefill and 4 decode steps' logits,
     greedy tokens off near-ties, every cache leaf; smollm also at a
     2048-token prompt (attention_flash);
 15. [serve] the serving path, ``repro_torch.launch.serve.main``, on full
     mamba2-370m (batch 4, prompt 2048, 32 new tokens), counters zeroed
     before and read after — B5 48 times a prefill, 0 in decode — its
     steady prefill and decode times, a profile of one prefill and of one
     decode step; then full smollm-135m (batch 4, prompt 2048: every 'G'
     layer of the prefill through attention_flash, counted) and its steady
     times;
 16. [ssm-train-check] reduced mamba2-370m (seq 32: 4 chunks of 8), 3
     pipelined int8 steps from distinct worker starts, GPU (B5, B5b, B1)
     against CPU: losses rel 1e-4, ensembles atol 1e-4, n_good equal and
     not all 0;
 17. [ssm-train] the SSM training path, ``repro_torch.launch.train`` on
     full mamba2-370m (48 layers, d_model 1024, random weights from seed
     0), W=4, batch 2, seq 512, --pipelined --wire-format int8, 8 steps,
     counters zeroed before and read after — B5 and B5b 48 times a step,
     B1r/B1a once — its steady step time and peak memory, the forward and
     backward of one step by CUDA events and its profile.
Then it prints the kernels' JSON line, the card's name and power limit,
and last the device JSON line.  Without a GPU, or without the repo's
sources beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import json
import math
import pathlib
import subprocess
import sys
import tempfile
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

W, R, P, BLOCK_ROWS = 4, 262848, 1, 64
ROW_RANGE = (61824, 133120)          # partition 1 of the main path's layout
EPS, LR = 0.05, 0.05
HBM_BYTES_PER_S = 3.35e12            # H100 SXM, NVIDIA data sheet
F32_FLOP_PER_S = 67e12               # f32 outside the tensor cores
TF32_FLOP_PER_S = 495e12             # TF32 on the tensor cores, dense
MAIN_STEPS = 8
PYTREE_STEPS = 8
TOL_REDUCE_RTOL = 1e-5               # sums in another order
TOL_APPLY_ATOL = 1e-6                # elementwise; the same op order
TOL_FUSED_ATOL = 1e-5                # fused vs unfused update: sums in
#                                      other orders, then one division
START_NOISE = 0.1                    # [check]: per-worker start offsets
ELASTIC_ROUNDS = 5                   # [elastic-check]
CHURN_DEAD, CHURN_ROUNDS = 2, (1, 2)  # [elastic-check]: worker 2 is down
#                                       in rounds 1-2


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


def pipelined_check(torch, device, arch, tag):
    """3 pipelined int8 steps of reduced ``arch`` on the GPU (kernels) and
    on the CPU (plain versions) from the same distinct worker starts,
    batches and draws: losses within rel 1e-4, n_good equal and not all 0,
    ensembles within atol 1e-4.  Returns (GPU losses, CPU losses, n_good,
    max |ensemble diff|, the GPU run's launch counts)."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model

    cfg = get_arch(arch).reduced()
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
        K.reset_launch_counts()
        for _ in range(3):
            tokens = torch.stack([torch.from_numpy(next(it)["tokens"])
                                  for it in its]).to(dev)
            packed, state, _, m = step(packed, state, 0, {"tokens": tokens},
                                       *G.draw_gossip_indices(draws, gcfg))
            out.append((float(m["loss"]), float(m["n_good"])))
        runs[str(dev)] = (out, packed.cpu(), K.launch_counts())
    (cpu, cpu_pk, _), (gpu, gpu_pk, counts) = runs["cpu"], runs[str(device)]
    for (lc, gc), (lg, gg) in zip(cpu, gpu):
        if abs(lg - lc) > 1e-4 * abs(lc) or gc != gg:
            raise AssertionError(f"{tag}: GPU (loss {lg}, n_good {gg}) vs "
                                 f"CPU (loss {lc}, n_good {gc})")
    err = float((gpu_pk - cpu_pk).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"{tag}: ensembles differ by {err:.3e}")
    check_admitted(tag, [g for _, g in gpu])
    return ([l for l, _ in gpu], [l for l, _ in cpu], [g for _, g in gpu],
            err, counts)


def phase_small_check(torch, device):
    gpu, cpu, n_good, err, _ = pipelined_check(torch, device, "smollm-135m",
                                               "small check")
    log(f"[check] reduced smollm, 3 pipelined int8 steps: GPU vs CPU "
        f"losses {[round(l, 6) for l in gpu]} vs "
        f"{[round(l, 6) for l in cpu]}, n_good {n_good}, "
        f"max |ensemble diff| {err:.3e}")


def main_argv(steps, workers=W):
    """The trainer's flags on the main path: full smollm-135m, pipelined,
    int8 wire, batch 2, seq 128."""
    return ["--arch", "smollm-135m", "--workers", str(workers),
            "--pipelined", "--wire-format", "int8", "--steps", str(steps),
            "--batch", "2", "--seq", "128", "--log-every", "1"]


def steady_median(step_seconds):
    """Median of a run's step times, the first (warm-up) left out."""
    steady = sorted(step_seconds[1:])
    return steady[len(steady) // 2]


def phase_main_path(torch):
    from repro_torch import kernels as K
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    argv = main_argv(MAIN_STEPS)
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
    median = steady_median(out["step_seconds"])
    log(f"[main] launches {counts} over {MAIN_STEPS} steps; step seconds "
        f"{[round(s, 4) for s in out['step_seconds']]} (first includes "
        f"warm-up); steady median {median * 1e3:.2f} ms; n_good "
        f"{out['n_good']}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del out
    torch.cuda.empty_cache()
    return counts, median


def churn_live(torch, t, device):
    """[elastic-check]'s schedule: worker CHURN_DEAD is down in the rounds
    CHURN_ROUNDS."""
    live = torch.ones(W, device=device)
    if t in CHURN_ROUNDS:
        live[CHURN_DEAD] = 0.0
    return live


def elastic_run(torch, cfg, step, init, gcfg, dev, schedule):
    """ELASTIC_ROUNDS steps of ``step`` from ``init(dev, elastic)`` with the
    same batches and draws on every device.  schedule: None (a legacy,
    non-elastic state), "ones" or "churn".  Returns (losses, n_good, state
    leaves on the CPU, whether the dead worker's rows stayed bitwise
    frozen in every round it was dead)."""
    from repro_torch.core.gossip import draw_gossip_indices
    from repro_torch.core.tree import flatten_sorted
    from repro_torch.launch.train import batch_iterators

    params, gossip = init(dev, schedule is not None)
    its = batch_iterators(cfg, W, 2, 32, 0)
    draws = torch.Generator().manual_seed(0)
    losses, n_good, frozen = [], [], True
    for t in range(ELASTIC_ROUNDS):
        tokens = torch.stack([torch.from_numpy(next(it)["tokens"])
                              for it in its]).to(dev)
        live = ()
        if schedule is not None:
            live = (churn_live(torch, t, dev) if schedule == "churn"
                    else torch.ones(W, device=dev),)
        dead = schedule == "churn" and t in CHURN_ROUNDS
        before = ([x[CHURN_DEAD].clone() for x in flatten_sorted(params)[0]]
                  if dead else None)
        params, gossip, _, m = step(params, gossip, 0, {"tokens": tokens},
                                    *draw_gossip_indices(draws, gcfg), *live)
        if dead:
            frozen &= all(torch.equal(a, x[CHURN_DEAD]) for a, x in
                          zip(before, flatten_sorted(params)[0]))
        losses.append(float(m["loss"]))
        n_good.append(float(m["n_good"]))
    return losses, n_good, [x.cpu() for x in flatten_sorted(params)[0]], \
        frozen


def ones_is_legacy(torch, cfg, init, grad_of, apply, gcfg, dev):
    """The engine ``apply`` on ``dev`` for ELASTIC_ROUNDS rounds, once on a
    legacy state and once on an elastic state with live = ones, from the
    same start, draws and per-round gradients (each taken once at the
    start state: a forward/backward repeated need not give the same bits,
    the engine does).  Returns whether states and gates agreed bitwise
    every round, and the admitted-message counts."""
    from repro_torch.core.gossip import draw_gossip_indices
    from repro_torch.core.tree import flatten_sorted
    from repro_torch.launch.train import batch_iterators

    start = init(dev, False)[0]
    its = batch_iterators(cfg, W, 2, 32, 0)
    grads = [grad_of(start, {"tokens": torch.stack([
        torch.from_numpy(next(it)["tokens"]) for it in its]).to(dev)})
        for _ in range(ELASTIC_ROUNDS)]
    runs = []
    for elastic in (False, True):
        params, gossip = init(dev, elastic)
        draws = torch.Generator().manual_seed(0)
        kw = {"live": torch.ones(W, device=dev)} if elastic else {}
        out = []
        for g in grads:
            params, gossip, m = apply(params, g, gossip,
                                      *draw_gossip_indices(draws, gcfg),
                                      **kw)
            out.append((flatten_sorted(params)[0], m["gate"]))
        runs.append(out)
    same = all(torch.equal(ga, gb) and all(
        torch.equal(a, b) for a, b in zip(la, lb))
        for (la, ga), (lb, gb) in zip(*runs))
    return same, [float(g.sum()) for _, g in runs[1]]


def phase_elastic_check(torch, device):
    """Elastic liveness on the reduced model, GPU against CPU: the pipelined
    int8 engine (B1r/B1a) and the pytree engine with use_fused (B2r/B2a),
    W=4, ELASTIC_ROUNDS train steps from distinct worker starts under the
    churn schedule, the same batches and draws on both devices: losses
    within rel 1e-4, n_good equal and not all 0, states within atol 1e-4;
    on the GPU the dead worker's rows bitwise frozen while it is dead, the
    engine's blend kernels launched every round (counters zeroed just
    before the churn run and read just after), and the engine on an
    elastic state with live = ones bitwise the legacy run
    (:func:`ones_is_legacy`)."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.gossip_blend.kernel import (APPLY, APPLY_W,
                                                         REDUCE, REDUCE_W)
    from repro_torch.launch.steps import (make_train_step,
                                          packed_loss_and_grad,
                                          tree_loss_and_grad)
    from repro_torch.models.model import init_model

    cfg = get_arch("smollm-135m").reduced()
    starts = worker_starts(torch, init_model(cfg, 0, device="cpu"))
    pipe_acfg, tree_acfg = ASGDConfig(eps=EPS), ASGDConfig(eps=EPS,
                                                           use_fused=True)
    pipe_cfg = G.GossipConfig(shifts=(1, 2), partial_blocks=4, delay=1,
                              wire_format="int8")
    spec = pack_spec_w(starts, block_rows=BLOCK_ROWS,
                       groups=G.leaf_groups(starts, 4), n_groups=4)

    def init_pipelined(dev, elastic):
        packed = pack_w(starts, spec).to(dev)
        return packed, G.init_pipelined_gossip_state(
            packed, pipe_cfg, block_rows=BLOCK_ROWS, elastic=elastic)

    tree_cfg = pytree_gcfg("leaves")

    def init_pytree(dev, elastic):
        wp = tree_map(lambda x: x.to(dev), starts)
        return wp, G.init_gossip_state(wp, tree_cfg, elastic=elastic)

    engines = (
        ("pipelined int8", make_train_step(
            cfg, pack_spec=spec, gcfg=pipe_cfg, acfg=pipe_acfg,
            pipelined=True), init_pipelined, pipe_cfg, (REDUCE, APPLY),
         lambda p, b: packed_loss_and_grad(cfg, p, b, spec)[1],
         lambda *a, **kw: G.asgd_gossip_apply_pipelined(
             *a, pipe_cfg, pipe_acfg, spec, **kw)),
        ("pytree use_fused", make_train_step(
            cfg, gcfg=tree_cfg, acfg=tree_acfg), init_pytree, tree_cfg,
         (REDUCE_W, APPLY_W),
         lambda p, b: tree_loss_and_grad(cfg, p, b)[1],
         lambda *a, **kw: G.asgd_gossip_apply(*a, tree_cfg, tree_acfg,
                                              **kw)))
    for name, step, init, gcfg, kernels, grad_of, apply in engines:
        cpu = elastic_run(torch, cfg, step, init, gcfg, "cpu", "churn")
        K.reset_launch_counts()
        gpu = elastic_run(torch, cfg, step, init, gcfg, device, "churn")
        torch.cuda.synchronize()
        counts = K.launch_counts()
        for lc, lg in zip(cpu[0], gpu[0]):
            if abs(lg - lc) > 1e-4 * abs(lc):
                raise AssertionError(f"elastic check {name}: GPU loss {lg} "
                                     f"vs CPU {lc}")
        if gpu[1] != cpu[1]:
            raise AssertionError(f"elastic check {name}: n_good GPU "
                                 f"{gpu[1]} vs CPU {cpu[1]}")
        err = max(float((a - b).abs().max()) for a, b in zip(gpu[2], cpu[2]))
        if not err <= 1e-4:
            raise AssertionError(f"elastic check {name}: states differ by "
                                 f"{err:.3e}")
        if not gpu[3]:
            raise AssertionError(f"elastic check {name}: worker "
                                 f"{CHURN_DEAD}'s rows moved while it was "
                                 f"dead")
        for k in kernels:
            if counts.get(k, 0) != ELASTIC_ROUNDS:
                raise AssertionError(
                    f"elastic check {name}: {k} launched "
                    f"{counts.get(k, 0)} times in {ELASTIC_ROUNDS} gossip "
                    f"rounds: {counts}")
        check_admitted(f"elastic check {name}", gpu[1])
        same, ones_good = ones_is_legacy(torch, cfg, init, grad_of, apply,
                                         gcfg, device)
        if not same:
            raise AssertionError(f"elastic check {name}: live = ones is not "
                                 f"bitwise the legacy run")
        check_admitted(f"elastic check {name} (live = ones)", ones_good)
        log(f"[elastic-check] reduced smollm, {ELASTIC_ROUNDS} {name} "
            f"steps, worker {CHURN_DEAD} dead in rounds {CHURN_ROUNDS}: GPU "
            f"vs CPU losses {[round(x, 6) for x in gpu[0]]} vs "
            f"{[round(x, 6) for x in cpu[0]]}, n_good {gpu[1]}, max |state "
            f"diff| {err:.3e}; dead rows bitwise frozen; launches {counts}; "
            f"engine with live = ones bitwise the legacy run (n_good "
            f"{ones_good})")


def phase_ckpt(torch, path):
    """--save on the main path (3 steps), the file restored into a fresh
    state of the same shape (packed ensemble, int8 FIFO and its scales
    bitwise), then --restore to 5 steps: B1r/B1a twice each (counters
    zeroed just before and read just after).  Prints the file size, the
    save and restore seconds and the host's peak RSS."""
    import os
    import resource
    from repro_torch import kernels as K
    from repro_torch.checkpoint import load_checkpoint_packed
    from repro_torch.core import gossip as G
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    argv = main_argv(3) + ["--save", path]
    log(f"[ckpt] python -m repro_torch.launch.train {' '.join(argv)}")
    peak_before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    out = train.main(argv)
    size, t_save = os.path.getsize(path), out["save_seconds"]
    saved, spec = out["state"], out["spec"]
    like = {"params": torch.zeros_like(saved["params"]),
            "gossip": G.init_pipelined_gossip_state(
                saved["params"], train.gossip_config(W, wire_format="int8"),
                block_rows=BLOCK_ROWS), "opt": 0, "step": 0}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    back = load_checkpoint_packed(path, like, spec)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t0
    g, g0 = back["gossip"], saved["gossip"]
    same = (torch.equal(back["params"], saved["params"])
            and back["step"] == saved["step"] == 3
            and (g.buf_idx, g.step) == (g0.buf_idx, g0.step)
            and all(torch.equal(a, b) for a, b in zip(g.buf, g0.buf))
            and all(torch.equal(a, b) for a, b in zip(g.buf_scales,
                                                      g0.buf_scales)))
    if not same:
        raise AssertionError("ckpt: the restored state is not bitwise the "
                             "saved one")
    del out, saved, like, back, g, g0
    torch.cuda.empty_cache()
    argv = main_argv(5) + ["--restore", path]
    log(f"[ckpt] python -m repro_torch.launch.train {' '.join(argv)}")
    K.reset_launch_counts()
    res = train.main(argv)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if len(res["losses"]) != 2 or not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"ckpt resume: losses {res['losses']}")
    for name in (REDUCE, APPLY):
        if counts.get(name, 0) != 2:
            raise AssertionError(f"ckpt resume: {name} launched "
                                 f"{counts.get(name, 0)} times in 2 rounds: "
                                 f"{counts}")
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20
    log(f"[ckpt] file {size} bytes ({size / 2**30:.3f} GiB); save "
        f"{t_save:.3f} s; round trip into a fresh state "
        f"{t_load:.3f} s (device synced), bitwise: packed ensemble, int8 "
        f"FIFO, scales, buf_idx, step; resume from step 3: restore "
        f"{res['restore_seconds']:.3f} s, losses "
        f"{[round(x, 4) for x in res['losses']]}, launches {counts}; host "
        f"peak RSS {peak:.2f} GiB ({peak_before:.2f} before the phase)")
    del res
    torch.cuda.empty_cache()


def phase_elastic(torch, path, main_ms):
    """--restore of [ckpt]'s W=4 file with --elastic at W=2 to step 6: the
    first delay + 1 = 2 rounds admit nothing (the join window), B1r/B1a
    every round (counters zeroed just before and read just after), losses
    finite, the final average at full width.  Then the main path at W=4
    from scratch, legacy and elastic (live = ones every step) in turns
    (legacy, elastic, elastic, legacy), B1r/B1a every round of each: their
    steady step times beside [main]'s."""
    from repro_torch import kernels as K
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    argv = main_argv(6, workers=2) + ["--restore", path, "--elastic"]
    log(f"[elastic] python -m repro_torch.launch.train {' '.join(argv)}")
    K.reset_launch_counts()
    res = train.main(argv)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    rounds = len(res["losses"])
    if rounds != 3 or not all(map(math.isfinite, res["losses"])):
        raise AssertionError(f"elastic: losses {res['losses']}")
    if res["n_good"][:2] != [0.0, 0.0]:
        raise AssertionError(f"elastic: the join window admitted messages: "
                             f"n_good {res['n_good']}")
    for name in (REDUCE, APPLY):
        if counts.get(name, 0) != rounds:
            raise AssertionError(f"elastic: {name} launched "
                                 f"{counts.get(name, 0)} times in {rounds} "
                                 f"rounds: {counts}")
    wq = res["params"]["scan"]["pos0"]["attn"]["wq"]
    if (tuple(wq.shape) != (2,) + wq_shape()[1:]
            or not bool(torch.isfinite(wq).all())):
        raise AssertionError(f"elastic: final average wq {tuple(wq.shape)} "
                             f"not finite/shaped")
    log(f"[elastic] W 4 -> 2 from step 3: restore "
        f"{res['restore_seconds']:.3f} s, losses "
        f"{[round(x, 4) for x in res['losses']]}, n_good {res['n_good']} "
        f"(join window: rounds 3-4), launches {counts}, final average wq "
        f"{tuple(wq.shape)}")
    del res
    torch.cuda.empty_cache()
    medians = {"legacy": [], "elastic": []}
    for run in ("legacy", "elastic", "elastic", "legacy"):
        argv = main_argv(MAIN_STEPS) + (["--elastic"] if run == "elastic"
                                        else [])
        K.reset_launch_counts()
        res = train.main(argv)
        torch.cuda.synchronize()
        counts = K.launch_counts()
        for name in (REDUCE, APPLY):
            if counts.get(name, 0) != MAIN_STEPS:
                raise AssertionError(f"elastic W={W} {run}: {name} launched "
                                     f"{counts.get(name, 0)} times in "
                                     f"{MAIN_STEPS} rounds: {counts}")
        if not all(map(math.isfinite, res["losses"])):
            raise AssertionError(f"elastic W={W} {run}: losses "
                                 f"{res['losses']}")
        medians[run].append(steady_median(res["step_seconds"]) * 1e3)
        log(f"[elastic] W={W} {run} (train.main {' '.join(argv)}): step "
            f"seconds {[round(x, 4) for x in res['step_seconds']]}; "
            f"launches {counts}")
        del res
        torch.cuda.empty_cache()
    log(f"[elastic] W={W}, {MAIN_STEPS} steps each, in turns legacy, "
        f"elastic, elastic, legacy: steady medians legacy "
        f"{[round(x, 2) for x in medians['legacy']]} ms, elastic (live = "
        f"ones) {[round(x, 2) for x in medians['elastic']]} ms; [main] "
        f"{main_ms * 1e3:.2f} ms")


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
    # the same two halves on an elastic state with live = ones: the cost
    # of the liveness masks
    ones = torch.ones(W, device=device)
    elastic = G.PackedGossipState(buf=state.buf, buf_idx=(1, 1), step=2,
                                  buf_scales=state.buf_scales,
                                  buf_live=(ones, ones))
    t_ex_l = cuda_ms(lambda: G.initiate_exchange_packed(
        packed, 0, 1, gcfg, spec, live=ones), 5)
    t_bl_l = cuda_ms(lambda: G.consume_exchange_packed(
        packed, pgrads, elastic, state.buf[1], state.buf_scales[1], 1, gcfg,
        acfg, spec, sent_live=ones, live=ones), 5)
    log(f"[breakdown] elastic, live = ones: exchange {t_ex_l:.3f} ms "
        f"({t_ex_l - t_ex:+.3f}), blend {t_bl_l:.3f} ms "
        f"({t_bl_l - t_bl:+.3f}) by CUDA events")

    # device busy share of one whole train step, from a profiler trace
    step = make_train_step(cfg, pack_spec=spec, gcfg=gcfg, acfg=acfg,
                           pipelined=True)
    batch = {"tokens": tokens}
    profile_step(torch, "profile", lambda: step(packed, state, 0, batch, 0,
                                                1))


def profile_step(torch, tag, run, what="one step", group=None):
    """Wall time, device busy time and idle share of one call of ``run``
    (after a warm-up call), and the top device kernels, from a
    torch.profiler trace; with ``group`` = (label, name parts), the summed
    device time of the kernels whose names hold one of the parts, and its
    share of the device busy time."""
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
        if group:
            us = sum(t for n, t in by_name.items()
                     if any(part in n for part in group[1]))
            log(f"[{tag}] {group[0]}: {us / 1e3:.3f} ms of device time, "
                f"{us / busy:.1%} of the device busy time")
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
B4_KERNELS = ("assign_stream_kernel", "assign_partial_kernel",
              "finalize_kernel")     # B4's device kernels, by name
# B4's shapes: (case, W or None for a shared x, M, K, D)
B4_SHAPES = (("batch", None, KM_M, KM_K, KM_D),    # run_batch's E/M step
             ("round", KM_W, KM_B, KM_K, KM_D),    # one round's W gradients
             ("k100", None, 10**7, 100, KM_D),     # Fig. 7's largest k
             ("envelope", None, 2**20, 1024, 128))  # the TPU's VMEM note


def device_ms(torch, run, parts, reps):
    """Device milliseconds per call of ``run`` (after a warm-up call) summed
    over the kernels whose names hold one of ``parts``, their device
    launches per call, and the parts that ran, from a torch.profiler trace
    of ``reps`` calls; None when the trace holds no such device events."""
    run()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        # a throwaway first launch: after earlier traces in the process the
        # profiler drops a session's first device event
        torch.zeros(1, device="cuda")
        torch.cuda.synchronize()
        for _ in range(reps):
            run()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and any(part in e.name for part in parts)]
    if not events:
        return None
    ran = tuple(part for part in parts if any(part in e.name for e in events))
    return (sum(e.time_range.end - e.time_range.start for e in events)
            / reps / 1e3, len(events) / reps, ran)


def b4_kernel_ran(dev):
    """Which of B4's two kernels a device_ms trace saw run."""
    if dev is None:
        return "no kernel traced"
    return " and ".join(n for n in dev[2] if n != "finalize_kernel")


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
    """B4 at its four shapes (BATCH, round, Fig. 7's k = 100, envelope) and
    at M = 2^25 + 3, K = 1 (count exactness); B6r/B6a on one flattened
    smollm-135m replica with the gate open and shut — each against its
    plain version."""
    from repro_torch.kernels.kmeans_assign.kernel import kmeans_assign_w
    from repro_torch.kernels.kmeans_assign.ref import kmeans_assign_plain
    from repro_torch.kernels.parzen_blend.kernel import (parzen_apply,
                                                         parzen_reduce)
    from repro_torch.kernels.parzen_blend.ref import (parzen_apply_plain,
                                                      parzen_reduce_plain)
    from repro_torch.core.parzen import gate_from_terms

    results = {}
    g = torch.Generator(device=device).manual_seed(3)
    for case, wn, m, k, d in B4_SHAPES:
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
        # the kernel this shape ran, as the profiler saw it; at the round
        # shape also the device time of B4's two launches alone, since
        # back-to-back calls time the wrapper's host side too
        reps = 20 if case == "round" else 3
        dev = device_ms(torch, run, B4_KERNELS, reps)
        time_pass(torch, results, ("B4", case),
                  f"B4 {case:8s} W={nw} M={m} K={k} D={d}", run, plain, err,
                  x.numel() * 4 + nw * m * 4 + w.numel() * 4
                  + nw * k * (d + 1) * 4, 2 * nw * m * k * d,
                  f" (idx flips {flips} among {near} near ties, sums within "
                  f"{TOL_SUMS_RTOL} of f64, bitwise repeatable; ran "
                  f"{b4_kernel_ran(dev)})")
        if case == "round":
            log(f"[kernels] B4 round: "
                + (f"{dev[0]:.4f} ms of device time a call ({dev[1]:.2f} "
                   f"device launches: {' and '.join(dev[2])}, "
                   f"torch.profiler over {reps} calls)" if dev else
                   "device time not measured (no device events traced)")
                + f" against {results[('B4', case)]['ms']:.4f} ms a call "
                f"by CUDA events over back-to-back calls")
        del x, w, out
        torch.cuda.empty_cache()
    x = torch.randn((COUNT_M, 4), generator=g, device=device)
    w = torch.zeros((1, 1, 4), device=device)
    counts = kmeans_assign_w(x, w)[2]
    torch.cuda.synchronize()
    if float(counts[0]) != float(torch.tensor(COUNT_M, dtype=torch.float32)):
        raise AssertionError(f"B4 counts: {float(counts[0])} for M={COUNT_M}")
    dev = device_ms(torch, lambda: kmeans_assign_w(x, w), B4_KERNELS, 3)
    log(f"[kernels] B4 counts at M={COUNT_M}, K=1: {float(counts[0]):.1f} "
        f"== float32(M) (an f32 sum of ones would stop at 16777216; "
        f"ran {b4_kernel_ran(dev)})")
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
            not errs_b[-1] < errs_b[0] or \
            c.get(ASSIGN, 0) != 2 * KM_BATCH_ITERS:
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


# ---------------------------------------------------------------------------
# the serving slice: B5 (ssd_scan) and the serve path
# ---------------------------------------------------------------------------

SSD_SHAPE = (4, 2048, 32, 64, 128, 128)   # mamba2-370m serve: Bb S H P N Q
SSD_PAD_S = 2000                          # padded to 2048 by ops.ssd_scan
TOL_SSD = 1e-4                            # of the result's largest magnitude
SSD_KERNEL_NAMES = ("chunk_prep", "chunk_state", "chunk_out")   # B5's stages
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SMOLLM_PROMPT = 2048                      # FLASH_MIN_SEQ: attention_flash
TOL_SERVE = 1e-4                          # GPU vs CPU, of the largest
#                                           magnitude (bf16 KV leaves 1e-2)


def ssd_operands(torch, device, Bb, S, H, P, N, seed=5):
    """The mixer's inputs, drawn like the model's: x, B, C standard normal;
    dt = softplus(randn + dt_bias 0); A = -exp(A_log) with A_log =
    log(linspace(1, 16, H)), the init's, for every row."""
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn((Bb, S, H, P), generator=g, device=device)
    dt = torch.nn.functional.softplus(
        torch.randn((Bb, S, H), generator=g, device=device))
    a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
    A = (-torch.exp(a_log)).expand(Bb, H).contiguous()
    B = torch.randn((Bb, S, N), generator=g, device=device)
    C = torch.randn((Bb, S, N), generator=g, device=device)
    return x, dt, A, B, C


def ssd_check(torch, name, out, out_p, repeat=None):
    """y and h within TOL_SSD of the plain version's largest magnitude,
    finite; with ``repeat``, two more launches bitwise equal.  Returns
    (max abs err, max rel err over |ref| >= 1e-3 max|ref|, max|ref|) for y,
    then for h."""
    errs = []
    for what, a, b in (("y", out[0], out_p[0]), ("h", out[1], out_p[1])):
        scale = float(b.abs().max())
        diff = (a - b).abs()
        err = float(diff.max())
        big = b.abs() >= 1e-3 * scale
        rel = float((diff[big] / b.abs()[big]).max())
        if not bool(torch.isfinite(a).all()) or not err <= TOL_SSD * scale:
            raise AssertionError(f"{name} {what}: kernel vs plain max abs err "
                                 f"{err:.3e} > {TOL_SSD} x {scale:.3e}")
        errs += [err, rel, scale]
    if repeat is not None:
        for _ in range(2):
            again = repeat()
            if not all(torch.equal(p, q) for p, q in zip(again, out)):
                raise AssertionError(f"{name}: not reproducible")
    return errs


def ssd_cancelling(torch, device, Bb, S, H, P, N, seed=7):
    """x alternating in sign along S over B and C that share a large
    constant component plus small noise, dt near constant, slow decay: y is
    ~1% of its terms, so products that keep only TF32's ~3 digits miss the
    TOL_SSD gate."""
    g = torch.Generator(device=device).manual_seed(seed)
    sign = (-1.0) ** torch.arange(S, device=device)
    x = sign[None, :, None, None] * (1 + 0.1 * torch.randn(
        (Bb, S, H, P), generator=g, device=device))
    dt = 0.05 + 0.001 * torch.rand((Bb, S, H), generator=g, device=device)
    A = (-0.01 * torch.linspace(1.0, 4.0, H, device=device)).expand(
        Bb, H).contiguous()
    B = 1.0 + 0.01 * torch.randn((Bb, S, N), generator=g, device=device)
    C = 1.0 + 0.01 * torch.randn((Bb, S, N), generator=g, device=device)
    return x, dt, A, B, C


def phase_ssd_kernel(torch, device):
    """B5 against its plain version at the serve shape (contiguous, and as
    views of a conv output), at a padded S, at the decay extremes and on a
    cancelling input."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_chunked
    from repro_torch.kernels.ssd_scan.kernel import SCAN, _library
    from repro_torch.kernels.ssd_scan.ops import pad_to_chunk
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain

    Bb, S, H, P, N, Q = SSD_SHAPE
    ops = ssd_operands(torch, device, Bb, S, H, P, N)
    run = lambda: ssd_scan_chunked(*ops, Q)                  # noqa: E731
    plain = lambda: ssd_scan_plain(*ops, Q)                  # noqa: E731
    K.reset_launch_counts()
    out = run()
    torch.cuda.synchronize()
    if K.launch_counts() != {SCAN: 1}:
        raise AssertionError(f"B5: counted {K.launch_counts()} for one call")
    out_p = plain()
    torch.cuda.synchronize()
    ey, ry, sy, eh, rh, sh = ssd_check(torch, "B5/serve", out, out_p, run)
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(plain, 5)
    # bytes: x, dt, A, B, C once, y and h once.  Operations (multiply-adds
    # count 2), the least the function needs: C.B^T's lower triangle once
    # per row (the heads share B and C), per head the triangle times xdt,
    # C.h and the state update.  The kernel's route: three TF32 products
    # for each product on the tensor cores
    nc = S // Q
    n_bytes = 4 * (2 * Bb * S * H * P + Bb * S * H + Bb * H + 2 * Bb * S * N
                   + Bb * H * N * P)
    n_flops = (Bb * nc * Q * (Q + 1) * N
               + Bb * H * nc * (Q * (Q + 1) * P + 4 * Q * N * P))
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    simt_ms = max(t_bytes, n_flops / F32_FLOP_PER_S * 1e3)
    tc_ms = max(t_bytes, 3 * n_flops / TF32_FLOP_PER_S * 1e3)
    log(f"[kernels] B5 Bb={Bb} S={S} H={H} P={P} N={N} chunk={Q}: kernel "
        f"{ms:.4f} ms ({_library().ssd_launches()} device launches a call), "
        f"plain {plain_ms:.4f} ms; bound {tc_ms:.4f} ms on the tensor cores "
        f"in split TF32 (3 x {n_flops / 1e9:.2f} GFLOP of TF32), "
        f"{tc_ms / ms:.1%} of it; {simt_ms:.4f} ms in f32 SIMT, "
        f"{simt_ms / ms:.1%} of it; bytes {n_bytes / 1e9:.3f} GB, "
        f"{t_bytes:.4f} ms; y max abs err {ey:.3e} (rel {ry:.3e}, max|y| "
        f"{sy:.3e}), h {eh:.3e} (rel {rh:.3e}, max|h| {sh:.3e}); within "
        f"{TOL_SSD} of max|plain|, bitwise repeatable")
    results = {("B5", "serve"): {"ms": ms, "plain_ms": plain_ms,
                                 "bound_ms": tc_ms, "bound_by": "operations",
                                 "max_abs_err": ey}}
    del out, out_p

    # the model's layout: x, B and C as views of one conv output
    g = torch.Generator(device=device).manual_seed(6)
    xbc = torch.randn((Bb, S, H * P + 2 * N), generator=g, device=device)
    xv = xbc[..., :H * P].reshape(Bb, S, H, P)
    Bv, Cv = xbc[..., H * P:H * P + N], xbc[..., H * P + N:]
    dts, As = ops[1], ops[2]
    strided = lambda: ssd_scan(xv, dts, As, Bv[:, :, None],  # noqa: E731
                               Cv[:, :, None], chunk=Q)
    out = strided()
    ref = ssd_scan_chunked(xv.contiguous(), dts, As, Bv.contiguous(),
                           Cv.contiguous(), Q)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(out, ref)):
        raise AssertionError("B5: strided operands differ from contiguous")
    log(f"[kernels] B5 strided (x, B, C views of a (Bb, S, {H * P + 2 * N}) "
        f"conv output, read in place): {cuda_ms(strided, 20):.4f} ms, "
        f"bitwise equal to contiguous copies")
    del xbc, xv, Bv, Cv, out, ref

    xs, dts, _, Bs, Cs = (t[:, :SSD_PAD_S] if t.ndim > 2 else t for t in ops)
    out = ssd_scan(xs, dts, ops[2], Bs[:, :, None], Cs[:, :, None], chunk=Q)
    xp, dtp, Bp, Cp = pad_to_chunk(xs, dts, Bs, Cs, Q)
    y_p, h_p = ssd_scan_plain(xp, dtp, ops[2], Bp, Cp, Q)
    torch.cuda.synchronize()
    ey, _, _, eh, _, _ = ssd_check(torch, "B5/padded", out,
                                   (y_p[:, :SSD_PAD_S], h_p))
    log(f"[kernels] B5 padded S={SSD_PAD_S} -> {xp.shape[1]} through "
        f"ops.ssd_scan: y max abs err {ey:.3e}, h {eh:.3e}")
    del ops, xs, dts, Bs, Cs, xp, dtp, Bp, Cp, out, y_p, h_p
    ones = torch.ones((1, 64, 2, 4), device=device)
    ext = (ones, torch.full((1, 64, 2), 1e-4, device=device),
           torch.tensor([[-100.0, -1e-3]], device=device),
           torch.ones((1, 64, 8), device=device),
           torch.ones((1, 64, 8), device=device))
    ey, _, _, eh, _, _ = ssd_check(torch, "B5/extremes",
                                   ssd_scan_chunked(*ext, 32),
                                   ssd_scan_plain(*ext, 32))
    log(f"[kernels] B5 decay extremes (A -100 and -1e-3, dt 1e-4): finite, "
        f"y max abs err {ey:.3e}, h {eh:.3e}")

    ops = ssd_cancelling(torch, device, Bb, 512, H, P, N)
    out, out_p = ssd_scan_chunked(*ops, Q), ssd_scan_plain(*ops, Q)
    torch.cuda.synchronize()
    ssd_check(torch, "B5/cancelling", out, out_p)
    split = [float((a - b).abs().max()) / float(b.abs().max())
             for a, b in zip(out, out_p)]
    log(f"[kernels] B5 cancelling sums (S=512, max|y| "
        f"{float(out_p[0].abs().max()):.3e}): split TF32 y, h max abs err "
        f"{split[0]:.3e}, {split[1]:.3e} of max|plain| (gate {TOL_SSD})")
    del ops, out, out_p
    torch.cuda.empty_cache()
    return results


def serve_run(torch, cfg, params, tokens, dev, steps):
    """Prefill, then ``steps`` decode steps fed the greedy tokens of
    ``tokens['greedy']`` when given (else this run's own).  Returns
    (logits per step on the CPU, greedy tokens, final cache on the CPU)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models import model as M
    p = tree_map(lambda x: x.to(dev), params)
    prompt = tokens["prompt"].to(dev)
    with torch.no_grad():
        last, cache = M.prefill(cfg, p, {"tokens": prompt},
                                cache_len=prompt.shape[1] + steps)
        logits, greedy = [last.cpu()], []
        for i in range(steps):
            tok = (tokens["greedy"][i] if "greedy" in tokens
                   else logits[-1].argmax(-1))
            greedy.append(logits[-1].argmax(-1))
            step, cache = M.decode_step(cfg, p, tok.to(dev),
                                        prompt.shape[1] + i, cache)
            logits.append(step.cpu())
    return logits, greedy, tree_map(lambda x: x.cpu(), cache)


def phase_serve_check(torch, device):
    """Reduced mamba2-370m and smollm-135m (prompts of 32, and smollm's of
    2048 too: its 'G' layers then take attention_flash), the same CPU-made
    weights and prompts on the GPU (B5 in every 'S' layer) and the CPU
    (plain): the prefill's and 4 decode steps' logits within TOL_SERVE of
    their largest magnitude, the greedy tokens equal wherever the CPU's
    top-2 margin exceeds twice that, and every cache leaf close."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree import flatten_sorted
    from repro_torch.models.model import init_model

    for arch, plen in (("mamba2-370m", 32), ("smollm-135m", 32),
                       ("smollm-135m", SMOLLM_PROMPT)):
        cfg = get_arch(arch).reduced()
        params = init_model(cfg, 0, device="cpu")
        prompt = torch.randint(0, cfg.vocab, (2, plen),
                               generator=torch.Generator().manual_seed(1))
        cpu = serve_run(torch, cfg, params, {"prompt": prompt}, "cpu", 4)
        K.reset_launch_counts()
        gpu = serve_run(torch, cfg, params, {"prompt": prompt,
                                             "greedy": cpu[1]}, device, 4)
        counts = K.launch_counts()
        want = cfg.n_layers if arch == "mamba2-370m" else 0
        if counts.get("ssd_scan", 0) != want:
            raise AssertionError(f"serve check {arch}: launches {counts}")
        errs, near = [], 0
        for lc, lg in zip(cpu[0], gpu[0]):
            scale = float(lc.abs().max())
            err = float((lg - lc).abs().max())
            if not err <= TOL_SERVE * scale:
                raise AssertionError(f"serve check {arch}: logits differ by "
                                     f"{err:.3e} > {TOL_SERVE} x {scale:.3e}")
            errs.append(err)
            top = torch.topk(lc, 2, dim=-1).values
            clear = (top[:, 0] - top[:, 1]) > 2 * TOL_SERVE * scale
            near += int((~clear).sum())
            if not bool((lg.argmax(-1) == lc.argmax(-1))[clear].all()):
                raise AssertionError(f"serve check {arch}: greedy tokens "
                                     f"differ off a near-tie")
        cache_err = 0.0
        for a, b in zip(flatten_sorted(gpu[2])[0], flatten_sorted(cpu[2])[0]):
            tol = 1e-2 if b.dtype == torch.bfloat16 else TOL_SERVE
            d = float((a.float() - b.float()).abs().max())
            if not d <= tol * max(float(b.float().abs().max()), 1e-30):
                raise AssertionError(f"serve check {arch}: a cache leaf "
                                     f"differs by {d:.3e}")
            cache_err = max(cache_err, d)
        log(f"[serve-check] reduced {arch}, batch 2, prompt {plen}, 4 decode "
            f"steps: GPU vs CPU logits max abs err "
            f"{[float(f'{e:.3e}') for e in errs]}, greedy tokens equal "
            f"({near} near ties), cache leaves max abs err {cache_err:.3e}; "
            f"launches {counts}")


def serve_timings(torch, cfg, params, batch):
    """Two ``serve.generate`` runs (warm-up, steady) of SERVE_NEW tokens."""
    from repro_torch.launch import serve
    prompt = batch["tokens"].shape[1]
    for label in ("warm-up", "steady"):
        _, t = serve.generate(cfg, params, batch, prompt, SERVE_NEW)
        log(f"[serve] {cfg.name} generate ({label}): prefill "
            f"{t['prefill_ms']:.3f} ms, decode {t['decode_ms_per_token']:.3f}"
            f" ms per token, {SERVE_BATCH * t['steps_per_s']:.1f} tokens/s "
            f"decoded, {SERVE_BATCH * prompt / t['prefill_ms'] * 1e3:.0f} "
            f"prompt tokens/s")


def phase_serve(torch, device):
    """``launch.serve.main`` on full mamba2-370m (counters zeroed before,
    read after: B5 once per 'S' layer of the one prefill, none in decode),
    the per-phase counts, the steady prefill and decode times, a profile
    of one prefill and of one decode step; then ``serve.main`` and the
    steady times on full smollm-135m.  Returns the mamba2 run's counts."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan.kernel import SCAN
    from repro_torch.launch import serve
    from repro_torch.models import blocks
    from repro_torch.models import model as M

    cfg = get_arch("mamba2-370m")
    argv = ["--arch", "mamba2-370m", "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SERVE_PROMPT), "--new-tokens",
            str(SERVE_NEW)]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    toks = serve.main(argv)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"serve: tokens {tuple(toks.shape)} "
                             f"{toks[0].tolist()}")
    if counts.get(SCAN, 0) != cfg.n_layers:
        raise AssertionError(f"serve: {SCAN} launched {counts.get(SCAN, 0)} "
                             f"times in one prefill + {SERVE_NEW - 1} decode "
                             f"steps of {cfg.n_layers} 'S' layers: {counts}")
    log(f"[serve] launches {counts}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

    params = M.init_model(cfg, 0, device=device)
    tokens = torch.randint(0, cfg.vocab, (SERVE_BATCH, SERVE_PROMPT),
                           device=device, generator=torch.Generator(
                               device=device).manual_seed(1))
    batch = {"tokens": tokens}
    cache_len = SERVE_PROMPT + SERVE_NEW
    with torch.no_grad():
        K.reset_launch_counts()
        last, cache = M.prefill(cfg, params, batch, cache_len=cache_len)
        torch.cuda.synchronize()
        pre = K.launch_counts()
        K.reset_launch_counts()
        tok = last.argmax(-1)
        for i in range(4):
            logits, cache = M.decode_step(cfg, params, tok, SERVE_PROMPT + i,
                                          cache)
            tok = logits.argmax(-1)
        torch.cuda.synchronize()
        dec = K.launch_counts()
        if pre.get(SCAN, 0) != cfg.n_layers or dec.get(SCAN, 0) != 0 or \
                not bool(torch.isfinite(logits).all()):
            raise AssertionError(f"serve: per-phase launches prefill {pre}, "
                                 f"4 decode steps {dec}")
        del last, cache, logits
    log(f"[serve] launches per prefill {pre}, in 4 decode steps {dec}")
    serve_timings(torch, cfg, params, batch)
    with torch.no_grad():
        profile_step(torch, "serve-profile", lambda: M.prefill(
            cfg, params, batch, cache_len=cache_len), what="one prefill",
            group=("B5 (ssd_scan)", SSD_KERNEL_NAMES))
        _, cache = M.prefill(cfg, params, batch, cache_len=cache_len)
        tok = tokens[:, -1]
        profile_step(torch, "serve-profile", lambda: M.decode_step(
            cfg, params, tok, SERVE_PROMPT, cache), what="one decode step")
    del params, tokens, batch, cache
    torch.cuda.empty_cache()

    cfg = get_arch("smollm-135m")
    argv = ["--arch", "smollm-135m", "--batch", str(SERVE_BATCH),
            "--prompt-len", str(SMOLLM_PROMPT), "--new-tokens",
            str(SERVE_NEW)]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    with count_calls(blocks, "attention_flash") as flash:
        toks = serve.main(argv)
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW) or \
            len(flash) != cfg.n_layers:
        raise AssertionError(f"serve smollm: tokens {tuple(toks.shape)}, "
                             f"attention_flash called {len(flash)} times "
                             f"for {cfg.n_layers} 'G' layers of a prefill")
    log(f"[serve] smollm-135m: attention_flash {len(flash)} calls (one per "
        f"'G' layer of the {SMOLLM_PROMPT}-token prefill); peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    params = M.init_model(cfg, 0, device=device)
    serve_timings(torch, cfg, params, {"tokens": torch.randint(
        0, cfg.vocab, (SERVE_BATCH, SMOLLM_PROMPT), device=device,
        generator=torch.Generator(device=device).manual_seed(1))})
    del params
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# the SSM training slice: B5b (the SSD scan's backward) and mamba2-370m
# training; the serving phases above take smollm-135m's attention_flash
# ---------------------------------------------------------------------------

SSD_TRAIN_SHAPE = (8, 512, 32, 64, 128, 128)   # W 4 x batch 2, seq 512
SSD_BWD_NAMES = ("walk_bwd", "head_bwd", "bc_finish", "final_bwd")  # B5b's
GRAD_NAMES = ("dx", "ddt", "dA", "dB", "dC")
SSM_TRAIN_STEPS, SSM_TRAIN_SEQ = 8, 512


@contextlib.contextmanager
def count_calls(module, name):
    """Counts the calls of ``module.name`` inside the block (a list, one
    entry a call) and restores it after."""
    real, calls = getattr(module, name), []

    def counted(*a, **k):
        calls.append(1)
        return real(*a, **k)

    setattr(module, name, counted)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def ssd_bwd_check(torch, name, got, ref, repeat=None):
    """Each of B5b's five gradients within TOL_SSD of the plain backward's
    largest magnitude, finite; with ``repeat``, two more launches bitwise
    equal.  Returns {gradient: (max abs err, err / max|plain|)}."""
    errs = {}
    for what, a, b in zip(GRAD_NAMES, got, ref):
        scale = float(b.abs().max())
        err = float((a - b).abs().max())
        if not bool(torch.isfinite(a).all()) or not err <= TOL_SSD * scale:
            raise AssertionError(f"{name} {what}: kernel vs plain max abs "
                                 f"err {err:.3e} > {TOL_SSD} x {scale:.3e}")
        errs[what] = (err, err / scale)
    if repeat is not None:
        for _ in range(2):
            if not all(torch.equal(p, q) for p, q in zip(repeat(), got)):
                raise AssertionError(f"{name}: not reproducible")
    return errs


def ssd_bwd_work(Bb, S, H, P, N, Q):
    """(bytes, operations) the SSD scan's gradient needs: x, dt, A, B, C,
    dy and d h_final read once, dx, ddt, dA, dB, dC written once; the
    multiply-adds (2 operations each) of the products, none twice: the
    state walk (chunks 1..nc-1), per (b, c, h) dy_i.xdt_j and its product
    with dy over the triangle, B.dh_c and dh_c.xdt, h_prev.dy (chunks
    1..nc-1: h_prev of chunk 0 is zero), per (b, c) the triangle's sums
    over B and C."""
    nc = S // Q
    n_bytes = 4 * (3 * Bb * S * H * P + 2 * Bb * S * H + 2 * Bb * H
                   + 4 * Bb * S * N + Bb * H * N * P)
    macs = (Bb * H * ((nc - 1) * 2 * Q * N * P
                      + nc * (Q * (Q + 1) * P + 2 * Q * N * P))
            + Bb * nc * Q * (Q + 1) * N)
    return n_bytes, 2 * macs


def phase_ssd_bwd_kernel(torch, device):
    """B5b against the plain backward at the training shape, on the same
    inputs (B5's saved L and h_prev): a random input, a cancelling one and
    x, B, C as views of a conv output; through autograd once (one B5 and
    one B5b launch, the gradients bitwise the direct call's)."""
    from repro_torch import kernels as K
    from repro_torch.kernels.ssd_scan import ssd_scan_chunked
    from repro_torch.kernels.ssd_scan.kernel import (SCAN, SCAN_BWD,
                                                     _bwd_library,
                                                     _scan_bwd_cuda,
                                                     _scan_cuda,
                                                     saved_for_backward)
    from repro_torch.kernels.ssd_scan.ref import ssd_scan_plain_bwd

    Bb, S, H, P, N, Q = SSD_TRAIN_SHAPE
    g = torch.Generator(device=device).manual_seed(9)
    dy = torch.randn((Bb, S, H, P), generator=g, device=device)
    dh = torch.randn((Bb, H, N, P), generator=g, device=device)

    def case(label, ops):
        """(run, gradients, plain gradients, errors) of B5b on ``ops``."""
        _, _, work = _scan_cuda(*ops, Q)
        saved = saved_for_backward(work, ops[0], ops[3], Q)
        run = lambda: _scan_bwd_cuda(*ops, work, dy, dh, Q)  # noqa: E731
        got = run()
        ref = ssd_scan_plain_bwd(*ops, *saved, dy, dh, Q)
        torch.cuda.synchronize()
        return run, got, ref, ssd_bwd_check(torch, f"B5b/{label}", got, ref,
                                            run), saved

    ops = ssd_operands(torch, device, Bb, S, H, P, N, seed=8)
    run, got, ref, errs, saved = case("train", ops)
    ins = [t.clone().requires_grad_() for t in ops]
    K.reset_launch_counts()
    y, h = ssd_scan_chunked(*ins, Q)
    auto = torch.autograd.grad([y, h], ins, [dy, dh])
    torch.cuda.synchronize()
    if K.launch_counts() != {SCAN: 1, SCAN_BWD: 1}:
        raise AssertionError(f"B5b: counted {K.launch_counts()} for one "
                             f"forward and backward")
    if not all(torch.equal(a, b) for a, b in zip(auto, got)):
        raise AssertionError("B5b: autograd's gradients differ from the "
                             "direct call's")
    del y, h, auto, ins
    ms = cuda_ms(run, 20)
    plain_ms = cuda_ms(lambda: ssd_scan_plain_bwd(*ops, *saved, dy, dh, Q),
                       3)
    # the kernel's route: three TF32 products for each product on the tensor
    # cores (split TF32, as B5's), beside the f32 SIMT bound of the same work
    n_bytes, n_flops = ssd_bwd_work(Bb, S, H, P, N, Q)
    simt_ms, _ = bound_ms(n_bytes, n_flops)
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    tc_ms = max(t_bytes, 3 * n_flops / TF32_FLOP_PER_S * 1e3)
    stages = []
    for name in SSD_BWD_NAMES:
        # one launch a call: ms a launch over the launches the trace kept
        # (a session may drop one of its events)
        dev = device_ms(torch, run, (name,), 5)
        stages.append(f"{name} " + ("not traced" if dev is None
                                    else f"{dev[0] / dev[1]:.4f}"))
    err = max(e for e, _ in errs.values())
    log(f"[kernels] B5b Bb={Bb} S={S} H={H} P={P} N={N} chunk={Q}: kernel "
        f"{ms:.4f} ms ({_bwd_library().ssd_bwd_launches()} device launches "
        f"a call: {', '.join(stages)} ms of device time), plain "
        f"{plain_ms:.4f} ms; bound {tc_ms:.4f} ms on the tensor cores in "
        f"split TF32 (3 x {n_flops / 1e9:.2f} GFLOP of TF32), "
        f"{tc_ms / ms:.1%} of it; {simt_ms:.4f} ms in f32 SIMT, "
        f"{simt_ms / ms:.1%} of it; bytes {n_bytes / 1e9:.3f} GB, "
        f"{t_bytes:.4f} ms; err / max|plain| "
        f"{', '.join(f'{k} {r:.2e}' for k, (_, r) in errs.items())}; "
        f"bitwise repeatable; through autograd: 1 B5 + 1 B5b launch, "
        f"gradients bitwise the direct call's")
    results = {("B5b", "train"): {"ms": ms, "plain_ms": plain_ms,
                                  "bound_ms": tc_ms,
                                  "bound_by": ("operations" if tc_ms > t_bytes
                                               else "bytes"),
                                  "max_abs_err": err}}
    del run, got, ref, saved

    # the model's layout: x, B and C as views of one conv output
    g = torch.Generator(device=device).manual_seed(10)
    xbc = torch.randn((Bb, S, H * P + 2 * N), generator=g, device=device)
    views = (xbc[..., :H * P].reshape(Bb, S, H, P), ops[1], ops[2],
             xbc[..., H * P:H * P + N], xbc[..., H * P + N:])
    _, got, _, verr, _ = case("strided", views)
    copies = tuple(t.contiguous() for t in views)
    _, _, work = _scan_cuda(*copies, Q)
    again = _scan_bwd_cuda(*copies, work, dy, dh, Q)
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError("B5b: strided operands differ from contiguous")
    log(f"[kernels] B5b strided (x, B, C views of a (Bb, S, "
        f"{H * P + 2 * N}) conv output, read in place): err / max|plain| "
        f"{', '.join(f'{k} {r:.2e}' for k, (_, r) in verr.items())}, "
        f"bitwise equal to contiguous copies")
    del xbc, views, copies, work, got, again

    cops = ssd_cancelling(torch, device, Bb, S, H, P, N)
    _, _, _, cerr, _ = case("cancelling", cops)
    log(f"[kernels] B5b cancelling sums (S={S}): err / max|plain| "
        f"{', '.join(f'{k} {r:.2e}' for k, (_, r) in cerr.items())} "
        f"(gate {TOL_SSD})")
    del ops, cops
    torch.cuda.empty_cache()
    return results


def phase_ssm_train_check(torch, device):
    """Reduced mamba2-370m (seq 32: 4 chunks of 8), 3 pipelined int8
    steps, GPU (B5, B5b, B1) against CPU (plain versions)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan.kernel import SCAN, SCAN_BWD

    gpu, cpu, n_good, err, counts = pipelined_check(
        torch, device, "mamba2-370m", "ssm-train-check")
    layers = get_arch("mamba2-370m").reduced().n_layers
    if counts.get(SCAN) != 3 * layers or counts.get(SCAN_BWD) != 3 * layers:
        raise AssertionError(f"ssm-train-check: launches {counts} in 3 "
                             f"steps of {layers} 'S' layers")
    log(f"[ssm-train-check] reduced mamba2-370m, W={W}, seq 32 (4 chunks of "
        f"8), 3 pipelined int8 steps: GPU vs CPU losses "
        f"{[round(l, 6) for l in gpu]} vs {[round(l, 6) for l in cpu]}, "
        f"n_good {n_good}, max |ensemble diff| {err:.3e}; GPU launches "
        f"{counts}")


def ssm_train_argv(steps):
    """The trainer's flags on the SSM training path: full mamba2-370m,
    pipelined, int8 wire, W 4, batch 2, seq 512 (4 chunks)."""
    return ["--arch", "mamba2-370m", "--workers", str(W), "--pipelined",
            "--wire-format", "int8", "--batch", "2", "--seq",
            str(SSM_TRAIN_SEQ), "--steps", str(steps), "--log-every", "1"]


def phase_ssm_train(torch, device):
    """``repro_torch.launch.train`` on full mamba2-370m, counters zeroed
    before and read after — B5 and B5b once per layer a step, B1r/B1a once
    a step — its steady step time and peak memory; then the forward and
    backward of one step by CUDA events and a profile of it.  Returns the
    run's launch counts of B5b."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.kernels.ssd_scan.kernel import SCAN, SCAN_BWD
    from repro_torch.launch import train
    from repro_torch.launch.steps import packed_loss_and_grad
    from repro_torch.models.model import init_model

    cfg = get_arch("mamba2-370m")
    argv = ssm_train_argv(SSM_TRAIN_STEPS)
    log(f"[ssm-train] python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = train.main(argv)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = out["losses"]
    if len(losses) != SSM_TRAIN_STEPS or not all(map(math.isfinite, losses)):
        raise AssertionError(f"ssm-train: losses {losses}")
    want = {SCAN: cfg.n_layers * SSM_TRAIN_STEPS,
            SCAN_BWD: cfg.n_layers * SSM_TRAIN_STEPS,
            REDUCE: SSM_TRAIN_STEPS, APPLY: SSM_TRAIN_STEPS}
    if any(counts.get(k) != v for k, v in want.items()):
        raise AssertionError(f"ssm-train: launches {counts}, want {want} "
                             f"in {SSM_TRAIN_STEPS} steps")
    a_log = out["params"]["scan"]["pos0"]["ssm"]["A_log"]
    if tuple(a_log.shape) != (W, cfg.n_layers, 32) or \
            not bool(torch.isfinite(a_log).all()):
        raise AssertionError(f"ssm-train: final average A_log "
                             f"{tuple(a_log.shape)} not finite/shaped")
    median = steady_median(out["step_seconds"])
    log(f"[ssm-train] launches {counts} over {SSM_TRAIN_STEPS} steps; step "
        f"seconds {[round(t, 4) for t in out['step_seconds']]} (first "
        f"includes warm-up); steady median {median * 1e3:.2f} ms; n_good "
        f"{out['n_good']}; peak memory {peak:.2f} GiB")
    del out, a_log
    torch.cuda.empty_cache()

    params = init_model(cfg, 0, device=device)
    wp = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
    gcfg = G.GossipConfig(shifts=(1, 2), partial_blocks=4, delay=1,
                          wire_format="int8")
    spec = pack_spec_w(wp, block_rows=BLOCK_ROWS,
                       groups=G.leaf_groups(wp, 4), n_groups=4)
    packed = pack_w(wp, spec)
    del params, wp
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (W, 2, SSM_TRAIN_SEQ), device=device,
        generator=torch.Generator(device=device).manual_seed(0))}
    fb = lambda: packed_loss_and_grad(cfg, packed, batch, spec)  # noqa: E731
    t_fb = cuda_ms(fb, 3)
    log(f"[ssm-train] forward+backward of one step (W={W}, batch 2, seq "
        f"{SSM_TRAIN_SEQ}, packed gradient): {t_fb:.3f} ms by CUDA events")
    profile_step(torch, "ssm-train-profile", fb, what="one forward+backward",
                 group=("B5 + B5b (ssd_scan, ssd_scan_bwd)",
                        SSD_KERNEL_NAMES + SSD_BWD_NAMES))
    del packed, batch
    torch.cuda.empty_cache()
    return {SCAN_BWD: counts[SCAN_BWD]}


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
    t_start = time.perf_counter()
    sys.path.insert(0, str(SRC))
    from repro_torch import kernels as K
    from repro_torch import set_full_fp32_precision
    from repro_torch.kernels.gossip_blend.kernel import (
        APPLY, APPLY_1, APPLY_W, REDUCE, REDUCE_1, REDUCE_W, SOURCE)
    from repro_torch.kernels.kmeans_assign.kernel import ASSIGN
    from repro_torch.kernels.kmeans_assign.kernel import SOURCE as KM_SOURCE
    from repro_torch.kernels.parzen_blend.kernel import APPLY as PZ_APPLY
    from repro_torch.kernels.parzen_blend.kernel import REDUCE as PZ_REDUCE
    from repro_torch.kernels.ssd_scan.kernel import (BWD_SOURCE, SCAN,
                                                     SCAN_BWD)
    from repro_torch.kernels.ssd_scan.kernel import SOURCE as SSD_SOURCE

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
    counts, main_s = phase_main_path(torch)
    phase_breakdown(torch, device)
    phase_elastic_check(torch, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = str(pathlib.Path(tmp) / "main.msgpack")
        phase_ckpt(torch, path)
        phase_elastic(torch, path, main_s)
    counts.update(phase_pytree(torch, device))
    counts.update(phase_fused_update(torch, device))
    kres.update(phase_kmeans_kernels(torch, device))
    counts.update(phase_parzen_blend(torch, device))
    phase_kmeans_check(torch, device)
    counts.update(phase_kmeans(torch, device))
    kres.update(phase_ssd_kernel(torch, device))
    kres.update(phase_ssd_bwd_kernel(torch, device))
    phase_serve_check(torch, device)
    counts.update(phase_serve(torch, device))
    phase_ssm_train_check(torch, device)
    counts.update(phase_ssm_train(torch, device))

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
            ("B6a", PZ_APPLY, SOURCE, f"{pz}:85", "open"),
            ("B5", SCAN, SSD_SOURCE, "src/repro/kernels/ssd_scan/kernel.py:85",
             "serve"),
            # no TPU kernel: the reference differentiates ssd_chunked
            ("B5b", SCAN_BWD, BWD_SOURCE, "src/repro/models/ssm.py:67",
             "train")):
        r = kres[(tag, case)]
        kernels.append({
            "name": name, "route": "cuda",
            "source": str(src.relative_to(ROOT)),
            "replaces": ref, "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None})
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s "
        f"(build included)")
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
