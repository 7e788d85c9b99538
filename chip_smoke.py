#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Every training forward rematerializes, as the reference's train step does
(each full cycle of the layer pattern run without a graph; backward
reruns it).

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
     zeroed just before and read just after — B1r/B1a every round; then
     on its trained state the step with the forward rematerialized and
     with ``make_train_step(..., remat=False)``, in turns: the price of
     remat in step time beside its saving in peak memory;
  5. [breakdown]/[profile] the pieces of one full-size pipelined step,
     and its exchange and blend on an elastic state (live = ones);
     [mesh-check]/[mesh] launch/mesh.py's four regions at one rank of an
     NCCL group, a (1, 1) ("data", "model") mesh, on that ensemble with
     seeded per-worker offsets (W = 4 = W_local): both wires, delay 0
     and 1, legacy and elastic (worker 2 down), every shift and
     partition, each region bitwise the single-device engine on the same
     input, psum_axes ("model",) bitwise no psum, B1r/B1a launches on
     the region path counted, the pipelined region's time beside
     [breakdown]'s exchange + blend; [train-lm]
     ``repro_torch.examples.train_lm --full --steps 8`` (asgd, silent,
     sync on full smollm-135m), every loss finite;
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
     --algo silent step through train.main; [tp] the tensor-parallel
     pytree step (launch/tensor_parallel.py, make_train_step(mesh=)) at
     one rank of an NCCL group, a (1, 1) ("data", "model") mesh, every
     leaf a DTensor: full smollm-135m (W=4), qwen2.5-14b at full width
     cut to 2 layers (W=1), gemma3-1b at full width cut to one 6-layer
     cycle (W=2, seq 1024), paligemma-3b at full width cut to 2 layers
     (W=2, 256 patches) and full whisper-tiny (W=4, 1500 frames), 3
     steps each against the plain pytree step
     from the same starts, batches and draws (bitwise, or else within
     1e-5 with the gates equal), B2r/B2a once a round on its path, both
     steps' times and peaks; [tp-options] the same step under the
     options of ROADMAP 15d/15f — full smollm-135m (W=4, seq 128) on the
     int8 wire, with live= (worker 1 down on step 2), inner momentum,
     Adam, gossip_every 2, 'rows' mode and 'rows' on int8, full
     mamba2-370m (W=4, seq 512) on int8 — each bitwise the plain step
     with the same option, B2r/B2a once a gossip round (none on the
     off-rounds), both steps' times and peaks; [tp-serve] the
     tensor-parallel serve of the attention archs against the plain
     one; [tp-ssm] the 'S' and 'R'
     archs tensor-parallel: full mamba2-370m (W=4, seq 512) and
     recurrentgemma-9b at full width cut to one (R, R, L) cycle (W=1) 3
     steps each against the plain pytree step, and full mamba2-370m and
     recurrentgemma-9b served (prompt 2048, batch 4, 16 tokens) against
     the plain generate; B5/B5b as often on each tensor-parallel path as
     on the plain one; [tp-moe] the MoE archs expert-parallel: full
     granite-moe-1b-a400m (W=1, seq 128) 3 steps against the plain
     pytree step, full granite-moe and phi3.5-moe at 4 layers served
     (prompt 2048, batch 4, 16 tokens) against the plain generate; the
     placed MoE's call counter above 0, peaks within 5% of plain;
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
     counters zeroed before and read after — B5 96 times a step (backward
     reruns each layer's forward), B5b 48, B1r/B1a once — its steady step
     time and peak memory, the forward and
     backward of one step by CUDA events and its profile;
 18. [moe-train-check] reduced granite-moe-1b-a400m and phi3.5-moe, 3
     pipelined int8 steps from distinct worker starts, GPU (B1r/B1a)
     against CPU: losses (the router's aux term included) rel 1e-4,
     ensembles atol 1e-4, n_good equal and not all 0;
 19. [moe-train] the MoE training path, ``repro_torch.launch.train`` on
     full granite-moe-1b-a400m (24 layers, d_model 1024, 32 experts top-8,
     random weights from seed 0), W=2, batch 2, seq 128, --pipelined
     --wire-format int8, 8 steps, counters zeroed before and read after —
     B1r/B1a once a step — its steady step time and peak memory, the
     forward and backward of one step by CUDA events and its profile, and
     one layer's apply_moe forward+backward (its gradients bitwise equal
     over two runs) times the 24 layers: MoE's share;
 20. [moe-blend] B1r/B1a on granite-moe's packed ensemble at W=2, the
     ensemble [moe-train] blends (2.7e9 f32 elements), then at W=4 (5.3e9):
     pack_w/unpack_w and the int8 exchange bitwise on the last worker's
     rows, past element 2^31 (and at W=4 past 2^32), each kernel against
     its plain version on those rows, and both kernels' times against
     their bounds;
 21. [moe-serve-check] reduced granite-moe and phi3.5-moe from the same
     CPU-made weights, GPU against CPU: prefill and 4 decode steps' logits,
     greedy tokens off near-ties, every cache leaf, each decode step from
     the CPU's cache and free-running from the GPU's own (held to the
     CPU's step on that cache), with the free run's distance from the
     CPU's free run and the bf16 cache elements that differ;
 22. [moe-serve] ``launch.serve.main`` on full granite-moe (batch 4,
     prompt 2048, 32 new tokens; every 'G' layer of the prefill through
     attention_flash, counted), then granite-moe and phi3.5-moe at full
     width with its depth cut to 4 layers: steady prefill and decode
     times, peak memory while serving, a profile of one prefill;
 23. [gemma-train-check] reduced gemma3-1b (6 layers: 'L' x5, 'G'; window
     16) and reduced recurrentgemma-9b (3 layers: 'R', 'R', 'L'; lru_width
     256) at seq 32, where the window binds: 3 pipelined int8 steps from
     distinct worker starts, GPU (B1r/B1a) against CPU: losses rel 1e-4,
     ensembles atol 1e-4, n_good equal and not all 0;
 24. [gemma-train] ``repro_torch.launch.train`` on full gemma3-1b (26
     layers: 22 'L' with window 512, 4 'G'; random weights from seed 0),
     W=4, batch 2, seq 1024, where the window binds, --pipelined
     --wire-format int8,
     8 steps, counters zeroed before and read after — B1r/B1a once a step
     — its steady step time and peak memory, the forward and backward of
     one step by CUDA events, its profile, and B1r/B1a's device time in
     one step;
 25. [rg-train] ``repro_torch.launch.train`` on recurrentgemma-9b at full
     width with its depth cut to one (R, R, L) cycle (the trainer's
     get_arch cut for the run), W=2, batch 2, seq 128, pipelined int8, 8
     steps, counters zeroed before and read after — B1r/B1a once a step —
     and the readings of [24]; then the trained 'L' layer's forward and
     backward at seq 4096, where its window of 2048 binds (attention_flash
     with the window, counted), by CUDA events;
 26. [gemma-blend] B1r/B1a as [moe-blend] on the ensembles the Gemma paths
     blend: gemma3-1b at W=4 (4.0e9 f32 elements, past 2^31) and the
     depth-cut recurrentgemma-9b at W=2 (3.4e9, past 2^31);
 27. [gemma-serve-check] reduced gemma3-1b and recurrentgemma-9b as
     [moe-serve-check] (prompts of 32, 4 decode steps past the window of
     16), the 'R' layers' prefilled conv cache zero; then reduced
     gemma3-1b at a 2048-token prompt, GPU against CPU, every 'L' layer of
     the GPU's prefill through attention_flash with its window (counted);
 28. [gemma-serve] ``launch.serve.main`` (batch 4, prompt 2048, 32 new
     tokens) on full gemma3-1b — 26 attention_flash calls a prefill, 22
     with window 512 and 4 without, counted — and full recurrentgemma-9b
     (38 layers; 12 'L' with window 2048): steady prefill and decode
     times, peak memory while serving, a profile of one prefill;
 29. [vlm-audio-train-check] reduced paligemma-3b (8 stub patches) and
     whisper-tiny (2 encoder layers, 32 stub frames), 3 pipelined int8
     steps from distinct worker starts, each worker's patches or frames
     drawn with its tokens, GPU (B1r/B1a) against CPU: losses rel 1e-4,
     ensembles atol 1e-4, n_good equal and not all 0;
 30. [audio-train] ``repro_torch.launch.train`` on full whisper-tiny (4 +
     4 layers, d_model 384; 1500 frames a sample), W=4, batch 2, seq 128,
     pipelined int8, 8 steps, counters zeroed before and read after —
     B1r/B1a once a step — then the readings of [24];
 31. [vlm-train] the same on full paligemma-3b (18 layers), W=2, 256
     patches and 128 text tokens a sample;
 32. [vlm-blend] / [audio-blend] B1r/B1a as [moe-blend] on the ensembles
     [vlm-train] and [audio-train] blend (paligemma's 5.0e9 elements, past
     2^31);
 33. [vlm-audio-serve-check] both reduced archs as [moe-serve-check]
     (prompts of 32 after the patches or frames; whisper's decode reads
     its bf16 cross-attention cache), then reduced paligemma at a prompt
     of 2040 (2048 positions with its prefix): every layer of the CPU's
     and of the GPU's prefill through attention_flash with prefix_len 8,
     counted;
 34. [audio-serve] ``launch.serve.main`` on full whisper-tiny (batch 4,
     1500 frames, prompt 416, 32 new tokens: 448 positions, every
     attention dense), its steady prefill and decode times, peak memory
     and a profile of one prefill;
 35. [vlm-serve] the same on full paligemma-3b (batch 4, 256 patches, 32
     new tokens) at prompts of 128 (384 positions, the dense prefix mask)
     and 1792 (2048 positions: its 18 layers' prefill through
     attention_flash with prefix_len 256, counted);
 36. [qwen-serve-check] reduced qwen2.5-14b (QKV biases) and qwen3-14b
     (qk RMSNorm), their biases and norm scales perturbed by 0.5 x N(0, 1),
     as [moe-serve-check]; [qwen-train-check] both as [gemma-train-check];
 37. [qwen-serve] both at full size (14.8e9 params, 55.0 GiB f32) through
     the readings of [moe-serve] (batch 4, prompt 2048, 32 new tokens:
     every layer of the prefill through attention_flash, counted);
 38. [qwen-train] ``repro_torch.launch.train`` on each at full width with
     its depth cut to 2 layers, W=2, batch 2, seq 128, pipelined int8, 8
     steps, counters zeroed before and read after — B1r/B1a once a step on
     an ensemble of 4.2e9 and 4.4e9 elements, past 2^31;
 39. [dryrun] ``repro_torch.launch.dryrun.run_pair`` on named pairs of the
     production (16, 16) mesh (a fake process group of 256 ranks, one
     process): smollm-135m x train_4k on the pytree, packed and pipelined
     engines, mamba2-370m x prefill_32k (B5 modeled) and x train_4k
     pipelined (B5 twice a layer and B5b once modeled), mamba2-370m x
     decode_32k, qwen2.5-14b and granite-moe-1b-a400m x train_4k; each
     record's layout, dominant term, useful ratio, peak and fits, and
     trace times; the tensor-parallel pairs (the pytree train step and
     the serve steps: one rank's shards over ``model``) each beside the
     replicated peak of the parent tree's trace (DRYRUN_REPLICATED_GIB),
     the train pairs' argument bytes their placed bytes and their peaks
     below the replicated ones;
     B5's and B5b's workspace sizes as the meta branches model them
     against the kernels' own (``ssd_workspace_floats``,
     ``ssd_bwd_workspace_floats``);
 40. [dryrun-check] the dry-run's meta trace of the [main] step (full
     smollm-135m, W=4, batch 2, seq 128, pipelined int8) against that step
     run once on the card, its state built as the trainer builds it, both
     under the dry-run's counters: the arguments' shapes, dtypes and bytes
     equal, the aten FLOPs equal FlopCounterMode on the card exactly, the
     modeled B1r/B1a calls equal kernels.launch_counts(), and the modeled
     peak over ``torch.cuda.max_memory_allocated()`` (above what was
     allocated before the state) within PEAK_RATIO, printed with the
     tracker's own reading on the card; the step rematerializes;
 41. [dryrun-tp-check] the same for one rank of [tp]'s smollm step (full
     smollm-135m, W=4, batch 2, seq 128, the fused blend, tensor-parallel
     on a (1, 1) NCCL mesh): the meta trace of the dry-run's placed layout
     against the step run once on the card — FLOPs exact, the modeled
     B2r/B2a calls equal kernels.launch_counts(), argument bytes equal,
     the peak ratio within PEAK_RATIO.
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
TRAIN_LM_STEPS = 8                   # [train-lm]
PYTREE_STEPS = 8
TOL_REDUCE_RTOL = 1e-5               # sums in another order
TOL_APPLY_ATOL = 1e-6                # elementwise; the same op order
TOL_FUSED_ATOL = 1e-5                # fused vs unfused update: sums in
#                                      other orders, then one division
START_NOISE = 0.1                    # [check]: per-worker start offsets
ELASTIC_ROUNDS = 5                   # [elastic-check]
CHURN_DEAD, CHURN_ROUNDS = 2, (1, 2)  # [elastic-check]: worker 2 is down
#                                       in rounds 1-2
REMAT_REPS = 4                       # [main]: steps a turn, remat vs not
REMAT_PRICE_MAX = 1.9                # [main]: remat's step over remat=False's
#                                      (1.30-1.65 measured; 1.82-2.05 with
#                                      torch.utils.checkpoint, PERF.md §6)


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


# pipelined_check's gossip draw seeds: its third round blends round 0's
# payload, and from distinct starts a partition may be admitted by no
# worker (reduced granite-moe's seed 0 draws partition 3, which none
# admits); which seeds admit depends on the CPU's torch version, so each
# check takes the first seed whose CPU run admits a message
DRAW_SEEDS = tuple(range(16))


def pipelined_check(torch, device, arch, tag):
    """3 pipelined int8 steps of reduced ``arch`` on the GPU (kernels) and
    on the CPU (plain versions) from the same distinct worker starts, batches
    (with the frontend's frames or patches) and gossip draws: losses within
    rel 1e-4, n_good equal and not all 0, ensembles within atol 1e-4.  The
    draws come from the first of DRAW_SEEDS whose CPU run admits a message
    (the last one if none does, and the check then fails).  Returns (GPU
    losses, CPU losses, n_good, max |ensemble diff|, the GPU run's launch
    counts, the draw seed)."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.launch.train import next_wbatch
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

    def run(dev, seed):
        packed = pack_w(wp, spec).to(dev)
        state = G.init_pipelined_gossip_state(packed, gcfg,
                                              block_rows=BLOCK_ROWS)
        its = [lm_batch_iterator(
            w, 2, 32, cfg.vocab, frontend=cfg.frontend, d_model=cfg.d_model,
            encoder_seq=cfg.encoder_seq, prefix_len=cfg.prefix_len)
            for w in range(W)]
        draws = torch.Generator().manual_seed(seed)
        out = []
        K.reset_launch_counts()
        for _ in range(3):
            packed, state, _, m = step(packed, state, 0,
                                       next_wbatch(its, dev),
                                       *G.draw_gossip_indices(draws, gcfg))
            out.append((float(m["loss"]), float(m["n_good"])))
        return out, packed.cpu(), K.launch_counts()

    for seed in DRAW_SEEDS:
        cpu, cpu_pk, _ = run("cpu", seed)
        if sum(g for _, g in cpu) > 0:
            break
    gpu, gpu_pk, counts = run(device, seed)
    for (lc, gc), (lg, gg) in zip(cpu, gpu):
        if abs(lg - lc) > 1e-4 * abs(lc) or gc != gg:
            raise AssertionError(f"{tag}: GPU (loss {lg}, n_good {gg}) vs "
                                 f"CPU (loss {lc}, n_good {gc})")
    err = float((gpu_pk - cpu_pk).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"{tag}: ensembles differ by {err:.3e}")
    check_admitted(tag, [g for _, g in gpu])
    return ([l for l, _ in gpu], [l for l, _ in cpu], [g for _, g in gpu],
            err, counts, seed)


def phase_small_check(torch, device):
    gpu, cpu, n_good, err, _, seed = pipelined_check(
        torch, device, "smollm-135m", "small check")
    log(f"[check] reduced smollm, 3 pipelined int8 steps, draw seed {seed}: "
        f"GPU vs CPU "
        f"losses {[round(l, 6) for l in gpu]} vs "
        f"{[round(l, 6) for l in cpu]}, n_good {n_good}, "
        f"max |ensemble diff| {err:.3e}")


def train_argv(arch, wn, seq, steps):
    """The trainer's flags on a training path: full ``arch``, pipelined,
    int8 wire, ``wn`` workers, batch 2, ``seq`` tokens."""
    return ["--arch", arch, "--workers", str(wn), "--pipelined",
            "--wire-format", "int8", "--batch", "2", "--seq", str(seq),
            "--steps", str(steps), "--log-every", "1"]


def main_argv(steps, workers=W):
    """The trainer's flags on the main path: full smollm-135m, seq 128."""
    return train_argv("smollm-135m", workers, 128, steps)


def steady_median(step_seconds):
    """Median of a run's step times, the first (warm-up) left out."""
    steady = sorted(step_seconds[1:])
    return steady[len(steady) // 2]


def phase_main_path(torch):
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
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
    state, spec = out["state"], out["spec"]
    del out, wq
    torch.cuda.empty_cache()
    remat_readings(torch, "main", get_arch("smollm-135m"), state, spec, W,
                   128, torch.device("cuda"))
    del state
    torch.cuda.empty_cache()
    return counts, median


def remat_readings(torch, tag, cfg, state, spec, wn, seq, device):
    """The trainer's pipelined int8 step on a trained packed ``state`` of
    ``wn`` workers (batch 2, ``seq`` tokens) with the forward
    rematerialized (the default) and with ``make_train_step(...,
    remat=False)``, in turns (remat, none, none, remat), REMAT_REPS steps
    a turn from the same state: each one's median step time (host clock
    to a device sync) and peak memory, the state included.  Fails where
    remat's step takes over REMAT_PRICE_MAX times the other's."""
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.launch import train
    from repro_torch.launch.steps import make_train_step

    batch = {"tokens": torch.randint(
        0, cfg.vocab, (wn, 2, seq), device=device,
        generator=torch.Generator(device=device).manual_seed(0))}
    gcfg = train.gossip_config(wn, wire_format="int8")
    steps = {r: make_train_step(cfg, pack_spec=spec, gcfg=gcfg,
                                acfg=ASGDConfig(eps=EPS), pipelined=True,
                                remat=r) for r in (True, False)}
    times = {True: [], False: []}
    peaks = {True: 0.0, False: 0.0}
    for remat in (True, False, False, True):
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _ in range(REMAT_REPS):
            t0 = time.perf_counter()
            out = steps[remat](state["params"], state["gossip"],
                               state["opt"], batch, 0, 1)
            torch.cuda.synchronize()
            times[remat].append(time.perf_counter() - t0)
            if not math.isfinite(float(out[3]["loss"])):
                raise AssertionError(f"{tag}: remat={remat} loss "
                                     f"{out[3]['loss']}")
            del out
        peaks[remat] = max(peaks[remat],
                           torch.cuda.max_memory_allocated() / 2**30)
    med = {r: sorted(v)[len(v) // 2] * 1e3 for r, v in times.items()}
    log(f"[{tag}] remat vs make_train_step(remat=False), in turns, "
        f"{REMAT_REPS} steps a turn: median step {med[True]:.2f} / "
        f"{med[False]:.2f} ms (remat costs {med[True] - med[False]:.2f} ms, "
        f"{med[True] / med[False] - 1:.1%}); peak memory {peaks[True]:.2f} / "
        f"{peaks[False]:.2f} GiB (the state included)")
    if med[True] > REMAT_PRICE_MAX * med[False]:
        raise AssertionError(f"{tag}: remat's step {med[True]:.2f} ms over "
                             f"{REMAT_PRICE_MAX} x remat=False's "
                             f"{med[False]:.2f} ms")
    torch.cuda.empty_cache()
    return med, peaks


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
    return {"packed": packed, "pgrads": pgrads, "spec": spec, "acfg": acfg,
            "exchange_ms": t_ex, "blend_ms": t_bl}


def mesh_states(torch, G, packed, spec, gcfg, live, si, bi):
    """(packed engine's state, pipelined engine's state) with every FIFO
    slot holding a real payload (partition ``bi`` at shift ``si``) and the
    staleness guard open; on an elastic run each slot's recorded validity
    is that payload's under ``live``."""
    ranges = G.packed_row_ranges(spec, gcfg)
    sent = G.exchange_packed(packed, ranges, si, bi, gcfg,
                             block_rows=spec.block_rows)
    sent, scales = sent if isinstance(sent, tuple) else (sent, None)
    sent_live = None if live is None else G.roll_live(live, si, gcfg)
    out = []
    for pipelined in (False, True):
        d = G.fifo_depth(gcfg, pipelined=pipelined)
        out.append(G.PackedGossipState(
            buf=(sent,) * d, buf_idx=(bi,) * d, step=d,
            buf_scales=None if scales is None else (scales,) * d,
            buf_live=None if live is None else (sent_live,) * d))
    return out


def same(torch, tag, got, want):
    """Bitwise equality of two output tuples (None entries skipped)."""
    want = [w for w in want if w is not None]
    if len(got) != len(want) or not all(
            torch.equal(a, b) for a, b in zip(got, want)):
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(got, want)]
        raise AssertionError(f"{tag}: region != single-device engine "
                             f"(max |diff| per output {diffs})")


def phase_mesh(torch, device, bd):
    """[mesh-check]/[mesh]: launch/mesh.py's four regions at one rank of an
    NCCL process group on the card, a (1, 1) ("data", "model") mesh, on
    [breakdown]'s full smollm-135m ensemble (W = 4 = W_local) with seeded
    per-worker offsets, the trainer's GossipConfig: both wires, delay 0
    and 1, legacy and elastic (worker CHURN_DEAD down), every shift and
    partition (each shift the roll's r != 0 local path), each region
    bitwise the single-device engine on the same input; psum_axes
    ("model",) bitwise no psum (an NCCL all_gather of one rank); B1r/B1a
    launches on the region path; the pipelined region's time."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch import kernels as K
    from repro_torch.core import gossip as G
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import mesh as MM
    from repro_torch.launch.train import gossip_config

    spec, acfg, pgrads = bd["spec"], bd["acfg"], bd["pgrads"]
    packed = bd["packed"] + START_NOISE * torch.randn(
        bd["packed"].shape, device=device,
        generator=torch.Generator(device=device).manual_seed(3))
    churn = torch.ones(W, device=device)
    churn[CHURN_DEAD] = 0.0
    region_counts, opened, pairs = {}, [0, 0], 0

    def counted(region, *args):
        """A region call, its kernel launches added to region_counts."""
        before = K.launch_counts()
        out = region(*args)
        torch.cuda.synchronize()
        for k, v in K.launch_counts().items():
            region_counts[k] = region_counts.get(k, 0) + v - before.get(k, 0)
        return out if isinstance(out, tuple) else (out,)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            log(f"[mesh-check] {dist.get_backend()} group of "
                f"{dist.get_world_size()} rank, "
                f"mesh {tuple(mesh.shape)} {mesh.mesh_dim_names}, W={W}, "
                f"W_local={MM.local_worker_count(mesh, W)}")
            for wire in ("none", "int8"):
                for delay in (0, 1):
                    for elastic in (False, True):
                        gcfg = gossip_config(W, delay=delay,
                                             wire_format=wire)
                        live = churn if elastic else None
                        lives = (churn,) if elastic else ()
                        kw = dict(n_workers=W, elastic=elastic)
                        rnd = MM.shard_map_gossip_round(mesh, spec, gcfg,
                                                        acfg, **kw)
                        pipe = MM.shard_map_pipelined_round(
                            mesh, spec, gcfg, acfg, **kw)
                        init = MM.shard_map_initiate_exchange(mesh, spec,
                                                              gcfg, **kw)
                        cons = MM.shard_map_consume_blend(mesh, spec, gcfg,
                                                          acfg, **kw)
                        for si in range(len(gcfg.shifts)):
                            for bi in range(gcfg.partial_blocks):
                                tag = (f"[mesh-check] {wire} delay {delay}"
                                       f"{' elastic' if elastic else ''} "
                                       f"shift {gcfg.shifts[si]} part {bi}")
                                pst, qst = mesh_states(torch, G, packed, spec,
                                                       gcfg, live, si, bi)
                                new, st, m = G.asgd_gossip_apply_packed(
                                    packed, pgrads, pst, si, bi, gcfg, acfg,
                                    spec, live=live)
                                head = G._fifo_head(pst)
                                ext = (head[0],) + ((head[1],) if head[1]
                                                    is not None else ())
                                hl = (head[3], churn) if elastic else ()
                                tails = [x[-1] if x else None for x in (
                                    st.buf, st.buf_scales, st.buf_live)]
                                same(torch, tag + " round", counted(
                                    rnd, packed, pgrads, *ext, head[2],
                                    pst.step, si, bi, *hl),
                                    [new, tails[0], tails[1], m["gate"],
                                     tails[2]])
                                opened[0] += int(m["gate"].sum())
                                new, st, m = G.asgd_gossip_apply_pipelined(
                                    packed, pgrads, qst, si, bi, gcfg, acfg,
                                    spec, live=live)
                                head = G._fifo_head(qst)
                                ext = (head[0],) + ((head[1],) if head[1]
                                                    is not None else ())
                                hl = (head[3], churn) if elastic else ()
                                tails = [x[-1] if x else None for x in (
                                    st.buf, st.buf_scales, st.buf_live)]
                                same(torch, tag + " pipelined", counted(
                                    pipe, packed, pgrads, *ext, head[2],
                                    qst.step, si, bi, *hl),
                                    [new, tails[0], tails[1], m["gate"],
                                     tails[2]])
                                same(torch, tag + " initiate", counted(
                                    init, packed, si, bi, *lives), tails)
                                same(torch, tag + " consume", counted(
                                    cons, packed, pgrads, *ext, head[2],
                                    qst.step, *hl), [new, m["gate"]])
                                opened[1] += int(m["gate"].sum())
                                pairs += 1
            # the gate accumulator summed over the one 'model' rank (NCCL
            # all_gather): bitwise no sum
            gcfg = gossip_config(W, wire_format="int8")
            _, qst = mesh_states(torch, G, packed, spec, gcfg, None, 0, 1)
            head = G._fifo_head(qst)
            args = (packed, pgrads, head[0], head[1], head[2], qst.step, 0, 1)
            plain = MM.shard_map_pipelined_round(mesh, spec, gcfg, acfg,
                                                 n_workers=W)
            summed = MM.shard_map_pipelined_round(
                mesh, spec, dataclasses.replace(gcfg,
                                                gate_psum_axes=("model",)),
                acfg, n_workers=W)
            same(torch, "[mesh-check] psum_axes ('model',)",
                 counted(summed, *args), counted(plain, *args))
            check_s = time.perf_counter() - t0
            t_pipe = cuda_ms(lambda: plain(*args), 5)
        finally:
            dist.destroy_process_group()
    for name in (REDUCE, APPLY):
        want = 3 * pairs + 2
        if region_counts.get(name, 0) != want:
            raise AssertionError(f"[mesh-check] {name} launched "
                                 f"{region_counts.get(name, 0)} times on the "
                                 f"region path, want {want}: {region_counts}")
    if not all(0 < n < W * pairs for n in opened):
        raise AssertionError(f"[mesh-check] gates opened {opened} of "
                             f"{W * pairs} each: the check would not cover "
                             "both sides of the gate")
    log(f"[mesh-check] {pairs} (config, shift, partition) cases x 4 regions "
        f"bitwise the single-device engine, psum at one rank bitwise no "
        f"psum, in {check_s:.1f} s; gates opened {opened} of {W * pairs} "
        f"each; launches on the region path {region_counts}")
    log(f"[mesh] pipelined region (int8, delay 1, W={W}, full smollm-135m): "
        f"{t_pipe:.3f} ms by CUDA events; [breakdown] exchange + blend "
        f"{bd['exchange_ms']:.3f} + {bd['blend_ms']:.3f} = "
        f"{bd['exchange_ms'] + bd['blend_ms']:.3f} ms")
    return region_counts


def phase_train_lm(torch):
    """[train-lm] repro_torch.examples.train_lm --full --steps 8 on the
    card: asgd, silent and sync on full smollm-135m (the pytree engine),
    every loss finite."""
    from repro_torch import kernels as K
    from repro_torch.examples import train_lm

    argv = ["--full", "--steps", str(TRAIN_LM_STEPS)]
    log(f"[train-lm] python -m repro_torch.examples.train_lm "
        f"{' '.join(argv)}")
    torch.cuda.empty_cache()
    K.reset_launch_counts()
    t0 = time.perf_counter()
    losses = train_lm.main(argv)
    torch.cuda.synchronize()
    for name, ls in losses.items():
        if len(ls) != TRAIN_LM_STEPS or not all(map(math.isfinite, ls)):
            raise AssertionError(f"[train-lm] {name} losses {ls}")
    log(f"[train-lm] {time.perf_counter() - t0:.1f} s; losses "
        f"{ {k: [round(x, 4) for x in v] for k, v in losses.items()} }; "
        f"launches {K.launch_counts()}")


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


TP_STEPS, TP_TIMED, TP_EPS = 3, 3, 0.01
# [tp]'s full-width runs: (arch, layers (None: all), W, seq).  qwen2.5-14b
# 2 layers at W=1: the pytree engine holds ~8 copies of the state in its
# blend (7.85 GiB a replica at 2 layers), so W=2 would not fit; gemma3-1b
# one (L x 5, G) cycle at seq 1024, where its window of 512 binds;
# paligemma-3b 2 layers (3.0 GiB a replica) after its 256 patches;
# whisper-tiny whole, on 1500 frames
TP_RUNS = (("smollm-135m", None, W, 128),
           ("qwen2.5-14b", 2, 1, 128),
           ("gemma3-1b", 6, 2, 1024),
           ("paligemma-3b", 2, 2, 128),
           ("whisper-tiny", None, W, 128))
TP_STUB = {"audio": "frames", "vision": "patches"}


def tp_starts(torch, cfg, wn, device):
    """W worker starts on the card from seed 0, made again the same for
    each run: the model plus per-worker offsets as large as each leaf's
    spread (seeded), which at eps TP_EPS open some gates (the CPU test's
    starts, tests/test_torch_tensor_parallel.py)."""
    from repro_torch.core.tree import tree_map
    from repro_torch.models.model import init_model
    g = torch.Generator(device=device).manual_seed(1)
    return tree_map(lambda x: x.expand((wn,) + tuple(x.shape)) + x.std()
                    * torch.randn((wn,) + tuple(x.shape), device=device,
                                  generator=g) if x.numel() > 1 else
                    x.expand((wn,) + tuple(x.shape)).clone(),
                    init_model(cfg, 0, device=device))


def tp_run(torch, device, cfg, wn, seq, mesh, opts=None):
    """TP_STEPS pytree steps (eps TP_EPS, use_fused, 'leaves' p=4, delay 1)
    of ``cfg``
    from :func:`tp_starts`, seeded batches and draws — tensor-parallel on
    ``mesh`` when given, else the plain single-device step — then
    TP_TIMED steps timed one by one.  ``opts`` (TP_OPTIONS' entries):
    the step's other options — the wire, 'rows' mode, gossip_every, the
    inner optimizer, the algo, and ``live=`` (worker TP_DEAD down on step
    TP_DEAD_STEP; the state elastic).  Returns the checked steps' losses
    and gates (None where the algo has none), the params after them
    (CPU), their B2r/B2a launches, the timed steps' median ms and the
    peak memory."""
    import dataclasses

    from repro_torch import kernels as K
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.gossip import (draw_gossip_indices,
                                         init_gossip_state)
    from repro_torch.core.tree import flatten_sorted
    from repro_torch.launch import tensor_parallel as TP
    from repro_torch.launch.mesh import shard_workers
    from repro_torch.launch.steps import init_inner_state, make_train_step
    from repro_torch.launch.train import expandable_segments

    opts = opts or {}
    gcfg = dataclasses.replace(pytree_gcfg(opts.get("mode", "leaves"),
                                           opts.get("wire")),
                               gossip_every=opts.get("every", 1))
    acfg = ASGDConfig(eps=TP_EPS, use_fused=True)
    inner, algo, elastic = (opts.get("inner", "sgd"),
                            opts.get("algo", "asgd"), opts.get("live", False))
    draws = torch.Generator().manual_seed(0)
    gen = torch.Generator(device=device).manual_seed(2)
    stub = TP_STUB.get(cfg.frontend)
    stub_len = cfg.encoder_seq if cfg.frontend == "audio" else cfg.prefix_len
    out = {"losses": [], "gates": [], "ms": []}
    with expandable_segments(device):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = tp_starts(torch, cfg, wn, device)
        if mesh is not None:
            params = TP.place_params(mesh, params)
            gossip = TP.init_placed_gossip_state(params, gcfg,
                                                 elastic=elastic)
        else:
            gossip = init_gossip_state(params, gcfg, elastic=elastic)
        opt = init_inner_state(params, inner)
        step = make_train_step(cfg, algo=algo, inner=inner, gcfg=gcfg,
                               acfg=acfg, mesh=mesh)
        K.reset_launch_counts()
        for t in range(TP_STEPS + TP_TIMED):
            batch = {"tokens": torch.randint(0, cfg.vocab, (wn, 2, seq),
                                             device=device, generator=gen)}
            if stub:
                # the stub frontend's input at 0.1 x N(0, 1)
                batch[stub] = 0.1 * torch.randn(
                    (wn, 2, stub_len, cfg.d_model), device=device,
                    generator=gen)
            kw = {}
            if elastic:
                live = torch.ones((wn,), device=device)
                if t == TP_DEAD_STEP:
                    live[TP_DEAD] = 0.0
                kw["live"] = live
            if mesh is not None:
                batch = {k: shard_workers(v, mesh) for k, v in batch.items()}
                kw = {k: shard_workers(v, mesh) for k, v in kw.items()}
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, gossip, opt, m = step(params, gossip, opt, batch,
                                          *draw_gossip_indices(draws, gcfg),
                                          **kw)
            torch.cuda.synchronize()
            if t < TP_STEPS:
                out["losses"].append(float(m["loss"]))
                out["gates"].append(m["gate"].cpu() if "gate" in m
                                    else None)
            else:
                out["ms"].append((time.perf_counter() - t0) * 1e3)
            if t == TP_STEPS - 1:
                out["counts"] = K.launch_counts()
                out["params"] = [
                    (x.full_tensor() if mesh is not None else x).cpu()
                    for x in flatten_sorted(params)[0]]
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        del params, gossip, opt, step
        torch.cuda.empty_cache()
    out["ms"] = sorted(out["ms"])[len(out["ms"]) // 2]
    return out


def phase_tp(torch, device):
    """[tp]: the tensor-parallel pytree step (launch/tensor_parallel.py,
    make_train_step(mesh=)) at one rank of an NCCL group, a (1, 1)
    ("data", "model") mesh, every leaf a DTensor placed by
    launch/sharding.py, each of TP_RUNS at full width (the layers, W and
    seq it names; batch 2; the frontend's patches or frames beside the
    tokens), TP_STEPS steps each against the plain pytree step from the
    same starts, batches and draws: bitwise, or else losses within rel
    1e-5, params within atol 1e-5 and rel 1e-5, gates equal; B2r/B2a
    launched once a round on the tensor-parallel path, counters zeroed
    before and read after; each path's step time (median of TP_TIMED) and
    peak memory.  Returns the tensor-parallel path's launch counts."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.gossip_blend.kernel import APPLY_W, REDUCE_W
    from repro_torch.launch import mesh as MM

    runs = [(arch, get_arch(arch) if layers is None else
             dataclasses.replace(get_arch(arch), n_layers=layers), wn, seq)
            for arch, layers, wn, seq in TP_RUNS]
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            for arch, cfg, wn, seq in runs:
                tp, plain = tp_train_pair(torch, device, "[tp]", cfg, wn,
                                          seq, mesh)
                for name in (REDUCE_W, APPLY_W):
                    total[name] = total.get(name, 0) + tp["counts"][name]
                del tp, plain
        finally:
            dist.destroy_process_group()
    return total


def tp_train_pair(torch, device, tag, cfg, wn, seq, mesh, opts=None,
                  rounds=TP_STEPS):
    """:func:`tp_run` of ``cfg`` tensor-parallel on ``mesh`` and plain,
    under ``opts``, held together: bitwise, or else (``opts`` None: the
    steps without options) losses within rel 1e-5, params within atol
    1e-5 and rel 1e-5, gates equal; B2r/B2a launched ``rounds`` times (once
    a gossip round) on the tensor-parallel path; logged under ``tag``.
    Returns both runs."""
    import torch.distributed as dist

    from repro_torch.kernels.gossip_blend.kernel import APPLY_W, REDUCE_W

    tp = tp_run(torch, device, cfg, wn, seq, mesh, opts)
    plain = tp_run(torch, device, cfg, wn, seq, None, opts)
    arch = cfg.name
    bitwise = (tp["losses"] == plain["losses"] and all(
        torch.equal(a, b) for a, b in zip(tp["params"], plain["params"])))
    err = max(float((a - b).abs().max())
              for a, b in zip(tp["params"], plain["params"]))
    rel = max(abs(a - b) / abs(b)
              for a, b in zip(tp["losses"], plain["losses"]))
    gates = all((a is None and b is None) or torch.equal(a, b)
                for a, b in zip(tp["gates"], plain["gates"]))
    what = "" if opts is None else f" {opts}"
    if not bitwise and (opts is not None or not (
            rel <= 1e-5 and gates and all(
                torch.allclose(a, b, rtol=1e-5, atol=1e-5)
                for a, b in zip(tp["params"], plain["params"])))):
        raise AssertionError(
            f"{tag} {arch}{what}: tensor-parallel vs plain step: loss rel "
            f"{rel:.3e}, gates equal {gates}, max |param diff| {err:.3e}")
    for name in (REDUCE_W, APPLY_W):
        if tp["counts"].get(name, 0) != rounds:
            raise AssertionError(
                f"{tag} {arch}{what}: {name} launched "
                f"{tp['counts'].get(name, 0)} times in {TP_STEPS} steps "
                f"({rounds} gossip rounds), want {rounds}: {tp['counts']}")
    n_good = [None if g is None else float(g.sum()) for g in tp["gates"]]
    match = "bitwise" if bitwise else "within rel/atol 1e-5, gates equal"
    stub = TP_STUB.get(cfg.frontend)
    extra = f", {stub} {cfg.encoder_seq or cfg.prefix_len}" if stub else ""
    log(f"{tag} {arch}{what} (n_layers {cfg.n_layers}, W={wn}, batch 2, seq "
        f"{seq}{extra}) on a {dist.get_backend()} {tuple(mesh.shape)} "
        f"{mesh.mesh_dim_names} mesh: {TP_STEPS} steps {match} the plain "
        f"pytree step (losses {[round(l, 6) for l in tp['losses']]}, max "
        f"|param diff| {err:.3e}, n_good {n_good}); launches on the "
        f"tensor-parallel path {tp['counts']}; step {tp['ms']:.2f} ms vs "
        f"plain {plain['ms']:.2f} ms (median of {TP_TIMED}, after the "
        f"checked steps); peak {tp['peak_gib']:.2f} GiB vs "
        f"{plain['peak_gib']:.2f} GiB")
    return tp, plain


# [tp-options]' runs: (arch, W, seq, options) — every option of the
# pytree step that the tensor-parallel step takes beside [tp]'s: full
# smollm-135m under each, and full mamba2-370m (its 'S' layers' heads
# over `model`) on the int8 wire
TP_OPTIONS = (("smollm-135m", W, 128, {"wire": "int8"}),
              ("smollm-135m", W, 128, {"live": True}),
              ("smollm-135m", W, 128, {"inner": "momentum"}),
              ("smollm-135m", W, 128, {"inner": "adam"}),
              ("smollm-135m", W, 128, {"every": 2}),
              ("smollm-135m", W, 128, {"mode": "rows"}),
              ("smollm-135m", W, 128, {"mode": "rows", "wire": "int8"}),
              ("mamba2-370m", W, 512, {"wire": "int8"}))
TP_DEAD, TP_DEAD_STEP = 1, 1         # [tp-options]: worker 1 down on step 2


def phase_tp_options(torch, device):
    """[tp-options]: the tensor-parallel pytree step under the options
    ROADMAP items 15d and 15f brought to the mesh (TP_OPTIONS), at one
    rank of an NCCL group, a (1, 1) ("data", "model") mesh: each run
    TP_STEPS steps bitwise the plain pytree step with the same option from
    the same starts, batches and draws; B2r/B2a launched once a gossip
    round and not on gossip_every's off-rounds, counters zeroed before
    and read after; each path's step time (median of TP_TIMED) and peak
    memory.  Returns the tensor-parallel path's launch counts."""
    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.gossip_blend.kernel import APPLY_W, REDUCE_W
    from repro_torch.launch import mesh as MM

    total = {}
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tpo_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            for arch, wn, seq, opts in TP_OPTIONS:
                every = opts.get("every", 1)
                rounds = len([t for t in range(TP_STEPS) if t % every == 0])
                tp, plain = tp_train_pair(torch, device, "[tp-options]",
                                          get_arch(arch), wn, seq, mesh,
                                          opts, rounds)
                for name in (REDUCE_W, APPLY_W):
                    total[name] = total.get(name, 0) + tp["counts"][name]
                del tp, plain
        finally:
            dist.destroy_process_group()
    log(f"[tp-options] phase {time.perf_counter() - t0:.1f} s; B2r/B2a "
        f"launches on the tensor-parallel paths {total}")
    return total


TP_SERVE_BATCH, TP_SERVE_NEW = 4, 16
TP_SERVE_TOL = 1e-5                  # of the largest logit, where not bitwise
# [tp-serve]'s runs: (arch, layers (None: all), prompt).  qwen2.5-14b at
# full width cut to 2 layers, paligemma-3b to 2 layers after its 256
# patches; whisper-tiny whole after its 1500 frames (416 + 16 tokens in
# its 448 positions); the prompts of 2048 prefill through attention_flash
TP_SERVE_RUNS = (("smollm-135m", None, 2048),
                 ("qwen2.5-14b", 2, 2048),
                 ("gemma3-1b", None, 2048),
                 ("paligemma-3b", 2, 128),
                 ("whisper-tiny", None, 416))


def place_serve_consuming(TP, mesh, params):
    """``TP.place_serve_params(mesh, params)`` a leaf at a time, each plain
    leaf dropped from ``params`` once placed: a sharded leaf is copied
    even on one rank, and a whole recurrentgemma-9b (35 GiB) held twice
    would nearly fill the card."""
    from repro_torch.launch import sharding as SH

    out = {}
    for path, _ in SH.tree_paths(params):
        node, one = params, {}
        for name in path[:-1]:
            node = node[name]
        leaf = one
        for name in path[:-1]:
            leaf = leaf.setdefault(name, {})
        leaf[path[-1]] = node.pop(path[-1])
        placed = TP.place_serve_params(mesh, one)
        dest = out
        for name in path[:-1]:
            placed, dest = placed[name], dest.setdefault(name, {})
        dest[path[-1]] = placed[path[-1]]
        del one, leaf, placed
    return out


def tp_serve_run(torch, device, cfg, prompt, mesh):
    """``launch.serve.generate`` of TP_SERVE_NEW tokens at batch
    TP_SERVE_BATCH from ``init_model(cfg, 0)`` and seeded prompts (and the
    frontend's stub frames or patches) — tensor-parallel on ``mesh`` (the
    params placed by ``place_serve_params``) when given, else plain —
    twice: the first run records the logits of the prefill and of every
    decode step (``serve.greedy_tokens`` wrapped), the second is timed.
    Returns the tokens, the logits (CPU), generate's prefill and decode
    times and the peak memory while serving (from the placed params)."""
    from repro_torch.launch import serve
    from repro_torch.launch import tensor_parallel as TP
    from repro_torch.models.model import init_model

    torch.cuda.empty_cache()
    params = init_model(cfg, 0, device=device)
    if mesh is not None:
        params = place_serve_consuming(TP, mesh, params)
    # the peak while serving (placement's own transient left out)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (TP_SERVE_BATCH, prompt),
                                     device=device, generator=gen),
             **serve.stub_inputs(cfg, (TP_SERVE_BATCH,), gen, device)}
    greedy, logits = serve.greedy_tokens, []

    def recorded(x):
        logits.append((x.full_tensor() if mesh is not None else x).cpu())
        return greedy(x)
    serve.greedy_tokens = recorded
    try:
        toks, _ = serve.generate(cfg, params, batch, prompt, TP_SERVE_NEW,
                                 mesh=mesh)
    finally:
        serve.greedy_tokens = greedy
    again, t = serve.generate(cfg, params, batch, prompt, TP_SERVE_NEW,
                              mesh=mesh)
    if not torch.equal(toks, again):
        raise AssertionError(f"[tp-serve] {cfg.name}: two runs' tokens "
                             "differ")
    out = {"tokens": toks.cpu(), "logits": logits, **t,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    del params, batch
    torch.cuda.empty_cache()
    return out


def phase_tp_serve(torch, device):
    """[tp-serve]: the tensor-parallel serve (launch/steps.py
    make_prefill_step / make_decode_step(mesh=) through
    ``launch.serve.generate(mesh=)``) at one rank of an NCCL group, a
    (1, 1) ("data", "model") mesh — params placed by
    ``param_pspec(train=False)``, every cache leaf by ``cache_pspec`` (its
    KV heads over the one ``model`` rank) — for each of TP_SERVE_RUNS
    against the plain ``generate`` from the same weights and prompts:
    tokens equal, and the logits of the prefill and of every decode step
    bitwise, or else within TP_SERVE_TOL of the largest; each path's
    prefill ms, decode ms a token (generate's, the second run) and peak
    memory."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as MM

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_serve_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            for arch, layers, prompt in TP_SERVE_RUNS:
                cfg = get_arch(arch)
                if layers is not None:
                    cfg = dataclasses.replace(cfg, n_layers=layers)
                tp_serve_pair(torch, device, "[tp-serve]", cfg, prompt, mesh)
        finally:
            dist.destroy_process_group()
    log(f"[tp-serve] phase {time.perf_counter() - t0:.1f} s")


def tp_serve_pair(torch, device, tag, cfg, prompt, mesh):
    """:func:`tp_serve_run` of ``cfg`` tensor-parallel on ``mesh`` and
    plain, each with the launch counters zeroed before and read after,
    held together: tokens equal, and the logits of the prefill and of
    every decode step bitwise, or else within TP_SERVE_TOL of the largest;
    logged under ``tag``.  Returns the tensor-parallel path's launch
    counts and the plain path's, then both runs (:func:`tp_serve_run`)."""
    import torch.distributed as dist

    from repro_torch import kernels as K

    K.reset_launch_counts()
    tp = tp_serve_run(torch, device, cfg, prompt, mesh)
    tp_counts = K.launch_counts()
    K.reset_launch_counts()
    plain = tp_serve_run(torch, device, cfg, prompt, None)
    plain_counts = K.launch_counts()
    arch = cfg.name
    pairs = list(zip(tp["logits"], plain["logits"]))
    bitwise = all(torch.equal(a, b) for a, b in pairs)
    err = max(float((a - b).abs().max() / b[:, :cfg.vocab].abs().max())
              for a, b in pairs)
    if not torch.equal(tp["tokens"], plain["tokens"]) or not (
            bitwise or err <= TP_SERVE_TOL):
        raise AssertionError(
            f"{tag} {arch}: tokens equal "
            f"{torch.equal(tp['tokens'], plain['tokens'])}, largest logit "
            f"difference {err:.3e} of the largest logit (gate "
            f"{TP_SERVE_TOL})")
    stub = {"audio": f", {cfg.encoder_seq} frames",
            "vision": f", {cfg.prefix_len} patches"}.get(cfg.frontend, "")
    log(f"{tag} {arch} (n_layers {cfg.n_layers}, batch {TP_SERVE_BATCH}, "
        f"prompt {prompt}{stub}, {TP_SERVE_NEW} tokens) on a "
        f"{dist.get_backend()} {tuple(mesh.shape)} {mesh.mesh_dim_names} "
        f"mesh: tokens equal, logits of the prefill and {len(pairs) - 1} "
        f"decode steps {'bitwise' if bitwise else f'within {err:.3e}'} the "
        f"plain serve's; prefill {tp['prefill_ms']:.3f} ms vs plain "
        f"{plain['prefill_ms']:.3f} ms, decode "
        f"{tp['decode_ms_per_token']:.3f} vs "
        f"{plain['decode_ms_per_token']:.3f} ms a token; peak "
        f"{tp['peak_gib']:.2f} GiB vs {plain['peak_gib']:.2f} GiB; launches "
        f"(two generate runs each) {tp_counts} vs {plain_counts}")
    return tp_counts, plain_counts, tp, plain


# [tp-ssm]'s runs.  Training: (arch, layers (None: all), W, seq), batch 2:
# mamba2-370m whole at W 4 (1.5 GiB a replica; the pytree engine holds ~9
# copies); recurrentgemma-9b at full width cut to one (R, R, L) cycle at
# W 1 (6.9 GiB a replica, the 1 GiB embedding included: W 2 would not
# fit).  Serving: (arch, prompt), both whole, batch TP_SERVE_BATCH,
# TP_SERVE_NEW tokens.
TP_SSM_TRAIN = (("mamba2-370m", None, W, 512),
                ("recurrentgemma-9b", 3, 1, 512))
TP_SSM_SERVE = (("mamba2-370m", 2048), ("recurrentgemma-9b", 2048))


def phase_tp_ssm(torch, device):
    """[tp-ssm]: tensor parallelism for the 'S' (Mamba-2 SSD) and 'R'
    (RG-LRU) archs at one rank of an NCCL group, a (1, 1) ("data",
    "model") mesh: each of TP_SSM_TRAIN's pytree steps against the plain
    pytree step (:func:`tp_train_pair`: bitwise or within 1e-5, gates
    equal, B2r/B2a once a round), and each of TP_SSM_SERVE's generate
    against the plain one (:func:`tp_serve_pair`: tokens equal, logits
    bitwise or within TP_SERVE_TOL).  B5 and B5b launch as often on the
    tensor-parallel path as on the plain one — the counters zeroed before
    each path and read after — and at least once where the config has
    'S' layers.  Returns the tensor-parallel paths' B5/B5b launches."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan.kernel import SCAN, SCAN_BWD
    from repro_torch.launch import mesh as MM

    def same_scans(arch, what, tp, plain, names):
        for name in names:
            n = tp.get(name, 0)
            if n != plain.get(name, 0) or (n == 0 and "S" in get_arch(
                    arch).pattern_cycle):
                raise AssertionError(
                    f"[tp-ssm] {arch} {what}: {name} launched {n} times on "
                    f"the tensor-parallel path, {plain.get(name, 0)} on the "
                    "plain one")
            total[name] = total.get(name, 0) + n

    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_ssm_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            for arch, layers, wn, seq in TP_SSM_TRAIN:
                cfg = get_arch(arch)
                if layers is not None:
                    cfg = dataclasses.replace(cfg, n_layers=layers)
                t1 = time.perf_counter()
                tp, plain = tp_train_pair(torch, device, "[tp-ssm]", cfg, wn,
                                          seq, mesh)
                same_scans(arch, "training", tp["counts"], plain["counts"],
                           (SCAN, SCAN_BWD))
                del tp, plain
                log(f"[tp-ssm] {arch} training: both paths in "
                    f"{time.perf_counter() - t1:.1f} s")
            for arch, prompt in TP_SSM_SERVE:
                t1 = time.perf_counter()
                same_scans(arch, "serving", *tp_serve_pair(
                    torch, device, "[tp-ssm]", get_arch(arch), prompt,
                    mesh)[:2], (SCAN,))
                log(f"[tp-ssm] {arch} serving: both paths in "
                    f"{time.perf_counter() - t1:.1f} s")
        finally:
            dist.destroy_process_group()
    log(f"[tp-ssm] phase {time.perf_counter() - t0:.1f} s; B5/B5b launches "
        f"on the tensor-parallel paths {total}")
    return total


# [tp-moe]'s runs.  Training: full granite-moe-1b-a400m (24 layers, 32
# experts top-8) at W 1, seq 128, batch 2: a replica is 5.3 GB and the
# pytree engine holds ~9 copies, so W 2 would not fit beside the plain
# pair; phi3.5-moe (168 GB a replica in f32) does not train on one card.
# Serving: granite whole and phi3.5-moe at PHI_LAYERS of its 32 layers,
# as [moe-serve] serves them, batch TP_SERVE_BATCH, TP_SERVE_NEW tokens
TP_MOE_TRAIN = (("granite-moe-1b-a400m", None, 1, 128),)
TP_MOE_SERVE = (("granite-moe-1b-a400m", None, 2048),
                ("phi3.5-moe-42b-a6.6b", 4, 2048))
TP_PEAK_RATIO = 1.05                 # [tp-moe]: peaks within 5% of plain


def phase_tp_moe(torch, device):
    """[tp-moe]: expert parallelism for the MoE archs (models/moe.py
    ``_apply_placed``) at one rank of an NCCL group, a (1, 1) ("data",
    "model") mesh, every expert local: each of TP_MOE_TRAIN's pytree
    steps against the plain pytree step (:func:`tp_train_pair`: bitwise
    or within 1e-5, gates equal, B2r/B2a once a round), and each of
    TP_MOE_SERVE's generate against the plain one (:func:`tp_serve_pair`:
    tokens equal, logits bitwise or within TP_SERVE_TOL).  The placed
    MoE's call counter, zeroed before each pair and read after (the
    plain path never calls it), is above 0; each peak within
    TP_PEAK_RATIO of the plain path's.  Returns the tensor-parallel
    paths' B2r/B2a launches."""
    import dataclasses

    import torch.distributed as dist

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.gossip_blend.kernel import APPLY_W, REDUCE_W
    from repro_torch.launch import mesh as MM
    from repro_torch.models import moe

    def checked(arch, what, tp, plain):
        calls = moe.placed_calls()
        if calls == 0 or tp["peak_gib"] > TP_PEAK_RATIO * plain["peak_gib"]:
            raise AssertionError(
                f"[tp-moe] {arch} {what}: {calls} placed MoE calls, peak "
                f"{tp['peak_gib']:.2f} GiB against the plain path's "
                f"{plain['peak_gib']:.2f} GiB")
        log(f"[tp-moe] {arch} {what}: {calls} placed MoE calls on the "
            f"tensor-parallel path; peak ratio "
            f"{tp['peak_gib'] / plain['peak_gib']:.4f}")

    def config(arch, layers):
        cfg = get_arch(arch)
        return cfg if layers is None else dataclasses.replace(
            cfg, n_layers=layers)

    t0 = time.perf_counter()
    total = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_moe_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            for arch, layers, wn, seq in TP_MOE_TRAIN:
                t1 = time.perf_counter()
                moe.reset_placed_calls()
                tp, plain = tp_train_pair(torch, device, "[tp-moe]",
                                          config(arch, layers), wn, seq, mesh)
                checked(arch, "training", tp, plain)
                for name in (REDUCE_W, APPLY_W):
                    total[name] = total.get(name, 0) + tp["counts"][name]
                del tp, plain
                log(f"[tp-moe] {arch} training: both paths in "
                    f"{time.perf_counter() - t1:.1f} s")
            for arch, layers, prompt in TP_MOE_SERVE:
                t1 = time.perf_counter()
                moe.reset_placed_calls()
                _, _, tp, plain = tp_serve_pair(
                    torch, device, "[tp-moe]", config(arch, layers), prompt,
                    mesh)
                checked(arch, "serving", tp, plain)
                del tp, plain
                log(f"[tp-moe] {arch} serving: both paths in "
                    f"{time.perf_counter() - t1:.1f} s")
        finally:
            dist.destroy_process_group()
    log(f"[tp-moe] phase {time.perf_counter() - t0:.1f} s; B2r/B2a launches "
        f"on the tensor-parallel training paths {total}")
    return total


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
    over the kernels whose names hold one of ``parts``, from a
    torch.profiler trace of ``reps`` calls.  A session can drop a device
    event, so each part's time is its mean over the launches the trace
    kept, times its launches a call (the kept ones over ``reps``,
    rounded).  Returns (ms a call, launches a call, the parts that ran,
    the events kept, of the launches a call x ``reps``), or None when the
    trace holds no such device events."""
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
    ms, launches, ran, kept = 0.0, 0, [], 0
    for part in parts:
        us = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and part in e.name]
        if us:
            per_call = max(1, round(len(us) / reps))
            ms += sum(us) / len(us) * per_call / 1e3
            launches, kept = launches + per_call, kept + len(us)
            ran.append(part)
    if not ran:
        return None
    return ms, launches, tuple(ran), kept


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
                + (f"{dev[0]:.4f} ms of device time a call ({dev[1]} "
                   f"device launches: {' and '.join(dev[2])}; "
                   f"torch.profiler over {reps} calls kept {dev[3]} of "
                   f"{dev[1] * reps} events)" if dev else
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


def check_logits(torch, tag, pairs):
    """(CPU, GPU) logits per step within TOL_SERVE of their largest
    magnitude, and the greedy tokens equal wherever the CPU's top-2 margin
    exceeds twice that.  Returns (max abs err per step, near ties)."""
    errs, near = [], 0
    for lc, lg in pairs:
        scale = float(lc.abs().max())
        err = float((lg - lc).abs().max())
        if not err <= TOL_SERVE * scale:
            raise AssertionError(f"{tag}: logits differ by {err:.3e} > "
                                 f"{TOL_SERVE} x {scale:.3e}")
        errs.append(err)
        top = torch.topk(lc, 2, dim=-1).values
        clear = (top[:, 0] - top[:, 1]) > 2 * TOL_SERVE * scale
        near += int((~clear).sum())
        if not bool((lg.argmax(-1) == lc.argmax(-1))[clear].all()):
            raise AssertionError(f"{tag}: greedy tokens differ off a "
                                 f"near-tie")
    return errs, near


def check_cache(torch, tag, got, want):
    """Every cache leaf of ``got`` close to ``want``'s (bf16 leaves within
    one bf16 step, 1e-2, of their largest magnitude; f32 ones within
    TOL_SERVE).  Returns the max abs err."""
    from repro_torch.core.tree import flatten_sorted
    cache_err = 0.0
    for a, b in zip(flatten_sorted(got)[0], flatten_sorted(want)[0]):
        tol = 1e-2 if b.dtype == torch.bfloat16 else TOL_SERVE
        d = float((a.float().cpu() - b.float()).abs().max())
        if not d <= tol * max(float(b.float().abs().max()), 1e-30):
            raise AssertionError(f"{tag}: a cache leaf differs by {d:.3e}")
        cache_err = max(cache_err, d)
    return cache_err


def phase_serve_check(torch, device):
    """Reduced mamba2-370m and smollm-135m (prompts of 32, and smollm's of
    2048 too: its 'G' layers then take attention_flash), the same CPU-made
    weights and prompts on the GPU (B5 in every 'S' layer) and the CPU
    (plain): the prefill's and 4 decode steps' logits within TOL_SERVE of
    their largest magnitude, the greedy tokens equal wherever the CPU's
    top-2 margin exceeds twice that, and every cache leaf close."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
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
        tag = f"serve check {arch}"
        errs, near = check_logits(torch, tag, zip(cpu[0], gpu[0]))
        cache_err = check_cache(torch, tag, gpu[2], cpu[2])
        log(f"[serve-check] reduced {arch}, batch 2, prompt {plen}, 4 decode "
            f"steps: GPU vs CPU logits max abs err "
            f"{[float(f'{e:.3e}') for e in errs]}, greedy tokens equal "
            f"({near} near ties), cache leaves max abs err {cache_err:.3e}; "
            f"launches {counts}")


def serve_timings(torch, cfg, params, batch, tag="serve"):
    """Two ``serve.generate`` runs (warm-up, steady) of SERVE_NEW tokens;
    returns the steady run's tokens and timings."""
    from repro_torch.launch import serve
    prompt = batch["tokens"].shape[1]
    for label in ("warm-up", "steady"):
        toks, t = serve.generate(cfg, params, batch, prompt, SERVE_NEW)
        log(f"[{tag}] {cfg.name} generate ({label}): prefill "
            f"{t['prefill_ms']:.3f} ms, decode {t['decode_ms_per_token']:.3f}"
            f" ms per token, {SERVE_BATCH * t['steps_per_s']:.1f} tokens/s "
            f"decoded, {SERVE_BATCH * prompt / t['prefill_ms'] * 1e3:.0f} "
            f"prompt tokens/s")
    return toks, t


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
    entry a call: the call's keyword arguments) and restores it after."""
    real, calls = getattr(module, name), []

    def counted(*a, **k):
        calls.append(k)
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
        # one launch a call: device_ms averages over the launches the
        # trace kept (a session may drop one of its events)
        dev = device_ms(torch, run, (name,), 5)
        stages.append(f"{name} " + ("not traced" if dev is None
                                    else f"{dev[0]:.4f}"))
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


def check_train_run(tag, losses, counts, steps, want):
    """A training run's losses finite, one a step, and its launch counts
    those of ``want``."""
    if len(losses) != steps or not all(map(math.isfinite, losses)):
        raise AssertionError(f"{tag}: losses {losses}")
    if any(counts.get(k) != v for k, v in want.items()):
        raise AssertionError(f"{tag}: launches {counts}, want {want} in "
                             f"{steps} steps")


def run_trainer(torch, tag, argv, steps, want):
    """``repro_torch.launch.train.main(argv)`` with the launch counters
    zeroed just before and read just after and the peak memory reset,
    held by :func:`check_train_run`.  Returns (its output, the counts, the
    peak memory in GiB)."""
    from repro_torch import kernels as K
    from repro_torch.launch import train

    log(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    out = train.main(argv)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_train_run(tag, out["losses"], counts, steps, want)
    return out, counts, torch.cuda.max_memory_allocated() / 2**30


def phase_ssm_train_check(torch, device):
    """Reduced mamba2-370m (seq 32: 4 chunks of 8), 3 pipelined int8
    steps, GPU (B5, B5b, B1) against CPU (plain versions)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan.kernel import SCAN, SCAN_BWD

    gpu, cpu, n_good, err, counts, seed = pipelined_check(
        torch, device, "mamba2-370m", "ssm-train-check")
    layers = get_arch("mamba2-370m").reduced().n_layers
    # the forward rematerializes: backward reruns B5 once a layer
    if counts.get(SCAN) != 2 * 3 * layers or \
            counts.get(SCAN_BWD) != 3 * layers:
        raise AssertionError(f"ssm-train-check: launches {counts} in 3 "
                             f"steps of {layers} 'S' layers (B5 twice a "
                             f"layer a step under remat)")
    log(f"[ssm-train-check] reduced mamba2-370m, W={W}, seq 32 (4 chunks of "
        f"8), 3 pipelined int8 steps, draw seed {seed}: GPU vs CPU losses "
        f"{[round(l, 6) for l in gpu]} vs {[round(l, 6) for l in cpu]}, "
        f"n_good {n_good}, max |ensemble diff| {err:.3e}; GPU launches "
        f"{counts}")


def phase_ssm_train(torch, device):
    """``repro_torch.launch.train`` on full mamba2-370m, counters zeroed
    before and read after — B5 and B5b once per layer a step, B1r/B1a once
    a step — its steady step time and peak memory; then the forward and
    backward of one step by CUDA events and a profile of it.  Returns the
    run's launch counts of B5b."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.kernels.ssd_scan.kernel import SCAN, SCAN_BWD
    from repro_torch.launch.steps import packed_loss_and_grad
    from repro_torch.models.model import init_model

    cfg = get_arch("mamba2-370m")
    # B5 twice a layer a step: the rematerialized forward reruns in backward
    want = {SCAN: 2 * cfg.n_layers * SSM_TRAIN_STEPS,
            SCAN_BWD: cfg.n_layers * SSM_TRAIN_STEPS,
            REDUCE: SSM_TRAIN_STEPS, APPLY: SSM_TRAIN_STEPS}
    out, counts, peak = run_trainer(torch, "ssm-train",
                                    train_argv("mamba2-370m", W,
                                               SSM_TRAIN_SEQ,
                                               SSM_TRAIN_STEPS),
                                    SSM_TRAIN_STEPS, want)
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


# ---------------------------------------------------------------------------
# the MoE slice: granite-moe-1b-a400m trained at full size through B1r/B1a
# (its packed ensemble past 2^31 elements), and served with phi3.5-moe
# (depth cut) at full width; the expert products are cuBLAS matmuls
# ---------------------------------------------------------------------------

MOE_ARCH, PHI_ARCH = "granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"
MOE_W = 2                        # [moe-train] workers: at 4 a step runs
#                                  out of the card's 80 GB (PERF.md §4)
MOE_BLEND_WS = (MOE_W, 4)         # [moe-blend]: the training path's
#                                  ensemble, then W=4's (past 2^32)
MOE_TRAIN_STEPS, MOE_SEQ = 8, 128
PHI_LAYERS = 4                   # phi3.5-moe's 32 layers cut to fit a card
PAST_ELEMENT = 2**31             # [moe-blend]: rows checked lie past it


def phase_moe_train_check(torch, device):
    """Reduced granite-moe and phi3.5-moe, 3 pipelined int8 steps from
    distinct worker starts, GPU (B1r/B1a) against CPU: losses (aux
    included) rel 1e-4, ensembles atol 1e-4, n_good equal, not all 0."""
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE

    for arch in (MOE_ARCH, PHI_ARCH):
        gpu, cpu, n_good, err, counts, seed = pipelined_check(
            torch, device, arch, "moe-train-check")
        if counts.get(REDUCE) != 3 or counts.get(APPLY) != 3:
            raise AssertionError(f"moe-train-check {arch}: launches {counts}"
                                 f" in 3 steps")
        log(f"[moe-train-check] reduced {arch}, W={W}, batch 2, seq 32, 3 "
            f"pipelined int8 steps, draw seed {seed}: GPU vs CPU losses "
            f"{[round(l, 6) for l in gpu]} vs {[round(l, 6) for l in cpu]}"
            f", n_good {n_good}, max |ensemble diff| {err:.3e}; GPU "
            f"launches {counts}")


def moe_layer_fwd_bwd(torch, cfg, layer, device):
    """One MoE layer's apply_moe forward+backward at the training step's
    shapes (MOE_W workers, batch 2, seq MOE_SEQ) on ``layer``'s weights
    and a seeded input: two runs' gradients of x and every leaf bitwise
    equal, then their time by CUDA events.  Returns (ms, dropped pairs,
    pairs)."""
    from repro_torch.models import moe

    leaves = {n: v.detach().clone().requires_grad_(True)
              for n, v in layer.items()}
    names = sorted(leaves)
    g = torch.Generator(device=device).manual_seed(2)
    shape = (MOE_W, 2, MOE_SEQ, cfg.d_model)
    x = torch.randn(shape, generator=g, device=device).requires_grad_(True)
    r = torch.randn(shape, generator=g, device=device)
    k, groups = cfg.experts_per_token, cfg.moe_dispatch_groups

    def fwd_bwd():
        y, aux = moe.apply_moe(leaves, x, k, act=cfg.act,
                               capacity_factor=cfg.capacity_factor,
                               dispatch_groups=groups)
        loss = (y * r).sum() + cfg.router_aux_weight * aux.sum()
        return torch.autograd.grad(loss, [x] + [leaves[n] for n in names])

    first, again = fwd_bwd(), fwd_bwd()
    for n, a, b in zip(["x"] + names, first, again):
        if not torch.equal(a, b):
            raise AssertionError(f"moe-train: the gradient of {n} of one "
                                 f"layer differs between two runs")
    with torch.no_grad():
        tg = 2 * MOE_SEQ // groups             # tokens a group, per worker
        _, idx, _, _ = moe.route(leaves, x.reshape(MOE_W, groups, tg, -1),
                                 k)
        cap = max(1, int(cfg.capacity_factor * tg * k / cfg.n_experts))
        _, keep = moe.capacity_slots(idx, cfg.n_experts, cap)
    return cuda_ms(fwd_bwd, 5), int((~keep).sum()), keep.numel()


def phase_moe_train(torch, device):
    """``repro_torch.launch.train`` on full granite-moe-1b-a400m, counters
    zeroed before and read after — B1r/B1a once a step — its steady step
    time and peak memory; then on its final ensemble the forward and
    backward of one step by CUDA events and a profile of it, and one
    layer's apply_moe forward+backward (bitwise repeatable) times the
    layers: MoE's share of the forward+backward."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.packing import unpack_w
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch.steps import packed_loss_and_grad

    cfg = get_arch(MOE_ARCH)
    out, counts, peak = run_trainer(
        torch, "moe-train",
        train_argv(MOE_ARCH, MOE_W, MOE_SEQ, MOE_TRAIN_STEPS), MOE_TRAIN_STEPS,
        {REDUCE: MOE_TRAIN_STEPS, APPLY: MOE_TRAIN_STEPS})
    losses = out["losses"]
    router = out["params"]["scan"]["pos0"]["moe"]["router"]
    if tuple(router.shape) != (MOE_W, cfg.n_layers, cfg.d_model,
                               cfg.n_experts) or \
            not bool(torch.isfinite(router).all()):
        raise AssertionError(f"moe-train: final average router "
                             f"{tuple(router.shape)} not finite/shaped")
    packed, spec = out["state"]["params"], out["spec"]
    median = steady_median(out["step_seconds"])
    log(f"[moe-train] W={MOE_W}, packed ensemble {tuple(packed.shape)} = "
        f"{packed.numel():,} f32 elements ({packed.numel() / 2**31:.2f} x "
        f"2^31); launches {counts} over {MOE_TRAIN_STEPS} steps; losses "
        f"{[round(l, 4) for l in losses]}; step seconds "
        f"{[round(t, 4) for t in out['step_seconds']]} (first includes "
        f"warm-up); steady median {median * 1e3:.2f} ms; n_good "
        f"{out['n_good']}; peak memory {peak:.2f} GiB")
    del out, router
    torch.cuda.empty_cache()

    batch = {"tokens": torch.randint(
        0, cfg.vocab, (MOE_W, 2, MOE_SEQ), device=device,
        generator=torch.Generator(device=device).manual_seed(0))}
    fb = lambda: packed_loss_and_grad(cfg, packed, batch, spec)  # noqa: E731
    t_fb = cuda_ms(fb, 3)
    log(f"[moe-train] forward+backward of one step (W={MOE_W}, batch 2, "
        f"seq {MOE_SEQ}, packed gradient): {t_fb:.3f} ms by CUDA events")
    profile_step(torch, "moe-train-profile", fb,
                 what="one forward+backward")
    layer = {n: v[:, 0] for n, v in
             unpack_w(packed, spec)["scan"]["pos0"]["moe"].items()}
    t_moe, dropped, pairs = moe_layer_fwd_bwd(torch, cfg, layer, device)
    log(f"[moe-train] one layer's apply_moe forward+backward (layer 0's "
        f"weights, a seeded input, {dropped} of {pairs} (token, slot) "
        f"pairs dropped): {t_moe:.3f} ms by CUDA events, gradients bitwise "
        f"equal over two runs; x {cfg.n_layers} layers = "
        f"{t_moe * cfg.n_layers:.3f} ms, {t_moe * cfg.n_layers / t_fb:.1%} "
        f"of the forward+backward")
    del packed, batch, layer
    torch.cuda.empty_cache()


def phase_moe_blend(torch, device):
    """B1r/B1a on granite-moe's packed ensemble at each of MOE_BLEND_WS
    workers: MOE_W, the ensemble [moe-train] blends, then 4."""
    from repro_torch.configs.registry import get_arch

    for wn in MOE_BLEND_WS:
        blend_check(torch, device, "moe-blend", get_arch(MOE_ARCH), wn,
                    " (the [moe-train] path's ensemble)" if wn == MOE_W
                    else "")


def blend_check(torch, device, tag, cfg, wn, note=""):
    """B1r/B1a on ``cfg``'s packed ensemble at ``wn`` workers (its last
    worker's rows past element 2^31 wherever the ensemble is larger):
    pack_w/unpack_w of the model bitwise on the last worker, the int8
    exchange (quantize + roll) bitwise on its rows, then each kernel
    against its plain version on that worker's rows — the reduce over the
    last partition, the apply on windows across the partition's edges and
    the ensemble's end — and both kernels' times against their bounds."""
    from repro_torch.core import gossip as G
    from repro_torch.core.packing import (pack_spec_w, pack_w,
                                          quantize_rows, unpack_w)
    from repro_torch.core.tree import flatten_sorted, tree_map
    from repro_torch.kernels.gossip_blend import gossip_gates
    from repro_torch.kernels.gossip_blend.kernel import (
        gossip_apply_w_resident, gossip_reduce_w_resident)
    from repro_torch.kernels.gossip_blend.ref import (
        gossip_apply_w_resident_plain, gossip_reduce_w_resident_plain)
    from repro_torch.launch.train import gossip_config
    from repro_torch.models.model import init_model

    gcfg = gossip_config(wn, wire_format="int8")
    params = init_model(cfg, 0, device=device)
    wp = tree_map(lambda x: x.expand((wn,) + tuple(x.shape)), params)
    spec = pack_spec_w(wp, block_rows=gcfg.fused_block_rows,
                       groups=G.leaf_groups(wp, gcfg.partial_blocks),
                       n_groups=gcfg.partial_blocks)
    w = pack_w(wp, spec)
    for a, b in zip(flatten_sorted(params)[0],
                    flatten_sorted(unpack_w(w, spec))[0]):
        if not torch.equal(b[-1], a):
            raise AssertionError(f"{tag}: unpack_w(pack_w(.)) of the "
                                 f"last worker is not the model")
    del params, wp
    torch.cuda.empty_cache()
    br, rows = spec.block_rows, spec.rows
    r0, r1 = G.packed_row_ranges(spec, gcfg)[-1]
    first = ((wn - 1) * rows + r0) * 512
    past = w.numel() > PAST_ELEMENT
    if past and first < PAST_ELEMENT:
        raise AssertionError(f"{tag}: the last worker's range starts at "
                             f"element {first:,}, not past 2^31")
    g = torch.Generator(device=device).manual_seed(3)
    dw = torch.empty_like(w)
    for i in range(wn):      # distinct workers, and a local step
        w[i].add_(torch.randn(w[i].shape, generator=g, device=device),
                  alpha=0.01)
        dw[i].normal_(generator=g).mul_(0.01)
    shift = gcfg.shifts[0]
    ext, scales = G.quantized_exchange_body(
        w, r0, r1, br, lambda x: torch.roll(x, shift, dims=0))
    q, sc = quantize_rows(w[(wn - 1 - shift) % wn, r0:r1], br)
    if not (torch.equal(ext[-1, r0:r1], q) and torch.equal(
            scales[-1, r0 // br:r1 // br], sc) and not ext[-1, :r0].any()
            and not ext[-1, r1:].any()):
        raise AssertionError(f"{tag}: the int8 exchange differs on the "
                             f"last worker's rows")
    del q, sc
    ext, scales = ext[:, None], scales[:, None]
    red = lambda: gossip_reduce_w_resident(           # noqa: E731
        w, dw, ext, (r0, r1), scales, block_rows=br)
    red_plain = lambda: gossip_reduce_w_resident_plain(  # noqa: E731
        w[-1:], dw[-1:], ext[-1:], (r0, r1), scales[-1:], block_rows=br)
    acc = red()
    torch.cuda.synchronize()
    where = " (past 2^31)" if past else ""
    err_r, rel = check_reduce(torch, f"B1r{where}", acc[-1:],
                              red_plain(), lambda: red()[-1:])
    gates = gossip_gates(acc, EPS)
    inv = 1.0 / (gates.sum(dim=1) + 1.0)
    app = lambda: gossip_apply_w_resident(            # noqa: E731
        w, dw, ext, gates, inv, LR, (r0, r1), scales, block_rows=br)
    out = app()
    torch.cuda.synchronize()
    err_a = 0.0
    windows = [(r0 - 8 * br, r0 + 8 * br), ((r0 + r1) // 2 // br * br,
                                             (r0 + r1) // 2 // br * br
                                             + 16 * br),
               (r1 - 8 * br, r1 + 8 * br), (rows - 16 * br, rows)]
    for a, b in windows:
        a, b = max(a, 0), min(b, rows)
        out_p = gossip_apply_w_resident_plain(
            w[-1:, a:b], dw[-1:, a:b], ext[-1:, :, a:b], gates[-1:],
            inv[-1:], LR, (r0 - a, r1 - a), scales[-1:, :, a // br:b // br],
            block_rows=br)
        err_a = max(err_a, check_apply(torch, f"B1a{where}",
                                       out[-1:, a:b], out_p))
    del out, out_p
    torch.cuda.empty_cache()
    # the bytes and operations of phase_kernels' B1 bounds at P = 1, int8
    n_in, n_all = wn * (r1 - r0) * 512, wn * rows * 512
    sc_b = wn * ((r1 - r0) // br) * 4
    ms_r, ms_a = cuda_ms(red, 10), cuda_ms(app, 3)
    plain_r = cuda_ms(red_plain, 3)
    b_r, by_r = bound_ms(n_in * 9 + sc_b + wn * 12, n_in * 9)
    b_a, by_a = bound_ms(n_all * 12 + n_in + sc_b + wn * 8 + 4,
                         n_all * 2 + n_in * 7)
    log(f"[{tag}] B1r/B1a on {cfg.name}'s ensemble {tuple(w.shape)} "
        f"({w.numel():,} elements), last partition rows [{r0}, {r1}), the "
        f"last worker's from element {first:,}: exchange and pack bitwise; "
        f"B1r vs plain (last worker) rel err {rel:.2e}, bitwise "
        f"repeatable; B1a vs plain on {len(windows)} windows max abs err "
        f"{err_a:.3e}")
    log(f"[{tag}] B1r {ms_r:.4f} ms (bound {b_r:.4f} ms, {by_r}, "
        f"{b_r / ms_r:.1%}; plain on the last worker's rows {plain_r:.4f} "
        f"ms), B1a {ms_a:.4f} ms (bound {b_a:.4f} ms, {by_a}, "
        f"{b_a / ms_a:.1%}) at R={rows}, W={wn}{note}")
    del w, dw, ext, scales, acc
    torch.cuda.empty_cache()


def bf16_steps(torch, got, want):
    """Over the bf16 cache leaves, how far ``got``'s elements lie from
    ``want``'s in bf16 steps (adjacent bf16 values are one step apart).
    Returns (elements, elements that differ, of those one step apart,
    the largest number of steps, the largest |want| of an element more
    than one step off, the largest abs difference)."""
    from repro_torch.core.tree import flatten_sorted

    def ordered(t):                  # bf16 bit patterns in value order
        i = t.cpu().view(torch.int16).int()
        return torch.where(i < 0, -(i & 0x7FFF), i)
    n = diff = one = most = 0
    far = gap = 0.0
    for x, y in zip(flatten_sorted(got)[0], flatten_sorted(want)[0]):
        if y.dtype == torch.bfloat16:
            d = (ordered(x) - ordered(y)).abs()
            n, diff = n + d.numel(), diff + int((d > 0).sum())
            one, most = one + int((d == 1).sum()), max(most, int(d.max()))
            yf = y.float().cpu()
            if bool((d > 1).any()):
                far = max(far, float(yf[d > 1].abs().max()))
            gap = max(gap, float((x.float().cpu() - yf).abs().max()))
    return n, diff, one, most, far, gap


def phase_moe_serve_check(torch, device):
    """Reduced granite-moe and phi3.5-moe (batch 2, prompts of 32) through
    :func:`serve_check_free`."""
    for arch in (MOE_ARCH, PHI_ARCH):
        serve_check_free(torch, device, arch, "moe-serve-check")


def serve_check_free(torch, device, arch, tag, plen=32, steps=4,
                     perturb=False):
    """Reduced ``arch`` (batch 2, prompts of ``plen`` after the frontend's
    stub frames or patches), the same CPU-made weights and prompts on the GPU
    and the CPU, the CPU's greedy tokens fed to every run.  Each decode
    step runs three times on the GPU's side: from the CPU's cache before it
    (the step alone), and free-running from the GPU's own cache — which the
    CPU then also steps from.  Held within TOL_SERVE of their largest
    magnitude, with the greedy tokens equal off near-ties: the prefill's
    logits, each step's from the CPU's cache, and the free-running GPU's
    against the CPU's step on that same cache; every cache leaf after each
    step close.  The free-running logits against the CPU's own free-running
    ones are reported beside what the cache's difference alone does (the
    CPU on the GPU's cache against the CPU on its own), and the bf16 cache
    elements that differ in bf16 steps: the KV cache is bf16, and a GPU-vs-
    CPU difference of one f32 rounding can round an element to the
    neighbouring bf16 value, which free-running decode carries into every
    later step.  ``perturb``: the weights go through :func:`perturbed`
    first.  Returns the GPU's cache after the prefill."""
    from repro_torch import kernels as K
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree import tree_map
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import model as M
    from repro_torch.models.model import init_model, vision_prefix

    cfg = get_arch(arch).reduced()
    params = init_model(cfg, 0, device="cpu")
    if perturb:
        params = perturbed(torch, params)
    pg = tree_map(lambda x: x.to(device), params)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, plen), generator=gen),
             **stub_inputs(cfg, (2,), gen, "cpu")}
    start = plen + vision_prefix(cfg)       # decode writes after a prefix
    tag = f"{tag} {arch}"
    K.reset_launch_counts()
    with torch.no_grad():
        last_c, cache_c = M.prefill(cfg, params, batch,
                                    cache_len=start + steps)
        last_g, free_g = M.prefill(cfg, pg, tree_map(
            lambda x: x.to(device), batch), cache_len=start + steps)
        prefilled = tree_map(torch.clone, free_g)
        pairs = [(last_c, last_g.cpu())]
        cache_errs = [check_cache(torch, tag, free_g, cache_c)]
        drift = [bf16_steps(torch, free_g, cache_c)]
        on_own, free, carry = [], [], []
        tok = last_c.argmax(-1)
        for i in range(steps):
            # copies even where the device is the CPU's: decode writes its
            # cache in place
            cache_g = tree_map(lambda x: x.to(device, copy=True), cache_c)
            cache_x = tree_map(lambda x: x.to("cpu", copy=True), free_g)
            step_c, cache_c = M.decode_step(cfg, params, tok, start + i,
                                            cache_c)
            step_g, cache_g = M.decode_step(cfg, pg, tok.to(device),
                                            start + i, cache_g)
            step_f, free_g = M.decode_step(cfg, pg, tok.to(device),
                                           start + i, free_g)
            step_x, cache_x = M.decode_step(cfg, params, tok, start + i,
                                            cache_x)
            pairs.append((step_c, step_g.cpu()))
            on_own.append((step_x, step_f.cpu()))
            cache_errs.append(check_cache(torch, tag, cache_g, cache_c))
            check_cache(torch, f"{tag} free-running", free_g, cache_x)
            drift.append(bf16_steps(torch, free_g, cache_c))
            free.append(float((step_f.cpu() - step_c).abs().max()))
            carry.append(float((step_x - step_c).abs().max()))
            tok = step_c.argmax(-1)
    counts = K.launch_counts()
    if counts:
        raise AssertionError(f"{tag}: launches {counts}")
    errs, near = check_logits(torch, tag, pairs)
    own, near_own = check_logits(torch, f"{tag} free-running", on_own)
    scale = float(pairs[-1][0].abs().max())
    fmt = lambda v: [float(f"{e:.3e}") for e in v]  # noqa: E731
    log(f"[{tag}] reduced, batch 2, prompt {plen}, {steps} decode steps "
        f"each from the CPU's cache: GPU vs CPU logits max abs err "
        f"{fmt(errs)} (largest magnitude {scale:.3f}), greedy tokens equal "
        f"({near} near ties), cache leaves max abs err "
        f"{max(cache_errs):.3e}")
    log(f"[{tag}] reduced, free-running: the GPU's decode on its own cache "
        f"vs the CPU's on that cache, max abs err {fmt(own)} ({near_own} "
        f"near ties); vs the CPU's free run {fmt(free)} "
        f"({max(free) / scale:.2e} of the largest magnitude), the cache's "
        f"difference alone (CPU on the GPU's cache vs on its own) "
        f"{fmt(carry)}; bf16 cache elements that differ (of "
        f"{drift[0][0]:,}; after the prefill, then each step): "
        f"{[d[1] for d in drift]}, of them one bf16 step apart "
        f"{[d[2] for d in drift]}, most steps apart {[d[3] for d in drift]},"
        f" the largest magnitude of an element more than one step apart "
        f"{max(d[4] for d in drift):.3e}, the largest difference "
        f"{max(d[5] for d in drift):.3e}")
    return prefilled


def phase_moe_serve(torch, device):
    """``launch.serve.main`` on full granite-moe (batch 4, prompt 2048, 32
    new tokens: every 'G' layer of the prefill through attention_flash,
    counted); then :func:`serve_readings` of it and of phi3.5-moe at full
    width with its depth cut to PHI_LAYERS."""
    import dataclasses

    from repro_torch.configs.registry import get_arch

    cfg = get_arch(MOE_ARCH)
    serve_main_checked(torch, "moe-serve", cfg)
    phi = dataclasses.replace(get_arch(PHI_ARCH), n_layers=PHI_LAYERS)
    serve_readings(torch, device, cfg, "moe-serve", "full size")
    serve_readings(torch, device, phi, "moe-serve",
                   f"full width, n_layers cut from "
                   f"{get_arch(PHI_ARCH).n_layers} to {PHI_LAYERS}")


def flash_windows(cfg, seq=SERVE_PROMPT):
    """The ``window=`` of attention_flash for each attention layer of a
    prefill of ``cfg`` at ``seq`` positions: 'L' its window, 'G' none;
    no call below FLASH_MIN_SEQ or off a multiple of 512 (the dense form
    runs there)."""
    from repro_torch.models.blocks import FLASH_MIN_SEQ
    if seq < FLASH_MIN_SEQ or seq % 512:
        return []
    return [cfg.sliding_window if t == "L" else None
            for t in cfg.layer_types if t in ("G", "L")]


def windows_of(calls):
    """The ``window=`` of each counted attention_flash call."""
    return [k.get("window") for k in calls]


def check_prefixes(tag, cfg, calls):
    """A vision arch's attention_flash calls each carry its prefix."""
    got = [k.get("prefix_len") for k in calls]
    if cfg.frontend == "vision" and got != [cfg.prefix_len] * len(got):
        raise AssertionError(f"{tag} {cfg.name}: attention_flash "
                             f"prefix_len {got}, want {cfg.prefix_len}")


def serve_main_checked(torch, tag, cfg, prompt=SERVE_PROMPT):
    """``launch.serve.main`` on full ``cfg`` (batch SERVE_BATCH, ``prompt``
    tokens after the frontend's stub frames or patches, SERVE_NEW new
    tokens), attention_flash's calls counted: the tokens in the
    vocabulary, one call an attention layer of the prefill with that
    layer's window (and a vision arch's prefix) where the prefill's
    length takes it; its peak memory."""
    from repro_torch.launch import serve
    from repro_torch.models import blocks
    from repro_torch.models.model import vision_prefix

    argv = ["--arch", cfg.name, "--batch", str(SERVE_BATCH), "--prompt-len",
            str(prompt), "--new-tokens", str(SERVE_NEW)]
    log(f"[{tag}] python -m repro_torch.launch.serve {' '.join(argv)}")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with count_calls(blocks, "attention_flash") as flash:
        toks = serve.main(argv)
    seq = prompt + vision_prefix(cfg)
    want = flash_windows(cfg, seq)
    if tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab)).all()) or \
            windows_of(flash) != want:
        raise AssertionError(f"{tag} {cfg.name}: tokens {tuple(toks.shape)},"
                             f" attention_flash windows {windows_of(flash)},"
                             f" want {want}")
    check_prefixes(tag, cfg, flash)
    n_win = sum(w is not None for w in want)
    pre = (f", with prefix_len {cfg.prefix_len}"
           if cfg.frontend == "vision" else "")
    calls = ("one per attention layer ("
             + (f"{n_win} 'L' with window {cfg.sliding_window}, "
                if n_win else "")
             + f"{len(want) - n_win} 'G' without{pre})" if want else
             "the dense form below 2048 positions")
    log(f"[{tag}] {cfg.name}: attention_flash {len(flash)} calls in the "
        f"{seq}-position prefill ({prompt} tokens"
        + (f" after {seq - prompt} patches" if seq > prompt else "")
        + f"), {calls}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB (the weights' "
        f"init included)")
    del toks
    torch.cuda.empty_cache()


def serve_readings(torch, device, cfg, tag, note, prompt=SERVE_PROMPT):
    """``cfg`` (described by ``note``) initialized on the card, prompts of
    ``prompt`` tokens (after the frontend's stub frames or patches):
    finite prefill logits, :func:`serve_timings` (its two prefills'
    attention_flash calls counted against :func:`flash_windows`), the
    peak memory while serving and a profile of one prefill."""
    from repro_torch.core.tree import flatten_sorted
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.models import blocks
    from repro_torch.models import model as M

    torch.cuda.empty_cache()
    params = M.init_model(cfg, 0, device=device)
    n_params = sum(v.numel() for v in flatten_sorted(params)[0])
    gen = torch.Generator(device=device).manual_seed(1)
    batch = {"tokens": torch.randint(
        0, cfg.vocab, (SERVE_BATCH, prompt), device=device, generator=gen),
        **stub_inputs(cfg, (SERVE_BATCH,), gen, device)}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seq = prompt + M.vision_prefix(cfg)
    cache_len = seq + SERVE_NEW
    with torch.no_grad():
        last, _ = M.prefill(cfg, params, batch, cache_len=cache_len)
    if not bool(torch.isfinite(last[:, :cfg.vocab]).all()):
        raise AssertionError(f"{tag} {cfg.name}: prefill logits not finite")
    del last
    with count_calls(blocks, "attention_flash") as flash:
        toks, t = serve_timings(torch, cfg, params, batch, tag)
    if windows_of(flash) != 2 * flash_windows(cfg, seq) or \
            tuple(toks.shape) != (SERVE_BATCH, SERVE_NEW) or \
            not bool(((toks >= 0) & (toks < cfg.vocab)).all()):
        raise AssertionError(f"{tag} {cfg.name}: tokens {tuple(toks.shape)},"
                             f" attention_flash windows {windows_of(flash)} "
                             f"in 2 prefills")
    check_prefixes(tag, cfg, flash)
    stub = {"audio": f", {cfg.encoder_seq} frames",
            "vision": f", {cfg.prefix_len} patches"}.get(cfg.frontend, "")
    log(f"[{tag}] {cfg.name} ({note}; {n_params:,} params, "
        f"{n_params * 4 / 2**30:.2f} GiB f32): steady prefill "
        f"{t['prefill_ms']:.3f} ms, decode {t['decode_ms_per_token']:.3f} ms "
        f"per token (batch {SERVE_BATCH}{stub}, prompt {prompt}, "
        f"{SERVE_NEW} new tokens; attention_flash {len(flash) // 2} calls a "
        f"prefill); peak memory while serving "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    with torch.no_grad():
        profile_step(torch, f"{tag}-profile", lambda: M.prefill(
            cfg, params, batch, cache_len=cache_len),
            what=f"one {cfg.name} prefill")
    del params, batch, toks
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the Gemma slice: 'L' (sliding-window) attention, scaled embeddings,
# softcaps and the RG-LRU ('R') in plain torch; gemma3-1b trained at full
# size and recurrentgemma-9b at full width through B1r/B1a, both served at
# full size
# ---------------------------------------------------------------------------

GEMMA_ARCH, RG_ARCH = "gemma3-1b", "recurrentgemma-9b"
GEMMA_W = 4                      # [gemma-train] workers: W=4 fits with the
#                                  forward rematerialized (before, only W=2;
#                                  PERF.md §4)
GEMMA_SEQ = 1024                 # [gemma-train]: past the window of 512
RG_W, RG_LAYERS = 2, 3           # [rg-train]: one (R, R, L) cycle, full width
RG_SEQ = 128                     # [rg-train]'s trainer run
RG_WINDOW_SEQ = 4096             # its 'L' layer's reading: window 2048 binds
GEMMA_STEPS = 8
GB_KERNELS = ("reduce_partial_kernel", "reduce_finalize_kernel",
              "apply_kernel")    # B1r/B1a's device kernels, by name


def phase_gemma_train_check(torch, device):
    """Reduced gemma3-1b (6 layers, window 16) and recurrentgemma-9b (3
    layers, lru_width 256) at seq 32, where the window binds: 3 pipelined
    int8 steps from distinct worker starts, GPU (B1r/B1a) against CPU:
    losses rel 1e-4, ensembles atol 1e-4, n_good equal, not all 0."""
    train_checks(torch, device, "gemma-train-check", (GEMMA_ARCH, RG_ARCH))


def train_checks(torch, device, tag, archs):
    """:func:`pipelined_check` of each reduced arch of ``archs``, B1r and
    B1a launched once a step."""
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE

    for arch in archs:
        gpu, cpu, n_good, err, counts, seed = pipelined_check(
            torch, device, arch, tag)
        if counts.get(REDUCE) != 3 or counts.get(APPLY) != 3:
            raise AssertionError(f"{tag} {arch}: launches {counts} in 3 "
                                 f"steps")
        log(f"[{tag}] reduced {arch}, W={W}, batch 2, seq 32, 3 pipelined "
            f"int8 steps, draw seed {seed}: GPU vs CPU losses "
            f"{[round(l, 6) for l in gpu]} vs {[round(l, 6) for l in cpu]}"
            f", n_good {n_good}, max |ensemble diff| {err:.3e}; GPU "
            f"launches {counts}")


def train_readings(torch, tag, cfg, state, spec, wn, seq, device):
    """On a trained packed ``state`` of ``wn`` workers (batch 2, ``seq``
    tokens, with the frontend's stub frames or patches): the device time
    of B1r/B1a in one whole pipelined step, then one step's
    forward+backward by CUDA events and a profile of it, under the
    trainer's allocator setting (``launch/train.py
    expandable_segments``).  The allocator's cache is emptied before
    each: a step needs most of the card, and the cache of the reading
    before holds it in pieces."""
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.launch import train
    from repro_torch.launch.serve import stub_inputs
    from repro_torch.launch.steps import make_train_step, packed_loss_and_grad

    with train.expandable_segments(device):
        gen = torch.Generator(device=device).manual_seed(0)
        batch = {"tokens": torch.randint(0, cfg.vocab, (wn, 2, seq),
                                         device=device, generator=gen),
                 **stub_inputs(cfg, (wn, 2), gen, device)}
        packed = state["params"]
        step = make_train_step(
            cfg, pack_spec=spec,
            gcfg=train.gossip_config(wn, wire_format="int8"),
            acfg=ASGDConfig(eps=EPS), pipelined=True)
        torch.cuda.empty_cache()
        dev = device_ms(torch, lambda: step(packed, state["gossip"],
                                            state["opt"], batch, 0, 1),
                        GB_KERNELS, 3)
        if dev is None or len(dev[2]) != 3:
            raise AssertionError(f"{tag}: B1r/B1a's kernels not traced in "
                                 f"a step: {dev}")
        log(f"[{tag}] B1r/B1a in one pipelined step: {dev[0]:.4f} ms of "
            f"device time ({dev[1]} device launches: {', '.join(dev[2])}; "
            f"torch.profiler over 3 steps kept {dev[3]} of {dev[1] * 3} "
            f"events)")
        torch.cuda.empty_cache()
        fb = lambda: packed_loss_and_grad(  # noqa: E731
            cfg, packed, batch, spec)
        t_fb = cuda_ms(fb, 3)
        log(f"[{tag}] forward+backward of one step (W={wn}, batch 2, seq "
            f"{seq}, packed gradient): {t_fb:.3f} ms by CUDA events")
        torch.cuda.empty_cache()
        profile_step(torch, f"{tag}-profile", fb, what="one forward+backward")


def train_summary(out, counts, peak):
    """A training run's losses, step times and memory, for the log."""
    return (f"launches {counts} over {GEMMA_STEPS} steps; losses "
            f"{[round(l, 4) for l in out['losses']]}; step seconds "
            f"{[round(t, 4) for t in out['step_seconds']]} (first includes "
            f"warm-up); steady median "
            f"{steady_median(out['step_seconds']) * 1e3:.2f} ms; n_good "
            f"{out['n_good']}; peak memory {peak:.2f} GiB")


def phase_gemma_train(torch, device):
    """``repro_torch.launch.train`` on full gemma3-1b (26 layers: 22 'L',
    4 'G'), GEMMA_W workers, batch 2, seq GEMMA_SEQ (past the window of
    512), --pipelined --wire-format int8, counters zeroed before and read
    after — B1r/B1a once a step — its steady step time and peak memory,
    then :func:`train_readings`."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE

    cfg = get_arch(GEMMA_ARCH)
    out, counts, peak = run_trainer(
        torch, "gemma-train",
        train_argv(GEMMA_ARCH, GEMMA_W, GEMMA_SEQ, GEMMA_STEPS), GEMMA_STEPS,
        {REDUCE: GEMMA_STEPS, APPLY: GEMMA_STEPS})
    wq = out["params"]["scan"]["pos0"]["attn"]["wq"]
    n_full = cfg.n_layers // len(cfg.pattern_cycle)
    if tuple(wq.shape) != (GEMMA_W, n_full, cfg.d_model, cfg.n_heads,
                           cfg.resolved_head_dim) or \
            not bool(torch.isfinite(wq).all()):
        raise AssertionError(f"gemma-train: final average wq "
                             f"{tuple(wq.shape)} not finite/shaped")
    packed = out["state"]["params"]
    log(f"[gemma-train] {cfg.name} ({cfg.n_layers} layers: "
        f"{cfg.layer_types.count('L')} 'L' with window "
        f"{cfg.sliding_window}, {cfg.layer_types.count('G')} 'G'), "
        f"W={GEMMA_W}, seq {GEMMA_SEQ}, packed ensemble "
        f"{tuple(packed.shape)} = {packed.numel():,} f32 elements; "
        + train_summary(out, counts, peak))
    state, spec = out["state"], out["spec"]
    del out, wq, packed
    torch.cuda.empty_cache()
    train_readings(torch, "gemma-train", cfg, state, spec, GEMMA_W,
                   GEMMA_SEQ, device)
    del state
    torch.cuda.empty_cache()


@contextlib.contextmanager
def depth_cut(module, arch, n_layers):
    """``module.get_arch`` gives ``arch`` with its depth cut to
    ``n_layers`` inside the block (a trainer has no depth flag)."""
    import dataclasses

    real = module.get_arch

    def cut(name):
        cfg = real(name)
        return dataclasses.replace(cfg, n_layers=n_layers) \
            if name == arch else cfg

    module.get_arch = cut
    try:
        yield
    finally:
        module.get_arch = real


def rg_cut():
    """recurrentgemma-9b at full width, its depth cut to RG_LAYERS."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    return dataclasses.replace(get_arch(RG_ARCH), n_layers=RG_LAYERS)


def l_layer_fwd_bwd(torch, cfg, layer, wn, seq, device):
    """One 'L' layer's apply_layer forward+backward at ``wn`` workers,
    batch 2, ``seq`` tokens (its attention through attention_flash with
    the window, counted) on ``layer``'s weights and a seeded input; its
    time by CUDA events.  Returns (ms, the attention_flash windows)."""
    from repro_torch.core.tree import flatten_sorted, tree_map
    from repro_torch.models import blocks

    leaves = tree_map(lambda v: v.detach().clone().requires_grad_(True),
                      layer)
    flat = flatten_sorted(leaves)[0]
    g = torch.Generator(device=device).manual_seed(2)
    shape = (wn, 2, seq, cfg.d_model)
    x = torch.randn(shape, generator=g, device=device).requires_grad_(True)
    r = torch.randn(shape, generator=g, device=device)
    pos = torch.arange(seq, device=device)

    def fwd_bwd():
        y = blocks.apply_layer(cfg, "L", leaves, x, pos)[0]
        return torch.autograd.grad((y * r).sum(), [x] + flat)

    with count_calls(blocks, "attention_flash") as flash:
        grads = fwd_bwd()
    if not all(bool(torch.isfinite(t).all()) for t in grads):
        raise AssertionError("rg-train: an 'L' layer's gradient is not "
                             "finite")
    del grads
    return cuda_ms(fwd_bwd, 3), windows_of(flash)


def phase_rg_train(torch, device):
    """recurrentgemma-9b at full width with its depth cut to RG_LAYERS (one
    (R, R, L) cycle) through ``repro_torch.launch.train`` (its get_arch
    cut by :func:`depth_cut`), RG_W workers, batch 2, seq RG_SEQ,
    pipelined int8, counters zeroed before and read after — B1r/B1a once
    a step — its steady step time and peak memory, then
    :func:`train_readings`, and the trained 'L' layer's forward+backward
    at RG_WINDOW_SEQ tokens, where its window of 2048 binds."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    cfg = rg_cut()
    with depth_cut(train, RG_ARCH, RG_LAYERS):
        out, counts, peak = run_trainer(
            torch, "rg-train", train_argv(RG_ARCH, RG_W, RG_SEQ, GEMMA_STEPS),
            GEMMA_STEPS, {REDUCE: GEMMA_STEPS, APPLY: GEMMA_STEPS})
    state, spec = out["state"], out["spec"]
    if not bool(torch.isfinite(state["params"]).all()):
        raise AssertionError("rg-train: the ensemble is not finite")
    log(f"[rg-train] {cfg.name} at full width, n_layers cut from "
        f"{get_arch(RG_ARCH).n_layers} to {RG_LAYERS} "
        f"({''.join(cfg.layer_types)}), W={RG_W}, seq {RG_SEQ}, packed "
        f"ensemble {tuple(state['params'].shape)} = "
        f"{state['params'].numel():,} f32 elements ({cfg.param_count():,} "
        f"params a replica, analytic); "
        + train_summary(out, counts, peak))
    layer = tree_map(lambda v: v[:, 0], out["params"]["scan"]["pos2"])
    del out
    torch.cuda.empty_cache()
    train_readings(torch, "rg-train", cfg, state, spec, RG_W, RG_SEQ,
                   device)
    del state
    torch.cuda.empty_cache()
    ms, windows = l_layer_fwd_bwd(torch, cfg, layer, RG_W, RG_WINDOW_SEQ,
                                  device)
    if windows != [cfg.sliding_window]:
        raise AssertionError(f"rg-train: the 'L' layer's attention_flash "
                             f"windows {windows}, want "
                             f"[{cfg.sliding_window}]")
    log(f"[rg-train] the trained 'L' layer's forward+backward at W={RG_W}, "
        f"batch 2, seq {RG_WINDOW_SEQ} (attention_flash, window "
        f"{cfg.sliding_window}): {ms:.3f} ms by CUDA events")
    del layer
    torch.cuda.empty_cache()


def phase_gemma_blend(torch, device):
    """:func:`blend_check` on the ensembles the Gemma training paths
    blend: gemma3-1b at GEMMA_W workers (past 2^31 elements), and the
    depth-cut recurrentgemma-9b at RG_W."""
    from repro_torch.configs.registry import get_arch

    blend_check(torch, device, "gemma-blend", get_arch(GEMMA_ARCH), GEMMA_W,
                " (the [gemma-train] path's ensemble)")
    blend_check(torch, device, "gemma-blend", rg_cut(), RG_W,
                f" ({RG_LAYERS} layers; the [rg-train] path's ensemble)")


def phase_gemma_serve_check(torch, device):
    """Reduced gemma3-1b and recurrentgemma-9b through
    :func:`serve_check_free` at a prompt of 32 (the window of 16 binds in
    the prefill and in every decode step), the 'R' layers' prefilled conv
    cache zero, as the reference's, and their state h not; then reduced
    gemma3-1b at a 2048-token prompt, every 'L' layer of the CPU's and of
    the GPU's prefill through attention_flash with its window (counted)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import blocks

    for arch, plen in ((GEMMA_ARCH, 32), (RG_ARCH, 32),
                       (GEMMA_ARCH, SMOLLM_PROMPT)):
        cfg = get_arch(arch).reduced()
        with count_calls(blocks, "attention_flash") as flash:
            cache = serve_check_free(torch, device, arch,
                                     "gemma-serve-check", plen=plen)
        want = 2 * flash_windows(cfg, plen)
        if windows_of(flash) != want:
            raise AssertionError(f"gemma-serve-check {arch} prompt {plen}: "
                                 f"attention_flash windows "
                                 f"{windows_of(flash)}, want {want}")
        if want:
            log(f"[gemma-serve-check] reduced {arch}, prompt {plen}: "
                f"attention_flash windows {windows_of(flash)} (one call a "
                f"layer of the CPU's prefill, then of the GPU's)")
        zero = [cache["scan"][f"pos{j}"] for j, t in
                enumerate(cfg.pattern_cycle) if t == "R"]
        if any(bool(c["conv"].any()) or not bool(c["h"].abs().sum() > 0)
               for c in zero):
            raise AssertionError(f"gemma-serve-check {arch}: an 'R' layer's "
                                 f"prefilled conv cache is not zero, or "
                                 f"its state h is")
        if zero:
            log(f"[gemma-serve-check] {arch}: the {len(zero)} 'R' cycle "
                f"positions' prefilled conv caches are zero (as the "
                f"reference's), their states h nonzero")


def phase_gemma_serve(torch, device):
    """``launch.serve.main`` (batch 4, prompt 2048, 32 new tokens) on full
    gemma3-1b — its prefill's 26 attention_flash calls counted: 22 'L'
    with window 512, 4 'G' without — and full recurrentgemma-9b (38
    layers, its 12 'L' with window 2048, which masks nothing in the
    prefill and binds in decode); then :func:`serve_readings` of each."""
    from repro_torch.configs.registry import get_arch

    for arch in (GEMMA_ARCH, RG_ARCH):
        serve_main_checked(torch, "gemma-serve", get_arch(arch))
        serve_readings(torch, device, get_arch(arch), "gemma-serve",
                       "full size")


# ---------------------------------------------------------------------------
# the frontend slice: PaliGemma's prefix-LM and whisper's encoder-decoder
# (LayerNorm, the plain MLP, sinusoidal positions, cross-attention) in
# plain torch; both trained through B1r/B1a and served
# ---------------------------------------------------------------------------

VLM_ARCH, AUDIO_ARCH = "paligemma-3b", "whisper-tiny"
VLM_W, AUDIO_W = 2, 4             # [vlm-train], [audio-train] workers
FRONTEND_SEQ = 128                # text tokens a training sample
AUDIO_PROMPT = 416                # + 32 new tokens: whisper's 448 positions
VLM_PROMPTS = (128, 1792)         # + 256 patches: 384 (dense) and 2048
#                                   (attention_flash) positions


def frontend_train(torch, device, tag, cfg, wn):
    """``repro_torch.launch.train`` on ``cfg`` (its trainer's get_arch cut
    by :func:`depth_cut` where ``cfg`` is cut), ``wn`` workers, batch 2,
    FRONTEND_SEQ text tokens with the frontend's stub inputs, pipelined
    int8, GEMMA_STEPS steps, counters zeroed before and read after —
    B1r/B1a once a step — then :func:`train_readings`."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    full = get_arch(cfg.name)
    with depth_cut(train, cfg.name, cfg.n_layers):
        out, counts, peak = run_trainer(
            torch, tag, train_argv(cfg.name, wn, FRONTEND_SEQ, GEMMA_STEPS),
            GEMMA_STEPS, {REDUCE: GEMMA_STEPS, APPLY: GEMMA_STEPS})
    state, spec = out["state"], out["spec"]
    if not bool(torch.isfinite(state["params"]).all()):
        raise AssertionError(f"{tag}: the ensemble is not finite")
    depth = ("full size" if cfg.n_layers == full.n_layers else
             f"full width, n_layers cut from {full.n_layers} to "
             f"{cfg.n_layers}")
    stub = {"audio": f"{cfg.encoder_seq} frames",
            "vision": f"{cfg.prefix_len} patches"}[cfg.frontend]
    log(f"[{tag}] {cfg.name} ({depth}), W={wn}, batch 2, {FRONTEND_SEQ} "
        f"text tokens and {stub} a sample, packed ensemble "
        f"{tuple(state['params'].shape)} = {state['params'].numel():,} f32 "
        f"elements ({cfg.param_count():,} params a replica, analytic); "
        + train_summary(out, counts, peak))
    del out
    torch.cuda.empty_cache()
    train_readings(torch, tag, cfg, state, spec, wn, FRONTEND_SEQ, device)
    del state
    torch.cuda.empty_cache()


def phase_frontend_train_check(torch, device):
    """Reduced paligemma-3b (8 patches) and whisper-tiny (2 encoder
    layers, 32 frames) through :func:`train_checks`."""
    train_checks(torch, device, "vlm-audio-train-check",
                 (VLM_ARCH, AUDIO_ARCH))


def phase_audio_train(torch, device):
    """Full whisper-tiny (4 + 4 layers, 1500 frames a sample) through
    :func:`frontend_train` at AUDIO_W workers."""
    from repro_torch.configs.registry import get_arch
    frontend_train(torch, device, "audio-train", get_arch(AUDIO_ARCH),
                   AUDIO_W)


def phase_vlm_train(torch, device):
    """Full paligemma-3b (18 layers, 256 patches a sample) through
    :func:`frontend_train` at VLM_W workers (at 9 layers before the forward
    rematerialized: at 18 a step ran out of the card's memory)."""
    from repro_torch.configs.registry import get_arch
    frontend_train(torch, device, "vlm-train", get_arch(VLM_ARCH), VLM_W)


def phase_frontend_blend(torch, device):
    """:func:`blend_check` on the ensembles the frontend training paths
    blend: paligemma-3b's at VLM_W ([vlm-blend]), whisper-tiny's at
    AUDIO_W ([audio-blend])."""
    from repro_torch.configs.registry import get_arch

    blend_check(torch, device, "vlm-blend", get_arch(VLM_ARCH), VLM_W,
                " (the [vlm-train] path's ensemble)")
    blend_check(torch, device, "audio-blend", get_arch(AUDIO_ARCH), AUDIO_W,
                " (the [audio-train] path's ensemble)")


def phase_frontend_serve_check(torch, device):
    """Reduced paligemma-3b and whisper-tiny through
    :func:`serve_check_free` at a prompt of 32 (after 8 patches or 32
    frames); then reduced paligemma at a prompt of 2040, 2048 positions
    with its prefix, every 'G' layer of the CPU's and of the GPU's
    prefill through attention_flash with prefix_len 8 (counted)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.models import blocks
    from repro_torch.models.model import vision_prefix

    tag = "vlm-audio-serve-check"
    for arch, plen in ((VLM_ARCH, 32), (AUDIO_ARCH, 32), (VLM_ARCH, 2040)):
        cfg = get_arch(arch).reduced()
        with count_calls(blocks, "attention_flash") as flash:
            serve_check_free(torch, device, arch, tag, plen=plen)
        want = 2 * flash_windows(cfg, plen + vision_prefix(cfg))
        if windows_of(flash) != want:
            raise AssertionError(f"{tag} {arch} prompt {plen}: "
                                 f"attention_flash windows "
                                 f"{windows_of(flash)}, want {want}")
        check_prefixes(tag, cfg, flash)
        if want:
            log(f"[{tag}] reduced {arch}, prompt {plen} after "
                f"{vision_prefix(cfg)} patches: attention_flash prefix_len "
                f"{[k.get('prefix_len') for k in flash]} (one call a layer "
                f"of the CPU's prefill, then of the GPU's)")


def phase_audio_serve(torch, device):
    """``launch.serve.main`` on full whisper-tiny (batch 4, 1500 frames,
    prompt AUDIO_PROMPT, 32 new tokens: every attention dense), then
    :func:`serve_readings`."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(AUDIO_ARCH)
    serve_main_checked(torch, "audio-serve", cfg, AUDIO_PROMPT)
    serve_readings(torch, device, cfg, "audio-serve", "full size",
                   AUDIO_PROMPT)


def phase_vlm_serve(torch, device):
    """``launch.serve.main`` on full paligemma-3b (batch 4, 256 patches,
    32 new tokens) at each prompt of VLM_PROMPTS — at 1792 (2048
    positions) its 18 'G' layers of the prefill through attention_flash
    with prefix_len 256, counted — then :func:`serve_readings` at each."""
    from repro_torch.configs.registry import get_arch

    cfg = get_arch(VLM_ARCH)
    for prompt in VLM_PROMPTS:
        serve_main_checked(torch, "vlm-serve", cfg, prompt)
        serve_readings(torch, device, cfg, "vlm-serve", "full size", prompt)


# ---------------------------------------------------------------------------
# the qwen archs: QKV biases (qwen2.5-14b) and per-head qk RMSNorm
# (qwen3-14b), remat_policy 'dots'; served at full size (a 55 GiB f32
# replica), trained at full width with the depth cut, through B1r/B1a on a
# packed ensemble past 2^31 elements
# ---------------------------------------------------------------------------

QWEN_ARCHS = ("qwen2.5-14b", "qwen3-14b")
QWEN_W, QWEN_LAYERS, QWEN_SEQ = 2, 2, 128   # [qwen-train]: full width,
#                                             2 layers (PERF.md §4 says why)
QWEN_PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm")


def perturbed(torch, params, seed=3):
    """``params`` with every leaf under a QWEN_PERTURBED key plus
    0.5 x N(0, 1) from ``seed``: at init the QKV biases are zeros and the
    qk-norm scales ones, which would hide a fault in either."""
    g = torch.Generator().manual_seed(seed)

    def walk(node, hit):
        if isinstance(node, dict):
            return {k: walk(v, hit or k in QWEN_PERTURBED)
                    for k, v in sorted(node.items())}
        return node + 0.5 * torch.randn(node.shape, generator=g) \
            if hit else node
    return walk(params, False)


def phase_qwen_check(torch, device):
    """[qwen-serve-check]: reduced qwen2.5-14b and qwen3-14b, their biases
    and qk-norm scales perturbed, through :func:`serve_check_free`;
    [qwen-train-check]: both through :func:`train_checks` (the workers'
    seeded starts move every leaf, the biases and scales too)."""
    for arch in QWEN_ARCHS:
        serve_check_free(torch, device, arch, "qwen-serve-check",
                         perturb=True)
    train_checks(torch, device, "qwen-train-check", QWEN_ARCHS)


def phase_qwen_serve(torch, device):
    """[qwen-serve]: :func:`serve_readings` of both archs at full size
    (batch 4, prompt 2048: 48 and 40 attention_flash calls a prefill)."""
    from repro_torch.configs.registry import get_arch
    for arch in QWEN_ARCHS:
        serve_readings(torch, device, get_arch(arch), "qwen-serve",
                       "full size")


def phase_qwen_train(torch, device):
    """[qwen-train]: ``repro_torch.launch.train`` on each arch at full
    width, its depth cut to QWEN_LAYERS by :func:`depth_cut`, QWEN_W
    workers, batch 2, seq QWEN_SEQ, pipelined int8, GEMMA_STEPS steps,
    counters zeroed before and read after — B1r/B1a once a step on the
    packed ensemble past 2^31 elements."""
    import dataclasses

    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import train

    for arch in QWEN_ARCHS:
        full = get_arch(arch)
        cfg = dataclasses.replace(full, n_layers=QWEN_LAYERS)
        with depth_cut(train, arch, QWEN_LAYERS):
            out, counts, peak = run_trainer(
                torch, "qwen-train",
                train_argv(arch, QWEN_W, QWEN_SEQ, GEMMA_STEPS), GEMMA_STEPS,
                {REDUCE: GEMMA_STEPS, APPLY: GEMMA_STEPS})
        packed = out["state"]["params"]
        if not bool(torch.isfinite(packed).all()):
            raise AssertionError(f"qwen-train {arch}: the ensemble is not "
                                 f"finite")
        log(f"[qwen-train] {arch} at full width, n_layers cut from "
            f"{full.n_layers} to {QWEN_LAYERS}, remat_policy "
            f"{cfg.remat_policy!r}, W={QWEN_W}, batch 2, seq {QWEN_SEQ}, "
            f"packed ensemble {tuple(packed.shape)} = {packed.numel():,} f32 "
            f"elements ({packed.numel() / 2**31:.2f} x 2^31; "
            f"{cfg.param_count():,} params a replica, analytic); "
            + train_summary(out, counts, peak))
        del out, packed
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the dry-run slice: launch/dryrun.py on named pairs, and its meta trace of
# the main path's step held against that step on the card
# ---------------------------------------------------------------------------

DRYRUN_PAIRS = (("smollm-135m", "train_4k", "pytree"),
                ("smollm-135m", "train_4k", "packed"),
                ("smollm-135m", "train_4k", "pipelined"),
                ("mamba2-370m", "prefill_32k", "pytree"),
                ("mamba2-370m", "train_4k", "pipelined"),
                ("mamba2-370m", "decode_32k", "pytree"),
                ("qwen2.5-14b", "train_4k", "pytree"),
                ("granite-moe-1b-a400m", "train_4k", "pytree"))
# the peak (GiB) each tensor-parallel pair's trace had while the dry-run
# replicated every worker slice over `model` (the parent tree's
# `launch.dryrun --all --mesh both`, torch 2.13 on the CPU; PERF.md §6)
DRYRUN_REPLICATED_GIB = {("smollm-135m", "train_4k"): 41.64,
                         ("mamba2-370m", "prefill_32k"): 26.59,
                         ("mamba2-370m", "decode_32k"): 1.78,
                         ("qwen2.5-14b", "train_4k"): 287.77,
                         ("granite-moe-1b-a400m", "train_4k"): 77.25}
DRYRUN_FULL_BUDGET_S = 3.0           # full depth where it is predicted to
#                                      trace within this
PEAK_RATIO = (0.95, 1.05)            # [dryrun-check]: modeled peak / card's


def phase_dryrun(torch):
    """[dryrun]: run_pair on DRYRUN_PAIRS; the SSD kernels' workspace
    sizes as the meta branches model them against the kernels' own."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels.ssd_scan import kernel as SK
    from repro_torch.launch import dryrun as D

    t0 = time.perf_counter()
    records = []
    for arch, shape, engine in DRYRUN_PAIRS:
        rec = D.run_pair(arch, shape, multi_pod=False, engine=engine,
                         full_budget_s=DRYRUN_FULL_BUDGET_S)
        records.append(rec)
        repl = (DRYRUN_REPLICATED_GIB.get((arch, shape))
                if rec["layout"] == "tensor_parallel" else None)
        placed = ("" if repl is None else
                  f" (replicated over model, the parent tree's trace: "
                  f"{repl:.2f} GiB)")
        log(f"[dryrun] {arch} x {shape} ({engine}, {rec['layout']}): compute "
            f"{rec['compute_s'] * 1e3:.3f} ms, memory "
            f"{rec['memory_s'] * 1e3:.3f} ms, collective "
            f"{rec['collective_s'] * 1e3:.3f} ms -> {rec['dominant']}; "
            f"useful {rec['useful_ratio']:.4f}; aten FLOPs "
            f"{rec['hlo_flops']:.4e}, bytes {rec['hlo_bytes']:.4e}; peak "
            f"{rec['memory']['peak_bytes'] / 2**30:.2f} GiB"
            f"{' (extrapolated)' if rec['memory']['extrapolated'] else ''}"
            f"{placed}, argument bytes "
            f"{rec['memory']['argument_bytes'] / 2**30:.2f} GiB, placed "
            f"{rec['memory']['placed_bytes'] / 2**30:.2f} GiB"
            f", fits {rec['fits']}; kernels "
            f"{ {k: v['launches'] for k, v in rec['kernels'].items()} }; "
            f"trace shallow {rec['trace_shallow_s']} s, full "
            f"{rec['trace_full_s']} s")
    for a, s, e in DRYRUN_PAIRS:
        if s == "train_4k" and e != "pytree":
            rec = records[DRYRUN_PAIRS.index((a, s, e))]
            if rec["kernels"].get("gossip_apply_w_resident", {}).get(
                    "launches") != 1:
                raise AssertionError(f"[dryrun] {a} {e}: B1a not modeled "
                                     f"once a step: {rec['kernels']}")
    for rec, (a, s, e) in zip(records, DRYRUN_PAIRS):
        placed = s != "train_4k" or e == "pytree"
        if rec["layout"] != ("tensor_parallel" if placed else "worker_split"):
            raise AssertionError(f"[dryrun] {a} {s} {e}: layout "
                                 f"{rec['layout']}")
        mem = rec["memory"]
        if placed and s == "train_4k" and (
                mem["argument_bytes"] != mem["placed_bytes"]
                or mem["peak_bytes"] / 2**30 >= DRYRUN_REPLICATED_GIB[(a, s)]):
            raise AssertionError(f"[dryrun] {a} {s}: a rank's share not "
                                 f"traced: {mem}")
    for rec in records:       # B5 (and B5b in training) once an 'S' layer,
        n = get_arch(rec["arch"]).n_layers   # B5 twice under remat
        want = {"prefill_32k": {"ssd_scan": n},
                "train_4k": {"ssd_scan": 2 * n, "ssd_scan_bwd": n}}.get(
                    rec["shape"], {}) if rec["arch"] == "mamba2-370m" else {}
        for name, launches in want.items():
            if rec["kernels"].get(name, {}).get("launches") != launches:
                raise AssertionError(f"[dryrun] mamba2 {rec['shape']}: "
                                     f"{name} not {launches} a step: "
                                     f"{rec['kernels']}")
    # the workspace the meta branches allocate is the kernels' own
    lib, blib = SK._library(), SK._bwd_library()
    for dims in (SSD_SHAPE, (16, 4096, 32, 64, 128, 128)):
        if (SK.workspace_floats(*dims) != lib.ssd_workspace_floats(*dims)
                or SK.bwd_workspace_floats(*dims)
                != blib.ssd_bwd_workspace_floats(*dims)):
            raise AssertionError(f"[dryrun] SSD workspace sizes at {dims}: "
                                 "modeled != the kernels'")
    log(f"[dryrun] {len(records)} records in "
        f"{time.perf_counter() - t0:.1f} s; SSD workspaces as modeled")
    print("[dryrun] records " + json.dumps(records), flush=True)


def phase_dryrun_check(torch, device):
    """[dryrun-check]: the dry-run's meta trace of the [main] step against
    that step run once on the card under the same counters."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.gossip import (init_pipelined_gossip_state,
                                         leaf_groups)
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.core.tree import tree_map
    from repro_torch.kernels.gossip_blend.kernel import APPLY, REDUCE
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import train
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M

    t0 = time.perf_counter()
    cfg = get_arch("smollm-135m")
    gcfg = train.gossip_config(W, wire_format="int8")
    shape = ShapeConfig("main", 128, 2 * W, "train")
    with fake_process_group(1):
        meta = D.trace_step(cfg, shape, make_host_mesh(1, 1, device="cpu"),
                            gcfg, engine="pipelined", workers=W)
    t_meta = time.perf_counter() - t0

    # the [main] step on the card, its state built as train.main builds it
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    params = M.init_model(cfg, 0, device=device)
    wparams = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
    spec = pack_spec_w(wparams, block_rows=gcfg.fused_block_rows,
                       groups=leaf_groups(wparams, gcfg.partial_blocks),
                       n_groups=gcfg.partial_blocks)
    packed = pack_w(wparams, spec)
    del params, wparams
    gossip = init_pipelined_gossip_state(packed, gcfg,
                                         block_rows=spec.block_rows)
    batch = train.next_wbatch(train.batch_iterators(cfg, W, 2, 128, 0),
                              device)
    step = make_train_step(cfg, pack_spec=spec, gcfg=gcfg,
                           acfg=ASGDConfig(eps=EPS), pipelined=True)
    args = {"params": packed, "gossip": gossip, "opt_state": 0,
            "batch": batch, "shift_idx": 0, "block_idx": 0}
    del packed, gossip, batch
    real = D.arg_tensors(args)
    want = meta["arg_shapes"]
    got = [(tuple(t.shape), t.dtype) for t in real]
    real_bytes = sum(t.numel() * t.element_size() for t in real)
    if got != want or real_bytes != meta["arg_bytes"]:
        raise AssertionError(f"[dryrun-check] arguments: meta {want} "
                             f"({meta['arg_bytes']} B) != card {got} "
                             f"({real_bytes} B)")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.reset_launch_counts()
    with D.Counters(real) as c:
        out = step(*args.values())
        torch.cuda.synchronize()
    del real
    counts = K.launch_counts()
    card_peak = torch.cuda.max_memory_allocated() - base
    if not math.isfinite(float(out[3]["loss"])):
        raise AssertionError(f"[dryrun-check] loss {out[3]['loss']}")
    del out, args
    modeled = {}
    for k in meta["kernels"]:
        modeled[k["name"]] = modeled.get(k["name"], 0) + 1
    if c.flops != meta["flops"]:
        raise AssertionError(f"[dryrun-check] aten FLOPs: meta "
                             f"{meta['flops']} != card {c.flops}")
    if {n: counts.get(n, 0) for n in (REDUCE, APPLY)} != {
            n: modeled.get(n, 0) for n in (REDUCE, APPLY)} or \
            modeled.get(APPLY) != 1:
        raise AssertionError(f"[dryrun-check] launches: modeled {modeled} "
                             f"!= card {counts}")
    ratio = meta["peak"] / card_peak
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        raise AssertionError(f"[dryrun-check] peak: modeled {meta['peak']} "
                             f"B / card {card_peak} B = {ratio:.4f}, outside "
                             f"{PEAK_RATIO}")
    log(f"[dryrun-check] [main] step (smollm-135m W={W}, pipelined int8, "
        f"rematerialized): "
        f"aten FLOPs meta {meta['flops']} = card {c.flops}; B1r/B1a "
        f"modeled {modeled} = launched {counts}; argument bytes "
        f"{meta['arg_bytes']} = {real_bytes}; aten bytes meta "
        f"{meta['bytes']}, card {c.bytes}; peak: modeled "
        f"{meta['peak'] / 2**30:.3f} GiB, tracker on the card "
        f"{c.peak / 2**30:.3f} GiB, max_memory_allocated above the "
        f"{base / 2**30:.3f} GiB before {card_peak / 2**30:.3f} GiB, "
        f"modeled / card {ratio:.4f} (gate {PEAK_RATIO}); meta "
        f"trace {t_meta:.1f} s, {time.perf_counter() - t0:.1f} s in all")
    torch.cuda.empty_cache()


def phase_dryrun_tp_check(torch, device):
    """[dryrun-tp-check]: the dry-run's meta trace of one rank of [tp]'s
    smollm step (tensor-parallel at a (1, 1) mesh, the fused blend)
    against that step run once on the card at one NCCL rank under the same
    counters."""
    from repro_torch import kernels as K
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_arch
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.gossip import init_gossip_state
    from repro_torch.kernels.gossip_blend.kernel import APPLY_W, REDUCE_W
    from repro_torch.launch import dryrun as D
    from repro_torch.launch import mesh as MM
    from repro_torch.launch import tensor_parallel as TP
    from repro_torch.launch.steps import make_train_step

    import torch.distributed as dist

    t0 = time.perf_counter()
    cfg = get_arch("smollm-135m")
    seq = 128
    shape = ShapeConfig("tp", seq, 2 * W, "train")
    gcfg = pytree_gcfg()
    acfg = ASGDConfig(eps=TP_EPS, use_fused=True)
    with MM.fake_process_group(1):
        meta = D.trace_step(cfg, shape, MM.make_host_mesh(1, 1, device="cpu"),
                            gcfg, workers=W, acfg=acfg)
    t_meta = time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_dtp_") as tmp:
        MM.init_ranks(str(pathlib.Path(tmp) / "store"), 0, 1, device)
        try:
            mesh = MM.make_host_mesh(1, 1, device=device)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            base = torch.cuda.memory_allocated()
            params = TP.place_params(mesh, tp_starts(torch, cfg, W, device))
            gossip = init_gossip_state(params, gcfg)
            gen = torch.Generator(device=device).manual_seed(2)
            batch = {"tokens": MM.shard_workers(torch.randint(
                0, cfg.vocab, (W, 2, seq), device=device, generator=gen,
                dtype=torch.int32), mesh)}
            step = make_train_step(cfg, gcfg=gcfg, acfg=acfg, mesh=mesh)
            args = {"params": params, "gossip": gossip, "opt_state": 0,
                    "batch": batch, "shift_idx": 0, "block_idx": 0}
            del params, gossip, batch
            real = D.arg_tensors(args)
            got = [(tuple(t.shape), t.dtype) for t in real]
            real_bytes = sum(t.numel() * t.element_size() for t in real)
            if got != meta["arg_shapes"] or real_bytes != meta["arg_bytes"]:
                raise AssertionError(
                    f"[dryrun-tp-check] arguments: meta {meta['arg_shapes']} "
                    f"({meta['arg_bytes']} B) != card {got} ({real_bytes} B)")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            K.reset_launch_counts()
            with D.Counters(real) as c:
                out = step(*args.values())
                torch.cuda.synchronize()
            del real
            counts = K.launch_counts()
            card_peak = torch.cuda.max_memory_allocated() - base
            loss = float(out[3]["loss"])
            del out, args, step
        finally:
            dist.destroy_process_group()
    if not math.isfinite(loss):
        raise AssertionError(f"[dryrun-tp-check] loss {loss}")
    modeled = {}
    for k in meta["kernels"]:
        modeled[k["name"]] = modeled.get(k["name"], 0) + 1
    if c.flops != meta["flops"]:
        raise AssertionError(f"[dryrun-tp-check] aten FLOPs: meta "
                             f"{meta['flops']} != card {c.flops}")
    names = (REDUCE_W, APPLY_W)
    if {n: counts.get(n, 0) for n in names} != {
            n: modeled.get(n, 0) for n in names} or modeled.get(APPLY_W) != 1:
        raise AssertionError(f"[dryrun-tp-check] launches: modeled "
                             f"{modeled} != card {counts}")
    ratio = meta["peak"] / card_peak
    if not PEAK_RATIO[0] <= ratio <= PEAK_RATIO[1]:
        raise AssertionError(f"[dryrun-tp-check] peak: modeled "
                             f"{meta['peak']} B / card {card_peak} B = "
                             f"{ratio:.4f}, outside {PEAK_RATIO}")
    log(f"[dryrun-tp-check] [tp]'s smollm-135m step (W={W}, seq {seq}, "
        f"fused blend, tensor-parallel on a (1, 1) NCCL mesh): aten FLOPs "
        f"meta {meta['flops']} = card {c.flops}; B2r/B2a modeled {modeled} "
        f"= launched {counts}; argument bytes {meta['arg_bytes']} = "
        f"{real_bytes}; aten bytes meta {meta['bytes']}, card {c.bytes}; "
        f"traced collectives meta {meta['collectives']}, card "
        f"{c.collectives}; peak: modeled {meta['peak'] / 2**30:.3f} GiB, "
        f"tracker on the card {c.peak / 2**30:.3f} GiB, "
        f"max_memory_allocated above the {base / 2**30:.3f} GiB before "
        f"{card_peak / 2**30:.3f} GiB, modeled / card {ratio:.4f} (gate "
        f"{PEAK_RATIO}); loss {loss:.6f}; meta trace {t_meta:.1f} s, "
        f"{time.perf_counter() - t0:.1f} s in all")
    torch.cuda.empty_cache()


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
    bd = phase_breakdown(torch, device)
    phase_mesh(torch, device, bd)
    del bd
    phase_train_lm(torch)
    phase_elastic_check(torch, device)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ckpt_") as tmp:
        path = str(pathlib.Path(tmp) / "main.msgpack")
        phase_ckpt(torch, path)
        phase_elastic(torch, path, main_s)
    counts.update(phase_pytree(torch, device))
    for name, n in phase_tp(torch, device).items():
        counts[name] += n
    for name, n in phase_tp_options(torch, device).items():
        counts[name] += n
    phase_tp_serve(torch, device)
    tp_ssm = phase_tp_ssm(torch, device)
    tp_moe = phase_tp_moe(torch, device)
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
    for name, n in {**tp_ssm, **tp_moe}.items():
        counts[name] += n
    phase_moe_train_check(torch, device)
    phase_moe_train(torch, device)
    phase_moe_blend(torch, device)
    phase_moe_serve_check(torch, device)
    phase_moe_serve(torch, device)
    phase_gemma_train_check(torch, device)
    phase_gemma_train(torch, device)
    phase_rg_train(torch, device)
    phase_gemma_blend(torch, device)
    phase_gemma_serve_check(torch, device)
    phase_gemma_serve(torch, device)
    phase_frontend_train_check(torch, device)
    phase_audio_train(torch, device)
    phase_vlm_train(torch, device)
    phase_frontend_blend(torch, device)
    phase_frontend_serve_check(torch, device)
    phase_audio_serve(torch, device)
    phase_vlm_serve(torch, device)
    phase_qwen_check(torch, device)
    phase_qwen_serve(torch, device)
    phase_qwen_train(torch, device)
    phase_dryrun(torch)
    phase_dryrun_check(torch, device)
    phase_dryrun_tp_check(torch, device)

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
