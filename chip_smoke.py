#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (src/repro_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):
  1. build every CUDA kernel of the port from its sources (one nvcc per
     source, all started together) and print the build time;
  2. hold each kernel of the main path against its plain-torch version at
     the main path's shapes (W=4, R=262848, P=1; f32 and int8 externals,
     a partial row range), with CUDA-event times for both and each
     kernel's bound;
  3. a small-input check: 3 pipelined int8 steps of the reduced model on
     the GPU against the same steps on the CPU (the plain versions, which
     the CPU tests hold to the JAX reference);
  4. the main path: ``repro_torch.launch.train`` on full smollm-135m, W=4,
     --pipelined --wire-format int8, with the launch counters zeroed just
     before and read just after — every kernel must have run every round;
  5. a per-component breakdown of one full-size pipelined step.
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
TOL_REDUCE_RTOL = 1e-5               # sums in another order
TOL_APPLY_ATOL = 1e-6                # elementwise; the same op order


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


def make_operands(torch, device, wire):
    """Main-path-shaped operands made on the device from a seed: half the
    workers' externals ahead of the local step, half behind."""
    from repro_torch.core.packing import quantize_rows
    g = torch.Generator(device=device).manual_seed(0)
    w = 0.05 * torch.randn((W, R, 512), generator=g, device=device)
    dw = 0.01 * torch.randn((W, R, 512), generator=g, device=device)
    side = torch.tensor([0.5, -0.5, 0.5, -0.5], device=device)
    ext = (w - side[:, None, None] * dw
           + 0.02 * torch.randn((W, R, 512), generator=g, device=device))
    ext = ext[:, None]
    scales = None
    if wire == "int8":
        ext, scales = quantize_rows(ext, BLOCK_ROWS)
    return w, dw, ext, scales


def phase_kernels(torch, device):
    """B1r/B1a against their plain versions at the main path's shapes."""
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
        err_r = float((acc - acc_p).abs().max())
        rel = float(((acc - acc_p).abs() / acc_p.abs().clamp_min(1e-30))
                    .max())
        if not torch.allclose(acc, acc_p, rtol=TOL_REDUCE_RTOL, atol=0):
            raise AssertionError(f"reduce/{wire}: kernel vs plain rel err "
                                 f"{rel:.3e} > {TOL_REDUCE_RTOL}")
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
        err_a = float((out - out_p).abs().max())
        if not err_a <= TOL_APPLY_ATOL:
            raise AssertionError(f"apply/{wire}: kernel vs plain max abs "
                                 f"err {err_a:.3e} > {TOL_APPLY_ATOL}")
        del out, out_p
        # bytes each function must move: reduce reads w, dw, ext (and the
        # scales) on the range's rows and writes (W, P, 3); apply reads w,
        # dw everywhere, ext on the range, gates/inv/lr, writes (W, R, LANE)
        n_in = W * rows_in * 512
        n_all = W * R * 512
        deq = P if scales is not None else 0       # dequantize multiplies
        sc_b = 0 if scales is None else W * P * (rows_in // BLOCK_ROWS) * 4
        passes = (
            ("reduce", red, red_plain, err_r, f" (max rel {rel:.3e})",
             n_in * (4 + 4 + P * ext_b) + sc_b + W * P * 3 * 4,
             n_in * (2 + 6 * P + deq)),
            ("apply", app, app_plain, err_a, "",
             n_all * 12 + n_in * P * ext_b + sc_b + W * P * 4 + W * 4 + 4,
             n_all * 2 + n_in * (4 + 2 * P + deq)),
        )
        for name, fn, plain, err, note, n_bytes, n_flops in passes:
            ms = cuda_ms(fn, 20)
            plain_ms = cuda_ms(plain, 5)
            b_ms, b_by = bound_ms(n_bytes, n_flops)
            results[(name, wire)] = {"ms": ms, "plain_ms": plain_ms,
                                     "bound_ms": b_ms, "bound_by": b_by,
                                     "max_abs_err": err}
            log(f"[kernels] {name:6s} {wire:4s} rows [{r0},{r1}) of R={R}: "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}, {n_bytes / 1e9:.3f} GB), "
                f"{b_ms / ms:.1%} of bound, max abs err {err:.3e}{note}")
        del w, dw, ext, scales, acc, acc_p
        torch.cuda.empty_cache()
    return results


def phase_small_check(torch, device):
    """3 pipelined int8 steps of the reduced model on the GPU (kernels) and
    on the CPU (plain versions) from the same weights, batches and draws:
    losses within rel 1e-4, n_good equal, ensembles within atol 1e-4."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.core import gossip as G
    from repro_torch.core.asgd import ASGDConfig
    from repro_torch.core.packing import pack_spec_w, pack_w
    from repro_torch.core.tree import tree_map
    from repro_torch.data.synthetic import lm_batch_iterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models.model import init_model

    cfg = get_arch("smollm-135m").reduced()
    params = init_model(cfg, 0, device="cpu")
    wp = tree_map(lambda x: x.expand((W,) + tuple(x.shape)), params)
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
    if tuple(wq.shape) != (W, 30, 576, 9, 64) or \
            not bool(torch.isfinite(wq).all()):
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
    step(packed, state, 0, batch, 0, 1)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step(packed, state, 0, batch, 0, 1)
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
        log(f"[profile] one step: wall {wall_us / 1e3:.3f} ms, device busy "
            f"{busy / 1e3:.3f} ms, idle share {1 - busy / wall_us:.1%}, "
            f"{len(spans)} device ops")
        for name, us in top:
            log(f"[profile]   {us / 1e3:8.3f} ms  {name[:100]}")
    else:
        log("[profile] the trace holds no device events: device busy share "
            "not measured")


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
    from repro_torch.kernels.gossip_blend.kernel import (APPLY, REDUCE,
                                                         SOURCE)

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
    phase_small_check(torch, device)
    counts = phase_main_path(torch)
    phase_breakdown(torch, device)

    source = str(SOURCE.relative_to(ROOT))
    kernels = []
    for name, pass_, line in ((REDUCE, "reduce", 370), (APPLY, "apply", 412)):
        r = kres[(pass_, "int8")]     # the main path's wire
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": f"src/repro/kernels/gossip_blend/kernel.py:{line}",
            "launches": counts[name], "max_abs_err": r["max_abs_err"],
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": None})
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
