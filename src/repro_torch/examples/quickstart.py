"""Quickstart: the paper's own experiment — ASGD vs SimuParallelSGD vs BATCH
on K-Means clustering of synthetic data (paper §5, scaled to laptop size).

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart \
          [--device cpu] [--m N]

The data, the prototypes and BATCH run on the device (CUDA unless
``--device cpu``), their E/M steps through kernel B4; the two asynchronous
runs use the threaded GASPI simulator, a host simulator by design
(core/async_sim.py), on a float64 copy of the data.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device, set_full_fp32_precision
from repro_torch.core import kmeans
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.async_sim import AsyncSimConfig, run_async_asgd
from repro_torch.core.baselines import run_batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--m", type=int, default=100_000, help="samples")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_full_fp32_precision()

    # --- data: k=10 clusters in 10-d (paper's headline dims)
    gen = torch.Generator(device=dev).manual_seed(0)
    x, centers, _ = kmeans.synthetic_clusters(gen, k=10, d=10, m=args.m,
                                              spread=0.12)
    w0 = kmeans.init_prototypes(
        x, kmeans.choose_prototype_indices(gen, args.m, 10))
    x64 = x.cpu().numpy().astype(np.float64)
    w64 = w0.cpu().numpy().astype(np.float64)
    print(f"initial quantization error: "
          f"{float(kmeans.quantization_error(x, w0)):.4f}")

    # --- ASGD (paper alg. 5): 8 asynchronous ranks, GASPI-style one-sided
    #     messaging with Parzen-window gating
    cfg = AsyncSimConfig(ranks=8, rounds=200,
                         asgd=ASGDConfig(eps=0.1, batch=100))
    out = run_async_asgd(cfg, x64, w64, seed=0)
    print(f"ASGD    : err={out['error_first']:.4f}  "
          f"msgs sent={out['msgs_sent'].sum()} "
          f"good={out['msgs_good'].sum()} "
          f"wall={out['wall_seconds']:.1f}s (host threads)")

    # --- SimuParallelSGD (silent mode == communication off)
    cfg_s = AsyncSimConfig(ranks=8, rounds=200,
                           asgd=ASGDConfig(eps=0.1, batch=100, silent=True))
    out_s = run_async_asgd(cfg_s, x64, w64, seed=0)
    print(f"SGD     : err={out_s['error_first']:.4f}  (communication-free)")

    # --- BATCH (MapReduce-style full-batch descent), on the device
    w_b, errs_b = run_batch(x, w0, eps=1.0, iters=30)
    print(f"BATCH   : err={float(errs_b[-1]):.4f}  (30 full passes on "
          f"{dev.type})")

    # --- convergence traces (samples touched -> error)
    tr = np.mean(np.asarray(out["err_trace"]), axis=0)
    tr_s = np.mean(np.asarray(out_s["err_trace"]), axis=0)
    print("\nerror every 10 rounds (ASGD vs silent):")
    for i in range(0, len(tr), 4):
        print(f"  round {10 * i:4d}:  {tr[i]:.4f}   {tr_s[i]:.4f}")
    if (tr <= tr_s[-1]).any():
        print("\nASGD reaches silent-mode's final error with "
              f"{100 * (1 - np.argmax(tr <= tr_s[-1]) / len(tr)):.0f}% "
              "of the iterations")
    return {"asgd": out, "silent": out_s, "batch_errors": errs_b}


if __name__ == "__main__":
    main()
