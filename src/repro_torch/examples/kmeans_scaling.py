"""Reproduce the paper's strong-scaling story (Figs. 1/5): time-to-error of
ASGD vs SGD vs BATCH as the worker count grows.  Rounds-to-error are
simulated (core/baselines.py, on the device); the wall-clock is MODELED
(FDR-Infiniband cost model, examples/cost_model.py) — no time printed here
is a measured one.

Run:  PYTHONPATH=src python -m repro_torch.examples.kmeans_scaling \
          [--device cpu] [--m N]
"""
import argparse

import torch

from repro_torch import resolve_device, set_full_fp32_precision
from repro_torch.core import kmeans
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.baselines import (RoundSimConfig, draw_rounds,
                                        draw_shard_permutation, run_batch,
                                        shard_data, simulate_rounds)
from repro_torch.examples.cost_model import (iters_to_error, t_comm_asgd,
                                             t_comm_batch, t_comm_sgd)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--m", type=int, default=200_000, help="samples")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    set_full_fp32_precision()

    gen = torch.Generator(device=dev).manual_seed(0)
    x, centers, _ = kmeans.synthetic_clusters(gen, k=10, d=10, m=args.m,
                                              spread=0.12)
    w0 = kmeans.init_prototypes(
        x, kmeans.choose_prototype_indices(gen, args.m, 10))
    b = 500
    grad_us = 40.0  # modeled per-sample cost (the reference's placeholder)
    state_bytes = w0.numel() * 4
    total_samples = 1_600_000

    print("modeled (FDR-Infiniband cost model) seconds to error:")
    print(f"{'workers':>8} {'ASGD(s)':>10} {'SGD(s)':>10} {'BATCH(s)':>10}")
    target = None
    rows = []
    _, errs_b = run_batch(x, w0, eps=1.0, iters=30)
    errs_b = errs_b.cpu().numpy()
    for workers in (4, 8, 16, 32, 64):
        rounds = max(4, total_samples // (workers * b))
        shards = shard_data(x, workers, draw_shard_permutation(gen, args.m))
        cfg = RoundSimConfig(workers=workers, rounds=rounds,
                             asgd=ASGDConfig(eps=0.1, batch=b))
        out = simulate_rounds(shards, w0, cfg,
                              draw_rounds(gen, cfg, shards.shape[1]))
        errors = out["errors"].cpu().numpy()
        if target is None:
            target = float(errors[-1]) * 1.1
        it = iters_to_error(errors, target)
        t_round = b * grad_us * 1e-6
        wall_asgd = it * (t_round + t_comm_asgd(state_bytes))
        wall_sgd = it * (t_round + t_comm_sgd())
        it_b = iters_to_error(errs_b, target)
        wall_b = it_b * ((x.shape[0] // workers) * grad_us * 1e-6
                         + t_comm_batch(state_bytes, workers))
        rows.append((workers, it, it_b, wall_asgd, wall_sgd, wall_b))
        print(f"{workers:>8} {wall_asgd:>10.3f} {wall_sgd:>10.3f} "
              f"{wall_b:>10.3f}   (rounds-to-err: asgd/sgd={it}, "
              f"batch={it_b})")

    print("\nNote: per the paper, BATCH pays a full data pass + tree "
          "all-reduce per iteration;\nASGD sends one-sided |w|/p messages "
          "that never block; SGD never communicates.")
    return rows


if __name__ == "__main__":
    main()
