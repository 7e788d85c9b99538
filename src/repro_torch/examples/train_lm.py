"""End-to-end example: train a ~135M-class LM (smollm-135m) with ASGD for a
few steps on synthetic data, against the SimuParallelSGD (silent) and
synchronous-BATCH baselines, through the port's trainer
(``repro_torch.launch.train``, its pytree engine).

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm \\
          [--full] [--steps N] [--workers W] [--device cpu]

Without ``--full`` the arch is reduced; ``--device cpu`` runs on the CPU
through the kernels' plain versions.  Run as a script it fails unless
ASGD's last loss is below its first (the reference example's check);
:func:`main` returns the losses and leaves that verdict to its caller.
"""
import argparse

import numpy as np

from repro_torch.launch.train import main as train_main


def train_argv(full: bool, steps: int, workers: int, device: str) -> list:
    """The trainer's flags common to the three runs."""
    argv = ["--arch", "smollm-135m", "--steps", str(steps),
            "--workers", str(workers), "--batch", "2", "--seq", "128",
            "--eps", "0.1", "--log-every", "20", "--device", device]
    if not full:
        argv.append("--reduced")
    return argv


def summarize(name, losses):
    ls = np.asarray(losses)
    print(f"{name:8s} start={ls[0]:.3f} "
          f"mid={ls[len(ls) // 2]:.3f} final={ls[-1]:.3f}")


def main(argv=None):
    """Train asgd, silent and sync; print the loss summary and return the
    three runs' per-step losses."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--full", action="store_true",
                    help="full smollm-135m (default: reduced)")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    common = train_argv(args.full, args.steps, args.workers, args.device)

    print("=== ASGD (paper alg. 5: local SGD + gossip w/ Parzen gate) ===")
    losses = {"asgd": train_main(common + ["--algo", "asgd"])["losses"]}
    print("\n=== SimuParallelSGD (silent: zero communication) ===")
    losses["silent"] = train_main(common + ["--algo", "silent"])["losses"]
    print("\n=== BATCH analogue (synchronous all-reduce every step) ===")
    losses["sync"] = train_main(common + ["--algo", "sync"])["losses"]

    print("\n=== summary (next-token loss) ===")
    for name, ls in losses.items():
        summarize(name, ls)
    return losses


if __name__ == "__main__":
    asgd = main()["asgd"]
    if not asgd[-1] < asgd[0]:
        raise SystemExit(f"training must reduce loss: asgd losses {asgd}")
