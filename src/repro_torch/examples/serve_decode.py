"""Serving example: batched prefill + greedy decode across the reference's
architecture families, through the public serving CLI.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \
          [--device cpu]

The port serves the dense, MoE, SSM and hybrid families (smollm-135m,
granite-moe-1b-a400m, mamba2-370m, recurrentgemma-9b, reduced); the other
archs of the reference's list are not ported yet, and the example ends by
raising NotImplementedError that names each with its ROADMAP.md item.
"""
import argparse

from repro_torch.configs.registry import get_arch
from repro_torch.launch.serve import main as serve_main
from repro_torch.models.blocks import FAMILY_ITEMS

ARCHS = [
    "smollm-135m",          # dense
    "granite-moe-1b-a400m", # MoE top-8
    "mamba2-370m",          # SSM (O(1) decode state)
    "recurrentgemma-9b",    # hybrid RG-LRU
    "whisper-tiny",         # enc-dec audio (stub frontend)
    "paligemma-3b",         # VLM (stub SigLIP prefix)
]
PORTED = ("smollm-135m", "granite-moe-1b-a400m", "mamba2-370m",
          "recurrentgemma-9b")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for arch in PORTED:
        serve_main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "8",
                    "--device", args.device])
    missing = [f"{a} (item {FAMILY_ITEMS[get_arch(a).arch_type]})"
               for a in ARCHS if a not in PORTED]
    raise NotImplementedError(
        f"serving {', '.join(missing)} is not ported yet — ROADMAP.md "
        "queue A")


if __name__ == "__main__":
    main()
