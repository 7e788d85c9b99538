"""Serving example: batched prefill + greedy decode across the reference's
architecture families, through the public serving CLI.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_decode \
          [--device cpu]

Serves each family's arch reduced: dense (smollm-135m), MoE
(granite-moe-1b-a400m), SSM (mamba2-370m), hybrid (recurrentgemma-9b),
encoder-decoder audio (whisper-tiny, on stub frames) and VLM
(paligemma-3b, on stub patch embeddings).
"""
import argparse

from repro_torch.launch.serve import main as serve_main

ARCHS = [
    "smollm-135m",          # dense
    "granite-moe-1b-a400m", # MoE top-8
    "mamba2-370m",          # SSM (O(1) decode state)
    "recurrentgemma-9b",    # hybrid RG-LRU
    "whisper-tiny",         # enc-dec audio (stub frontend)
    "paligemma-3b",         # VLM (stub SigLIP prefix)
]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    for arch in ARCHS:
        serve_main(["--arch", arch, "--reduced", "--batch", "2",
                    "--prompt-len", "16", "--new-tokens", "8",
                    "--device", args.device])


if __name__ == "__main__":
    main()
