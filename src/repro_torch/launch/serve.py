"""CLI server: batched prefill + greedy decode.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-370m \\
      --batch 4 --prompt-len 2048 --new-tokens 32

serves full mamba2-370m on the GPU (every 'S' layer of the prefill through
the SSD-scan kernel B5; decode is plain torch, as in the reference).  Add
``--device cpu`` (and ``--reduced`` for the smoke-scale arch) to run on the
CPU through the kernels' plain versions.  The port serves every arch of
the reference: whisper-tiny's prompt follows the encoder's output on
``encoder_seq`` stub frames, paligemma-3b's follows ``prefix_len`` stub
patch embeddings, both drawn at 0.1 x N(0, 1) from the seed, as the
reference's server draws them.  ``generate(..., mesh=)`` serves every
arch tensor-parallel over a ``("data", "model")`` mesh
(launch/tensor_parallel.py); the CLI, as the reference's, has no flag for
it.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import resolve_device, set_full_fp32_precision
from ..configs.registry import get_arch
from ..models import model as M
from .steps import make_decode_step, make_prefill_step
from .tensor_parallel import greedy_tokens, serve_gather, serve_slice


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def stub_inputs(cfg, lead, generator, device):
    """The frontend stub's inputs for a batch of shape ``lead`` ((batch,),
    or (W, batch) for a trainer): {"frames": (*lead, encoder_seq, D)} for
    an audio arch, {"patches": (*lead, prefix_len, D)} for a vision arch,
    at 0.1 x N(0, 1) from ``generator``; {} without a frontend."""
    stub = {"audio": ("frames", cfg.encoder_seq),
            "vision": ("patches", cfg.prefix_len)}.get(cfg.frontend)
    if not stub:
        return {}
    name, seq = stub
    return {name: 0.1 * torch.randn(tuple(lead) + (seq, cfg.d_model),
                                    generator=generator, device=device)}


@torch.no_grad()
def generate(cfg, params, batch, prompt_len, new_tokens, mesh=None):
    """Prefill + greedy decode loop (launch/steps.py's serving steps, the
    argmax ``tensor_parallel.greedy_tokens``).
    Returns (tokens (B, new_tokens), {"prefill_ms", "decode_ms_per_token",
    "steps_per_s"}): host-clock times of work that ends in a device sync.
    A vision prefix takes the first ``cfg.prefix_len`` positions of the
    cache, so decode writes after it.

    mesh: a ``("data", "model")`` DeviceMesh, every rank calling with the
    same whole ``batch`` and params placed by ``tensor_parallel
    .place_serve_params``: each rank serves its slice of the batch over
    the data axes (all of it where the batch does not divide), tensor-
    parallel over ``model``, its cache placed by ``cache_pspec``; every
    rank returns the whole batch's tokens."""
    prefill = make_prefill_step(cfg, mesh)
    decode = make_decode_step(cfg, mesh)
    rows = batch["tokens"].shape[0]
    kw = {}
    if mesh is not None:
        batch = {k: serve_slice(mesh, v) for k, v in batch.items()}
        kw["rows"] = rows
    device = batch["tokens"].device
    prefix = M.vision_prefix(cfg)
    _sync(device)
    t0 = time.perf_counter()
    last, cache = prefill(params, batch,
                          cache_len=prompt_len + prefix + new_tokens, **kw)
    tok = greedy_tokens(last)
    _sync(device)
    prefill_s = time.perf_counter() - t0
    out = [tok]
    t0 = time.perf_counter()
    for i in range(new_tokens - 1):
        logits, cache = decode(params, tok, prompt_len + prefix + i, cache,
                               **kw)
        tok = greedy_tokens(logits)
        out.append(tok)
    _sync(device)
    steps = max(new_tokens - 1, 1)
    decode_s = max(time.perf_counter() - t0, 1e-9)
    toks = torch.stack(out, dim=1).to(torch.int32)
    if mesh is not None:
        toks = serve_gather(mesh, toks, rows)
    return toks, {
        "prefill_ms": prefill_s * 1e3,
        "decode_ms_per_token": decode_s * 1e3 / steps,
        "steps_per_s": (new_tokens - 1) / decode_s}


def main(argv=None):
    """Parse flags, serve one batch of random prompts, print the timings
    and the reference's two lines; returns the tokens (batch, new_tokens)."""
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    set_full_fp32_precision()
    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = M.init_model(cfg, args.seed, device=device)
    gen = torch.Generator(device=device).manual_seed(args.seed + 1)
    batch = {"tokens": torch.randint(0, cfg.vocab,
                                     (args.batch, args.prompt_len),
                                     generator=gen, device=device)}
    batch.update(stub_inputs(cfg, (args.batch,), gen, device))
    toks, t = generate(cfg, params, batch, args.prompt_len, args.new_tokens)
    print(f"prefill {t['prefill_ms']:.3f} ms ({args.batch} x "
          f"{args.prompt_len} tokens), decode {t['decode_ms_per_token']:.3f}"
          f" ms per token, {args.batch * t['steps_per_s']:.1f} tokens/s "
          f"on {device}", flush=True)
    print(f"arch={cfg.name} batch={args.batch} "
          f"decoded {toks.shape[1]} tokens/seq at {t['steps_per_s']:.1f} "
          f"steps/s", flush=True)
    print("first sequence:", toks[0].tolist(), flush=True)
    return toks


if __name__ == "__main__":
    main()
