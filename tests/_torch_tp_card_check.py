"""tests/_torch_tp_ranks.py's 4 gloo CPU ranks on a machine without jax
(the card's, whose torch is stricter about DTensor views than this
one's), against the port's single-device pytree step there:

    PYTHONPATH=src python tests/_torch_tp_card_check.py OUT_DIR

The cases are the test's (tests/test_torch_tensor_parallel.py): its
configs, weights, tokens and frames or patches from the same numpy
seeds; the draws are chosen here without jax (shifts 1 then 2 on the
first group holding a replicated leaf, then group 0).  Each case is held
to the test's tolerances against the single-device step: losses within
rel 1e-5, params within rtol 1e-5 and atol 1e-5, gates equal.  Prints a
line a case; exits 1 if a rank fails or a case misses.
"""
import pathlib
import sys

import numpy as np
import torch

import _torch_tp_ranks as R
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.tree import tree_map
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM

TIMEOUT_S = 900
SIZES = dict(zip(("data", "model"), R.MESH))


def draws(cfg, gcfg):
    meta = tree_map(lambda x: x.expand((R.W,) + tuple(x.shape)),
                    TM.init_model(cfg, device="meta"))
    groups = [g for _, g in SH.tree_paths(tg.leaf_groups(
        meta, gcfg.partial_blocks))]
    repl = min(g for (p, x), g in zip(SH.tree_paths(meta), groups)
               if "model" not in SH.param_pspec(p, x, axis_sizes=SIZES))
    return [(0, repl), (1, repl), (0, 0)]


def case_inputs(arch, seed):
    """The rank program's inputs of one case, and its global batches."""
    cfg = R.config(arch, get_arch)
    gcfg = tg.GossipConfig(**R.gossip_kw(arch, torch.bfloat16))
    rng = np.random.default_rng(seed + 100)
    out = {f"{arch}.w.{k}": v for k, v in R.weights(cfg, seed).items()}
    batches = []
    for t, d in enumerate(draws(cfg, gcfg)):
        b = {"tokens": rng.integers(0, cfg.vocab, (R.W, R.BATCH, R.SEQ))
             .astype(np.int32)}
        out[f"{arch}.tok.{t}"] = b["tokens"]
        out[f"{arch}.draw.{t}"] = np.asarray(d)
        batches.append((b, d))
    if cfg.frontend:       # drawn after the tokens, as the test draws them
        n = cfg.encoder_seq if cfg.frontend == "audio" else cfg.prefix_len
        for t, (b, _) in enumerate(batches):
            b[R.STUB[cfg.frontend]] = out[f"{arch}.stub.{t}"] = (
                0.1 * rng.standard_normal((R.W, R.BATCH, n, cfg.d_model))
                .astype(np.float32))
    return out, batches


def single(arch, inputs, batches):
    """Losses, gates and final params of the single-device pytree step."""
    cfg = R.config(arch, get_arch)
    gcfg = tg.GossipConfig(**R.gossip_kw(arch, torch.bfloat16))
    step = make_train_step(cfg, gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
    head = f"{arch}.w."
    params = params_from_numpy(R.nest({k[len(head):]: v for k, v in
                                       inputs.items() if k.startswith(head)}))
    state, metrics = tg.init_gossip_state(params, gcfg), []
    for b, (si, bi) in batches:
        params, state, _, m = step(params, state, 0, {
            k: torch.from_numpy(v) for k, v in b.items()}, si, bi)
        metrics.append({n: m[n].numpy() for n in ("loss", "gate")})
    return metrics, {R.path_key(p): x.numpy()
                     for p, x in SH.tree_paths(params)}


def main(out_dir):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    inputs, batches = {}, {}
    for seed, arch in enumerate(R.ARCHS):
        ins, batches[arch] = case_inputs(arch, seed)
        inputs.update(ins)
    procs, logs = R.start_ranks(out, inputs)
    torch.set_num_threads(1)
    try:
        want = {a: single(a, inputs, batches[a]) for a in R.ARCHS}
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    print(f"torch {torch.__version__}: ranks exited {codes}", flush=True)
    if any(codes):
        print((out / f"rank{codes.index(next(filter(None, codes)))}.log")
              .read_text()[-3000:])
        return 1
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(R.WORLD)]
    ok = True
    for arch in R.ARCHS:
        steps, params = want[arch]
        rel = max(abs(float(got[0][f"{arch}.{t}.loss"]) - float(m["loss"]))
                  / abs(float(m["loss"])) for t, m in enumerate(steps))
        gates = all(np.array_equal(rk[f"{arch}.{t}.gate"], m["gate"])
                    for rk in got for t, m in enumerate(steps))
        err = max(float(np.abs(got[0][f"{arch}.final.{k}"] - v).max())
                  for k, v in params.items())
        close = all(np.allclose(got[0][f"{arch}.final.{k}"], v, rtol=1e-5,
                                atol=1e-5) for k, v in params.items())
        good = rel <= 1e-5 and gates and close
        ok &= good
        print(f"{arch}: loss rel {rel:.3e}, gates equal {gates}, max |param "
              f"diff| {err:.3e}: {'ok' if good else 'MISSED'}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
