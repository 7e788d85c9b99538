"""tests/_torch_tp_ranks.py's and tests/_torch_tp_serve_ranks.py's 4
gloo CPU ranks on a machine without jax (the card's, whose torch is
stricter about DTensor views than this one's), against the port's
single-device pytree step and serve there:

    PYTHONPATH=src python tests/_torch_tp_card_check.py OUT_DIR

Training: the cases of tests/test_torch_tensor_parallel.py — its
configs, weights, tokens and frames or patches from the same numpy
seeds; the draws are chosen here without jax (shifts 1 then 2 on the
first group holding a replicated leaf, then group 0).  Each case is held
to the test's tolerances against the single-device step: losses within
rel 1e-5, params within rtol 1e-5 and atol 1e-5, gates equal.

Serving: the cases of tests/test_torch_tensor_parallel_serve.py, on
numpy weights (worker 0's of the training cases' draw; that test takes
the reference's initialisation, which needs jax) and prompts, frames and
patches from numpy seeds.  Each is held to that test's gates against the
single-device serve: the prefill's logits and each decode step's (from
an f32 copy of the single-device cache) within 1e-5 of the largest,
generate(mesh=)'s tokens equal, every cache leaf placed by cache_pspec,
a decode step's collectives the same at two cache lengths.

'S' and 'R' layers, and MoE FFNs: the cases of
tests/test_torch_tensor_parallel_ssm.py (tests/_torch_tp_ssm_ranks.py)
and of tests/test_torch_tensor_parallel_moe.py
(tests/_torch_tp_moe_ranks.py), on numpy weights (worker 0 of each
training draw as the base of its workers' starts), against the
single-device port at that test's gates: training's losses, gates and
params as above and each gradient part within 1e-4 of its largest
magnitude; serving's logits within 1e-5 of the largest, tokens equal,
cache placements, and a decode step's collectives alike at two lengths
and none reading the cache.

The step options the dry-run's step takes: tests/test_torch_tensor_
parallel_blend.py's cases (tests/_torch_tp_blend_ranks.py: the plain
blend, algos sync and silent, the silent flag) on the smollm training
case's inputs, held as training above.  The dry-run's placed trace:
tests/test_torch_dryrun_tp.py's cases (tests/_torch_tp_dryrun_ranks.py),
ranks 0 and 1 traced on meta here against the gloo ranks' real run,
every count equal but the peak, the real one within 1% above (that
test's bound).  The options ROADMAP 15d/15f brought to the mesh:
tests/test_torch_tensor_parallel_options.py's cases
(tests/_torch_tp_options_ranks.py: the int8 wire on shards, live=,
momentum, Adam, sync with momentum, gossip_every 2, 'rows' mode alone
and on int8) against the single-device step at that test's gates, its
int8 exchange check and its planted faults.

Prints a line a case; exits 1 if a rank fails or a case misses.
"""
import json
import pathlib
import sys

import numpy as np
import torch

import _torch_tp_blend_ranks as B
import _torch_tp_dryrun_ranks as DR
import _torch_tp_moe_ranks as M
import _torch_tp_options_ranks as O
import _torch_tp_ranks as R
import _torch_tp_serve_ranks as S
import _torch_tp_ssm_ranks as T
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.tree import tree_map
from repro_torch.launch import sharding as SH
from repro_torch.launch.steps import (init_inner_state, make_train_step,
                                      tree_loss_and_grad)
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


def single(arch, inputs, batches, algo="asgd", use_fused=True, **acfg_kw):
    """Losses, gates (where the algo has them) and final params of the
    single-device pytree step."""
    cfg = R.config(arch, get_arch)
    gcfg = tg.GossipConfig(**R.gossip_kw(arch, torch.bfloat16))
    step = make_train_step(cfg, algo=algo, gcfg=gcfg, acfg=tasgd.ASGDConfig(
        eps=R.EPS, use_fused=use_fused, **acfg_kw))
    head = f"{arch}.w."
    params = params_from_numpy(R.nest({k[len(head):]: v for k, v in
                                       inputs.items() if k.startswith(head)}))
    state, metrics = tg.init_gossip_state(params, gcfg), []
    for b, (si, bi) in batches:
        params, state, _, m = step(params, state, 0, {
            k: torch.from_numpy(v) for k, v in b.items()}, si, bi)
        metrics.append({n: m[n].numpy() for n in ("loss", "gate")
                        if n in m})
    return metrics, {R.path_key(p): x.numpy()
                     for p, x in SH.tree_paths(params)}


def serve_inputs(name, seed):
    """The serve rank program's inputs of one case."""
    arch, rows, prompt = S.CASES[name]
    cfg = R.config(arch, get_arch)
    out = {f"{name}.w.{k}": v[0] for k, v in R.weights(cfg, seed).items()}
    rng = np.random.default_rng(seed + 300)
    out[f"{name}.tokens"] = rng.integers(0, cfg.vocab, (rows, prompt)) \
        .astype(np.int32)
    if cfg.frontend:
        n = cfg.encoder_seq if cfg.frontend == "audio" else cfg.prefix_len
        out[f"{name}.stub"] = (0.1 * rng.standard_normal(
            (rows, n, cfg.d_model))).astype(np.float32)
    return out


def serve_placements_ok(rk, name, cfg, rows, length):
    """Every recorded cache leaf placed as cache_pspec says."""
    sizes = dict(zip(("data", "model"), R.MESH))
    meta = TM.init_cache(cfg, rows, length, device="meta")
    for path, x in SH.tree_paths(meta):
        spec = SH.cache_pspec(path, x, cfg, axis_sizes=sizes)
        dims = [d for d, a in enumerate(spec) if a == "model"]
        want = f"S{dims[0]}" if dims else "R"
        for t in range(S.NEW):
            if str(rk[f"{name}.{t}.cache.{R.path_key(path)}.placement"]) \
                    != want:
                return False
    return True


def serve_check(out):
    """The serve ranks against the single-device serve; True if every
    case meets the gates."""
    out.mkdir(parents=True, exist_ok=True)
    inputs = {}
    for seed, name in enumerate(S.CASES):
        inputs.update(serve_inputs(name, seed))
    procs, logs = R.start_ranks(out, inputs, script=S.__file__)
    torch.set_num_threads(1)
    try:
        want = {}
        for name, (arch, _, prompt) in S.CASES.items():
            cfg = R.config(arch, get_arch)
            head = f"{name}.w."
            params = params_from_numpy(R.nest({
                k[len(head):]: v for k, v in inputs.items()
                if k.startswith(head)}))
            logits, toks, _ = S.serve_plain(
                cfg, params, S.batch_of(inputs, name, cfg), prompt)
            want[name] = (logits[0].numpy(), toks.numpy())
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    print(f"torch {torch.__version__}: serve ranks exited {codes}",
          flush=True)
    if any(codes):
        print((out / f"rank{codes.index(next(filter(None, codes)))}.log")
              .read_text()[-3000:])
        return False
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(R.WORLD)]
    ok = all(np.array_equal(rk["greedy.got"], rk["greedy.want"])
             for rk in got)
    for name, (arch, rows, prompt) in S.CASES.items():
        cfg = R.config(arch, get_arch)
        prefill, toks = want[name]

        def rel(a, b):
            return float(np.abs(a - b).max()
                         / np.abs(b[..., :cfg.vocab]).max())
        errs = [rel(rk[f"{name}.0.logits"], prefill[rk[f"{name}.rows"]])
                for rk in got]
        errs += [rel(rk[f"{name}.forced.{t}"],
                     rk[f"{name}.forced_plain.{t}"][rk[f"{name}.rows"]])
                 for rk in got for t in range(1, S.NEW)]
        same_toks = all(np.array_equal(rk[f"{name}.generate"], toks)
                        for rk in got)
        placed = all(serve_placements_ok(rk, name, cfg, rows,
                                         S.cache_len(cfg, prompt))
                     for rk in got)
        comms = all(list(rk[f"{name}.comms"])
                    == list(rk[f"{name}.comms_long"]) for rk in got)
        good = max(errs) <= 1e-5 and same_toks and placed and comms
        ok &= good
        print(f"serve {name}: max logit err {max(errs):.3e} of the largest, "
              f"tokens equal {same_toks}, placements {placed}, collectives "
              f"alike at two lengths {comms}: "
              f"{'ok' if good else 'MISSED'}", flush=True)
    return ok


def layer_inputs(ranks):
    """The inputs of ``ranks`` (tests/_torch_tp_ssm_ranks.py or
    _torch_tp_moe_ranks.py: its TRAIN and SERVE cases) from numpy (worker
    0 of each case's training draw as the base, T.worker_starts beside
    it) and each training case's config."""
    inputs, train = {}, {}
    for seed, (name, (arch, cuts, rows)) in enumerate(ranks.TRAIN.items()):
        cfg = T.config(arch, cuts, get_arch)
        base = {k: v[0] for k, v in R.weights(cfg, seed).items()}
        inputs.update({f"train.{name}.w.{k}": v for k, v in
                       T.worker_starts(base, seed).items()})
        rng = np.random.default_rng(seed + 100)
        toks = []
        for t, d in enumerate(draws(cfg, tg.GossipConfig(**T.gossip_kw()))):
            toks.append(rng.integers(0, cfg.vocab, (R.W, rows, T.SEQ))
                        .astype(np.int32))
            inputs[f"train.{name}.tok.{t}"] = toks[-1]
            inputs[f"train.{name}.draw.{t}"] = np.asarray(d)
        train[name] = cfg
    for seed, (name, (arch, cuts, rows, prompt)) in enumerate(
            ranks.SERVE.items()):
        cfg = T.config(arch, cuts, get_arch)
        inputs.update({f"{name}.w.{k}": v[0] for k, v in
                       R.weights(cfg, seed + 10).items()})
        inputs[f"{name}.tokens"] = np.random.default_rng(seed + 300) \
            .integers(0, cfg.vocab, (rows, prompt)).astype(np.int32)
    return inputs, train


def layer_check(out, ranks, what):
    """The ranks of ``ranks`` ('S'/'R' or MoE, :func:`layer_inputs`)
    against the single-device port: training's losses, gates and params
    at the train cases' gates, each gradient part within 1e-4 of its
    largest magnitude; serving's logits within 1e-5 of the largest,
    tokens equal, placements, collectives alike at two lengths and none
    reading the cache.  True if every case meets them."""
    out.mkdir(parents=True, exist_ok=True)
    inputs, train = layer_inputs(ranks)
    procs, logs = R.start_ranks(out, inputs, script=ranks.__file__)
    torch.set_num_threads(1)
    try:
        want = {}
        for name, cfg in train.items():
            head = f"train.{name}."
            params = params_from_numpy(R.nest({
                k[len(head) + 2:]: v for k, v in inputs.items()
                if k.startswith(head + "w.")}))
            toks = [torch.from_numpy(inputs[f"{head}tok.{t}"])
                    for t in range(T.STEPS)]
            _, grads = tree_loss_and_grad(cfg, params, {"tokens": toks[0]})
            gcfg = tg.GossipConfig(**T.gossip_kw())
            step = make_train_step(cfg, gcfg=gcfg, acfg=tasgd.ASGDConfig(
                eps=R.EPS, use_fused=True))
            state, metrics = tg.init_gossip_state(params, gcfg), []
            for t in range(T.STEPS):
                si, bi = (int(v) for v in inputs[f"{head}draw.{t}"])
                params, state, _, m = step(params, state, 0,
                                           {"tokens": toks[t]}, si, bi)
                metrics.append({n: m[n].numpy() for n in ("loss", "gate")
                        if n in m})
            want[name] = (metrics, {R.path_key(p): x.numpy()
                                    for p, x in SH.tree_paths(params)},
                          {R.path_key(p): x.numpy()
                           for p, x in SH.tree_paths(grads)})
        for name, (arch, cuts, _, prompt) in ranks.SERVE.items():
            cfg = T.config(arch, cuts, get_arch)
            params = params_from_numpy(R.nest({
                k[len(name) + 3:]: v for k, v in inputs.items()
                if k.startswith(f"{name}.w.")}))
            logits, toks, _ = S.serve_plain(cfg, params, {
                "tokens": torch.from_numpy(inputs[f"{name}.tokens"])},
                prompt)
            want[f"serve.{name}"] = (logits[0].numpy(), toks.numpy())
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    print(f"torch {torch.__version__}: {what} ranks exited {codes}",
          flush=True)
    if any(codes):
        print((out / f"rank{codes.index(next(filter(None, codes)))}.log")
              .read_text()[-3000:])
        return False
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(R.WORLD)]
    ok = True
    for name, cfg in train.items():
        steps, params, grads = want[name]
        head = f"train.{name}."
        rel = max(abs(float(got[0][f"{head}{t}.loss"]) - float(m["loss"]))
                  / abs(float(m["loss"])) for t, m in enumerate(steps))
        gates = all(np.array_equal(rk[f"{head}{t}.gate"], m["gate"])
                    for rk in got for t, m in enumerate(steps))
        close = all(np.allclose(got[0][f"{head}final.{k}"], v, rtol=1e-5,
                                atol=1e-5) for k, v in params.items())
        gerr = max(
            float(np.abs(T.grad_parts(cfg, k, got[0][f"{head}grads.{k}"])[p]
                         - w).max() / np.abs(w).max())
            for k, v in grads.items()
            for p, w in T.grad_parts(cfg, k, v).items())
        good = rel <= 1e-5 and gates and close and gerr <= 1e-4
        ok &= good
        print(f"{what} train {name}: loss rel {rel:.3e}, gates equal "
              f"{gates}, params within 1e-5 {close}, largest gradient part "
              f"error {gerr:.3e} of its largest: "
              f"{'ok' if good else 'MISSED'}",
              flush=True)
    for name, (arch, cuts, rows, prompt) in ranks.SERVE.items():
        cfg = T.config(arch, cuts, get_arch)
        prefill, toks = want[f"serve.{name}"]

        def rel(a, b):
            return float(np.abs(a - b).max()
                         / np.abs(b[..., :cfg.vocab]).max())
        errs = [rel(rk[f"{name}.0.logits"], prefill[rk[f"{name}.rows"]])
                for rk in got]
        errs += [rel(rk[f"{name}.forced.{t}"],
                     rk[f"{name}.forced_plain.{t}"][rk[f"{name}.rows"]])
                 for rk in got for t in range(1, S.NEW)]
        same_toks = all(np.array_equal(rk[f"{name}.generate"], toks)
                        for rk in got)
        placed = all(serve_placements_ok(rk, name, cfg, rows,
                                         S.cache_len(cfg, prompt))
                     for rk in got)
        comms = all(list(rk[f"{name}.comms"])
                    == list(rk[f"{name}.comms_long"])
                    and int(rk[f"{name}.comms_cache"]) == 0 for rk in got)
        good = max(errs) <= 1e-5 and same_toks and placed and comms
        ok &= good
        print(f"{what} serve {name}: max logit err {max(errs):.3e} of the "
              f"largest, tokens equal {same_toks}, placements {placed}, "
              f"collectives alike at two lengths and none on the cache "
              f"{comms}: "
              f"{'ok' if good else 'MISSED'}", flush=True)
    return ok


def finish(out, procs, logs, what):
    """Waits for the ranks; True if every one exited 0 (else prints the
    first failing rank's log)."""
    try:
        codes = [p.wait(timeout=TIMEOUT_S) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for f in logs:
            f.close()
    print(f"torch {torch.__version__}: {what} ranks exited {codes}",
          flush=True)
    if any(codes):
        print((out / f"rank{codes.index(next(filter(None, codes)))}.log")
              .read_text()[-3000:])
    return not any(codes)


def blend_check(out):
    """The step-option ranks against the single-device pytree step under
    each option; True if every case meets the gates."""
    out.mkdir(parents=True, exist_ok=True)
    inputs, batches = case_inputs(B.ARCH, 0)
    procs, logs = R.start_ranks(out, inputs, script=B.__file__)
    torch.set_num_threads(1)
    want = {}
    try:
        for case, (algo, acfg_kw) in B.CASES.items():
            want[case] = single(B.ARCH, inputs, batches, algo=algo,
                                use_fused=False, **acfg_kw)
    finally:
        ran = finish(out, procs, logs, "step-option")
    if not ran:
        return False
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(R.WORLD)]
    ok = True
    for case, (steps, params) in want.items():
        rel = max(abs(float(got[0][f"{case}.{t}.loss"]) - float(m["loss"]))
                  / abs(float(m["loss"])) for t, m in enumerate(steps))
        gates = all(np.array_equal(rk[f"{case}.{t}.gate"], m["gate"])
                    for rk in got for t, m in enumerate(steps) if "gate" in m)
        close = all(np.allclose(got[0][f"{case}.final.{k}"], v, rtol=1e-5,
                                atol=1e-5) for k, v in params.items())
        good = rel <= 1e-5 and gates and close
        ok &= good
        print(f"step option {case}: loss rel {rel:.3e}, gates equal {gates}"
              f", params close {close}: {'ok' if good else 'MISSED'}",
              flush=True)
    return ok


def options_check(out):
    """The step options of ROADMAP 15d/15f (tests/_torch_tp_options_ranks
    .py) against the single-device pytree step with each option; True if
    every case meets the test's gates: losses within rel 1e-5, gates and
    buf_live equal, params within rtol and atol 1e-5 (Adam: each step
    against the single-device step from the ranks' state on their
    gradient, the gradient within 1e-5 of the single-device one's); the
    int8 exchange on shards bitwise the single-device one and the
    shard-absmax fault missing it; the planted faults missing."""
    out.mkdir(parents=True, exist_ok=True)
    inputs, batches = case_inputs(O.ARCH, 0)
    procs, logs = R.start_ranks(out, inputs, script=O.__file__)
    torch.set_num_threads(1)
    want = {}
    try:
        for case in O.CASES:
            want[case] = single_option(case, inputs, batches)
    finally:
        ran = finish(out, procs, logs, "15d/15f step-option")
    if not ran:
        return False
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(R.WORLD)]

    def meets(tag, case):
        steps, params = want[case]
        rel = max(abs(float(got[0][f"{tag}.{t}.loss"]) - float(m["loss"]))
                  / abs(float(m["loss"])) for t, m in enumerate(steps))
        equal = all(np.array_equal(rk[f"{tag}.{t}.{k}"], m[k])
                    for rk in got for t, m in enumerate(steps)
                    for k in ("gate", "buf_live") if k in m)
        if O.CASES[case][1] == "adam":
            close = all(int(got[0][f"{tag}.{t}.tf_beyond"]) == 0 and float(
                got[0][f"{tag}.{t}.grad_rel"]) <= 1e-5
                for t in range(len(steps)))
        else:
            close = all(np.allclose(got[0][f"{tag}.final.{k}"], v,
                                    rtol=1e-5, atol=1e-5)
                        for k, v in params.items())
        return rel, equal, close, rel <= 1e-5 and equal and close
    ok = True
    for case in O.CASES:
        rel, equal, close, good = meets(case, case)
        ok &= good
        print(f"15d/15f option {case}: loss rel {rel:.3e}, gates and "
              f"buf_live equal {equal}, params close {close}: "
              f"{'ok' if good else 'MISSED'}", flush=True)
    for fault, case in O.FAULTS.items():
        good = not meets(fault, case)[3]
        ok &= good
        verdict = "missed, as it must" if good else "MET: the check is blind"
        print(f"15d/15f planted fault {fault}: {verdict}", flush=True)
    pairs = [k for k in got[0] if k.startswith("xchg.") and
             k.count(".") == 2]
    exact = all(float(rk[k]) == 0.0 for rk in got for k in pairs)
    fault = all(float(rk[k + ".fault"]) > 0.0 for rk in got for k in pairs
                if int(rk[k + ".sharded"]))
    ok &= exact and fault
    print(f"15d int8 exchange on shards bitwise the single-device one on "
          f"{len(pairs)} pairs: {exact}; shard-absmax fault misses: {fault}",
          flush=True)
    return ok


def single_option(case, inputs, batches):
    """Losses, gates, buf_live and final params of the single-device
    pytree step under a tests/_torch_tp_options_ranks.py case."""
    algo, inner, _, acfg_kw, elastic = O.CASES[case]
    cfg = R.config(O.ARCH, get_arch)
    gcfg = tg.GossipConfig(**O.gossip_kw(case))
    step = make_train_step(cfg, algo=algo, inner=inner, gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=R.EPS, **{
                               "use_fused": True, **acfg_kw}))
    head = f"{O.ARCH}.w."
    params = params_from_numpy(R.nest({k[len(head):]: v for k, v in
                                       inputs.items() if k.startswith(head)}))
    state = tg.init_gossip_state(params, gcfg, elastic=elastic)
    opt, metrics = init_inner_state(params, inner), []
    for t, (b, (si, bi)) in enumerate(batches):
        kw = {"live": O.live_at(t)} if elastic else {}
        params, state, opt, m = step(params, state, opt, {
            k: torch.from_numpy(v) for k, v in b.items()}, si, bi, **kw)
        rec = {n: m[n].numpy() for n in ("loss", "gate") if n in m}
        if elastic:
            rec["buf_live"] = state.buf_live.numpy()
        metrics.append(rec)
    return metrics, {R.path_key(p): x.numpy()
                     for p, x in SH.tree_paths(params)}


def dryrun_check(out):
    """The dry-run's placed trace: ranks 0 and 1 on meta here against the
    gloo ranks' real steps; True if every count is equal."""
    from repro_torch.launch.mesh import fake_process_group, make_host_mesh
    out.mkdir(parents=True, exist_ok=True)
    procs, logs = R.start_ranks(out, {}, script=DR.__file__)
    torch.set_num_threads(1)
    meta = {}
    try:
        for rank in (0, 1):
            with fake_process_group(DR.WORLD, rank=rank):
                mesh = make_host_mesh(*DR.MESH, device="cpu")
                meta[rank] = {c[0]: DR.trace(c, mesh) for c in DR.CASES}
    finally:
        ran = finish(out, procs, logs, "dry-run")
    if not ran:
        return False
    ok = True
    for rank in (0, 1):
        real = {k: json.loads(str(v)) for k, v in
                np.load(out / f"rank{rank}.npz").items()}
        for case, m in meta[rank].items():
            r = real[case]
            bad = [k for k in ("flops", "bytes", "arg_bytes", "kernels",
                               "collectives", "n_collectives") if m[k] != r[k]]
            if not m["peak"] <= r["peak"] <= 1.01 * m["peak"]:
                bad.append("peak")
            ok &= not bad
            print(f"dry-run {case} rank {rank}: meta = real "
                  f"{'in every count' if not bad else 'MISSED in ' + str(bad)}"
                  f" (FLOPs {m['flops']}, peak {m['peak']} B)", flush=True)
    return ok


def main(out_dir):
    out = pathlib.Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    serve_ok = serve_check(out / "serve")
    serve_ok &= layer_check(out / "ssm", T, "'S'/'R'")
    serve_ok &= layer_check(out / "moe", M, "MoE")
    serve_ok &= blend_check(out / "blend")
    serve_ok &= options_check(out / "options")
    serve_ok &= dryrun_check(out / "dryrun")
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
    return 0 if ok and serve_ok else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1]))
