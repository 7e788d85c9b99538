"""Tensor parallelism over ``model`` for the configs with 'S' (Mamba-2
SSD) and 'R' (RG-LRU) layers: the port's pytree train step
(make_train_step(mesh=)) and its serve (make_prefill_step /
make_decode_step(mesh=), generate(mesh=)) across 4 gloo CPU processes,
against the reference's jitted steps and the port's single-device ones.

One launch (tests/_torch_tp_ssm_ranks.py) runs 4 ranks as a (2, 2)
``("data", "model")`` mesh.  Cases (its TRAIN and SERVE): reduced
mamba2-370m, its 32 heads split over ``model`` with the shard boundaries
of in_proj's columns and the conv's channels inside x; mamba2-odd (3
heads, which ``model`` 2 does not divide: every rank scans every head,
the ssm cache replicated; in_proj shards d_model); reduced
recurrentgemma-9b, one (R, R, L) cycle with seq_parallel, at batch 2
(the RG-LRU split along its width) and at batch 16 (attn_batch_shard's
hint: the recurrent block split over its batch).  Weights are the
reference's initialisation carried over with repro_torch.convert; for
training each of W = 4 workers adds its own seeded offset as large as
the leaf's spread (eps 0.01 then opens some gates); tokens and prompts
come from numpy seeds.  Training: seq 32, partial_blocks 4, delay 1, 3
steps, draws chosen as tests/test_torch_tensor_parallel.py chooses them
(steps 1 and 2 blend groups holding replicated leaves).  Serving: batch
2, prompt 16, 8 greedy tokens.

While the ranks run, this process runs the reference (its jitted train
step with the plain blend, the jitted gradient of the workers' summed
losses, its jitted prefill and decode step; for training, all cases but
recurrentgemma-b16: TRAIN_REF) and the port's single-device steps (one
torch thread).

Tolerances.  Training: against the reference, test_torch_train_pytree
.py's (losses within rel 1e-4, params within atol 1e-4, gates and n_good
exactly); against the single-device port, losses within rel 1e-5, params
within rtol and atol 1e-5, gates exactly.  Gradients, leaf by leaf (and
in_proj's z/x/B/C/dt columns and conv_w's and conv_b's x/B/C channels
apart), within 1e-4 of the part's largest magnitude of the single-device
port's and 2e-4 of the reference's: these f32 gradients carry ~1.2e-5
of their largest magnitude against an f64 run of the same step (the
single-device port's, reduced mamba2), the single-device port's differ
from the reference's by up to 5.0e-5 (mamba2-odd's embedding), and a sum
over ``model`` in another order moves them by up to 3.0e-5 more; a
gradient that misses its sum over ``model`` is off by O(1).  Serving
(test_torch_tensor_parallel_serve.py's): logits within 1e-4 of the
largest of the reference's and 1e-5 of the single-device port's (the
decode steps each from an f32 copy of the single-device cache); greedy
tokens equal; the prefill's f32 states within 1e-5 of the single-device
port's largest magnitude and 1e-4 of the reference's, bf16 KV caches
within one bf16 step (1e-2).
"""
import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_decode_step as jmake_decode_step
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step, tree_loss_and_grad
from repro_torch.models import model as TM

import _torch_tp_ranks as R
import _torch_tp_serve_ranks as S
import _torch_tp_ssm_ranks as T
from test_torch_tensor_parallel import (finish_ranks, jax_draws, leaf_facts,
                                        step_keys)

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
SIZES = dict(zip(("data", "model"), R.MESH))
TRAIN, SERVE = tuple(T.TRAIN), tuple(T.SERVE)
# the training cases also held to the reference; recurrentgemma-b16 only
# to the single-device port (its batch-sharded recurrent block is the
# tensor-parallel path's own layout of recurrentgemma-9b's function, and
# the reference's step at batch 16 compiles for ~17 s)
TRAIN_REF = TRAIN[:3]
# of a gradient part's largest magnitude: against the single-device port,
# and against the reference (module docstring)
GRAD_TOL = {"single": 1e-4, "reference": 2e-4}
BF16_STEP = 1e-2
KV_LEAVES = ("k", "v")


def train_cfg(name, registry=get_arch):
    arch, cuts, _ = T.TRAIN[name]
    return T.config(arch, cuts, registry)


def serve_cfg(name, registry=get_arch):
    arch, cuts, _, _ = T.SERVE[name]
    return T.config(arch, cuts, registry)


def reference_leaves(cfg, seed):
    """One model's reference initialisation: (params, {path key: numpy})."""
    jp = JM.init_model(cfg, jax.random.key(seed))
    return jp, {R.path_key(p): np.asarray(x)
                for p, x in SH.tree_paths(jax.tree.map(np.asarray, jp))}


def make_train_case(name, seed):
    cfg = train_cfg(name)
    gcfg = tg.GossipConfig(**T.gossip_kw())
    keys = step_keys(leaf_facts(cfg, gcfg), gcfg)
    rng = np.random.default_rng(seed + 100)
    rows = T.TRAIN[name][2]
    tokens = [rng.integers(0, cfg.vocab, (R.W, rows, T.SEQ))
              .astype(np.int32) for _ in range(T.STEPS)]
    base = reference_leaves(train_cfg(name, jget_arch), seed)[1]
    jcfg = jg.GossipConfig(**T.gossip_kw())
    return {"w": T.worker_starts(base, seed), "tokens": tokens,
            "keys": keys,
            "draws": [jax_draws(jax.random.key(k), jcfg) for k in keys]}


def run_train_reference(name, case, cfg=None):
    """Losses, gates and n_good of each step, the final params, and the
    gradient of the first batch's summed worker losses (``cfg``: the
    reference's config, by default the case's)."""
    cfg = cfg or train_cfg(name, jget_arch)
    gcfg = jg.GossipConfig(**T.gossip_kw())
    jp = jax.tree.map(jnp.asarray, R.nest(case["w"]))

    def summed(p, tokens):
        return jnp.sum(jax.vmap(lambda pw, tw: JM.loss_fn(
            cfg, pw, {"tokens": tw}))(p, tokens))
    grads = jax.jit(jax.grad(summed))(jp, jnp.asarray(case["tokens"][0]))
    state, opt = jg.init_gossip_state(jp, gcfg), jinit_inner(jp, "sgd")
    step = jax.jit(jmake_train_step(cfg, algo="asgd", gcfg=gcfg,
                                    acfg=jasgd.ASGDConfig(eps=R.EPS),
                                    inner="sgd"))
    out = []
    for tok, k in zip(case["tokens"], case["keys"]):
        jp, state, opt, m = step(jp, state, opt, {"tokens": jnp.asarray(tok)},
                                 jax.random.key(k))
        out.append({n: np.asarray(m[n]) for n in ("loss", "gate", "n_good")})
    return out, numpy_leaves(jp), numpy_leaves(grads)


def numpy_leaves(tree):
    return {R.path_key(p): np.asarray(x) for p, x in
            SH.tree_paths(jax.tree.map(np.asarray, tree))}


def run_train_single(name, case, cfg=None):
    """The same on the port's single-device pytree step (B2r/B2a's plain
    versions) and tree_loss_and_grad."""
    cfg = cfg or train_cfg(name)
    gcfg = tg.GossipConfig(**T.gossip_kw())
    params = params_from_numpy(R.nest(case["w"]))
    _, grads = tree_loss_and_grad(
        cfg, params, {"tokens": torch.from_numpy(case["tokens"][0])})
    step = make_train_step(cfg, gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
    state = tg.init_gossip_state(params, gcfg)
    out = []
    for tok, (si, bi) in zip(case["tokens"], case["draws"]):
        params, state, _, m = step(params, state, 0,
                                   {"tokens": torch.from_numpy(tok)}, si, bi)
        out.append({n: m[n].numpy() for n in ("loss", "gate", "n_good")})
    return (out, {R.path_key(p): x.numpy() for p, x in SH.tree_paths(params)},
            {R.path_key(p): x.numpy() for p, x in SH.tree_paths(grads)})


def make_serve_case(name, seed):
    cfg = serve_cfg(name)
    jp, weights = reference_leaves(serve_cfg(name, jget_arch), seed)
    rows, prompt = T.SERVE[name][2:]
    rng = np.random.default_rng(seed + 300)
    return {"jp": jp, "w": weights, "batch": {"tokens": rng.integers(
        0, cfg.vocab, (rows, prompt)).astype(np.int32)}}


def numpy_cache(cache):
    return {R.path_key(p): np.asarray(x.float() if torch.is_tensor(x)
                                      else np.asarray(x, np.float32))
            for p, x in SH.tree_paths(cache)}


def run_serve_single(name, case):
    logits, toks, caches = S.serve_plain(
        serve_cfg(name), params_from_numpy(R.nest(case["w"])),
        {"tokens": torch.from_numpy(case["batch"]["tokens"])},
        T.SERVE[name][3])
    return ([x.numpy() for x in logits], toks.numpy(),
            [numpy_cache(c) for c in caches])


def run_serve_reference(name, case, single):
    """The reference's prefill, then each decode step from an f32 copy of
    the port's single-device cache and its token."""
    jcfg = serve_cfg(name, jget_arch)
    prompt = T.SERVE[name][3]
    scfg = dataclasses.replace(jcfg, attn_batch_shard=False,
                               seq_parallel=False)
    length = S.cache_len(jcfg, prompt)
    prefill = jax.jit(lambda p, b: JM.prefill(scfg, p, b, cache_len=length))
    decode = jax.jit(jmake_decode_step(jcfg))
    last, cache = prefill(case["jp"], {"tokens": jnp.asarray(
        case["batch"]["tokens"])})
    logits, caches = [np.asarray(last)], [numpy_cache(jax.tree.map(
        lambda x: np.asarray(x, np.float32), cache))]
    _, toks, single_caches = single
    for i in range(S.NEW - 1):
        jc = R.nest({k: jnp.asarray(v) for k, v in single_caches[i].items()})
        out, _ = decode(case["jp"], jnp.asarray(toks[:, i]),
                        jnp.int32(prompt + i), jc)
        logits.append(np.asarray(out))
    return logits, caches


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """{case: inputs} of training and serving, {case: (reference run,
    single-device run)} of each, the ranks' outputs."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp_ssm")
    train = {n: make_train_case(n, seed) for seed, n in enumerate(TRAIN)}
    serve = {n: make_serve_case(n, seed + 10)
             for seed, n in enumerate(SERVE)}
    inputs = {}
    for n, c in train.items():
        inputs.update({f"train.{n}.w.{k}": v for k, v in c["w"].items()})
        for t in range(T.STEPS):
            inputs[f"train.{n}.tok.{t}"] = c["tokens"][t]
            inputs[f"train.{n}.draw.{t}"] = np.asarray(c["draws"][t])
    for n, c in serve.items():
        inputs.update({f"{n}.w.{k}": v for k, v in c["w"].items()})
        inputs[f"{n}.tokens"] = c["batch"]["tokens"]
    procs, logs = R.start_ranks(tmp, inputs, script=T.__file__)
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(1)
        runs = {}
        for n, c in train.items():
            runs[f"train.{n}"] = (run_train_reference(n, c)
                                  if n in TRAIN_REF else None,
                                  run_train_single(n, c))
        for n, c in serve.items():
            single = run_serve_single(n, c)
            runs[n] = (run_serve_reference(n, c, single), single)
    finally:
        torch.set_num_threads(threads)
        ranks = finish_ranks(tmp, procs, logs, t_end)
    return train, serve, runs, ranks


def rank_metric(ranks, key):
    vals = [rk[key] for rk in ranks]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0], err_msg=key)
    return vals[0]


def ranks_tree(rk, head):
    return {k[len(head):]: v for k, v in rk.items() if k.startswith(head)}


@pytest.mark.parametrize("name", TRAIN_REF)
def test_train_matches_reference(launch, name):
    """Losses, gates and n_good every step and the params after 3 steps
    against the reference's jitted single-device step; some gates open
    and some stay shut."""
    _, _, runs, ranks = launch
    steps, params, _ = runs[f"train.{name}"][0]
    opened = 0
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, f"train.{name}.{t}.loss"))
        assert abs(loss - float(want["loss"])) <= 1e-4 * abs(want["loss"])
        np.testing.assert_array_equal(
            rank_metric(ranks, f"train.{name}.{t}.gate"), want["gate"])
        assert float(rank_metric(ranks, f"train.{name}.{t}.n_good")) == \
            float(want["n_good"])
        opened += int(want["gate"].sum())
    assert 0 < opened < R.W * T.STEPS, opened
    got = ranks_tree(ranks[0], f"train.{name}.final.")
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("name", TRAIN)
def test_train_matches_single_device_port(launch, name):
    """The same against the port's single-device pytree step, to rel
    1e-5 / atol 1e-5."""
    _, _, runs, ranks = launch
    steps, params, _ = runs[f"train.{name}"][1]
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, f"train.{name}.{t}.loss"))
        assert abs(loss - float(want["loss"])) <= 1e-5 * abs(want["loss"])
        np.testing.assert_array_equal(
            rank_metric(ranks, f"train.{name}.{t}.gate"), want["gate"])
    got = ranks_tree(ranks[0], f"train.{name}.final.")
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", TRAIN)
def test_gradients_match_by_leaf(launch, name):
    """The first batch's gradient of every leaf, by name, gathered from
    the placed step (``loss_and_grad``: each gradient redistributed to its
    leaf's placement) within GRAD_TOL of its largest magnitude of the
    single-device port's and of the reference's (TRAIN_REF) — in_proj's
    B/C columns,
    conv_w's and conv_b's B/C channels, A_log, dt_bias and D included,
    the parts a missing sum over ``model`` would get wrong."""
    _, _, runs, ranks = launch
    cfg = train_cfg(name)
    got = ranks_tree(ranks[0], f"train.{name}.grads.")
    for who, run in zip(("reference", "single"), runs[f"train.{name}"]):
        if run is None:
            continue
        want = run[2]
        assert got.keys() == want.keys(), who
        for key in want:
            parts = T.grad_parts(cfg, key, got[key])
            for part, w in T.grad_parts(cfg, key, want[key]).items():
                scale = np.abs(w).max()
                err = np.abs(parts[part] - w).max()
                assert scale > 0 and err <= GRAD_TOL[who] * scale, (
                    who, part, err, scale)


def expected_specs(cfg):
    """{path key: (global shape, param_pspec spec)} of the W workers'
    params."""
    meta = TM.init_model(cfg, device="meta")
    return {R.path_key(p): ((R.W,) + tuple(x.shape), SH.param_pspec(
        p, x.expand((R.W,) + tuple(x.shape)), axis_sizes=SIZES))
        for p, x in SH.tree_paths(meta)}


def placement_of(spec) -> str:
    dims = [d for d, a in enumerate(spec) if a == "model"]
    return f"S{dims[0]}" if dims else "R"


@pytest.mark.parametrize("name", TRAIN)
def test_train_placements_and_placed_bytes(launch, name):
    """Every leaf and its gradient on every rank: Shard(d) where
    param_pspec names model at d, else Replicate; its local bytes
    sharding.placed_bytes.  A_log, dt_bias, D and the norms replicate."""
    _, _, _, ranks = launch
    specs = expected_specs(train_cfg(name))
    for key, (shape, spec) in specs.items():
        for rk in ranks:
            for what in ("leaf", "grad"):
                k = f"train.{name}.{what}.{key}"
                assert str(rk[f"{k}.placement"]) == placement_of(spec), k
                assert int(rk[f"{k}.bytes"]) == SH.placed_bytes(
                    shape, torch.float32, spec, SIZES), k
        if key.rsplit("/", 1)[-1] in ("A_log", "dt_bias", "D"):
            assert placement_of(spec) == "R", key


def heads_of(cfg):
    """(heads, heads a rank scans) of a case's 'S' layers at model 2."""
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    return H, H // R.MESH[1] if H % R.MESH[1] == 0 else H


@pytest.mark.parametrize("name", TRAIN)
def test_scans_run_on_each_ranks_heads(launch, name):
    """Every SSD scan (B5's wrapper) ran on the rank's own heads where
    they divide over model, on every head where they do not: the first
    batch's gradient and 3 steps, each layer's forward and remat's rerun
    in backward.  The RG-LRU blocks ran split along their width at batch
    2, over their batch at batch 16."""
    _, _, _, ranks = launch
    cfg = train_cfg(name)
    n_s = cfg.n_layers * cfg.pattern_cycle.count("S") // len(
        cfg.pattern_cycle)
    n_r = cfg.n_layers * cfg.pattern_cycle.count("R") // len(
        cfg.pattern_cycle)
    for rk in ranks:
        heads = rk[f"train.{name}.scan_heads"]
        assert len(heads) == 2 * (1 + T.STEPS) * n_s
        assert set(heads.tolist()) <= {heads_of(cfg)[1]}
        paths = rk[f"train.{name}.rg_paths"].tolist()
        assert len(paths) == 2 * (1 + T.STEPS) * n_r
        if n_r:
            want = "batch" if T.TRAIN[name][2] == 16 else "width"
            assert set(paths) == {want}, paths
    if n_s:
        H, per_rank = heads_of(cfg)
        assert per_rank == (H // 2 if name == "mamba2-370m" else H)


def assert_logits_near(got, want, vocab, tol, what):
    scale = np.abs(want[..., :vocab]).max()
    err = np.abs(got - want).max()
    assert err <= tol * scale, (what, err, scale)


@pytest.mark.parametrize("name", SERVE)
def test_serve_logits_match_reference_and_single_device(launch, name):
    """The prefill's last logits and each decode step's (from an f32 copy
    of the single-device serve's cache, with its token) within 1e-4 of
    the reference's largest and 1e-5 of the single-device port's."""
    _, _, runs, ranks = launch
    (ref, _), single = runs[name]
    vocab = serve_cfg(name).vocab
    for rk in ranks:
        rows = rk[f"{name}.rows"]
        got = rk[f"{name}.0.logits"]
        assert_logits_near(got, ref[0][rows], vocab, 1e-4, "ref")
        assert_logits_near(got, single[0][0][rows], vocab, 1e-5, "single")
        for t in range(1, S.NEW):
            got = rk[f"{name}.forced.{t}"]
            assert_logits_near(got, rk[f"{name}.forced_plain.{t}"][rows],
                               vocab, 1e-5, ("single", t))
            assert_logits_near(got, ref[t][rows], vocab, 1e-4, ("ref", t))


@pytest.mark.parametrize("name", SERVE)
def test_serve_tokens_equal(launch, name):
    """generate(mesh=)'s tokens on every rank equal the single-device
    port's, which equal the reference's argmax after the prefill and
    after each step of the same history."""
    _, _, runs, ranks = launch
    (ref, _), single = runs[name]
    toks = single[1]
    np.testing.assert_array_equal(np.stack([np.argmax(x, -1) for x in ref],
                                           1), toks)
    for rk in ranks:
        np.testing.assert_array_equal(rk[f"{name}.generate"], toks)


def assert_cache_near(got_of, want, rows, tol_f32, what):
    for key, v in want.items():
        got = got_of(key)
        v = v[:, rows] if key.startswith("scan/") else v[rows]
        assert got.shape == v.shape, (what, key)
        tol = BF16_STEP if key.rsplit("/", 1)[-1] in KV_LEAVES else tol_f32
        err, scale = np.abs(got - v).max(), np.abs(v).max()
        assert err <= tol * scale, (what, key, err, scale)


@pytest.mark.parametrize("name", SERVE)
def test_serve_caches_match(launch, name):
    """The prefill's cache within 1e-5 (f32 states) or a bf16 step (KV)
    of the single-device port's and 1e-4 or a bf16 step of the
    reference's; each free-running decode step's within 1e-5 or a bf16
    step of the single-device serve's."""
    _, _, runs, ranks = launch
    (_, ref_caches), single = runs[name]
    for rk in ranks:
        rows = rk[f"{name}.rows"]
        for t in range(S.NEW):
            def got(key, t=t):
                return rk[f"{name}.{t}.cache.{key}.value"]
            assert_cache_near(got, single[2][t], rows, 1e-5, ("single", t))
        assert_cache_near(lambda key: rk[f"{name}.0.cache.{key}.value"],
                          ref_caches[0], rows, 1e-4, "ref")


@pytest.mark.parametrize("name", SERVE)
def test_serve_cache_placements(launch, name):
    """Every cache leaf after the prefill and each decode step placed as
    cache_pspec says — ssm over heads (replicated for mamba2-odd's 3),
    conv and h over channels, KV heads or the sequence — with its dtype
    the single-device cache's, and sharding.placed_bytes a rank; the SSD
    scans of the prefill on each rank's heads."""
    _, _, runs, ranks = launch
    cfg = serve_cfg(name)
    rows, prompt = T.SERVE[name][2:]
    meta = TM.init_cache(cfg, rows, S.cache_len(cfg, prompt), device="meta")
    single = runs[name][1][2][0]
    seen = set()
    for path, x in SH.tree_paths(meta):
        key = R.path_key(path)
        spec = SH.cache_pspec(path, x, cfg, axis_sizes=SIZES)
        leaf = path[-1]
        dtype = torch.bfloat16 if leaf in KV_LEAVES else torch.float32
        seen.add((leaf, placement_of(spec)))
        for rk in ranks:
            for t in range(S.NEW):
                k = f"{name}.{t}.cache.{key}"
                assert str(rk[f"{k}.placement"]) == placement_of(spec), k
                assert int(rk[f"{k}.bytes"]) == SH.placed_bytes(
                    x.shape, dtype, spec, SIZES), k
        assert key in single
    split = heads_of(cfg)[1] < heads_of(cfg)[0]
    if "S" in cfg.pattern_cycle:
        assert ("ssm", "S2" if split else "R") in seen
        assert ("conv", "S3") in seen
        for rk in ranks:
            assert set(rk[f"{name}.scan_heads"].tolist()) == \
                {heads_of(cfg)[1]}
    else:
        assert {("h", "S2"), ("conv", "S3")} <= seen


@pytest.mark.parametrize("name", SERVE)
def test_decode_moves_no_cache(launch, name):
    """A decode step's collectives (each op and its bytes) are the same on
    the prefill's cache and on a placed cache of about twice its length,
    and none of them reads a cache leaf's storage: only the token's
    projection, conv output, norm sums and output sums move."""
    _, _, _, ranks = launch
    for rk in ranks:
        ops = list(rk[f"{name}.comms"])
        assert ops and ops == list(rk[f"{name}.comms_long"])
        assert int(rk[f"{name}.comms_cache"]) == 0
        assert int(rk[f"{name}.comms_long_cache"]) == 0


@pytest.mark.parametrize("arch", ("mamba2-370m", "recurrentgemma-9b"))
def test_ssm_archs_pass_both_scopes(arch):
    """'S' and 'R' layers pass check_scope and check_serve_scope at full
    size, under any name; so does the int8 wire on shards (ROADMAP
    15d)."""
    cfg = dataclasses.replace(get_arch(arch), name="some-lm")
    kw = dict(algo="asgd", inner="sgd",
              acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
    TP.check_scope(cfg, gcfg=tg.GossipConfig(), **kw)
    TP.check_serve_scope(cfg)
    TP.check_scope(cfg, gcfg=tg.GossipConfig(wire_format="int8"), **kw)
