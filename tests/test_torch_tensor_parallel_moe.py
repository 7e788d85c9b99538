"""Expert parallelism over ``model`` for the MoE configs (granite-moe-
1b-a400m, phi3.5-moe-42b-a6.6b): the port's pytree train step
(make_train_step(mesh=)) and its serve (make_prefill_step /
make_decode_step(mesh=), generate(mesh=)) across 4 gloo CPU processes,
against the reference's jitted steps and the port's single-device ones.

One launch (tests/_torch_tp_moe_ranks.py) runs 4 ranks as a (2, 2)
``("data", "model")`` mesh.  Cases (its TRAIN and SERVE): reduced
granite-moe and phi3.5-moe (4 experts top-2, 16 dispatch groups; 2
experts a rank), trained and served; granite-aux1, trained at
router_aux_weight 1.0; granite-e3 (3 experts, which ``model`` 2 does not
divide: the fallback), trained and served; granite-routing (32 experts
top-8 at narrow widths) served at batch 4, whose decode drops pairs;
granite-g3 (3 dispatch groups) served where a group straddles the data
slices.  Weights are the reference's initialisation carried over with
repro_torch.convert; for training each of W = 4 workers adds its own
seeded offset as large as the leaf's spread (tests/_torch_tp_ssm_ranks
.py worker_starts); tokens and prompts come from numpy seeds.  Training:
seq 32, partial_blocks 4, delay 1, 3 steps.  Serving: 8 greedy tokens.

While the ranks run, this process runs the reference (its jitted train
step with the plain blend, the jitted gradient of the workers' summed
losses, its jitted prefill and decode step) and the port's
single-device steps (one torch thread, tests/_torch_threads.py).

Tolerances (tests/test_torch_tensor_parallel_ssm.py's).  Training:
against the reference, losses within rel 1e-4, params within atol 1e-4,
gates and n_good exactly; against the single-device port, losses within
rel 1e-5, params within rtol and atol 1e-5, gates exactly.  Gradients,
leaf by leaf (the router's included), within 1e-4 of the leaf's largest
magnitude of the single-device port's and 2e-4 of the reference's: the
combine summed over ``model`` adds a token's k expert outputs in another
order (measured ≤ 2.6e-6 of the largest against the single-device port,
≤ 4.7e-6 against the reference); a gradient that misses
its sum over ``model``, or counts the aux loss twice, is off by O(1) at
router_aux_weight 1.0.  Serving: logits within 1e-4 of the largest of the
reference's and 1e-5 of the single-device port's (the decode steps each
from an f32 copy of the single-device cache); greedy tokens equal; every
placed MoE call's dropped (token, slot) pairs — its routing the same on
both ``model`` ranks — exactly the reference's on the whole batch's
groups, and, at each serving case's seed, not those of the naive
grouping of each data slice alone.
"""
import dataclasses
import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as JMoE
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM

import _torch_tp_moe_ranks as M
import _torch_tp_ranks as R
import _torch_tp_serve_ranks as S
import _torch_tp_ssm_ranks as T
import test_torch_tensor_parallel_ssm as SSM
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import finish_ranks

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
SIZES = dict(zip(("data", "model"), R.MESH))
TRAIN, SERVE = tuple(M.TRAIN), tuple(M.SERVE)
GRAD_TOL = {"single": 1e-4, "reference": 2e-4}
# each training case's seed: one at which the reference's 3 steps open
# some gates and leave some shut (granite-aux1 opens none at 2-9)
TRAIN_SEEDS = {"granite-moe": 0, "phi3.5-moe": 1, "granite-aux1": 10,
               "granite-e3": 3}


def train_cfg(name, registry=get_arch):
    arch, cuts, _ = M.TRAIN[name]
    return M.config(arch, cuts, registry)


def serve_cfg(name, registry=get_arch):
    arch, cuts, _, _ = M.SERVE[name]
    return M.config(arch, cuts, registry)


def make_train_case(name, seed):
    cfg = train_cfg(name)
    gcfg = tg.GossipConfig(**T.gossip_kw())
    keys = SSM.step_keys(SSM.leaf_facts(cfg, gcfg), gcfg)
    rng = np.random.default_rng(seed + 100)
    rows = M.TRAIN[name][2]
    tokens = [rng.integers(0, cfg.vocab, (R.W, rows, T.SEQ))
              .astype(np.int32) for _ in range(T.STEPS)]
    base = SSM.reference_leaves(train_cfg(name, SSM.jget_arch), seed)[1]
    jcfg = SSM.jg.GossipConfig(**T.gossip_kw())
    return {"w": T.worker_starts(base, seed), "tokens": tokens,
            "keys": keys,
            "draws": [SSM.jax_draws(jax.random.key(k), jcfg) for k in keys]}


def make_serve_case(name, seed):
    cfg = serve_cfg(name)
    jp, weights = SSM.reference_leaves(serve_cfg(name, SSM.jget_arch), seed)
    rows, prompt = M.SERVE[name][2:]
    rng = np.random.default_rng(seed + 300)
    return {"jp": jp, "w": weights, "batch": {"tokens": rng.integers(
        0, cfg.vocab, (rows, prompt)).astype(np.int32)}}


def run_serve_single(name, case):
    logits, toks, caches = S.serve_plain(
        serve_cfg(name), params_from_numpy(R.nest(case["w"])),
        {"tokens": torch.from_numpy(case["batch"]["tokens"])},
        M.SERVE[name][3])
    return ([x.numpy() for x in logits], toks.numpy(),
            [SSM.numpy_cache(c) for c in caches])


def run_serve_reference(name, case, single):
    """The reference's prefill, then each decode step from an f32 copy of
    the port's single-device cache and its token."""
    jcfg = serve_cfg(name, SSM.jget_arch)
    prompt = M.SERVE[name][3]
    length = S.cache_len(jcfg, prompt)
    prefill = jax.jit(lambda p, b: SSM.JM.prefill(jcfg, p, b,
                                                  cache_len=length))
    decode = jax.jit(SSM.jmake_decode_step(jcfg))
    last, _ = prefill(case["jp"], {"tokens": jnp.asarray(
        case["batch"]["tokens"])})
    logits = [np.asarray(last)]
    _, toks, single_caches = single
    for i in range(S.NEW - 1):
        jc = R.nest({k: jnp.asarray(v) for k, v in single_caches[i].items()})
        out, _ = decode(case["jp"], jnp.asarray(toks[:, i]),
                        jnp.int32(prompt + i), jc)
        logits.append(np.asarray(out))
    return logits


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """{case: inputs} of training and serving, {case: (reference run,
    single-device run)} of each, the ranks' outputs."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp_moe")
    train = {n: make_train_case(n, TRAIN_SEEDS[n]) for n in TRAIN}
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
    procs, logs = R.start_ranks(tmp, inputs, script=M.__file__)
    try:
        runs = {}
        for n, c in train.items():
            runs[f"train.{n}"] = (
                SSM.run_train_reference(n, c, train_cfg(n, SSM.jget_arch)),
                SSM.run_train_single(n, c, train_cfg(n)))
        for n, c in serve.items():
            single = run_serve_single(n, c)
            runs[n] = (run_serve_reference(n, c, single), single)
    finally:
        ranks = finish_ranks(tmp, procs, logs, t_end)
    return train, serve, runs, ranks


@pytest.mark.parametrize("name", TRAIN)
def test_train_matches_reference(launch, name):
    """Losses, gates and n_good every step and the params after 3 steps
    against the reference's jitted single-device step; some gates open
    and some stay shut."""
    _, _, runs, ranks = launch
    steps, params, _ = runs[f"train.{name}"][0]
    opened = 0
    for t, want in enumerate(steps):
        loss = float(SSM.rank_metric(ranks, f"train.{name}.{t}.loss"))
        assert abs(loss - float(want["loss"])) <= 1e-4 * abs(want["loss"])
        np.testing.assert_array_equal(
            SSM.rank_metric(ranks, f"train.{name}.{t}.gate"), want["gate"])
        assert float(SSM.rank_metric(ranks, f"train.{name}.{t}.n_good")) \
            == float(want["n_good"])
        opened += int(want["gate"].sum())
    assert 0 < opened < R.W * T.STEPS, opened
    got = SSM.ranks_tree(ranks[0], f"train.{name}.final.")
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
        loss = float(SSM.rank_metric(ranks, f"train.{name}.{t}.loss"))
        assert abs(loss - float(want["loss"])) <= 1e-5 * abs(want["loss"])
        np.testing.assert_array_equal(
            SSM.rank_metric(ranks, f"train.{name}.{t}.gate"), want["gate"])
    got = SSM.ranks_tree(ranks[0], f"train.{name}.final.")
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("name", TRAIN)
def test_gradients_match_by_leaf(launch, name):
    """The first batch's gradient of every leaf, by name, gathered from
    the placed step (``loss_and_grad``) within GRAD_TOL of its largest
    magnitude of the single-device port's and of the reference's — the
    router's (the combine's partial terms summed over ``model``, the aux
    loss's once), the experts' and the FFN input's upstream leaves
    included."""
    _, _, runs, ranks = launch
    got = SSM.ranks_tree(ranks[0], f"train.{name}.grads.")
    assert any(k.endswith("/moe/router") for k in got)
    for who, run in zip(("reference", "single"), runs[f"train.{name}"]):
        want = run[2]
        assert got.keys() == want.keys(), who
        for key, w in want.items():
            scale = np.abs(w).max()
            err = np.abs(got[key] - w).max()
            assert scale > 0 and err <= GRAD_TOL[who] * scale, (
                who, key, err, scale)


def expected_specs(cfg, train=True):
    """{path key: (global shape, param_pspec spec)} of the params (the W
    workers' for training, one model's for serving)."""
    meta = TM.init_model(cfg, device="meta")
    lead = (R.W,) if train else ()
    return {R.path_key(p): (lead + tuple(x.shape), SH.param_pspec(
        p, x.expand(lead + tuple(x.shape)), axis_sizes=SIZES, train=train))
        for p, x in SH.tree_paths(meta)}


def expert_split(cfg) -> bool:
    return cfg.n_experts % R.MESH[1] == 0


@pytest.mark.parametrize("name", TRAIN)
def test_train_placements_and_placed_bytes(launch, name):
    """Every leaf and its gradient on every rank placed as param_pspec
    says, with sharding.placed_bytes locally: the expert leaves Shard on
    their expert dim where E divides over model (else on d_ff or
    d_model), the router replicated."""
    _, _, _, ranks = launch
    cfg = train_cfg(name)
    specs = expected_specs(cfg)
    for key, (shape, spec) in specs.items():
        for rk in ranks:
            for what in ("leaf", "grad"):
                k = f"train.{name}.{what}.{key}"
                assert str(rk[f"{k}.placement"]) == SSM.placement_of(spec), k
                assert int(rk[f"{k}.bytes"]) == SH.placed_bytes(
                    shape, torch.float32, spec, SIZES), k
        leaf = key.rsplit("/", 1)[-1]
        if "/moe/" in key:
            # (W, n_full, E, ., .): the expert dim is 2
            want = ("R" if leaf == "router" else "S2" if expert_split(cfg)
                    else "S4")
            assert SSM.placement_of(spec) == want, key


@pytest.mark.parametrize("name", SERVE)
def test_serve_param_placements(launch, name):
    """Every serve param on every rank placed as param_pspec(train=False)
    says, with placed_bytes locally."""
    _, _, _, ranks = launch
    for key, (shape, spec) in expected_specs(serve_cfg(name),
                                             train=False).items():
        for rk in ranks:
            k = f"{name}.param.{key}"
            assert str(rk[f"{k}.placement"]) == SSM.placement_of(spec), k
            assert int(rk[f"{k}.bytes"]) == SH.placed_bytes(
                shape, torch.float32, spec, SIZES), k


def routes(rk, key):
    n = int(rk[f"{key}.calls"])
    return [{w: rk[f"{key}.{w}.{i}"] for w in ("inputs", "slots", "keeps")}
            for i in range(n)]


def global_capacity(cfg, shape, slices):
    """C of a placed MoE call on a rank's input of ``shape`` (W, B_l, S,
    D), its batch one of ``slices`` data slices: apply_moe's capacity of
    the global batch's groups, or apply_moe_decode's of its B tokens."""
    E, k = cfg.n_experts, cfg.experts_per_token
    B, S = shape[1] * slices, shape[2]
    if S == 1:
        return max(1, -(-B * k // E) * 2)
    Tg = B * S // groups_of(cfg, B * S)
    return max(1, int(cfg.capacity_factor * Tg * k / E))


@pytest.mark.parametrize("case", [f"train.{n}" for n in TRAIN] + list(SERVE))
def test_routing_identical_over_model(launch, case):
    """Every placed MoE call ran on both ``model`` ranks of a data
    coordinate with the same input and the same (slot, keep) tables,
    numbered by the global expert count and the global batch's capacity
    (a kept pair's slot < E*C, a dropped one's E*C), and counted in
    placed_calls."""
    _, _, _, ranks = launch
    train = case.startswith("train.")
    cfg = train_cfg(case[6:]) if train else serve_cfg(case)
    slices = 1 if train else R.MESH[0]
    for d in range(R.MESH[0]):
        a, b = (routes(ranks[d * R.MESH[1] + m], f"{case}.route")
                for m in range(R.MESH[1]))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            for w in ("inputs", "slots", "keeps"):
                np.testing.assert_array_equal(x[w], y[w], err_msg=w)
            EC = cfg.n_experts * global_capacity(cfg, x["inputs"].shape,
                                                 slices)
            np.testing.assert_array_equal(x["keeps"], x["slots"] < EC)
            assert x["slots"].max() <= EC
        for rk in ranks[d * R.MESH[1]:(d + 1) * R.MESH[1]]:
            assert int(rk[f"{case}.placed_calls"]) >= len(a)


def layer_router(case, layer):
    return {"router": jnp.asarray(
        case["w"]["scan/pos0/moe/router"][layer])}


def reference_keep(router, x, cfg, groups):
    """The reference's kept pairs (T*k,) of a layer input x (T, D) split
    into ``groups`` groups, with apply_moe's capacity."""
    E, k = cfg.n_experts, cfg.experts_per_token
    Tg = x.shape[0] // groups
    C = max(1, int(cfg.capacity_factor * Tg * k / E))
    return np.asarray(keep_of(router, x.reshape(groups, Tg, -1), E, k,
                              C)).reshape(-1)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def keep_of(router, xg, E, k, C):
    """The reference's kept pairs (G, Tg*k) of groups xg (G, Tg, D) at
    capacity C, from its own route and cumsum (its _dispatch_group's
    first lines)."""
    def one(xt):
        _, idx, _, _ = JMoE.route(router, xt, k)
        flat = idx.reshape(-1)
        pos = JMoE._blocked_cumsum(
            jax.nn.one_hot(flat, E, dtype=jnp.int32)) - 1
        return jnp.take_along_axis(pos, flat[:, None], axis=1)[:, 0] < C
    return jax.vmap(one)(xg)


def decode_keep(router, x, cfg):
    """The reference's kept pairs of one decode position's B tokens x
    (B, D), apply_moe_decode's capacity."""
    E, k = cfg.n_experts, cfg.experts_per_token
    C = max(1, -(-x.shape[0] * k // E) * 2)
    return np.asarray(keep_of(router, x[None], E, k, C)).reshape(-1)


def groups_of(cfg, T):
    g = cfg.moe_dispatch_groups
    return g if T % g == 0 else 1


@pytest.mark.parametrize("name", SERVE)
def test_serve_drops_the_reference_pairs(launch, name):
    """Every placed MoE call of the serve (the prefill, generate's decode
    steps, the forced and long-cache decode steps): the pairs the data
    slices kept, in the global token order, are the reference's on the
    whole batch's layer input (its groups and capacity), and at this
    case's seed some call's naive grouping — each data slice's tokens as
    a batch of their own — keeps another set.  granite-routing's decode
    drops pairs."""
    _, serve, _, ranks = launch
    cfg = serve_cfg(name)
    per_d = [routes(ranks[d * R.MESH[1]], f"{name}.route")
             for d in range(R.MESH[0])]
    naive_differs, decode_drops = False, False
    for i, calls in enumerate(zip(*per_d)):
        layer = i % cfg.n_layers
        router = layer_router(serve[name], layer)
        xs = [c["inputs"][0] for c in calls]          # (B_l, S, D) each
        x = np.concatenate(xs).reshape(-1, cfg.d_model)
        got = np.concatenate([c["keeps"].reshape(-1) for c in calls])
        if xs[0].shape[1] == 1:
            want = decode_keep(router, x, cfg)
            naive = np.concatenate([decode_keep(
                router, xl.reshape(-1, cfg.d_model), cfg) for xl in xs])
            decode_drops |= not want.all()
        else:
            want = reference_keep(router, x, cfg, groups_of(cfg, len(x)))
            naive = np.concatenate([reference_keep(
                router, xl.reshape(-1, cfg.d_model), cfg,
                groups_of(cfg, xl.shape[0] * xl.shape[1])) for xl in xs])
        np.testing.assert_array_equal(got, want, err_msg=f"call {i}")
        naive_differs |= not np.array_equal(naive, want)
    assert naive_differs, "the naive per-slice grouping keeps the same pairs"
    if name == "granite-routing":
        assert decode_drops


@pytest.mark.parametrize("name", SERVE)
def test_serve_logits_match_reference_and_single_device(launch, name):
    """The prefill's last logits and each decode step's (from an f32 copy
    of the single-device serve's cache, with its token) within 1e-4 of
    the reference's largest and 1e-5 of the single-device port's."""
    _, _, runs, ranks = launch
    ref, single = runs[name]
    vocab = serve_cfg(name).vocab
    for rk in ranks:
        rows = rk[f"{name}.rows"]
        got = rk[f"{name}.0.logits"]
        SSM.assert_logits_near(got, ref[0][rows], vocab, 1e-4, "ref")
        SSM.assert_logits_near(got, single[0][0][rows], vocab, 1e-5,
                               "single")
        for t in range(1, S.NEW):
            got = rk[f"{name}.forced.{t}"]
            SSM.assert_logits_near(got, rk[f"{name}.forced_plain.{t}"][rows],
                                   vocab, 1e-5, ("single", t))
            SSM.assert_logits_near(got, ref[t][rows], vocab, 1e-4,
                                   ("ref", t))


@pytest.mark.parametrize("name", SERVE)
def test_serve_tokens_equal(launch, name):
    """generate(mesh=)'s tokens on every rank equal the single-device
    port's, which equal the reference's argmax after the prefill and
    after each step of the same history."""
    _, _, runs, ranks = launch
    ref, single = runs[name]
    toks = single[1]
    np.testing.assert_array_equal(np.stack([np.argmax(x, -1) for x in ref],
                                           1), toks)
    for rk in ranks:
        np.testing.assert_array_equal(rk[f"{name}.generate"], toks)


MOE_ARCHS = ("granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b")
MOE = dict(n_experts=4, experts_per_token=2)
# MoE configs, alone and beside 'R' or 'S' layers, with each step maker
SCOPE_CASES = (
    [(a, {}, m) for a in MOE_ARCHS for m in ("train", "prefill", "decode")]
    + [(a, c, m) for a, c in (("recurrentgemma-9b", MOE),
                              ("mamba2-370m", MOE),
                              ("granite-moe-1b-a400m", {}),
                              ("qwen3-14b", dict(pattern_cycle=("G", "S"),
                                                 **MOE)),
                              ("qwen3-14b", MOE))
       for m in ("prefill", "decode")]
    + [("qwen3-14b", dict(pattern_cycle=("G", "S"), **MOE), "train"),
       ("qwen3-14b", MOE, "train")])


@pytest.mark.parametrize("arch,cuts,maker", SCOPE_CASES)
def test_moe_configs_pass_scope(arch, cuts, maker):
    """Configs with MoE FFNs, beside 'R' or 'S' layers too, pass
    check_scope (the training maker) or check_serve_scope (prefill and
    decode) and build their mesh steps' scope check without raising; so
    does the int8 wire on shards (ROADMAP 15d), and make_train_step builds
    the tensor-parallel step with it."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), **cuts)
    assert cfg.n_experts > 0
    if maker != "train":
        TP.check_serve_scope(cfg)
        return
    kw = dict(algo="asgd", inner="sgd",
              acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
    TP.check_scope(cfg, gcfg=tg.GossipConfig(), **kw)
    int8 = tg.GossipConfig(wire_format="int8")
    TP.check_scope(cfg, gcfg=int8, **kw)
    step = make_train_step(cfg, gcfg=int8, mesh=R.ModelMesh(), **kw)
    assert isinstance(step, TP.TensorParallelStep) and step.gcfg == int8


def test_moe_serve_over_data_needs_rows():
    """An MoE config's serve steps on a mesh of two data groups refuse to
    guess the whole batch, before any work: its dispatch groups are the
    global batch's (rows=), and rows= must be the rank's rows times the
    data groups, or the rank's own."""
    cfg = get_arch("granite-moe-1b-a400m").reduced()

    class Mesh:
        mesh_dim_names, shape = ("data", "model"), (2, 1)

        def __getitem__(self, name):
            return self
    prefill, decode = TP.make_serve_steps(cfg, Mesh())
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="rows="):
        prefill({}, {"tokens": tokens})
    with pytest.raises(ValueError, match="rows="):
        decode({}, tokens[:, 0], 4, {})
    with pytest.raises(ValueError, match="not a slice"):
        prefill({}, {"tokens": tokens}, rows=3)
