"""The port's tensor-parallel pytree step (launch/tensor_parallel.py,
make_train_step(mesh=)) across 4 gloo CPU processes, against the
reference's jitted single-device ``make_train_step`` and the port's own
single-device pytree step.

One launch (tests/_torch_tp_ranks.py) runs 4 ranks as a (2, 2)
``("data", "model")`` mesh, W = 4 (W_local = 2), batch 2, seq 32,
partial_blocks 4, delay 1, 3 steps: the first round is gated out by the
staleness guard, the next two blend.  Cases, from numpy seeds: reduced
smollm-135m (4 heads and 2 KV heads divide 2); reduced qwen2.5-14b cut to
3 heads and 1 KV head, so wq/wk/wv/wo take the d_model fallback that its
40/8 heads take at model 16, on the bf16 wire; reduced qwen3-14b
(qk-norm); reduced whisper-tiny cut to 3 heads (the fallback its 6 heads
take at model 16) and a vocab of 500 that pads to 512, with 32 stub
frames through its encoder, LayerNorm, the plain MLP with biases and
cross-attention; reduced paligemma-3b (its 4 heads split over `model`,
its 1 KV head falls back) with 8 stub patches ahead of the text;
reduced gemma3-1b cut to 3 heads and 1 KV head (its 4/1 at model 16
fall back) and to one ('L', 'G') cycle of 2 layers, with an attention
softcap of 50 and a logit softcap of 30, which the registered config does
not set, so both softcaps are reached, its 'L' window of 16 binding at
seq 32.  Every worker starts from the
same base weights plus its own seeded offsets as large as the leaf's
spread, which with eps 0.01 opens some gates on every case; norm scales
and biases (LayerNorm's and the MLP's too), qk-norm scales and QKV biases
are 0.5 x N(0, 1) (test_torch_qwen.py perturbs the QKV biases and
qk-norm scales so), so the replicated leaves carry real terms.  Each
step's draws are chosen so that steps 1 and 2 blend a group holding
replicated leaves (shift 1: one row of a rank's slice crosses ranks;
shift 2: both).  The seq_parallel hints of every config but whisper's
redistribute the residual stream.  Beside the cases, DTensor's rule for
``Partial + Replicate``, which a replicated bias or the residual meets on
the output of a contraction over a sharded dim, is shown on the ranks.

While the ranks run, this process runs the reference (its plain blend;
the fused one would run the Pallas kernels in interpret mode) and the
port's single-device step (B2r/B2a's plain versions, their gate sums
recorded).

Tolerances: against the reference, test_torch_train_pytree.py's (losses
within rel 1e-4, params within atol 1e-4, n_good and the gates exactly);
against the port's single-device step, losses within rel 1e-5, params
within rtol 1e-5 and atol 1e-5, gates exactly, the round's (W, 1, 3)
eq.-4 sums within 1e-5 of the sum of their terms' magnitudes (the sums
over `model` and the packs add in another order; the dot term cancels, so
its value alone is no scale for its rounding).
"""
import dataclasses
import subprocess
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
from repro.launch.steps import make_train_step as jmake_train_step
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.tree import tree_map
from repro_torch.kernels.gossip_blend import ops as tops
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step
from repro_torch.models import model as TM

import _torch_tp_ranks as R

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
SIZES = dict(zip(("data", "model"), R.MESH))
W_LOCAL = R.W // R.MESH[0]
def jax_draws(key, gcfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(gcfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, gcfg.partial_blocks)))


def leaf_facts(cfg, gcfg):
    """[(path key, global shape, spec, group id)] in sorted-key order."""
    meta = tree_map(lambda x: x.expand((R.W,) + tuple(x.shape)),
                    TM.init_model(cfg, device="meta"))
    groups = [g for _, g in SH.tree_paths(tg.leaf_groups(
        meta, gcfg.partial_blocks))]
    return [(R.path_key(p), tuple(x.shape),
             SH.param_pspec(p, x, axis_sizes=SIZES), g)
            for (p, x), g in zip(SH.tree_paths(meta), groups)]


def step_keys(facts, gcfg):
    """A reference key per step: steps 0 and 1 draw shifts 1 and 2 and a
    group holding replicated leaves (blended on steps 1 and 2)."""
    repl = {g for _, _, spec, g in facts if "model" not in spec}
    want = [lambda si, bi: si == 0 and bi in repl,
            lambda si, bi: si == 1 and bi in repl,
            lambda si, bi: True]
    keys, k = [], 0
    for ok in want:
        while not ok(*jax_draws(jax.random.key(k), gcfg)):
            k += 1
        keys.append(k)
        k += 1
    return keys


def make_case(arch, seed):
    cfg = R.config(arch, get_arch)
    gcfg = tg.GossipConfig(**R.gossip_kw(arch, torch.bfloat16))
    facts = leaf_facts(cfg, gcfg)
    keys = step_keys(facts, gcfg)
    rng = np.random.default_rng(seed + 100)
    tokens = [rng.integers(0, cfg.vocab, (R.W, R.BATCH, R.SEQ))
              .astype(np.int32) for _ in range(R.STEPS)]
    # the frontend's stub input, lm_batch_iterator's 0.1 x N(0, 1)
    stub = [0.1 * rng.standard_normal((R.W, R.BATCH, stub_len(cfg),
                                       cfg.d_model)).astype(np.float32)
            for _ in range(R.STEPS)] if cfg.frontend else None
    jcfg = jg.GossipConfig(**R.gossip_kw(arch, jnp.bfloat16))
    return {"w": R.weights(cfg, seed), "tokens": tokens, "stub": stub,
            "keys": keys,
            "draws": [jax_draws(jax.random.key(k), jcfg) for k in keys],
            "facts": facts}


def stub_len(cfg):
    """The positions of a frontend's stub input: frames or patches."""
    return cfg.encoder_seq if cfg.frontend == "audio" else cfg.prefix_len


def batches(arch, case):
    """Each step's global batch (numpy): the tokens, and the frontend's
    frames or patches."""
    out = []
    for t, tok in enumerate(case["tokens"]):
        b = {"tokens": tok}
        if case["stub"] is not None:
            b[R.STUB[R.config(arch, get_arch).frontend]] = case["stub"][t]
        out.append(b)
    return out


def run_reference(arch, case):
    cfg = R.config(arch, jget_arch)
    gcfg = jg.GossipConfig(**R.gossip_kw(arch, jnp.bfloat16))
    acfg = jasgd.ASGDConfig(eps=R.EPS)
    jp = jax.tree.map(jnp.asarray, R.nest(case["w"]))
    state, opt = jg.init_gossip_state(jp, gcfg), jinit_inner(jp, "sgd")
    step = jax.jit(jmake_train_step(cfg, algo="asgd", gcfg=gcfg, acfg=acfg,
                                    inner="sgd"))
    out = []
    for b, k in zip(batches(arch, case), case["keys"]):
        jp, state, opt, m = step(jp, state, opt,
                                 {n: jnp.asarray(v) for n, v in b.items()},
                                 jax.random.key(k))
        out.append({n: np.asarray(m[n]) for n in ("loss", "gate", "n_good")})
    return out, {R.path_key(p): np.asarray(x) for p, x in
                 SH.tree_paths(jax.tree.map(np.asarray, jp))}


def magnitudes(w3, d3, e4, mask):
    """(W, 1, 3) f64: each eq.-4 sum's terms' magnitudes summed —
    sum |dw (w - ext)|, ||ext||^2, ||dw||^2 under the mask — the scale of
    a sum's rounding in any order (the dot term cancels)."""
    w, d, e = (x.double().numpy() for x in (w3, d3, e4[:, 0]))
    m = 1.0 if mask is None else mask.double().numpy()
    return np.stack([(np.abs(d * (w - e)) * m).sum((1, 2)),
                     (e * e * m).sum((1, 2)),
                     (d * d * m).sum((1, 2))], axis=-1)[:, None]


def run_single(arch, case):
    """The port's single-device pytree step (use_fused: B2r/B2a's plain
    versions here), each round's gate sums recorded."""
    cfg = R.config(arch, get_arch)
    gcfg = tg.GossipConfig(**R.gossip_kw(arch, torch.bfloat16))
    step = make_train_step(cfg, gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
    params = params_from_numpy(R.nest(case["w"]))
    state = tg.init_gossip_state(params, gcfg)
    sums, out = [], []
    reduce_w = tops.gossip_reduce_w

    def recorded(w3, d3, e4, mask):
        sums.append((reduce_w(w3, d3, e4, mask), magnitudes(w3, d3, e4,
                                                            mask)))
        return sums[-1][0]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tops, "gossip_reduce_w", recorded)
        for b, (si, bi) in zip(batches(arch, case), case["draws"]):
            params, state, _, m = step(
                params, state, 0, {n: torch.from_numpy(v)
                                   for n, v in b.items()}, si, bi)
            out.append({n: m[n].numpy() for n in ("loss", "gate", "n_good")}
                       | {"terms": sums[-1][0].numpy(), "mag": sums[-1][1]})
    return out, {R.path_key(p): x.numpy() for p, x in
                 SH.tree_paths(params)}


def finish_ranks(tmp, procs, logs, t_end):
    try:
        for p in procs:
            p.wait(timeout=max(1.0, t_end - time.monotonic()))
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        # the rank that failed first, not one its crash took down
        texts = [(tmp / f"rank{r}.log").read_text() for r in bad]
        text = next((t for t in texts if "closed by peer" not in t),
                    texts[0])[-3000:]
        pytest.fail(f"ranks {bad} failed or passed the {TIMEOUT_S} s limit "
                    f"(codes {[procs[r].returncode for r in bad]}):\n{text}")
    return [dict(np.load(tmp / f"rank{r}.npz")) for r in range(R.WORLD)]


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """{arch: case}, {arch: reference run}, {arch: single-device run}, the
    ranks' outputs."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp")
    cases = {a: make_case(a, seed) for seed, a in enumerate(R.ARCHS)}
    inputs = {}
    for a, c in cases.items():
        inputs.update({f"{a}.w.{k}": v for k, v in c["w"].items()})
        for t in range(R.STEPS):
            inputs[f"{a}.tok.{t}"] = c["tokens"][t]
            if c["stub"] is not None:
                inputs[f"{a}.stub.{t}"] = c["stub"][t]
            inputs[f"{a}.draw.{t}"] = np.asarray(c["draws"][t])
    procs, logs = R.start_ranks(tmp, inputs)
    threads = torch.get_num_threads()
    try:
        ref = {a: run_reference(a, c) for a, c in cases.items()}
        # one torch thread beside the four ranks (test_torch_qwen.py's
        # reason: small ops on a busy host)
        torch.set_num_threads(1)
        single = {a: run_single(a, c) for a, c in cases.items()}
    finally:
        torch.set_num_threads(threads)
        ranks = finish_ranks(tmp, procs, logs, t_end)
    return cases, ref, single, ranks


def rank_metric(ranks, arch, t, name):
    """A metric every rank reports alike (each gathers the whole W)."""
    vals = [rk[f"{arch}.{t}.{name}"] for rk in ranks]
    for v in vals[1:]:
        np.testing.assert_array_equal(v, vals[0], err_msg=f"{arch} {name}")
    return vals[0]


def final_params(ranks, arch):
    head = f"{arch}.final."
    return {k[len(head):]: v for k, v in ranks[0].items()
            if k.startswith(head)}


@pytest.mark.parametrize("arch", R.ARCHS)
def test_matches_reference(launch, arch):
    """Losses, gates, n_good every step and the params after 3 steps
    against the reference's jitted single-device step; some gates open
    and some stay shut."""
    cases, ref, _, ranks = launch
    steps, params = ref[arch]
    opened = 0
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, arch, t, "loss"))
        assert abs(loss - float(want["loss"])) <= 1e-4 * abs(want["loss"])
        np.testing.assert_array_equal(rank_metric(ranks, arch, t, "gate"),
                                      want["gate"])
        assert float(rank_metric(ranks, arch, t, "n_good")) == float(
            want["n_good"])
        opened += int(want["gate"].sum())
    assert float(steps[0]["n_good"]) == 0.0
    assert 0 < opened < R.W * (R.STEPS - 1), opened
    got = final_params(ranks, arch)
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4, err_msg=k)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_matches_single_device_port(launch, arch):
    """The same against the port's own single-device pytree step, to
    rel 1e-5 / atol 1e-5."""
    _, _, single, ranks = launch
    steps, params = single[arch]
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, arch, t, "loss"))
        assert abs(loss - float(want["loss"])) <= 1e-5 * abs(want["loss"])
        np.testing.assert_array_equal(rank_metric(ranks, arch, t, "gate"),
                                      want["gate"])
    got = final_params(ranks, arch)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_placements_and_placed_bytes(launch, arch):
    """Every leaf on every rank: Shard(d) where param_pspec names model at
    d, else Replicate; its local bytes launch/sharding.py placed_bytes."""
    cases, _, _, ranks = launch
    kinds = set()
    for key, shape, spec, _ in cases[arch]["facts"]:
        dims = [d for d, a in enumerate(spec) if a == "model"]
        want = f"S{dims[0]}" if dims else "R"
        kinds.add(want[0])
        assert spec[0] == "data"
        for rk in ranks:
            assert str(rk[f"{arch}.leaf.{key}.placement"]) == want, key
            assert int(rk[f"{arch}.leaf.{key}.bytes"]) == SH.placed_bytes(
                shape, torch.float32, spec, SIZES), key
    assert kinds == {"S", "R"}
    specs = {k: s for k, _, s, _ in cases[arch]["facts"]}
    d_model = ("data", None, "model", None, None)    # the fallback's wq
    heads = ("data", None, None, "model", None)
    if arch in ("qwen2.5-14b", "gemma3-1b"):   # the fallback of 3/1 heads
        assert specs["scan/pos0/attn/wq"] == d_model
        assert specs["scan/pos0/attn/wo"] == ("data", None, None, None,
                                              "model")
    if arch == "qwen2.5-14b":
        assert "model" not in specs["scan/pos0/attn/bq"]
    if arch == "gemma3-1b":
        assert "model" not in specs["scan/pos1/attn/q_norm/scale"]
    if arch == "paligemma-3b":     # 4 heads split, 1 KV head falls back
        assert specs["scan/pos0/attn/wq"] == heads
        assert specs["scan/pos0/attn/wk"] == d_model
    if arch == "whisper-tiny":
        for mixer in ("encoder/scan/attn", "scan/pos0/attn",
                      "scan/pos0/cross"):
            assert specs[f"{mixer}/wq"] == d_model
        for pre in ("encoder/scan", "scan/pos0"):
            assert specs[f"{pre}/mlp/up_b"] == ("data", None, "model")
            assert "model" not in specs[f"{pre}/mlp/down_b"]
            assert "model" not in specs[f"{pre}/ln1/bias"]


@pytest.mark.parametrize("arch", R.ARCHS)
def test_gate_sums_count_replicated_leaves_once(launch, arch):
    """On the blended steps (1 and 2, each a group holding replicated
    leaves) each rank's (W_local, 1, 3) eq.-4 sums equal its workers' rows
    of the single-device round's within rtol 1e-5 of the sum of their
    terms' magnitudes (the value itself for the squared sums; the dot term
    cancels), and the replicated leaves' share is large enough that the
    planted fault (B2r's mask the same on every `model` rank, so each
    replicated leaf counts once per `model` rank) misses them."""
    _, _, single, ranks = launch
    steps = single[arch][0]
    for t, want in list(enumerate(steps))[1:]:
        for r, rk in enumerate(ranks):
            rows = rk[f"{arch}.workers"]
            tol = 1e-5 * want["mag"][rows]
            terms = rk[f"{arch}.{t}.terms"]
            assert (np.abs(terms - want["terms"][rows]) <= tol).all(), (
                arch, t, r, terms - want["terms"][rows], tol)
            doubled = rk[f"{arch}.{t}.doubled"]
            assert (np.abs(doubled - want["terms"][rows]) > tol).any(), (
                arch, t, r)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_wire_bytes_are_the_shards(launch, arch):
    """Each rank sends, a round, the rows of its W_local slice that cross
    ranks, each its shard of the group's leaves in the wire's dtype."""
    cases, _, _, ranks = launch
    itemsize = 2 if R.WIRE.get(arch) == "dtype" else 4
    n = R.MESH[0]
    for t, (si, bi) in enumerate(cases[arch]["draws"]):
        row = sum(SH.placed_bytes(shape, torch.float32, spec, SIZES)
                  // W_LOCAL // 4 * itemsize
                  for _, shape, spec, g in cases[arch]["facts"] if g == bi)
        q, r = divmod((1, 2)[si] % R.W, W_LOCAL)
        moved = ((W_LOCAL - r) * (q % n != 0) + r * ((q + 1) % n != 0)
                 if r else W_LOCAL * (q % n != 0))
        assert moved == (1, 2)[si]
        for rk in ranks:
            assert int(rk[f"{arch}.{t}.bytes"]) == moved * row, (arch, t)


@pytest.mark.parametrize("arch", R.ARCHS)
def test_hints_redistribute_and_live_raises(launch, arch):
    """seq_parallel's hints moved the residual stream on the mesh (none
    moved where the config has no seq_parallel: whisper's); live= on a
    state not initialized elastic raised ValueError on every rank, as the
    single-device step's does."""
    _, _, _, ranks = launch
    seq_parallel = R.config(arch, get_arch).seq_parallel
    for rk in ranks:
        assert (int(rk[f"{arch}.hints_moved"]) > 0) == seq_parallel
        assert int(rk[f"{arch}.live_raises"]) == 1


# the attention layers that run on each rank's own heads: smollm's 4/2
# heads, qwen3's 4/4 and paligemma's 4 heads (its 1 KV head read whole)
# split over 2; 3 heads do not, and take the d_model fallback
SPLIT_LAYERS = {"smollm-135m": 2, "qwen3-14b": 2, "paligemma-3b": 2}


@pytest.mark.parametrize("arch", R.ARCHS)
def test_attention_splits_heads_where_they_divide(launch, arch):
    """Every attention layer of every step ran on each rank's own heads,
    twice (the forward and remat's rerun in backward), where the query
    heads divide over `model`; none did under the d_model fallback."""
    _, _, _, ranks = launch
    for rk in ranks:
        assert int(rk[f"{arch}.head_splits"]) == (
            2 * R.STEPS * SPLIT_LAYERS.get(arch, 0)), arch


def test_partial_plus_replicated_counts_once(launch):
    """DTensor adds a replicated operand to a ``Partial`` value once: y's
    value is the parts' sum plus b (1 + 2 + 10 on the 2 model ranks;
    torch 2.13 keeps y ``Partial`` with b/2 folded into each rank's part),
    and b's gradient of y's sum is one per element, not one per model
    rank: what a replicated bias (down_b, a LayerNorm bias) or the
    residual added to a contraction over a sharded dim needs."""
    _, _, _, ranks = launch
    for rk in ranks:
        np.testing.assert_array_equal(rk["probe.y"], np.full(3, 13.0))
        np.testing.assert_array_equal(rk["probe.grad"], np.ones(3))


# options the step refused before it carried them (ROADMAP 15d, 15f),
# alone and beside the algos, the plain blend, the silent flag and the
# 'R' and 'S' archs it carried already
OUT_OF_SCOPE = {
    "int8 wire": dict(gcfg=dict(wire_format="int8")),
    "silent": dict(algo="silent", inner="momentum"),
    "sync": dict(algo="sync", inner="adam"),
    "momentum": dict(inner="momentum"),
    "rows mode": dict(gcfg=dict(partial_mode="rows")),
    "plain blend": dict(use_fused=False, gcfg=dict(gossip_every=2)),
    "silent flag": dict(silent=True, gcfg=dict(partial_mode="rows")),
    "gossip_every 2": dict(gcfg=dict(gossip_every=2)),
    "recurrentgemma-9b": dict(arch="recurrentgemma-9b",
                              gcfg=dict(wire_format="int8")),
    "mamba2-370m": dict(arch="mamba2-370m", inner="momentum"),
}


@pytest.mark.parametrize("option", sorted(OUT_OF_SCOPE))
def test_out_of_scope_options_raise(option):
    """Each option the tensor-parallel step once refused passes
    check_scope, and make_train_step builds the step with it, before the
    mesh is touched."""
    kw = dict(OUT_OF_SCOPE[option])
    cfg = dataclasses.replace(get_arch(kw.pop("arch", "smollm-135m"))
                              .reduced(), **kw.pop("cfg", {}))
    gcfg = tg.GossipConfig(**kw.pop("gcfg", {}))
    acfg = tasgd.ASGDConfig(eps=R.EPS, use_fused=kw.pop("use_fused", True),
                            silent=kw.pop("silent", False))
    kw = {"algo": "asgd", "inner": "sgd", **kw}
    TP.check_scope(cfg, gcfg=gcfg, acfg=acfg, **kw)
    step = make_train_step(cfg, gcfg=gcfg, acfg=acfg, mesh=R.ModelMesh(),
                           **kw)
    assert (step.algo, step.inner, step.acfg) == (kw["algo"], kw["inner"],
                                                  acfg)


def test_scope_is_decided_by_features():
    """A config of the carried features passes check_scope whatever its
    name."""
    cfg = dataclasses.replace(get_arch("qwen3-14b").reduced(),
                              name="some-dense-lm")
    TP.check_scope(cfg, algo="asgd", inner="sgd", gcfg=tg.GossipConfig(),
                   acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))


@pytest.mark.parametrize("arch", ("gemma3-1b", "paligemma-3b",
                                  "whisper-tiny"))
def test_frontend_and_gemma_features_pass_check_scope(arch):
    """'L' windows, softcaps, scaled embeddings, the vision prefix, the
    audio encoder with cross-attention, LayerNorm, the plain MLP and
    sinusoidal positions pass check_scope, under any name."""
    cfg = dataclasses.replace(get_arch(arch), name="some-lm",
                              attn_softcap=50.0, logit_softcap=30.0)
    TP.check_scope(cfg, algo="asgd", inner="sgd", gcfg=tg.GossipConfig(),
                   acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))


def test_packed_engines_refuse_a_mesh():
    cfg = get_arch("smollm-135m").reduced()
    with pytest.raises(ValueError, match="regions"):
        make_train_step(cfg, pack_spec=object(), mesh=object(),
                        acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
