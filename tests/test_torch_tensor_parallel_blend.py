"""The tensor-parallel pytree step (launch/tensor_parallel.py,
make_train_step(mesh=)) under the step options the dry-run's step takes:
the plain blend (``ASGDConfig(use_fused=False)``, the reference's
default), algos 'sync' and 'silent', and ``ASGDConfig(silent=True)``,
across 4 gloo CPU processes, against the reference's jitted
single-device ``make_train_step`` and the port's own single-device
pytree step; and the options still out of scope.

One launch (tests/_torch_tp_blend_ranks.py) runs 4 ranks as a (2, 2)
``("data", "model")`` mesh, W = 4 (W_local = 2), reduced smollm-135m,
batch 2, seq 32, partial_blocks 4, delay 1, 3 steps, with
tests/test_torch_tensor_parallel.py's inputs: every worker the same base
weights plus its own seeded offset as large as the leaf's spread, norm
scales 0.5 x N(0, 1) (replicated leaves with real terms), draws from
``jax.random`` keys chosen so that steps 1 and 2 blend a group holding
replicated leaves (the first round is gated out by the staleness guard).

Tolerances, as tests/test_torch_tensor_parallel.py's: against the
reference, losses within rel 1e-4, params within atol 1e-4, gates and
n_good exactly (away from the threshold: the plain blend's gates open
and shut here with margins far above a sum's rounding; a gate closer
than that may flip with the summation order); against the port's
single-device step, losses within rel 1e-5, params within rtol and atol
1e-5, and the plain blend's (W_local, 3) eq.-4 sums within 1e-5 of the
sum of their terms' magnitudes, while the planted fault's (a replicated
leaf's terms counted on every ``model`` rank) miss them.
"""
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
from repro_torch.core.tree import flatten_sorted
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import make_train_step

import _torch_tp_blend_ranks as B
import _torch_tp_ranks as R
from test_torch_tensor_parallel import (batches, finish_ranks, make_case,
                                        rank_metric)

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
ARCH = B.ARCH
CASES = tuple(B.CASES)


def run_reference(case, inputs):
    algo, acfg_kw = B.CASES[case]
    cfg = R.config(ARCH, jget_arch)
    gcfg = jg.GossipConfig(**R.gossip_kw(ARCH, jnp.bfloat16))
    acfg = jasgd.ASGDConfig(eps=R.EPS, **acfg_kw)
    jp = jax.tree.map(jnp.asarray, R.nest(inputs["w"]))
    state, opt = jg.init_gossip_state(jp, gcfg), jinit_inner(jp, "sgd")
    step = jax.jit(jmake_train_step(cfg, algo=algo, gcfg=gcfg, acfg=acfg,
                                    inner="sgd"))
    out = []
    for b, k in zip(batches(ARCH, inputs), inputs["keys"]):
        jp, state, opt, m = step(jp, state, opt,
                                 {n: jnp.asarray(v) for n, v in b.items()},
                                 jax.random.key(k))
        out.append({n: np.asarray(v) for n, v in m.items()})
    return out, {R.path_key(p): np.asarray(x) for p, x in
                 SH.tree_paths(jax.tree.map(np.asarray, jp))}


def magnitudes(params, grads, ext, groups, block_idx):
    """(W, 3) f64: each eq.-4 sum's terms' magnitudes over the group's
    leaves — sum |dw (w - ext)|, ||dw||^2, ||ext||^2 — the scale of a
    sum's rounding in any order (the dot term cancels)."""
    out = 0.0
    for x, d, e, g in zip(*(flatten_sorted(t)[0]
                            for t in (params, grads, ext, groups))):
        if g != block_idx:
            continue
        x, d, e = (t.double().reshape(t.shape[0], -1) for t in (x, d, e))
        out = out + torch.stack([(d * (x - e)).abs().sum(1),
                                 (d * d).sum(1), (e * e).sum(1)], dim=-1)
    return out.numpy()


def run_single(case, inputs):
    """The port's single-device pytree step; under the plain blend each
    round's (W, 3) eq.-4 sums and their magnitudes recorded."""
    algo, acfg_kw = B.CASES[case]
    cfg = R.config(ARCH, get_arch)
    gcfg = tg.GossipConfig(**R.gossip_kw(ARCH, torch.bfloat16))
    step = make_train_step(cfg, algo=algo, gcfg=gcfg, acfg=tasgd.ASGDConfig(
        eps=R.EPS, use_fused=False, **acfg_kw))
    params = params_from_numpy(R.nest(inputs["w"]))
    state = tg.init_gossip_state(params, gcfg)
    sums, out = [], []
    reduce3 = tg._per_worker_reduce3

    def recorded(p, g, e, groups=None, block_idx=None):
        terms = reduce3(p, g, e, groups, block_idx)
        sums.append((torch.stack(terms, dim=-1).numpy(),
                     magnitudes(p, g, e, groups, block_idx)))
        return terms
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "_per_worker_reduce3", recorded)
        for t, (b, (si, bi)) in enumerate(zip(batches(ARCH, inputs),
                                              inputs["draws"])):
            params, state, _, m = step(
                params, state, 0, {n: torch.from_numpy(v)
                                   for n, v in b.items()}, si, bi)
            rec = {n: v.numpy() for n, v in m.items()}
            if sums:
                rec["terms"], rec["mag"] = sums[-1]
            out.append(rec)
    return out, {R.path_key(p): x.numpy() for p, x in
                 SH.tree_paths(params)}


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The inputs, {case: reference run}, {case: single-device run}, the
    ranks' outputs."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp_blend")
    inputs = make_case(ARCH, 0)
    files = {f"{ARCH}.w.{k}": v for k, v in inputs["w"].items()}
    for t in range(R.STEPS):
        files[f"{ARCH}.tok.{t}"] = inputs["tokens"][t]
        files[f"{ARCH}.draw.{t}"] = np.asarray(inputs["draws"][t])
    procs, logs = R.start_ranks(tmp, files, script=B.__file__)
    threads = torch.get_num_threads()
    try:
        ref = {c: run_reference(c, inputs) for c in CASES}
        torch.set_num_threads(1)
        single = {c: run_single(c, inputs) for c in CASES}
    finally:
        torch.set_num_threads(threads)
        ranks = finish_ranks(tmp, procs, logs, t_end)
    return inputs, ref, single, ranks


def final_params(ranks, case):
    head = f"{case}.final."
    return {k[len(head):]: v for k, v in ranks[0].items()
            if k.startswith(head)}


@pytest.mark.parametrize("case", CASES)
def test_matches_reference(launch, case):
    """Losses every step and the params after 3 steps against the
    reference's jitted step; the gates and n_good exactly where the algo
    reports them: the plain blend's open on some workers and stay shut on
    others, the silent flag's are all shut."""
    _, ref, _, ranks = launch
    steps, params = ref[case]
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, case, t, "loss"))
        assert abs(loss - float(want["loss"])) <= 1e-4 * abs(want["loss"])
        if "gate" in want:
            np.testing.assert_array_equal(
                rank_metric(ranks, case, t, "gate"), want["gate"])
            assert float(rank_metric(ranks, case, t, "n_good")) == float(
                want["n_good"])
        else:
            assert f"{case}.{t}.gate" not in ranks[0]
    opened = sum(int(s["gate"].sum()) for s in steps if "gate" in s)
    if case == "plain":
        assert 0 < opened < R.W * (R.STEPS - 1), opened
    if case == "silent-flag":
        assert opened == 0
    got = final_params(ranks, case)
    assert got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4,
                                   err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", CASES)
def test_matches_single_device_port(launch, case):
    """The same against the port's own single-device pytree step, to rel
    1e-5 / atol 1e-5."""
    _, _, single, ranks = launch
    steps, params = single[case]
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, case, t, "loss"))
        assert abs(loss - float(want["loss"])) <= 1e-5 * abs(want["loss"])
        if "gate" in want:
            np.testing.assert_array_equal(
                rank_metric(ranks, case, t, "gate"), want["gate"])
    got = final_params(ranks, case)
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5,
                                   err_msg=f"{case} {k}")


def test_plain_sums_count_replicated_leaves_once(launch):
    """Each plain-blend round's (W_local, 3) sums on each rank equal its
    workers' rows of the single-device round's within 1e-5 of their
    terms' magnitudes; on the blended steps (1 and 2, each a group
    holding replicated leaves) the planted fault misses them."""
    _, _, single, ranks = launch
    steps = single["plain"][0]
    for t, want in enumerate(steps):
        for r, rk in enumerate(ranks):
            rows = rk["workers"]
            tol = 1e-5 * want["mag"][rows]
            terms = rk[f"plain.{t}.terms"]
            assert (np.abs(terms - want["terms"][rows]) <= tol).all(), (
                t, r, terms - want["terms"][rows], tol)
            if t > 0:
                doubled = rk[f"plain.{t}.doubled"]
                assert (np.abs(doubled - want["terms"][rows]) > tol).any(), (
                    t, r)


def test_round_counter_and_live(launch):
    """The plain blend and the silent flag bump the round counter once a
    step; sync and silent leave the gossip state alone; live= holds on
    every rank under every option: under 'asgd' a step with live = ones
    on an elastic copy of the state is bitwise the step without live=,
    under sync and silent live= raises ValueError."""
    _, _, _, ranks = launch
    for rk in ranks:
        for case in CASES:
            want = R.STEPS if B.CASES[case][0] == "asgd" else 0
            assert int(rk[f"{case}.step"]) == want, case
            assert int(rk[f"{case}.live_ok"]) == 1, case


# options the mesh step refused before it carried them (ROADMAP 15d, 15f)
STILL_OUT = {
    "momentum": dict(inner="momentum"),
    "adam": dict(inner="adam"),
    "rows mode": dict(gcfg=dict(partial_mode="rows")),
    "gossip_every 2": dict(gcfg=dict(gossip_every=2)),
    "sync with momentum": dict(algo="sync", inner="momentum"),
    "int8 wire": dict(gcfg=dict(wire_format="int8")),
    "silent flag on int8": dict(silent=True, gcfg=dict(wire_format="int8")),
}


@pytest.mark.parametrize("option", sorted(STILL_OUT))
def test_options_still_out_of_scope_raise(option):
    """Each option the mesh step once refused now passes check_scope, and
    make_train_step builds the tensor-parallel step with it, before the
    mesh is touched."""
    kw = dict(STILL_OUT[option])
    cfg = get_arch(ARCH).reduced()
    gcfg = tg.GossipConfig(**kw.pop("gcfg", {}))
    acfg = tasgd.ASGDConfig(eps=R.EPS, use_fused=False,
                            silent=kw.pop("silent", False))
    kw = {"algo": "asgd", "inner": "sgd", **kw}
    TP.check_scope(cfg, gcfg=gcfg, acfg=acfg, **kw)
    step = make_train_step(cfg, gcfg=gcfg, acfg=acfg, mesh=R.ModelMesh(),
                           **kw)
    assert isinstance(step, TP.TensorParallelStep)
    assert (step.algo, step.inner, step.gcfg) == (kw["algo"], kw["inner"],
                                                  gcfg)


@pytest.mark.parametrize("case", CASES)
def test_carried_options_pass_check_scope(case):
    """The plain blend, the fused one, both algos and the silent flag pass
    check_scope on every arch the port carries."""
    algo, acfg_kw = B.CASES[case]
    for use_fused in (False, True):
        acfg = tasgd.ASGDConfig(eps=R.EPS, use_fused=use_fused, **acfg_kw)
        for arch in ("smollm-135m", "mamba2-370m", "granite-moe-1b-a400m"):
            TP.check_scope(get_arch(arch).reduced(), algo=algo,
                           inner="sgd", gcfg=tg.GossipConfig(), acfg=acfg)
