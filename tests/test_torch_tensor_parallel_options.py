"""The tensor-parallel pytree step (launch/tensor_parallel.py,
make_train_step(mesh=)) under the options of the reference's pytree step
that ROADMAP items 15d and 15f brought to the mesh, across 4 gloo CPU
processes, against the reference's jitted single-device
``make_train_step`` and the port's own single-device pytree step with the
same options: the int8 wire on shards (under the fused and the plain
blend), ``live=`` with a worker down on the second step, inner momentum
and Adam, sync with momentum, ``gossip_every`` 2, and 'rows' mode alone
and on the int8 wire.

One launch (tests/_torch_tp_options_ranks.py) runs 4 ranks as a (2, 2)
``("data", "model")`` mesh, W = 4 (W_local = 2), reduced smollm-135m
(its vocab-sharded embedding the ``Shard(1)`` leaf whose rows block a
rank holds part of), batch 2, seq 32, partial_blocks 4, delay 1, 3
steps, with tests/test_torch_tensor_parallel.py's inputs and
``jax.random`` draws (shift 1, then 2, on a group holding replicated
leaves).

Tolerances, the blend test's (tests/test_torch_tensor_parallel_blend.py):
against the reference, losses within rel 1e-4, params within atol 1e-4,
gates and n_good exactly; against the port's single-device step, losses
within rel 1e-5, params within rtol and atol 1e-5, gates and each step's
``buf_live`` exactly.  Adam normalizes each gradient element by its root
mean square, so a rounding of the gradient moves a small gradient's step
by up to lr and the runs part after it: its params are held on the first
step against the reference (beyond atol 1e-4 only at Adam ties, |g| <
1e-6, counted and printed), and on each step against the single-device
step from the ranks' own state and gradient, the gradient itself within
1e-5 of the single-device one's.  On identical inputs the int8
exchange on shards is bitwise the single-device ``exchange_leaves``, and
a rank's wire bytes are its shards' codes plus one f32 scale a worker
and sent leaf.
Where a whole step's int8 codes differ from the reference's, each
difference is a rounding tie (the two runs' values on either side of a
half-integer) and the ties are counted and printed.  Three planted
faults miss: each shard quantized by its own absmax (at the exchange),
``live`` rolled inside each rank's slice only, the rows block of a
``Shard(1)`` leaf taken at local indices (each whole step against the
single-device one).
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
from repro_torch.configs.registry import ARCHS, get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.launch import hlo_analysis as HA
from repro_torch.launch import sharding as SH
from repro_torch.launch import tensor_parallel as TP
from repro_torch.launch.steps import (init_inner_state, make_train_step,
                                      tree_loss_and_grad)

import _torch_tp_options_ranks as O
import _torch_tp_ranks as R
from _torch_threads import one_torch_thread  # noqa: F401
from test_torch_tensor_parallel import (batches, finish_ranks, make_case,
                                        rank_metric)

TIMEOUT_S = 150            # the whole launch; a hang fails, it never waits
ARCH = O.ARCH
CASES = tuple(O.CASES)
SIZES = dict(zip(("data", "model"), R.MESH))
W_LOCAL = R.W // R.MESH[0]
INT8 = ("int8", "int8-plain", "rows-int8")


def flat(tree):
    return {R.path_key(p): np.asarray(x) for p, x in SH.tree_paths(tree)}


def run_reference(case, inputs):
    """Each step's metrics (and ``buf_live``), the params at each step's
    start, and the final params of the reference's jitted step."""
    algo, inner, gkw, _, elastic = O.CASES[case]
    cfg = R.config(ARCH, jget_arch)
    gcfg = jg.GossipConfig(**{**R.gossip_kw(ARCH, jnp.bfloat16), **gkw})
    jp = jax.tree.map(jnp.asarray, R.nest(inputs["w"]))
    state = jg.init_gossip_state(jp, gcfg, elastic=elastic)
    opt = jinit_inner(jp, inner)
    step = jax.jit(jmake_train_step(cfg, algo=algo, inner=inner, gcfg=gcfg,
                                    acfg=jasgd.ASGDConfig(eps=R.EPS)))
    out, starts = [], []
    for t, (b, k) in enumerate(zip(batches(ARCH, inputs), inputs["keys"])):
        starts.append(flat(jax.tree.map(np.asarray, jp)))
        args = [jp, state, opt, {n: jnp.asarray(v) for n, v in b.items()},
                jax.random.key(k)]
        if elastic:
            args.append(jnp.asarray(O.live_at(t).numpy()))
        jp, state, opt, m = step(*args)
        rec = {n: np.asarray(v) for n, v in m.items()}
        if elastic:
            rec["buf_live"] = np.asarray(state.buf_live)
        out.append(rec)
    return out, flat(jax.tree.map(np.asarray, jp)), starts


def run_single(case, inputs):
    """The same of the port's single-device pytree step."""
    algo, inner, _, acfg_kw, elastic = O.CASES[case]
    cfg = R.config(ARCH, get_arch)
    gcfg = tg.GossipConfig(**O.gossip_kw(case))
    step = make_train_step(cfg, algo=algo, inner=inner, gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=R.EPS, **{
                               "use_fused": True, **acfg_kw}))
    params = params_from_numpy(R.nest(inputs["w"]))
    state = tg.init_gossip_state(params, gcfg, elastic=elastic)
    opt = init_inner_state(params, inner)
    out, starts = [], []
    for t, b in enumerate(batches(ARCH, inputs)):
        starts.append(flat(params))
        kw = {"live": O.live_at(t)} if elastic else {}
        params, state, opt, m = step(
            params, state, opt, {n: torch.from_numpy(v)
                                 for n, v in b.items()},
            *inputs["draws"][t], **kw)
        rec = {n: v.numpy() for n, v in m.items()}
        if elastic:
            rec["buf_live"] = state.buf_live.numpy()
        out.append(rec)
    return out, flat(params), starts


@pytest.fixture(scope="module")
def launch(tmp_path_factory):
    """The inputs, {case: reference run}, {case: single-device run}, the
    ranks' outputs."""
    t_end = time.monotonic() + TIMEOUT_S
    tmp = tmp_path_factory.mktemp("tp_options")
    inputs = make_case(ARCH, 0)
    files = {f"{ARCH}.w.{k}": v for k, v in inputs["w"].items()}
    for t in range(R.STEPS):
        files[f"{ARCH}.tok.{t}"] = inputs["tokens"][t]
        files[f"{ARCH}.draw.{t}"] = np.asarray(inputs["draws"][t])
    procs, logs = R.start_ranks(tmp, files, script=O.__file__)
    try:
        ref = {c: run_reference(c, inputs) for c in CASES}
        single = {c: run_single(c, inputs) for c in CASES}
    finally:
        ranks = finish_ranks(tmp, procs, logs, t_end)
    return inputs, ref, single, ranks


def final_params(ranks, tag):
    head = f"{tag}.final."
    return {k[len(head):]: v for k, v in ranks[0].items()
            if k.startswith(head)}


def misses(ranks, tag, single):
    """Where the ranks' run ``tag`` misses the single-device run at its
    gates: losses rel 1e-5, gates and buf_live equal, params rtol and
    atol 1e-5 (an empty list: it meets them all)."""
    steps, params, _ = single
    out = []
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, tag, t, "loss"))
        if abs(loss - float(want["loss"])) > 1e-5 * abs(want["loss"]):
            out.append(f"loss {t}")
        for k in ("gate", "buf_live"):
            if k in want and not np.array_equal(
                    rank_metric(ranks, tag, t, k), want[k]):
                out.append(f"{k} {t}")
    got = final_params(ranks, tag)
    out += [k for k, v in params.items()
            if not np.allclose(got[k], v, rtol=1e-5, atol=1e-5)]
    return out


def adam_ties(got, want, grads, atol, rtol=0.0):
    """(elements beyond the tolerance, those of them at an Adam tie,
    |g| < ADAM_TIE) of flat trees."""
    beyond = ties = 0
    for k, v in want.items():
        miss = ~np.isclose(got[k], v, rtol=rtol, atol=atol)
        beyond += int(miss.sum())
        ties += int((miss & (np.abs(grads[k]) < O.ADAM_TIE)).sum())
    return beyond, ties


@pytest.mark.parametrize("case", CASES)
def test_matches_reference(launch, case, capsys):
    """Losses every step and the params after 3 steps against the
    reference's jitted step with the same option; gates, n_good and the
    live case's buf_live exactly.  Adam: its params after the first step
    (from the same inputs) within atol 1e-4 but at Adam ties (|g| <
    ADAM_TIE, where the update normalizes a gradient near the float noise
    of its sums), which are counted and printed; each tie moves a weight
    by up to lr, so the runs' later params part and are not compared."""
    inputs, ref, _, ranks = launch
    steps, params, starts = ref[case]
    if O.CASES[case][1] == "adam":
        cfg = R.config(ARCH, get_arch)
        b = batches(ARCH, inputs)[0]
        grads = flat(tree_loss_and_grad(
            cfg, params_from_numpy(R.nest(inputs["w"])),
            {n: torch.from_numpy(v) for n, v in b.items()})[1])
        head = f"{case}.after0."
        got = {k[len(head):]: v for k, v in ranks[0].items()
               if k.startswith(head)}
        beyond, ties = adam_ties(got, starts[1], grads, atol=1e-4)
        with capsys.disabled():
            print(f"\n[adam ties] against the reference, first step: "
                  f"{ties} of {sum(v.size for v in got.values())} "
                  f"elements beyond atol 1e-4, each a tie")
        assert beyond == ties
        params = {}
    for t, want in enumerate(steps):
        loss = float(rank_metric(ranks, case, t, "loss"))
        assert abs(loss - float(want["loss"])) <= 1e-4 * abs(want["loss"])
        for k in ("gate", "n_good", "buf_live"):
            if k in want:
                np.testing.assert_array_equal(
                    rank_metric(ranks, case, t, k), want[k],
                    err_msg=f"{case} {k} {t}")
    if O.CASES[case][0] == "sync":
        assert f"{case}.0.gate" not in ranks[0]
    got = final_params(ranks, case)
    assert not params or got.keys() == params.keys()
    for k, v in params.items():
        np.testing.assert_allclose(got[k], v, rtol=0, atol=1e-4,
                                   err_msg=f"{case} {k}")


@pytest.mark.parametrize("case", CASES)
def test_matches_single_device_port(launch, case, capsys):
    """The same against the port's single-device pytree step, to rel 1e-5
    / atol 1e-5; the round counter as its (the off-rounds of gossip_every
    2 shut every gate); the dead worker's payload dropped on the wire.
    Adam: its losses and gates so; each step's params within rtol and
    atol 1e-5 of the single-device step from the ranks' own state before
    it (params, buffer, moments) on the ranks' own gradient, and that
    gradient within 1e-5 of the single-device one's, relative to each
    leaf's largest (tests/_torch_tp_options_ranks.py ``adam_step_check``:
    Adam divides a moment by its root mean square, so a gradient's
    rounding moves a small gradient's step by up to lr, and the two are
    held apart)."""
    _, _, single, ranks = launch
    if O.CASES[case][1] == "adam":
        assert misses(ranks, case, (single[case][0], {}, None)) == []
        rel = [float(ranks[0][f"{case}.{t}.grad_rel"])
               for t in range(R.STEPS)]
        with capsys.disabled():
            print(f"\n[adam] the ranks' gradient against the single-device "
                  f"one, over each leaf's largest, by step: {rel}")
        for t in range(R.STEPS):
            assert int(ranks[0][f"{case}.{t}.tf_beyond"]) == 0, t
            assert float(ranks[0][f"{case}.{t}.grad_rel"]) <= 1e-5, t
    else:
        assert misses(ranks, case, single[case]) == []
    want = R.STEPS if O.CASES[case][0] == "asgd" else 0
    for rk in ranks:
        assert int(rk[f"{case}.step"]) == want
    if case == "every2":
        assert not rank_metric(ranks, case, 1, "gate").any()
    if case == "live":
        live = rank_metric(ranks, case, O.DEAD_STEP, "buf_live")
        assert live[O.DEAD] == 0 and live.sum() < R.W - 1


def test_int8_exchange_is_the_single_device_one(launch):
    """On the initial weights, every (shift, partition) pair's int8
    exchange on shards is bitwise core.gossip.exchange_leaves of the whole
    leaves on every rank; each shard quantized by its own absmax misses
    it on every pair whose group holds a sharded leaf."""
    _, _, _, ranks = launch
    pairs = [(s, b) for s in range(2) for b in range(4)]
    for rk in ranks:
        for s, b in pairs:
            assert float(rk[f"xchg.{s}.{b}"]) == 0.0, (s, b)
            if int(rk[f"xchg.{s}.{b}.sharded"]):
                assert float(rk[f"xchg.{s}.{b}.fault"]) > 0.0, (s, b)
    assert any(int(ranks[0][f"xchg.0.{b}.sharded"]) for b in range(4))


@pytest.mark.parametrize("case", ("int8", "int8-plain"))
def test_int8_wire_bytes(launch, case):
    """A rank sends a round, for each worker row that crosses ranks, its
    shards of the group's leaves in int8 codes and one f32 scale a sent
    leaf."""
    inputs, _, _, ranks = launch
    for t, (si, bi) in enumerate(inputs["draws"]):
        group = [(shape, spec) for _, shape, spec, g in inputs["facts"]
                 if g == bi]
        row = sum(SH.placed_bytes(shape, torch.float32, spec, SIZES)
                  // 4 // W_LOCAL for shape, spec in group) + 4 * len(group)
        moved = HA.moved_rows((1, 2)[si], R.MESH[0], W_LOCAL)
        for rk in ranks:
            assert int(rk[f"{case}.{t}.bytes"]) == moved * row, (case, t)


def codes(tree, keys, block):
    """{key: (scaled values x / scale, codes)} of the leaves ``keys`` of a
    flat tree, each worker's absmax over the leaf, or over its rows block
    ``block`` (partition index, p) along dim 1."""
    out = {}
    for k in keys:
        x = torch.from_numpy(tree[k])
        if block is not None and x.ndim >= 2:
            x = tg.slice_rows(x, *block)
        x32 = x.float()
        absmax = x32.abs().reshape(x.shape[0], -1).amax(1)
        _, inv = tg.int8_scale(absmax.reshape((-1,) + (1,) * (x.ndim - 1)))
        out[k] = ((x32 * inv).numpy(), tg.int8_codes(x32, inv).numpy())
    return out


@pytest.mark.parametrize("case", INT8)
def test_int8_codes_differ_only_at_ties(launch, case, capsys):
    """Each step's sent codes from the reference's params and from the
    port's equal on the first step (identical inputs) and elsewhere
    differ only at rounding ties: by one, the two runs' scaled values on
    either side of the half-integer between the codes.  The ties are
    counted and printed."""
    inputs, ref, single, _ = launch
    rows = tg.GossipConfig(**O.gossip_kw(case)).partial_mode == "rows"
    groups = {k: g for k, _, _, g in inputs["facts"]}
    ties = []
    for t, (_, bi) in enumerate(inputs["draws"]):
        keys = sorted(groups) if rows else [k for k in groups
                                            if groups[k] == bi]
        block = (bi, 4) if rows else None
        a = codes(ref[case][2][t], keys, block)
        b = codes(single[case][2][t], keys, block)
        n = 0
        for k in keys:
            (sa, qa), (sb, qb) = a[k], b[k]
            diff = qa != qb
            if t == 0:
                assert not diff.any(), (case, k)
            lo = np.minimum(qa, qb)[diff] + 0.5
            assert (np.abs(qa - qb)[diff] == 1).all(), (case, t, k)
            assert (np.minimum(sa, sb)[diff] <= lo).all() and (
                lo <= np.maximum(sa, sb)[diff]).all(), (case, t, k)
            n += int(diff.sum())
        ties.append(n)
    with capsys.disabled():
        print(f"\n[int8 ties] {case}: codes differing from the reference's "
              f"at rounding ties, by step: {ties}")


@pytest.mark.parametrize("fault", sorted(O.FAULTS))
def test_planted_faults_miss(launch, fault):
    """``live`` rolled inside each rank's slice, and the rows block of the
    Shard(1) embedding taken at its local indices, each miss the
    single-device step that the correct run meets."""
    inputs, _, single, ranks = launch
    case = O.FAULTS[fault]
    assert misses(ranks, case, single[case]) == []
    assert misses(ranks, fault, single[case]) != []
    if fault == "rows-local-index":
        assert any(spec[1] == "model" for _, _, spec, _ in inputs["facts"])


OPTIONS = (dict(gcfg=dict(wire_format="int8")), dict(inner="momentum"),
           dict(inner="adam"), dict(gcfg=dict(partial_mode="rows")),
           dict(gcfg=dict(gossip_every=2)),
           dict(algo="sync", inner="momentum"),
           dict(gcfg=dict(partial_mode="rows", wire_format="int8",
                          gossip_every=3)))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_options_pass_check_scope(arch):
    """None of the options raises in check_scope, on any of the ten archs;
    the packed and pipelined engines and lr_schedule on a mesh still
    raise ValueError."""
    cfg = get_arch(arch)
    for kw in OPTIONS:
        kw = dict(kw)
        TP.check_scope(cfg, algo=kw.pop("algo", "asgd"),
                       inner=kw.pop("inner", "sgd"),
                       gcfg=tg.GossipConfig(**kw.pop("gcfg", {})),
                       acfg=tasgd.ASGDConfig(eps=R.EPS, use_fused=True))
    base = dict(algo="asgd", inner="sgd", gcfg=tg.GossipConfig(),
                acfg=tasgd.ASGDConfig(eps=R.EPS))
    for bad in (dict(pack_spec=object()), dict(pipelined=True),
                dict(lr_schedule=lambda s: R.EPS)):
        with pytest.raises(ValueError, match="regions"):
            TP.check_scope(cfg, **base, **bad)
