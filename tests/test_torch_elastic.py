"""Elastic per-peer liveness in the port's gossip engines (pytree, packed,
pipelined) — the single-process cases of the reference's test_elastic.py,
and each engine against the reference under a churn schedule.

Contract cases (port alone): ``live=`` needs an elastic state; an elastic
init opens with its gates closed; ``live`` = ones on an elastic state is
bitwise the legacy run on every engine across wire format x delay; the
packed engine follows the pytree engine and the pipelined engine at
``delay`` follows the packed one at ``delay + 1`` under churn; the split
halves thread ``sent_live``; a restore at a new W keeps its gates closed
for the join window, then opens them.

Parity cases: the port and the reference (jitted, as its engines run)
from the same numpy inputs, the reference's ``jax.random`` draws replayed
into the port, the same churn schedule.  Gates equal — the inputs keep
every gate far from its threshold (workers step toward or away from the
worker mean) — and states within atol 1e-6 (elementwise blends of O(1)
values; the gate sums differ in order only).  A dead worker's rows stay
bitwise frozen in the port while it is dead.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gossip_cases import configs, draws, to_t, tree
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.core.packing import pack_w as jpack_w
from repro_torch.checkpoint import (load_checkpoint, load_checkpoint_packed,
                                    save_checkpoint, save_checkpoint_packed)
from repro_torch.core.asgd import ASGDConfig
from repro_torch.core.gossip import (GossipConfig, asgd_gossip_apply,
                                     asgd_gossip_apply_packed,
                                     asgd_gossip_apply_pipelined,
                                     consume_exchange_packed,
                                     init_gossip_state,
                                     init_packed_gossip_state,
                                     init_pipelined_gossip_state,
                                     initiate_exchange_packed, leaf_groups,
                                     roll_live)
from repro_torch.core.packing import pack_spec_w, pack_w, unpack_w
from repro_torch.core.tree import flatten_sorted, tree_map

W = 4


def make_params(w=W, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.standard_normal((w,) + s)
                                .astype(np.float32))
            for k, s in (("wq", (16, 8)), ("bias", (6,)), ("wo", (8, 4)))}


def sign_grads(params):
    return tree_map(lambda x: 0.05 * torch.sign(x), params)


def make_spec(params, p=2):
    return pack_spec_w(params, block_rows=2,
                       groups=leaf_groups(params, p), n_groups=p)


def wire_cfg(wf, **kw):
    return GossipConfig(wire_format=wf, payload_dtype=torch.bfloat16
                        if wf == "dtype" else None, **kw)


def churn_live(t, dead=1, t0=2, k=2, w=W):
    """Worker ``dead`` is down for rounds [t0, t0 + k)."""
    live = torch.ones(w)
    if t0 <= t < t0 + k:
        live[dead] = 0.0
    return live


def gen_draws(cfg, n, seed=0):
    from repro_torch.core.gossip import draw_gossip_indices
    g = torch.Generator().manual_seed(seed)
    return [draw_gossip_indices(g, cfg) for _ in range(n)]


# ---------------------------------------------------------------------------
# the elastic-state contract
# ---------------------------------------------------------------------------

def test_live_requires_an_elastic_state():
    params = make_params()
    gcfg = GossipConfig(shifts=(1,), partial_blocks=2)
    acfg = ASGDConfig(eps=0.05)
    ones = torch.ones(W)
    state = init_gossip_state(params, gcfg)
    assert state.buf_live is None
    with pytest.raises(ValueError, match="elastic=True"):
        asgd_gossip_apply(params, sign_grads(params), state, 0, 0, gcfg,
                          acfg, live=ones)
    spec = make_spec(params)
    packed = pack_w(params, spec)
    pdw = 0.05 * torch.sign(packed)
    st = init_packed_gossip_state(packed, gcfg)
    assert st.buf_live is None
    with pytest.raises(ValueError, match="elastic=True"):
        asgd_gossip_apply_packed(packed, pdw, st, 0, 0, gcfg, acfg, spec,
                                 live=ones)
    with pytest.raises(ValueError, match="elastic=True"):
        asgd_gossip_apply_pipelined(
            packed, pdw, init_pipelined_gossip_state(packed, gcfg), 0, 0,
            gcfg, acfg, spec, live=ones)
    with pytest.raises(ValueError, match="elastic=True"):
        consume_exchange_packed(
            packed, pdw, init_pipelined_gossip_state(packed, gcfg),
            *initiate_exchange_packed(packed, 0, 0, gcfg, spec), gcfg, acfg,
            spec, live=ones)


def test_elastic_init_opens_with_closed_gates():
    params = make_params()
    gcfg = GossipConfig(shifts=(1,), partial_blocks=2, delay=1)
    state = init_gossip_state(params, gcfg, elastic=True)
    assert torch.equal(state.buf_live, torch.zeros(W))
    packed = pack_w(params, make_spec(params))
    st = init_packed_gossip_state(packed, gcfg, elastic=True)
    assert len(st.buf_live) == 1 and torch.equal(st.buf_live[0],
                                                 torch.zeros(W))
    st = init_pipelined_gossip_state(
        packed, wire_cfg("int8", shifts=(1,), partial_blocks=2, delay=1),
        block_rows=2, elastic=True)
    assert len(st.buf_live) == 2
    assert all(torch.equal(x, torch.zeros(W)) for x in st.buf_live)


def test_roll_live_travels_with_the_payload():
    """Worker w's slot is real iff its sender (w - shift) and w are alive:
    the payload's roll, so a sign error shows under churn."""
    cfg = GossipConfig(shifts=(1, 2))
    live = torch.tensor([1.0, 0.0, 1.0, 1.0])
    assert roll_live(live, 0, cfg).tolist() == [1.0, 0.0, 0.0, 1.0]
    assert roll_live(live, 1, cfg).tolist() == [1.0, 0.0, 1.0, 0.0]
    payload = torch.arange(W, dtype=torch.float32)
    assert torch.roll(payload, cfg.shifts[0], dims=0).tolist()[2] == 1.0


# ---------------------------------------------------------------------------
# live = ones is bitwise the legacy run
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["pytree", "packed", "pipelined"])
@pytest.mark.parametrize("wf", [None, "dtype", "int8"])
@pytest.mark.parametrize("delay", [0, 1, 2])
def test_live_ones_is_bitwise_legacy(engine, wf, delay):
    params = make_params()
    grads = sign_grads(params)
    gcfg = wire_cfg(wf, shifts=(1, 2), partial_blocks=2, delay=delay)
    acfg = ASGDConfig(eps=0.05)
    ones = torch.ones(W)
    spec = make_spec(params)
    br = spec.block_rows if wf == "int8" else None
    if engine == "pytree":
        a = b = params
        sa, sb = (init_gossip_state(params, gcfg, elastic=e)
                  for e in (False, True))
        fn = functools.partial(asgd_gossip_apply, cfg=gcfg, acfg=acfg)
        d = grads
    else:
        init = (init_pipelined_gossip_state if engine == "pipelined"
                else init_packed_gossip_state)
        a = b = pack_w(params, spec)
        sa, sb = (init(a, gcfg, block_rows=br, elastic=e)
                  for e in (False, True))
        apply = (asgd_gossip_apply_pipelined if engine == "pipelined"
                 else asgd_gossip_apply_packed)
        fn = functools.partial(apply, cfg=gcfg, acfg=acfg, spec=spec)
        d = pack_w(grads, spec)
    for s, blk in gen_draws(gcfg, 5):
        a, sa, ma = fn(a, d, sa, s, blk)
        b, sb, mb = fn(b, d, sb, s, blk, live=ones)
        for x, y in zip(flatten_sorted(a)[0], flatten_sorted(b)[0]):
            assert torch.equal(x, y)
        assert torch.equal(ma["gate"], mb["gate"])
        bufs = ((sa.buf, sb.buf) if engine == "pytree"
                else (sa.buf[0], sb.buf[0]))
        for x, y in zip(*(flatten_sorted(t)[0] for t in bufs)):
            assert torch.equal(x, y)


def test_elastic_state_defaults_live_to_ones():
    params = make_params()
    grads = sign_grads(params)
    gcfg = GossipConfig(shifts=(1, 2), partial_blocks=2, delay=1)
    acfg = ASGDConfig(eps=0.05)
    sa = init_gossip_state(params, gcfg, elastic=True)
    sb = init_gossip_state(params, gcfg, elastic=True)
    a = b = params
    for s, blk in gen_draws(gcfg, 3):
        a, sa, _ = asgd_gossip_apply(a, grads, sa, s, blk, gcfg, acfg)
        b, sb, _ = asgd_gossip_apply(b, grads, sb, s, blk, gcfg, acfg,
                                     live=torch.ones(W))
        assert all(torch.equal(a[k], b[k]) for k in params)


# ---------------------------------------------------------------------------
# engines against each other under churn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("delay", [0, 1])
def test_packed_matches_pytree_under_churn(delay):
    params = make_params()
    grads = sign_grads(params)
    gcfg = GossipConfig(shifts=(1, 2), partial_blocks=2, delay=delay)
    acfg = ASGDConfig(eps=0.05, use_parzen=False)
    spec = make_spec(params)
    p_ref, s_ref = params, init_gossip_state(params, gcfg, elastic=True)
    packed = pack_w(params, spec)
    s_pk = init_packed_gossip_state(packed, gcfg, elastic=True)
    pdw = pack_w(grads, spec)
    for t, (s, blk) in enumerate(gen_draws(gcfg, 7)):
        live = churn_live(t)
        p_ref, s_ref, m_ref = asgd_gossip_apply(p_ref, grads, s_ref, s, blk,
                                                gcfg, acfg, live=live)
        packed, s_pk, m_pk = asgd_gossip_apply_packed(
            packed, pdw, s_pk, s, blk, gcfg, acfg, spec, live=live)
        assert torch.equal(m_pk["gate"], m_ref["gate"])
    got = unpack_w(packed, spec)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), p_ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("wf", [None, "int8"])
@pytest.mark.parametrize("delay", [0, 1])
def test_pipelined_matches_packed_delay_plus_1_under_churn(wf, delay):
    params = make_params()
    cfg = wire_cfg(wf, shifts=(1, 2), partial_blocks=2, delay=delay)
    ref_cfg = dataclasses.replace(cfg, delay=delay + 1)
    acfg = ASGDConfig(eps=0.05, use_parzen=False)
    spec = make_spec(params)
    br = spec.block_rows if wf == "int8" else None
    pk_p = pk_r = pack_w(params, spec)
    pdw = pack_w(sign_grads(params), spec)
    st_p = init_pipelined_gossip_state(pk_p, cfg, block_rows=br,
                                       elastic=True)
    st_r = init_packed_gossip_state(pk_r, ref_cfg, block_rows=br,
                                    elastic=True)
    opened = 0.0
    for t, (s, blk) in enumerate(gen_draws(cfg, 7)):
        live = churn_live(t, dead=2, t0=3)
        pk_p, st_p, m_p = asgd_gossip_apply_pipelined(
            pk_p, pdw, st_p, s, blk, cfg, acfg, spec, live=live)
        pk_r, st_r, m_r = asgd_gossip_apply_packed(
            pk_r, pdw, st_r, s, blk, ref_cfg, acfg, spec, live=live)
        assert torch.equal(m_p["gate"], m_r["gate"])
        assert torch.equal(pk_p, pk_r)
        opened += float(m_p["gate"].sum())
    assert opened > 0.0   # churn must not degenerate to silent SGD


def test_split_halves_thread_sent_live():
    params = make_params()
    cfg = GossipConfig(shifts=(1, 2), partial_blocks=2, delay=1)
    acfg = ASGDConfig(eps=0.05, use_parzen=False)
    spec = make_spec(params)
    pk_a = pk_b = pack_w(params, spec)
    pdw = pack_w(sign_grads(params), spec)
    st_a = init_pipelined_gossip_state(pk_a, cfg, elastic=True)
    st_b = init_pipelined_gossip_state(pk_b, cfg, elastic=True)
    for t, (s, blk) in enumerate(gen_draws(cfg, 6)):
        live = churn_live(t, dead=0)
        pk_a, st_a, m_a = asgd_gossip_apply_pipelined(
            pk_a, pdw, st_a, s, blk, cfg, acfg, spec, live=live)
        sent, ss, bi, sent_live = initiate_exchange_packed(
            pk_b, s, blk, cfg, spec, live=live)
        pk_b, st_b, m_b = consume_exchange_packed(
            pk_b, pdw, st_b, sent, ss, bi, cfg, acfg, spec,
            sent_live=sent_live, live=live)
        assert torch.equal(pk_a, pk_b) and torch.equal(m_a["gate"],
                                                       m_b["gate"])


def test_restore_at_new_w_gates_closed_then_open(tmp_path):
    """A packed file saved at W=4 restores at W=2 on the elastic path: the
    restored slot holds real stale rows but its liveness is 0 (the join
    window), so round 0 admits nothing; once a real exchange refills the
    slot, gates open."""
    p = 2
    params = make_params()
    gcfg = GossipConfig(shifts=(1,), partial_blocks=p, delay=1)
    acfg = ASGDConfig(eps=0.05, use_parzen=False)
    spec = make_spec(params, p)
    packed = pack_w(params, spec)
    pdw = pack_w(sign_grads(params), spec)
    st = init_packed_gossip_state(packed, gcfg)
    for s, blk in [(0, 0), (0, 1), (0, 0)]:
        packed, st, _ = asgd_gossip_apply_packed(packed, pdw, st, s, blk,
                                                 gcfg, acfg, spec)
    path = tmp_path / "w4.msgpack"
    save_checkpoint_packed(path, {"params": packed, "gossip": st, "opt": 0,
                                  "step": 3}, spec)
    params2 = make_params(w=2)
    spec2 = make_spec(params2, p)
    packed2 = pack_w(params2, spec2)
    like = {"params": torch.zeros_like(packed2),
            "gossip": init_packed_gossip_state(packed2, gcfg, elastic=True),
            "opt": 0, "step": 0}
    back = load_checkpoint_packed(path, like, spec2, elastic=True)
    assert back["step"] == 3
    assert torch.equal(back["gossip"].buf_live[0], torch.zeros(2))
    assert float(back["gossip"].buf[0].abs().max()) > 0.0
    pk, g = back["params"], back["gossip"]
    pdw2 = pack_w(sign_grads(unpack_w(pk, spec2)), spec2)
    gates = []
    for s, blk in [(0, 1), (0, 0), (0, 1)]:
        pk, g, m = asgd_gossip_apply_packed(pk, pdw2, g, s, blk, gcfg, acfg,
                                            spec2, live=torch.ones(2))
        gates.append(float(m["gate"].sum()))
    assert gates[0] == 0.0 and sum(gates[1:]) > 0.0


def test_unpacked_elastic_restore_migrates_and_trains(tmp_path):
    params = make_params()
    gcfg = GossipConfig(shifts=(1,), partial_blocks=2, delay=1)
    path = tmp_path / "w4.msgpack"
    save_checkpoint(path, {"params": params,
                           "gossip": init_gossip_state(params, gcfg),
                           "step": 5})
    params8 = make_params(w=8)
    like = {"params": params8,
            "gossip": init_gossip_state(params8, gcfg, elastic=True),
            "step": 0}
    back = load_checkpoint(path, like, resize_workers=True)
    for k in params:
        assert back["params"][k].shape[0] == 8
        assert torch.equal(back["params"][k][4:], back["params"][k][:4])
    assert torch.equal(back["gossip"].buf_live, torch.zeros(8))
    assert back["step"] == 5
    p, _, _ = asgd_gossip_apply(
        back["params"], sign_grads(back["params"]), back["gossip"], 1, 0,
        GossipConfig(shifts=(1, 2), partial_blocks=2, delay=1),
        ASGDConfig(eps=0.05, use_parzen=False), live=torch.ones(8))
    assert all(bool(torch.isfinite(x).all()) for x in p.values())


# ---------------------------------------------------------------------------
# each engine against the reference under churn
# ---------------------------------------------------------------------------

CHURN = [(1, 1, 3), (2, 1, 2)]   # (dead worker, first round, rounds down)


def churn_schedule(t):
    live = np.ones(W, np.float32)
    for dead, t0, k in CHURN:
        if t0 <= t < t0 + k:
            live[dead] = 0.0
    return live


def assert_dead_rows_frozen(before, after, live):
    for x, y in zip(flatten_sorted(before)[0], flatten_sorted(after)[0]):
        for w in np.flatnonzero(live == 0.0):
            assert torch.equal(x[w], y[w])


@pytest.mark.parametrize("mode,wire,fused", [
    ("leaves", "none", False), ("leaves", "int8", True),
    ("rows", "bf16", False), ("rows", "none", True)])
def test_pytree_engine_matches_reference_under_churn(mode, wire, fused):
    jcfg, tcfg, jacfg, tacfg = configs(mode, wire, 1, use_fused=fused)
    params = tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), to_t(params)
    js = jg.init_gossip_state(jp, jcfg, elastic=True)
    ts = init_gossip_state(tp, tcfg, elastic=True)
    jstep = jax.jit(functools.partial(jg.asgd_gossip_apply, cfg=jcfg,
                                      acfg=jacfg))
    opened = 0
    for t in range(6):
        grads, key, live = tree(100 + t, scale=0.1), jax.random.key(t), \
            churn_schedule(t)
        jp, js, jm = jstep(jp, jax.tree.map(jnp.asarray, grads), js, key,
                           live=jnp.asarray(live))
        before = tp
        tp, ts, tm = asgd_gossip_apply(tp, to_t(grads), ts, *draws(key, jcfg),
                                       tcfg, tacfg,
                                       live=torch.from_numpy(live))
        assert_dead_rows_frozen(before, tp, live)
        np.testing.assert_array_equal(tm["gate"].numpy(),
                                      np.asarray(jm["gate"]))
        np.testing.assert_array_equal(ts.buf_live.numpy(),
                                      np.asarray(js.buf_live))
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-6)
        opened += int(tm["gate"].sum())
        # restart from the reference's state (see _torch_gossip_cases)
        tp, ts.buf = to_t(jp), to_t(js.buf)
    assert opened > 0


def packed_inputs(seed=2):
    """(numpy packed, numpy pdw, spec args) of a 4-leaf tree: workers 0,
    2, 3 step toward the worker mean (their peers lie ahead: gates open),
    worker 1 away from it (gates closed)."""
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((W, 12, 64)),
              "b": {"c": rng.standard_normal((W, 40)),
                    "d": rng.standard_normal((W, 3, 9, 70))},
              "e": rng.standard_normal((W, 30, 33))}
    side = np.array([0.5, -0.5, 0.5, 0.5])

    def grad(x):
        toward = x - x.mean(axis=0, keepdims=True)
        return (side.reshape((W,) + (1,) * (x.ndim - 1)) * toward
                + 1e-3 * rng.standard_normal(x.shape))
    grads = jax.tree.map(grad, params)
    f32 = functools.partial(jax.tree.map, lambda x: x.astype(np.float32))
    return f32(params), f32(grads)


@pytest.mark.parametrize("engine,wire,delay", [
    ("pipelined", "int8", 1),      # the main path
    ("pipelined", None, 0),
    ("packed", None, 1),
    ("packed", "int8", 2)])
def test_packed_engines_match_reference_under_churn(engine, wire, delay):
    params, grads = packed_inputs()
    kw = dict(shifts=(1, 2), partial_blocks=4, delay=delay,
              wire_format=wire, fused_block_rows=8)
    jcfg, tcfg = jg.GossipConfig(**kw), GossipConfig(**kw)
    jacfg, tacfg = jasgd.ASGDConfig(eps=0.05), ASGDConfig(eps=0.05)
    jtree, ttree = jax.tree.map(jnp.asarray, params), to_t(params)
    jspec = jpack_spec_w(jtree, block_rows=8,
                         groups=jg.leaf_groups(jtree, 4), n_groups=4)
    tspec = pack_spec_w(ttree, block_rows=8, groups=leaf_groups(ttree, 4),
                        n_groups=4)
    jpk, jpdw = jpack_w(jtree, jspec), jpack_w(
        jax.tree.map(jnp.asarray, grads), jspec)
    tpk, tpdw = pack_w(ttree, tspec), pack_w(to_t(grads), tspec)
    br = 8 if wire == "int8" else None
    if engine == "pipelined":
        js = jg.init_pipelined_gossip_state(jpk, jcfg, block_rows=br,
                                            elastic=True)
        ts = init_pipelined_gossip_state(tpk, tcfg, block_rows=br,
                                         elastic=True)
        jfn, tfn = jg.asgd_gossip_apply_pipelined, asgd_gossip_apply_pipelined
    else:
        js = jg.init_packed_gossip_state(jpk, jcfg, block_rows=br,
                                         elastic=True)
        ts = init_packed_gossip_state(tpk, tcfg, block_rows=br,
                                      elastic=True)
        jfn, tfn = jg.asgd_gossip_apply_packed, asgd_gossip_apply_packed
    jstep = jax.jit(functools.partial(jfn, cfg=jcfg, acfg=jacfg, spec=jspec))
    opened = 0
    for t in range(7):
        key, live = jax.random.key(t), churn_schedule(t)
        jpk, js, jm = jstep(jpk, jpdw, js, key, live=jnp.asarray(live))
        before = tpk
        tpk, ts, tm = tfn(tpk, tpdw, ts, *draws(key, jcfg), tcfg, tacfg,
                          tspec, live=torch.from_numpy(live))
        assert_dead_rows_frozen(before, tpk, live)
        np.testing.assert_array_equal(tm["gate"].numpy(),
                                      np.asarray(jm["gate"]))
        np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=0,
                                   atol=1e-6)
        jlive = np.asarray(js.buf_live).reshape(len(ts.buf_live), W)
        np.testing.assert_array_equal(
            np.stack([x.numpy() for x in ts.buf_live]), jlive)
        opened += int(tm["gate"].sum())
        # restart the port from the reference's ensemble, so one int8
        # step of a last-bit difference cannot compound
        tpk = torch.from_numpy(np.array(jpk))
    assert opened > 0
