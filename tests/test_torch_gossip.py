"""The port's ASGD core and packed-resident gossip engines
(repro_torch.core) against the reference's, at the reduced slice's size
(smollm-135m reduced, W=4, R=2624).

The exchange is bitwise; the pipelined engine at ``delay`` is bitwise the
packed engine at ``delay + 1`` (the reference's run_pipelined_parity
contract); the engines match the reference's over 4 rounds with the
(shift, partition) indices drawn by jax.random exactly as the reference
draws them — states within atol 1e-6, gates equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.core.packing import pack_w as jpack_w
from repro.models import model as JM
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.packing import pack_spec_w as tpack_spec_w
from repro_torch.core.packing import pack_w as tpack_w
from repro_torch.core.tree import flatten_sorted, tree_map

from _torch_threads import one_torch_thread  # noqa: F401

W = 4


def worker_tree(seed):
    cfg = get_arch("smollm-135m").reduced()
    params = JM.init_model(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda x: (np.asarray(x)[None]
                   + 0.01 * rng.standard_normal((W,) + x.shape))
        .astype(np.float32), params)


def packed_pair(cfg, seed=0):
    """(jax packed, jax pdw, jax spec, torch packed, torch pdw, torch spec)
    of the reduced tree and a gradient tree.  Workers 0, 2, 3 step toward
    the worker mean (their peers lie ahead: gates open), worker 1 away
    from it (gates closed)."""
    params, rng = worker_tree(seed), np.random.default_rng(seed + 100)
    side = np.array([0.5, -0.5, 0.5, 0.5], np.float32)

    def grad(x):
        toward = x - x.mean(axis=0, keepdims=True)
        side_b = side.reshape((W,) + (1,) * (x.ndim - 1))
        return (side_b * toward + 1e-3 * rng.standard_normal(x.shape)
                ).astype(np.float32)
    grads = jax.tree.map(grad, params)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    groups = cfg.partial_mode == "leaves"
    jspec = jpack_spec_w(jp, block_rows=64,
                         groups=jg.leaf_groups(jp, cfg.partial_blocks)
                         if groups else None, n_groups=cfg.partial_blocks)
    tspec = tpack_spec_w(tp, block_rows=64,
                         groups=tg.leaf_groups(tp, cfg.partial_blocks)
                         if groups else None, n_groups=cfg.partial_blocks)
    return (jpack_w(jp, jspec), jpack_w(jax.tree.map(jnp.asarray, grads),
                                        jspec), jspec,
            tpack_w(tp, tspec), tpack_w(tree_map(torch.from_numpy, grads),
                                        tspec), tspec)


def jax_draws(key, cfg):
    """The reference's per-round draws (core/gossip.py), as host ints."""
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


def tstate_stacked(state):
    """The port's tuple FIFO as the reference's stacked buffer layout."""
    if len(state.buf) == 1:
        return state.buf[0]
    return torch.stack(state.buf)


@pytest.mark.parametrize("wire", [None, "int8", "bf16"])
def test_exchange_packed_bitwise(wire):
    kw = {"wire_format": "dtype",
          "payload_dtype": jnp.bfloat16} if wire == "bf16" else \
        {"wire_format": wire}
    jcfg = jg.GossipConfig(shifts=(1, 2), partial_blocks=4, **kw)
    tcfg = tg.GossipConfig(shifts=(1, 2), partial_blocks=4,
                           **({"wire_format": "dtype",
                               "payload_dtype": torch.bfloat16}
                              if wire == "bf16" else {"wire_format": wire}))
    jpk, _, jspec, tpk, _, tspec = packed_pair(tcfg)
    ranges = jg.packed_row_ranges(jspec, jcfg)
    assert tg.packed_row_ranges(tspec, tcfg) == ranges
    for s in range(2):
        for b in range(4):
            j_out = jg.exchange_packed(jpk, ranges, s, b, jcfg,
                                       block_rows=64)
            t_out = tg.exchange_packed(tpk, ranges, s, b, tcfg,
                                       block_rows=64)
            if wire != "int8":
                j_out, t_out = (j_out,), (t_out,)
            for a, c in zip(j_out, t_out):
                np.testing.assert_array_equal(np.asarray(a), c.numpy())


def test_fifo_depth_and_staleness_guard():
    assert tg.fifo_depth(tg.GossipConfig(delay=0)) == 1
    assert tg.fifo_depth(tg.GossipConfig(delay=2)) == 2
    assert tg.fifo_depth(tg.GossipConfig(delay=1), pipelined=True) == 2
    for step in range(4):
        for delay, extra, every in ((1, 0, 1), (1, 1, 1), (3, 0, 1),
                                    (1, 1, 2)):
            jcfg = jg.GossipConfig(delay=delay, gossip_every=every)
            tcfg = tg.GossipConfig(delay=delay, gossip_every=every)
            assert tg.staleness_valid(step, tcfg, extra=extra) == float(
                jg.staleness_valid(jnp.int32(step), jcfg, extra=extra))
    assert tg.staleness_valid(0, tg.GossipConfig(delay=0)) is None
    packed = torch.zeros((W, 128, 512))
    st = tg.init_pipelined_gossip_state(
        packed, tg.GossipConfig(wire_format="int8"), block_rows=64)
    assert len(st.buf) == 2 and st.buf[0].dtype == torch.int8
    assert st.buf_scales[0].shape == (W, 2) and st.buf_idx == (0, 0)


def _run_port(engine, cfg, acfg, tspec, tpk, tpdw, draws):
    init = (tg.init_pipelined_gossip_state if engine == "pipelined"
            else tg.init_packed_gossip_state)
    state = init(tpk, cfg, block_rows=64)
    fn = (tg.asgd_gossip_apply_pipelined if engine == "pipelined"
          else tg.asgd_gossip_apply_packed)
    out = []
    for s, b in draws:
        tpk, state, m = fn(tpk, tpdw, state, s, b, cfg, acfg, tspec)
        out.append((tpk, m["gate"]))
    return out, state


@pytest.mark.parametrize("mode", ["leaves", "rows"])
@pytest.mark.parametrize("wire", [None, "int8"])
@pytest.mark.parametrize("delay", [0, 1])
def test_pipelined_is_packed_at_delay_plus_one(delay, wire, mode):
    cfg = tg.GossipConfig(shifts=(1, 2), partial_blocks=4,
                          partial_mode=mode, delay=delay, wire_format=wire)
    acfg = tasgd.ASGDConfig(eps=0.05)
    *_, tpk, tpdw, tspec = packed_pair(cfg, seed=1)
    gen = torch.Generator().manual_seed(0)
    draws = [tg.draw_gossip_indices(gen, cfg) for _ in range(5)]
    pipe, pstate = _run_port("pipelined", cfg, acfg, tspec, tpk, tpdw, draws)
    ref_cfg = dataclasses.replace(cfg, delay=delay + 1)
    ref, _ = _run_port("packed", ref_cfg, acfg, tspec, tpk, tpdw, draws)
    assert len(pstate.buf) == delay + 1
    opened = 0
    for (a, ga), (b, gb) in zip(pipe, ref):
        assert torch.equal(a, b) and torch.equal(ga, gb)
        opened += int(ga.sum())
    assert opened > 0


@pytest.mark.parametrize("engine,wire,mode,delay,elastic", [
    ("pipelined", "int8", "leaves", 1, False),     # the main path
    ("pipelined", None, "rows", 0, True),
    ("packed", None, "leaves", 1, False),
    ("packed", "int8", "rows", 2, True),
])
def test_engine_matches_reference(engine, wire, mode, delay, elastic):
    kw = dict(shifts=(1, 2), partial_blocks=4, partial_mode=mode,
              delay=delay, wire_format=wire)
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    ak = dict(eps=0.05, elastic=elastic, elastic_alpha=0.3)
    jacfg, tacfg = jasgd.ASGDConfig(**ak), tasgd.ASGDConfig(**ak)
    jpk, jpdw, jspec, tpk, tpdw, tspec = packed_pair(tcfg, seed=2)
    if engine == "pipelined":
        jstate = jg.init_pipelined_gossip_state(jpk, jcfg, block_rows=64)
        jfn = jg.asgd_gossip_apply_pipelined
    else:
        jstate = jg.init_packed_gossip_state(jpk, jcfg, block_rows=64)
        jfn = jg.asgd_gossip_apply_packed
    keys = [jax.random.key(i) for i in range(4)]
    ours, tstate = _run_port(engine, tcfg, tacfg, tspec, tpk, tpdw,
                             [jax_draws(k, jcfg) for k in keys])
    opened = 0
    for key, (t_pk, t_gate) in zip(keys, ours):
        jpk, jstate, m = jfn(jpk, jpdw, jstate, key, jcfg, jacfg, jspec)
        np.testing.assert_array_equal(np.asarray(m["gate"]), t_gate.numpy())
        np.testing.assert_allclose(t_pk.numpy(), np.asarray(jpk), rtol=0,
                                   atol=1e-6)
        opened += int(t_gate.sum())
    assert opened > 0
    # the FIFO holds payloads of states equal within f32 rounding: the
    # same within 1e-6 (float wire) or one int8 quantization step
    jbuf = np.asarray(jstate.buf).astype(np.float32)
    tbuf = tstate_stacked(tstate).numpy().astype(np.float32)
    np.testing.assert_allclose(tbuf, jbuf, rtol=0,
                               atol=1.0 if wire == "int8" else 1e-6)
    assert list(np.atleast_1d(np.asarray(jstate.buf_idx))) == \
        list(tstate.buf_idx)


def test_gossip_every_and_silent_match_reference():
    kw = dict(shifts=(1, 2), partial_blocks=4, delay=1, gossip_every=2)
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jpk, jpdw, jspec, tpk, tpdw, tspec = packed_pair(tcfg, seed=3)
    for silent in (False, True):
        jacfg = jasgd.ASGDConfig(eps=0.05, silent=silent)
        tacfg = tasgd.ASGDConfig(eps=0.05, silent=silent)
        js = jg.init_packed_gossip_state(jpk, jcfg)
        ts = tg.init_packed_gossip_state(tpk, tcfg)
        a, b = jpk, tpk
        for i in range(4):
            key = jax.random.key(i)
            s, blk = jax_draws(key, jcfg)
            a, js, m = jg.asgd_gossip_apply_packed(a, jpdw, js, key, jcfg,
                                                   jacfg, jspec)
            b, ts, tm = tg.asgd_gossip_apply_packed(b, tpdw, ts, s, blk,
                                                    tcfg, tacfg, tspec)
            np.testing.assert_array_equal(np.asarray(m["gate"]),
                                          tm["gate"].numpy())
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                       atol=1e-6)
        assert ts.step == 4


def test_gate_psum_axes_needs_a_mesh():
    """GossipConfig.gate_psum_axes sums the gate accumulator over mesh
    dims: the single-device engines hold no mesh, so they raise (the
    reference's psum is unbound outside shard_map), and () is no sum."""
    cfg = tg.GossipConfig(shifts=(1, 2), partial_blocks=4,
                          gate_psum_axes=("model",))
    acfg = tasgd.ASGDConfig(eps=0.05)
    *_, tpk, tpdw, tspec = packed_pair(cfg, seed=1)
    for fn in (tg.asgd_gossip_apply_packed, tg.asgd_gossip_apply_pipelined):
        init = (tg.init_pipelined_gossip_state
                if fn is tg.asgd_gossip_apply_pipelined
                else tg.init_packed_gossip_state)
        with pytest.raises(ValueError, match="no mesh was given"):
            fn(tpk, tpdw, init(tpk, cfg), 0, 1, cfg, acfg, tspec)
    assert tg.GossipConfig().gate_psum_axes == ()


def small_trees(seed, n_ext):
    rng = np.random.default_rng(seed)

    def tree():
        return {"w": rng.standard_normal((6, 5)).astype(np.float32),
                "b": {"x": rng.standard_normal((7,)).astype(np.float32)}}
    w, dw = tree(), tree()
    exts = [tree() for _ in range(n_ext)]
    # one external ahead of the local step, one empty (eq. 3)
    exts[0] = jax.tree.map(lambda a, d: a - 0.5 * d, w, dw)
    exts[1] = jax.tree.map(np.zeros_like, w)
    return w, dw, exts


@pytest.mark.parametrize("elastic", [False, True])
def test_asgd_update_matches_reference(elastic):
    w, dw, exts = small_trees(4, 4)
    ak = dict(eps=0.1, elastic=elastic, elastic_alpha=0.3)
    jw, jn = jasgd.asgd_update(
        jax.tree.map(jnp.asarray, w), jax.tree.map(jnp.asarray, dw),
        [jax.tree.map(jnp.asarray, e) for e in exts], jasgd.ASGDConfig(**ak))
    tw, tn = tasgd.asgd_update(
        tree_map(torch.from_numpy, w), tree_map(torch.from_numpy, dw),
        [tree_map(torch.from_numpy, e) for e in exts],
        tasgd.ASGDConfig(**ak))
    assert float(tn) == float(jn) >= 1
    for a, b in zip(jax.tree.leaves(jw), flatten_sorted(tw)[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-6)
    # use_fused: the same update through B3 (its plain version here);
    # sums in another order, so atol 1e-5
    fw, fn = tasgd.asgd_update(
        tree_map(torch.from_numpy, w), tree_map(torch.from_numpy, dw),
        [tree_map(torch.from_numpy, e) for e in exts],
        tasgd.ASGDConfig(use_fused=True, **ak))
    assert float(fn) == float(jn)
    for a, b in zip(jax.tree.leaves(jw), flatten_sorted(fw)[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-5)


def test_final_average_and_leaf_groups():
    params = worker_tree(5)
    tp = tree_map(torch.from_numpy, params)
    javg = jg.final_average(jax.tree.map(jnp.asarray, params))
    for a, b in zip(jax.tree.leaves(javg), flatten_sorted(
            tg.final_average(tp))[0]):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                   atol=1e-7)
    for p in (2, 3, 4):
        assert jax.tree.leaves(jg.leaf_groups(params, p)) == \
            flatten_sorted(tg.leaf_groups(tp, p))[0]
