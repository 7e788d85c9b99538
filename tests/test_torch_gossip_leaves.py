"""The port's pytree gossip engine in 'leaves' mode (static leaf groups)
against ``repro.core.gossip.asgd_gossip_apply``; the blend in plain torch
and through the worker-batched kernels (B2, their plain versions on the
CPU).  The driver and its tolerances: _torch_gossip_cases.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_gossip_cases import (W, configs, draws, run_parity, to_t,
                                 tree)
from repro.core import gossip as jg
from repro_torch.core import gossip as tg


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("wire,delay", [("none", 0), ("none", 1),
                                        ("bf16", 1), ("int8", 1)])
def test_leaves_round_matches_reference(wire, delay, fused):
    gates = run_parity("leaves", wire, delay, fused)
    assert 0 < float(sum(g.sum() for g in gates)) < 3 * W  # the gates mix
    if delay:       # the staleness guard closes round 0
        assert not gates[0].any()


@pytest.mark.parametrize("fused", [False, True])
def test_leaves_interval_gossip_matches_reference(fused):
    """gossip_every=2: odd rounds take the local step only."""
    gates = run_parity("leaves", "none", 1, fused, rounds=4, gossip_every=2)
    assert not gates[1].any() and not gates[3].any()


@pytest.mark.parametrize("fused", [False, True])
def test_leaves_elastic_and_ungated_match_reference(fused):
    run_parity("leaves", "none", 0, fused, rounds=2, elastic=True,
               elastic_alpha=0.3)
    run_parity("leaves", "none", 0, fused, rounds=2, use_parzen=False)


def test_fake_quant_wire_is_bitwise_the_jitted_reference():
    """The int8 wire of the pytree engine: one absmax scale per worker per
    leaf, zeros kept exactly zero; bitwise the reference under jit."""
    params = tree(3)
    params["b"]["c"][1] = 0.0            # an all-zero worker row
    _, tcfg, _, _ = configs("leaves", "int8", 1)
    jcfg, _, _, _ = configs("leaves", "int8", 1)
    ref = jax.jit(lambda t: jg.wire_roundtrip(t, jcfg))(
        jax.tree.map(jnp.asarray, params))
    out = tg.wire_roundtrip(to_t(params), tcfg)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(ref)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert not out["b"]["c"][1].any()


def test_exchange_and_gate_pieces_match_reference():
    """exchange_leaves (the group rolled, zeros elsewhere) and both forms
    of the gate (single_sweep and the four-traversal ablation)."""
    jcfg, tcfg, jacfg, tacfg = configs("leaves", "none", 1)
    params, grads, ext = tree(4), tree(5, 0.1), tree(6)
    jp = jax.tree.map(jnp.asarray, params)
    groups = tg.leaf_groups(to_t(params), 4)
    assert groups == jg.leaf_groups(jp, 4)
    for s, b in ((0, 1), (1, 3)):
        sent_j = jg.exchange_leaves(jp, groups, jnp.int32(s), jnp.int32(b),
                                    jcfg)
        sent_t = tg.exchange_leaves(to_t(params), groups, s, b, tcfg)
        for x, y in zip(jax.tree.leaves(sent_t), jax.tree.leaves(sent_j)):
            np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    for single in (True, False):
        for b in range(4):
            g_j = jg._gossip_gate(jp, jax.tree.map(jnp.asarray, grads),
                                  jax.tree.map(jnp.asarray, ext), jacfg,
                                  groups, jnp.int32(b), single_sweep=single)
            g_t = tg._gossip_gate(to_t(params), to_t(grads), to_t(ext),
                                  tacfg, groups, b, single_sweep=single)
            np.testing.assert_array_equal(g_t.numpy(), np.asarray(g_j))


def test_silent_sync_local_and_live():
    jcfg, tcfg, jacfg, tacfg = configs("leaves", "none", 1)
    params, grads = tree(7), tree(8, 0.1)
    jp, jgr = (jax.tree.map(jnp.asarray, x) for x in (params, grads))
    tp, tgr = to_t(params), to_t(grads)
    state = tg.init_gossip_state(tp, tcfg)
    silent = tg.ASGDConfig(eps=0.05, silent=True)
    out, st, m = tg.asgd_gossip_apply(tp, tgr, state, 0, 0, tcfg, silent)
    assert st.step == 1 and st.buf is state.buf and not m["gate"].any()
    for fn_t, fn_j in ((tg.local_sgd_apply, jg.local_sgd_apply),
                       (tg.sync_dp_apply, jg.sync_dp_apply)):
        ref = fn_j(jp, jgr, 0.05)
        got = fn_t(tp, tgr, 0.05)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-7)
    for a, b in zip(jax.tree.leaves(out),
                    jax.tree.leaves(tg.local_sgd_apply(tp, tgr, 0.05))):
        assert torch.equal(a, b)
    with pytest.raises(NotImplementedError, match="item 4"):
        tg.asgd_gossip_apply(tp, tgr, state, *draws(jax.random.key(0),
                                                    jcfg), tcfg, tacfg,
                             live=torch.ones(W))
