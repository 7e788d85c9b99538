"""Shared driver of the pytree-engine parity tests
(test_torch_gossip_leaves.py, test_torch_gossip_rows.py): the port's
``asgd_gossip_apply`` and the reference's, jitted as its engines run it,
side by side for a few rounds from the same numpy inputs, with the
reference's ``jax.random`` draws replayed into the port.  After each
round the port restarts from the reference's params and buffer, so every
round compares the two from identical inputs (last-bit differences in
the states would otherwise move an int8 wire value by a whole step).

The tree has leaves of 1 to 4 dims (a 1-D (W,) leaf, a dim-1 of 3, 5, 6
and 9 — so 'rows' mode clamps overlapping last blocks).  Each round
feeds fresh gradients.  Tolerances: gates and the staleness buffer
exactly (the wire round-trips are bitwise: bf16 casts, the int8
fake-quant as the reference computes it under jit); states within atol
1e-6 (elementwise blends of O(1) values; the gate sums differ in order
only, and the seeded inputs keep every gate far from its threshold).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg

W = 4
PAYLOAD = {"bf16": (jnp.bfloat16, torch.bfloat16)}


def tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    shapes = {"a": (W, 6, 40), "b": {"c": (W, 5), "d": (W, 3, 4, 70)},
              "e": (W, 9, 33), "f": (W,)}
    return jax.tree.map(
        lambda s: (scale * rng.standard_normal(s)).astype(np.float32),
        shapes, is_leaf=lambda x: isinstance(x, tuple))


def configs(mode, wire, delay, gossip_every=1, **acfg_kw):
    kw = dict(shifts=(1, 2), partial_blocks=4, partial_mode=mode,
              delay=delay, gossip_every=gossip_every, fused_block_rows=8)
    jkw, tkw = dict(kw), dict(kw)
    if wire == "int8":
        jkw["wire_format"] = tkw["wire_format"] = "int8"
    elif wire in PAYLOAD:
        jkw["payload_dtype"], tkw["payload_dtype"] = PAYLOAD[wire]
    return (jg.GossipConfig(**jkw), tg.GossipConfig(**tkw),
            jasgd.ASGDConfig(eps=0.05, **acfg_kw),
            tasgd.ASGDConfig(eps=0.05, **acfg_kw))


def draws(key, cfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


def to_t(x):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), x)


def assert_tree_equal(t_tree, j_tree, atol=0.0):
    tl, jl = jax.tree.leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert tuple(a.shape) == b.shape
        np.testing.assert_allclose(a.float().numpy(),
                                   np.asarray(b, np.float32), rtol=0,
                                   atol=atol)


def run_parity(mode, wire="none", delay=1, fused=False, rounds=3,
               gossip_every=1, **acfg_kw):
    """Drive both engines ``rounds`` rounds; returns the per-round port
    gates (for the callers' own checks)."""
    jcfg, tcfg, jacfg, tacfg = configs(mode, wire, delay, gossip_every,
                                       use_fused=fused, **acfg_kw)
    params = tree(0)
    jp, tp = jax.tree.map(jnp.asarray, params), to_t(params)
    jstate, tstate = jg.init_gossip_state(jp, jcfg), tg.init_gossip_state(
        tp, tcfg)
    jstep = jax.jit(functools.partial(jg.asgd_gossip_apply, cfg=jcfg,
                                      acfg=jacfg))
    gates = []
    for i in range(rounds):
        grads = tree(100 + i, scale=0.1)
        key = jax.random.key(i)
        jp, jstate, jm = jstep(jp, jax.tree.map(jnp.asarray, grads), jstate,
                               key)
        tp, tstate, tm = tg.asgd_gossip_apply(tp, to_t(grads), tstate,
                                              *draws(key, jcfg), tcfg, tacfg)
        np.testing.assert_array_equal(tm["gate"].numpy(),
                                      np.asarray(jm["gate"]))
        assert float(tm["n_good"]) == float(jm["n_good"])
        assert tstate.step == int(jstate.step)
        assert tstate.buf_idx == int(jstate.buf_idx)
        assert_tree_equal(tstate.buf, jstate.buf)
        assert_tree_equal(tp, jp, atol=1e-6)
        gates.append(tm["gate"])
        tp, tstate.buf = to_t(jp), to_t(jstate.buf)
    return gates
