"""The pytree engine's train step — smollm-135m reduced (2 layers,
d_model 256), W=4 workers as a tree of (W, ...) leaves — through the port
against the reference's jitted ``make_train_step`` (no packed_resident),
on the same weights, batches and gossip draws, for algo asgd (the blend
in plain torch and through B2), silent and sync; plus the CLI on the CPU.

Tolerances: losses within rel 1e-4 and the params within atol 1e-4 over 2
steps (f32 forward/backward sums in different orders compound); the
admitted-message count n_good and the gates exactly.  With delay 1 the
first round is gated out by the staleness guard and the second blends the
buffered block, so 2 steps show the whole engine.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.data.synthetic import lm_batch_iterator
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import init_inner_state, make_train_step

from _torch_threads import one_torch_thread  # noqa: F401

W, BATCH, SEQ, STEPS = 4, 2, 32, 2


def jax_draws(key, cfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


@functools.lru_cache
def reference_init():
    """The reference's reduced smollm-135m params, made once for the four
    cases (jax arrays are immutable)."""
    return JM.init_model(jget_arch("smollm-135m").reduced(),
                         jax.random.key(0))


@pytest.mark.parametrize("algo,inner,fused", [
    ("asgd", "sgd", False), ("asgd", "momentum", True),
    ("silent", "sgd", False), ("sync", "momentum", False)])
def test_pytree_step_matches_reference(algo, inner, fused):
    cfg = jget_arch("smollm-135m").reduced()
    key = jax.random.key(0)
    wnp = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (W,) + x.shape).copy(),
        reference_init())
    kw = dict(shifts=(1, 2), partial_blocks=4, delay=1)
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jacfg = jasgd.ASGDConfig(eps=0.05, use_fused=fused)
    tacfg = tasgd.ASGDConfig(eps=0.05, use_fused=fused)

    jp = jax.tree.map(jnp.asarray, wnp)
    jstate, jopt = jg.init_gossip_state(jp, jcfg), jinit_inner(jp, inner)
    jstep = jax.jit(jmake_train_step(cfg, algo=algo, gcfg=jcfg, acfg=jacfg,
                                     inner=inner))
    tp = params_from_numpy(wnp)
    tstate, topt = tg.init_gossip_state(tp, tcfg), init_inner_state(tp,
                                                                    inner)
    tstep = make_train_step(get_arch("smollm-135m").reduced(), algo=algo,
                            inner=inner, gcfg=tcfg, acfg=tacfg)

    its = [lm_batch_iterator(w, BATCH, SEQ, cfg.vocab) for w in range(W)]
    n_good = []
    for step in range(STEPS):
        tokens = np.stack([next(it)["tokens"] for it in its])
        k = jax.random.fold_in(key, step)
        jp, jstate, jopt, jm = jstep(jp, jstate, jopt,
                                     {"tokens": jnp.asarray(tokens)}, k)
        tp, tstate, topt, tm = tstep(tp, tstate, topt,
                                     {"tokens": torch.from_numpy(tokens)},
                                     *jax_draws(k, jcfg))
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= 1e-4 * abs(ref)
        assert ("n_good" in tm) == ("n_good" in jm) == (algo == "asgd")
        if algo == "asgd":
            assert float(tm["n_good"]) == float(jm["n_good"])
            np.testing.assert_array_equal(tm["gate"].numpy(),
                                          np.asarray(jm["gate"]))
            n_good.append(float(tm["n_good"]))
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)
    if algo == "asgd":
        assert tstate.step == STEPS and n_good[0] == 0.0
    if algo == "sync":      # every worker took the same averaged step
        for leaf in jax.tree.leaves(tp):
            assert torch.equal(leaf[0], leaf[3])


@pytest.mark.parametrize("algo", ["asgd", "silent", "sync"])
def test_cli_pytree_engine_on_cpu(algo):
    out = ttrain.main(["--arch", "smollm-135m", "--reduced", "--device",
                       "cpu", "--workers", "4", "--algo", algo, "--steps",
                       "3", "--seq", "32", "--wire-format", "int8",
                       "--log-every", "100"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert len(out["n_good"]) == (3 if algo == "asgd" else 0)
    wq = out["params"]["scan"]["pos0"]["attn"]["wq"]
    assert wq.shape == (4, 2, 256, 4, 64)
    assert torch.equal(wq[0], wq[3])     # the worker average
