"""Training reduced mamba2-370m (2 'S' layers, d_model 256, 32 SSD heads
of 16, state 16, chunk 8; seq 32 = 4 chunks, so the scan's backward
crosses chunks) through the port against the reference's jitted train
step, on the same weights, batches and gossip draws: the pipelined int8
engine and the pytree asgd engine, 3 steps each; plus the CLI trainer on
the CPU.  The reference differentiates its jnp chunked scan with jax.grad;
the port runs the scan's backward (the plain version on the CPU, B5b on
the card).

Tolerances: losses within rel 1e-4, the state within atol 1e-4 (f32
forward/backward sums in different orders compound over the steps), the
admitted-message count n_good exactly.  The workers start 0.1 apart
(seeded noise) and with these draws admit no message in 3 rounds: from
such starts this training is chaotic in the reference itself — two of its
runs 1e-7 apart at the start drift ~1e-3 apart one round after a blend
admits messages — so no atol holds past an open gate, for the reference
against itself either.  chip_smoke.py's [ssm-train-check] runs the card
against the CPU through an admitting round.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.core.packing import pack_w as jpack_w
from repro.data.synthetic import lm_batch_iterator
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.packing import pack_spec_w, pack_w
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import init_inner_state, make_train_step

ARCH, W, BATCH, SEQ, STEPS = "mamba2-370m", 4, 2, 32, 3
START_NOISE = 0.1
GOSSIP = dict(shifts=(1, 2), partial_blocks=4, delay=1)


def jax_draws(key, cfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


def worker_params(cfg):
    """The reference's init for W workers, as numpy, each worker's leaves
    offset by its own seeded noise: distinct starts, so the gates' terms
    are not trivially zero."""
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda x: (np.asarray(x)[None] + START_NOISE * rng.standard_normal(
            (W,) + x.shape)).astype(np.float32),
        JM.init_model(cfg, jax.random.key(0)))


def run_both(jstep, jstate, tstep, tstate, jcfg, vocab, check_state):
    """STEPS rounds of both steps on the same batches and draws; returns
    the port's final (params, gossip, opt)."""
    key = jax.random.key(0)
    its = [lm_batch_iterator(w, BATCH, SEQ, vocab) for w in range(W)]
    for step in range(STEPS):
        tokens = np.stack([next(it)["tokens"] for it in its])
        k = jax.random.fold_in(key, step)
        *jstate, jm = jstep(*jstate, {"tokens": jnp.asarray(tokens)}, k)
        *tstate, tm = tstep(*tstate, {"tokens": torch.from_numpy(tokens)},
                            *jax_draws(k, jcfg))
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= 1e-4 * abs(ref)
        assert float(tm["n_good"]) == float(jm["n_good"])
        check_state(tstate[0], jstate[0])
    return tstate


def test_pipelined_int8_mamba2_matches_reference():
    cfg = jget_arch(ARCH).reduced()
    wnp = worker_params(cfg)
    kw = dict(GOSSIP, wire_format="int8")
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jw = jax.tree.map(jnp.asarray, wnp)
    jspec = jpack_spec_w(jw, block_rows=64, groups=jg.leaf_groups(jw, 4),
                         n_groups=4)
    jpk = jpack_w(jw, jspec)
    jstep = jax.jit(jmake_train_step(
        cfg, gcfg=jcfg, acfg=jasgd.ASGDConfig(eps=0.05),
        packed_resident=True, pack_spec=jspec, pipelined=True))
    tw = params_from_numpy(wnp)
    tspec = pack_spec_w(tw, block_rows=64, groups=tg.leaf_groups(tw, 4),
                        n_groups=4)
    tpk = pack_w(tw, tspec)
    tstep = make_train_step(get_arch(ARCH).reduced(), pack_spec=tspec,
                            gcfg=tcfg, acfg=tasgd.ASGDConfig(eps=0.05),
                            pipelined=True)

    def check(ours, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)

    tstate = run_both(
        jstep, (jpk, jg.init_pipelined_gossip_state(jpk, jcfg,
                                                    block_rows=64),
                jinit_inner(jpk, "sgd")),
        tstep, (tpk, tg.init_pipelined_gossip_state(tpk, tcfg,
                                                    block_rows=64),
                init_inner_state(tpk, "sgd")), jcfg, cfg.vocab, check)
    assert tstate[1].step == STEPS


def test_pytree_asgd_mamba2_matches_reference():
    cfg = jget_arch(ARCH).reduced()
    wnp = worker_params(cfg)
    jcfg, tcfg = jg.GossipConfig(**GOSSIP), tg.GossipConfig(**GOSSIP)
    jp = jax.tree.map(jnp.asarray, wnp)
    jstep = jax.jit(jmake_train_step(cfg, gcfg=jcfg,
                                     acfg=jasgd.ASGDConfig(eps=0.05)))
    tp = params_from_numpy(wnp)
    tstep = make_train_step(get_arch(ARCH).reduced(), gcfg=tcfg,
                            acfg=tasgd.ASGDConfig(eps=0.05))

    def check(ours, ref):
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)

    run_both(jstep, (jp, jg.init_gossip_state(jp, jcfg),
                     jinit_inner(jp, "sgd")),
             tstep, (tp, tg.init_gossip_state(tp, tcfg),
                     init_inner_state(tp, "sgd")), jcfg, cfg.vocab, check)


@pytest.mark.parametrize("engine", [["--pipelined", "--wire-format", "int8"],
                                    ["--algo", "silent"]])
def test_cli_trains_mamba2_on_cpu(engine):
    out = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--workers", "2", "--steps", "2", "--seq", "16",
                       "--log-every", "100", *engine])
    assert len(out["losses"]) == 2 and np.isfinite(out["losses"]).all()
    a_log = out["params"]["scan"]["pos0"]["ssm"]["A_log"]
    assert a_log.shape == (2, 2, 32) and torch.equal(a_log[0], a_log[1])


def test_cli_rejects_a_seq_off_the_chunk():
    with pytest.raises(ValueError, match="ssm_chunk 8"):
        ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                     "--steps", "1", "--seq", "20"])
