"""Training the MoE archs — reduced granite-moe-1b-a400m (32 experts top-8
cut to 4 top-2) and reduced phi3.5-moe-42b-a6.6b (16 top-2 cut to 4
top-2); 2 'G' layers, d_model 256, 16 dispatch groups — through the port
against the reference, on the reference's weights carried over as numpy:

* the forward's logits, the loss with the router's aux term and every
  gradient leaf against the reference's ``loss_fn`` under
  ``jax.value_and_grad``, jitted;
* 3 pipelined int8 steps and one pytree asgd step against the reference's
  jitted train step on the same batches and gossip draws;
* checkpoints of the trainer both ways: a reference trainer's --save file
  restored by the port (leaf for leaf the file's bytes) and a port
  trainer's file restored by the reference trainer, each resumed for 2
  steps by both.

Tolerances: logits within 1e-4 of their largest magnitude, the loss
within rel 1e-5, gradients within atol 1e-5; over training steps the
losses within rel 1e-4, the state within atol 1e-4 and n_good exactly.
At batch 2 x seq 32 a worker's 64 tokens form 16 groups of 4 with
capacity 2 an expert, so the reference drops (token, slot) pairs here,
and the port drops the same ones (a different drop would move the loss
far past these tolerances).
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
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.core.packing import pack_w as jpack_w
from repro.data.synthetic import lm_batch_iterator, synthetic_lm_batch
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.checkpoint import canonical_leaves
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.packing import pack_spec_w, pack_w
from repro_torch.core.tree import flatten_sorted
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import (init_inner_state, make_train_step,
                                      tree_loss_and_grad)
from repro_torch.models import model as TM

from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
W, BATCH, SEQ, STEPS = 4, 2, 32, 3
START_NOISE = 0.1
GOSSIP = dict(shifts=(1, 2), partial_blocks=4, delay=1)


def jax_draws(key, cfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


@functools.lru_cache
def reference_init(cfg, seed=0):
    """The reference's params of ``cfg`` from ``seed``, made once for every
    test that starts from them (jax arrays are immutable)."""
    return JM.init_model(cfg, jax.random.key(seed))


def worker_params(cfg, w=W):
    """The reference's init for w workers, as numpy, each worker's leaves
    offset by its own seeded noise."""
    rng = np.random.default_rng(1)
    return jax.tree.map(
        lambda x: (np.asarray(x)[None] + START_NOISE * rng.standard_normal(
            (w,) + x.shape)).astype(np.float32),
        reference_init(cfg))


def test_reduced_configs_have_experts():
    for arch in ARCHS:
        cfg = get_arch(arch).reduced()
        assert (cfg.n_experts, cfg.experts_per_token,
                cfg.moe_dispatch_groups) == (4, 2, 16)
        params = TM.init_model(cfg, 0, device="cpu")
        moe = params["scan"]["pos0"]["moe"]
        assert "mlp" not in params["scan"]["pos0"]
        assert {n: tuple(v.shape) for n, v in moe.items()} == {
            "router": (2, 256, 4), "gate": (2, 4, 256, cfg.d_ff),
            "up": (2, 4, 256, cfg.d_ff), "down": (2, 4, cfg.d_ff, 256)}


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    """Two workers' own weights and tokens: logits and loss (aux
    included) per worker, and the gradient of every leaf."""
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg, w=2)
    rng = np.random.default_rng(2)
    tokens = np.stack([synthetic_lm_batch(rng, BATCH, SEQ, cfg.vocab)
                       ["tokens"] for _ in range(2)])
    tp = params_from_numpy(wnp)
    tcfg = get_arch(arch).reduced()
    logits, aux = TM.forward_w(tcfg, tp, {"tokens": torch.from_numpy(
        tokens)})
    losses, grads = tree_loss_and_grad(tcfg, tp, {"tokens":
                                                  torch.from_numpy(tokens)})
    assert bool((aux > 0.5).all())       # the router's term is in the loss
    # the reference jitted once for both workers, as the other archs'
    # tests run it (eager dispatch of its 16 groups costs more)
    jforward = jax.jit(lambda p, b: JM.forward(cfg, p, b, remat=False))
    jloss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b, remat=False)))
    for w in range(2):
        jp = jax.tree.map(lambda x: jnp.asarray(x[w]), wnp)
        jb = {"tokens": jnp.asarray(tokens[w])}
        jlogits, jaux = jforward(jp, jb)
        scale = float(np.abs(np.asarray(jlogits)).max())
        assert float(np.abs(logits[w].detach().numpy()
                            - np.asarray(jlogits)).max()) <= 1e-4 * scale
        np.testing.assert_allclose(float(aux[w]), float(jaux), rtol=1e-5)
        jloss, jgrad = jloss_grad(jp, jb)
        np.testing.assert_allclose(float(losses[w]), float(jloss),
                                   rtol=1e-5)
        jl, tl = jax.tree.leaves(jgrad), flatten_sorted(grads)[0]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a[w].numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


def run_both(jstep, jstate, tstep, tstate, jcfg, vocab, check_state,
             steps=STEPS, stub=None):
    """``steps`` rounds of both steps on the same batches and draws;
    returns the n_good of each round.  ``stub``: lm_batch_iterator's
    frontend keywords, whose frames or patches join each worker's batch."""
    key = jax.random.key(0)
    its = [lm_batch_iterator(w, BATCH, SEQ, vocab, **(stub or {}))
           for w in range(W)]
    n_good = []
    for step in range(steps):
        bs = [next(it) for it in its]
        batch = {n: np.stack([b[n] for b in bs]) for n in bs[0]}
        k = jax.random.fold_in(key, step)
        *jstate, jm = jstep(*jstate, {n: jnp.asarray(v)
                                      for n, v in batch.items()}, k)
        *tstate, tm = tstep(*tstate, {n: torch.from_numpy(v)
                                      for n, v in batch.items()},
                            *jax_draws(k, jcfg))
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= 1e-4 * abs(ref)
        assert float(tm["n_good"]) == float(jm["n_good"])
        n_good.append(float(jm["n_good"]))
        check_state(tstate[0], jstate[0])
    return n_good


@pytest.mark.parametrize("arch", ARCHS)
def test_pipelined_int8_matches_reference(arch):
    cfg = jget_arch(arch).reduced()
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
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    tstep = make_train_step(get_arch(arch).reduced(), pack_spec=tspec,
                            gcfg=tcfg, acfg=tasgd.ASGDConfig(eps=0.05),
                            pipelined=True)

    def check(ours, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)

    run_both(jstep, (jpk, jg.init_pipelined_gossip_state(jpk, jcfg,
                                                         block_rows=64),
                     jinit_inner(jpk, "sgd")),
             tstep, (tpk, tg.init_pipelined_gossip_state(tpk, tcfg,
                                                         block_rows=64),
                     init_inner_state(tpk, "sgd")), jcfg, cfg.vocab, check)


@pytest.mark.parametrize("arch", ARCHS)
def test_pytree_asgd_step_matches_reference(arch):
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg)
    jcfg, tcfg = jg.GossipConfig(**GOSSIP), tg.GossipConfig(**GOSSIP)
    jp = jax.tree.map(jnp.asarray, wnp)
    jstep = jax.jit(jmake_train_step(cfg, gcfg=jcfg,
                                     acfg=jasgd.ASGDConfig(eps=0.05)))
    tp = params_from_numpy(wnp)
    tstep = make_train_step(get_arch(arch).reduced(), gcfg=tcfg,
                            acfg=tasgd.ASGDConfig(eps=0.05))

    def check(ours, ref):
        for a, b in zip(flatten_sorted(ours)[0], jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)

    run_both(jstep, (jp, jg.init_gossip_state(jp, jcfg),
                     jinit_inner(jp, "sgd")),
             tstep, (tp, tg.init_gossip_state(tp, tcfg),
                     init_inner_state(tp, "sgd")), jcfg, cfg.vocab, check,
             steps=1)


TRAIN = ["--arch", "granite-moe-1b-a400m", "--reduced", "--batch", "1",
         "--seq", "32", "--workers", "2", "--pipelined", "--wire-format",
         "int8", "--log-every", "100"]


def test_reference_checkpoint_restores_into_the_port(tmp_path):
    """A reference trainer's file of reduced granite: the port restores
    it leaf for leaf (the file's bytes), and 2 resumed steps of each
    trainer from it give the same losses."""
    msgpack = pytest.importorskip("msgpack")
    from repro.launch.train import main as jtrain_main
    from repro_torch.checkpoint.checkpoint import (_encode_leaf,
                                                   _packed_state_to_tree)
    ck = tmp_path / "ref.msgpack"
    jtrain_main(TRAIN + ["--steps", "2", "--save", str(ck)])
    out = ttrain.main(TRAIN + ["--device", "cpu", "--steps", "2",
                               "--restore", str(ck)])
    assert out["losses"] == [] and out["state"]["step"] == 2
    mine = canonical_leaves(_packed_state_to_tree(out["state"],
                                                  out["spec"]))[0]
    theirs = msgpack.unpackb(ck.read_bytes(), raw=False)["leaves"]
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        dtype, shape, data = _encode_leaf(a)
        assert (dtype, shape) == (b["dtype"], b["shape"])
        assert data.tobytes() == b["data"]
    more = ttrain.main(TRAIN + ["--device", "cpu", "--steps", "4",
                                "--restore", str(ck)])
    ref = jtrain_main(TRAIN + ["--steps", "4", "--restore", str(ck)])
    np.testing.assert_allclose(more["losses"], [float(x) for x in ref],
                               rtol=1e-4)


def test_port_checkpoint_restores_into_the_reference(tmp_path):
    """A port trainer's --save file of reduced granite: the reference
    trainer restores it and its 2 resumed steps give the port's resumed
    losses."""
    pytest.importorskip("msgpack")
    from repro.launch.train import main as jtrain_main
    ck = str(tmp_path / "port.msgpack")
    ttrain.main(TRAIN + ["--device", "cpu", "--steps", "2", "--save", ck])
    ours = ttrain.main(TRAIN + ["--device", "cpu", "--steps", "4",
                                "--restore", ck])
    ref = jtrain_main(TRAIN + ["--steps", "4", "--restore", ck])
    assert len(ours["losses"]) == 2 and len(ref) == 2
    np.testing.assert_allclose(ours["losses"], [float(x) for x in ref],
                               rtol=1e-4)
    assert ours["params"]["scan"]["pos0"]["moe"]["gate"].shape == \
        (2, 2, 4, 256, 512)
