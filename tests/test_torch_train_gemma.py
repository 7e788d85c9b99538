"""Training the Gemma family — reduced gemma3-1b (6 layers: 'L' x5, 'G';
window 16, scaled embeddings, qk-norm) and reduced recurrentgemma-9b (3
layers: 'R', 'R', 'L'; lru_width 256, window 16) — through the port
against the reference, on the reference's weights carried over as numpy,
at seq 32, where the window binds:

* the forward's logits, the loss and every gradient leaf against the
  reference's ``loss_fn`` under ``jax.value_and_grad``;
* 2 pytree asgd steps with ``use_fused`` (the first gated out by the
  staleness guard, the second blends) against the reference's jitted
  train step on the same batches and gossip draws, the fused layout in
  row blocks of 256 (the reference's Pallas kernels run in interpret
  mode here, one grid step a block: at 64 rows a block the steps took
  twice as long).

3 pipelined int8 steps of each arch are in
test_torch_train_gemma_pipelined.py and the checkpoints both ways in
test_torch_train_gemma_ckpt.py, files of their own so that test workers
share the load.

Tolerances: logits within 1e-5 of their largest magnitude, the loss
within rel 1e-5, gradients within atol 1e-5; over training steps the
losses within rel 1e-4, the state within atol 1e-4 and n_good exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core import asgd as jasgd
from repro.core import gossip as jg
from repro.data.synthetic import synthetic_lm_batch
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.tree import flatten_sorted
from repro_torch.launch.steps import (init_inner_state, make_train_step,
                                      tree_loss_and_grad)
from repro_torch.models import model as TM
from test_torch_train_moe import BATCH, GOSSIP, SEQ, run_both, worker_params
from _torch_threads import one_torch_thread  # noqa: F401

ARCHS = ["gemma3-1b", "recurrentgemma-9b"]


def test_reduced_configs_bind_the_window():
    g, r = (get_arch(a).reduced() for a in ARCHS)
    assert g.layer_types == ("L",) * 5 + ("G",) and r.layer_types == \
        ("R", "R", "L")
    assert g.sliding_window == r.sliding_window == 16 < SEQ
    assert g.scale_embeddings and r.scale_embeddings and r.lru_width == 256
    params = TM.init_model(r, 0, device="cpu")
    assert sorted(params["scan"]["pos0"]) == ["ln1", "ln2", "mlp", "rglru"]
    assert params["scan"]["pos0"]["rglru"]["w_a"].shape == (1, 256, 256)
    assert sorted(params["scan"]["pos2"]) == ["attn", "ln1", "ln2", "mlp"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    """Two workers' own weights and tokens: logits and loss per worker,
    and the gradient of every leaf."""
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg, w=2)
    rng = np.random.default_rng(2)
    tokens = np.stack([synthetic_lm_batch(rng, BATCH, SEQ, cfg.vocab)
                       ["tokens"] for _ in range(2)])
    tp = params_from_numpy(wnp)
    tcfg = get_arch(arch).reduced()
    batch = {"tokens": torch.from_numpy(tokens)}
    logits, _ = TM.forward_w(tcfg, tp, batch)
    losses, grads = tree_loss_and_grad(tcfg, tp, batch)
    # jitted once, called for each worker
    jforward = jax.jit(lambda p, t: JM.forward(cfg, p, {"tokens": t},
                                               remat=False)[0])
    jloss_grad = jax.jit(jax.value_and_grad(lambda p, t: JM.loss_fn(
        cfg, p, {"tokens": t}, remat=False)))
    for w in range(2):
        jp = jax.tree.map(lambda x: jnp.asarray(x[w]), wnp)
        jt = jnp.asarray(tokens[w])
        jlogits = np.asarray(jforward(jp, jt))
        assert float(np.abs(logits[w].detach().numpy() - jlogits).max()) \
            <= 1e-5 * float(np.abs(jlogits).max())
        jloss, jgrad = jloss_grad(jp, jt)
        np.testing.assert_allclose(float(losses[w]), float(jloss),
                                   rtol=1e-5)
        jl, tl = jax.tree.leaves(jgrad), flatten_sorted(grads)[0]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a[w].numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_pytree_fused_asgd_steps_match_reference(arch):
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg)
    kw = dict(GOSSIP, fused_block_rows=256)
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jp = jax.tree.map(jnp.asarray, wnp)
    jstep = jax.jit(jmake_train_step(
        cfg, gcfg=jcfg, acfg=jasgd.ASGDConfig(eps=0.05, use_fused=True)))
    tp = params_from_numpy(wnp)
    tstep = make_train_step(get_arch(arch).reduced(), gcfg=tcfg,
                            acfg=tasgd.ASGDConfig(eps=0.05, use_fused=True))

    def check(ours, ref):
        for a, b in zip(flatten_sorted(ours)[0], jax.tree.leaves(ref)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                       atol=1e-4)

    n_good = run_both(jstep, (jp, jg.init_gossip_state(jp, jcfg),
                              jinit_inner(jp, "sgd")),
                      tstep, (tp, tg.init_gossip_state(tp, tcfg),
                              init_inner_state(tp, "sgd")), jcfg, cfg.vocab,
                      check, steps=2)
    assert n_good[0] == 0 and n_good[1] > 0
