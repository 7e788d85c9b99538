"""Shared cases of the frontend archs' parity tests (test_torch_prefix.py:
paligemma-3b; test_torch_encoder.py: whisper-tiny), reduced, through the
port against the reference on the reference's weights carried over as
numpy, each worker's stub inputs (frames or patches) drawn with its tokens:

* the forward's logits, the loss and every gradient leaf of two workers
  against the reference's ``loss_fn`` under ``jax.value_and_grad``:
  logits and each gradient leaf within 1e-5 of their largest magnitude,
  the loss within rel 1e-5;
* 3 pipelined int8 steps from distinct worker starts against the
  reference's jitted pipelined train step, on the same batches and gossip
  draws, under the train tests' gates: losses rel 1e-4, n_good exactly,
  the packed state atol 1e-4 each step, bitwise at the start.  The packed
  layout takes row blocks of BLOCK_ROWS = 256 (the reference's Pallas
  kernels run in interpret mode here, one grid step a block).
"""
import jax
import jax.numpy as jnp
import numpy as np
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
from repro_torch.core.tree import flatten_sorted
from repro_torch.launch.steps import (init_inner_state, make_train_step,
                                      tree_loss_and_grad)
from repro_torch.models import model as TM
from test_torch_train_moe import BATCH, GOSSIP, SEQ, run_both, worker_params

BLOCK_ROWS = 256


def stub_kw(cfg):
    """lm_batch_iterator's frontend keywords for ``cfg``."""
    return dict(frontend=cfg.frontend, d_model=cfg.d_model,
                encoder_seq=cfg.encoder_seq, prefix_len=cfg.prefix_len)


def worker_batches(cfg, w=2, seed=2):
    """One batch for each of ``w`` workers, every key stacked (numpy)."""
    bs = [next(lm_batch_iterator(seed * 100 + i, BATCH, SEQ, cfg.vocab,
                                 **stub_kw(cfg))) for i in range(w)]
    return {n: np.stack([b[n] for b in bs]) for n in bs[0]}


def assert_within(ours, ref, tol=1e-5):
    ref = np.asarray(ref)
    err, scale = float(np.abs(ours - ref).max()), float(np.abs(ref).max())
    assert err <= tol * scale, (err, scale)


def check_forward_loss_and_gradients(arch):
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg, w=2)
    batch = worker_batches(cfg)
    tp = params_from_numpy(wnp)
    tcfg = get_arch(arch).reduced()
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
    logits, _ = TM.forward_w(tcfg, tp, tbatch)
    losses, grads = tree_loss_and_grad(tcfg, tp, tbatch)
    jforward = jax.jit(lambda p, b: JM.forward(cfg, p, b, remat=False)[0])
    jloss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b, remat=False)))
    for w in range(2):
        jp = jax.tree.map(lambda x: jnp.asarray(x[w]), wnp)
        jbatch = {n: jnp.asarray(v[w]) for n, v in batch.items()}
        assert_within(logits[w].detach().numpy(), jforward(jp, jbatch))
        jloss, jgrad = jloss_grad(jp, jbatch)
        np.testing.assert_allclose(float(losses[w]), float(jloss),
                                   rtol=1e-5)
        jl, tl = jax.tree.leaves(jgrad), flatten_sorted(grads)[0]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            assert_within(a[w].numpy(), b)
    return logits


def check_pipelined_int8(arch):
    cfg = jget_arch(arch).reduced()
    wnp = worker_params(cfg)
    kw = dict(GOSSIP, wire_format="int8")
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jw = jax.tree.map(jnp.asarray, wnp)
    jspec = jpack_spec_w(jw, block_rows=BLOCK_ROWS,
                         groups=jg.leaf_groups(jw, 4), n_groups=4)
    jpk = jpack_w(jw, jspec)
    jstep = jax.jit(jmake_train_step(
        cfg, gcfg=jcfg, acfg=jasgd.ASGDConfig(eps=0.05),
        packed_resident=True, pack_spec=jspec, pipelined=True))
    tw = params_from_numpy(wnp)
    tspec = pack_spec_w(tw, block_rows=BLOCK_ROWS,
                        groups=tg.leaf_groups(tw, 4), n_groups=4)
    tpk = pack_w(tw, tspec)
    np.testing.assert_array_equal(tpk.numpy(), np.asarray(jpk))
    tstep = make_train_step(get_arch(arch).reduced(), pack_spec=tspec,
                            gcfg=tcfg, acfg=tasgd.ASGDConfig(eps=0.05),
                            pipelined=True)

    def check(ours, ref):
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-4)

    return run_both(
        jstep, (jpk, jg.init_pipelined_gossip_state(jpk, jcfg,
                                                    block_rows=BLOCK_ROWS),
                jinit_inner(jpk, "sgd")),
        tstep, (tpk, tg.init_pipelined_gossip_state(tpk, tcfg,
                                                    block_rows=BLOCK_ROWS),
                init_inner_state(tpk, "sgd")), jcfg, cfg.vocab, check,
        stub=stub_kw(cfg))
