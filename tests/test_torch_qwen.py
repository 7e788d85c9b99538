"""The qwen archs — reduced qwen2.5-14b (QKV biases) and qwen3-14b
(per-head qk RMSNorm): 2 'G' layers, d_model 256, 4 heads, an untied head,
remat_policy 'dots' — through the port against the reference, on the
reference's weights carried over as numpy with the biases ``bq``/``bk``/
``bv`` and the qk-norm scales ``q_norm``/``k_norm`` perturbed by
0.5 x N(0, 1) before either package reads them (at init they are zeros
and ones, which would hide a fault in either):

* the logits, the loss and every gradient leaf against the reference's
  ``loss_fn(remat=True)`` under ``jax.value_and_grad`` (the port
  rematerializes too);
* the prefill, 4 decode steps (each cache leaf after each) and
  ``generate`` against the reference's;
* 3 pipelined int8 steps against the reference's jitted pipelined step.

The port runs on one torch thread here (``one_thread``), so that its
small ops do not contend with JAX's thread pool and the other test
processes for the cores.

Tolerances: test_torch_serve.py's for serving (1e-4 of the largest
magnitude, the bf16 cache within 1e-2), test_torch_train_moe.py's for
training (logits 1e-4 of the largest magnitude, loss rel 1e-5, gradients
atol 1e-5; over steps losses rel 1e-4, the state atol 1e-4, n_good
exactly).
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
from repro.data.synthetic import synthetic_lm_batch
from repro.launch.serve import generate as jgenerate
from repro.launch.steps import init_inner_state as jinit_inner
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.packing import pack_spec_w, pack_w
from repro_torch.core.tree import flatten_sorted
from repro_torch.launch import serve as tserve
from repro_torch.launch.steps import (init_inner_state, make_train_step,
                                      tree_loss_and_grad)
from repro_torch.models import model as TM
from test_torch_serve import (BATCH, PROMPT, STEPS, assert_cache_near,
                              assert_near, jb, tb)
from test_torch_train_moe import (GOSSIP, reference_init, run_both,
                                  worker_params)

ARCHS = ["qwen2.5-14b", "qwen3-14b"]
PERTURBED = ("bq", "bk", "bv", "q_norm", "k_norm")
BLOCK_ROWS = 256          # the pipelined check's row blocks (see
#                           test_torch_train_gemma_pipelined.py)


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def perturb(tree, seed):
    """The numpy tree with every leaf under a PERTURBED key plus
    0.5 x N(0, 1) from ``seed``; the other leaves as they are."""
    rng = np.random.default_rng(seed)

    def walk(node, hit):
        if isinstance(node, dict):
            return {k: walk(v, hit or k in PERTURBED)
                    for k, v in sorted(node.items())}
        x = np.asarray(node)
        if not hit:
            return x
        return (x + 0.5 * rng.standard_normal(x.shape)).astype(x.dtype)
    return walk(tree, False)


def perturbed_params(arch, seed=0):
    """(reference cfg, reference params, port params), both from one
    perturbed numpy tree."""
    cfg = jget_arch(arch).reduced()
    tree = perturb(jax.tree.map(np.asarray, reference_init(cfg, seed)),
                   seed + 10)
    return cfg, jax.tree.map(jnp.asarray, tree), params_from_numpy(tree)


def test_perturbed_leaves_are_the_arch_features():
    for arch, want in zip(ARCHS, (("bk", "bq", "bv"), ("k_norm", "q_norm"))):
        _, jp, _ = perturbed_params(arch)
        attn = jp["scan"]["pos0"]["attn"]
        assert tuple(k for k in sorted(attn) if k in PERTURBED) == want
        for k in want:
            leaf = attn[k]["scale"] if "norm" in k else attn[k]
            assert float(jnp.abs(leaf - (1.0 if "norm" in k else 0.0))
                         .min()) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_gradients_match_reference(arch):
    """Two workers' own perturbed weights and tokens: each worker's logits
    and loss, and the gradient of every leaf, against the reference's
    rematerialized loss."""
    cfg = jget_arch(arch).reduced()
    wnp = perturb(worker_params(cfg, w=2), 20)
    rng = np.random.default_rng(2)
    tokens = np.stack([synthetic_lm_batch(rng, BATCH, 32, cfg.vocab)
                       ["tokens"] for _ in range(2)])
    tcfg = get_arch(arch).reduced()
    tp = params_from_numpy(wnp)
    batch = {"tokens": torch.from_numpy(tokens)}
    with torch.no_grad():
        logits, _ = TM.forward_w(tcfg, tp, batch)
    losses, grads = tree_loss_and_grad(tcfg, tp, batch)
    jforward = jax.jit(lambda p, b: JM.forward(cfg, p, b, remat=True)[0])
    jloss_grad = jax.jit(jax.value_and_grad(
        lambda p, b: JM.loss_fn(cfg, p, b, remat=True)))
    for w in range(2):
        jp = jax.tree.map(lambda x: jnp.asarray(x[w]), wnp)
        jbatch = {"tokens": jnp.asarray(tokens[w])}
        assert_near(logits[w], jforward(jp, jbatch))
        jloss, jgrad = jloss_grad(jp, jbatch)
        np.testing.assert_allclose(float(losses[w]), float(jloss),
                                   rtol=1e-5)
        jl, tl = jax.tree.leaves(jgrad), flatten_sorted(grads)[0]
        assert len(jl) == len(tl)
        for a, b in zip(tl, jl):
            np.testing.assert_allclose(a[w].numpy(), np.asarray(b), rtol=0,
                                       atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_and_generate_match_reference(arch):
    """The prefill's last logits and cache, 4 decode steps fed the
    reference's greedy tokens (logits and every cache leaf after each),
    then generate's tokens."""
    cfg, jp, tp = perturbed_params(arch, seed=1)
    tcfg = get_arch(arch).reduced()
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, PROMPT))
             .astype(np.int32)}
    jlast, jcache = JM.prefill(cfg, jp, jb(batch), cache_len=PROMPT + STEPS)
    last, cache = TM.prefill(tcfg, tp, tb(batch), cache_len=PROMPT + STEPS)
    assert_near(last, jlast)
    assert_cache_near(cache, jcache)
    jdecode = jax.jit(lambda p, t, pos, c: JM.decode_step(cfg, p, t, pos, c))
    tok = jnp.argmax(jlast, axis=-1).astype(jnp.int32)
    for i in range(STEPS):
        jlogits, jcache = jdecode(jp, tok, jnp.int32(PROMPT + i), jcache)
        logits, cache = TM.decode_step(tcfg, tp, torch.from_numpy(
            np.array(tok)), PROMPT + i, cache)
        assert_near(logits, jlogits)
        assert_cache_near(cache, jcache)
        tok = jnp.argmax(jlogits, axis=-1).astype(jnp.int32)
    jtoks, _ = jgenerate(cfg, jp, jb(batch), PROMPT, STEPS + 1)
    toks, _ = tserve.generate(tcfg, tp, tb(batch), PROMPT, STEPS + 1)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(jtoks))


@pytest.mark.parametrize("arch", ARCHS)
def test_pipelined_int8_matches_reference(arch):
    """3 pipelined int8 steps from distinct perturbed worker starts, on
    the same batches and gossip draws."""
    cfg = jget_arch(arch).reduced()
    wnp = perturb(worker_params(cfg), 30)
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

    n_good = run_both(
        jstep, (jpk, jg.init_pipelined_gossip_state(jpk, jcfg,
                                                    block_rows=BLOCK_ROWS),
                jinit_inner(jpk, "sgd")),
        tstep, (tpk, tg.init_pipelined_gossip_state(tpk, tcfg,
                                                    block_rows=BLOCK_ROWS),
                init_inner_state(tpk, "sgd")), jcfg, cfg.vocab, check)
    assert len(n_good) == 3
