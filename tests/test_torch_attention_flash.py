"""The port's chunked ``attention_flash`` (models/common.py) against the
reference's (src/repro/models/common.py:206) on the same weights and
inputs: causal, sliding-window and prefix masks at small blocks, its
gradient against ``jax.grad``, a 'G' layer at seq 2048 (where both
packages' ``apply_layer`` dispatch to it) on reduced smollm-135m, and the
reference's block limit (S a multiple of block_k) kept.

Tolerance: rtol 2e-4, atol 2e-5, that of the reference's own
tests/test_attention.py (online-softmax sums in block order; f32 matmuls
in another order); gradients within 1e-4 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import blocks as JB
from repro.models import common as JC
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import tree_map
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from _torch_threads import one_torch_thread  # noqa: F401

SPEC = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)


def setup(S, seed=0, B=2):
    """Reference attention params, the port's (leading worker axis W = 1),
    and x (B, S, 64) from a numpy seed."""
    jp = JC.init_attention(jax.random.key(seed), JC.AttnSpec(**SPEC))
    tp = tree_map(lambda t: t[None],
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    x = 0.5 * np.random.default_rng(seed + 1).standard_normal(
        (B, S, 64)).astype(np.float32)
    return jp, tp, x


@pytest.mark.parametrize("mask", [{}, {"window": 40}, {"window": 150},
                                  {"prefix_len": 70}, {"prefix_len": 200}])
def test_flash_matches_reference(mask):
    S = 256
    jp, tp, x = setup(S)
    ref = JC.attention_flash(jp, JC.AttnSpec(**SPEC), jnp.asarray(x),
                             jnp.arange(S), block_q=64, block_k=128, **mask)
    ours = TC.attention_flash(tp, TC.AttnSpec(**SPEC),
                              torch.from_numpy(x)[None], torch.arange(S),
                              block_q=64, block_k=128, **mask)[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def test_flash_gradient_matches_jax_grad():
    S = 128
    jp, tp, x = setup(S, seed=3)
    ct = np.random.default_rng(4).standard_normal((2, S, 64)).astype(
        np.float32)

    def jloss(p, xx):
        out = JC.attention_flash(p, JC.AttnSpec(**SPEC), xx, jnp.arange(S),
                                 window=50, block_q=32, block_k=64)
        return jnp.sum(out * ct)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x)[None].requires_grad_()
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    out = TC.attention_flash(leaves, TC.AttnSpec(**SPEC), xt,
                             torch.arange(S), window=50, block_q=32,
                             block_k=64)
    (out * torch.from_numpy(ct)[None]).sum().backward()
    pairs = [(xt.grad[0], jg_x)] + [(leaves[k].grad[0], jg_p[k])
                                    for k in sorted(leaves)]
    for ours, ref in pairs:
        ref = np.asarray(ref)
        err = np.abs(ours.numpy() - ref).max()
        assert err <= 1e-4 * np.abs(ref).max(), (err, np.abs(ref).max())


def test_g_layer_at_2048_dispatches_to_flash(monkeypatch):
    """A 'G' layer of reduced smollm-135m at seq 2048: the port's
    apply_layer takes attention_flash (default blocks 512 / 1024), as the
    reference's does, and matches it."""
    cfg = jget_arch("smollm-135m").reduced()
    S = 2048
    jp = JB.init_layer(jax.random.key(0), cfg, "G")
    tp = tree_map(lambda t: t[None],
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    x = np.random.default_rng(2).standard_normal(
        (1, S, cfg.d_model)).astype(np.float32)
    ref = JB.apply_layer(cfg, "G", jp, jnp.asarray(x), jnp.arange(S))[0]
    calls = []
    real = TB.attention_flash
    monkeypatch.setattr(TB, "attention_flash",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    ours, _, _ = TB.apply_layer(get_arch("smollm-135m").reduced(), "G",
                                tp, torch.from_numpy(x)[None],
                                torch.arange(S))
    assert calls == [1]
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)


def test_seq_not_a_multiple_of_block_k_raises():
    """S = 2560 passes the dispatch (>= 2048, % 512 == 0) and fails the
    reference's assert S % block_k == 0: the port raises there too."""
    S = 2560
    jp, tp, x = setup(S, B=1)
    with pytest.raises(AssertionError):
        JC.attention_flash(jp, JC.AttnSpec(**SPEC), jnp.asarray(x),
                           jnp.arange(S))
    with pytest.raises(ValueError, match="block_k 1024"):
        TC.attention_flash(tp, TC.AttnSpec(**SPEC),
                           torch.from_numpy(x)[None], torch.arange(S))
    cfg = get_arch("smollm-135m").reduced()
    lp = tree_map(lambda t: t[None], TB.init_layer(
        torch.Generator().manual_seed(0), cfg, "G"))
    with pytest.raises(ValueError, match="block_k"):
        TB.apply_layer(cfg, "G", lp, torch.zeros((1, 1, S, cfg.d_model)),
                       torch.arange(S))
