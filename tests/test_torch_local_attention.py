"""The gemma family's attention features in the port (models/common.py,
models/model.py) against the reference's, on the same weights and inputs
made from a seed with numpy:

* ``sliding_mask``, exactly;
* ``attention_dense`` under the sliding mask, ``attention_flash`` at
  S = 2048 with window 16 and ``attention_decode`` with a window over
  positions past it (the port slices the cache where the reference masks
  it), each with and without a score softcap;
* scaled embeddings and the softcapped ``unembed`` through a whole reduced
  gemma3-1b with ``attn_softcap=50.0, logit_softcap=30.0`` (no config of
  the ten sets a softcap, so only these tests reach them).

Tolerances: rtol 1e-5 / atol 1e-5 for the dense and decode forms and the
model's logits, rtol 2e-4 / atol 2e-5 for ``attention_flash`` (that of
tests/test_torch_attention_flash.py: online-softmax sums in block order).
Each softcap case also checks that the cap changed the result by ten times
the tolerance or more, so a dropped cap would fail.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.models import common as JC
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import tree_map
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from _torch_threads import one_torch_thread  # noqa: F401

SPEC = dict(d_model=64, n_heads=4, n_kv_heads=2, head_dim=16)
WINDOW = 16
CAPS = [None, 2.0]
TOL = dict(rtol=1e-5, atol=1e-5)


def setup(S, seed=0, B=2):
    jp = JC.init_attention(jax.random.key(seed), JC.AttnSpec(**SPEC))
    tp = tree_map(lambda t: t[None],
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    x = np.random.default_rng(seed + 1).standard_normal(
        (B, S, 64)).astype(np.float32)
    return jp, tp, x


def specs(cap):
    return JC.AttnSpec(**SPEC, softcap=cap), TC.AttnSpec(**SPEC, softcap=cap)


def test_sliding_mask_matches_reference():
    q = np.arange(40)
    for window in (1, 5, 16, 64):
        ref = np.asarray(JC.sliding_mask(jnp.asarray(q), jnp.asarray(q),
                                         window))
        ours = TC.sliding_mask(torch.from_numpy(q), torch.from_numpy(q),
                               window)
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert ours.sum() == sum(min(i + 1, window) for i in range(40))


@pytest.mark.parametrize("cap", CAPS)
def test_dense_sliding_attention_matches_reference(cap):
    S = 48
    jp, tp, x = setup(S)
    jspec, tspec = specs(cap)
    pos = np.arange(S)
    jmask = JC.sliding_mask(jnp.asarray(pos), jnp.asarray(pos), WINDOW)
    ref = JC.attention_dense(jp, jspec, jnp.asarray(x), jnp.asarray(pos),
                             jmask)
    tmask = TC.sliding_mask(torch.from_numpy(pos), torch.from_numpy(pos),
                            WINDOW)
    ours = TC.attention_dense(tp, tspec, torch.from_numpy(x)[None],
                              torch.from_numpy(pos), tmask)[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
    if cap:
        uncapped = TC.attention_dense(tp, specs(None)[1],
                                      torch.from_numpy(x)[None],
                                      torch.from_numpy(pos), tmask)[0]
        assert float((uncapped - ours).abs().max()) > 1e-2


@pytest.mark.parametrize("cap", CAPS)
def test_flash_sliding_attention_at_2048_matches_reference(cap):
    S = 2048
    jp, tp, x = setup(S, seed=2, B=1)
    jspec, tspec = specs(cap)
    ref = JC.attention_flash(jp, jspec, jnp.asarray(x), jnp.arange(S),
                             window=WINDOW)
    ours = TC.attention_flash(tp, tspec, torch.from_numpy(x)[None],
                              torch.arange(S), window=WINDOW)[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=2e-4,
                               atol=2e-5)
    if cap:
        uncapped = TC.attention_flash(tp, specs(None)[1],
                                      torch.from_numpy(x)[None],
                                      torch.arange(S), window=WINDOW)[0]
        assert float((uncapped - ours).abs().max()) > 1e-2


@pytest.mark.parametrize("cap", CAPS)
def test_windowed_decode_matches_reference(cap):
    """Decode steps at positions 0..2*WINDOW+3 against a bf16 cache: the
    port reads the cache's last WINDOW positions, the reference all of
    them under its -1e30 mask; outputs and the caches after each step."""
    S_max, steps = 2 * WINDOW + 8, 2 * WINDOW + 4
    jp, tp, x = setup(S_max, seed=4)
    jspec, tspec = specs(cap)
    jcache = JC.init_kv_cache(2, S_max, SPEC["n_kv_heads"],
                              SPEC["head_dim"])
    tcache = tree_map(lambda t: t[None], TC.init_kv_cache(
        2, S_max, SPEC["n_kv_heads"], SPEC["head_dim"]))
    jstep = jax.jit(lambda p, xx, pos, c: JC.attention_decode(
        p, jspec, xx, pos, c, window=WINDOW))
    for pos in range(steps):
        ref, jcache = jstep(jp, jnp.asarray(x[:, pos:pos + 1]),
                            jnp.int32(pos), jcache)
        ours = TC.attention_decode(tp, tspec, torch.from_numpy(
            x[:, pos:pos + 1])[None], pos, tcache, window=WINDOW)[0]
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **TOL)
        for n in ("k", "v"):
            np.testing.assert_array_equal(
                tcache[n][0].float().numpy(),
                np.asarray(jcache[n].astype(jnp.float32)))
    if cap:     # the last step's scores, uncapped, give another output
        cache = tree_map(lambda t: t.clone(), tcache)
        uncapped = TC.attention_decode(tp, specs(None)[1], torch.from_numpy(
            x[:, steps - 1:steps])[None], steps - 1, cache,
            window=WINDOW)[0]
        assert float((uncapped - ours).abs().max()) > 1e-2


def test_scaled_embeddings_and_softcaps_through_the_model():
    """Reduced gemma3-1b with both softcaps set: embed_tokens scales by
    sqrt(d_model), the logits are softcapped, and the forward's logits
    match the reference's."""
    jcfg = dataclasses.replace(jget_arch("gemma3-1b").reduced(),
                               attn_softcap=50.0, logit_softcap=30.0)
    tcfg = dataclasses.replace(get_arch("gemma3-1b").reduced(),
                               attn_softcap=50.0, logit_softcap=30.0)
    jp = JM.init_model(jcfg, jax.random.key(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp))
    tokens = np.random.default_rng(0).integers(
        0, jcfg.vocab, (2, 24)).astype(np.int32)
    emb = TM.embed_tokens(tcfg, tree_map(lambda t: t[None], tp),
                          torch.from_numpy(tokens)[None])[0]
    np.testing.assert_allclose(emb.numpy(), np.asarray(JM.embed_tokens(
        jcfg, jp, jnp.asarray(tokens))), **TOL)
    np.testing.assert_allclose(
        emb.numpy(), tp["embed"][tokens].numpy() * np.sqrt(jcfg.d_model),
        rtol=1e-6)
    ref = np.asarray(JM.forward(jcfg, jp, {"tokens": jnp.asarray(tokens)},
                                remat=False)[0])
    ours = TM.forward(tcfg, tp, {"tokens": torch.from_numpy(tokens)})
    np.testing.assert_allclose(ours.detach().numpy(), ref, **TOL)
    live = ours[..., :jcfg.vocab]
    assert float(live.abs().max()) < 30.0
    uncapped = TM.forward(get_arch("gemma3-1b").reduced(), tp,
                          {"tokens": torch.from_numpy(tokens)})
    assert float((uncapped - ours).abs().max()) > 1e-4   # 10x the tol
