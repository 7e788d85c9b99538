"""PaliGemma's prefix-LM in the port (models/common.py ``prefix_mask``,
the dense and the chunked attention under it, models/model.py's vision
prefix) against the reference's, on the same weights and inputs made from
a seed with numpy, reduced (2 'G' layers, d_model 256, 4 heads / 1 kv of
64, a prefix of 8 patches):

* ``prefix_mask``, exactly;
* ``attention_dense`` under the prefix mask, and ``attention_flash`` with
  ``prefix_len`` at S = 2048, tiny width, in its default blocks (the
  prefill path's), against the reference's;
* the patches enter unscaled before the scaled text embeddings;
* a 'G' layer at S = 2048 takes ``attention_flash`` with the prefix;
* the forward, loss and gradients, 3 pipelined int8 steps and one CLI
  step of the whole reduced arch (tests/_torch_frontend_cases.py).

Tolerances: rtol 1e-5 / atol 1e-5 for the dense form, rtol 2e-4 / atol
2e-5 for ``attention_flash`` (as tests/test_torch_attention_flash.py
holds it: online-softmax sums in block order); the whole arch's as
_torch_frontend_cases.py states.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_frontend_cases import (check_forward_loss_and_gradients,
                                   check_pipelined_int8, worker_batches)
from repro.configs.registry import get_arch as jget_arch
from repro.models import common as JC
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import tree_map
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import model as TM
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "paligemma-3b"
SPEC = dict(d_model=64, n_heads=4, n_kv_heads=1, head_dim=16)
TOL = dict(rtol=1e-5, atol=1e-5)
FLASH_TOL = dict(rtol=2e-4, atol=2e-5)


def setup(S, seed=0, B=2):
    jp = JC.init_attention(jax.random.key(seed), JC.AttnSpec(**SPEC))
    tp = tree_map(lambda t: t[None],
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    x = 0.5 * np.random.default_rng(seed + 1).standard_normal(
        (B, S, 64)).astype(np.float32)
    return jp, tp, x


def test_reduced_config():
    cfg = get_arch(ARCH).reduced()
    assert (cfg.prefix_len, cfg.frontend, cfg.n_kv_heads, cfg.glu_mlp,
            cfg.scale_embeddings) == (8, "vision", 1, True, True)
    assert get_arch(ARCH).prefix_len == 256


def test_prefix_mask_matches_reference():
    q = np.arange(40)
    for prefix in (0, 1, 8, 39, 60):
        ref = np.asarray(JC.prefix_mask(jnp.asarray(q), jnp.asarray(q),
                                        prefix))
        ours = TC.prefix_mask(torch.from_numpy(q), torch.from_numpy(q),
                              prefix)
        np.testing.assert_array_equal(ours.numpy(), ref)
        assert ours.sum() == sum(max(i + 1, min(prefix, 40))
                                 for i in range(40))


def test_dense_prefix_attention_matches_reference():
    S, prefix = 48, 13
    jp, tp, x = setup(S)
    pos = np.arange(S)
    ref = JC.attention_dense(
        jp, JC.AttnSpec(**SPEC), jnp.asarray(x), jnp.asarray(pos),
        JC.prefix_mask(jnp.asarray(pos), jnp.asarray(pos), prefix))
    ours = TC.attention_dense(
        tp, TC.AttnSpec(**SPEC), torch.from_numpy(x)[None],
        torch.from_numpy(pos),
        TC.prefix_mask(torch.from_numpy(pos), torch.from_numpy(pos), prefix))
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(ref), **TOL)
    causal = TC.attention_dense(
        tp, TC.AttnSpec(**SPEC), torch.from_numpy(x)[None],
        torch.from_numpy(pos),
        TC.causal_mask(torch.from_numpy(pos), torch.from_numpy(pos)))
    # the prefix's own rows now see its later keys; the rows after it see
    # every prefix key under either mask
    assert float((causal[0, :, :prefix] - ours[0, :, :prefix]).abs().max()) \
        > 1e-2
    torch.testing.assert_close(causal[0, :, prefix:], ours[0, :, prefix:])


@pytest.mark.parametrize("prefix", [8, 700])
def test_flash_prefix_at_2048_matches_reference(prefix):
    S = 2048
    jp, tp, x = setup(S, seed=2, B=1)
    ref = JC.attention_flash(jp, JC.AttnSpec(**SPEC), jnp.asarray(x),
                             jnp.arange(S), prefix_len=prefix)
    ours = TC.attention_flash(tp, TC.AttnSpec(**SPEC),
                              torch.from_numpy(x)[None], torch.arange(S),
                              prefix_len=prefix)[0]
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), **FLASH_TOL)


def test_patches_enter_unscaled():
    cfg = get_arch(ARCH).reduced()
    params = tree_map(lambda t: t[None], TM.init_model(cfg, 0, device="cpu"))
    b = {n: torch.from_numpy(v[:1]) for n, v in worker_batches(cfg).items()}
    x, positions, prefix, enc = TM._embed_inputs(cfg, params, b)
    assert prefix == 8 and enc is None
    assert x.shape == (1, 2, 8 + 32, 256) and torch.equal(
        positions, torch.arange(40))
    assert torch.equal(x[:, :, :8], b["patches"])
    text = params["embed"][0][b["tokens"][0].long()] * math.sqrt(256)
    assert torch.equal(x[0, :, 8:], text)


def test_g_layer_at_2048_takes_flash_with_the_prefix():
    cfg = get_arch(ARCH).reduced()
    params = TM.init_model(cfg, 0, device="cpu")
    layer = tree_map(lambda t: t[None, 0], params["scan"]["pos0"])
    x = torch.randn((1, 1, 2048, 256), generator=torch.Generator()
                    .manual_seed(0))
    real, calls = TB.attention_flash, []

    def counted(*a, **k):
        calls.append(k)
        return real(*a, **k)

    TB.attention_flash = counted
    try:
        y = TB.apply_layer(cfg, "G", layer, x, torch.arange(2048),
                           prefix_len=8)[0]
    finally:
        TB.attention_flash = real
    assert calls == [{"window": None, "prefix_len": 8}]
    assert bool(torch.isfinite(y).all())


def test_forward_loss_and_gradients_match_reference():
    logits = check_forward_loss_and_gradients(ARCH)
    assert logits.shape[2] == 8 + 32         # the prefix's positions too


def test_pipelined_int8_matches_reference():
    assert len(check_pipelined_int8(ARCH)) == 3


def test_train_cli_on_cpu():
    out = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--workers", "2", "--pipelined", "--wire-format",
                       "int8", "--steps", "1", "--seq", "32"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    assert out["params"]["scan"]["pos0"]["attn"]["wk"].shape == \
        (2, 2, 256, 1, 64)
