"""The port's dense model (repro_torch.models) against the reference's on
JAX-initialized weights carried over with repro_torch.convert: the loss
within rel 1e-5 and the packed gradient — born packed through unpack_rows
views — within atol 1e-5 (f32 matmuls summed in different orders)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jget_arch
from repro.core.gossip import leaf_groups as jleaf_groups
from repro.core.packing import pack_spec_w as jpack_spec_w
from repro.core.packing import pack_w as jpack_w
from repro.core.packing import unpack_rows as junpack_rows
from repro.data.synthetic import synthetic_lm_batch
from repro.models import model as JM
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy, params_to_numpy
from repro_torch.core.gossip import leaf_groups
from repro_torch.core.packing import pack_spec_w, pack_w
from repro_torch.core.tree import flatten_sorted, tree_map
from repro_torch.launch.steps import packed_loss_and_grad
from repro_torch.models import model as TM
from _torch_threads import one_torch_thread  # noqa: F401

W = 2


def reference_setup(seed=0, batch=2, seq=32, arch="smollm-135m"):
    cfg = jget_arch(arch).reduced()
    params = JM.init_model(cfg, jax.random.key(seed))
    rng = np.random.default_rng(seed)
    tokens = np.stack([synthetic_lm_batch(rng, batch, seq, cfg.vocab)
                       ["tokens"] for _ in range(W)])
    return cfg, params, tokens


def test_configs_are_the_reference_configs():
    from repro.configs.registry import ARCHS as JARCHS
    assert sorted(TARCHS) == sorted(JARCHS)
    for name, cfg in JARCHS.items():
        assert repr(TARCHS[name]) == repr(cfg)
    full = get_arch("smollm-135m")
    assert (full.n_layers, full.d_model, full.n_heads, full.n_kv_heads,
            full.d_ff, full.vocab) == (30, 576, 9, 3, 1536, 49152)
    # the analytic count leaves out the final norm's d_model scales
    assert full.param_count() + full.d_model == 134_515_008


def test_init_model_matches_reference_layout():
    cfg = get_arch("smollm-135m").reduced()
    jshapes = jax.eval_shape(lambda: JM.init_model(cfg, jax.random.key(0)))
    params = TM.init_model(cfg, 0, device="cpu")
    jl, tl = jax.tree.leaves(jshapes), flatten_sorted(params)[0]
    assert [tuple(s.shape) for s in jl] == [tuple(t.shape) for t in tl]
    assert params["scan"]["pos0"]["attn"]["wq"].shape == (2, 256, 4, 64)
    assert params["tail"] == {}
    again = TM.init_model(cfg, 0, device="cpu")
    assert all(torch.equal(a, b) for a, b in
               zip(tl, flatten_sorted(again)[0]))


@pytest.mark.parametrize("arch", [
    "smollm-135m",        # the slice: tied embeddings, GQA
    "qwen2.5-14b",        # + QKV bias, untied head
    "qwen3-14b",          # + per-head qk RMSNorm
])
def test_loss_matches_reference(arch):
    cfg, params, tokens = reference_setup(arch=arch)
    ref = float(JM.loss_fn(cfg, params, {"tokens": jnp.asarray(tokens[0])},
                           remat=False))
    tparams = params_from_numpy(jax.tree.map(np.asarray, params))
    ours = float(TM.loss_fn(get_arch(arch).reduced(), tparams,
                            {"tokens": torch.from_numpy(tokens[0])}))
    assert abs(ours - ref) <= 1e-5 * abs(ref)
    logits = TM.forward(get_arch(arch).reduced(), tparams,
                        {"tokens": torch.from_numpy(tokens[0])})
    np.testing.assert_allclose(
        logits.detach().numpy(),
        np.asarray(JM.forward(cfg, params, {"tokens": jnp.asarray(tokens[0])},
                              remat=False)[0]), rtol=0, atol=1e-4)
    back = params_to_numpy(tparams)
    for a, b in zip(jax.tree.leaves(params), flatten_sorted(back)[0]):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_packed_grad_matches_reference():
    """d(loss)/d(packed rows) per worker: the reference's jax.grad through
    its unpack_rows views vs the port's one backward through its views."""
    cfg, params, tokens = reference_setup(seed=1)
    rng = np.random.default_rng(1)
    wparams = jax.tree.map(
        lambda x: (np.asarray(x)[None]
                   + 0.01 * rng.standard_normal((W,) + x.shape))
        .astype(np.float32), params)
    jw = jax.tree.map(jnp.asarray, wparams)
    jspec = jpack_spec_w(jw, block_rows=64, groups=jleaf_groups(jw, 4),
                         n_groups=4)
    jpacked = jpack_w(jw, jspec)
    ref_loss, ref_grad = [], []
    for w in range(W):
        loss, g = jax.value_and_grad(lambda rows: JM.loss_fn(
            cfg, junpack_rows(rows, jspec),
            {"tokens": jnp.asarray(tokens[w])}, remat=False))(jpacked[w])
        ref_loss.append(float(loss))
        ref_grad.append(np.asarray(g))
    tw = params_from_numpy(wparams)
    tspec = pack_spec_w(tw, block_rows=64, groups=leaf_groups(tw, 4),
                        n_groups=4)
    tpacked = pack_w(tw, tspec)
    losses, pgrad = packed_loss_and_grad(
        get_arch("smollm-135m").reduced(), tpacked,
        {"tokens": torch.from_numpy(tokens)}, tspec)
    np.testing.assert_allclose(losses.numpy(), ref_loss, rtol=1e-5)
    assert pgrad.shape == tpacked.shape and not tpacked.requires_grad
    np.testing.assert_allclose(pgrad.numpy(), np.stack(ref_grad), rtol=0,
                               atol=1e-5)
    # the padding takes exactly zero gradient, as pack_w of a grad tree
    mask = pack_w(tree_map(torch.ones_like, tw), tspec) == 0
    assert not pgrad[mask].any()


def test_unsupported_features_raise():
    # the gemma family raised before 'L' and 'R' layers, scaled embeddings
    # and the softcaps were ported; both archs now initialize
    # (test_torch_train_gemma.py holds them to the reference)
    params = TM.init_model(get_arch("gemma3-1b").reduced(), 0, device="cpu")
    assert params["scan"]["pos0"]["attn"]["wq"].shape == (1, 256, 4, 64)
    params = TM.init_model(get_arch("recurrentgemma-9b").reduced(), 0,
                           device="cpu")
    assert params["scan"]["pos0"]["rglru"]["in_x"].shape == (1, 256, 256)
    # MoE raised before models/moe.py was ported; reduced granite-moe now
    # initializes (test_torch_train_moe.py holds it to the reference)
    params = TM.init_model(get_arch("granite-moe-1b-a400m").reduced(), 0,
                           device="cpu")
    assert params["scan"]["pos0"]["moe"]["router"].shape == (2, 256, 4)
    # paligemma-3b and whisper-tiny raised before the
    # prefix-LM and the encoder-decoder were ported; both now initialize,
    # in the reference's leaf layout (test_torch_prefix.py and
    # test_torch_encoder.py hold them to the reference)
    for arch in ("paligemma-3b", "whisper-tiny"):
        cfg = get_arch(arch).reduced()
        jshapes = jax.eval_shape(
            lambda: JM.init_model(cfg, jax.random.key(0)))
        params = TM.init_model(cfg, 0, device="cpu")
        assert [tuple(t.shape) for t in flatten_sorted(params)[0]] == \
            [tuple(x.shape) for x in jax.tree.leaves(jshapes)]
    assert sorted(params["encoder"]) == ["final_norm", "scan"]
    assert sorted(params["scan"]["pos0"]) == ["attn", "cross", "ln1",
                                              "ln2", "ln_cross", "mlp"]
    # a layer type no config has still raises, naming no queue item
    odd = dataclasses.replace(get_arch("smollm-135m").reduced(),
                              pattern_cycle=("X",))
    with pytest.raises(NotImplementedError, match="not ported$"):
        TM.init_model(odd, 0, device="cpu")
    # seq 2048 raised before attention_flash was ported; it now runs
    # (test_torch_attention_flash.py holds it to the reference)
    cfg = get_arch("smollm-135m").reduced()
    params = TM.init_model(cfg, 0, device="cpu")
    logits = TM.forward(cfg, params,
                        {"tokens": torch.zeros((1, 2048), dtype=torch.long)})
    assert logits.shape == (1, 2048, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all())
