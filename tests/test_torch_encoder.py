"""whisper-tiny's encoder-decoder in the port (models/common.py LayerNorm,
models/mlp.py the plain MLP, models/blocks.py the 'E' layer and
cross-attention, models/model.py the encoder and sinusoidal positions)
against the reference's, on the same weights and inputs made from a seed
with numpy, reduced (2 decoder and 2 encoder layers, d_model 256, 32
frames):

* ``layernorm`` (the population variance), the non-GLU MLP with its
  biases, ``sinusoidal``, ``run_encoder``, and the cross-attention of the
  full sequence and of one decode step against the bf16 cache, each with
  the worker axis at W = 2;
* the reference's 'E' layer at seq 2048 routes into the causal
  ``attention_flash`` (no config reaches it: whisper's encoder_seq is
  1500); the port keeps that branch;
* the forward, loss and gradients, 3 pipelined int8 steps and one CLI
  step of the whole reduced arch (tests/_torch_frontend_cases.py);
* a param tree saved by either package restores in the other, leaf for
  leaf.

Tolerances: rtol 1e-5 / atol 1e-5 for the pieces (2e-4 / 2e-5 for
``attention_flash``, as tests/test_torch_attention_flash.py holds it);
the whole arch's as _torch_frontend_cases.py states.
"""
import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_frontend_cases import (check_forward_loss_and_gradients,
                                   check_pipelined_int8)
from repro.configs.registry import get_arch as jget_arch
from repro.models import blocks as JB
from repro.models import common as JC
from repro.models import mlp as JMLP
from repro.models import model as JM
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core.tree import flatten_sorted, tree_map
from repro_torch.launch import train as ttrain
from repro_torch.models import blocks as TB
from repro_torch.models import common as TC
from repro_torch.models import mlp as TMLP
from repro_torch.models import model as TM
from _torch_threads import one_torch_thread  # noqa: F401

ARCH = "whisper-tiny"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def ref():
    """The reduced config of both packages, the reference's params, and
    the port's with a worker axis of 2 (both workers the same)."""
    cfg = jget_arch(ARCH).reduced()
    jp = JM.init_model(cfg, jax.random.key(0))
    tp = tree_map(lambda t: t.expand((2,) + tuple(t.shape)),
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    return cfg, get_arch(ARCH).reduced(), jp, tp


def randn(shape, seed, scale=1.0):
    return (scale * np.random.default_rng(seed).standard_normal(shape)) \
        .astype(np.float32)


def per_worker_ref(fn, x):
    """The reference's ``fn`` on each worker's slice of x (W, ...)."""
    return np.stack([np.asarray(fn(jnp.asarray(x[w])))
                     for w in range(x.shape[0])])


def test_reduced_config_and_layout():
    cfg = get_arch(ARCH).reduced()
    assert (cfg.n_layers, cfg.encoder_layers, cfg.encoder_seq,
            cfg.norm_type, cfg.glu_mlp, cfg.use_rope) == \
        (2, 2, 32, "layernorm", False, False)
    params = TM.init_model(cfg, 0, device="cpu")
    enc = params["encoder"]["scan"]
    assert sorted(enc) == ["attn", "ln1", "ln2", "mlp"]     # no cross
    assert enc["attn"]["wq"].shape == (2, 256, 4, 64)
    assert sorted(enc["ln1"]) == ["bias", "scale"]
    assert sorted(params["scan"]["pos0"]["mlp"]) == ["down", "down_b",
                                                     "up", "up_b"]
    assert torch.equal(params["final_norm"]["scale"], torch.ones(256))


def test_every_reference_arch_is_supported():
    from repro_torch.configs.registry import ARCHS
    assert len(ARCHS) == 10
    for cfg in ARCHS.values():
        TB.check_supported(cfg)
        TB.check_supported(cfg.reduced())


def test_layernorm_matches_reference():
    """Random scales and biases per worker; the input's mean far from 0,
    so a Bessel-corrected variance or a variance taken about 0 would
    fail."""
    D = 64
    scale, bias = randn((2, D), 0), randn((2, D), 1)
    x = randn((2, 3, 5, D), 2) + 4.0
    ours = TC.layernorm({"scale": torch.from_numpy(scale),
                         "bias": torch.from_numpy(bias)}, torch.from_numpy(x))
    for w in range(2):
        want = JC.layernorm({"scale": jnp.asarray(scale[w]),
                             "bias": jnp.asarray(bias[w])}, jnp.asarray(x[w]))
        np.testing.assert_allclose(ours[w].numpy(), np.asarray(want), **TOL)
    init = TC.init_layernorm(D)
    assert torch.equal(init["scale"], torch.ones(D)) and \
        torch.equal(init["bias"], torch.zeros(D))


def test_nonglu_mlp_matches_reference():
    jp = JMLP.init_mlp_nonglu(jax.random.key(0), 32, 96)
    pnp = {n: randn((2,) + np.shape(v), i + 3, 0.2) + np.asarray(v)
           for i, (n, v) in enumerate(sorted(jp.items()))}
    x = randn((2, 3, 7, 32), 9)
    ours = TMLP.apply_mlp_nonglu(params_from_numpy(pnp), torch.from_numpy(x),
                                 "gelu")
    for w in range(2):
        want = JMLP.apply_mlp_nonglu(
            {n: jnp.asarray(v[w]) for n, v in pnp.items()},
            jnp.asarray(x[w]), "gelu")
        np.testing.assert_allclose(ours[w].numpy(), np.asarray(want), **TOL)
    shapes = {n: tuple(v.shape) for n, v in
              TMLP.init_mlp_nonglu(torch.Generator(), 32, 96).items()}
    assert shapes == {n: v.shape for n, v in jp.items()}


def test_sinusoidal_matches_reference():
    """Within 1e-5 of the largest magnitude (1): at angles up to 1500 rad
    the two libraries' f32 pow and sin differ by a few ulps of the
    angle."""
    for seq, d in ((1500, 384), (448, 384), (37, 256)):
        np.testing.assert_allclose(TM.sinusoidal(seq, d).numpy(),
                                   np.asarray(JM.sinusoidal(seq, d)),
                                   rtol=0, atol=1e-5)


def test_run_encoder_matches_reference(ref):
    cfg, tcfg, jp, tp = ref
    frames = randn((2, 2, cfg.encoder_seq, cfg.d_model), 4, 0.1)
    ours = TM.run_encoder(tcfg, tp, torch.from_numpy(frames))
    want = per_worker_ref(lambda f: JM.run_encoder(cfg, jp, f), frames)
    np.testing.assert_allclose(ours.numpy(), want, **TOL)


def test_cross_attention_matches_reference(ref):
    """``_cross_full`` on a 9-token decoder input against 32 encoder
    positions, and ``_cross_decode`` of one token against the bf16 cache
    the port's prefill would hold."""
    cfg, tcfg, jp, tp = ref
    jc = jp["scan"]["pos0"]["cross"]
    jc = jax.tree.map(lambda v: v[0], jc)         # the first layer's
    tc = tree_map(lambda v: v[:, 0], tp["scan"]["pos0"]["cross"])
    x = randn((2, 2, 9, cfg.d_model), 5)
    enc = randn((2, 2, cfg.encoder_seq, cfg.d_model), 6)
    ours, k, v = TB._cross_full(tcfg, tc, torch.from_numpy(x),
                                torch.from_numpy(enc))
    for w in range(2):
        want = JB._cross_full(cfg, jc, jnp.asarray(x[w]),
                              jnp.asarray(enc[w]))
        np.testing.assert_allclose(ours[w].numpy(), np.asarray(want), **TOL)
    cache = {"cross_k": k.to(torch.bfloat16), "cross_v": v.to(torch.bfloat16)}
    ours = TB._cross_decode(tcfg, tc, torch.from_numpy(x[:, :, :1]), cache)
    for w in range(2):
        jcache = {n: jnp.asarray(c[w].float().numpy()).astype(jnp.bfloat16)
                  for n, c in cache.items()}
        want = JB._cross_decode(cfg, jc, jnp.asarray(x[w, :, :1]), jcache)
        np.testing.assert_allclose(ours[w].numpy(), np.asarray(want), **TOL)


@contextlib.contextmanager
def flash_calls():
    real, calls = TB.attention_flash, []

    def counted(*a, **k):
        calls.append(k)
        return real(*a, **k)

    TB.attention_flash = counted
    try:
        yield calls
    finally:
        TB.attention_flash = real


def test_encoder_layer_at_2048_takes_causal_flash():
    """The reference's ``_attend_full`` sends an 'E' layer at seq >= 2048
    (seq % 512 == 0) to the causal ``attention_flash`` with prefix_len 0,
    before its all-ones encoder mask is reached.  The port keeps the
    branch: its output matches the reference's at tiny width, the call is
    made without a window and with prefix_len 0, and the first position's
    output does not see the last frame (bitwise)."""
    small = dict(d_model=32, n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64)
    cfg = dataclasses.replace(jget_arch(ARCH).reduced(), **small)
    tcfg = dataclasses.replace(get_arch(ARCH).reduced(), **small)
    jp = JB.init_layer(jax.random.key(3), cfg, "E", is_decoder=False)
    tp = tree_map(lambda t: t[None],
                  params_from_numpy(jax.tree.map(np.asarray, jp)))
    S = 2048
    x = randn((1, S, 32), 7)
    want, _, _ = JB.apply_layer(cfg, "E", jp, jnp.asarray(x),
                                jnp.arange(S)[None])
    with flash_calls() as calls:
        ours = TB.apply_layer(tcfg, "E", tp, torch.from_numpy(x)[None],
                              torch.arange(S))[0]
    assert calls == [{"window": None, "prefix_len": 0}]
    np.testing.assert_allclose(ours[0].numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-5)
    x2 = x.copy()
    x2[:, -1] += 1.0
    moved = TB.apply_layer(tcfg, "E", tp, torch.from_numpy(x2)[None],
                           torch.arange(S))[0]
    assert torch.equal(moved[0, :, :512], ours[0, :, :512])
    assert not torch.equal(moved[0, :, -1], ours[0, :, -1])


def test_forward_loss_and_gradients_match_reference():
    logits = check_forward_loss_and_gradients(ARCH)
    assert logits.shape[2] == 32           # the text positions only


def test_pipelined_int8_matches_reference():
    assert len(check_pipelined_int8(ARCH)) == 3


def test_train_cli_on_cpu():
    out = ttrain.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--workers", "2", "--pipelined", "--wire-format",
                       "int8", "--steps", "1", "--seq", "32"])
    assert len(out["losses"]) == 1 and np.isfinite(out["losses"]).all()
    enc = out["params"]["encoder"]["scan"]["attn"]["wq"]
    assert enc.shape == (2, 2, 256, 4, 64)


def test_param_checkpoints_restore_across_packages(ref, tmp_path):
    """Reduced whisper's param tree (the encoder, cross-attention,
    LayerNorm and the MLP biases included): the port's file restores in
    the reference leaf for leaf, and the reference's in the port."""
    pytest.importorskip("msgpack")
    from repro.checkpoint.checkpoint import load_checkpoint as jload
    from repro.checkpoint.checkpoint import save_checkpoint as jsave
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    cfg, tcfg, jp, _ = ref
    ours = TM.init_model(tcfg, 5, device="cpu")
    save_checkpoint(tmp_path / "port.msgpack", ours)
    back = jload(tmp_path / "port.msgpack", jp)
    tl, jl = flatten_sorted(ours)[0], jax.tree.leaves(back)
    assert len(tl) == len(jl) == len(jax.tree.leaves(jp))
    for a, b in zip(tl, jl):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jsave(tmp_path / "ref.msgpack", jp)
    mine = load_checkpoint(tmp_path / "ref.msgpack", ours)
    for a, b in zip(flatten_sorted(mine)[0], jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
