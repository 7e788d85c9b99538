"""The whole slice — pipelined int8-wire ASGD training of smollm-135m
(reduced: 2 layers, d_model 256, R=2624) — through the port against the
reference's jitted train step, on the same weights, batches and gossip
draws; plus the port's CLI trainer and its inner optimizers.

Tolerances: losses within rel 1e-4 and the ensemble within atol 1e-4 over
3 steps (f32 forward/backward sums in different orders compound over the
steps); the admitted-message count n_good exactly.  Adam is held to the
reference step by step in test_optimizers_and_lr_schedule_match_reference
only: its update divides by sqrt(v) + 1e-8, so on gradients near 1e-8 it
amplifies last-bit differences into O(lr) ones.
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
from repro.data.synthetic import lm_batch_iterator
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import model as JM
from repro.optim import optimizers as jopt
from repro_torch.configs.registry import get_arch
from repro_torch.convert import params_from_numpy
from repro_torch.core import asgd as tasgd
from repro_torch.core import gossip as tg
from repro_torch.core.packing import pack_spec_w, pack_w
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import init_inner_state, make_train_step
from repro_torch.optim import optimizers as topt

from _torch_threads import one_torch_thread  # noqa: F401

W, BATCH, SEQ, STEPS = 4, 2, 32, 3


def jax_draws(key, cfg):
    k_shift, k_blk = jax.random.split(key)
    return (int(jax.random.randint(k_shift, (), 0, len(cfg.shifts))),
            int(jax.random.randint(k_blk, (), 0, cfg.partial_blocks)))


@functools.lru_cache
def reference_init(seed):
    """The reference's reduced smollm-135m params from ``seed``, made once
    for every case that starts from them (jax arrays are immutable)."""
    return JM.init_model(jget_arch("smollm-135m").reduced(),
                         jax.random.key(seed))


@pytest.mark.parametrize("inner", ["sgd", "momentum"])
def test_pipelined_int8_slice_matches_reference(inner):
    cfg = jget_arch("smollm-135m").reduced()
    key = jax.random.key(0)
    params = reference_init(0)
    # workers start from one model, as the trainers do
    wnp = jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (W,) + x.shape).copy(),
        params)
    kw = dict(shifts=(1, 2), partial_blocks=4, delay=1, wire_format="int8")
    jcfg, tcfg = jg.GossipConfig(**kw), tg.GossipConfig(**kw)
    jacfg, tacfg = jasgd.ASGDConfig(eps=0.05), tasgd.ASGDConfig(eps=0.05)

    jw = jax.tree.map(jnp.asarray, wnp)
    jspec = jpack_spec_w(jw, block_rows=64, groups=jg.leaf_groups(jw, 4),
                         n_groups=4)
    jpk = jpack_w(jw, jspec)
    jstate = jg.init_pipelined_gossip_state(jpk, jcfg, block_rows=64)
    from repro.launch.steps import init_inner_state as jinit_inner
    jopt_state = jinit_inner(jpk, inner)
    jstep = jax.jit(jmake_train_step(cfg, gcfg=jcfg, acfg=jacfg, inner=inner,
                                     packed_resident=True, pack_spec=jspec,
                                     pipelined=True))

    tw = params_from_numpy(wnp)
    tspec = pack_spec_w(tw, block_rows=64, groups=tg.leaf_groups(tw, 4),
                        n_groups=4)
    tpk = pack_w(tw, tspec)
    tstate = tg.init_pipelined_gossip_state(tpk, tcfg, block_rows=64)
    topt_state = init_inner_state(tpk, inner)
    tstep = make_train_step(get_arch("smollm-135m").reduced(),
                            pack_spec=tspec, inner=inner, gcfg=tcfg,
                            acfg=tacfg, pipelined=True)

    its = [lm_batch_iterator(w, BATCH, SEQ, cfg.vocab) for w in range(W)]
    for step in range(STEPS):
        tokens = np.stack([next(it)["tokens"] for it in its])
        k = jax.random.fold_in(key, step)
        jpk, jstate, jopt_state, jm = jstep(
            jpk, jstate, jopt_state, {"tokens": jnp.asarray(tokens)}, k)
        tpk, tstate, topt_state, tm = tstep(
            tpk, tstate, topt_state, {"tokens": torch.from_numpy(tokens)},
            *jax_draws(k, jcfg))
        ref = float(jm["loss"])
        assert abs(float(tm["loss"]) - ref) <= 1e-4 * abs(ref)
        assert float(tm["n_good"]) == float(jm["n_good"])
        np.testing.assert_array_equal(tm["gate"].numpy(),
                                      np.asarray(jm["gate"]))
        np.testing.assert_allclose(tpk.numpy(), np.asarray(jpk), rtol=0,
                                   atol=1e-4)
    assert tstate.step == STEPS and len(tstate.buf) == 2


def test_cli_trains_on_cpu_when_asked():
    out = ttrain.main(["--arch", "smollm-135m", "--reduced", "--device",
                       "cpu", "--workers", "4", "--pipelined",
                       "--wire-format", "int8", "--steps", "3", "--seq",
                       "32", "--log-every", "100"])
    assert len(out["losses"]) == 3 and np.isfinite(out["losses"]).all()
    assert len(out["n_good"]) == 3 and len(out["step_seconds"]) == 3
    wq = out["params"]["scan"]["pos0"]["attn"]["wq"]
    assert wq.shape == (4, 2, 256, 4, 64)
    assert torch.equal(wq[0], wq[3])     # the worker average


def test_cli_requires_cuda_unless_cpu_is_asked():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "smollm-135m", "--reduced", "--pipelined",
                     "--steps", "1"])


@pytest.mark.parametrize("flags,match", [
    (["--elastic"], "elastic"),
    (["--save", "x.msgpack"], "save"),
    (["--pipelined", "--elastic"], "elastic"),
    (["--pipelined", "--save", "x.msgpack"], "save"),
    (["--pipelined", "--restore", "x.msgpack"], "restore"),
])
def test_cli_options_not_ported_raise(flags, match, tmp_path, monkeypatch,
                                      capsys):
    """--elastic, --save and --restore were the trainer's unported flags;
    they now run (test_torch_checkpoint.py holds them to the reference):
    each takes one step on the CPU and does what it names."""
    monkeypatch.chdir(tmp_path)
    base = ["--arch", "smollm-135m", "--reduced", "--device", "cpu",
            "--seq", "32"]
    if match == "restore":
        ttrain.main(base + ["--pipelined", "--steps", "1", "--save",
                            "x.msgpack"])
    out = ttrain.main(base + ["--steps", "2" if match == "restore" else "1",
                              *flags])
    assert len(out["losses"]) == 1
    log = capsys.readouterr().out
    if match == "elastic":
        gossip = out["state"]["gossip"]
        assert gossip.buf_live is not None
    elif match == "save":
        assert (tmp_path / "x.msgpack").is_file()
        assert "saved -> x.msgpack" in log
    else:
        assert "restored step=1 from x.msgpack (re-packed)" in log


def test_cli_pipelined_sync_is_refused():
    with pytest.raises(ValueError, match="pipelined=True requires algo"):
        ttrain.main(["--arch", "smollm-135m", "--reduced", "--device", "cpu",
                     "--steps", "1", "--pipelined", "--algo", "sync"])


def test_silent_packed_step_is_local_sgd():
    cfg = get_arch("smollm-135m").reduced()
    params = params_from_numpy(jax.tree.map(
        lambda x: np.broadcast_to(np.asarray(x), (2,) + x.shape).copy(),
        reference_init(1)))
    spec = pack_spec_w(params, block_rows=64)
    packed = pack_w(params, spec)
    gcfg = tg.GossipConfig(shifts=(1,), partial_mode="rows")
    step = make_train_step(cfg, pack_spec=spec, algo="silent", gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=0.05))
    tokens = torch.randint(0, cfg.vocab, (2, 1, 16),
                           generator=torch.Generator().manual_seed(0))
    from repro_torch.launch.steps import packed_loss_and_grad
    _, g = packed_loss_and_grad(cfg, packed, {"tokens": tokens}, spec)
    state = tg.init_packed_gossip_state(packed, gcfg)
    new, state2, _, m = step(packed, state, 0, {"tokens": tokens}, 0, 0)
    assert torch.equal(new, packed - 0.05 * g) and state2 is state
    # sync on the packed engine: every worker steps with the worker mean
    sync = make_train_step(cfg, pack_spec=spec, algo="sync", gcfg=gcfg,
                           acfg=tasgd.ASGDConfig(eps=0.05))
    new, state2, _, m = sync(packed, state, 0, {"tokens": tokens}, 0, 0)
    assert torch.equal(new, packed - 0.05 * g.mean(dim=0, keepdim=True))
    assert state2 is state and "n_good" not in m


def test_optimizers_and_lr_schedule_match_reference():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 7)).astype(np.float32)
    grads = [rng.standard_normal((3, 7)).astype(np.float32) for _ in range(3)]
    jw, js = jnp.asarray(w), jopt.adam_init(jnp.asarray(w))
    tw, ts = torch.from_numpy(w), topt.adam_init(torch.from_numpy(w))
    jm, tm = jnp.asarray(w), torch.from_numpy(w)
    jms, tms = jopt.momentum_init(jm), topt.momentum_init(tm)
    for g in grads:
        jw, js = jopt.adam_update(jw, jnp.asarray(g), js, 0.01)
        tw, ts = topt.adam_update(tw, torch.from_numpy(g), ts, 0.01)
        jm, jms = jopt.momentum_update(jm, jnp.asarray(g), jms, 0.01)
        tm, tms = topt.momentum_update(tm, torch.from_numpy(g), tms, 0.01)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        topt.sgd_update(torch.from_numpy(w), torch.from_numpy(grads[0]),
                        0.01).numpy(),
        np.asarray(jopt.sgd_update(jnp.asarray(w), jnp.asarray(grads[0]),
                                   0.01)))
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)
    for kind in ("const", "cosine", "linear"):
        jf = jopt.lr_schedule(kind, 0.05, warmup=3, total=10)
        tf = topt.lr_schedule(kind, 0.05, warmup=3, total=10)
        for s in range(12):
            assert tf(s) == pytest.approx(float(jf(jnp.int32(s))), rel=1e-6)


def run_example(module, argv, monkeypatch, capsys):
    """Run an example's main with its trainer replaced by a recorder that
    returns the same made-up losses for every run; returns (the trainer
    argv lists, the summary it printed)."""
    calls = []

    def train_main(a):
        calls.append(list(a))
        losses = [3.0, 2.5, 2.25, 2.0]
        return losses if module.__name__ == "ref_train_lm" else {
            "losses": losses}
    monkeypatch.setattr(module, "train_main", train_main)
    capsys.readouterr()
    if argv is None:
        module.main()
    else:
        module.main(argv)
    out = capsys.readouterr().out
    return calls, out[out.index("=== summary"):]


def test_train_lm_example_matches_reference_flags(monkeypatch, capsys):
    """examples/train_lm.py: the port's example gives the trainer the
    reference example's flags (plus --device) for asgd, silent and sync,
    and prints the same summary of the same losses."""
    import importlib.util
    import pathlib
    import sys

    from repro_torch.examples import train_lm

    path = pathlib.Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm.py"
    spec = importlib.util.spec_from_file_location("ref_train_lm", path)
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    for flags in ([], ["--full", "--steps", "7", "--workers", "3"]):
        monkeypatch.setattr(sys, "argv", ["train_lm.py"] + flags)
        ref_calls, ref_out = run_example(ref, None, monkeypatch, capsys)
        calls, out = run_example(train_lm, flags + ["--device", "cpu"],
                                 monkeypatch, capsys)
        assert [c[-1] for c in calls] == ["asgd", "silent", "sync"]
        for c in calls:
            i = c.index("--device")
            assert c[i + 1] == "cpu"
            del c[i:i + 2]
        assert calls == ref_calls
        assert out == ref_out


def test_train_lm_example_trains_reduced_on_cpu():
    from repro_torch.examples import train_lm
    losses = train_lm.main(["--steps", "2", "--device", "cpu"])
    assert set(losses) == {"asgd", "silent", "sync"}
    for ls in losses.values():
        assert len(ls) == 2 and np.isfinite(ls).all()
    assert losses["asgd"][-1] < losses["asgd"][0]
