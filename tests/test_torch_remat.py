"""Rematerialized training, as the reference does it: models/model.py
``forward_w`` rematerializes each full cycle of the layer pattern
(``rematerialize``: the forward without a graph, rerun in backward) where
``remat`` is set, no cache is returned, ``cfg.remat_policy`` is not
'none' and grad is on.

* Where it rematerializes: once a full cycle under 'full' and 'dots', never
  under 'none', with ``remat=False``, with ``return_cache`` (the prefill)
  or under ``no_grad``; an unknown policy raises.
* The same numbers: for reduced smollm-135m, mamba2-370m (the SSD scan's
  Function, B5's plain twin on the CPU, rerun in backward),
  granite-moe-1b-a400m, recurrentgemma-9b ('dots'), whisper-tiny and
  paligemma-3b, the packed gradient with remat is bitwise the one
  without (the CPU recomputes the same values), and backward reran every
  cycle layer once.
* Less saved: the bytes that autograd saves (``saved_tensors_hooks``),
  the params aside, fall with remat, and grow with depth only by each
  cycle's inputs: no activation inside a layer is among them.
* The reference's fact behind 'dots' = 'full': its residuals under
  ``jax.vmap`` over the workers (its train step's form) are as many for
  'dots' as for 'full', while its unbatched ``loss_fn`` saves more under
  'dots' (jax 0.9, reduced qwen2.5-14b at 2 layers: 28 and 28 under the
  vmap, 28 and 34 unbatched).
* The dry-run: a reduced pair's traced peak falls with remat.

The port runs on one torch thread here (``one_thread``): with more, MKL
may pick another thread count per call on a loaded machine, and a sum in
another order differs in the last bit between any two runs.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import pytest
import torch
from jax.ad_checkpoint import print_saved_residuals

from repro.configs.registry import get_arch as jget_arch
from repro.models import model as JM
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_arch
from repro_torch.core.gossip import GossipConfig, leaf_groups
from repro_torch.core.packing import pack_spec_w, pack_w, unpack_w
from repro_torch.core.tree import tree_map
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import fake_process_group, make_host_mesh
from repro_torch.launch.serve import stub_inputs
from repro_torch.launch.steps import make_train_step, packed_loss_and_grad
from repro_torch.models import model as TM

W, BATCH, SEQ = 2, 2, 32
FAMILIES = ["smollm-135m", "mamba2-370m", "granite-moe-1b-a400m",
            "recurrentgemma-9b", "whisper-tiny", "paligemma-3b"]


def packed_case(arch, n_layers=None, seed=0):
    """(cfg, the packed W-worker ensemble, its spec, a seeded batch with
    the frontend's stub inputs) of reduced ``arch``."""
    cfg = get_arch(arch).reduced()
    if n_layers:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    g = torch.Generator().manual_seed(seed)
    wp = tree_map(lambda x: (x + 0.1 * torch.randn(
        (W,) + tuple(x.shape), generator=g)).contiguous(),
        TM.init_model(cfg, seed))
    spec = pack_spec_w(wp, groups=leaf_groups(wp, 2), n_groups=2)
    batch = {"tokens": torch.randint(0, cfg.vocab, (W, BATCH, SEQ),
                                     generator=g),
             **stub_inputs(cfg, (W, BATCH), g, "cpu")}
    return cfg, pack_w(wp, spec), spec, batch


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def counting(monkeypatch, name):
    """Counts the calls of models.model's ``name``."""
    calls = []
    real = getattr(TM, name)

    def wrapped(*a, **k):
        calls.append(a)
        return real(*a, **k)
    monkeypatch.setattr(TM, name, wrapped)
    yield calls
    monkeypatch.setattr(TM, name, real)


@pytest.mark.parametrize("policy,remat,cache,grad,want", [
    ("full", True, False, True, 2),
    ("dots", True, False, True, 2),
    ("none", True, False, True, 0),
    ("full", False, False, True, 0),
    ("full", True, True, True, 0),
    ("full", True, False, False, 0),
])
def test_checkpoints_each_full_cycle_where_the_reference_does(
        monkeypatch, policy, remat, cache, grad, want):
    """Reduced gemma3-1b at 13 layers: two full (5 'L', 'G') cycles and a
    tail of one, which stays outside the rematerialized cycles."""
    base = get_arch("gemma3-1b").reduced()
    cfg = dataclasses.replace(base, n_layers=13, remat_policy=policy)
    assert TM.cycle_structure(cfg)[1:] == (2, ("L",))
    params = TM.init_model(cfg, 0)
    tokens = torch.randint(0, cfg.vocab, (1, BATCH, SEQ),
                           generator=torch.Generator().manual_seed(0))
    wp = tree_map(lambda x: x[None], params)
    with counting(monkeypatch, "rematerialize") as calls, \
            torch.set_grad_enabled(grad):
        TM.forward_w(cfg, wp, {"tokens": tokens}, remat=remat,
                     return_cache=cache)
    assert len(calls) == want


def test_unknown_policy_raises():
    cfg = dataclasses.replace(get_arch("smollm-135m").reduced(),
                              remat_policy="everything")
    with pytest.raises(ValueError, match="remat_policy"):
        TM.loss_fn(cfg, TM.init_model(cfg, 0),
                   {"tokens": torch.zeros((1, 8), dtype=torch.int64)})


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_gradient_bitwise_equal(monkeypatch, arch):
    cfg, packed, spec, batch = packed_case(arch)
    with counting(monkeypatch, "apply_layer") as calls:
        losses, grad = packed_loss_and_grad(cfg, packed, batch, spec)
    n_remat = len(calls)
    with counting(monkeypatch, "apply_layer") as calls:
        losses0, grad0 = packed_loss_and_grad(cfg, packed, batch, spec,
                                              remat=False)
    cycle, n_full, _ = TM.cycle_structure(cfg)
    assert n_remat == len(calls) + n_full * len(cycle)
    assert torch.equal(losses, losses0)
    assert torch.equal(grad, grad0)
    assert bool(grad.abs().sum() > 0)


def saved_bytes(cfg, packed, spec, batch, remat):
    """Bytes the forward saves for backward, the params (views of the
    packed leaf) aside, and the packed gradient."""
    total = [0]
    leaf = packed.detach().requires_grad_(True)
    params = leaf.untyped_storage().data_ptr()

    def pack(t):
        if t.untyped_storage().data_ptr() != params:
            total[0] += t.numel() * t.element_size()
        return t
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        losses = TM.loss_fn_w(cfg, unpack_w(leaf, spec), batch, remat=remat)
    losses.sum().backward()
    return total[0], leaf.grad


def test_remat_saves_no_layer_activation():
    """Reduced smollm at 2 and 4 layers (one-layer cycles): with remat
    the saved bytes grow by the two added cycles' inputs (x and aux,
    which the rematerialized cycles keep to recompute from) and nothing
    else — no activation inside a layer — and are fewer than without,
    which grow by every saved activation of the two added layers."""
    got = {}
    for n in (2, 4):
        case = packed_case("smollm-135m", n_layers=n)
        (on, g1), (off, g0) = (saved_bytes(*case, remat=r)
                               for r in (True, False))
        assert torch.equal(g1, g0)
        got[n] = (on, off)
    cfg = get_arch("smollm-135m").reduced()
    cycle_inputs = 4 * (W * BATCH * SEQ * cfg.d_model + W)
    assert got[4][0] - got[2][0] == 2 * cycle_inputs
    assert got[4][1] - got[2][1] > 10 * 2 * cycle_inputs
    assert got[2][0] < got[2][1]


def residual_counts(cfg, params, tokens, policy, vmapped):
    """(residuals, those not arguments) that ``print_saved_residuals``
    lists for the reference's loss_fn(remat=True) under ``policy``,
    unbatched or under jax.vmap over two workers."""
    c = dataclasses.replace(cfg, remat_policy=policy)
    if vmapped:
        params = jax.tree.map(lambda x: jnp.stack([x, x]), params)
        tokens = jnp.stack([tokens, tokens])

        def f(p, t):
            return jnp.sum(jax.vmap(lambda pp, tt: JM.loss_fn(
                c, pp, {"tokens": tt}, remat=True))(p, t))
    else:
        def f(p, t):
            return JM.loss_fn(c, p, {"tokens": t}, remat=True)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        print_saved_residuals(f, params, tokens)
    lines = out.getvalue().splitlines()
    return len(lines), sum("from the argument" not in x for x in lines)


def test_reference_dots_saves_what_full_saves_under_vmap():
    cfg = dataclasses.replace(jget_arch("qwen2.5-14b").reduced(), n_layers=2)
    assert cfg.remat_policy == "dots"
    params = JM.init_model(cfg, jax.random.key(0))
    tokens = jnp.zeros((BATCH, 16), jnp.int32)
    count = {(p, v): residual_counts(cfg, params, tokens, p, v)
             for p in ("none", "full", "dots") for v in (False, True)}
    assert count[("dots", True)] == count[("full", True)]
    assert count[("dots", False)][0] > count[("full", False)][0]
    for v in (False, True):
        assert count[("none", v)][0] > count[("dots", v)][0]


def test_dryrun_peak_falls_with_remat():
    """Reduced smollm (4 layers) at seq 256 through run_pair on a fake
    (1, 1) mesh, pipelined: the traced peak with the config's 'full'
    policy below the one with 'none'; the FLOPs above (the recomputed
    forward)."""
    shape = ShapeConfig("train_remat", 256, 4, "train")
    base = dataclasses.replace(get_arch("smollm-135m").reduced(), n_layers=4)
    recs = {}
    with fake_process_group(1):
        mesh = make_host_mesh(1, 1, device="cpu")
        for policy in ("full", "none"):
            recs[policy] = D.run_pair(
                "smollm-135m", shape.name, multi_pod=False,
                gcfg=GossipConfig(shifts=(1,), partial_blocks=2),
                engine="pipelined", mesh=mesh,
                cfg=dataclasses.replace(base, remat_policy=policy),
                shape=shape, full_budget_s=1e9, verbose=False)
    on, off = recs["full"], recs["none"]
    assert on["memory"]["peak_bytes"] < off["memory"]["peak_bytes"]
    assert on["hlo_flops"] > off["hlo_flops"]
    assert on["memory"]["argument_bytes"] == off["memory"]["argument_bytes"]


def test_train_step_takes_remat():
    """make_train_step(remat=False) gives the same step as the default,
    bitwise, on the CPU (the pipelined int8 engine, one step)."""
    from repro_torch.core import gossip as G
    cfg, packed, spec, batch = packed_case("smollm-135m")
    gcfg = G.GossipConfig(shifts=(1,), partial_blocks=2, wire_format="int8")
    outs = []
    for remat in (True, False):
        step = make_train_step(cfg, pack_spec=spec, gcfg=gcfg,
                               pipelined=True, remat=remat)
        state = G.init_pipelined_gossip_state(packed, gcfg,
                                              block_rows=spec.block_rows)
        outs.append(step(packed, state, 0, batch, 0, 1))
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][3]["loss"], outs[1][3]["loss"])
